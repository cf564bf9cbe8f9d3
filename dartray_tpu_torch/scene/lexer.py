"""PBRT scene-file lexer with an include stack (counterpart of the JAX
reference's ``scene/lexer.py``, a copy: numbers go through Python's
``float`` exactly as there, so that a compiled scene is bit-equal).

A byte-level tokenizer producing identifiers, numbers, quoted strings and
brackets; ``#`` comments; ``Include`` pushes the included text on a stack.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

IDENT = 0
NUMBER = 1
STRING = 2
LBRACK = 3
RBRACK = 4
EOF = 5


class Token(NamedTuple):
    kind: int
    value: object
    line: int


def tokenize(text: str) -> Iterator[Token]:
    i, n, line = 0, len(text), 1
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
        elif c in " \t\r":
            i += 1
        elif c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 1
            yield Token(STRING, text[i + 1:j], line)
            i = j + 1
        elif c == "[":
            yield Token(LBRACK, "[", line)
            i += 1
        elif c == "]":
            yield Token(RBRACK, "]", line)
            i += 1
        elif c in "+-.0123456789":
            j = i
            while j < n and text[j] not in ' \t\r\n"[]#':
                j += 1
            s = text[i:j]
            try:
                v = float(s)
                yield Token(NUMBER, v, line)
            except ValueError:
                yield Token(IDENT, s, line)
            i = j
        else:
            j = i
            while j < n and (text[j].isalnum() or text[j] in "_"):
                j += 1
            if j == i:
                j = i + 1
            yield Token(IDENT, text[i:j], line)
            i = j
    yield Token(EOF, None, line)


class Lexer:
    """Pull-lexer with include stack (pbrt_lexer.dart addInclude)."""

    def __init__(self, text: str, resolver=None, name="<scene>"):
        self.stack = [tokenize(text)]
        self.resolver = resolver    # name -> text (ResourceManager analog)
        self.peeked: Optional[Token] = None

    def add_include(self, name: str):
        if self.resolver is None:
            raise FileNotFoundError(f"no resolver for Include {name!r}")
        text = self.resolver(name)
        self.stack.append(tokenize(text))

    def next(self) -> Token:
        if self.peeked is not None:
            t = self.peeked
            self.peeked = None
            return t
        while self.stack:
            t = next(self.stack[-1])
            if t.kind == EOF and len(self.stack) > 1:
                self.stack.pop()
                continue
            return t
        return Token(EOF, None, 0)

    def peek(self) -> Token:
        if self.peeked is None:
            self.peeked = self.next()
        return self.peeked
