"""Leveled logging with a swappable callback; SEVERE raises (counterpart of
the JAX reference's ``log.py``).

Five levels (DEBUG, INFO, WARNING, ERROR, SEVERE) go through one callback;
logging at SEVERE raises ``SevereLogError``. ``as_callback`` adapts a Log to
the ``log=`` callables of the parser and the render manager (plain strings
log at INFO, strings starting with "warning" at WARNING, "error" at ERROR).
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Optional

DEBUG, INFO, WARNING, ERROR, SEVERE = 0, 1, 2, 3, 4
_NAMES = {DEBUG: "DEBUG", INFO: "INFO", WARNING: "WARNING",
          ERROR: "ERROR", SEVERE: "SEVERE"}


class SevereLogError(RuntimeError):
    """Raised by Log.severe (LOG_SEVERE semantics, log.dart:42-47)."""


class Log:
    def __init__(self, callback: Optional[Callable[[int, str], None]] = None,
                 level: int = INFO, prefix: str = "", timestamps: bool = False):
        self.callback = callback or self._default
        self.level = level
        self.prefix = prefix           # e.g. "[THREAD 2/8]" (render_isolate)
        self.timestamps = timestamps

    def _default(self, level, msg):
        stream = sys.stderr if level >= WARNING else sys.stdout
        print(msg, file=stream, flush=True)

    def log(self, level: int, msg: str):
        if level < self.level and level != SEVERE:
            return
        parts = []
        if self.timestamps:
            parts.append(time.strftime("%H:%M:%S"))
        if self.prefix:
            parts.append(self.prefix)
        parts.append(f"{_NAMES[level]}: {msg}" if level != INFO else msg)
        line = " ".join(parts)
        self.callback(level, line)
        if level == SEVERE:
            raise SevereLogError(msg)

    def debug(self, msg):
        self.log(DEBUG, msg)

    def info(self, msg):
        self.log(INFO, msg)

    def warning(self, msg):
        self.log(WARNING, msg)

    def error(self, msg):
        self.log(ERROR, msg)

    def severe(self, msg):
        self.log(SEVERE, msg)

    def as_callback(self) -> Callable[[str], None]:
        """Adapter for the `log=`-callable call sites (parser/manager):
        classifies "warning:"-prefixed strings at WARNING, rest at INFO."""
        def cb(msg):
            s = str(msg)
            low = s.lstrip().lower()
            if low.startswith("warning"):
                self.log(WARNING, s)
            elif low.startswith("error"):
                self.log(ERROR, s)
            else:
                self.log(INFO, s)
        return cb


# module-level default (Log.* free functions in the reference)
default = Log()


def debug(msg):
    default.debug(msg)


def info(msg):
    default.info(msg)


def warning(msg):
    default.warning(msg)


def error(msg):
    default.error(msg)


def severe(msg):
    default.severe(msg)
