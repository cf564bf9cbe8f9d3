"""Render statistics (counterpart of the JAX reference's ``stats.py``):
counters, wall-clock timings per phase, and the spans of the program's
layers. The render entry points fill a ``RenderStats`` when they are given
one; every count is exact host-side accounting of the work issued (waves,
camera rays, traversal queries). ``TorchOps`` counts the torch operations
the host issues, for the walks whose cost is host-bound.

Spans. While a ``RenderStats`` collects (``with collect(rs):``), the layers'
``span(name)`` contexts record into it: the name, start and end in ns of
``time.time_ns()`` (the clock ``torch.profiler`` stamps its events with),
the parent span, the thread, the unit (the wave or fitting step a span
belongs to: a span opened with ``unit=True`` outside every other unit
starts a new one, every other span takes its parent's) and ``recompute``
(opened inside an autograd backward pass: a checkpoint's recompute). With
device events on, each span also records a pair of ``torch.cuda.Event`` at
its edges on the current stream; they are read by ``export`` only, so a
span never synchronises. ``count(name, n)`` adds to a counter; ``n`` may be
a device tensor, which accumulates on the device and is read at export.

Off (the default), ``span`` returns one shared no-op context after a
single global check and ``count`` returns at once: no event, no device
reduction, no synchronisation. A span opened on a thread with no open span
of its own (the autograd engine's device thread) takes as parent the
innermost open span of the thread that started collecting.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from contextlib import contextmanager
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_ACTIVE = None          # the RenderStats that collects, or None


class _NoSpan:
    """What ``span`` returns while nothing collects."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str, unit: bool = False, **attrs):
    """A span of the collecting ``RenderStats``, or ``NO_SPAN``."""
    rs = _ACTIVE
    if rs is None:
        return NO_SPAN
    return Span(rs, name, unit, attrs)


def spanned(name: str):
    """Decorator: each call of the function is a span `name` while a
    ``RenderStats`` collects."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def collecting() -> bool:
    """Whether a ``RenderStats`` collects: callers test it before they
    compute what they would count (a device reduction, say)."""
    return _ACTIVE is not None


def count(name: str, n=1):
    """Add `n` to the collecting ``RenderStats``' counter `name`."""
    rs = _ACTIVE
    if rs is not None:
        rs.add(name, n)


@contextmanager
def collect(rs: "RenderStats", events: bool = False):
    """Spans and counts of the program go to `rs` inside the context.
    events: record CUDA events at each span's edges."""
    global _ACTIVE
    prev, prev_events, prev_main = _ACTIVE, rs.events, rs._main
    rs.events = events
    rs._main = threading.get_ident()
    _ACTIVE = rs
    try:
        yield rs
    finally:
        _ACTIVE = prev
        rs.events, rs._main = prev_events, prev_main


class Span:
    """One timed stretch of a layer; ``RenderStats.spans`` holds them in
    the order they closed."""
    __slots__ = ("rs", "id", "name", "attrs", "want_unit", "start_ns",
                 "end_ns", "parent", "thread", "unit", "recompute",
                 "events", "timing")

    def __init__(self, rs, name, unit=False, attrs=None, timing=False):
        self.rs, self.name, self.attrs = rs, name, attrs or {}
        self.want_unit, self.timing = unit, timing
        self.events = None

    def __enter__(self):
        rs = self.rs
        self.thread = threading.get_ident()
        stack = rs._stacks.setdefault(self.thread, [])
        if stack:
            parent = stack[-1]
        else:
            main = rs._stacks.get(rs._main)
            parent = main[-1] if main and self.thread != rs._main else None
        self.parent = parent
        self.unit = parent.unit if parent is not None else None
        if self.want_unit and self.unit is None:
            self.unit = next(rs._units)
        self.id = next(rs._ids)
        self.recompute = torch._C._current_graph_task_id() >= 0
        if rs.events:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        rs = self.rs
        rs._stacks[self.thread].pop()
        rs.spans.append(self)
        if self.timing:
            rs.timings[self.name] = rs.timings.get(self.name, 0.0) + (
                self.end_ns - self.start_ns) * 1e-9
        return False


class RenderStats:
    """Counters + phase timings + spans; render entry points fill it when
    passed, and the program's layers while it collects (``collect``)."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.timings: Dict[str, float] = {}
        self.device_counters: Dict[str, torch.Tensor] = {}
        self.spans = []
        self.events = False
        self._main = None
        self._stacks = {}
        self._ids = itertools.count()
        self._units = itertools.count()

    def add(self, name: str, n=1):
        if torch.is_tensor(n):
            have = self.device_counters.get(name)
            if have is None:
                self.device_counters[name] = n.detach().clone()
            else:
                have.add_(n)
            return
        self.counters[name] = self.counters.get(name, 0) + n

    def time(self, name: str):
        """A span whose seconds also add to ``timings[name]``."""
        return Span(self, name, timing=True)

    def counter_values(self) -> Dict[str, float]:
        """The host counters and the device counters, read."""
        out = dict(self.counters)
        for k, v in self.device_counters.items():
            out[k] = out.get(k, 0) + float(v)
        return out

    def export(self) -> dict:
        """Spans as dicts (``parent`` an id or None; ``device_ms`` the
        time between the span's events, where it recorded them) and every
        counter read. Waits for the device where spans recorded events."""
        spans = []
        for s in self.spans:
            d = {"id": s.id, "name": s.name, "start_ns": s.start_ns,
                 "end_ns": s.end_ns,
                 "parent": None if s.parent is None else s.parent.id,
                 "thread": s.thread, "unit": s.unit,
                 "recompute": s.recompute, "attrs": dict(s.attrs)}
            if s.events is not None:
                s.events[1].synchronize()
                d["device_ms"] = s.events[0].elapsed_time(s.events[1])
            spans.append(d)
        return {"spans": spans, "counters": self.counter_values()}

    def summary(self) -> str:
        lines = ["render stats:"]
        for k in sorted(self.counters):
            v = self.counters[k]
            lines.append(f"  {k:<28} {v:,.0f}")
        for k in sorted(self.timings):
            lines.append(f"  {k:<28} {self.timings[k]:.2f}s")
        c = self.counters
        if "rays/traversal_queries" in c and "time/render" in {
                k for k in self.timings}:
            t = max(self.timings["time/render"], 1e-9)
            lines.append(f"  {'rays_per_second':<28} "
                         f"{c['rays/traversal_queries'] / t:,.0f}")
        lines += (self._span_lines() + self._lane_lines()
                  + self._draw_lines())
        return "\n".join(lines)

    def _span_lines(self):
        """Host seconds by span name (a span inside one of its own name
        is in its parent's), beside the times ``timings`` already holds."""
        tot, n = {}, {}
        for s in self.spans:
            if s.timing:
                continue
            p = s.parent
            while p is not None and p.name != s.name:
                p = p.parent
            if p is not None:
                continue
            tot[s.name] = tot.get(s.name, 0) + (s.end_ns - s.start_ns) * 1e-9
            n[s.name] = n.get(s.name, 0) + 1
        return [f"  span {k:<23} {tot[k]:.3f}s x {n[k]}"
                for k in sorted(tot)]

    def _lane_lines(self):
        """Live share of the traversal lanes, by mode."""
        c = self.counter_values()
        out = []
        for k in sorted(c):
            if k.startswith("lanes/") and c[k] > 0:
                live = c.get("lanes_live/" + k[len("lanes/"):], 0)
                out.append(f"  {'live_' + k:<28} {100 * live / c[k]:.1f}%")
        return out

    def _draw_lines(self):
        """The share of the sample draws the hashing kernel took."""
        share = draws_on_kernel_pct(self.counters)
        return [] if share is None else [
            f"  {'draws_on_kernel':<28} {share:.1f}%"]

    def as_dict(self) -> dict:
        return {"counters": dict(self.counters),
                "timings": dict(self.timings)}


def draws_on_kernel_pct(counters):
    """Percent of the sample draws counted in `counters` that took the
    hashing kernel (``draws/kernel`` against ``draws/plain``); None where
    none was counted."""
    kern = counters.get("draws/kernel", 0)
    total = kern + counters.get("draws/plain", 0)
    return 100 * kern / total if total else None


class TorchOps(TorchDispatchMode):
    """While active (``with TorchOps() as ops:``), ``ops.n`` counts the
    torch operations dispatched, on any device: what the host issues, one
    kernel launch or CPU loop each at most."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))
