"""Render statistics (counterpart of the JAX reference's ``stats.py``):
counters and wall-clock timings per phase. The render entry points fill a
``RenderStats`` when they are given one; every count is exact host-side
accounting of the work issued (waves, camera rays, traversal queries).
``TorchOps`` counts the torch operations the host issues, for the walks whose
cost is host-bound.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

from torch.utils._python_dispatch import TorchDispatchMode


class RenderStats:
    """Counters + phase timings; render entry points fill it when passed."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.timings: Dict[str, float] = {}

    def add(self, name: str, n=1):
        self.counters[name] = self.counters.get(name, 0) + n

    @contextmanager
    def time(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + (
                time.time() - t0)

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
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {"counters": dict(self.counters),
                "timings": dict(self.timings)}


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
