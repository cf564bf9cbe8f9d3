"""The port's own spans and counters (``dartray_tpu_torch.stats``), read by
the benchmark.

The traced stretch (``stretch``): a few units with the port's collector
on, CUDA events at every span's edges, under ``torch.profiler`` with the
device's activity alone. Spans are stamped with ``time.time_ns()``, the
clock the profiler stamps its events with, so a span and a kernel are laid
on one time line: seconds after the trace's ``trace_start_ns``.

What it leaves in ``rec.port``: ``spans``, ``counters``, ``device`` (the
device intervals), ``w0`` / ``w1`` (the stretch's ends), ``units`` and
``trace_start_ns``. A port without the collector (``stats.collect``)
leaves nothing there, and every reader below then reads nothing.

The readers are pure functions of ``rec.port``, so the tests feed them
canned records.
"""
from __future__ import annotations

import time

from benchmark import tracing


def _stats():
    try:
        from dartray_tpu_torch import stats
    except ImportError:
        return None
    return stats if hasattr(stats, "collect") else None


# --- collecting --------------------------------------------------------------

def stretch(dev, rec, unit, units):
    """`units` calls of ``unit()`` with the collector on, under the
    profiler with the device's activity alone; the device synchronised at
    both ends. Nothing where the port has no collector."""
    stats = _stats()
    if stats is None:
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    rs = stats.RenderStats()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a = time.time_ns()
        with stats.collect(rs, events=True):
            for _ in range(units):
                unit()
        torch.cuda.synchronize(dev)
        b = time.time_ns()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    dev_iv, _, _ = tracing.split_events(prof.events())
    ex = rs.export()
    rec.port = {"spans": on_trace_clock(ex["spans"], t0),
                "counters": ex["counters"], "device": dev_iv,
                "w0": (a - t0) * 1e-9, "w1": (b - t0) * 1e-9,
                "units": units, "trace_start_ns": t0}


def on_trace_clock(spans, t0):
    """``spans`` with ``start`` / ``end`` in seconds after ``t0`` (ns)."""
    return [dict(s, start=(s["start_ns"] - t0) * 1e-9,
                 end=(s["end_ns"] - t0) * 1e-9) for s in spans]


# --- arithmetic on the spans -------------------------------------------------

def outermost(spans, name):
    """The spans named `name` that no span of that name holds."""
    by_id = {s["id"]: s for s in spans}
    out = []
    for s in spans:
        if s["name"] != name:
            continue
        p = by_id.get(s["parent"])
        while p is not None and p["name"] != name:
            p = by_id.get(p["parent"])
        if p is None:
            out.append(s)
    return out


def overlap(gap_list, spans):
    """Seconds of the gaps that lie inside the union of the spans."""
    merged = []
    for a, b in sorted((s["start"], s["end"]) for s in spans):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return sum(max(0.0, min(b, d) - max(a, c))
               for a, b in gap_list for c, d in merged)


def stretch_gaps(port):
    """The device's idle stretches of the traced stretch's window."""
    dev = tracing.clip(port["device"], port["w0"], port["w1"])
    return tracing.gaps(dev, port["w0"], port["w1"])


def idle_spans(port, n=12):
    """[[span, seconds]]: the device's idle time in the stretch, summed by
    the innermost port span open on any host thread at each gap's middle
    ("idle" where none is), top n."""
    return tracing.name_gaps(
        stretch_gaps(port),
        [(s["name"], s["start"], s["end"]) for s in port["spans"]], n)


# --- what the metric readers read --------------------------------------------

def event_ms(rec, name):
    """Device ms a unit between the events of the outermost spans `name`;
    None where the run traced no stretch with the collector on."""
    port = getattr(rec, "port", None)
    if not port:
        return None
    got = [s["device_ms"] for s in outermost(port["spans"], name)
           if "device_ms" in s]
    return sum(got) / port["units"] if got else None
