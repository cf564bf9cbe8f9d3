"""Trace arithmetic: what a torch.profiler trace of a stretch of the window
says about the device.

Copied in part from ``tools/profile_torch_wave.py`` (how device kernels are
told apart from host ops and named ranges) and extended: the device's busy
time is the UNION of its activity intervals inside the traced window (not
a sum, which double counts overlapping streams), idle gaps are named by the
innermost host op running at their middle, and device time is attributed
to a named range by the interval of the range on the host clock (the runs
that attribute synchronise the device at both ends of the range, so every
kernel launched inside it also runs inside it).

The pure functions take plain tuples, so the tests feed them canned traces.
"""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

PREFIX = "bench:"      # the benchmark's own named ranges


def _is_device(e):
    dt = getattr(e, "device_type", None)
    if dt is not None and "CUDA" in str(dt):
        return True
    cpu = getattr(e, "cpu_time_total", 0)
    dev = (e.self_device_time_total if hasattr(e, "self_device_time_total")
           else getattr(e, "self_cuda_time_total", 0))
    return cpu == 0 and dev > 0


def split_events(events):
    """Profiler FunctionEvents -> (device intervals, host ranges, host ops),
    each a list of (name, start_s, end_s) on the trace's clock. Device
    intervals leave out the device-side twins of the benchmark's ranges."""
    dev, ranges, ops = [], [], []
    for e in events:
        tr = e.time_range
        item = (e.name, tr.start * 1e-6, tr.end * 1e-6)
        if _is_device(e):
            if not e.name.startswith(PREFIX):
                dev.append(item)
        elif e.name.startswith(PREFIX):
            ranges.append(item)
        else:
            ops.append(item)
    return dev, ranges, ops


def device_window(intervals, wall_s):
    """A stretch traced with the device's activity alone: its window is
    ``wall_s`` long (the host clock's length of the stretch, the device
    idle at both ends), laid from the first device activity on."""
    w0 = min((a for _, a, _ in intervals), default=0.0)
    return {"device": clip(intervals, w0, w0 + wall_s), "w0": w0,
            "w1": w0 + wall_s}


def clip(intervals, w0, w1):
    return [(n, max(a, w0), min(b, w1)) for n, a, b in intervals
            if b > w0 and a < w1 and min(b, w1) > max(a, w0)]


def union_length(intervals):
    """Length covered by the union of (name, start, end) intervals."""
    total, cur_a, cur_b = 0.0, None, None
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals, w0, w1):
    """Idle stretches of [w0, w1] between the union of the intervals."""
    out, t = [], w0
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if w1 > t:
        out.append((t, w1))
    return out


def idle_pct_of_units(trace, unit_s):
    """100 x (1 - busy time a unit / the median unit's time), the busy
    time from a stretch traced with the device's activity alone (its
    ``device`` intervals over its ``units``), the unit times from the
    untraced window; None without both."""
    if not trace or not trace["device"] or not unit_s:
        return None
    busy = union_length(trace["device"]) / trace["units"]
    return 100.0 * (1.0 - busy / statistics.median(unit_s))


def top_by_name(intervals, n=10):
    """[[name, seconds]] of the n names with the most summed time."""
    acc = defaultdict(float)
    for name, a, b in intervals:
        acc[name] += b - a
    return [[k, v] for k, v in sorted(acc.items(), key=lambda x: -x[1])[:n]]


def name_gaps(gap_list, host_ops, n=10):
    """[[host op, seconds]]: idle time summed by the innermost host op
    running at each gap's middle ("idle" where none runs), top n."""
    ops = sorted(host_ops, key=lambda x: x[1])
    starts = [o[1] for o in ops]
    acc = defaultdict(float)
    for a, b in gap_list:
        mid = 0.5 * (a + b)
        best = None
        i = bisect.bisect_right(starts, mid)
        # the latest-starting op that still covers mid is the innermost
        for j in range(i - 1, max(i - 4096, -1), -1):
            if ops[j][2] >= mid:
                best = ops[j][0]
                break
        acc[best or "idle"] += b - a
    return [[k, v] for k, v in sorted(acc.items(), key=lambda x: -x[1])[:n]]


def inside(intervals, ranges):
    """The intervals whose middle lies inside one of the ranges."""
    rs = []
    for _, a, b in sorted(ranges, key=lambda x: x[1]):
        if rs and a <= rs[-1][1]:
            rs[-1] = (rs[-1][0], max(rs[-1][1], b))
        else:
            rs.append((a, b))
    starts = [r[0] for r in rs]
    out = []
    for it in intervals:
        mid = 0.5 * (it[1] + it[2])
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and rs[i][1] >= mid:
            out.append(it)
    return out
