"""The general part of one benchmark run: set-up, the measured window, the
traced stretches, the check against the reference and the result line.

Everything particular to a cell comes from files found by name
(``registry.py``): ``BENCHMARK.json`` names the cell's configuration and
traffic mix and the metrics it reports; ``configs/<config>.json`` makes the
scene (``scenes.py``, its shapes by ``shapes/<kind>.py``);
``traffic/<mix>.json`` holds the mix's parameters, its ``mode`` names what
the window runs (``modes/<mode>.py``: "render", waves of
``renderers.sampler.render_wave``; "grad", steps of
``grad.render_loss_grad`` with a plain Adam update) and its ``integrator``
the port's and the reference's radiance (``integrators/<name>.py``); each
metric is read by ``metrics/<name>.py`` from the run's ``Record``;
``limits/<cell>.json`` holds the limits of the numbers the check compares.

A mode module has ``GRAD`` (autograd on in the window), ``SYNC_UNITS``
(the window synchronises after every unit), ``Cell(cfg, traffic, seed, dev,
rec, bench)`` with ``warm_up()``, ``unit()``, ``samples_per_unit()`` and
``answers(seed)``, ``numbers(cfg, traffic, seed, answers, dev, bench,
control)``, ``trace(cell, traffic, dev, rec)`` and ``FAULTS``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import registry, scenes, tracing
from .reference import geometry as ref_geom
from .reference import shading as ref_sh

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_DEPTH = [0]            # open synchronised ranges


class NoDevice(RuntimeError):
    """The cell's chips are not there."""


# --- finding things by name --------------------------------------------------

def load_manifest(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(man, name):
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(man, cell, group):
    """The `group` ("end_to_end" / "per_layer") metrics the cell reports."""
    return [m for m in man[group]
            if "workloads" not in m or cell in m["workloads"]]


def config_path(man, name, bench=HERE):
    for c in man["configs"]:
        if c["name"] == name:
            return os.path.join(os.path.dirname(bench), c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_json(kind, name, bench=HERE):
    with open(os.path.join(bench, kind, name + ".json")) as f:
        return json.load(f)


def metric_reader(name, bench=HERE) -> Callable:
    """``read(record)`` of metrics/<name>.py."""
    return registry.load("metrics", name, bench).read


# --- what a run records ------------------------------------------------------

@dataclasses.dataclass
class Record:
    """What the metric readers read. Times in seconds."""
    mode: str
    setup_s: float = 0.0
    window_s: float = 0.0
    samples: int = 0               # camera samples deposited in the window
    units: int = 0                 # waves or steps in the window
    peak_mem_bytes: int = 0        # allocator peak over the window
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)
    enqueue_s: List[float] = dataclasses.field(default_factory=list)
    unit_s: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[dict] = None   # the stretch traced on the device alone
    split: Optional[dict] = None   # the host-traced, synchronised ranges
    power_limit: str = ""
    log: Callable = print


def _power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_kernels(dev, rec):
    """The span around the port's kernel load (nvcc on a cache miss)."""
    if dev.type == "cuda":
        from dartray_tpu_torch.ops import traverse_cuda as tc
        t0 = time.perf_counter()
        tc.load_kernels(("traverse6",))
        rec.spans["kernel_load"] = time.perf_counter() - t0


# --- tracing stretches -------------------------------------------------------

def profile_device(dev, fn):
    """fn() traced with the device's activity alone: no host operator is
    recorded, so the host runs as it does untraced. The window is the
    stretch's length on the host clock (the device idle at both ends),
    laid from the first device activity on. Returns the device intervals
    and the window's ends on the trace's clock."""
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    dev_iv, _, _ = tracing.split_events(prof.events())
    return tracing.device_window(dev_iv, wall)


def profile_host(dev, fn):
    """fn() traced with the host's operators and the device's activity,
    inside the range bench:window. The host's tracing slows the host, so
    this stretch only names the device's idle gaps by what the host was
    doing, and attributes device time to the ranges ``synced_range``
    opens (kernel times are the device's own)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(tracing.PREFIX + "window"):
            fn()
            sync(dev)
    dev_iv, ranges, ops = tracing.split_events(prof.events())
    win = [r for r in ranges if r[0] == tracing.PREFIX + "window"]
    w0, w1 = win[0][1], win[0][2]
    return {"device": tracing.clip(dev_iv, w0, w1), "ranges": ranges,
            "ops": ops, "w0": w0, "w1": w1}


def synced_range(dev, name, fn):
    """fn wrapped so that the device is idle when the range bench:<name>
    opens and has finished fn's work when it closes, so every kernel fn
    launches runs inside the range. A call inside a wrapped call opens no
    range of its own."""
    from torch.profiler import record_function

    def wrapped(*a, **k):
        if _DEPTH[0]:
            return fn(*a, **k)
        _DEPTH[0] += 1
        try:
            sync(dev)
            with record_function(tracing.PREFIX + name):
                out = fn(*a, **k)
                sync(dev)
        finally:
            _DEPTH[0] -= 1
        return out
    return wrapped


# --- the reference's scene and the numbers compared ---------------------------

def reference_scene(cfg, dev, dtype):
    return ref_geom.Scene(cfg["meshes"], cfg["materials"], dev, dtype)


def reference_camera(cfg, traffic, dev, dtype):
    c = cfg["camera"]
    return ref_sh.Camera(c["eye"], c["look"], c["up"], c["fov"],
                         traffic["width"], traffic["height"], dtype, dev)


def pixel_numbers(prog, ref):
    """rel_l1: summed |program - reference| over summed |reference| of the
    pixels (rows of RGB); rel_err_median: the median pixel's |difference|
    over its |reference| + 0.01."""
    prog = prog.double().cpu().reshape(-1, 3)
    ref = ref.double().cpu().reshape(-1, 3)
    diff = (prog - ref).abs().sum(-1)
    mag = ref.abs().sum(-1)
    rel_l1 = float(diff.sum() / mag.sum().clamp_min(1e-12))
    med = float((diff / (mag + 0.01)).median())
    return {"rel_l1": rel_l1, "rel_err_median": med}


def check(nums, limits):
    """The numbers a cell's limits file lists, each beside its limit, and
    whether all hold."""
    out = {k: {"value": nums[k], "limit": v} for k, v in limits.items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out


# --- planted faults (the tests, and readings of a fault on the card) ---------

class Shim:
    """A module of the program with one function replaced."""

    def __init__(self, real, name, fn):
        self._real = real
        setattr(self, name, fn)

    def __getattr__(self, name):
        return getattr(self._real, name)


def fault_altered(obj):
    """An answer altered where it is produced: the radiance of every lane
    off by one percent (in a fit too, where the image is what the loss and
    the gradient are made from)."""
    li = obj.li
    obj.li = lambda *a: li(*a) * 1.01


# --- one run -----------------------------------------------------------------

def run_cell(workload, seed, seconds, trace, *, t_start=None, device="cuda",
             control=None, fault=None, overrides=None, bench=HERE,
             root=ROOT, log=None):
    """One run of a cell; returns the result dict (the last line's object).

    device: "cuda" on the chip; the tests pass "cpu" with `overrides`
    (keys of the traffic mix and of the configuration, shrinking them).
    fault: the name of one of the mode's ``FAULTS``, planted under the
    timed path after set-up. Raises NoDevice where the cell's chips are
    missing."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    man = load_manifest(root)
    cell = cell_of(man, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            have = (torch.cuda.device_count() if torch.cuda.is_available()
                    else 0)
            raise NoDevice(f"{workload} needs {cell['chips']} CUDA "
                           f"device(s); this machine has {have}")
        dev = torch.device("cuda", 0)
        torch.zeros(1, device=dev)
    overrides = overrides or {}
    cfg = scenes.load_config(config_path(man, cell["config"], bench),
                             overrides.get("config"), bench)
    traffic = dict(load_json("traffic", cell["traffic"], bench),
                   **overrides.get("traffic", {}))
    limits = load_json("limits", workload, bench)
    mode = registry.load("modes", traffic["mode"], bench)
    rec = Record(mode=traffic["mode"], log=lambda *a: None)
    with torch.enable_grad() if mode.GRAD else torch.no_grad():
        obj = mode.Cell(cfg, traffic, seed, dev, rec, bench)
        if fault is not None:
            mode.FAULTS[fault](obj)
        obj.warm_up()
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        rec.setup_s = time.perf_counter() - t_start
        timed = trace or mode.SYNC_UNITS
        units = 0
        t0 = time.perf_counter()
        while True:
            ta = time.perf_counter()
            obj.unit()
            units += 1
            if timed:
                tb = time.perf_counter()
                sync(dev)
                rec.enqueue_s.append(tb - ta)
                rec.unit_s.append(time.perf_counter() - ta)
            if time.perf_counter() - t0 >= seconds:
                break
        sync(dev)
        rec.window_s = time.perf_counter() - t0
        rec.units = units
        rec.samples = units * obj.samples_per_unit()
        if dev.type == "cuda":
            rec.peak_mem_bytes = torch.cuda.max_memory_allocated(dev)
        ans = obj.answers(seed)
        if trace and dev.type == "cuda":
            mode.trace(obj, traffic, dev, rec)
    metrics = {}
    group = "per_layer" if trace else "end_to_end"
    rec.power_limit = _power_limit() if dev.type == "cuda" else "cpu"
    rec.log = log
    for m in metrics_of(man, workload, group):
        v = metric_reader(m["name"], bench)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = _device_info(dev, cell, rec, trace)
    # the program's state goes before the reference runs
    del obj
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ok, nums = check(mode.numbers(cfg, traffic, seed, ans, dev, bench,
                                  control=control), limits)
    log(f"check: {time.perf_counter() - t0:.1f} s")
    out = {"correct": bool(ok), "attempted": units, "failed": 0,
           "metrics": metrics, "device": device_info}
    if rec.trace is not None:
        out["breakdown"] = {
            "device_ops": tracing.top_by_name(rec.trace["device"]),
            "idle_gaps": tracing.name_gaps(
                tracing.gaps(rec.split["device"], rec.split["w0"],
                             rec.split["w1"]), rec.split["ops"])}
    out["checks"] = nums
    return out


def _device_info(dev, cell, rec, trace):
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": cell["chips"],
                "memory_peak_bytes": int(rec.peak_mem_bytes)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace and rec.trace is not None:
        t = rec.trace
        info["busy_s"] = tracing.union_length(t["device"])
        info["window_s"] = t["w1"] - t["w0"]
    info["power"] = rec.power_limit
    return info
