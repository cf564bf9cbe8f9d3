"""Compare two trees of this repository on the card, cell by cell of the
benchmark (``BENCHMARK.json``).

    python3 tools/ab_cells.py --other DIR [--cells a,b] \\
        [--seeds 11,12,13] [--seconds 10] [--spans SEED] [--out FILE]

DIR is the other tree (the parent commit, say: ``git archive`` unpacked
into a git-ignored directory inside the repository, so that a chip call
carries it); this tree is the change. For each cell (default: every one),
each seed gives one pair of untraced runs of ``benchmark/run.py`` (each
its own process, from its tree's root); pairs alternate which side runs
first: parent, change, change, parent, ... So both sides of a pair share
the seed and the card, and a drift of the card over the call falls on both
sides alike.

``--spans SEED``: then each cell whose traffic renders, once a side,
traced, with its mode set to ``render_spans`` (the render mode plus a
stretch of waves with the port's collector on): device ms a wave by
outermost port span between its CUDA events, the collector's counters
(``draws/kernel`` / ``draws/plain`` among them), and the traced run's
per-layer metrics. A tree whose port has no collector reads none.

Prints the card (``nvidia-smi``), one JSON line a run, then a summary a
cell: each end-to-end metric by pair (parent, change, change / parent) and
the median ratio, and whether every run was correct. ``--out`` also
appends every line to FILE.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run inside a tree: one traced run of a render cell in the render_spans
# mode, the port's spans of its collector stretch kept (port_spans.stretch
# leaves them on the run's record, which run_cell does not return)
SPANS_RUN = r"""
import json, sys, time
t_start = time.perf_counter()
sys.path.insert(0, ".")
from benchmark import harness, port_spans
port = {}
real = port_spans.stretch
def stretch(dev, rec, unit, units):
    real(dev, rec, unit, units)
    port.update(getattr(rec, "port", None) or {})
port_spans.stretch = stretch
cell, seed, seconds = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
out = harness.run_cell(cell, seed, seconds, True, t_start=t_start,
                       overrides={"traffic": {"mode": "render_spans"}})
ev = {}
for name in sorted({s["name"] for s in port.get("spans", ())}):
    got = [s["device_ms"] for s in port_spans.outermost(port["spans"], name)
           if "device_ms" in s]
    if got:
        ev[name] = sum(got) / port["units"]
print(json.dumps({"correct": out["correct"], "metrics": out["metrics"],
                  "checks": out["checks"], "event_ms_per_wave": ev,
                  "counters": port.get("counters", {}),
                  "idle_spans": port_spans.idle_spans(port) if port
                  else []}))
"""


def last_json(text):
    for line in reversed(text.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


def run(tree, argv, timeout):
    t = time.time()
    try:
        p = subprocess.run(argv, cwd=tree, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = "timeout", e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    return rc, last_json(out) if rc == 0 else None, err, time.time() - t


def untraced(tree, cell, seed, seconds):
    rc, res, err, wall = run(tree, [
        sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
        str(seed), "--seconds", str(seconds), "--trace", "0"], 900)
    line = {"cell": cell, "seed": seed, "kind": "untraced", "rc": rc,
            "wall_s": round(wall, 1)}
    if res is None:
        return dict(line, error=err[-2000:])
    return dict(line, correct=res["correct"],
                metrics={k: v["value"] for k, v in res["metrics"].items()},
                checks={k: v["value"] for k, v in res["checks"].items()},
                memory_peak_bytes=res.get("device", {}).get(
                    "memory_peak_bytes"))


def spans(tree, cell, seed, seconds):
    rc, res, err, wall = run(tree, [sys.executable, "-c", SPANS_RUN, cell,
                                    str(seed), str(seconds)], 1200)
    line = {"cell": cell, "seed": seed, "kind": "spans", "rc": rc,
            "wall_s": round(wall, 1)}
    if res is None:
        return dict(line, error=err[-2000:])
    res["metrics"] = {k: v["value"] for k, v in res["metrics"].items()}
    res["checks"] = {k: v["value"] for k, v in res["checks"].items()}
    return dict(line, **res)


def summary(cell, lines):
    """{metric: {"pairs": [[parent, change, ratio]], "median_ratio"}}."""
    by_seed = {}
    for ln in lines:
        by_seed.setdefault(ln["seed"], {})[ln["side"]] = ln
    out = {"cell": cell, "correct": all(ln.get("correct") for ln in lines),
           "metrics": {}}
    names = sorted({k for ln in lines for k in ln.get("metrics", {})})
    for name in names:
        pairs = []
        for seed, sides in by_seed.items():
            p = sides.get("parent", {}).get("metrics", {}).get(name)
            c = sides.get("change", {}).get("metrics", {}).get(name)
            if p is not None and c is not None:
                pairs.append([p, c, c / p])
        out["metrics"][name] = {
            "pairs": pairs,
            "median_ratio": (statistics.median(r for _, _, r in pairs)
                             if pairs else None)}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="the parent's tree (its root)")
    ap.add_argument("--cells", default=None)
    ap.add_argument("--seeds", default="2718281829,3141592653,1618033988")
    ap.add_argument("--seconds", type=float, default=None,
                    help="default: BENCHMARK.json's run_seconds")
    ap.add_argument("--spans", type=int, default=None, metavar="SEED")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    seconds = a.seconds or man["run_seconds"]
    cells = (a.cells.split(",") if a.cells
             else [w["name"] for w in man["workloads"]])
    seeds = [int(s) for s in a.seeds.split(",")]
    trees = {"parent": os.path.abspath(a.other), "change": ROOT}
    sink = open(a.out, "a") if a.out else None

    def say(obj):
        text = json.dumps(obj)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    except OSError:
        smi = None
    say({"card": smi, "cells": cells, "seeds": seeds, "seconds": seconds})
    results = {}
    for cell in cells:
        for i, seed in enumerate(seeds):
            order = ("parent", "change") if i % 2 == 0 else ("change",
                                                              "parent")
            for side in order:
                ln = dict(untraced(trees[side], cell, seed, seconds),
                          side=side)
                results.setdefault(cell, []).append(ln)
                say(ln)
    if a.spans is not None:
        for cell in cells:
            traffic = next(w["traffic"] for w in man["workloads"]
                           if w["name"] == cell)
            with open(os.path.join(ROOT, "benchmark", "traffic",
                                   traffic + ".json")) as f:
                if not json.load(f)["mode"].startswith("render"):
                    continue
            for side in ("parent", "change"):
                say(dict(spans(trees[side], cell, a.spans, seconds),
                         side=side))
    for cell, lines in results.items():
        say(dict(summary(cell, lines), kind="summary"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
