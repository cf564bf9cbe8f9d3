"""Run one cell several times and report how far its runs spread.

    python benchmark/spread.py --workload <name> --seconds <s> \\
        --seeds 11,12,13,14,15,16 [--sets 2] [--trace 0|1] [--control bf16] \\
        [--fault unchanged|half|altered] \\
        [--out FILE.jsonl]

Each run is its own process of ``run.py``, one after another, the seeds in
the order given, the same seeds in every set. Every result line is appended
to ``--out``; the summary printed last gives, for each metric of each set,
the values, the median and the spread: the distance between the first and
third quartiles (``statistics.quantiles(values, n=4)``) over the median; and
for each number the check compares, its largest reading and its limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    seeds = [int(s) for s in a.seeds.split(",")]
    if a.out and os.path.dirname(a.out):
        os.makedirs(os.path.dirname(a.out), exist_ok=True)
    runs = []
    for k in range(a.sets):
        for seed in seeds:
            cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
                   a.workload, "--seed", str(seed), "--seconds",
                   str(a.seconds), "--trace", str(a.trace)]
            if a.control:
                cmd += ["--control", a.control]
            if a.fault:
                cmd += ["--fault", a.fault]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            res = None
            if p.returncode == 0 and lines:
                res = json.loads(lines[-1])
            rec = {"set": k, "seed": seed, "rc": p.returncode, "wall_s": wall,
                   "result": res, "stderr_tail": p.stderr[-1500:]}
            runs.append(rec)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            brief = {n: m["value"] for n, m in (res or {}).get(
                "metrics", {}).items()}
            checks = {n: c["value"] for n, c in (res or {}).get(
                "checks", {}).items()}
            print(json.dumps({"set": k, "seed": seed, "rc": p.returncode,
                              "wall_s": round(wall, 1),
                              "correct": (res or {}).get("correct"),
                              "metrics": brief, "checks": checks}),
                  flush=True)
            if p.returncode != 0:
                print(p.stderr[-3000:], file=sys.stderr, flush=True)
    summary = {}
    for k in range(a.sets):
        got = [r["result"] for r in runs if r["set"] == k and r["result"]]
        names = sorted({n for g in got for n in g["metrics"]})
        for n in names:
            vals = [g["metrics"][n]["value"] for g in got
                    if n in g["metrics"]]
            summary.setdefault(n, []).append(
                {"set": k, "median": statistics.median(vals),
                 "spread": spread(vals), "values": vals})
    worst = {}
    for r in runs:
        for n, c in ((r["result"] or {}).get("checks") or {}).items():
            w = worst.setdefault(n, {"max": c["value"], "limit": c["limit"]})
            w["max"] = max(w["max"], c["value"])
    print(json.dumps({"workload": a.workload, "summary": summary,
                      "checks_max": worst,
                      "all_correct": all(r["result"] and r["result"]["correct"]
                                         for r in runs)}))


if __name__ == "__main__":
    main()
