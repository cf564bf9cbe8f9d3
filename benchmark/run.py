"""Run one cell of the benchmark of dartray_tpu_torch once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1> [--control bf16]

From the root of a checkout that holds the port (``dartray_tpu_torch/``).
Loads the cell's scene into the port, warms up, measures for ``--seconds``,
checks what the measured path produced against the plain reference under
``benchmark/reference/`` and prints one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared beside its limit (also the last lines of standard error).

``--control bf16`` puts the reference computed in bfloat16 in the
program's place, and ``--fault unchanged|half|altered`` plants one of the
mode's ``FAULTS`` (``modes/<mode>.py``) under the timed path: the check
must then come out false (readings for the limits; the benchmark's own
runs take neither).
Exits 3 without a result where the cell's CUDA devices are missing, 4
where a module of JAX or of the JAX package ``dartray_tpu`` is loaded, 5
where the port cannot be imported. Kernel caches stay inside the checkout: the port's libraries in
``dartray_tpu_torch/_build/`` and its native BVH builder beside its
source, Triton's under ``benchmark/.cache/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None)
    ap.add_argument("--fault", default=None)
    a = ap.parse_args(argv)
    cache = os.path.join(HERE, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    sys.path.insert(0, ROOT)
    try:
        import dartray_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port dartray_tpu_torch cannot be imported: {e}",
              file=sys.stderr)
        return 5
    from benchmark import checks, harness
    try:
        out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                               t_start=T_START, control=a.control,
                               fault=a.fault)
    except harness.NoDevice as e:
        print(str(e), file=sys.stderr)
        return 3
    found = checks.forbidden_modules()
    if found:
        print("loaded modules a run may not load: " + ", ".join(found),
              file=sys.stderr)
        return 4
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
