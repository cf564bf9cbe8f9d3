"""Checks the benchmark holds itself to: the characters of names and units
in BENCHMARK.json, and the modules a run may not load."""
from __future__ import annotations

import re
import sys

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# the JAX package and its stack: compared by whole top-level name, since
# the port's own name ("dartray_tpu_torch") begins with "dartray_tpu"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dartray_tpu"})


def forbidden_modules(names=None):
    """Top-level names among `names` (default: sys.modules) that a run may
    not load."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


def manifest_problems(man: dict):
    """Every name, unit and text field of a manifest that breaks the
    benchmark's rules of form; an empty list when it keeps them."""
    bad = []

    def name(kind, v):
        if not isinstance(v, str) or not NAME_RE.match(v):
            bad.append(f"{kind} {v!r} is not a valid name")

    def text(kind, v):
        if (not isinstance(v, str) or not 1 <= len(v) <= 200 or "\n" in v
                or "\t" in v):
            bad.append(f"{kind} {v!r} is not one line of 1-200 characters")

    for c in man.get("configs", []):
        name("config", c.get("name"))
        text("source", c.get("source"))
        text("why", c.get("why"))
        for k in c.get("reduced", []):
            name("reduced key", k)
    for w in man.get("workloads", []):
        name("workload", w.get("name"))
        name("config", w.get("config"))
        name("traffic", w.get("traffic"))
        text("why", w.get("why"))
    for group in ("end_to_end", "per_layer"):
        for m in man.get(group, []):
            name("metric", m.get("name"))
            if not isinstance(m.get("unit"), str) or not UNIT_RE.match(
                    m["unit"]):
                bad.append(f"unit {m.get('unit')!r} is not a valid unit")
            if m.get("better") not in ("lower", "higher"):
                bad.append(f"{m.get('name')}: better must be lower|higher")
            if group == "per_layer":
                text("layer", m.get("layer"))
    for word in man.get("command", []):
        text("command word", word)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e.get("name") for e in man.get(group, [])]
        if len(names) != len(set(names)):
            bad.append(f"two {group} entries share a name")
    return bad
