"""Files found by name: what a cell runs comes from modules of their own.

``load(kind, name)`` imports ``<bench>/<kind>/<name>.py``:

* ``modes/<mode>.py``: what a traffic mix's window runs (its ``mode``):
  the cell object, the check's numbers, the traced stretches and the
  faults that can be planted under it;
* ``integrators/<name>.py``: the port's radiance ``li`` for a scene handed
  over through ``SceneBuilder`` (``program(params)``) and the reference's
  estimator (``reference(params)``);
* ``shapes/<kind>.py``: one kind of shape as a numpy triangle mesh;
* ``metrics/<name>.py``: the reader of one metric, ``read(record)``.

A later cell adds such files beside these, and no file here changes.
"""
from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))
_CACHE = {}


def load(kind: str, name: str, bench: str = HERE):
    """The module ``<bench>/<kind>/<name>.py``, imported once a path."""
    path = os.path.join(str(bench), kind, name + ".py")
    if path not in _CACHE:
        if not os.path.isfile(path):
            raise KeyError(f"no {kind} {name!r}: {path} is missing")
        tag = "".join(c if c.isalnum() else "_" for c in f"{kind}_{name}")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{tag}_{len(_CACHE)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _CACHE[path] = mod
    return _CACHE[path]
