"""The render mode (``modes/render.py``: its set-up, window, check, traced
stretches and faults, unchanged), with one more traced stretch after the
render mode's own in a traced run: ``render.PROFILED_WAVES`` waves with
the port's collector on (``port_spans.stretch``), whose device idle by
innermost port span goes to standard error. An untraced run is the render
mode's.

The record's ``mode`` is "render", so every metric of a render cell reads
a cell of this mode as one.
"""
import os
import sys

from benchmark import port_spans, registry

render = registry.load("modes", "render",
                       os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))

GRAD = render.GRAD
SYNC_UNITS = render.SYNC_UNITS
numbers = render.numbers
FAULTS = render.FAULTS


class Cell(render.Cell):
    def __init__(self, cfg, traffic, seed, dev, rec, bench):
        rec.mode = "render"
        super().__init__(cfg, traffic, seed, dev, rec, bench)


def trace(obj, traffic, dev, rec):
    render.trace(obj, traffic, dev, rec)
    port_spans.stretch(dev, rec, obj.unit, render.PROFILED_WAVES)
    port = getattr(rec, "port", None)
    if port:
        print("idle_spans (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in port_spans.idle_spans(port)),
            file=sys.stderr, flush=True)
