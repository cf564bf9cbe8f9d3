"""device_idle_pct.grad: the share of a step in which the device runs
nothing, in percent: one minus the device's busy time a step (the union of
its activity in a step traced with the device's activity alone) over the
median step of the window (untraced, each step synchronised). The traced
step itself is longer, because tracing slows the host that issues it."""
from benchmark import tracing


def read(rec):
    if rec.mode != "grad":
        return None
    return tracing.idle_pct_of_units(rec.trace, rec.unit_s)
