"""device_idle_pct.render: the share of a wave in which the device runs
nothing, in percent: one minus the device's busy time a wave (the union of
its activity over waves traced with the device's activity alone) over the
median wave of the window (each wave synchronised in a traced run)."""
from benchmark import tracing


def read(rec):
    if rec.mode != "render":
        return None
    return tracing.idle_pct_of_units(rec.trace, rec.unit_s)
