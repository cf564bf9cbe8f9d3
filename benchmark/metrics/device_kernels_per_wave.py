"""device_kernels_per_wave: device activities (kernels, copies, fills) in
the plain traced stretch, divided by its waves."""


def read(rec):
    t = rec.trace
    if rec.mode != "render" or t is None or not t["device"]:
        return None
    return len(t["device"]) / t["units"]
