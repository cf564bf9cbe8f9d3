"""motion_roofline_pct: the share of its roofline that the traversal
kernel's motion instantiation reaches.

Numerator: the least time of a wave's lanes as the traffic states them
(``rec.wave_lanes``, set by the mode: the camera wave and every probe
wave) times ``BYTES_PER_LANE`` at the H100's 3.35 TB/s. Denominator: the
device time a wave of the kernels named ``traverse6_kernel<true>`` in the
stretch traced with the device's activity alone. Where no such kernel ran,
or the mode states no lanes, it reads nothing (never infinity)."""
import re

from benchmark import peaks

KERNEL = re.compile(r"traverse6_kernel\W*true\b")
# in: origin, direction, tmin, tmax and the shutter time (9 x 4 B);
# out: t and prim (2 x 4 B); each once
BYTES_PER_LANE = 44


def wave_bytes(lanes):
    """The bytes a wave of `lanes` motion lanes moves at the least."""
    return lanes * BYTES_PER_LANE


def read(rec):
    t = rec.trace
    lanes = getattr(rec, "wave_lanes", None)
    if rec.mode != "render" or t is None or not lanes:
        return None
    matched = [k for k in t["device"] if KERNEL.search(k[0])]
    busy = sum(b - a for _, a, b in matched) / t["units"]
    if busy <= 0:
        return None
    least = wave_bytes(lanes) / peaks.H100["hbm_bytes_per_s"]
    rec.log(f"motion_roofline_pct: {len(matched)} kernels over "
            f"{t['units']} waves, {lanes} lanes a wave, "
            f"card {rec.power_limit}")
    return 100.0 * least / busy
