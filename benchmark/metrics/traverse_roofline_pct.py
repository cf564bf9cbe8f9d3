"""traverse_roofline_pct: the traversal kernels' share of their roofline.

Numerator: the least time of the queries, their lanes (scene.types.QUERIES,
dead lanes included) times 40 bytes (origin, direction, tmin and tmax in;
t and prim out, once each) at the H100's 3.35 TB/s. Denominator: the device
time of the traversal kernels, matched by the names below. Where no kernel
matches it reads nothing (never infinity)."""
from benchmark import peaks

KERNELS = ("traverse6_kernel", "traverse6_motion_kernel", "traverse5",
           "traverse7", "traverse1", "traverse2", "traverse3", "traverse4")
BYTES_PER_LANE = 40


def read(rec):
    s = rec.split
    if rec.mode != "render" or s is None or not s.get("lanes"):
        return None
    matched = [k for k in s["device"] if any(n in k[0] for n in KERNELS)]
    if not matched:
        rec.log("traverse_roofline_pct: no traversal kernel in the trace")
        return None
    t = sum(b - a for _, a, b in matched)
    least = s["lanes"] * BYTES_PER_LANE / peaks.H100["hbm_bytes_per_s"]
    names = sorted({k[0] for k in matched})
    rec.log(f"traverse_roofline_pct: {len(matched)} kernels matched "
            f"({', '.join(n[:60] for n in names)}), {s['lanes']} lanes, "
            f"card {rec.power_limit}")
    return 100.0 * least / t
