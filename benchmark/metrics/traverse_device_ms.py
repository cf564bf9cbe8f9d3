"""traverse_device_ms: device time a wave of every kernel that ran inside
the benchmark's synchronised ranges around the port's traversal entry
points (scene.types.intersect, intersect_pair, intersect_p): the sort,
gathers and finish with the traversal kernel."""
from benchmark import tracing


def read(rec):
    s = rec.split
    if rec.mode != "render" or s is None or s.get("range") != "traversal":
        return None
    ranges = [r for r in s["ranges"] if r[0] == tracing.PREFIX + "traversal"]
    kern = tracing.inside(s["device"], ranges)
    if not kern:
        return None
    return sum(b - a for _, a, b in kern) / s["units"] * 1e3
