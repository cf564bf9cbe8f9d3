"""motion_tri_tests_per_lane: the triangle tests a lane of the traversal
kernel's motion instantiation makes, in the stretch traced with the port's
collector on: the sum of the port's ``tests_motion/<mode>`` counters (each
warp of a motion launch adds its lanes' tests, ``ops/traverse_cuda.py``)
over the sum of its ``lanes_motion/<mode>`` (``scene/types.py``). Nothing
where the port counts no motion tests (a static scene, or a port whose
motion kernel has no counters) or no motion lanes."""


def _total(counters, prefix):
    return sum(v for k, v in counters.items() if k.startswith(prefix))


def read(rec):
    port = getattr(rec, "port", None)
    if not port:
        return None
    c = port["counters"]
    if not any(k.startswith("tests_motion/") for k in c):
        return None
    lanes = _total(c, "lanes_motion/")
    return _total(c, "tests_motion/") / lanes if lanes else None
