"""motion_tri_tests_per_lane on canned records: the motion tests over the
motion lanes of the collector's stretch, summed over modes; nothing where
the port counted no motion tests or ran no collector."""
import types

import pytest

from benchmark import registry


def _read(counters, port=True):
    rec = types.SimpleNamespace(
        port={"counters": counters, "spans": [], "units": 2}
        if port else None)
    return registry.load("metrics", "motion_tri_tests_per_lane").read(rec)


def test_tests_over_lanes_summed_over_modes():
    got = _read({"lanes_motion/closest": 10, "lanes_motion/any": 30,
                 "tests_motion/closest": 50.0, "tests_motion/any": 70.0,
                 "pops_motion/any": 99, "lanes/any": 1000,
                 "draws/kernel": 5})
    assert got == pytest.approx(120.0 / 40)


@pytest.mark.parametrize("counters", [
    {},                                          # a port without counters
    {"lanes_motion/any": 30},                    # lanes, no tests counted
    {"lanes/any": 30, "draws/kernel": 5},        # a static scene
    {"tests_motion/any": 0.0}])                  # tests, no lanes
def test_reads_nothing_without_motion_tests_and_lanes(counters):
    assert _read(counters) is None


def test_reads_nothing_without_the_collector():
    assert _read({}, port=False) is None
