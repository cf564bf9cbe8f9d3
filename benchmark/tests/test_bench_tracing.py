"""The metric arithmetic on small canned traces."""
import pytest

from benchmark import harness, tracing


def test_union_counts_overlap_once():
    iv = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0)]
    assert tracing.union_length(iv) == pytest.approx(4.0)


def test_gaps_and_clipping():
    iv = [("a", 1.0, 2.0), ("b", 1.5, 4.0), ("c", 6.0, 7.0)]
    assert tracing.gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0),
                                           (7.0, 10.0)]
    # clipped to the window
    assert tracing.union_length(tracing.clip(iv, 1.5, 3.5)) == \
        pytest.approx(2.0)


def test_gaps_named_by_innermost_host_op():
    ops = [("outer", 0.0, 10.0), ("inner", 3.0, 5.0)]
    named = tracing.name_gaps([(3.5, 4.5), (6.0, 8.0), (11.0, 12.0)], ops)
    assert dict((k, v) for k, v in named) == pytest.approx(
        {"inner": 1.0, "outer": 2.0, "idle": 1.0})


def test_inside_merges_nested_ranges():
    ranges = [("r", 0.0, 10.0), ("r", 2.0, 3.0)]
    iv = [("k1", 4.0, 5.0), ("k2", 11.0, 12.0)]
    assert tracing.inside(iv, ranges) == [("k1", 4.0, 5.0)]


def test_device_window_runs_from_the_first_activity():
    iv = [("k1", 2.0, 2.5), ("k0", 1.0, 1.5), ("late", 4.5, 5.0)]
    got = tracing.device_window(iv, 3.0)
    assert (got["w0"], got["w1"]) == (1.0, 4.0)
    assert sorted(d[0] for d in got["device"]) == ["k0", "k1"]
    assert tracing.union_length(got["device"]) == pytest.approx(1.0)


def _rec(**split):
    rec = harness.Record(mode="render", log=lambda *a: None,
                         power_limit="test card")
    rec.split = dict({"units": 1, "range": "traversal", "ranges": [],
                      "device": []}, **split)
    return rec


def test_roofline_share():
    read = harness.metric_reader("traverse_roofline_pct")
    # 1e6 lanes x 40 B at 3.35 TB/s = 11.94 us; the kernels took 100 us
    rec = _rec(lanes=1_000_000, device=[
        ("void traverse6_kernel<false>(float4)", 0.0, 60e-6),
        ("void traverse6_kernel<false>(float4)", 1e-3, 1e-3 + 40e-6),
        ("at::native::mul", 0.0, 1.0)])
    assert read(rec) == pytest.approx(100 * 40e6 / 3.35e12 / 100e-6)


def test_roofline_reads_nothing_without_a_matching_kernel():
    read = harness.metric_reader("traverse_roofline_pct")
    assert read(_rec(lanes=1000, device=[("at::native::mul", 0, 1)])) is None


def test_traversal_device_time_is_inside_its_ranges():
    read = harness.metric_reader("traverse_device_ms")
    rec = _rec(ranges=[("bench:traversal", 0.0, 1e-3)],
               device=[("sort", 1e-4, 2e-4), ("kernel", 3e-4, 6e-4),
                       ("shade", 2e-3, 3e-3)])
    assert read(rec) == pytest.approx(0.4)


def test_idle_and_kernels_per_wave():
    rec = harness.Record(mode="render", unit_s=[1.0, 0.9, 1.2])
    rec.trace = {"device": [("k", 0.0, 0.25), ("k", 0.5, 0.75)],
                 "w0": 0.0, "w1": 1.0, "units": 2}
    # busy 0.25 s a wave over the median wave of 1.0 s
    assert harness.metric_reader("device_idle_pct.render")(rec) == \
        pytest.approx(75.0)
    assert harness.metric_reader("device_kernels_per_wave")(rec) == 1.0
    assert harness.metric_reader("device_idle_pct.grad")(rec) is None
    rec.unit_s = []
    assert harness.metric_reader("device_idle_pct.render")(rec) is None


def test_end_to_end_readers():
    rec = harness.Record(mode="render", setup_s=3.0, window_s=2.0,
                         samples=10, units=5)
    assert harness.metric_reader("samples_per_s")(rec) == 5.0
    assert harness.metric_reader("grad_step_s")(rec) is None
    rec = harness.Record(mode="grad", window_s=9.0, units=3,
                         peak_mem_bytes=2 ** 30)
    assert harness.metric_reader("grad_step_s")(rec) == 3.0
    assert harness.metric_reader("grad_peak_mem_gib")(rec) == 1.0
