"""The readers of the port's own spans and counters (``port_spans.py`` and
the metric files that use it) on canned records, the arithmetic that
splits a fitting step's idle by span, the cell that collects them on the
CPU at a small size (sound, control and faults, and nothing collected in
an untraced run), the stretch over a port without the collector, and on
the card the clock that lays the spans beside the kernels."""
import pytest
import torch

from benchmark import harness, port_spans

from .conftest import shrink_config

AO = "bench100k.ao.2160p"
NEW = ("sampler_device_ms", "traverse_event_ms")


def _span(i, name, a, b, parent=None, unit=0, recompute=False, dev=None):
    s = {"id": i, "name": name, "start": a, "end": b,
         "start_ns": int(a * 1e9), "end_ns": int(b * 1e9), "parent": parent,
         "unit": unit, "recompute": recompute, "thread": 1, "attrs": {}}
    if dev is not None:
        s["device_ms"] = dev
    return s


def _canned(mode="render"):
    rec = harness.Record(mode=mode, setup_s=10.0, log=lambda *a: None)
    rec.port = {
        "spans": [_span(10, "wave", 0.0, 1.0),
                  _span(11, "sample", 0.1, 0.2, parent=10, dev=5.0),
                  _span(12, "sample", 0.12, 0.15, parent=11, dev=2.0),
                  _span(13, "traverse", 0.3, 0.5, parent=10, dev=7.0),
                  _span(14, "traverse", 0.31, 0.4, parent=13, dev=3.0),
                  _span(15, "wave", 1.0, 2.0, unit=1),
                  _span(16, "sample", 1.1, 1.2, parent=15, unit=1,
                        dev=4.0)],
        "counters": {"lanes/closest": 100, "lanes_live/closest": 100.0},
        "device": [("k", 0.0, 0.5), ("k", 0.7, 1.6)],
        "w0": 0.0, "w1": 2.0, "units": 2, "trace_start_ns": 0}
    return rec


def _fit():
    rec = _canned("grad")
    rec.port.update(
        spans=[_span(0, "grad.step", 0.0, 1.0),
               _span(1, "grad.forward", 0.0, 0.4, parent=0),
               _span(2, "grad.backward", 0.4, 1.0, parent=0),
               _span(3, "wave", 0.5, 0.8, parent=2, recompute=True),
               _span(4, "bounce", 0.6, 0.7, parent=3, recompute=True)],
        device=[("k", 0.1, 0.2), ("k", 0.5, 0.6), ("k", 0.9, 0.95)],
        w0=0.0, w1=1.2, units=1)
    return rec


def test_render_readers_on_a_canned_record():
    rec = _canned()
    read = lambda n: harness.metric_reader(n)(rec)           # noqa: E731
    # outermost spans only, over the stretch's two waves
    assert read("sampler_device_ms") == pytest.approx((5.0 + 4.0) / 2)
    assert read("traverse_event_ms") == pytest.approx(7.0 / 2)


def test_the_idle_of_a_step_splits_by_span():
    port = _fit().port
    spans = port["spans"]
    gaps = port_spans.stretch_gaps(port)
    # gaps 0-0.1, 0.2-0.5, 0.6-0.9, 0.95-1.2
    fwd = port_spans.overlap(gaps, port_spans.outermost(spans,
                                                        "grad.forward"))
    bwd = port_spans.overlap(gaps, port_spans.outermost(spans,
                                                        "grad.backward"))
    assert fwd == pytest.approx(0.3)            # 0-0.1 and 0.2-0.4
    assert bwd == pytest.approx(0.45)           # 0.4-0.5, 0.6-0.9, 0.95-1
    idle = sum(b - a for a, b in gaps)
    assert idle - fwd - bwd == pytest.approx(0.2)     # 1.0-1.2, outside
    # by the innermost span open at each gap's middle
    named = dict((k, v) for k, v in port_spans.idle_spans(port))
    assert named == pytest.approx({"grad.forward": 0.4, "wave": 0.3,
                                   "idle": 0.25})
    assert sum(named.values()) == pytest.approx(idle)


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_the_collector(name):
    for mode in ("render", "grad"):
        rec = harness.Record(mode=mode, setup_s=3.0, log=lambda *a: None)
        assert harness.metric_reader(name)(rec) is None


def test_stretch_leaves_nothing_without_the_collector(monkeypatch):
    monkeypatch.setattr(port_spans, "_stats", lambda: None)
    rec = harness.Record(mode="render", log=lambda *a: None)
    port_spans.stretch(torch.device("cpu"), rec, lambda: 1 / 0, 2)
    assert getattr(rec, "port", None) is None
    for name in NEW:
        assert harness.metric_reader(name)(rec) is None


def _ao(**kw):
    ov = {"config": shrink_config,
          "traffic": {"width": 24, "height": 16, "check_pixels": 64}}
    return harness.run_cell(AO, 3_100_000_021, 0.3, kw.pop("trace", False),
                            device="cpu", overrides=ov, log=lambda *a: None,
                            **kw)


def test_ao_cell_is_correct_and_untraced_collects_nothing(cpu_threads,
                                                         monkeypatch):
    from dartray_tpu_torch import stats

    def refuse(*a, **k):
        raise AssertionError("a span recorded in an untraced run")
    monkeypatch.setattr(stats.Span, "__init__", refuse)
    out = _ao()
    assert out["correct"], out["checks"]
    # the render mode's readers read this cell as a render cell
    assert "samples_per_s" in out["metrics"]


@pytest.mark.parametrize("kw", [{"control": "bf16"}, {"fault": "altered"},
                                {"fault": "half"}, {"fault": "unchanged"}])
def test_ao_cell_catches_the_control_and_faults(cpu_threads, kw):
    assert not _ao(**kw)["correct"]


def test_ao_cell_runs_over_a_port_without_the_collector(cpu_threads,
                                                        monkeypatch):
    monkeypatch.setattr(port_spans, "_stats", lambda: None)
    out = _ao(trace=True)
    assert out["correct"]
    assert not set(NEW) & set(out["metrics"])
    assert "scene_build_s" in out["metrics"]


@pytest.mark.cuda
def test_kernels_inside_a_synchronised_span_lie_inside_it(cuda_device):
    """Spans on time.time_ns() and the device trace share one clock."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import tracing
    from dartray_tpu_torch import stats
    x = torch.rand(1 << 22, device=cuda_device)
    torch.cuda.synchronize(cuda_device)
    rs = stats.RenderStats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with stats.collect(rs, events=True):
            with stats.span("work"):
                for _ in range(20):
                    x = torch.sin(x) * 1.0001
                torch.cuda.synchronize(cuda_device)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    dev, _, _ = tracing.split_events(prof.events())
    s, = port_spans.on_trace_clock(rs.export()["spans"], t0)
    assert len(dev) >= 20
    for _, a, b in dev:
        assert s["start"] <= a <= b <= s["end"]
    assert s["device_ms"] > 0
