"""The moving AO cell (``bench100k_moving.ao.2160p``) at a small size: the
port's CPU run against the moving reference, the moving reference with
no shift against the static one, the control and every planted fault
caught, the two motion metrics on canned records, and on the card the
cell traced at a small film. Its own overrides (``conftest.SMALL`` is
left as it is): a 2,000-triangle sphere, a 24x16 film, 64 check
pixels."""
import math

import pytest
import torch

from benchmark import harness, registry, scenes
from benchmark.reference import integrators as ref_ig
from benchmark.reference import motion as ref_motion
from benchmark.reference import render as ref_render
from benchmark.reference import sampling as ref_smp

from .conftest import shrink_config

CELL = "bench100k_moving.ao.2160p"
SMALL = {"width": 24, "height": 16, "check_pixels": 64}
MOTION = ("motion_kernel_event_ms", "motion_roofline_pct")


def _run(seed=3_100_000_031, **kw):
    return harness.run_cell(CELL, seed, 0.3, False, device="cpu",
                            overrides={"config": shrink_config,
                                       "traffic": dict(SMALL)},
                            log=lambda *a: None, **kw)


def test_port_agrees_with_the_moving_reference(cpu_threads):
    out = _run()
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        # far inside the cell's limits: the two sides round apart only
        assert c["value"] < 1e-4, (name, c)
    assert "samples_per_s" in out["metrics"]


@pytest.mark.parametrize("kw", [{"control": "bf16"}, {"fault": "altered"},
                                {"fault": "half"}, {"fault": "unchanged"},
                                {"fault": "frozen"}])
def test_control_and_faults_are_caught(cpu_threads, kw):
    assert not _run(**kw)["correct"]


def test_no_shift_is_the_static_reference(cpu_threads):
    """With translate_end = translate the moving reference's pixels are
    the static reference's (the lerp adds 0; the hit point o + t d differs
    from the static one's v0 + b1 e1 + b2 e2 by rounding only)."""
    def still(cfg):
        shrink_config(cfg)
        for s in cfg["shapes"]:
            if "motion" in s:
                s["motion"]["translate_end"] = list(s["translate"])
    man = harness.load_manifest()
    cfg = scenes.load_config(harness.config_path(man, "bench100k_moving"),
                             still)
    traffic = dict(harness.load_json("traffic", "ao_moving.2160p"), **SMALL)
    mode = registry.load("modes", "render_moving")
    moving = ref_motion.Scene(cfg["meshes"], mode.verts_end(cfg,
                                                            harness.HERE),
                              cfg["materials"], (0.0, 1.0), "cpu")
    static = harness.reference_scene(cfg, "cpu", torch.float32)
    assert torch.equal(moving.dv0, torch.zeros_like(moving.dv0))
    cam = harness.reference_camera(cfg, traffic, "cpu", torch.float32)
    smp = ref_smp.Sampler("lowdiscrepancy", 64, 11)
    px = torch.arange(0, 24, 3).repeat(2)
    py = torch.cat([torch.full((8,), 7), torch.full((8,), 10)])
    a = ref_render.pixel_values(
        moving, cam, smp, lambda sc, c, lanes, kd=None:
        ref_motion.ambient_occlusion(sc, c, lanes, n_samples=16), px, py, 4)
    b = ref_render.pixel_values(
        static, cam, smp, lambda sc, c, lanes, kd=None:
        ref_ig.ambient_occlusion(sc, c, lanes, n_samples=16), px, py, 4)
    assert (b > 0).any()
    assert torch.equal(a, b)


# --- the motion metrics on canned records ------------------------------------

def _record(kernels, spans, lanes=1000):
    rec = harness.Record(mode="render", log=lambda *a: None)
    rec.trace = {"device": kernels, "w0": 0.0, "w1": 1.0, "units": 2}
    rec.wave_lanes = lanes
    rec.port = {"spans": spans, "counters": {}, "device": kernels,
                "w0": 0.0, "w1": 1.0, "units": 2, "trace_start_ns": 0}
    return rec


def _kernel_span(i, ms, motion):
    return {"id": i, "name": "kernel", "start": 0.0, "end": 0.1,
            "parent": None, "unit": 0, "device_ms": ms,
            "attrs": {"motion": True} if motion else {}}


MOVING = [("void (anonymous namespace)::traverse6_kernel<true>(float4 "
           "const*, int4 const*)", 0.0, 0.004),
          ("void (anonymous namespace)::traverse6_kernel<true>(float4 "
           "const*, int4 const*)", 0.5, 0.504),
          ("void at::native::vectorized_elementwise_kernel<4>", 0.1, 0.3)]
STATIC = [("void (anonymous namespace)::traverse6_kernel<false>(float4 "
           "const*, int4 const*)", 0.0, 0.004)]


def test_motion_metrics_read_the_motion_launches_alone():
    rec = _record(MOVING, [_kernel_span(0, 3.0, True),
                           _kernel_span(1, 5.0, False),
                           _kernel_span(2, 1.0, True)])
    read = lambda n: harness.metric_reader(n)(rec)           # noqa: E731
    assert read("motion_kernel_event_ms") == pytest.approx((3.0 + 1.0) / 2)
    mod = registry.load("metrics", "motion_roofline_pct")
    assert mod.wave_bytes(1000) == 44_000
    # 44,000 B at 3.35 TB/s over 4 ms of motion kernel a wave
    assert read("motion_roofline_pct") == pytest.approx(
        100 * 44_000 / 3.35e12 / 0.004)


@pytest.mark.parametrize("kernels,lanes", [(STATIC, 1000), ([], 1000),
                                           (MOVING, 0), (MOVING, None)])
def test_motion_metrics_read_nothing_without_motion(kernels, lanes):
    rec = _record(kernels, [_kernel_span(0, 2.0, False)], lanes)
    for name in MOTION:
        assert harness.metric_reader(name)(rec) is None
    bare = harness.Record(mode="render", log=lambda *a: None)
    for name in MOTION:
        assert harness.metric_reader(name)(bare) is None


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_cell_on_the_card_at_a_small_film(cuda_device):
    out = harness.run_cell(
        CELL, 3_100_000_041, 1.0, True, device="cuda",
        overrides={"traffic": {"width": 64, "height": 48,
                               "check_pixels": 256}},
        log=lambda *a: None)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    m = out["metrics"]
    for name in MOTION:
        assert math.isfinite(m[name]["value"]) and m[name]["value"] > 0
    assert m["motion_roofline_pct"]["value"] < 100
