"""The span collector of ``dartray_tpu_torch.stats``: the span tree of a
path wave and of a fitting step, the recompute flag, nothing recorded and
no extra operation with the collector off, the profiler's clock, and the
live traversal lanes counted at the entry points."""
import contextlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from dartray_tpu_torch import cameras, grad, samplers, stats
from dartray_tpu_torch import film as film_mod
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.core import transform as tr
from dartray_tpu_torch.integrators import path as pi
from dartray_tpu_torch.renderers import sampler as rend
from dartray_tpu_torch.scene import build, parser
from dartray_tpu_torch.scene import types as st

W, H = 24, 16
N = 64


@pytest.fixture(scope="module")
def box():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    scene = st.to_device(build.cornell_box().build(), "cpu")
    cam = cameras.perspective(tr.look_at([0, 1, -3.6], [0, 1, 0],
                                         [0, 1, 0]), 40, W, H, device="cpu")
    ig = pi.PathIntegrator(max_depth=5)
    b = SimpleNamespace(
        scene=scene, cam=cam, li=lambda s, r, d, c: pi.li(ig, s, r, d, c),
        smp=samplers.make_sampler("lowdiscrepancy", spp=4, seed=3))
    b.px, b.py = rend.pixel_grid(W, H, device="cpu")
    wave(b)                        # the first wave's lazy set-up, untimed
    yield b
    torch.set_num_threads(n)


def wave(b, s=0):
    film = film_mod.make_film(W, H, device="cpu")
    return rend.render_wave(
        b.scene, b.cam, b.smp, film, b.px, b.py,
        torch.full(b.px.shape, s, dtype=torch.int32), li_fn=b.li, width=W,
        height=H, spp=4, device="cpu")


def fit_step(b, spp=1):
    theta, inject = grad.select(b.scene, ["materials.kd"])
    return grad.render_loss_grad(b.scene, b.cam, b.smp, b.li, 8, 8, theta,
                                 inject, lambda img: img.mean(), spp=spp,
                                 device="cpu")


def tree(rs):
    spans = rs.export()["spans"]
    by_id = {s["id"]: s for s in spans}
    parent = lambda s: by_id.get(s["parent"])          # noqa: E731

    def above(s):
        p = parent(s)
        while p is not None:
            yield p
            p = parent(p)
    return spans, parent, above


def test_a_path_wave_is_one_unit_of_nested_stages(box):
    rs = stats.RenderStats()
    with stats.collect(rs):
        wave(box, 0)
        wave(box, 1)
    spans, parent, above = tree(rs)
    waves = [s for s in spans if s["name"] == "wave"]
    assert len(waves) == 2 and all(w["parent"] is None for w in waves)
    assert len({w["unit"] for w in waves}) == 2
    for s in spans:
        top = ([s] + list(above(s)))[-1]
        assert top["name"] == "wave" and s["unit"] == top["unit"]
        assert not s["recompute"]
    kids = lambda name, of: {s["name"] for s in spans            # noqa: E731
                             if parent(s) and parent(s)["name"] == of}
    assert kids(None, "wave") == {"camera", "li", "film"}
    assert kids(None, "li") == {"traverse", "bounce"}
    assert kids(None, "bounce") == {"shade", "nee", "bsdf", "traverse"}
    assert kids(None, "traverse") == {"sort", "kernel", "finish"}
    assert kids(None, "camera") == {"sample"}
    assert {parent(s)["name"] for s in spans if s["name"] == "sample"
            and parent(s)["name"] != "sample"} == {"camera", "nee", "bsdf"}
    bounces = [s for s in spans if s["name"] == "bounce"
               and s["unit"] == waves[0]["unit"]]
    assert sorted(s["attrs"]["index"] for s in bounces) == list(range(6))
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        p = parent(s)
        if p is not None:
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]


def test_a_fitting_step_holds_forward_and_backward(box):
    rs = stats.RenderStats()
    with stats.collect(rs):
        fit_step(box, spp=2)
    spans, parent, above = tree(rs)
    step, = [s for s in spans if s["name"] == "grad.step"]
    assert step["parent"] is None and step["unit"] is not None
    assert {s["name"] for s in spans if parent(s) is step} == {
        "grad.forward", "grad.backward"}
    assert all(s["unit"] == step["unit"] for s in spans)
    under = lambda name: [s for s in spans if any(              # noqa: E731
        p["name"] == name for p in above(s))]
    assert len([s for s in under("grad.forward")
                if s["name"] == "wave"]) == 2
    # each checkpointed wave runs again inside the backward pass
    assert len([s for s in under("grad.backward")
                if s["name"] == "wave"]) == 2


def test_recompute_marks_the_backward_passs_spans_only(box):
    rs = stats.RenderStats()
    with stats.collect(rs):
        fit_step(box)
    spans, parent, above = tree(rs)
    for s in spans:
        names = {p["name"] for p in above(s)}
        assert s["recompute"] == ("grad.backward" in names), s["name"]
    assert any(s["recompute"] for s in spans)


def test_off_records_nothing_and_adds_no_operation(box, monkeypatch):
    assert stats.span("wave") is stats.NO_SPAN
    assert not stats.collecting()
    rs = stats.RenderStats()

    def refuse(*a, **k):
        raise AssertionError("recorded with the collector off")
    monkeypatch.setattr(stats.Span, "__init__", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with stats.TorchOps() as off:
        wave(box)
    assert rs.spans == [] and rs.counters == {}
    monkeypatch.setattr(stats, "span",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(stats, "count", lambda *a, **k: None)
    monkeypatch.setattr(stats, "collecting", lambda: False)
    with stats.TorchOps() as bare:
        wave(box)
    assert off.n == bare.n > 0
    monkeypatch.undo()
    with stats.collect(rs), stats.TorchOps() as on:
        wave(box)
    assert on.n > off.n         # the live lanes' sums, only when on


def test_spans_share_the_profilers_clock():
    rs = stats.RenderStats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stats.collect(rs), stats.span("outer"):
            time.sleep(2e-3)
            with record_function("inner"):
                torch.ones(64).sum()
            time.sleep(2e-3)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ev, = [e for e in prof.events() if e.name == "inner"]
    s, = rs.spans
    assert s.start_ns < t0 + ev.time_range.start * 1e3
    assert t0 + ev.time_range.end * 1e3 < s.end_ns


def _rays(dead_every, seed=0):
    """N rays from z = -1 toward +z over [-0.8, 0.8]^2; every
    `dead_every`-th lane dead (tmax -1)."""
    rng = np.random.RandomState(seed)
    o = np.concatenate([rng.uniform(-0.8, 0.8, (N, 2)),
                        np.full((N, 1), -1.0)], -1).astype(np.float32)
    d = np.tile(np.float32([0, 0, 1]), (N, 1))
    tmax = np.full(N, np.inf, np.float32)
    tmax[::dead_every] = -1.0
    return vm.make_rays(torch.from_numpy(o), torch.from_numpy(d),
                        tmax=torch.from_numpy(tmax)), int((tmax > 0).sum())


def _stack_scene(layers=3):
    """`layers` fully cut quads (alpha 0) at z = 0, 0.1, ... and a wall."""
    quads = "".join(
        'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" '
        f'[-1 -1 {z}  1 -1 {z}  1 1 {z}  -1 1 {z}] "texture alpha" "zero"\n'
        for z in np.arange(layers) * 0.1)
    text = ('LookAt 0 0 -3  0 0 0  0 1 0\nCamera "perspective"\n'
            'WorldBegin\nTexture "zero" "float" "constant" '
            '"float value" [0]\n' + quads
            + 'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
            '"point P" [-4 -4 2  4 -4 2  4 4 2  -4 4 2]\nWorldEnd\n')
    return st.to_device(parser.parse(text, device="cpu").scene, "cpu")


def test_live_lanes_of_a_merged_launch(box):
    ext, live_e = _rays(3)
    shadow, live_s = _rays(2, seed=1)
    rs = stats.RenderStats()
    with stats.collect(rs):
        st.intersect_pair(box.scene.geometry, ext, shadow)
    c = rs.counter_values()
    assert c == {"lanes/mixed": 2 * N, "lanes_live/mixed": live_e + live_s}


def test_live_lanes_through_the_alpha_rounds():
    """Every live ray pierces a cut layer in each of the first three
    rounds, so each continuation round re-traces exactly the live lanes;
    the dead ones stay dead. An alpha scene's pair is the split form, and
    its occlusion query is a closest-hit one."""
    scene = _stack_scene()
    geom = scene.geometry
    assert geom.has_alpha
    ext, live_e = _rays(3)
    shadow, live_s = _rays(2, seed=1)
    rs = stats.RenderStats()
    with stats.collect(rs):
        h, occ = st.intersect_pair(geom, ext, shadow)
    rounds = st.ALPHA_ROUNDS
    assert rs.counter_values() == {
        "lanes/closest": 2 * rounds * N,
        "lanes_live/closest": rounds * (live_e + live_s)}
    assert int((h.prim >= 0).sum()) == live_e
    assert int(occ.sum()) == live_s
