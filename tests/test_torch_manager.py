"""PyTorch port, the scene front door as a whole: ``render_pbrt``, ``run``,
the render loop's options and the command line, on the CPU (the plain
traversal in place of the kernel).

The Cornell render is held against ``tools/pbrt_golden.npz``, the JAX
reference's own ``render_pbrt`` of ``scenes/cornell.pbrt`` (48x48, 8 spp,
depth 5; ``tools/make_pbrt_golden.py``), with the tolerance of
``tests/test_torch_render.py``: >= 99 % of pixels within rtol 1e-3 / atol
1e-4 and the image mean within 1e-3 relative. The reference compiles its
wave for minutes on the CPU, so no test here runs it; the slow case
recomputes the golden file.
"""
import os
import sys

import numpy as np
import pytest
import torch

from dartray_tpu_torch import __main__ as cli
from dartray_tpu_torch import film as film_mod
from dartray_tpu_torch import stats as stats_mod
from dartray_tpu_torch.accel import traverse as tv
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.integrators import ao, direct, whitted
from dartray_tpu_torch.integrators import path as pi
from dartray_tpu_torch.io import image as io_img
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.renderers import sampler as rend
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import types as st

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_pbrt_golden as golden  # noqa: E402

torch.set_num_threads(1)

CORNELL = os.path.join(ROOT, "scenes", "cornell.pbrt")
with open(CORNELL) as f:
    CORNELL_TEXT = f.read()
QUIET = lambda *a, **k: None   # noqa: E731

# the reference's preview-cadence scene (tests/test_overrides.py)
SMALL = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "lowdiscrepancy" "integer pixelsamples" [4]
SurfaceIntegrator "path" "integer maxdepth" [3]
LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
AttributeBegin
  Material "matte" "color Kd" [0.6 0.6 0.6]
  Shape "sphere" "float radius" [1]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "color L" [8 8 8]
  Translate 0 3 0
  Shape "disk" "float radius" [1]
AttributeEnd
WorldEnd
"""


def _check_image(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(img - ref).max())
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()


def _small_job(**ov):
    job = parser.parse(SMALL, log=QUIET, device="cpu")
    return manager.apply_overrides(job, {"resolution": (8, 8), **ov},
                                   log=QUIET)


def test_render_pbrt_matches_the_references_golden_image():
    """The whole front door on the file: parse, compile, render through the
    path integrator; the stats count what the render issued."""
    stats = stats_mod.RenderStats()
    img = manager.render_pbrt(CORNELL, log=QUIET, stats=stats, device="cpu")
    _check_image(img, np.load(golden.GOLDEN)["image"])
    c = stats.counters
    waves, lanes = 8, 48 * 48
    assert c["waves"] == waves and c["rays/camera"] == waves * lanes
    # path depth 5: a closest-hit wave, five merged extension + shadow
    # waves of twice the lanes, a last shadow wave
    assert c["rays/traversal_queries"] == waves * lanes * 2 * (5 + 1)
    assert c["scene/triangles"] == 8204
    assert set(stats.timings) == {"time/compile+first_wave", "time/render"}
    # on the CPU the wrappers ran their plain versions
    assert sum(tc.LAUNCHES.values()) == 0


@pytest.mark.slow
def test_golden_file_is_the_references_render():
    """The reference, run again, gives the committed golden image."""
    ref = np.load(golden.GOLDEN)["image"]
    assert np.array_equal(golden.make()["image"], ref)


INTEGRATORS = {
    "path": ({"maxdepth": 3}, lambda: pi.li, pi.PathIntegrator(max_depth=3)),
    "directlighting": ({"maxdepth": 3}, lambda: direct.li,
                       direct.DirectLightingIntegrator(max_depth=3)),
    "whitted": ({"maxdepth": 3}, lambda: whitted.li,
                whitted.WhittedIntegrator(max_depth=3)),
    "ambientocclusion": ({"nsamples": 3, "maxdist": 1.5}, lambda: ao.li,
                         ao.AOIntegrator(n_samples=3, max_dist=1.5)),
}


@pytest.mark.parametrize("name", sorted(INTEGRATORS))
def test_each_surface_integrator_is_the_ports_own(name):
    """Each integrator name of the file, at the quick override, renders the
    image of the port's integrator called directly on the same job."""
    params, li, ig = INTEGRATORS[name]
    job = manager.apply_overrides(
        parser.parse(CORNELL_TEXT, log=QUIET, device="cpu"),
        {"quick_render": True,
         "surfaceIntegrator": {"name": name, "params": params}}, log=QUIET)
    img = manager.run(job, log=QUIET, device="cpu")
    assert img.shape == (12, 12, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    want = rend.render(job.scene, job.camera, job.sampler,
                       lambda s, r, d, c: li()(ig, s, r, d, c), job.width,
                       job.height, device="cpu")
    assert np.array_equal(img, want)


def test_command_line_writes_the_render_as_png(tmp_path):
    out = tmp_path / "quick.png"
    assert cli.main([CORNELL, "--quick", "-q", "--device", "cpu",
                     "-o", str(out)]) == 0
    img = manager.render_pbrt(CORNELL, overrides={"quick_render": True},
                              log=QUIET, device="cpu")
    io_img.save(str(tmp_path / "want.png"), np.clip(img, 0.0, 1.0))
    assert out.read_bytes() == (tmp_path / "want.png").read_bytes()
    assert io_img.load(out.read_bytes(), "quick.png").shape == (12, 12, 3)


def test_aggregatetest_renderer_finds_no_mismatch():
    lines = []
    text = ('Renderer "aggregatetest" "integer niters" [512]\n'
            + CORNELL_TEXT)
    img = manager.render_pbrt(text, log=lines.append, device="cpu")
    assert img.shape == (48, 48, 3) and not img.any()
    assert lines == [lines[0]] and "512 rays, 0 hit mismatches" in lines[0]


def test_aggregatetest_sets_a_ray_with_inconsistent_bounds_apart():
    """A ray that grazes the back wall 1.9e-6 past its edge x = -1 (ray
    52675 of the test's 65,536 on this scene): the exhaustive intersector's
    barycentric tolerance accepts the hit, the walk's box test (like the
    reference's v6 for the ray alone) rejects it. Counted apart, as pbrt's
    aggregate test counts inconsistent bounds; the other rays agree."""
    job = parser.parse(CORNELL_TEXT, log=QUIET, device="cpu")
    geom = st.to_device(job.scene, "cpu").geometry
    rng = np.random.RandomState(3)
    o = np.concatenate([[[-1.0572213, 1.5414852, -0.10979182]],
                        rng.uniform(-1.5, 2.5, (255, 3))]).astype(np.float32)
    d = np.concatenate([[[0.046706766, -0.42091957, 0.9058947]],
                        rng.randn(255, 3)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = vm.make_rays(torch.from_numpy(o), torch.from_numpy(d))
    assert not st.intersect(geom, rays).hit[0]
    assert tv.brute_force_intersect(geom.v0, geom.e1, geom.e2, rays).hit[0]
    mism, inconsistent, max_dt = manager.aggregate_compare(geom, rays)
    assert (mism, inconsistent) == (0, 1) and max_dt < 1e-5


@pytest.mark.parametrize("mode,expect", [("full", [4]),
                                         ("twopass", [1, 4]),
                                         ("iterative", [1, 2, 3, 4])])
def test_sampling_mode_preview_cadence(mode, expect):
    """The reference's cadence (tests/test_overrides.py), through run."""
    seen = []
    manager.run(_small_job(samplingMode=mode),
                progress=lambda s, spp, film: seen.append(s), log=QUIET,
                device="cpu")
    assert seen == expect, (mode, seen)


def test_a_failing_wave_returns_the_waves_before_it():
    """on_error="partial" (what run passes): a wave that raises ends the
    render with the film of the waves before it, logged as an error."""
    job = _small_job()
    ig = pi.PathIntegrator(max_depth=3)

    def li(s, r, d, c):
        if int(c["s_idx"][0]) == 2:
            raise RuntimeError("wave 3 fails")
        return pi.li(ig, s, r, d, c)

    lines = []
    img = rend.render(job.scene, job.camera, job.sampler, li, 8, 8,
                      stats=stats_mod.RenderStats(), on_error="partial",
                      log=lines.append, device="cpu")
    scene = st.to_device(job.scene, "cpu")
    film = film_mod.make_film(8, 8, device="cpu")
    px, py = rend.pixel_grid(8, 8, device="cpu")
    for s in range(2):
        film = rend.render_wave(
            scene, job.camera, job.sampler, film, px, py,
            torch.full(px.shape, s, dtype=torch.int32), li_fn=li, width=8,
            height=8, spp=job.sampler.spp, device="cpu")
    assert np.array_equal(img, film_mod.to_rgb(film).numpy())
    assert len(lines) == 1 and "wave 3/4" in lines[0]
    with pytest.raises(RuntimeError, match="wave 3 fails"):
        rend.render(job.scene, job.camera, job.sampler, li, 8, 8,
                    device="cpu")


@pytest.mark.parametrize("entry", ["render_pbrt", "run", "parse", "main"])
def test_front_door_defaults_to_the_card_and_raises_without_one(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    calls = {
        "render_pbrt": lambda: manager.render_pbrt(CORNELL, log=QUIET),
        "run": lambda: manager.run(_small_job(), log=QUIET),
        "parse": lambda: parser.parse(SMALL),
        "main": lambda: cli.main([CORNELL, "-q", "-o", os.devnull]),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
