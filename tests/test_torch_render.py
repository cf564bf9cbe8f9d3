"""PyTorch port, the slice as a whole: one scene through ``render_wave`` of
the JAX reference and of the port, with the same samples.

The reference runs un-jitted (no whole-wave XLA compile) with its Pallas
traversal kernel forced into interpret mode, so both sides go camera wave ->
merged extension+shadow launches -> last shadow wave over the same packed
BVH. The path-integrator renders of the reference (the Cornell box, static
and moving, and the benchmark scene) come from ``tools/render_golden.npz``
(``tools/make_render_golden.py``; the ``slow`` case renders them again);
the other integrators' are rendered here. Tolerance: >= 99 % of pixels
within rtol 1e-3 / atol 1e-4 and the image mean within 1e-3 relative: a ray
through an edge shared by two triangles may pick the other one, and a
mirror bounce then lands elsewhere.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dartray_tpu import film as ref_film
from dartray_tpu import materials as ref_mat
from dartray_tpu.integrators import ao as ref_ao
from dartray_tpu.integrators import direct as ref_di
from dartray_tpu.integrators import whitted as ref_wh
from dartray_tpu.renderers import sampler as ref_rend
from dartray_tpu.scene import build as ref_sb

import bench_torch
from dartray_tpu_torch import cameras, grad, samplers
from dartray_tpu_torch import film as film_mod
from dartray_tpu_torch import materials as mat_mod
from dartray_tpu_torch.core import transform as tr
from dartray_tpu_torch.integrators import ao, direct, whitted
from dartray_tpu_torch.integrators import path as pi
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.renderers import sampler as rend
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene import build as sb
from dartray_tpu_torch.scene import types as st

import torchhelp as th

sys.path.insert(0, os.path.join(th.ROOT, "tools"))
import make_render_golden as golden  # noqa: E402

torch.set_num_threads(1)

W, H, SPP, DEPTH = golden.W, golden.H, golden.SPP, golden.DEPTH
EYE, LOOK, UP, FOV = golden.EYE, golden.LOOK, golden.UP, golden.FOV
_reference_render = golden.reference_render


@pytest.fixture(scope="module")
def ref_golden():
    return np.load(golden.GOLDEN)


@pytest.fixture(scope="module")
def reference(ref_golden):
    """(image, film pixels, host scene) of the reference: its render of the
    Cornell box from the golden, its host scene built here."""
    return (ref_golden["cornell_img"], ref_golden["cornell_pixels"],
            ref_sb.cornell_box().build())


def _port_li(depth=DEPTH):
    ig = pi.PathIntegrator(max_depth=depth)
    return lambda s, r, d, c: pi.li(ig, s, r, d, c)


def _check_image(img, ref):
    assert img.shape == ref.shape == (H, W, 3) and np.isfinite(img).all()
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(img - ref).max())
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()


def test_render_matches_reference(reference):
    """The port end to end: its own scene compiler, ``render``."""
    ref_img, _, _ = reference
    cam = cameras.perspective(tr.look_at(EYE, LOOK, UP), FOV, W, H,
                              device="cpu")
    smp = samplers.make_sampler("lowdiscrepancy", spp=SPP)
    img = rend.render(sb.cornell_box().build(), cam, smp, _port_li(), W, H,
                      device="cpu")
    _check_image(img, ref_img)


def test_render_wave_on_the_reference_scene(reference):
    """``render_wave`` on the reference's own packed scene, carried over by
    the adapter; the film accumulator is compared too."""
    ref_img, ref_pixels, host = reference
    scene = st.to_device(adapt.from_reference(th.np_tree(host)), "cpu")
    cam = cameras.perspective(tr.look_at(EYE, LOOK, UP), FOV, W, H,
                              device="cpu")
    smp = samplers.make_sampler("lowdiscrepancy", spp=SPP)
    film = film_mod.make_film(W, H, device="cpu")
    px, py = rend.pixel_grid(W, H, device="cpu")
    assert th.same_bits(px.numpy(), np.asarray(ref_rend.pixel_grid(W, H)[0]))
    for s in range(smp.spp):
        film = rend.render_wave(
            scene, cam, smp, film, px, py,
            torch.full(px.shape, s, dtype=torch.int32), li_fn=_port_li(),
            width=W, height=H, spp=smp.spp, device="cpu")
    _check_image(film_mod.to_rgb(film).numpy(), ref_img)
    close = np.isclose(film.pixels.numpy(), ref_pixels, rtol=1e-3,
                       atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    # on the CPU the wrapper ran its plain version: no kernel was launched
    assert sum(tc.LAUNCHES.values()) == 0


SHIFT = golden.SHIFT
_moving_cornell = golden.moving_cornell


def _port_render(host, spp, depth):
    cam = cameras.perspective(tr.look_at(EYE, LOOK, UP), FOV, W, H,
                              device="cpu")
    smp = samplers.make_sampler("lowdiscrepancy", spp=spp)
    return rend.render(host, cam, smp, _port_li(depth), W, H, device="cpu")


def test_render_moving_scene_matches_reference(ref_golden):
    """Moving geometry end to end: camera rays draw their time from the
    shutter, every traversal (camera wave, merged launches, last shadow
    wave) runs the motion mode, shadow rays carry their surface ray's time.
    Reference: its v6 kernel with ``motion=True``, interpreted (golden)."""
    host = _moving_cornell(sb, SHIFT)
    assert host.geometry.has_motion
    img = _port_render(host, 1, 3)
    _check_image(img, ref_golden["moving_img"])
    still = _port_render(sb.cornell_box().build(), 1, 3)
    assert not np.allclose(img, still, rtol=1e-3, atol=1e-4)


def test_zero_delta_scene_renders_the_static_image():
    """``v + t * 0 == v`` bit for bit: a scene whose ``verts_end`` equals its
    ``verts`` goes through the motion mode and the ray-derived hit point and
    must still give the static scene's image. The hit point differs in its
    last bits (``o + t d`` against ``v0 + b1 e1 + b2 e2``), hence a tolerance
    on the image and equality on what the traversal returns."""
    moving = _moving_cornell(sb, np.zeros(3, np.float32))
    static = sb.cornell_box().build()
    assert moving.geometry.has_motion and not static.geometry.has_motion
    assert not moving.geometry.packed.soup16d.any()
    assert th.same_bits(moving.geometry.packed.soup16,
                        static.geometry.packed.soup16)
    cam = cameras.perspective(tr.look_at(EYE, LOOK, UP), FOV, W, H,
                              device="cpu")
    smp = samplers.make_sampler("lowdiscrepancy", spp=1)
    px, py = rend.pixel_grid(W, H, device="cpu")
    cs = samplers.camera_samples(smp, px, py, torch.zeros_like(px))
    rays, _, _ = cameras.generate_rays(cam, cs, W, H)
    hm = st.intersect(st.to_device(moving, "cpu").geometry, rays)
    hs = st.intersect(st.to_device(static, "cpu").geometry, rays)
    for a, b in zip(hm[:4], hs[:4]):
        assert torch.equal(a, b)
    img_m = _port_render(moving, 1, 3)
    img_s = _port_render(static, 1, 3)
    _check_image(img_m, img_s)


@pytest.mark.parametrize("name", ["direct", "whitted", "ao"])
def test_render_other_integrators_match_reference(name):
    """The three integrators that trace closest-hit and any-hit rays in
    SEPARATE launches, through the port's OWN scene compiler and ``render``
    (``tests/test_torch_integrators.py`` holds them on the reference's
    scene): the glass-and-mirror box, so the specular continuation runs."""
    rig, ig, rmod, mod = {
        "direct": (ref_di.DirectLightingIntegrator(max_depth=3),
                   direct.DirectLightingIntegrator(max_depth=3), ref_di,
                   direct),
        "whitted": (ref_wh.WhittedIntegrator(max_depth=3),
                    whitted.WhittedIntegrator(max_depth=3), ref_wh, whitted),
        "ao": (ref_ao.AOIntegrator(n_samples=3, max_dist=1.5),
               ao.AOIntegrator(n_samples=3, max_dist=1.5), ref_ao, ao),
    }[name]
    rb, b = ref_sb.cornell_box(), sb.cornell_box()
    rb.mat_rows[-2], b.mat_rows[-2] = ref_mat.glass(), mat_mod.glass()
    mp = pytest.MonkeyPatch()
    try:
        th.eager_reference(mp)
        film = _reference_render(
            rb.build(), EYE, LOOK, FOV, 1, 3,
            li=lambda s, r, d, c: rmod.li(rig, s, r, d, c))
    finally:
        mp.undo()
    cam = cameras.perspective(tr.look_at(EYE, LOOK, UP), FOV, W, H,
                              device="cpu")
    smp = samplers.make_sampler("lowdiscrepancy", spp=1)
    img = rend.render(b.build(), cam, smp,
                      lambda s, r, d, c: mod.li(ig, s, r, d, c), W, H,
                      device="cpu")
    _check_image(img, np.asarray(ref_film.to_rgb(film)))


BENCH_TRIS = golden.BENCH_TRIS


def test_render_bench_scene_matches_reference(ref_golden):
    """The benchmark scene (glass, matte, area light; a smaller displaced
    sphere) at the benchmark's camera, path depth 4 (into the glass, out of
    it, a diffuse hit behind it and its light sample): the port's own
    ``bench_scene`` and ``render`` against the reference's render of its
    own build of the scene (golden)."""
    eye, look, fov, depth = golden.BENCH_VIEW
    cam = cameras.perspective(tr.look_at(eye, look, UP), fov, W, H,
                              device="cpu")
    smp = samplers.make_sampler("lowdiscrepancy", spp=1)
    img = rend.render(sb.bench_scene(BENCH_TRIS).build(), cam, smp,
                      _port_li(depth), W, H, device="cpu")
    _check_image(img, ref_golden["bench_img"])


@pytest.mark.slow
def test_render_golden_is_the_references(ref_golden):
    """The reference, run again, renders the golden's images and film."""
    got, _ = golden.make()
    for k in ("cornell_img", "cornell_pixels", "moving_img", "bench_img"):
        assert np.array_equal(got[k], ref_golden[k]), k


_IMPORT_ALL = r"""
import importlib, os, sys
import dartray_tpu_torch
root = os.path.dirname(dartray_tpu_torch.__file__)
names = []
for d, subdirs, files in os.walk(root):
    subdirs[:] = [x for x in subdirs if x != "_build"]   # build outputs
    for f in files:
        if f.endswith(".py"):
            rel = os.path.relpath(os.path.join(d, f), os.path.dirname(root))
            names.append(rel[:-3].replace(os.sep, ".").removesuffix(".__init__"))
for n in names:
    importlib.import_module(n)
import bench_torch  # the port's bench: runs only under its __main__ guard
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "dartray_tpu" or m.startswith("dartray_tpu."))
assert len(names) >= 30, names
for m in ("core.prng", "core.sh", "integrators.prt", "integrators.bdpt",
          "renderers.probes", "renderers.metropolis"):
    assert "dartray_tpu_torch." + m in names, m
assert not bad, bad
assert "triton" not in sys.modules
print("imported", len(names))
"""


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the port and the port's bench, imported in a fresh
    interpreter, leave neither jax nor the JAX package in sys.modules."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


@pytest.mark.parametrize("entry", ["render", "render_wave", "make_film",
                                   "perspective", "pixel_grid", "to_device",
                                   "render_image", "render_loss_grad",
                                   "finite_difference", "bench_torch"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry):
    """No CUDA device here: every entry point's default device must raise,
    not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    c2w = tr.look_at(EYE, LOOK, UP)
    cam = cameras.perspective(c2w, FOV, 4, 4, device="cpu")
    smp = samplers.make_sampler("lowdiscrepancy", spp=1)
    film = film_mod.make_film(4, 4, device="cpu")
    px, py = rend.pixel_grid(4, 4, device="cpu")
    calls = {
        "render": lambda: rend.render(None, cam, smp, None, 4, 4),
        "render_wave": lambda: rend.render_wave(
            None, cam, smp, film, px, py, px, li_fn=None, width=4, height=4,
            spp=1),
        "make_film": lambda: film_mod.make_film(4, 4),
        "perspective": lambda: cameras.perspective(c2w, FOV, 4, 4),
        "pixel_grid": lambda: rend.pixel_grid(4, 4),
        "to_device": lambda: st.to_device({"a": np.zeros(3, np.float32)}),
        "render_image": lambda: grad.render_image(None, cam, smp, None, 4, 4),
        "render_loss_grad": lambda: grad.render_loss_grad(
            None, cam, smp, None, 4, 4, {}, None, None),
        "finite_difference": lambda: grad.finite_difference(
            None, cam, smp, None, 4, 4, {"a": np.ones(1, np.float32)},
            lambda s, t: s, lambda img: img.mean()),
        "bench_torch": bench_torch.main,
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
