"""PyTorch port, the differentiable render (``dartray_tpu_torch/grad.py``).

The box of the reference's gradient tests, built by the reference and
carried over by ``scene/adapt.from_reference``, so that both packages
differentiate the same tables over the same packed BVH. On the CPU the
traversal runs its plain version (``traverse6_plain``).

The reference's gradient takes 40 s eagerly and minutes jitted on the CPU,
so the port is held against a golden file made by
``tools/make_grad_golden.py`` from ``dartray_tpu.grad
.render_pixel_jacobian_sum`` (its Pallas kernel interpreted); the slow case
makes it again and compares. Tolerance against the reference: rtol 5e-3 /
atol 1e-6, the reference's own interpret-vs-XLA bound
(``tests/test_grad.py:174-176``).
"""
import os
import sys

import numpy as np
import pytest
import torch

from dartray_tpu_torch import cameras, grad, samplers
from dartray_tpu_torch.core import transform as tr
from dartray_tpu_torch.integrators import path as pi
from dartray_tpu_torch.renderers import sampler as rend
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene import build as sb
from dartray_tpu_torch.scene import types as st

import torchhelp as th

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_grad_golden as golden  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def box():
    """The port's host scene of the reference's box."""
    return adapt.from_reference(th.np_tree(th.ref_box_scene()))


def _setup(wh, spp, depth=3, remat=None):
    """Camera, sampler and path integrator of the reference's gradient
    tests (``tests/test_grad.py:43-49``), on the CPU."""
    cam = cameras.perspective(
        tr.look_at(golden.EYE, golden.LOOK, golden.UP), golden.FOV, wh, wh,
        device="cpu")
    smp = samplers.make_sampler("lowdiscrepancy", spp=spp)
    ig = pi.PathIntegrator(max_depth=depth, remat=remat)
    return cam, smp, lambda s, r, d, c: pi.li(ig, s, r, d, c)


def _jacobian(scene, paths, wh, spp, depth=3, remat=None):
    cam, smp, li = _setup(wh, spp, depth, remat)
    theta, inject = grad.select(scene, paths)
    val, g = grad.render_pixel_jacobian_sum(scene, cam, smp, li, wh, wh,
                                            theta, inject, device="cpu")
    return float(val), {k: v.numpy() for k, v in g.items()}


def test_grad_matches_the_reference(box):
    """d mean(img) / d (kd, intensity) at the golden file's setting."""
    ref = np.load(golden.GOLDEN)
    val, g = _jacobian(box, golden.PATHS, golden.WIDTH, golden.SPP,
                       golden.DEPTH, remat=False)
    np.testing.assert_allclose(val, ref["loss"], rtol=5e-3, atol=1e-6)
    for p in golden.PATHS:
        assert np.isfinite(g[p]).all(), p
        np.testing.assert_allclose(g[p], ref[p], rtol=5e-3, atol=1e-6,
                                   err_msg=p)
    assert g["lights.intensity"][0, 1] > 0.0
    assert np.abs(g["materials.kd"][:2]).min() > 0.0   # the two lit mattes


@pytest.mark.slow
def test_golden_file_is_the_references_gradient():
    """The reference, run again, gives the committed golden gradient."""
    ref = np.load(golden.GOLDEN)
    new = golden.make()
    for k in ("loss", *golden.PATHS):
        np.testing.assert_allclose(new[k], ref[k], rtol=1e-6, atol=0,
                                   err_msg=k)


def test_grad_light_intensity_matches_fd(box):
    """Radiance is linear in light emission given fixed paths: autodiff
    against central differences with common random numbers, within 2 % of
    |fd| (``tests/test_grad.py:84-104``)."""
    cam, smp, li = _setup(8, 4)
    theta, inject = grad.select(box, ["lights.intensity"])
    _, g = grad.render_pixel_jacobian_sum(box, cam, smp, li, 8, 8, theta,
                                          inject, device="cpu")
    g_l = g["lights.intensity"].numpy()
    assert np.isfinite(g_l).all() and g_l[0, 1] > 0.0
    inten = theta["lights.intensity"]

    def inject_l(scene, t):
        table = torch.as_tensor(inten).clone()
        table[0, 1] = t["L"]
        return inject(scene, {"lights.intensity": table})

    fd = grad.finite_difference(box, cam, smp, li, 8, 8,
                                {"L": inten[0, 1]}, inject_l,
                                lambda img: img.mean(), eps=5e-2,
                                device="cpu")["L"]
    assert abs(g_l[0, 1] - fd) < 0.02 * max(abs(fd), 1e-4), (g_l[0, 1], fd)


def test_remat_grad_matches_unremat(box):
    """Per-bounce checkpoints change no gradient
    (``tests/test_grad.py:125-138``)."""
    _, g0 = _jacobian(box, ["materials.kd"], 8, 2, remat=False)
    _, g1 = _jacobian(box, ["materials.kd"], 8, 2, remat=True)
    np.testing.assert_allclose(g1["materials.kd"], g0["materials.kd"],
                               rtol=1e-4, atol=1e-7)


def test_render_image_matches_render(box):
    """The differentiable film (out of place, waves checkpointed) and the
    in-place one of ``render`` give the same image on the same samples."""
    cam, smp, li = _setup(8, 2)
    theta, inject = grad.select(box, ["materials.kd"])
    kd = torch.as_tensor(theta["materials.kd"]).clone().requires_grad_(True)
    img = grad.render_image(inject(box, {"materials.kd": kd}), cam, smp, li,
                            8, 8, device="cpu")
    assert img.requires_grad and img.shape == (8, 8, 3)
    ref = rend.render(box, cam, smp, li, 8, 8, device="cpu")
    np.testing.assert_allclose(img.detach().numpy(), ref, rtol=0, atol=1e-6)


def test_grad_through_specular_chain(box):
    """Paths through the glass sphere still carry gradients: finite for kd,
    kt and the light, nonzero for kd (``tests/test_grad.py:109-122``)."""
    _, g = _jacobian(box, ["materials.kd", "materials.kt",
                           "lights.intensity"], 8, 2, depth=4)
    for k, v in g.items():
        assert np.isfinite(v).all(), k
    assert np.abs(g["materials.kd"]).sum() > 0.0


def test_select_and_inject_leave_the_source_scene_unchanged(box):
    """``inject`` builds new tables; ``to_device`` keeps a leaf's graph."""
    kd0 = box.materials.kd.copy()
    theta, inject = grad.select(box, ["materials.kd", "lights.intensity"])
    assert theta["materials.kd"] is box.materials.kd
    kd = torch.ones(kd0.shape, requires_grad=True)
    new = inject(box, {"materials.kd": kd, "lights.intensity":
                       theta["lights.intensity"]})
    assert new is not box and new.materials is not box.materials
    assert new.materials.kd is kd and new.geometry is box.geometry
    assert th.same_bits(box.materials.kd, kd0)
    dev = st.to_device(new, "cpu")
    assert dev.materials.kd.requires_grad
    (g,) = torch.autograd.grad((dev.materials.kd * 3.0).sum(), kd)
    assert torch.equal(g, torch.full(kd0.shape, 3.0))


def _moving_cornell(shift):
    b = sb.cornell_box()
    b.meshes[-2].verts_end = b.meshes[-2].verts + np.asarray(shift,
                                                             np.float32)
    return b.build()


def test_moving_scene_grad_at_zero_delta_equals_static():
    """The motion mode under autograd: a Cornell box whose sphere moves by
    zero gives the static scene's gradient (its hit points come from the
    ray, o + t d, so they differ from the barycentric ones in the last
    bits); a moving sphere gives a finite one."""
    paths = ["materials.kd", "lights.intensity"]
    moving = _moving_cornell([0.0, 0.0, 0.0])
    assert moving.geometry.has_motion
    _, gs = _jacobian(sb.cornell_box().build(), paths, 8, 2)
    _, gz = _jacobian(moving, paths, 8, 2)
    _, gm = _jacobian(_moving_cornell([0.5, 0.0, 0.0]), paths, 8, 2)
    for p in paths:
        assert np.isfinite(gm[p]).all() and np.isfinite(gz[p]).all(), p
        np.testing.assert_allclose(gz[p], gs[p], rtol=1e-5, atol=1e-7,
                                   err_msg=p)


def test_no_bounce_carry_outlives_the_forward_pass(box, monkeypatch):
    """Memory O(1) in spp: after ``render_image``'s forward pass with
    per-bounce remat, no bounce's hit rows (the largest part of its carry)
    are alive; the waves' checkpoints recompute them in the backward pass."""
    import gc
    import weakref
    alive = []
    real = st.interaction

    def spy(geom, rays, hits, diffs=None):
        alive.append(weakref.ref(hits.rows))
        return real(geom, rays, hits, diffs)

    monkeypatch.setattr(st, "interaction", spy)
    cam, smp, li = _setup(8, 2, depth=4, remat=True)
    theta, inject = grad.select(box, ["materials.kd"])
    kd = torch.as_tensor(theta["materials.kd"]).clone().requires_grad_(True)
    img = grad.render_image(inject(box, {"materials.kd": kd}), cam, smp, li,
                            8, 8, device="cpu")
    gc.collect()
    assert len(alive) == 2 * 5
    assert not any(r() is not None for r in alive)
    (g,) = torch.autograd.grad(img.mean(), kd)
    assert np.isfinite(g.numpy()).all() and float(g.abs().sum()) > 0
