"""PyTorch port, the cameras and the transforms they are built from:
orthographic (with and without depth of field), environment, perspective
with an animated transform; rotations, handedness, quaternions, the polar
decomposition and the animated transform, against the JAX reference on the
same seeded camera samples.

Matrices are host numpy on both sides and equal bit for bit. Rays and their
differentials agree to 1e-6 (rtol and atol: the two libraries' sin / cos
may differ by an ulp). Known behaviour p: the animated camera transform is
stored and never applied; rays leave through the shutter-open transform.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu import cameras as ref_cam
from dartray_tpu.core import math as ref_vm
from dartray_tpu.core import transform as ref_tr

from dartray_tpu_torch import cameras as cam
from dartray_tpu_torch import samplers as smp
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.core import transform as tr

import torchhelp as th

torch.set_num_threads(1)

N = 512
W, H = 40, 24
TOL = 1e-6


def _samples(seed=0):
    rng = np.random.RandomState(seed)
    img = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)],
                   -1).astype(np.float32)
    lens = rng.rand(N, 2).astype(np.float32)
    t = rng.rand(N).astype(np.float32)
    port = smp.CameraSamples(
        vm.V2(*(torch.from_numpy(img[:, i].copy()) for i in range(2))),
        vm.V2(*(torch.from_numpy(lens[:, i].copy()) for i in range(2))),
        torch.from_numpy(t))
    ref = ref_cam.CameraSamples(
        ref_vm.V2(jnp.asarray(img[:, 0]), jnp.asarray(img[:, 1])),
        ref_vm.V2(jnp.asarray(lens[:, 0]), jnp.asarray(lens[:, 1])),
        jnp.asarray(t))
    return port, ref


def _c2w(mod):
    return mod.look_at([0.3, 1.0, -3.0], [0.0, 0.8, 0.0], [0, 1, 0])


def _both(kind, **kw):
    """(port camera, reference camera) of one kind over the same c2w."""
    if kind == "perspective":
        return (cam.perspective(_c2w(tr), 45.0, W, H, device="cpu", **kw),
                ref_cam.perspective(_c2w(ref_tr), 45.0, W, H, **kw))
    if kind == "orthographic":
        return (cam.orthographic(_c2w(tr), W, H, device="cpu", **kw),
                ref_cam.orthographic(_c2w(ref_tr), W, H, **kw))
    return (cam.environment(_c2w(tr), W, H, device="cpu", **kw),
            ref_cam.environment(_c2w(ref_tr), W, H, **kw))


CASES = {
    "orthographic": ("orthographic", {}),
    "orthographic_window": ("orthographic",
                            {"screen_window": (-2.0, 1.0, -0.5, 1.5)}),
    "orthographic_dof": ("orthographic", {"lens_radius": 0.2,
                                          "focal_distance": 3.5,
                                          "shutter_open": 0.25,
                                          "shutter_close": 0.75}),
    "environment": ("environment", {"shutter_open": 0.1}),
    "perspective_dof": ("perspective", {"lens_radius": 0.1,
                                        "focal_distance": 2.0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rays_equal_the_references(case):
    kind, kw = CASES[case]
    port, ref = _both(kind, **kw)
    assert port.kind == ref.kind
    for f in ("raster2camera", "dx_camera", "dy_camera"):
        assert th.same_bits(getattr(port, f), np.asarray(getattr(ref, f))), f
    ps, rs = _samples()
    diff_scale = 0.5
    prays, pd, pw = cam.generate_rays(port, ps, W, H, diff_scale)
    rrays, rd, rw = ref_cam.generate_rays(ref, rs, W, H, diff_scale)
    close = lambda a, b: np.testing.assert_allclose(
        th.n3(a) if isinstance(a, vm.V3) else a.numpy(),
        th.n3(b) if isinstance(b, ref_vm.V3) else np.asarray(b),
        rtol=TOL, atol=TOL)
    close(prays.o, rrays.o)
    close(prays.d, rrays.d)
    for f in ("tmin", "tmax", "time"):
        close(getattr(prays, f), getattr(rrays, f))
    for a, b in zip(pd, rd):
        close(a, b)
    close(pw, rw)


def test_animated_camera_is_stored_and_never_applied():
    """Known behaviour p: an animated camera keeps its animated transform,
    and its rays are those of the static shutter-open camera."""
    end = tr.translate([0.5, 0.0, 0.2]) * _c2w(tr)
    anim = tr.animated(_c2w(tr), end, 0.0, 1.0)
    ref_anim = ref_tr.animated(_c2w(ref_tr), ref_tr.translate(
        [0.5, 0.0, 0.2]) * _c2w(ref_tr), 0.0, 1.0)
    moving = cam.perspective(_c2w(tr), 45.0, W, H, animated=anim,
                             device="cpu")
    still = cam.perspective(_c2w(tr), 45.0, W, H, device="cpu")
    ref = ref_cam.perspective(_c2w(ref_tr), 45.0, W, H, animated=ref_anim)
    assert moving.animated is anim and anim.actually_animated
    ps, rs = _samples(1)
    a, _, _ = cam.generate_rays(moving, ps, W, H)
    b, _, _ = cam.generate_rays(still, ps, W, H)
    r, _, _ = ref_cam.generate_rays(ref, rs, W, H)
    for f in ("o", "d"):
        assert torch.equal(vm.to_arr(getattr(a, f)),
                           vm.to_arr(getattr(b, f)))
        np.testing.assert_allclose(th.n3(getattr(a, f)),
                                   th.n3(getattr(r, f)), rtol=TOL, atol=TOL)
    # where the camera WOULD be at the shutter's end, had it moved
    m = anim.interpolate_matrix(torch.tensor([0.0, 0.5, 1.0]))
    want = np.asarray(ref_anim.interpolate_matrix(jnp.asarray([0.0, 0.5,
                                                               1.0])))
    np.testing.assert_allclose(m.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m[2].numpy(), end.m, atol=1e-4)


@pytest.mark.parametrize("which", ["rotate_x", "rotate_y", "rotate_z"])
def test_axis_rotations_are_the_references(which):
    got, want = getattr(tr, which)(37.5), getattr(ref_tr, which)(37.5)
    assert th.same_bits(got.m, np.asarray(want.m))
    assert th.same_bits(got.m_inv, np.asarray(want.m_inv))


def test_handedness_scale_and_decomposition_are_the_references():
    mats = [tr.rotate(30.0, [1, 2, 3]), tr.scale(1.0, -2.0, 1.0),
            tr.translate([1, 2, 3]) * tr.rotate_y(75.0) * tr.scale(
                2.0, 0.5, 1.5), tr.orthographic(0.5, 4.0)]
    for t in mats:
        r = ref_tr.from_matrix(t.m)
        assert t.swaps_handedness() == r.swaps_handedness()
        assert t.has_scale() == r.has_scale()
        for got, want in zip(tr.decompose(t.m), ref_tr.decompose(t.m)):
            assert th.same_bits(got, np.asarray(want))
    assert th.same_bits(tr.orthographic(0.5, 4.0).m,
                        np.asarray(ref_tr.orthographic(0.5, 4.0).m))
    q = np.random.RandomState(3).randn(6, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = np.linspace(0, 1, 6).astype(np.float32)
    np.testing.assert_allclose(
        tr.quat_to_matrix(torch.from_numpy(q)).numpy(),
        np.asarray(ref_tr.quat_to_matrix(jnp.asarray(q))), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        tr.slerp(torch.from_numpy(t), torch.from_numpy(q),
                 torch.from_numpy(q[::-1].copy())).numpy(),
        np.asarray(ref_tr.slerp(jnp.asarray(t), jnp.asarray(q),
                                jnp.asarray(q[::-1].copy()))),
        rtol=1e-5, atol=1e-6)
