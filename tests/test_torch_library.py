"""PyTorch port, the library helpers that no render path calls: the
samplers, warps and heuristics of ``core/sampling.py``, the vector, sphere,
quadratic and box helpers of ``core/math.py``, ``core/spectrum.py``'s
``is_black`` and ``CIE_Y_INTEGRAL``, ``scene/mesh.py::concat_meshes``,
``cameras.CameraSamples`` and ``integrators/photonmap.py::gather_photons``,
against the JAX reference on seeded inputs.

Bit for bit where the arithmetic is the same on both sides: the hash-keyed
samplers, the digit permutations and the permuted radical inverse (held
against the reference's compiled loop, which fuses its multiply-add),
``concat_meshes``, the constants, the box helpers and the fold order of
``gather_photons``. Elsewhere (sines, cosines, square roots, a division)
within rtol 1e-6, atol 1e-7: one float32 ulp of a result below 1 is at most
6e-8, whichever library rounds it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu import cameras as ref_cameras
from dartray_tpu.core import math as ref_vm
from dartray_tpu.core import sampling as ref_smp
from dartray_tpu.core import spectrum as ref_spec
from dartray_tpu.integrators import path as ref_path
from dartray_tpu.integrators import photonmap as ref_pm
from dartray_tpu.scene import mesh as ref_mesh

from dartray_tpu_torch import cameras, samplers
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.core import sampling as smp
from dartray_tpu_torch.core import spectrum as spec
from dartray_tpu_torch.integrators import path
from dartray_tpu_torch.integrators import photonmap as pm
from dartray_tpu_torch.scene import mesh

import torchhelp as th

torch.set_num_threads(1)

N = 257
KEY = 0x9E3779B1


def _u32(x):
    return torch.tensor(x, dtype=torch.int64)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def _u2(seed=0):
    u = np.random.RandomState(seed).rand(N, 2).astype(np.float32)
    return jnp.asarray(u), torch.from_numpy(u)


# (name, reference call, port call): samplers keyed by a u32 hash key
KEYED = {
    "hash_combine": (
        lambda: ref_smp.hash_combine(jnp.arange(N, dtype=jnp.uint32),
                                     jnp.arange(N, dtype=jnp.uint32) * 7),
        lambda: smp.hash_combine(torch.arange(N), torch.arange(N) * 7)),
    "hash_combine_scalar": (
        lambda: ref_smp.hash_combine(KEY, jnp.arange(N, dtype=jnp.uint32)),
        lambda: smp.hash_combine(KEY, torch.arange(N))),
    "stratified_sample_1d": (
        lambda: ref_smp.stratified_sample_1d(N, KEY),
        lambda: smp.stratified_sample_1d(N, _u32(KEY))),
    "stratified_sample_1d_no_jitter": (
        lambda: ref_smp.stratified_sample_1d(N, KEY, jitter=False),
        lambda: smp.stratified_sample_1d(N, _u32(KEY), jitter=False)),
    "stratified_sample_2d": (
        lambda: ref_smp.stratified_sample_2d(5, 7, KEY),
        lambda: smp.stratified_sample_2d(5, 7, _u32(KEY))),
    "shuffle_permutation": (
        lambda: ref_smp.shuffle_permutation(N, KEY),
        lambda: smp.shuffle_permutation(N, _u32(KEY))),
    "latin_hypercube": (
        lambda: ref_smp.latin_hypercube(N, 3, KEY),
        lambda: smp.latin_hypercube(N, 3, _u32(KEY))),
}


@pytest.mark.parametrize("name", sorted(KEYED))
def test_keyed_samplers_are_the_references_bit_for_bit(name):
    ref_fn, port_fn = KEYED[name]
    want = np.asarray(ref_fn())
    got = port_fn().numpy()
    if want.dtype == np.uint32 or want.dtype == np.int32:
        assert np.array_equal(got, want.astype(np.int64)), name
    else:
        assert th.same_bits(got, want), name


def test_permuted_halton_is_the_references_bit_for_bit():
    """The digit permutations come from the same numpy stream; the
    radical inverse over 8 dimensions on small and large indices."""
    bases, perms = ref_smp.halton_permutations(8, seed=3)
    pbases, pperms = smp.halton_permutations(8, seed=3, device="cpu")
    assert pbases == bases
    for a, b in zip(pperms, perms):
        assert th.same_bits(a.numpy(), np.asarray(b))
    n = np.concatenate([np.arange(200), np.random.RandomState(4).randint(
        0, 2 ** 31 - 1, 57)]).astype(np.int32)
    for base, perm, pperm in zip(bases, perms, pperms):
        want = jax.jit(ref_smp.permuted_radical_inverse,
                       static_argnums=1)(jnp.asarray(n), base, perm)
        got = smp.permuted_radical_inverse(torch.from_numpy(n).long(), base,
                                           pperm)
        assert th.same_bits(got.numpy(), np.asarray(want)), base
    with pytest.raises(NotImplementedError):
        smp.ld_shuffle_scrambled_1d(4)


def _rows(seed):
    """Per-ray 3x3 matrices as the V3-of-V3 rows of both packages."""
    m = np.random.RandomState(seed).randn(3, 3, N).astype(np.float32)
    return (ref_vm.V3(*(ref_vm.V3(*(jnp.asarray(m[i, j]) for j in range(3)))
                        for i in range(3))),
            vm.V3(*(vm.V3(*(torch.from_numpy(m[i, j]) for j in range(3)))
                    for i in range(3))))


def _v3(seed):
    a = np.random.RandomState(seed).randn(N, 3).astype(np.float32)
    return th.j3(a), th.t3(a)


def _scalars(seed, lo=-1.0, hi=1.0):
    a = np.random.RandomState(seed).uniform(lo, hi, N).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _warp(name):
    """(reference result, port result) of one helper on seeded inputs."""
    ju, tu = _u2(1)
    (ja, ta), (jb, tb) = _v3(2), _v3(3)
    (js, ts), (jc, tc), (jp, tp) = (_scalars(4, 0, 1), _scalars(5),
                                    _scalars(6, 0, 7))
    if name == "uniform_sample_hemisphere":
        return (ref_smp.uniform_sample_hemisphere(ju),
                smp.uniform_sample_hemisphere(tu))
    if name == "uniform_sample_disk":
        return (ref_smp.uniform_sample_disk(ju),
                smp.uniform_sample_disk(tu))
    if name == "balance_heuristic":
        return (ref_smp.balance_heuristic(1, js, 4, jc * jc),
                smp.balance_heuristic(1, ts, 4, tc * tc))
    if name == "distance":
        return ref_vm.distance(ja, jb), vm.distance(ta, tb)
    if name == "distance_sq":
        return ref_vm.distance_sq(ja, jb), vm.distance_sq(ta, tb)
    if name == "spherical_direction":
        return (ref_vm.spherical_direction(js, jc, jp),
                vm.spherical_direction(ts, tc, tp))
    if name == "spherical_direction_basis":
        (jx, tx), (jy, ty), (jz, tz) = _v3(7), _v3(8), _v3(9)
        return (ref_vm.spherical_direction_basis(js, jc, jp, jx, jy, jz),
                vm.spherical_direction_basis(ts, tc, tp, tx, ty, tz))
    if name == "xform_vector3_rows":
        jm, tm = _rows(10)
        return ref_vm.xform_vector3_rows(jm, ja), vm.xform_vector3_rows(tm, ta)
    if name == "quadratic":
        return (ref_vm.quadratic(js, jc, jp - 1.0),
                vm.quadratic(ts, tc, tp - 1.0))
    raise KeyError(name)


WARPS = ["uniform_sample_hemisphere", "uniform_sample_disk",
         "balance_heuristic", "distance", "distance_sq", "spherical_direction",
         "spherical_direction_basis", "xform_vector3_rows", "quadratic"]


@pytest.mark.parametrize("name", WARPS)
def test_warps_and_vector_helpers_are_the_references(name):
    want, got = _warp(name)
    if isinstance(want, tuple):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            if w.dtype == jnp.bool_:
                assert np.array_equal(g.numpy(), np.asarray(w))
            else:
                _close(g.numpy(), w)
    else:
        _close(got.numpy(), want)
    if name == "quadratic":
        assert 0.2 < float(got[0].float().mean()) < 0.9


def test_box_helpers_are_the_references():
    """Empty box, unions, surface areas and the slab test on (N, 2, 3)
    boxes, bit for bit."""
    rng = np.random.RandomState(11)
    lo = rng.randn(N, 3).astype(np.float32)
    box = np.stack([lo, lo + rng.rand(N, 3).astype(np.float32)], 1)
    box2 = box[::-1].copy()
    p = rng.randn(N, 3).astype(np.float32) * 2
    o = rng.randn(N, 3).astype(np.float32) * 3
    d = rng.randn(N, 3).astype(np.float32)
    d[::2] = box[::2].mean(1) - o[::2]          # half aimed at their box
    inv = (1.0 / d).astype(np.float32)
    tmax = np.full(N, np.inf, np.float32)
    tmax[::3] = 0.3
    tmin = np.zeros(N, np.float32)
    j, t = jnp.asarray, torch.from_numpy
    pairs = [
        (ref_vm.bbox_empty(), vm.bbox_empty("cpu")),
        (ref_vm.bbox_union(j(box), j(box2)), vm.bbox_union(t(box), t(box2))),
        (ref_vm.bbox_union(ref_vm.bbox_empty(), j(box)),
         vm.bbox_union(vm.bbox_empty("cpu"), t(box))),
        (ref_vm.bbox_union_point(j(box), j(p)),
         vm.bbox_union_point(t(box), t(p))),
        (ref_vm.bbox_surface_area(j(box)), vm.bbox_surface_area(t(box))),
        (ref_vm.bbox_intersect_p(j(box[:, 0]), j(box[:, 1]), j(o), j(inv),
                                 j(tmin), j(tmax)),
         vm.bbox_intersect_p(t(box[:, 0]), t(box[:, 1]), t(o), t(inv),
                             t(tmin), t(tmax))),
    ]
    for i, (want, got) in enumerate(pairs):
        assert th.same_bits(got.numpy(), np.asarray(want)), i
    assert 0 < pairs[-1][1].float().mean() < 1


def test_constants_are_the_references():
    assert vm.EPS == float(ref_vm.EPS)
    assert vm.MACHINE_EPSILON == ref_vm.MACHINE_EPSILON
    assert spec.CIE_Y_INTEGRAL == ref_spec.CIE_Y_INTEGRAL
    assert smp.UNIFORM_HEMISPHERE_PDF == ref_smp.UNIFORM_HEMISPHERE_PDF
    assert path.SAMPLE_DEPTH == ref_path.SAMPLE_DEPTH


def test_is_black_is_the_references():
    c = np.random.RandomState(12).rand(N, 3).astype(np.float32)
    c[::4] = 0.0
    c[1::4, 1] = 0.0
    want = ref_spec.is_black(th.j3(c))
    assert np.array_equal(spec.is_black(th.t3(c)).numpy(), np.asarray(want))
    assert np.array_equal(spec.is_black(torch.from_numpy(c)).numpy(),
                          np.asarray(ref_spec.is_black(jnp.asarray(c))))
    assert 0 < np.asarray(want).mean() < 1


def test_concat_meshes_is_the_references():
    """Three meshes: with normals and uvs, without either, with uvs only;
    and two without either (no normals, no uvs in the result)."""
    a = ref_mesh.sphere(radius=0.5, nu=8, nv=4)
    b = ref_mesh.make_mesh([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5]],
                           [[0, 1, 2], [1, 3, 2]])
    c = ref_mesh.make_mesh([[0, 0, 1], [1, 0, 1], [0, 1, 2]], [[0, 1, 2]],
                           uvs=[[0, 0], [1, 0], [0, 1]])
    port = lambda m: mesh.TriangleMesh(m.verts, m.faces, m.normals,  # noqa
                                       m.uvs)
    for group in ((a, b, c), (b, b)):
        want = ref_mesh.concat_meshes(list(group))
        got = mesh.concat_meshes([port(m) for m in group])
        for f in ("verts", "faces", "normals", "uvs"):
            w, g = getattr(want, f), getattr(got, f)
            assert (w is None) == (g is None), f
            if w is not None:
                assert th.same_bits(g, w), f


def test_camera_samples_is_the_references():
    assert cameras.CameraSamples._fields == ref_cameras.CameraSamples._fields
    assert samplers.CameraSamples is cameras.CameraSamples


def test_gather_photons_folds_in_the_references_order(monkeypatch):
    """An order-sensitive fold (an int32 rolling hash of the photons each
    query scans, and float sums within the radius) over a map with crowded
    cells, MAX_SCAN cut to 8 on both sides: bit for bit."""
    th.eager_reference(monkeypatch)
    monkeypatch.setattr(ref_pm, "MAX_SCAN", 8)
    monkeypatch.setattr(pm, "MAX_SCAN", 8)
    rng = np.random.RandomState(13)
    p = rng.uniform(-0.5, 0.5, (600, 3)).astype(np.float32)
    p[100:130] = p[99]                              # one crowded cell
    wi = rng.randn(600, 3).astype(np.float32)
    al = rng.rand(600, 3).astype(np.float32)
    q = rng.uniform(-0.4, 0.4, (32, 3)).astype(np.float32)
    q[0] = p[99]
    r2 = np.float32(0.02)

    def fold(xp, where, to_i32):
        def acc(c, pp, pwi, pal, valid):
            h, s = c
            code = to_i32(pp.x * 1000.0) ^ to_i32(pwi.y * 1000.0)
            h = where(valid, h * 31 + code, h)
            d2 = (pp.x - qq.x) ** 2 + (pp.y - qq.y) ** 2 + (pp.z - qq.z) ** 2
            inside = valid & (d2 < r2)
            return h, s + where(inside, pal.x, 0.0)
        return acc

    qq = th.j3(q)
    rmap = ref_pm.build_map(jnp.asarray(p), jnp.asarray(wi), jnp.asarray(al),
                            0.1)
    want = ref_pm.gather_photons(
        rmap, qq, fold(jnp, jnp.where, lambda x: x.astype(jnp.int32)),
        (jnp.zeros(32, jnp.int32), jnp.zeros(32, jnp.float32)))
    qq = th.t3(q)
    pmap = pm.build_map(th.t3(p), th.t3(wi), th.t3(al), 0.1)
    got = pm.gather_photons(
        pmap, qq, fold(torch, torch.where, lambda x: x.to(torch.int32)),
        (torch.zeros(32, dtype=torch.int32), torch.zeros(32)))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert th.same_bits(got[1].numpy(), np.asarray(want[1]))
    assert (np.asarray(want[1]) > 0).mean() > 0.5
