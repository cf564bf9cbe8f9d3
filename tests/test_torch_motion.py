"""PyTorch port, moving geometry: the shutter-union build, the delta tables
and the motion mode of the traversal (plain version of the CUDA kernel)
against the JAX reference on the moving sphere of ``tests/test_bvh.py``.

Host tables are compared bit for bit. Traversal: hit masks equal to the
reference's CPU traversal AND to its Pallas kernel in interpret mode, finished
t within rtol 1e-4 (the three walks lerp with the same two f32 operations but
may pick another triangle at a shared edge), prim equal on > 0.99 of lanes.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dartray_tpu.core import math as ref_vm
from dartray_tpu.scene import mesh as ref_mesh
from dartray_tpu.scene import types as ref_st

from dartray_tpu_torch.accel import traverse as tv
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene import mesh as mesh_mod
from dartray_tpu_torch.scene import types as st

import torchhelp as th

torch.set_num_threads(1)

SHIFT = np.asarray([2.0, 0, 0], np.float32)
N = 256


def _moving_sphere(mod):
    m = mod.sphere(radius=0.5, nu=24, nv=12)
    m.verts_end = m.verts + SHIFT
    return m


@pytest.fixture(scope="module")
def world():
    """The moving sphere compiled by both packages, and one ray set aimed
    at the lerped sphere from a ring of origins, with random times."""
    rhost = ref_st.compile_geometry([_moving_sphere(ref_mesh)], [0], [-1])
    host = st.compile_geometry([_moving_sphere(mesh_mod)], [0], [-1])
    rng = np.random.RandomState(11)
    ts = rng.rand(N).astype(np.float32)
    ang = rng.rand(N) * 2 * np.pi
    o = np.stack([2.0 * ts + 3.0 * np.cos(ang), 3.0 * np.sin(ang),
                  -3.0 * np.ones(N)], -1).astype(np.float32)
    c = np.stack([2.0 * ts, np.zeros(N), np.zeros(N)], -1)
    d = (c - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(rhost=rhost, host=host, rgeom=ref_st.to_device(rhost),
                geom=st.to_device(host, "cpu"), o=o, d=d, ts=ts)


def _rays(w, o=None, ts=None):
    o = w["o"] if o is None else o
    ts = w["ts"] if ts is None else ts
    return vm.make_rays(th.t3(o), th.t3(w["d"]), time=torch.from_numpy(ts))


def _ref_rays(w, o=None, ts=None):
    o = w["o"] if o is None else o
    ts = w["ts"] if ts is None else ts
    return ref_vm.make_rays(th.j3(o), th.j3(w["d"]), time=jnp.asarray(ts))


def test_build_motion_and_delta_tables_exact(world):
    """``build_motion``, ``pack(deltas=)`` and ``soup16d``: every leaf of the
    port's compiled moving geometry equals the reference's, bit for bit; the
    reference's per-component delta planes hold the numbers of ``soup16d``."""
    host, ref = world["host"], th.np_tree(world["rhost"])
    assert host.has_motion and host.cl.tri_dv0 is not None
    n = 0
    for path, leaf in th.port_leaves(host).items():
        want = th.ref_leaf(ref, path)
        if isinstance(leaf, np.ndarray):
            assert th.same_bits(leaf, want), path
            n += 1
        else:
            assert leaf == (tuple(want) if isinstance(leaf, tuple)
                            else want), path
    assert n > 30
    s16d = host.packed.soup16d
    rp = ref["packed"]
    for c in range(3):
        for col, name in ((c, "tdv0"), (3 + c, "tde1"), (6 + c, "tde2")):
            assert th.same_bits(s16d[:, col], rp[name][c].reshape(-1)), name
    # pad slots: zero deltas and a zero id column, never added to soup16's
    pad = host.packed.soup16[:, 9].view(np.int32) < 0
    assert pad.any() and not s16d[pad].any() and not s16d[:, 9:].any()


def test_from_reference_carries_a_moving_scene(world):
    ref = th.np_tree(world["rhost"])
    geom = adapt._geometry(ref)
    assert geom.has_motion and geom.shutter == (0.0, 1.0)
    assert th.same_bits(geom.packed.soup16d, ref["packed"]["soup16d"])
    assert th.same_bits(geom.cl.tri_dv0, ref["cl"]["tri_dv0"])
    moved = st.to_device(geom, "cpu")
    assert torch.is_tensor(moved.packed.soup16d)
    h = st.intersect(moved, _rays(world))
    h0 = st.intersect(world["geom"], _rays(world))
    assert torch.equal(h.prim, h0.prim) and torch.equal(h.t, h0.t)


def test_shutter_time_is_normalised_and_clamped(world):
    import dataclasses
    geom = dataclasses.replace(world["geom"], shutter=(2.0, 4.0))
    rgeom = dataclasses.replace(world["rgeom"], shutter=(2.0, 4.0))
    ts = np.linspace(1.0, 5.0, N).astype(np.float32)
    got = st._shutter_time01(geom, _rays(world, ts=ts)).numpy()
    want = np.asarray(ref_st._shutter_time01(rgeom, _ref_rays(world, ts=ts)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got.min() == 0.0 and got.max() == 1.0


def _check_hits(h, rh):
    prim, rprim = h.prim.numpy(), np.asarray(rh.prim)
    assert ((prim >= 0) == (rprim >= 0)).all()
    assert (prim == rprim).mean() > 0.99
    both = (prim >= 0) & (rprim >= 0)
    np.testing.assert_allclose(h.t.numpy()[both], np.asarray(rh.t)[both],
                               rtol=1e-4)


def test_moving_sphere_matches_reference(world, monkeypatch):
    """``intersect``, ``intersect_p`` and ``intersect_pair`` (the mixed
    launch with the concatenated time plane) against the reference's CPU
    traversal and its interpreted Pallas kernel."""
    rays, rrays = _rays(world), _ref_rays(world)
    h = st.intersect(world["geom"], rays)
    h_pair, occ_pair = st.intersect_pair(world["geom"], rays, rays)
    occ = st.intersect_p(world["geom"], rays)
    assert h.hit.all()                      # all aimed at the lerped centre
    rh = ref_st.intersect(world["rgeom"], rrays)
    rocc = ref_st.intersect_p(world["rgeom"], rrays)
    monkeypatch.setattr(ref_st, "FORCE_PALLAS_INTERPRET", True)
    rh_k = ref_st.intersect(world["rgeom"], rrays)
    rh_pair, rocc_k = ref_st.intersect_pair(world["rgeom"], rrays, rrays)
    for mine in (h, h_pair):
        for theirs in (rh, rh_k, rh_pair):
            _check_hits(mine, theirs)
    for o_ in (occ, occ_pair):
        assert (o_.numpy() == np.asarray(rocc)).all()
        assert (o_.numpy() == np.asarray(rocc_k)).all()
    # the hit point of a moving scene comes from the ray
    it = st.interaction(world["geom"], rays, h)
    p = th.n3(it["p"])
    np.testing.assert_allclose(
        p, world["o"] + h.t.numpy()[:, None] * world["d"], atol=1e-4)
    rit = ref_st.interaction(world["rgeom"], rrays, rh)
    np.testing.assert_allclose(p, th.n3(rit["p"]), atol=1e-4)


def test_rays_at_the_start_position_with_the_end_time_miss(world):
    """Aimed at where the sphere WAS, stamped with (almost) the shutter's
    end: closest-hit and occlusion both miss, sorted or not."""
    rng = np.random.RandomState(5)
    o = (np.asarray([[0, 0, -3.0]]) + 0.1 * rng.randn(N, 3)).astype(
        np.float32)
    d = np.broadcast_to(np.asarray([0, 0, 1.0], np.float32), (N, 3)).copy()
    late = np.full(N, 1.0 - 1e-4, np.float32)
    rays = vm.make_rays(th.t3(o), th.t3(d), time=torch.from_numpy(late))
    for sort in (False, True):
        assert not st.intersect(world["geom"], rays, sort=sort).hit.any()
        assert not st.intersect_p(world["geom"], rays, sort=sort).any()
    early = rays._replace(time=torch.zeros(N))
    assert st.intersect(world["geom"], early).hit.all()
    assert st.intersect_p(world["geom"], early).all()


@pytest.mark.parametrize("mode", ["closest", "any", "mixed"])
def test_motion_walk_matches_bruteforce_with_time(world, mode):
    """``traverse6_plain(time=)`` against the exhaustive per-ray-time oracle,
    on rays that partly miss (random origins around the swept volume)."""
    host = world["host"]
    rng = np.random.RandomState(21)
    n = 512
    o = (rng.randn(n, 3) * 1.5 + [1.0, 0, 0]).astype(np.float32)
    # aimed at a point of the swept volume that is NOT the ray's own time
    aim = np.stack([2.0 * rng.rand(n), np.zeros(n), np.zeros(n)], -1)
    d = (aim + 0.3 * rng.randn(n, 3) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ts = rng.rand(n).astype(np.float32)
    rays = vm.make_rays(th.t3(o), th.t3(d), time=torch.from_numpy(ts))
    m = _moving_sphere(mesh_mod)
    from dartray_tpu_torch.accel import bvh as bvh_mod
    a = bvh_mod.triangles_to_mt(m.verts, m.faces)
    b = bvh_mod.triangles_to_mt(m.verts_end, m.faces)
    bf = tv.brute_force_intersect(
        *(torch.from_numpy(x) for x in a), rays,
        deltas=[torch.from_numpy(y - x) for x, y in zip(a, b)])
    assert 0.05 < bf.hit.float().mean() < 0.95
    bvh = world["geom"].packed
    anyf = None
    if mode == "mixed":
        anyf = torch.from_numpy((rng.rand(n) < 0.5).astype(np.float32))
    t, prim = tc.traverse6(bvh, rays.o, rays.d, rays.tmin, rays.tmax,
                           any_hit=(mode == "any"), anyf=anyf, time=rays.time)
    assert torch.equal(prim >= 0, bf.hit)
    closest = (torch.zeros(n, dtype=torch.bool) if mode == "any" else
               torch.ones(n, dtype=torch.bool) if anyf is None else anyf <= 0)
    ft, fprim, _, _ = tc.finish_hits(bvh, None, rays.o, rays.d, rays.tmin, t,
                                     prim, time=rays.time)
    sel = closest & bf.hit
    if mode != "any":       # any-hit lanes only promise the mask
        np.testing.assert_allclose(ft[sel].numpy(), bf.t[sel].numpy(),
                                   rtol=1e-4)
        assert (fprim[sel] == bf.prim[sel]).float().mean() > 0.99
    # a static walk over the same tables (time ignored) sees another scene
    t0, prim0 = tc.traverse6(bvh, rays.o, rays.d, rays.tmin, rays.tmax,
                             any_hit=(mode == "any"), anyf=anyf)
    assert not torch.equal(prim0 >= 0, bf.hit)


MODES = ["closest", "any", "mixed"]


def _swept_wave(n, seed):
    """Rays around the swept volume that partly miss, with random times and
    per-lane any-hit flags, a fifth of the lanes dead (numpy arrays)."""
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * 1.5 + [1.0, 0, 0]).astype(np.float32)
    aim = np.stack([2.0 * rng.rand(n), np.zeros(n), np.zeros(n)], -1)
    d = (aim + 0.3 * rng.randn(n, 3) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ts = rng.rand(n).astype(np.float32)
    tmax = np.where(rng.rand(n) < 0.2, -1.0, np.inf).astype(np.float32)
    anyf = (rng.rand(n) < 0.5).astype(np.float32)
    return o, d, ts, tmax, anyf


def _rays_of(o, d, ts, tmax):
    return vm.make_rays(th.t3(o), th.t3(d), tmax=torch.from_numpy(tmax),
                        time=torch.from_numpy(ts))


def _mode_kw(mode, anyf):
    return {"any_hit": mode == "any",
            "anyf": torch.from_numpy(anyf) if mode == "mixed" else None}


@pytest.mark.parametrize("mode", MODES)
def test_motion_ray_result_does_not_depend_on_its_neighbours(world, mode):
    """The motion walk, like the static one, gives every ray the raw
    (t, prim) it would get alone: permuted, in batches of 32 with a ragged
    tail, with dead lanes in between. Its own time travels with the ray."""
    n = 512
    o, d, ts, tmax, anyf = _swept_wave(n, seed=31)
    bvh = world["geom"].packed

    def walk(sel):
        dead = sel < 0
        s = np.where(dead, 0, sel)
        rays = _rays_of(o[s], d[s], ts[s],
                        np.where(dead, -1.0, tmax[s]).astype(np.float32))
        t, p = tc.traverse6_plain(bvh, rays.o, rays.d, rays.tmin, rays.tmax,
                                  time=rays.time, **_mode_kw(mode, anyf[s]))
        return t.numpy(), p.numpy()

    th.hold_rays_independent(walk, n, seed=33)


_moving_k = {}


def _moving_sphere_packed(k):
    """The moving sphere packed with clusters of `k` triangles, with its
    open soup and deltas for the brute-force oracle (cached)."""
    if k not in _moving_k:
        from dartray_tpu_torch.accel import bvh as bvh_mod, cluster
        m = _moving_sphere(mesh_mod)
        a = bvh_mod.triangles_to_mt(m.verts, m.faces)
        b = bvh_mod.triangles_to_mt(m.verts_end, m.faces)
        cb = cluster.build_motion(*a, *b, k=k)
        packed, perm = tc.pack(cb.node_lo, cb.node_hi, cb.node_child,
                               cb.node_axis, cb.tri_v0, cb.tri_e1, cb.tri_e2,
                               cb.tri_id,
                               deltas=(cb.tri_dv0, cb.tri_de1, cb.tri_de2))
        assert packed.k == k and packed.soup16d is not None
        _moving_k[k] = (st.to_device(packed, "cpu"), torch.from_numpy(perm),
                        a, [y - x for x, y in zip(a, b)])
    return _moving_k[k]


@pytest.mark.parametrize("k", [8, 40])
@pytest.mark.parametrize("mode", MODES)
def test_motion_other_cluster_sizes_match_bruteforce(k, mode):
    """The moving sphere in clusters narrower and wider than a warp: after
    the finish step closest lanes equal the per-ray-time brute force (prim
    equal, t to rtol 1e-5), any-hit lanes have its mask, dead lanes miss."""
    bvh, perm, soup, deltas = _moving_sphere_packed(k)
    n = 512
    o, d, ts, tmax, anyf = _swept_wave(n, seed=41)
    rays = _rays_of(o, d, ts, tmax)
    t, prim = tc.traverse6(bvh, rays.o, rays.d, rays.tmin, rays.tmax,
                           time=rays.time, **_mode_kw(mode, anyf))
    ft, fprim, _, _ = tc.finish_hits(bvh, perm, rays.o, rays.d, rays.tmin, t,
                                     prim, time=rays.time)
    bf = tv.brute_force_intersect(
        *(torch.from_numpy(x) for x in soup), rays,
        deltas=[torch.from_numpy(x) for x in deltas])
    assert torch.equal(prim >= 0, bf.hit) and bf.hit.any()
    assert not (prim >= 0)[torch.from_numpy(tmax) < 0].any()
    closest = torch.from_numpy({"closest": np.ones_like(anyf),
                                "any": np.zeros_like(anyf),
                                "mixed": 1.0 - anyf}[mode] > 0)
    sel = closest & bf.hit
    assert torch.equal(fprim[sel], bf.prim[sel])
    np.testing.assert_allclose(ft[sel].numpy(), bf.t[sel].numpy(), rtol=1e-5)
