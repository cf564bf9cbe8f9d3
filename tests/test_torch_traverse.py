"""PyTorch port, traversal: the plain versions of the CUDA kernels (v6 per-ray
walk, v5 packet walk, v7 packet walk with the Woop leaf test) and the glue
around them against (a) the reference's Pallas kernels in interpret mode on
the SAME packed BVH and (b) brute force.

Tolerances: hit masks agree on >= 0.999 of rays and the 0.999-quantile
relative error of the finished t is < 1e-3 (a ray through a shared edge or an
exact tie may pick another triangle; the kernels' raw t is approximate, so
only finished values are compared); any-hit masks must be equal; packing,
sort keys and the finish step are exact (same f32 operations).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dartray_tpu.accel import cluster as ref_cluster, traverse as ref_tv
from dartray_tpu.core import math as ref_vm
from dartray_tpu.ops import traverse_pallas as tp

from dartray_tpu_torch.accel import cluster, traverse as tv
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene.types import to_device

import torchhelp as th

torch.set_num_threads(1)

N_RAYS = 512


@pytest.fixture(scope="module")
def world():
    """One soup, packed by both packages; rays; the brute-force answers."""
    v0, e1, e2 = th.soup()
    cb = cluster.build(v0, e1, e2, k=32)
    packed, perm = tc.pack(cb.node_lo, cb.node_hi, cb.node_child,
                           cb.node_axis, cb.tri_v0, cb.tri_e1, cb.tri_e2, cb.tri_id)
    rcb = ref_cluster.build(v0, e1, e2, k=32)
    rpacked, rperm = tp.pack(rcb.node_lo, rcb.node_hi, rcb.node_child,
                             rcb.node_axis, rcb.tri_v0, rcb.tri_e1,
                             rcb.tri_e2, rcb.tri_id)
    lo, hi = v0.min(0) - 1.0, v0.max(0) + 1.0
    return dict(v0=v0, e1=e1, e2=e2, packed=packed, perm=perm,
                bvh=to_device(packed, "cpu"), permt=torch.from_numpy(perm),
                bvh_woop=to_device(tc.with_woop(packed), "cpu"),
                rpacked=rpacked, rpacked_woop=tp.with_woop(rpacked),
                rperm=rperm, lo=lo, hi=hi)


def _port_rays(o, d, tmax=None):
    return vm.make_rays(th.t3(o), th.t3(d),
                        tmax=None if tmax is None else torch.from_numpy(tmax))


def _ref_rays(o, d, tmax=None):
    return ref_vm.make_rays(th.j3(o), th.j3(d),
                            tmax=None if tmax is None else jnp.asarray(tmax))


def _check_closest(t, prim, ref_t, ref_hit):
    hit = prim >= 0
    assert (hit == ref_hit).mean() >= 0.999, (hit != ref_hit).sum()
    both = hit & ref_hit
    rel = np.abs(t[both] - ref_t[both]) / np.maximum(np.abs(ref_t[both]), 1e-3)
    assert np.quantile(rel, 0.999) < 1e-3, rel.max()


def test_pack_exact(world):
    ref = th.np_tree(world["rpacked"])
    for path, leaf in th.port_leaves(world["packed"]).items():
        want = th.ref_leaf(ref, path)
        if isinstance(leaf, np.ndarray):
            assert th.same_bits(leaf, want), path
        else:
            assert leaf == want, path
    assert th.same_bits(world["perm"], np.asarray(world["rperm"]))


def test_pack_keeps_pad_slots_last(world):
    """The kernel ends a leaf at its first pad row (id < 0), the plain
    version masks pads wherever they are: the two agree only while pads
    trail in every cluster, so ``pack`` must hold that and refuse a soup
    that breaks it."""
    packed = world["packed"]
    ids = packed.soup16[:, 9].view(np.int32).reshape(packed.n_clusters,
                                                     packed.k)
    pad = ids < 0
    assert pad.any() and not (pad[:, :-1] & ~pad[:, 1:]).any()
    bad = ids.copy()
    c = int(np.argmax(~pad[:, 1]))         # a cluster with >= 2 triangles
    bad[c, 0] = -1
    z = np.zeros(bad.shape + (3,), np.float32)
    with pytest.raises(ValueError, match="pad slot"):
        tc.pack(None, None, None, None, z, z, z, bad)


@pytest.mark.parametrize("with_flag", [False, True])
def test_sort_key_exact(world, with_flag):
    o, d = th.ray_arrays(4096, seed=21)
    rng = np.random.RandomState(22)
    tmin = np.zeros(4096, np.float32)
    tmax = np.where(rng.rand(4096) < 0.3, -1.0, np.inf).astype(np.float32)
    af = (rng.rand(4096) < 0.5).astype(np.float32) if with_flag else None
    want = tp.sort_key_i32(
        [jnp.asarray(o[:, c]) for c in range(3)],
        [jnp.asarray(d[:, c]) for c in range(3)], jnp.asarray(tmin),
        jnp.asarray(tmax), jnp.asarray(world["lo"]), jnp.asarray(world["hi"]),
        anyflag=None if af is None else jnp.asarray(af))
    got = tc.sort_key_i32(
        list(th.t3(o)), list(th.t3(d)), torch.from_numpy(tmin),
        torch.from_numpy(tmax), torch.from_numpy(world["lo"]),
        torch.from_numpy(world["hi"]),
        anyflag=None if af is None else torch.from_numpy(af))
    assert th.same_bits(got.numpy(), np.asarray(want))


def test_finish_hits_rows_exact(world):
    """Random winners (and misses) through both finish steps, with a 48-wide
    rows table laid out like the geometry's attrp."""
    rng = np.random.RandomState(31)
    ck = world["perm"].shape[0]
    attrp = rng.randn(ck, 48).astype(np.float32)
    attrp[:, 0:9] = world["packed"].soup16[:, 0:9]
    attrp[:, 36] = world["perm"].view(np.float32)
    o, d = th.ray_arrays(N_RAYS, seed=32)
    prim_p = rng.randint(-1, ck, N_RAYS).astype(np.int32)
    z = np.zeros(N_RAYS, np.float32)
    want = tp.finish_hits_rows(world["rpacked"], jnp.asarray(attrp),
                               th.j3(o), th.j3(d), jnp.asarray(z),
                               jnp.asarray(z), jnp.asarray(prim_p))
    got = tc.finish_hits_rows(world["bvh"], torch.from_numpy(attrp),
                              th.t3(o), th.t3(d), torch.from_numpy(z),
                              torch.from_numpy(z), torch.from_numpy(prim_p))
    for g, w, name in zip(got, want, ("t", "prim", "b1", "b2", "rows")):
        g, w = g.numpy(), np.asarray(w)
        if name in ("prim", "rows"):
            assert th.same_bits(g, w), name
        else:
            # same f32 operations; the two compilers may contract a
            # multiply-add differently: one ulp of slack
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-7,
                                       err_msg=name)


@pytest.fixture(scope="module")
def brute(world):
    """The brute-force answers for the N_RAYS rays of a seed, computed once
    a seed: the port's own (which shares no code with the walk) and the
    reference's hit mask (to hold the oracle itself)."""
    @functools.cache
    def answers(seed):
        o, d = th.ray_arrays(N_RAYS, seed=seed)
        bf = tv.brute_force_intersect(th.t3(world["v0"]), th.t3(world["e1"]),
                                      th.t3(world["e2"]), _port_rays(o, d))
        rbf = ref_tv.brute_force_intersect(
            jnp.asarray(world["v0"]), jnp.asarray(world["e1"]),
            jnp.asarray(world["e2"]), _ref_rays(o, d))
        return bf, np.asarray(rbf.hit)
    return answers


@pytest.mark.parametrize("any_hit,sort", [(False, False), (False, True),
                                          (True, False), (True, True)])
def test_intersect_rays_matches_reference_and_bruteforce(world, brute,
                                                         any_hit, sort):
    seed = 4 if any_hit else 1
    o, d = th.ray_arrays(N_RAYS, seed=seed)
    rays = _port_rays(o, d)
    t, prim, b1, b2 = tc.intersect_rays(
        world["bvh"], world["permt"], torch.from_numpy(world["lo"]),
        torch.from_numpy(world["hi"]), rays.o, rays.d, rays.tmin, rays.tmax,
        any_hit=any_hit, sort=sort)
    t, prim = t.numpy(), prim.numpy()
    # (b) brute force, the port's held against the reference's
    bf, rbf_hit = brute(seed)
    assert (bf.hit.numpy() == rbf_hit).all()
    rrays = _ref_rays(o, d)
    # (a) the reference's Pallas kernel, interpreted, same packed scene
    rt, rprim, _, _ = tp.intersect_rays(
        world["rpacked"], jnp.asarray(world["rperm"]),
        jnp.asarray(world["lo"]), jnp.asarray(world["hi"]),
        rrays.o, rrays.d, rrays.tmin, rrays.tmax, any_hit=any_hit, sort=sort,
        kernel="v6", interpret=True)
    if any_hit:
        assert ((prim >= 0) == bf.hit.numpy()).all()
        assert ((prim >= 0) == (np.asarray(rprim) >= 0)).all()
        return
    _check_closest(t, prim, bf.t.numpy(), bf.hit.numpy())
    _check_closest(t, prim, np.asarray(rt), np.asarray(rprim) >= 0)
    same = (prim == bf.prim.numpy())
    assert same.mean() >= 0.999
    np.testing.assert_allclose(b1.numpy()[same], bf.b1.numpy()[same],
                               rtol=1e-4, atol=1e-5)


def test_intersect_rays_pair_matches_reference_and_bruteforce(world):
    """The merged extension+shadow launch (mixed mode), with dead lanes in
    both halves."""
    n = N_RAYS
    oe, de = th.ray_arrays(n, seed=6)
    os_, ds = th.ray_arrays(n, seed=7)
    rng = np.random.RandomState(8)
    tmax_e = np.where(rng.rand(n) < 0.5, -1.0, np.inf).astype(np.float32)
    tmax_s = np.where(rng.rand(n) < 0.7, -1.0, np.inf).astype(np.float32)
    ext, sh = _port_rays(oe, de, tmax_e), _port_rays(os_, ds, tmax_s)
    t, prim, b1, b2, occ = tc.intersect_rays_pair(
        world["bvh"], world["permt"], torch.from_numpy(world["lo"]),
        torch.from_numpy(world["hi"]),
        ext.o, ext.d, ext.tmin, ext.tmax, sh.o, sh.d, sh.tmin, sh.tmax)
    t, prim, occ = t.numpy(), prim.numpy(), occ.numpy()
    tri = [th.t3(world[k]) for k in ("v0", "e1", "e2")]
    bf_e = tv.brute_force_intersect(*tri, ext)
    bf_s = tv.brute_force_intersect(*tri, sh)
    _check_closest(t, prim, bf_e.t.numpy(), bf_e.hit.numpy())
    assert not (prim >= 0)[tmax_e < 0].any()
    assert (occ == bf_s.hit.numpy()).all()
    assert not occ[tmax_s < 0].any()
    rext, rsh = _ref_rays(oe, de, tmax_e), _ref_rays(os_, ds, tmax_s)
    rt, rprim, _, _, rocc = tp.intersect_rays_pair(
        world["rpacked"], jnp.asarray(world["rperm"]),
        jnp.asarray(world["lo"]), jnp.asarray(world["hi"]),
        rext.o, rext.d, rext.tmin, rext.tmax,
        rsh.o, rsh.d, rsh.tmin, rsh.tmax, interpret=True)
    _check_closest(t, prim, np.asarray(rt), np.asarray(rprim) >= 0)
    assert (occ == np.asarray(rocc)).all()


def test_cuda_tensor_never_takes_the_plain_version(world, monkeypatch):
    """For a tensor on the card every wrapper launches its kernel or raises;
    none may fall back. Here there is no card: the dispatch is checked by
    making the kernel paths raise and a CPU tensor still succeed."""
    def boom(*a, **k):
        raise RuntimeError("kernel path taken")
    for name in ("_traverse6_cuda", "_traverse5_cuda", "_traverse7_cuda"):
        monkeypatch.setattr(tc, name, boom)
    o, d = th.ray_arrays(8, seed=9)
    rays = _port_rays(o, d)
    moving = tc.with_deltas(
        world["bvh_woop"], torch.zeros_like(world["bvh"].soup16))
    args = (rays.o, rays.d, rays.tmin, rays.tmax)
    tc.traverse6(world["bvh"], *args)
    tc.traverse6(moving, *args, time=rays.time)
    tc.traverse5(moving, *args)
    tc.traverse7(moving, *args)
    assert set(tc.LAUNCHES.values()) == {0} and len(tc.LAUNCHES) == 18

    class OnCard:
        """Stands in for a tensor whose device is a CUDA device."""
        device = torch.device("cuda", 0)
    fake = vm.V3(OnCard(), OnCard(), OnCard())
    for call in (lambda: tc.traverse6(world["bvh"], fake, fake, None, None),
                 lambda: tc.traverse6(moving, fake, fake, None, None,
                                      time=OnCard()),
                 lambda: tc.traverse5(moving, fake, fake, None, None),
                 lambda: tc.traverse7(moving, fake, fake, None, None),
                 lambda: tc.intersect_rays(moving, None, None, None, fake,
                                           fake, None, None, sort=False,
                                           kernel="v5")):
        with pytest.raises(RuntimeError, match="kernel path taken"):
            call()


def test_woop_pack_exact(world):
    """The Woop table against the reference's operand, through the adapter
    that turns its (C, 4, 3K) layout into the port's rows."""
    want = adapt.woop_rows(np.asarray(world["rpacked_woop"].woop),
                           world["packed"].k)
    got = tc.woop_pack(world["packed"].soup16, world["packed"].k)
    assert got.shape == (world["perm"].shape[0], 12)
    assert th.same_bits(got, want)
    pad = world["perm"] < 0
    assert pad.any() and not got[pad].any()
    assert world["packed"].woop is None         # opt-in, as in the reference
    with pytest.raises(ValueError, match="with_woop"):
        tc.traverse7(world["bvh"], None, None, None, None)


@pytest.mark.parametrize("which,any_hit", [("v5", False), ("v5", True),
                                           ("v7", False), ("v7", True)])
def test_kernel_choice_matches_reference_and_bruteforce(world, brute, which,
                                                        any_hit):
    """``intersect_rays(kernel=)``: the packet walks' plain versions against
    brute force (the reference's own tolerances for these kernels) and
    against the reference's kernel of the same name, interpreted, on the
    same packed scene. The two packages walk packets of different widths in
    different orders, so only finished values are compared."""
    seed = 4 if any_hit else 1
    o, d = th.ray_arrays(N_RAYS, seed=seed)
    rays, rrays = _port_rays(o, d), _ref_rays(o, d)
    t, prim, _, _ = tc.intersect_rays(
        world["bvh_woop"], world["permt"], torch.from_numpy(world["lo"]),
        torch.from_numpy(world["hi"]), rays.o, rays.d, rays.tmin, rays.tmax,
        any_hit=any_hit, sort=False, kernel=which)
    t, prim = t.numpy(), prim.numpy()
    bf, _ = brute(seed)
    rt, rprim, _, _ = tp.intersect_rays(
        world["rpacked_woop"], jnp.asarray(world["rperm"]),
        jnp.asarray(world["lo"]), jnp.asarray(world["hi"]),
        rrays.o, rrays.d, rrays.tmin, rrays.tmax, any_hit=any_hit, sort=False,
        kernel=which, interpret=True)
    rt, rhit = np.asarray(rt), np.asarray(rprim) >= 0
    if any_hit:
        assert ((prim >= 0) == bf.hit.numpy()).all()
        assert ((prim >= 0) == rhit).all()
        return
    _check_closest(t, prim, bf.t.numpy(), bf.hit.numpy())
    assert ((prim >= 0) == rhit).mean() > 0.999
    both = (prim >= 0) & rhit & (prim == np.asarray(rprim))
    assert both.sum() > 0.99 * rhit.sum()
    np.testing.assert_allclose(t[both], rt[both], rtol=1e-5)


@pytest.mark.parametrize("which", ["v5", "v7"])
def test_packet_walk_sorted_with_dead_lanes_and_ragged_tail(world, which):
    """Sorted waves, a wave that does not fill its last packet, dead lanes
    and the counters: one entry per packet, nothing walked for a packet
    whose lanes are all dead."""
    n = 5 * tc.PACKET + 7
    o, d = th.ray_arrays(n, seed=51)
    rng = np.random.RandomState(52)
    tmax = np.where(rng.rand(n) < 0.3, -1.0, np.inf).astype(np.float32)
    tmax[2 * tc.PACKET:3 * tc.PACKET] = -1.0            # one dead packet
    rays = _port_rays(o, d, tmax)
    bf = tv.brute_force_intersect(th.t3(world["v0"]), th.t3(world["e1"]),
                                  th.t3(world["e2"]), rays)
    for any_hit in (False, True):
        t, prim, _, _ = tc.intersect_rays(
            world["bvh_woop"], world["permt"], torch.from_numpy(world["lo"]),
            torch.from_numpy(world["hi"]), rays.o, rays.d, rays.tmin,
            rays.tmax, any_hit=any_hit, sort=True, kernel=which)
        assert t.shape == (n,) and torch.equal(prim >= 0, bf.hit)
        assert not (prim >= 0)[torch.from_numpy(tmax) < 0].any()
    fn = {"v5": tc.traverse5, "v7": tc.traverse7}[which]
    stats = {}
    plain = {"v5": tc.traverse5_plain, "v7": tc.traverse7_plain}[which]
    plain(world["bvh_woop"], rays.o, rays.d, rays.tmin, rays.tmax,
          stats=stats)
    t, prim, cnt = fn(world["bvh_woop"], rays.o, rays.d, rays.tmin,
                      rays.tmax, counters=True)
    assert cnt.shape == (6, 2) and cnt.dtype == torch.int32
    assert (cnt[2] == 0).all() and (cnt[[0, 1, 3, 4, 5]] > 0).all()
    # a packet's node steps are slab tests of every live lane of it
    assert cnt[:, 0].sum() <= stats["node_pops"] <= tc.PACKET * cnt[:, 0].sum()
    assert stats["tri_tests"] > 0


@pytest.mark.parametrize("which", ["v1", "v2", "v3", "v4"])
def test_binary_tree_kernels_raise_by_name(world, which):
    """The kernels over the binary tree are served now; what still raises,
    naming the kernel, is moving geometry through one of them."""
    o, d = th.ray_arrays(8, seed=62)
    rays = _port_rays(o, d)
    args = (world["permt"], None, None, rays.o, rays.d, rays.tmin, rays.tmax)
    t, prim, _, _ = tc.intersect_rays(world["bvh"], *args, sort=False,
                                      kernel=which)
    assert t.shape == prim.shape == (8,)
    moving = tc.with_deltas(
        world["bvh"], torch.zeros_like(world["bvh"].soup16))
    with pytest.raises(ValueError, match=f"v6 kernel, not '{which}'"):
        tc.intersect_rays(moving, *args, sort=False, kernel=which,
                          time=rays.time)


def test_default_kernel_table_routes_waves(world, monkeypatch):
    """``DEFAULT_KERNEL`` has the reference's keys and kernel names, an
    unsorted closest-hit wave takes ``closest_coherent``, a sorted one
    ``closest``, an any-hit one ``any``; moving geometry refuses a packet
    kernel."""
    assert tc.DEFAULT_KERNEL == {k: v[0]
                                 for k, v in tp.DEFAULT_KERNEL.items()}
    calls = []
    for name in ("traverse5", "traverse6", "traverse7"):
        real = getattr(tc, name)
        monkeypatch.setattr(
            tc, name, lambda *a, _n=name, _r=real, **k: (calls.append(_n),
                                                         _r(*a, **k))[1])
    monkeypatch.setitem(tc.DEFAULT_KERNEL, "closest_coherent", "v5")
    monkeypatch.setitem(tc.DEFAULT_KERNEL, "any", "v7")
    o, d = th.ray_arrays(64, seed=61)
    rays = _port_rays(o, d)
    run = lambda **kw: tc.intersect_rays(
        world["bvh_woop"], world["permt"], torch.from_numpy(world["lo"]),
        torch.from_numpy(world["hi"]), rays.o, rays.d, rays.tmin, rays.tmax,
        **kw)
    run(sort=False)
    run(sort=True)
    run(any_hit=True)
    run(sort=False, kernel="v6")
    assert calls == ["traverse5", "traverse6", "traverse7", "traverse6"]
    with pytest.raises(ValueError, match="unknown traversal kernel"):
        run(kernel="v8")
    moving = tc.with_deltas(
        world["bvh_woop"], torch.zeros_like(world["bvh"].soup16))
    with pytest.raises(ValueError, match="requires the v6 kernel"):
        tc.intersect_rays(moving, world["permt"], None, None, rays.o, rays.d,
                          rays.tmin, rays.tmax, sort=False, time=rays.time)
    # zero deltas: the motion walk finds exactly the static walk's hits
    t0, p0, _, _ = run(sort=True, kernel="v6")
    t1, p1, _, _ = tc.intersect_rays(
        moving, world["permt"], torch.from_numpy(world["lo"]),
        torch.from_numpy(world["hi"]), rays.o, rays.d, rays.tmin, rays.tmax,
        kernel="v6", time=torch.full_like(rays.tmin, 0.37))
    assert torch.equal(t0, t1) and torch.equal(p0, p1)


MODES = ["closest", "any", "mixed"]


def _wave(n, seed, dead=0.2):
    """Rays with dead lanes and per-lane any-hit flags, as numpy arrays."""
    o, d = th.ray_arrays(n, seed=seed)
    rng = np.random.RandomState(seed + 1)
    tmax = np.where(rng.rand(n) < dead, -1.0, np.inf).astype(np.float32)
    anyf = (rng.rand(n) < 0.5).astype(np.float32)
    return o, d, tmax, anyf


def _mode_kw(mode, anyf, to=torch.from_numpy):
    return {"any_hit": mode == "any",
            "anyf": to(anyf) if mode == "mixed" else None}


@pytest.mark.parametrize("mode", MODES)
def test_ray_result_does_not_depend_on_its_neighbours(world, mode):
    """What the kernel's design rests on: every ray walks alone. The kernel
    hands rays to warps in batches, postpones a lane's leaves until its
    neighbours hold one too and lets the whole warp test one ray's leaf;
    none of that may show in a ray's raw (t, prim)."""
    o, d, tmax, anyf = _wave(N_RAYS, seed=71)

    def walk(sel):
        dead = sel < 0
        s = np.where(dead, 0, sel)
        rays = _port_rays(o[s], d[s], np.where(dead, -1.0, tmax[s]).astype(
            np.float32))
        t, p = tc.traverse6_plain(world["bvh"], rays.o, rays.d, rays.tmin,
                                  rays.tmax, **_mode_kw(mode, anyf[s]))
        return t.numpy(), p.numpy()

    th.hold_rays_independent(walk, N_RAYS, seed=73)


_other_k = {}


def _packed_with_k(world, k):
    """The test soup packed with clusters of `k` triangles (cached)."""
    if k not in _other_k:
        cb = cluster.build(world["v0"], world["e1"], world["e2"], k=k)
        packed, perm = tc.pack(cb.node_lo, cb.node_hi, cb.node_child,
                               cb.node_axis, cb.tri_v0, cb.tri_e1, cb.tri_e2,
                               cb.tri_id)
        assert packed.k == k and packed.soup16.shape[0] == packed.n_clusters * k
        _other_k[k] = packed, perm
    return _other_k[k]


@pytest.mark.parametrize("k", [8, 40])
@pytest.mark.parametrize("mode", MODES)
def test_other_cluster_sizes_match_bruteforce(world, k, mode):
    """Clusters narrower and wider than a warp (the kernel stages a leaf in
    rounds of 32 slots): after the finish step closest lanes equal brute
    force (prim equal, t to rtol 1e-5: both evaluate the same triangle), any-hit
    lanes have its mask, dead lanes miss."""
    packed, perm = _packed_with_k(world, k)
    bvh = to_device(packed, "cpu")
    o, d, tmax, anyf = _wave(N_RAYS, seed=81)
    rays = _port_rays(o, d, tmax)
    t, prim = tc.traverse6(bvh, rays.o, rays.d, rays.tmin, rays.tmax,
                           **_mode_kw(mode, anyf))
    ft, fprim, _, _ = tc.finish_hits(bvh, torch.from_numpy(perm), rays.o,
                                     rays.d, rays.tmin, t, prim)
    bf = tv.brute_force_intersect(th.t3(world["v0"]), th.t3(world["e1"]),
                                  th.t3(world["e2"]), rays)
    assert torch.equal(prim >= 0, bf.hit) and bf.hit.any()
    assert not (prim >= 0)[torch.from_numpy(tmax) < 0].any()
    closest = torch.from_numpy({"closest": np.ones_like(anyf),
                                "any": np.zeros_like(anyf),
                                "mixed": 1.0 - anyf}[mode] > 0)
    sel = closest & bf.hit
    assert torch.equal(fprim[sel], bf.prim[sel])
    np.testing.assert_allclose(ft[sel].numpy(), bf.t[sel].numpy(), rtol=1e-5)


HUGE = 3e19


def _packed_huge(world):
    """The test soup scaled by HUGE (cached): half of its determinants lie
    past 2^126, where nvcc's fast reciprocal does not apply and v5's fold
    divides exactly."""
    if "huge" not in _other_k:
        tri = [world[c] * np.float32(HUGE) for c in ("v0", "e1", "e2")]
        cb = cluster.build(*tri, k=32)
        _other_k["huge"] = tc.pack(cb.node_lo, cb.node_hi, cb.node_child,
                                   cb.node_axis, cb.tri_v0, cb.tri_e1,
                                   cb.tri_e2, cb.tri_id)
    return _other_k["huge"]


PACKET_PLAIN = {"v5": tc.traverse5_plain, "v7": tc.traverse7_plain}


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("k", [8, 40])
@pytest.mark.parametrize("which", ["v5", "v7"])
def test_packet_walks_at_other_cluster_sizes_match_bruteforce(world, which, k,
                                                              any_hit):
    """The plain versions of the packet walks over the wide tree, which the
    card holds v5 / v7 to, at clusters narrower and wider than a warp: after
    the finish step closest lanes equal brute force (prim equal, t to rtol
    1e-5: both evaluate the same triangle), any-hit lanes have its mask,
    dead lanes miss."""
    packed, perm = _packed_with_k(world, k)
    bvh = to_device(tc.with_woop(packed), "cpu")
    o, d, tmax, _ = _wave(N_RAYS, seed=82)
    rays = _port_rays(o, d, tmax)
    t, prim = PACKET_PLAIN[which](bvh, rays.o, rays.d, rays.tmin, rays.tmax,
                                  any_hit=any_hit)
    bf = tv.brute_force_intersect(th.t3(world["v0"]), th.t3(world["e1"]),
                                  th.t3(world["e2"]), rays)
    assert torch.equal(prim >= 0, bf.hit) and bf.hit.any()
    assert not (prim >= 0)[torch.from_numpy(tmax) < 0].any()
    if any_hit:
        return
    ft, fprim, _, _ = tc.finish_hits(bvh, torch.from_numpy(perm), rays.o,
                                     rays.d, rays.tmin, t, prim)
    assert torch.equal(fprim[bf.hit], bf.prim[bf.hit])
    np.testing.assert_allclose(ft[bf.hit].numpy(), bf.t[bf.hit].numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("which", ["v5", "v7"])
def test_packet_walks_take_a_hit_at_exactly_tmax(world, which):
    """The wide walks' tie rule ``nearer`` (``csrc/ray_tests.cuh``): a lane
    without a winner accepts t == t_best, so a triangle whose raw t equals
    the lane's tmax is taken, and one whose t lies one ulp past tmax is not.
    The card holds v5 / v7 raw-equal to these plain walks."""
    plain = PACKET_PLAIN[which]
    o, d = th.ray_arrays(N_RAYS, seed=83)
    rays = _port_rays(o, d)
    args = (world["bvh_woop"], rays.o, rays.d, rays.tmin)
    t, prim = plain(*args, rays.tmax)
    hit = prim >= 0
    assert hit.sum() > 50
    # the nearest raw t itself as tmax: the same triangle, the same t
    at = torch.where(hit, t, rays.tmax)
    t_at, prim_at = plain(*args, at)
    assert torch.equal(prim_at, prim) and torch.equal(t_at, t)
    _, occ = plain(*args, at, any_hit=True)
    assert torch.equal(occ >= 0, hit)
    # one ulp short of it: nothing is left to hit
    short = torch.where(hit, torch.nextafter(t, torch.zeros_like(t)),
                        rays.tmax)
    _, prim_short = plain(*args, short)
    assert not (prim_short >= 0)[hit].any()
    assert torch.equal(prim_short[~hit], prim[~hit])


@pytest.mark.parametrize("which", ["v5", "v6"])
def test_plain_walks_take_an_accepted_slot_at_infinite_t(world, which):
    """Over the soup scaled by ``HUGE`` Moeller-Trumbore's t overflows to
    +inf inside the barycentric bounds, and with tmax = +inf ``nearer``
    accepts it (t == t_best, no winner yet). The plain walks then keep the
    first accepted slot of the least t, as the kernels' sequential folds
    do: the lane's (t, prim) is a hit of that ray. They used to take the
    argmin over t with +inf for the rejected slots, slot 0 of the cluster,
    accepted or not."""
    packed, _ = _packed_huge(world)
    bvh = to_device(packed, "cpu")
    o, d = th.ray_arrays(4096, seed=44)
    rays = _port_rays(o * np.float32(HUGE), d)
    plain = {"v5": tc.traverse5_plain, "v6": tc.traverse6_plain}[which]
    t, prim = plain(bvh, rays.o, rays.d, rays.tmin, rays.tmax)
    hit = prim >= 0
    assert torch.isinf(t[hit]).sum() > 10
    row = bvh.soup16[prim[hit].long()]
    oc, dc = tc._components(rays.o, rays.d)
    ok, t_row = tc._mt([c[hit] for c in oc], [c[hit] for c in dc],
                       rays.tmin[hit], [row[:, c] for c in range(3)],
                       [row[:, 3 + c] for c in range(3)],
                       [row[:, 6 + c] for c in range(3)])
    assert bool(ok.all()) and torch.equal(t_row, t[hit])


# wave shapes the v6 kernel's warp-level steps can get wrong
CARD_SHAPES = ["ragged", "dead_batch", "short", "copies", "k8", "k40"]
# ... and the packet walks': clusters of 128 stage in rounds of 32 slots
PACKET_SHAPES = [*CARD_SHAPES, "k128"]


def _card_case(world, shape, seed):
    """(host packed BVH, perm, o, d, tmax, anyf) of one card-only case, all
    unsorted (an incoherent wave): `ragged` 4,101 rays (the last warp holds
    5), a fifth dead; `dead_batch` the same with one warp of 32 wholly dead
    lanes in the middle; `short` 19 rays (less than a warp); `copies` 32
    copies of one ray that hits (every lane holds the same leaves); `k8` /
    `k40` / `k128` the soup packed in clusters narrower / wider than a
    warp; `huge` the ragged wave over the soup and origins scaled by
    ``HUGE``."""
    k = {"k8": 8, "k40": 40, "k128": 128}.get(shape, 32)
    packed, perm = ((world["packed"], world["perm"]) if k == 32
                    else _packed_with_k(world, k))
    if shape == "huge":
        packed, perm = _packed_huge(world)
    n = {"short": 19, "copies": 32}.get(shape, 4096 + 5)
    o, d, tmax, anyf = _wave(n, seed)
    if shape == "huge":
        o = o * np.float32(HUGE)
    if shape == "dead_batch":
        tmax[64 * 32:65 * 32] = -1.0
    if shape == "copies":
        o[:] = np.asarray([3.0, 0.1, 0.2], np.float32)
        d[:] = -o / np.linalg.norm(o, axis=-1, keepdims=True)
        tmax[:] = np.inf
    return packed, perm, o, d, tmax, anyf


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [*CARD_SHAPES, "huge"])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain_version_on_the_card(world, mode, shape):
    """The CUDA kernel against its plain version on the same device tensors.
    Both round every operation alike and every ray takes the same walk,
    whichever lanes of its warp do the arithmetic, so the raw (t, prim) must
    be identical on every lane, any-hit lanes included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    packed, _, o, d, tmax, anyf = _card_case(world, shape, seed=41)
    bvh = to_device(packed, dev)
    rays = to_device(_port_rays(o, d, tmax), dev)
    kw = _mode_kw(mode, anyf, lambda a: torch.from_numpy(a).to(dev))
    before = dict(tc.LAUNCHES)
    tc.reset_overflow(dev)
    t_k, p_k = tc.traverse6(bvh, rays.o, rays.d, rays.tmin, rays.tmax, **kw)
    t_p, p_p = tc.traverse6_plain(bvh, rays.o, rays.d, rays.tmin, rays.tmax,
                                  **kw)
    assert tc.LAUNCHES[f"traverse6:{mode}"] == \
        before[f"traverse6:{mode}"] + 1
    assert int(tc.overflow_flag(dev).item()) == 0
    assert bool((p_p >= 0).any())
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k, t_p)


@pytest.mark.cuda
@pytest.mark.parametrize("kern,mode,shape", [
    *(("traverse6_motion", mode, shape) for mode in MODES
      for shape in CARD_SHAPES),
    *((kern, mode, shape) for kern in ("traverse5", "traverse7")
      for mode in ("closest", "any") for shape in PACKET_SHAPES),
    ("traverse5", "closest", "huge"), ("traverse5", "any", "huge")])
def test_new_kernels_match_plain_version_on_the_card(world, kern, mode,
                                                     shape):
    """The motion mode of v6 (on every shape of ``CARD_SHAPES``) and the two
    packet kernels (on every shape of ``PACKET_SHAPES``; v5 also on `huge`,
    where its fold's exact divide runs) against their plain versions on the
    same device tensors: identical (t, prim), identical counters, overflow
    flag 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    packed, perm, o, d, tmax, anyf = _card_case(world, shape, seed=44)
    n = o.shape[0]
    rng = np.random.RandomState(43)
    packed = tc.with_woop(packed)
    delta = (0.2 * rng.randn(*packed.soup16.shape)).astype(np.float32)
    delta[:, 9:] = 0.0
    delta[perm < 0] = 0.0
    bvh = to_device(tc.with_deltas(packed, delta), dev)
    rays = to_device(_port_rays(o, d, tmax), dev)
    args = (bvh, rays.o, rays.d, rays.tmin, rays.tmax)
    kw = {"any_hit": mode == "any"}
    if kern == "traverse6_motion":
        kw["time"] = torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev)
        if shape == "copies":
            kw["time"][:] = 0.37
        if mode == "mixed":
            kw["anyf"] = torch.from_numpy(anyf).to(dev)
        fn, plain = tc.traverse6, tc.traverse6_plain
    else:
        kw["counters"] = True
        fn = getattr(tc, kern)
        plain = getattr(tc, kern + "_plain")
    before = tc.LAUNCHES[f"{kern}:{mode}"]
    tc.reset_overflow(dev)
    got, want = fn(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    assert tc.LAUNCHES[f"{kern}:{mode}"] == before + 1
    assert int(tc.overflow_flag(dev).item()) == 0
    assert bool((want[1] >= 0).any())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
