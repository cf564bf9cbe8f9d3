"""PyTorch port, traversal: the plain version of the CUDA kernel and the glue
around it against (a) the reference's v6 Pallas kernel in interpret mode on
the SAME packed BVH and (b) brute force.

Tolerances: hit masks agree on >= 0.999 of rays and the 0.999-quantile
relative error of the finished t is < 1e-3 (a ray through a shared edge or an
exact tie may pick another triangle; the kernels' raw t is approximate, so
only finished values are compared); any-hit masks must be equal; packing,
sort keys and the finish step are exact (same f32 operations).
"""
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
                           cb.tri_v0, cb.tri_e1, cb.tri_e2, cb.tri_id)
    rcb = ref_cluster.build(v0, e1, e2, k=32)
    rpacked, rperm = tp.pack(rcb.node_lo, rcb.node_hi, rcb.node_child,
                             rcb.node_axis, rcb.tri_v0, rcb.tri_e1,
                             rcb.tri_e2, rcb.tri_id)
    lo, hi = v0.min(0) - 1.0, v0.max(0) + 1.0
    return dict(v0=v0, e1=e1, e2=e2, packed=packed, perm=perm,
                bvh=to_device(packed, "cpu"), permt=torch.from_numpy(perm),
                rpacked=rpacked, rperm=rperm, lo=lo, hi=hi)


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
        tc.pack(None, None, None, z, z, z, bad)


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


@pytest.mark.parametrize("any_hit,sort", [(False, False), (False, True),
                                          (True, False), (True, True)])
def test_intersect_rays_matches_reference_and_bruteforce(world, any_hit,
                                                         sort):
    o, d = th.ray_arrays(N_RAYS, seed=4 if any_hit else 1)
    rays = _port_rays(o, d)
    t, prim, b1, b2 = tc.intersect_rays(
        world["bvh"], world["permt"], torch.from_numpy(world["lo"]),
        torch.from_numpy(world["hi"]), rays.o, rays.d, rays.tmin, rays.tmax,
        any_hit=any_hit, sort=sort)
    t, prim = t.numpy(), prim.numpy()
    # (b) the port's own brute force, which shares no code with the walk
    bf = tv.brute_force_intersect(th.t3(world["v0"]), th.t3(world["e1"]),
                                  th.t3(world["e2"]), rays)
    # and the reference's brute force, to hold the oracle itself
    rrays = _ref_rays(o, d)
    rbf = ref_tv.brute_force_intersect(
        jnp.asarray(world["v0"]), jnp.asarray(world["e1"]),
        jnp.asarray(world["e2"]), rrays)
    assert (bf.hit.numpy() == np.asarray(rbf.hit)).all()
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
    """For a tensor on the card the wrapper launches the kernel or raises; it
    must not fall back. Here there is no card: the dispatch is checked by
    making the kernel path raise and a CPU tensor still succeed."""
    def boom(*a, **k):
        raise RuntimeError("kernel path taken")
    monkeypatch.setattr(tc, "_traverse6_cuda", boom)
    o, d = th.ray_arrays(8, seed=9)
    rays = _port_rays(o, d)
    tc.traverse6(world["bvh"], rays.o, rays.d, rays.tmin, rays.tmax)
    assert tc.LAUNCHES == {"closest": 0, "any": 0, "mixed": 0}

    class OnCard:
        """Stands in for a tensor whose device is a CUDA device."""
        device = torch.device("cuda", 0)
    fake = vm.V3(OnCard(), OnCard(), OnCard())
    with pytest.raises(RuntimeError, match="kernel path taken"):
        tc.traverse6(world["bvh"], fake, fake, None, None)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["closest", "any", "mixed"])
def test_kernel_matches_plain_version_on_the_card(world, mode):
    """The CUDA kernel against its plain version on the same device tensors.
    Both round every operation alike and take the same walk, so (t, prim)
    must be identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    bvh = to_device(world["packed"], dev)
    o, d = th.ray_arrays(4096, seed=41)
    rng = np.random.RandomState(42)
    tmax = np.where(rng.rand(4096) < 0.2, -1.0, np.inf).astype(np.float32)
    rays = _port_rays(o, d, tmax)
    rays = to_device(rays, dev)
    anyf = None
    if mode == "mixed":
        anyf = torch.from_numpy((rng.rand(4096) < 0.5).astype(np.float32)
                                ).to(dev)
    before = dict(tc.LAUNCHES)
    tc.reset_overflow(dev)
    t_k, p_k = tc.traverse6(bvh, rays.o, rays.d, rays.tmin, rays.tmax,
                            any_hit=(mode == "any"), anyf=anyf)
    t_p, p_p = tc.traverse6_plain(bvh, rays.o, rays.d, rays.tmin, rays.tmax,
                                  any_hit=(mode == "any"), anyf=anyf)
    assert tc.LAUNCHES[mode] == before[mode] + 1
    assert int(tc.overflow_flag(dev).item()) == 0
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k, t_p)
