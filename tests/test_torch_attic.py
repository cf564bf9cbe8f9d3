"""PyTorch port, the four kernels over the BINARY cluster tree (v1-v4): their
plain versions against the reference's Pallas kernels of the same name in
interpret mode on the SAME tree (carried across by ``from_reference``'s
packer) and against brute force; on a card, each CUDA kernel against its
plain version.

Tolerances: the two packages walk packets of different widths, so between
them only finished values are compared: ``prim`` equal and t within rtol 1e-5
after the finish step, any-hit masks equal. At the reference's own packet
width the walks are the same walk: v3's counters and every ``prim`` must then
be EQUAL. Kernel against plain version on the card: (t, prim) and counters
identical.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dartray_tpu.accel import cluster as ref_cluster
from dartray_tpu.ops import kernels_attic as ka
from dartray_tpu.ops import traverse_pallas as tp

from dartray_tpu_torch.accel import cluster, traverse as tv
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene.types import to_device

import torchhelp as th

torch.set_num_threads(1)

N_RAYS = 512
# kernel name -> (reference launcher, port wrapper, port plain version,
#                 library, lanes of the reference's packet at block_rows=8)
KERNELS = {
    "v1": ("traverse", tc.traverse, tc.traverse_plain, "traverse1", 1024),
    "v2": ("traverse2", tc.traverse2, tc.traverse2_plain, "traverse2", 128),
    "v3": ("traverse3", tc.traverse3, tc.traverse3_plain, "traverse3", 1024),
    "v4": ("traverse4", tc.traverse4, tc.traverse4_plain, "traverse4", 128),
}


@pytest.fixture(scope="module")
def world():
    """One soup, clustered and packed by the reference; the port walks the
    SAME tables, carried across as numpy."""
    v0, e1, e2 = th.soup()
    rcb = ref_cluster.build(v0, e1, e2, k=32)
    rpacked, rperm = tp.pack(rcb.node_lo, rcb.node_hi, rcb.node_child,
                             rcb.node_axis, rcb.tri_v0, rcb.tri_e1,
                             rcb.tri_e2, rcb.tri_id)
    packed = adapt._packed(th.np_tree(rpacked))
    lo, hi = v0.min(0) - 1.0, v0.max(0) + 1.0
    return dict(v0=v0, e1=e1, e2=e2, rcb=rcb, rpacked=rpacked, rperm=rperm,
                packed=packed, bvh=to_device(packed, "cpu"),
                permt=torch.from_numpy(np.asarray(rperm)), lo=lo, hi=hi)


@pytest.fixture
def ref_v3_runs(monkeypatch):
    """The reference's ``_kernel3`` reads a module-level name ``bf16`` that
    nothing defines; it is supplied from outside the package."""
    monkeypatch.setattr(ka, "bf16", False, raising=False)


def _port_rays(o, d, tmax=None):
    return vm.make_rays(th.t3(o), th.t3(d),
                        tmax=None if tmax is None else torch.from_numpy(tmax))


def _planes(n, tmax=None):
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.inf, np.float32) if tmax is None else tmax
    return tmin, tmax


def _ref_call(which, world, o, d, tmin, tmax, **kw):
    return getattr(ka, KERNELS[which][0])(
        world["rpacked"], th.j3(o), th.j3(d), jnp.asarray(tmin),
        jnp.asarray(tmax), interpret=True, **kw)


def _finish(world, o, d, t, prim):
    t, prim, _, _ = tc.finish_hits(
        world["bvh"], world["permt"], th.t3(o), th.t3(d),
        torch.zeros(len(o)), torch.tensor(np.asarray(t)),
        torch.tensor(np.asarray(prim)))
    return t.numpy(), prim.numpy()


def test_pack_binary_tables_exact(world):
    """``pack`` on the port's own cluster build gives the reference's
    ``bounds`` / ``meta`` / ``meta2`` bit for bit, with ``meta2[:, 0] =
    child0 * 4 + axis`` and a leaf as ``-(cluster + 1)``; ``from_reference``
    carries them."""
    cb = cluster.build(world["v0"], world["e1"], world["e2"], k=32)
    packed, perm = tc.pack(cb.node_lo, cb.node_hi, cb.node_child,
                           cb.node_axis, cb.tri_v0, cb.tri_e1, cb.tri_e2,
                           cb.tri_id)
    rp = world["rpacked"]
    for name, shape, dtype in (("bounds", 8, np.float32),
                               ("meta", 4, np.int32), ("meta2", 2, np.int32)):
        got, want = getattr(packed, name), np.asarray(getattr(rp, name))
        assert got.shape == (packed.n_nodes, shape) and got.dtype == dtype
        assert th.same_bits(got, want), name
        assert th.same_bits(getattr(world["packed"], name), want), name
    leaf = packed.meta[:, 0] < 0
    assert leaf.any() and (~leaf).any()
    assert (packed.meta2[~leaf, 0]
            == packed.meta[~leaf, 0] * 4 + packed.meta[~leaf, 2]).all()
    assert (packed.meta2[leaf, 0] == packed.meta[leaf, 0]).all()
    assert sorted(-packed.meta[leaf, 0] - 1) == list(range(packed.n_clusters))
    assert th.same_bits(perm, np.asarray(world["rperm"]))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("which", list(KERNELS))
def test_attic_kernel_matches_reference_and_bruteforce(world, ref_v3_runs,
                                                       which, any_hit):
    """Same tree, same rays, unsorted: the port's plain version at its own
    packet width against the reference's kernel of the same name and against
    brute force."""
    o, d = th.ray_arrays(N_RAYS, seed=4 if any_hit else 1)
    tmin, tmax = _planes(N_RAYS)
    rt, rprim = _ref_call(which, world, o, d, tmin, tmax, any_hit=any_hit)
    rays = _port_rays(o, d)
    t, prim = KERNELS[which][1](world["bvh"], rays.o, rays.d, rays.tmin,
                                rays.tmax, any_hit=any_hit)
    bf = tv.brute_force_intersect(th.t3(world["v0"]), th.t3(world["e1"]),
                                  th.t3(world["e2"]), rays)
    hit, rhit = prim.numpy() >= 0, np.asarray(rprim) >= 0
    assert (hit == rhit).all() and (hit == bf.hit.numpy()).all()
    if any_hit:
        return
    ft, fprim = _finish(world, o, d, t, prim)
    rft, rfprim = _finish(world, o, d, rt, rprim)
    assert (fprim == rfprim).all()
    np.testing.assert_allclose(ft[hit], rft[hit], rtol=1e-5)
    assert (fprim == bf.prim.numpy()).mean() >= 0.999


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("which", list(KERNELS))
def test_attic_walk_is_the_reference_walk_at_its_packet(world, ref_v3_runs,
                                                        which, any_hit):
    """At the reference's packet width the plain version pops the same nodes
    in the same order: raw ``prim`` is EQUAL on every lane, the any-hit
    blockers included."""
    o, d = th.ray_arrays(N_RAYS, seed=5)
    tmin, tmax = _planes(N_RAYS)
    _, rprim = _ref_call(which, world, o, d, tmin, tmax, any_hit=any_hit)
    rays = _port_rays(o, d)
    _, prim = KERNELS[which][2](world["bvh"], rays.o, rays.d, rays.tmin,
                                rays.tmax, any_hit=any_hit,
                                packet=KERNELS[which][4])
    assert (prim.numpy() == np.asarray(rprim)).all()


@pytest.mark.parametrize("any_hit", [False, True])
def test_v3_counters_equal_the_reference(world, ref_v3_runs, any_hit):
    """Node steps (every pop, missed boxes included) and leaf rounds of each
    packet, port against reference at 1,024 lanes a packet; 1,500 rays make
    two packets, the second ragged."""
    n = 1500
    o, d = th.ray_arrays(n, seed=6)
    rng = np.random.RandomState(7)
    tmin, tmax = _planes(n, np.where(rng.rand(n) < 0.2, -1.0,
                                     np.inf).astype(np.float32))
    _, rprim, rcnt = _ref_call("v3", world, o, d, tmin, tmax,
                               any_hit=any_hit, counters=True)
    rays = _port_rays(o, d, tmax)
    _, prim, cnt = tc.traverse3_plain(world["bvh"], rays.o, rays.d, rays.tmin,
                                      rays.tmax, any_hit=any_hit,
                                      counters=True, packet=1024)
    want = np.asarray(rcnt)[:, :2, 0]
    assert cnt.shape == (2, 2) and cnt.dtype == torch.int32
    assert (want > 0).all() and (cnt.numpy() == want).all(), (cnt, want)
    assert (prim.numpy() == np.asarray(rprim)).all()
    # the wrapper's own packet: one row per 128 lanes
    _, _, cnt128 = tc.traverse3(world["bvh"], rays.o, rays.d, rays.tmin,
                                rays.tmax, any_hit=any_hit, counters=True)
    assert cnt128.shape == (-(-n // 128), 2)


def test_reference_v3_needs_bf16_from_outside(world):
    """Known behaviour of the reference: without the name supplied,
    ``traverse3`` cannot run. A repair upstream shows here."""
    o, d = th.ray_arrays(128, seed=8)
    with pytest.raises(NameError, match="bf16"):
        _ref_call("v3", world, o, d, *_planes(128))


def _near_tie_leaf():
    """One cluster whose slots 0 and 1 are parallel triangles 40 ulps apart
    in t for a ray down the z axis, the NEARER one in slot 1; both patterns
    lie well inside one bucket of 128 (low bits 100 and 60)."""
    bits = np.float32(5.0).view(np.int32)
    z0 = (bits + 100).view(np.float32)
    z1 = (bits + 60).view(np.float32)
    v0 = np.array([[-1, -1, z0], [-1, -1, z1], [9, 9, 9]], np.float32)
    e1 = np.array([[4, 0, 0], [4, 0, 0], [1, 0, 0]], np.float32)
    e2 = np.array([[0, 4, 0], [0, 4, 0], [0, 1, 0]], np.float32)
    cb = ref_cluster.build(v0, e1, e2, k=32)
    # keep the build's order only if it kept ours: the case needs slot 0 far
    assert list(np.asarray(cb.tri_id)[0, :3]) == [0, 1, 2]
    return tp.pack(cb.node_lo, cb.node_hi, cb.node_child, cb.node_axis,
                   cb.tri_v0, cb.tri_e1, cb.tri_e2, cb.tri_id)[0]


@pytest.mark.parametrize("which", list(KERNELS))
def test_the_two_folds_on_a_near_tie(ref_v3_runs, which):
    """Two triangles of one leaf give t within 127 ulps. The strict fold (v1,
    v2) picks by exact t: slot 1, the nearer. The packed fold (v3, v4) rounds
    both to the same pattern and picks the LOWER slot: slot 0. Each equals
    its reference kernel."""
    rpacked = _near_tie_leaf()
    bvh = to_device(adapt._packed(th.np_tree(rpacked)), "cpu")
    o = np.zeros((4, 3), np.float32)
    d = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    tmin, tmax = _planes(4)
    rt, rprim = getattr(ka, KERNELS[which][0])(
        rpacked, th.j3(o), th.j3(d), jnp.asarray(tmin), jnp.asarray(tmax),
        interpret=True)
    rays = _port_rays(o, d)
    t, prim = KERNELS[which][1](bvh, rays.o, rays.d, rays.tmin, rays.tmax)
    want = 0 if tc.ATTIC[KERNELS[which][3]]["packed"] else 1
    assert (prim.numpy() == want).all()
    assert (np.asarray(rprim) == want).all()
    assert th.same_bits(t.numpy(), np.asarray(rt))
    if want == 0:       # the packed t is rounded DOWN: low 7 bits clear
        assert (t.numpy().view(np.int32) & 127 == 0).all()
        assert (t.numpy() == 5.0).all()


def _route(world, kern, any_hit):
    """``intersect_rays(kernel=kern, sort=True)`` on a wave with dead lanes
    and a ragged last packet; returns (its tmax, the result)."""
    n = 4 * 128 + 7
    o, d = th.ray_arrays(n, seed=51)
    rng = np.random.RandomState(52)
    tmax = np.where(rng.rand(n) < 0.3, -1.0, np.inf).astype(np.float32)
    rays = _port_rays(o, d, tmax)
    return tmax, tc.intersect_rays(
        world["bvh"], world["permt"], torch.from_numpy(world["lo"]),
        torch.from_numpy(world["hi"]), rays.o, rays.d, rays.tmin, rays.tmax,
        any_hit=any_hit, sort=True, kernel=kern)


@pytest.fixture(scope="module")
def route_v6(world):
    """{any_hit: v6's result on ``_route``'s wave}, walked once for every
    kernel held against it."""
    return {any_hit: _route(world, "v6", any_hit)[1]
            for any_hit in (False, True)}


@pytest.mark.parametrize("which", list(KERNELS))
def test_sorted_route_equals_v6(world, route_v6, which):
    """``intersect_rays(kernel=v, sort=True)`` against ``kernel="v6"`` after
    the finish step, dead lanes and a ragged last packet included."""
    tmax, (t, prim, b1, b2) = _route(world, which, False)
    t6, prim6, b16, b26 = route_v6[False]
    assert torch.equal(prim, prim6)
    assert not (prim >= 0)[torch.from_numpy(tmax) < 0].any()
    hit = prim >= 0
    np.testing.assert_allclose(t[hit].numpy(), t6[hit].numpy(), rtol=1e-5)
    np.testing.assert_allclose(b1.numpy(), b16.numpy(), rtol=1e-4, atol=1e-5)
    _, (_, occ, _, _) = _route(world, which, True)
    _, occ6, _, _ = route_v6[True]
    assert torch.equal(occ >= 0, occ6 >= 0)


def test_kernel_names(world):
    """Every name of the reference's table is served; an unknown one raises
    ``ValueError``; ``time=`` with a binary-tree kernel raises, because
    moving geometry needs v6."""
    o, d = th.ray_arrays(16, seed=61)
    rays = _port_rays(o, d)
    args = (rays.o, rays.d, rays.tmin, rays.tmax)
    with pytest.raises(ValueError, match="unknown traversal kernel"):
        tc.intersect_rays(world["bvh"], world["permt"], None, None, *args,
                          sort=False, kernel="v0")
    moving = tc.with_deltas(
        world["bvh"], torch.zeros_like(world["bvh"].soup16))
    for which in KERNELS:
        t, prim, _, _ = tc.intersect_rays(world["bvh"], world["permt"], None,
                                          None, *args, sort=False,
                                          kernel=which)
        assert t.shape == (16,)
        with pytest.raises(ValueError, match="requires the v6 kernel"):
            tc.intersect_rays(moving, world["permt"], None, None, *args,
                              sort=False, kernel=which, time=rays.time)


def test_cuda_tensor_never_takes_the_plain_version(world, monkeypatch):
    """For a tensor on the card every wrapper launches its kernel or raises.
    Here there is no card: the kernel path is made to raise, a CPU tensor
    still succeeds, and a stand-in for a CUDA tensor reaches the raise."""
    def boom(*a, **k):
        raise RuntimeError("kernel path taken")
    monkeypatch.setattr(tc, "_binary_cuda", boom)
    o, d = th.ray_arrays(8, seed=9)
    rays = _port_rays(o, d)
    before = dict(tc.LAUNCHES)

    class OnCard:
        device = torch.device("cuda", 0)
    fake = vm.V3(OnCard(), OnCard(), OnCard())
    for which, (_, fn, _, lib, _) in KERNELS.items():
        fn(world["bvh"], rays.o, rays.d, rays.tmin, rays.tmax)
        with pytest.raises(RuntimeError, match="kernel path taken"):
            fn(world["bvh"], fake, fake, None, None)
        assert {f"{lib}:closest", f"{lib}:any"} <= set(tc.LAUNCHES)
    assert tc.LAUNCHES == before        # the plain version counts nothing


_other_k = {}


def _packed_with_k(world, k):
    """The test soup clustered by the port in clusters of `k` triangles and
    packed (cached): (host packed BVH, perm)."""
    if k not in _other_k:
        cb = cluster.build(world["v0"], world["e1"], world["e2"], k=k)
        packed, perm = tc.pack(cb.node_lo, cb.node_hi, cb.node_child,
                               cb.node_axis, cb.tri_v0, cb.tri_e1, cb.tri_e2,
                               cb.tri_id)
        assert packed.k == k
        _other_k[k] = packed, perm
    return _other_k[k]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("k", [8, 40])
@pytest.mark.parametrize("which", ["v1", "v3", "v2", "v4"])
def test_block_walks_at_other_cluster_sizes_match_bruteforce(world, which, k,
                                                             any_hit):
    """The plain versions of the packet walks, block (v1, v3) and warp (v2,
    v4), which the card holds their kernels to, at clusters narrower and
    wider than a warp: after
    the finish step closest lanes equal brute force (prim equal, t to rtol
    1e-5: both evaluate the same triangle), any-hit lanes have its mask, dead
    lanes miss."""
    packed, perm = _packed_with_k(world, k)
    bvh = to_device(packed, "cpu")
    n = 384 + 7
    o, d = th.ray_arrays(n, seed=91)
    rng = np.random.RandomState(92)
    tmax = np.where(rng.rand(n) < 0.2, -1.0, np.inf).astype(np.float32)
    rays = _port_rays(o, d, tmax)
    t, prim = KERNELS[which][2](bvh, rays.o, rays.d, rays.tmin, rays.tmax,
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


# wave shapes a packet (128 lanes or a warp) can get wrong, beside the
# ragged wave
SHAPES = ["short", "one_live", "copies", "k8", "k40", "k128", "early"]


def _card_case(world, shape):
    """(host packed BVH, o, d, tmax) of one card-only case. `ragged`: 4,101
    rays (a ragged last packet), a fifth of them dead, the packet of lanes
    1024-1151 wholly dead; `short` 19 rays (one partial packet); `one_live`
    128 rays with a single live lane; `copies` 128 copies of one ray that
    hits; `k8` / `k40` / `k128` the ragged wave over clusters of 8 / 40 /
    128 triangles (v3 stages 16 buffered clusters a block in shared memory,
    v2 / v4 8 a warp: at k = 128 either is past the default 48 KB a block);
    `early` origins inside the
    soup, so that an any-hit wave's lanes all find blockers within a few
    leaves."""
    k = {"k8": 8, "k40": 40, "k128": 128}.get(shape, 32)
    packed = world["packed"] if k == 32 else _packed_with_k(world, k)[0]
    n = {"short": 19, "one_live": 128, "copies": 128}.get(shape, 4096 + 5)
    rng = np.random.RandomState(43)
    o, d = th.ray_arrays(n, seed=44)
    tmax = np.where(rng.rand(n) < 0.2, -1.0, np.inf).astype(np.float32)
    if n > 1152:
        tmax[1024:1152] = -1.0
    if shape in ("one_live", "copies"):
        o[:] = np.asarray([3.0, 0.1, 0.2], np.float32)
        d[:] = -o / np.linalg.norm(o, axis=-1, keepdims=True)
        tmax[:] = np.inf if shape == "copies" else -1.0
        tmax[77] = np.inf
    if shape == "early":
        o = (rng.randn(n, 3) * 0.3).astype(np.float32)
    return packed, o, d, tmax


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("which,shape", [
    (which, shape) for which in KERNELS for shape in ["ragged", *SHAPES]])
def test_attic_kernel_matches_plain_version_on_the_card(world, which, shape,
                                                        any_hit):
    """The CUDA kernel against its plain version on the same device tensors,
    on the shapes of ``_card_case``: identical (t, prim), identical counters,
    overflow flag 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    packed, o, d, tmax = _card_case(world, shape)
    bvh = to_device(packed, dev)
    rays = to_device(_port_rays(o, d, tmax), dev)
    args = (bvh, rays.o, rays.d, rays.tmin, rays.tmax)
    _, fn, plain, lib, _ = KERNELS[which]
    key = f"{lib}:{'any' if any_hit else 'closest'}"
    before = tc.LAUNCHES[key]
    tc.reset_overflow(dev)
    if which == "v3":
        got = fn(*args, any_hit=any_hit, counters=True)
    else:
        got = fn(*args, any_hit=any_hit)
    want = plain(*args, any_hit=any_hit, counters=which == "v3")
    torch.cuda.synchronize()
    assert tc.LAUNCHES[key] == before + 1
    assert int(tc.overflow_flag(dev).item()) == 0
    assert bool((want[1] >= 0).any())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # and the function itself: masks equal to the per-ray walk's
    _, p6 = tc.traverse6(*args, any_hit=any_hit)
    assert torch.equal(got[1] >= 0, p6 >= 0)
