"""PyTorch port, the reference's own traversal walks: the per-triangle SAH
BVH (``accel/bvh.py::build``) with its stackless threaded walk
(``accel/traverse.py::intersect`` / ``intersect_p``) and the cluster packet
walk (``accel/cluster.py::intersect`` / ``intersect_p``, static and moving),
against the JAX reference on the same seeded inputs.

The build is held bit for bit (rows, links, prim_index, world_bound, depth)
for every split method. The walks run on a tessellated sphere (2,304
triangles) and 512 rays: prim equal on every lane and t within rtol 1e-5 /
atol 1e-6 of the reference walk's, t / b1 / b2 of every hit bit for bit
the reference's own Moeller-Trumbore test of that ray and triangle, the
any-hit mask equal. Each reference walk is jitted once for the file's one
ray count (an un-jitted call compiles its while loop again at every call,
and a walk with jit disabled takes 5-12 s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu.accel import bvh as ref_bvh
from dartray_tpu.accel import cluster as ref_cluster
from dartray_tpu.accel import traverse as ref_traverse
from dartray_tpu.core import math as ref_vm
from dartray_tpu.scene import mesh as ref_mesh

from dartray_tpu_torch.accel import bvh, cluster, traverse
from dartray_tpu_torch.core import math as vm

import torchhelp as th

torch.set_num_threads(1)

N_RAYS = 512
ODD = 300                 # a ray count that is not a multiple of PACKET
SPLITS = ("sah", "middle", "equal")


def _sphere():
    m = ref_mesh.sphere(radius=1.0, nu=48, nv=24)
    return ref_bvh.triangles_to_mt(m.verts, m.faces)


def _rays(seed=11):
    """Half the origins inside the sphere, half outside; some rays cut
    short by tmax, some dead (tmax < tmin), and times in [0, 1]."""
    rng = np.random.RandomState(seed)
    o = rng.randn(N_RAYS, 3).astype(np.float32)
    o *= np.where(np.arange(N_RAYS) % 2 == 0, 0.5, 2.5)[:, None].astype(
        np.float32)
    d = rng.randn(N_RAYS, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::37, 1] = 0.0                       # exact zero components
    tmin = np.zeros(N_RAYS, np.float32)
    tmax = np.full(N_RAYS, np.inf, np.float32)
    tmax[::5] = 2.0
    tmin[::29], tmax[::29] = 1.0, 0.5     # dead lanes
    time = rng.rand(N_RAYS).astype(np.float32)
    return o, d, tmin, tmax, time


def _port_rays(o, d, tmin, tmax, time, n=N_RAYS, device="cpu"):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[:n])).to(device)
    return vm.make_rays(t(o), t(d), t(tmin), t(tmax), t(time))


def _ref_rays(o, d, tmin, tmax, time):
    return ref_vm.make_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
                            jnp.asarray(tmax), jnp.asarray(time))


def _ref_cluster(cb):
    """The port's cluster tree as the reference's pytree (one tree for
    both walks)."""
    return ref_cluster.ClusterBVH(**{
        f.name: (jnp.asarray(getattr(cb, f.name))
                 if isinstance(getattr(cb, f.name), np.ndarray)
                 else getattr(cb, f.name))
        for f in dataclasses.fields(ref_cluster.ClusterBVH)})


def _moving(v0, e1, e2):
    """The sphere translated and squashed over the shutter."""
    return v0 + np.float32([0.3, -0.2, 0.1]), e1 * np.float32(0.9), e2


@pytest.fixture(scope="module")
def port_world():
    """The port's side alone: soups, rays and the three trees."""
    v0, e1, e2 = _sphere()
    small_soup = th.soup(24, 5)
    return {"soup": (v0, e1, e2), "rays": _rays(),
            "bvh": bvh.build(v0, e1, e2),
            "small": bvh.build(*small_soup),  # shallow: 7 steps reach leaves
            "small_soup": small_soup, "cl": cluster.build(v0, e1, e2),
            "cl_moving": cluster.build_motion(v0, e1, e2,
                                              *_moving(v0, e1, e2))}


@pytest.fixture(scope="module")
def world(port_world):
    """port_world and the reference walks' results on the same rays."""
    w = port_world
    rr = _ref_rays(*w["rays"])
    b, small = w["bvh"], w["small"]
    rows, links = jnp.asarray(b.rows), jnp.asarray(b.links)
    ref = {
        "stackless": jax.jit(ref_traverse.intersect)(rows, links, rr),
        "stackless_p": jax.jit(ref_traverse.intersect_p)(rows, links, rr),
        "stackless_cut": jax.jit(ref_traverse.intersect,
                                 static_argnames="max_steps")(
            jnp.asarray(small.rows), jnp.asarray(small.links), rr,
            max_steps=7),
        "packet": jax.jit(ref_cluster.intersect)(_ref_cluster(w["cl"]), rr),
        "packet_p": jax.jit(ref_cluster.intersect_p)(_ref_cluster(w["cl"]),
                                                     rr),
        "moving": jax.jit(ref_cluster.intersect)(
            _ref_cluster(w["cl_moving"]), rr),
    }
    return {**w, "ref": ref}


def _walk(world, name, n=N_RAYS, device="cpu"):
    rays = _port_rays(*world["rays"], n=n, device=device)
    if name.startswith("stackless"):
        # stackless_cut / _uncut: the shallow tree, cut at 7 steps or not
        b = world["small" if name.endswith("cut") else "bvh"]
        rows = torch.as_tensor(b.rows, device=device)
        links = torch.as_tensor(b.links, device=device)
        if name.endswith("_p"):
            return traverse.intersect_p(rows, links, rays)
        cut = 7 if name == "stackless_cut" else 20000
        return traverse.intersect(rows, links, rays, max_steps=cut)
    tree = world["cl_moving" if name == "moving" else "cl"]
    walk = cluster.intersect_p if name.endswith("_p") else cluster.intersect
    return walk(cluster.to_device(tree, device), rays)


def _ref_mt(world, name, prim, n):
    """The reference's own Moeller-Trumbore test (``_mt_test``, un-jitted,
    so no product is contracted) of each of the first `n` rays against
    triangle `prim` (lerped to the ray's time for the moving tree):
    (t, b1, b2)."""
    soup = world["small_soup"] if name.endswith("cut") else world["soup"]
    j = np.maximum(prim, 0)
    tri = [jnp.asarray(a[j]) for a in soup]
    o, d, tmin, tmax, time = (jnp.asarray(a[:n]) for a in world["rays"])
    with jax.disable_jit():
        if name == "moving":
            moved = _moving(*soup)
            tri = [a + time[:, None] * jnp.asarray(b[j] - c[j])
                   for a, b, c in zip(tri, moved, soup)]
        _, t, u, v = ref_traverse._mt_test(o, d, *tri, tmin, tmax)
    return np.asarray(t), np.asarray(u), np.asarray(v)


def _same_hits(world, name, h, n=N_RAYS):
    """prim equal to the reference walk's on every lane and t within
    rtol 1e-5 / atol 1e-6 of it; on every hit, t / b1 / b2 bit for bit
    the reference's test of that ray and triangle (the compiled walk
    contracts its products into fused multiply-adds, which moves b1 / b2
    of a far ray by some 1e-5 of their value; its t stays in tolerance);
    a miss (inf, -1, 0, 0) as the reference's."""
    ref = world["ref"][name]
    prim = np.asarray(ref.prim)[:n]
    assert np.array_equal(h.prim.numpy(), prim)
    np.testing.assert_allclose(h.t.numpy(), np.asarray(ref.t)[:n],
                               rtol=1e-5, atol=1e-6)
    hit = prim >= 0
    for f, want in zip(("t", "b1", "b2"), _ref_mt(world, name, prim, n)):
        got = getattr(h, f).numpy()
        assert th.same_bits(got[hit], want[hit]), f
        assert th.same_bits(got[~hit], np.asarray(getattr(ref, f))[:n][~hit])


@pytest.mark.parametrize("split", SPLITS)
def test_build_is_the_references(split):
    """Bit for bit on the sphere and on a one-triangle mesh (a lone leaf
    root, every link -1)."""
    v0, e1, e2 = _sphere()
    for soup in ((v0, e1, e2), (v0[:1], e1[:1], e2[:1])):
        b = bvh.build(*soup, split_method=split)
        rb = ref_bvh.build(*soup, split_method=split)
        for f in ("rows", "links", "prim_index", "world_bound"):
            assert th.same_bits(getattr(b, f), getattr(rb, f)), f
        assert (b.n_nodes, b.max_depth) == (rb.n_nodes, rb.max_depth)
    assert b.n_nodes == 1 and (b.links == -1).all()
    assert b.rows[0, 14:16].view(np.int32)[0] == 0 and b.rows[0, 15] == 1.0


@pytest.mark.parametrize("name", ["stackless", "stackless_cut", "packet",
                                  "moving"])
def test_closest_hits_are_the_references(world, name):
    """Closest hits on every lane; `stackless_cut` stops at max_steps=7 on
    a shallow tree (24 triangles) and returns the reference's partial
    result, fewer hits than the walk to its end; `moving` lerps each
    buffered triangle to its ray's time."""
    h = _walk(world, name)
    _same_hits(world, name, h)
    hits = (h.prim >= 0).float().mean()
    if name == "stackless_cut":
        full = (_walk(world, "stackless_uncut").prim >= 0).float().mean()
        assert 0 < hits < full
    else:
        assert 0.3 < hits < 0.9


@pytest.mark.parametrize("name", ["stackless_p", "packet_p"])
def test_occlusion_is_the_references(world, name):
    occ = _walk(world, name)
    assert occ.dtype == torch.bool
    assert np.array_equal(occ.numpy(), np.asarray(world["ref"][name]))


@pytest.mark.parametrize("name", ["stackless", "packet", "packet_p"])
def test_a_ray_count_off_the_packet_width(world, name):
    """ODD rays: the packet walk pads its last packet with dead lanes; the
    hits are the reference's on the same rays."""
    h = _walk(world, name, n=ODD)
    ref = world["ref"][name]
    if name.endswith("_p"):
        assert np.array_equal(h.numpy(), np.asarray(ref)[:ODD])
    else:
        _same_hits(world, name, h, n=ODD)


@pytest.mark.parametrize("name", ["stackless", "packet", "moving"])
def test_walks_agree_with_brute_force(world, name):
    """Against the port's exhaustive intersector (with the motion deltas
    for the moving tree): the same hit mask, the same prim but where two
    triangles are hit at the same t (a ray through a shared edge), t within
    1e-5 relative."""
    v0, e1, e2 = world["soup"]
    deltas = None
    if name == "moving":
        mv = _moving(v0, e1, e2)
        deltas = [torch.from_numpy(b - a) for a, b in zip((v0, e1, e2), mv)]
    rays = _port_rays(*world["rays"])
    bf = traverse.brute_force_intersect(
        *(torch.from_numpy(a) for a in (v0, e1, e2)), rays, deltas=deltas)
    h = _walk(world, name)
    assert torch.equal(h.prim >= 0, bf.prim >= 0)
    differ = h.prim != bf.prim
    assert torch.equal(h.t[differ], bf.t[differ])
    assert int(differ.sum()) <= 2
    hit = bf.prim >= 0
    np.testing.assert_allclose(h.t[hit].numpy(), bf.t[hit].numpy(),
                               rtol=1e-5)


def test_walk_counters_and_dead_lanes(world):
    """The counters move by the walk's own steps; dead lanes and misses
    come back as (inf, -1)."""
    s0, p0 = dict(traverse.STEPS), dict(cluster.STEPS)
    h = _walk(world, "stackless")
    hp = _walk(world, "packet")
    assert traverse.STEPS["queries"] == s0["queries"] + 1
    assert traverse.STEPS["steps"] - s0["steps"] >= 2 * traverse.ALIVE_EVERY
    assert cluster.STEPS["flushes"] > p0["flushes"]
    assert cluster.STEPS["steps"] > p0["steps"]
    dead = np.arange(N_RAYS) % 29 == 0
    for x in (h, hp):
        assert (x.prim.numpy()[dead] == -1).all()
        assert np.isposinf(x.t.numpy()[x.prim.numpy() < 0]).all()


@pytest.mark.cuda
def test_walks_on_the_card_match_the_cpu(port_world):
    """Each walk on the card against the same walk on the CPU: prim equal,
    t within 1e-5 relative, the masks equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in ("stackless", "stackless_p", "packet", "packet_p",
                 "moving"):
        cpu = _walk(port_world, name)
        card = _walk(port_world, name, device="cuda")
        if name.endswith("_p"):
            assert torch.equal(card.cpu(), cpu), name
            continue
        assert torch.equal(card.prim.cpu(), cpu.prim), name
        np.testing.assert_allclose(card.t.cpu().numpy(), cpu.t.numpy(),
                                   rtol=1e-5, err_msg=name)
