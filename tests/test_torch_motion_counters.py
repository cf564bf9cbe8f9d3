"""What the port's collector sees of moving geometry: the lanes handed to
the traversal kernel's motion instantiation (``lanes_motion/<mode>``,
``scene/types.py``), their node pops and triangle tests
(``pops_motion/<mode>``, ``tests_motion/<mode>``) and the ``motion`` tag
on the ``kernel`` spans of those launches (``ops/traverse_cuda.py``),
through the AO integrator on the CPU; nothing on a static scene, nothing
with the collector off; and ``SceneBuilder.add_mesh(verts_end=)`` against
assigning ``verts_end`` after the fact. On the card (``-m cuda``): the
motion kernel against its plain version, raw (t, prim) and work counts."""
import numpy as np
import pytest
import torch

from dartray_tpu_torch import materials, stats
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.integrators import ao
from dartray_tpu_torch.scene import build
from dartray_tpu_torch.scene import mesh as mesh_mod
from dartray_tpu_torch.scene import types as st

import torchhelp as th

torch.set_num_threads(1)

SHIFT = np.float32([0.3, 0.0, 0.0])
SIDE = 16                       # a SIDE x SIDE fan of camera rays
R = SIDE * SIDE
PROBES = 3


def _builder(moving, assign=False):
    """A sphere over a floor; the sphere moves by SHIFT over the shutter,
    given to ``add_mesh`` or (`assign`) set on the builder's mesh after."""
    b = build.SceneBuilder()
    m = b.add_material(materials.matte())
    sph = mesh_mod.sphere(radius=0.5, nu=16, nv=8)
    end = sph.verts + SHIFT if moving and not assign else None
    b.add_mesh(sph, m, verts_end=end)
    if moving and assign:
        b.meshes[0].verts_end = b.meshes[0].verts + SHIFT
    b.add_mesh(mesh_mod.make_mesh(
        [[-3, -0.5, -3], [3, -0.5, -3], [3, -0.5, 3], [-3, -0.5, 3]],
        [[0, 1, 2], [0, 2, 3]]), m)
    return b


@pytest.fixture(scope="module")
def scenes():
    return {k: st.to_device(_builder(k == "moving").build(), "cpu")
            for k in ("moving", "static")}


def _ao_wave(scene):
    """One AO wave of R camera rays at times spread over the shutter."""
    g = np.random.default_rng(5)
    ys, xs = np.meshgrid(np.linspace(-0.6, 0.6, SIDE),
                         np.linspace(-0.8, 0.8, SIDE), indexing="ij")
    d = np.stack([xs.ravel(), ys.ravel(), np.full(R, 3.0)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.float32([0.0, 0.0, -3.0]), (R, 1))
    rays = vm.make_rays(torch.from_numpy(o), torch.from_numpy(
        d.astype(np.float32)), time=torch.from_numpy(
            g.random(R).astype(np.float32)))
    pix = torch.arange(R, dtype=torch.int32)
    sctx = {"px": pix % SIDE, "py": pix // SIDE,
            "s_idx": torch.zeros(R, dtype=torch.int32)}
    return ao.li(ao.AOIntegrator(n_samples=PROBES), scene, rays, None, sctx)


def _collect(scene):
    rs = stats.RenderStats()
    with stats.collect(rs):
        L = _ao_wave(scene)
    ex = rs.export()
    return L, ex["counters"], [s for s in ex["spans"] if s["name"] == "kernel"]


def test_a_moving_wave_counts_its_motion_lanes_and_tags_its_launches(scenes):
    L, c, kernels = _collect(scenes["moving"])
    assert c["lanes_motion/closest"] == R
    assert c["lanes_motion/any"] == PROBES * R
    assert c["lanes/closest"] == R and c["lanes/any"] == PROBES * R
    assert len(kernels) == 1 + PROBES
    assert all(s["attrs"] == {"motion": True} for s in kernels)
    assert 0 < float(L.x.sum()) < R           # some rays hit, some clear
    for mode in ("closest", "any"):           # every lane pops the root
        assert c["pops_motion/" + mode] >= c["lanes_motion/" + mode]
        assert c["tests_motion/" + mode] > 0


def test_a_static_wave_counts_and_tags_none(scenes):
    _, c, kernels = _collect(scenes["static"])
    assert not [k for k in c if k.endswith(tuple(
        f"_motion/{m}" for m in ("closest", "any", "mixed")))]
    assert c["lanes/closest"] == R and c["lanes/any"] == PROBES * R
    assert len(kernels) == 1 + PROBES
    assert all(s["attrs"] == {} for s in kernels)


def test_nothing_is_counted_with_the_collector_off(scenes, monkeypatch):
    """No lane is counted (no device sum either) and no span is made."""
    names = []
    count = stats.count

    def spy(name, n=1):
        names.append(name)
        return count(name, n)

    def refuse(*a, **k):
        raise AssertionError("a span made with the collector off")
    monkeypatch.setattr(stats, "count", spy)
    monkeypatch.setattr(stats.Span, "__init__", refuse)
    L = _ao_wave(scenes["moving"])
    assert not [k for k in names if k.startswith(("lanes", "pops_motion",
                                                  "tests_motion"))]
    monkeypatch.undo()
    L2, _, _ = _collect(scenes["moving"])
    assert torch.equal(L.x, L2.x)             # collecting moves no answer


def test_add_mesh_verts_end_equals_assigning_it_after():
    given = _builder(True).build()
    after = _builder(True, assign=True).build()
    assert given.geometry.has_motion and after.geometry.has_motion
    a = th.port_leaves(given, port_only=True)
    b = th.port_leaves(after, port_only=True)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert th.same_bits(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_add_mesh_refuses_a_verts_end_of_another_shape():
    b = build.SceneBuilder()
    sph = mesh_mod.sphere(radius=0.5, nu=8, nv=4)
    with pytest.raises(ValueError, match="verts_end"):
        b.add_mesh(sph, 0, verts_end=sph.verts[:-1])


def _card_motion(k):
    """A sphere moving by four times its radius over the shutter, packed in
    clusters of `k` triangles, with a wave of 4,096 rays around its swept
    volume at random times: a fifth of the lanes dead, half of them any-hit
    (numpy)."""
    from dartray_tpu_torch.accel import bvh as bvh_mod, cluster
    from dartray_tpu_torch.ops import traverse_cuda as tc
    m = mesh_mod.sphere(radius=0.5, nu=24, nv=12)
    a = bvh_mod.triangles_to_mt(m.verts, m.faces)
    b = bvh_mod.triangles_to_mt(m.verts + np.float32([2.0, 0, 0]), m.faces)
    cb = cluster.build_motion(*a, *b, k=k)
    packed, _ = tc.pack(cb.node_lo, cb.node_hi, cb.node_child, cb.node_axis,
                        cb.tri_v0, cb.tri_e1, cb.tri_e2, cb.tri_id,
                        deltas=(cb.tri_dv0, cb.tri_de1, cb.tri_de2))
    g = np.random.default_rng(90 + k)
    n = 4096
    o = g.normal(size=(n, 3)) * 1.5 + [1.0, 0, 0]
    aim = np.stack([2.0 * g.random(n), np.zeros(n), np.zeros(n)], -1)
    d = aim + 0.3 * g.normal(size=(n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(g.random(n) < 0.2, -1.0, np.inf)
    planes = [x.astype(np.float32) for x in (o, d, tmax, g.random(n),
                                             g.random(n) < 0.5)]
    return packed, planes


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32, 40])
@pytest.mark.parametrize("mode", ["closest", "any", "mixed"])
def test_motion_kernel_equals_plain_walk_and_counts_its_work(k, mode):
    """``traverse6_kernel<true>`` against ``traverse6_plain`` on the same
    device tensors: raw (t, prim) equal bit for bit, overflow flag 0, and
    the warps' node pops and triangle tests (``counts``) equal to the
    plain walk's ``stats``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from dartray_tpu_torch.ops import traverse_cuda as tc
    dev = torch.device("cuda", 0)
    packed, (o, d, tmax, ts, anyf) = _card_motion(k)
    bvh = st.to_device(packed, dev)
    rays = vm.make_rays(*(torch.from_numpy(x).to(dev) for x in (o, d)),
                        tmax=torch.from_numpy(tmax).to(dev),
                        time=torch.from_numpy(ts).to(dev))
    kw = {"any_hit": mode == "any", "time": rays.time,
          "anyf": torch.from_numpy(anyf).to(dev) if mode == "mixed"
          else None}
    args = (bvh, rays.o, rays.d, rays.tmin, rays.tmax)
    tc.reset_overflow(dev)
    key = f"traverse6_motion:{mode}"
    before = tc.LAUNCHES[key]
    work, want_work = {}, {}
    got = tc.traverse6(*args, **kw, counts=work)
    want = tc.traverse6_plain(*args, **kw, stats=want_work)
    torch.cuda.synchronize()
    assert tc.LAUNCHES[key] == before + 1
    assert int(tc.overflow_flag(dev).item()) == 0
    assert bool((want[1] >= 0).any()) and bool((want[1] < 0).any())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert {k_: int(v) for k_, v in work.items()} == {
        k_: want_work[k_] for k_ in ("node_pops", "tri_tests")}


@pytest.mark.cuda
def test_collected_motion_work_on_the_card_is_the_plain_walks():
    """With the collector on, a moving scene's closest, any-hit and mixed
    queries on the card count as ``pops_motion/<mode>`` and
    ``tests_motion/<mode>`` what the plain walk does on the same rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from dartray_tpu_torch.ops import traverse_cuda as tc
    dev = torch.device("cuda", 0)
    geom = st.to_device(_builder(True).build(), dev).geometry
    _, (o, d, tmax, ts, _) = _card_motion(32)
    rays = vm.make_rays(*(torch.from_numpy(x).to(dev) for x in (o, d)),
                        tmax=torch.from_numpy(tmax).to(dev),
                        time=torch.from_numpy(ts).to(dev))
    rs = stats.RenderStats()
    with stats.collect(rs):
        st.intersect(geom, rays)
        st.intersect_p(geom, rays)
        st.intersect_pair(geom, rays, rays)
    c = rs.export()["counters"]
    time = st._shutter_time01(geom, rays)
    twice = lambda x: torch.cat([x, x])
    both = (vm.V3(*map(twice, rays.o)), vm.V3(*map(twice, rays.d)),
            *map(twice, (rays.tmin, rays.tmax, time)))
    flag = torch.cat([torch.zeros_like(time), torch.ones_like(time)])
    for mode, args, kw in (
            ("closest", (rays.o, rays.d, rays.tmin, rays.tmax, time), {}),
            ("any", (rays.o, rays.d, rays.tmin, rays.tmax, time),
             {"any_hit": True}),
            ("mixed", both, {"anyf": flag})):
        want = {}
        tc.traverse6_plain(geom.packed, *args[:4], time=args[4], stats=want,
                           **kw)
        assert c["pops_motion/" + mode] == want["node_pops"], mode
        assert c["tests_motion/" + mode] == want["tri_tests"], mode
