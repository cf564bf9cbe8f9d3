"""What the port's collector sees of moving geometry: the lanes handed to
the traversal kernel's motion instantiation (``lanes_motion/<mode>``,
``scene/types.py``) and the ``motion`` tag on the ``kernel`` spans of
those launches (``ops/traverse_cuda.py``), through the AO integrator on
the CPU; nothing on a static scene, nothing with the collector off; and
``SceneBuilder.add_mesh(verts_end=)`` against assigning ``verts_end``
after the fact."""
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


def test_a_static_wave_counts_and_tags_none(scenes):
    _, c, kernels = _collect(scenes["static"])
    assert not [k for k in c if k.startswith("lanes_motion/")]
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
    assert not [k for k in names if k.startswith("lanes")]
    monkeypatch.undo()
    L2, _, _ = _collect(scenes["moving"])
    assert torch.equal(L.x, L2.x)             # collecting moves no answer


def test_add_mesh_verts_end_equals_assigning_it_after():
    given = _builder(True).build()
    after = _builder(True, assign=True).build()
    assert given.geometry.has_motion and after.geometry.has_motion
    a, b = th.port_leaves(given), th.port_leaves(after)
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
