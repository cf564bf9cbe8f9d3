"""PyTorch port, the grid and kd-tree accelerators: the host builds, the
walks, their dispatch through ``scene.types`` and the front door, against the
JAX reference on the same seeded inputs.

The builds are held array for array (``np.array_equal`` with dtypes). The
walks run un-jitted on the reference side (its XLA while loops) on the soup
of ``tests/test_alt_accels.py`` (300 triangles, 400 rays): hit and prim equal
on every lane, t within 1e-5 relative, the any-hit mask equal. Whole renders
of the sphere scene and of scenes/cornell.pbrt under each accelerator are
held against ``tools/accel_golden.npz`` (``tools/make_accel_golden.py``): at
least 99 % of pixels within rtol 1e-3 / atol 1e-4, the mean within 1e-3
relative.
"""
import dataclasses
import functools
import os
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu.accel import grid as ref_grid
from dartray_tpu.accel import kdtree as ref_kd
from dartray_tpu.core import math as ref_vm
from dartray_tpu.scene import build as ref_sb

from dartray_tpu_torch import stats as stats_mod
from dartray_tpu_torch.accel import grid, kdtree
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene import build as sb
from dartray_tpu_torch.scene import mesh
from dartray_tpu_torch.scene import types as st

import torchhelp as th

sys.path.insert(0, os.path.join(th.ROOT, "tools"))
import make_accel_golden as golden  # noqa: E402

torch.set_num_threads(1)

QUIET = lambda *a, **k: None   # noqa: E731
MODS = {"grid": (grid, ref_grid), "kdtree": (kdtree, ref_kd)}
KINDS = sorted(MODS)


def _same_build(port, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(a, np.ndarray):
            assert th.same_bits(b, a), f.name
        else:
            assert b == a, f.name


def _walk_both(kind, v0, e1, e2, o, d):
    """(port Hits, port any-hit mask, reference Hits, reference mask) of
    the same rays over each package's own build."""
    mod, ref_mod = MODS[kind]
    acc = st.to_device(mod.build(v0, e1, e2), "cpu")
    rays = vm.make_rays(torch.from_numpy(o), torch.from_numpy(d))
    racc = ref_mod.build(v0, e1, e2)
    rrays = ref_vm.make_rays(jnp.asarray(o), jnp.asarray(d))
    return (mod.intersect(acc, rays), mod.intersect_p(acc, rays),
            ref_mod.intersect(racc, rrays), ref_mod.intersect_p(racc, rrays))


def _same_hits(h, occ, rh, rocc):
    prim = np.asarray(rh.prim)
    assert np.array_equal(h.prim.numpy(), prim)
    hit = prim >= 0
    assert 0 < hit.sum() < prim.size
    np.testing.assert_allclose(h.t.numpy()[hit], np.asarray(rh.t)[hit],
                               rtol=1e-5)
    assert np.isposinf(h.t.numpy()[~hit]).all()
    assert np.array_equal(occ.numpy(), np.asarray(rocc))


@pytest.mark.parametrize("kind", KINDS)
def test_build_is_the_references(kind):
    v0, e1, e2 = th.soup(300, 0)
    mod, ref_mod = MODS[kind]
    _same_build(mod.build(v0, e1, e2), ref_mod.build(v0, e1, e2))


@pytest.mark.parametrize("kind", KINDS)
def test_hits_are_the_references(kind):
    """Closest hits and the any-hit mask over the reference's soup."""
    v0, e1, e2 = th.soup(300, 0)
    o, d = th.ray_arrays(400, 1)
    _same_hits(*_walk_both(kind, v0, e1, e2, o, d))


@pytest.mark.parametrize("kind", KINDS)
def test_ties_go_to_the_earlier_triangle(kind):
    """Every triangle twice (ids i and i + 60): each pair hits at the same
    t, and the sequential strict update keeps the one earlier in the list,
    as the flattened test must."""
    v0, e1, e2 = (np.concatenate([a, a]) for a in th.soup(60, 3))
    o, d = th.ray_arrays(400, 4)
    h, occ, rh, rocc = _walk_both(kind, v0, e1, e2, o, d)
    _same_hits(h, occ, rh, rocc)
    assert (h.prim.numpy() < 60).all()


@pytest.mark.parametrize("kind", KINDS)
def test_torch_operations_are_bounded_by_steps(kind):
    """The host issues a fixed number of operations a step (DDA step or
    node), not one a triangle of a voxel or leaf: 600 copies of one small
    triangle pile into one voxel / leaf beside the soup, and the walk issues
    fewer than 300 operations a step."""
    mod, _ = MODS[kind]
    v0, e1, e2 = th.soup(200, 5)
    pile = [np.repeat(a[:1] * 0.1, 600, 0) for a in (v0, e1, e2)]
    v0, e1, e2 = (np.concatenate([a, p]) for a, p in zip((v0, e1, e2), pile))
    acc = st.to_device(mod.build(v0, e1, e2), "cpu")
    most = acc.max_cell if kind == "grid" else acc.max_leaf
    assert most >= 600
    o, d = th.ray_arrays(400, 6)
    centre = pile[0][0] + (pile[1][0] + pile[2][0]) / 3
    o[:50] = centre - 3.0 * d[:50]    # some rays through the pile
    rays = vm.make_rays(torch.from_numpy(o), torch.from_numpy(d))
    for walk in (mod.intersect, mod.intersect_p):
        steps = mod.STEPS["steps"]
        with stats_mod.TorchOps() as ops:
            h = walk(acc, rays)
        steps = mod.STEPS["steps"] - steps
        assert steps > 3 and ops.n < 300 * steps, (ops.n, steps)
    assert h[:50].all()


@pytest.fixture(scope="module")
def box():
    """The port's compile of the Cornell box under an accelerator ("grid",
    "kdtree" or "bvh"), compiled once an accelerator for this file."""
    @functools.cache
    def build(accelerator):
        return sb.cornell_box().build(accelerator=accelerator)
    return build


def _camera_rays(n=1024, seed=7):
    rng = np.random.RandomState(seed)
    o = np.tile(np.float32([0.0, 1.0, -3.4]), (n, 1))
    d = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n),
                  np.ones(n)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return vm.make_rays(torch.from_numpy(o), torch.from_numpy(d))


@pytest.mark.parametrize("kind", KINDS)
def test_scene_queries_walk_the_alternate(box, kind, monkeypatch):
    """Through ``scene.types``: no kernel wrapper is called, a closest hit
    is the walk's with the attr rows of its prim (the ids and rows the
    kernel's finish gives on the same hits), ``intersect_pair`` is the split
    form, every query is counted, and hits and interactions equal the
    cluster BVH's wherever the prims agree (all but the lanes that graze a
    shared edge)."""
    calls = []
    monkeypatch.setattr(tc, "traverse6", lambda *a, **k: calls.append(1))
    scene = st.to_device(box(kind), "cpu")
    bvh = st.to_device(box("bvh"), "cpu")
    geom = scene.geometry
    assert geom.alt_kind == kind and bvh.geometry.alt is None
    rays = _camera_rays()
    q0 = st.QUERIES["rays"]
    h = st.intersect(geom, rays)
    occ = st.intersect_p(geom, rays)
    hp, occ_p = st.intersect_pair(geom, rays, rays)
    assert calls == [] and st.QUERIES["rays"] - q0 == 4 * rays.n
    walk = MODS[kind][0].intersect(geom.alt, rays)
    assert torch.equal(h.prim, walk.prim) and torch.equal(h.t, walk.t)
    assert th.same_bits(h.rows, st.attr_rows(geom, h.prim.clamp_min(0)))
    assert torch.equal(occ, h.prim >= 0) and torch.equal(occ_p, occ)
    assert torch.equal(hp.prim, h.prim) and th.same_bits(hp.rows, h.rows)
    monkeypatch.undo()
    hb = st.intersect(bvh.geometry, rays)
    same = (hb.prim == h.prim) & (h.prim >= 0)
    assert same.float().mean() > 0.99 and (h.prim == hb.prim).float(
    ).mean() > 0.999
    it = st.interaction(geom, rays, h)
    itb = st.interaction(bvh.geometry, rays, hb)
    for k in ("p", "ns", "ng", "dpdu"):
        for c in range(3):
            np.testing.assert_allclose(it[k][c][same], itb[k][c][same],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("mat_id", "light_id"):
        assert torch.equal(it[k][same], itb[k][same]), k


@pytest.mark.parametrize("kind", KINDS)
def test_adapted_scene_carries_the_alternate(box, kind):
    """``from_reference`` carries the reference's alternate array for array,
    and the port's own compile of the same box builds the same one."""
    ref = ref_sb.cornell_box().build(accelerator=kind)
    port = adapt.from_reference(th.np_tree(ref))
    own = box(kind)
    assert port.geometry.alt_kind == own.geometry.alt_kind == kind
    _same_build(port.geometry.alt, ref.geometry.alt)
    _same_build(own.geometry.alt, ref.geometry.alt)


def test_moving_geometry_keeps_the_cluster_bvh():
    m = mesh.sphere(radius=0.5, nu=8, nv=4)
    m2 = dataclasses.replace(m, verts_end=m.verts + np.float32([0.3, 0, 0]))
    with pytest.warns(UserWarning, match="moving geometry"):
        g = st.compile_geometry([m2], accelerator="kdtree")
    assert g.alt is None and g.alt_kind == "" and g.has_motion
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert st.compile_geometry([m], accelerator="grid").alt_kind == "grid"


# --- whole renders -----------------------------------------------------------

def _check_image(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(img - ref).max())
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()


@pytest.mark.parametrize("name", golden.VARIANTS)
def test_render_pbrt_matches_the_references_golden_image(name):
    """The sphere scene and the Cornell box under each alternate through
    render_pbrt on the CPU."""
    img = manager.render_pbrt(golden.variant_text(name),
                              search_paths=[golden.vg.SCENES],
                              overrides=golden.overrides(name), log=QUIET,
                              device="cpu")
    _check_image(img, np.load(golden.GOLDEN)[name])
    assert img.mean() > 0


@pytest.mark.slow
def test_golden_file_is_the_references_render():
    """The reference, run again, gives the committed golden images."""
    ref = np.load(golden.GOLDEN)
    images, _ = golden.make()
    assert sorted(images) == sorted(ref.files)
    for name, img in images.items():
        assert np.array_equal(img, ref[name]), name
