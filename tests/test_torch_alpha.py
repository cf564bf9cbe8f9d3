"""PyTorch port, alpha cut-outs: ``_alpha_cut``, the static continuation loop
of ``intersect`` / ``intersect_p`` / ``intersect_pair`` on an alpha scene and
the known behaviours l, m and o of the reference, against the JAX reference
on the same seeded inputs and the same packed scene (carried over by
``from_reference``).

The reference's hits come from its Pallas kernel in interpret mode, the
port's from ``traverse6_plain``; hits are compared after the finish step
(known behaviour a): prim equal, t to rtol 1e-5, b1 / b2 to rtol 1e-4 /
atol 1e-5. The whole render of ``scenes/alpha.pbrt`` is held against
``tools/lights_golden.npz`` (the reference's render, made by
``tools/make_lights_golden.py``): at least 99 % of pixels within rtol 1e-3 /
atol 1e-4 and the mean within 1e-3 relative.
"""
import collections
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu.accel import traverse as ref_tv
from dartray_tpu.core import math as ref_vm
from dartray_tpu.scene import mesh as ref_mesh
from dartray_tpu.scene import parser as ref_parser
from dartray_tpu.scene import types as ref_st

from dartray_tpu_torch.accel.traverse import Hits
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene import mesh as mesh_mod
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import types as st

import torchhelp as th

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_lights_golden as golden  # noqa: E402

torch.set_num_threads(1)

N = 512
QUIET = lambda *a, **k: None   # noqa: E731


@pytest.fixture(scope="module", autouse=True)
def eager(request):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    th.eager_reference(mp)


def _both(text):
    """(port host scene carried from the reference's, reference device
    scene) of a scene text parsed by the reference."""
    host = ref_parser.parse(text, log=QUIET).scene
    return (st.to_device(adapt.from_reference(th.np_tree(host)), "cpu"),
            ref_st.to_device(host))


@pytest.fixture(scope="module")
def stacked():
    with open(golden.ALPHA) as f:
        return _both(f.read())


def _rays(o, d, tmax=None):
    port = vm.make_rays(th.t3(o), th.t3(d),
                        tmax=None if tmax is None else torch.from_numpy(tmax))
    ref = ref_vm.make_rays(th.j3(o), th.j3(d),
                           tmax=None if tmax is None else jnp.asarray(tmax))
    return port, ref


def _camera_rays(seed=1, z=0.45):
    """Rays from about the camera of alpha.pbrt through the quad stack."""
    rng = np.random.RandomState(seed)
    o = (np.array([0.0, 0.0, -3.0]) + rng.randn(N, 3) * 0.05).astype(
        np.float32)
    at = np.concatenate([rng.uniform(-1.3, 1.3, (N, 2)),
                         np.full((N, 1), z)], -1)
    d = (at - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _shadow_rays(seed=2):
    """From the wall toward the distant light of alpha.pbrt, through the
    masks; a quarter of the lanes dead."""
    rng = np.random.RandomState(seed)
    o = np.concatenate([rng.uniform(-1.5, 1.5, (N, 2)),
                        np.full((N, 1), 1.99)], -1).astype(np.float32)
    d = np.tile(np.array([-1.0, 1.5, -5.0]) / np.linalg.norm([-1, 1.5, -5]),
                (N, 1)).astype(np.float32)
    tmax = np.where(rng.rand(N) < 0.25, -1.0, 10.0).astype(np.float32)
    return o, d, tmax


def _same_hits(got, want):
    prim, rprim = got.prim.numpy(), np.asarray(want.prim)
    assert (prim == rprim).all(), (prim != rprim).sum()
    hit = prim >= 0
    assert hit.any()
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-5)
    for f in ("b1", "b2"):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(want, f))[hit],
                                   rtol=1e-4, atol=1e-5)


def test_alpha_cut_is_the_references(stacked):
    """Seeded hits over the four masked quads and the wall, misses among
    them, without attr rows (the port gathers them) and with them."""
    scene, rscene = stacked
    geom, rgeom = scene.geometry, rscene.geometry
    rng = np.random.RandomState(3)
    prim = rng.randint(-1, geom.n_prims, N).astype(np.int32)
    b1 = rng.rand(N).astype(np.float32)
    b2 = (rng.rand(N) * (1.0 - b1)).astype(np.float32)
    t = np.where(prim >= 0, rng.rand(N) + 1.0, np.inf).astype(np.float32)
    ref = ref_st._alpha_cut(rgeom, ref_tv.Hits(
        t=jnp.asarray(t), prim=jnp.asarray(prim), b1=jnp.asarray(b1),
        b2=jnp.asarray(b2)))
    hits = Hits(t=torch.from_numpy(t), prim=torch.from_numpy(prim),
                b1=torch.from_numpy(b1), b2=torch.from_numpy(b2))
    got = st._alpha_cut(geom, hits)
    assert (got.numpy() == np.asarray(ref)).all()
    assert 0.2 < got.numpy().mean() < 0.6
    rows = st.attr_rows(geom, hits.prim.clamp_min(0))
    assert torch.equal(st._alpha_cut(geom, hits._replace(rows=rows)), got)


def test_intersect_is_the_references(stacked):
    scene, rscene = stacked
    o, d = _camera_rays()
    rays, rrays = _rays(o, d)
    _same_hits(st.intersect(scene.geometry, rays),
               ref_st.intersect(rscene.geometry, rrays))
    _same_hits(st.intersect(scene.geometry, rays, sort=False),
               ref_st.intersect(rscene.geometry, rrays, sort=False))


def test_intersect_p_and_pair_are_the_references(stacked):
    scene, rscene = stacked
    o, d, tmax = _shadow_rays()
    sh, rsh = _rays(o, d, tmax)
    occ = st.intersect_p(scene.geometry, sh).numpy()
    assert (occ == np.asarray(ref_st.intersect_p(rscene.geometry,
                                                 rsh))).all()
    assert 0.1 < occ.mean() < 0.7 and not occ[tmax < 0].any()
    oe, de = _camera_rays(seed=4)
    ext, rext = _rays(oe, de)
    h, occ = st.intersect_pair(scene.geometry, ext, sh)
    rh, rocc = ref_st.intersect_pair(rscene.geometry, rext, rsh)
    _same_hits(h, rh)
    assert (occ.numpy() == np.asarray(rocc)).all()


def _count_launches(monkeypatch):
    """Count the v6 launches by mode on the CPU: the plain version stands in
    for the kernel here, so the wrapper itself is counted."""
    counts = collections.Counter()
    real = tc.traverse6

    def counted(bvh, o, d, tmin, tmax, *, any_hit=False, anyf=None,
                time=None):
        counts["mixed" if anyf is not None else
               "any" if any_hit else "closest"] += 1
        return real(bvh, o, d, tmin, tmax, any_hit=any_hit, anyf=anyf,
                    time=time)

    monkeypatch.setattr(tc, "traverse6", counted)
    return counts


def test_an_alpha_query_is_four_closest_launches(stacked, monkeypatch):
    """The loop is static: ALPHA_ROUNDS closest-hit launches a query whatever
    the lanes hold, no any-hit and no mixed launch; intersect_pair is the
    two queries."""
    scene, _ = stacked
    counts = _count_launches(monkeypatch)
    o, d, tmax = _shadow_rays()
    sh, _ = _rays(o, d, tmax)
    ext, _ = _rays(*_camera_rays())
    assert st.ALPHA_ROUNDS == 4
    st.intersect(scene.geometry, ext)
    assert counts == {"closest": 4}
    st.intersect_p(scene.geometry, sh)
    assert counts == {"closest": 8}
    st.intersect_pair(scene.geometry, ext, sh)
    assert counts == {"closest": 16}


def test_path_wave_on_an_alpha_scene_is_closest_launches_only(
        stacked, monkeypatch):
    """A path wave of depth D on an alpha scene: 4 x (1 camera + D extension
    + D + 1 shadow) closest-hit launches (the bench scene with an alpha
    floor at depth 5: 48), and no other."""
    counts = _count_launches(monkeypatch)
    with open(golden.ALPHA) as f:
        text = f.read().replace(
            'SurfaceIntegrator "directlighting" "integer maxdepth" [1]',
            'SurfaceIntegrator "path" "integer maxdepth" [2]')
    img = manager.render_pbrt(text, log=QUIET, device="cpu",
                              overrides={"spp": 1})
    assert np.isfinite(img).all() and img.mean() > 0
    assert counts == {"closest": 4 * (1 + 2 + 3)}


def test_alpha_is_evaluated_at_p_zero():
    """Known behaviour l: the mask is evaluated with p = 0, so a 3-D
    checkerboard whose cell at the origin is cut (tex1 0) cuts every hit of
    the quad, wherever it lands; both packages let every ray through."""
    text = ('LookAt 0 0 -3  0 0 0  0 1 0\nCamera "perspective"\nWorldBegin\n'
            'Texture "c3" "float" "checkerboard" "integer dimension" [3] '
            '"float tex1" [0] "float tex2" [1]\n'
            'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
            '"point P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0] '
            '"float uv" [0 0 1 0 1 1 0 1] "texture alpha" "c3"\n'
            'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
            '"point P" [-4 -4 2  4 -4 2  4 4 2  -4 4 2]\nWorldEnd\n')
    scene, rscene = _both(text)
    assert scene.geometry.has_alpha
    o, d = _camera_rays(z=0.0)
    rays, rrays = _rays(o, d)
    h = st.intersect(scene.geometry, rays)
    _same_hits(h, ref_st.intersect(rscene.geometry, rrays))
    assert (h.prim.numpy() >= 2).all()        # the wall, never the quad


def _stack_text(n):
    """`n` fully cut quads (alpha constant 0) at z = 0, 0.1, ... and a wall."""
    quads = "".join(
        'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" '
        f'[-1 -1 {z}  1 -1 {z}  1 1 {z}  -1 1 {z}] "texture alpha" "zero"\n'
        for z in np.arange(n) * 0.1)
    return ('LookAt 0 0 -3  0 0 0  0 1 0\nCamera "perspective"\nWorldBegin\n'
            'Texture "zero" "float" "constant" "float value" [0]\n' + quads
            + 'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
            '"point P" [-4 -4 2  4 -4 2  4 4 2  -4 4 2]\nWorldEnd\n')


def test_a_ray_stops_at_its_fourth_cut_layer():
    """Known behaviour m: through five cut layers a ray keeps the fourth
    layer's hit although it is cut; with three it reaches the wall. The
    query statistic counts as the reference's QUERY_LOG: an alpha
    closest-hit query four times its rays, an occlusion query five times."""
    rng = np.random.RandomState(6)
    o = np.concatenate([rng.uniform(-0.8, 0.8, (N, 2)),
                        np.full((N, 1), -1.0)], -1).astype(np.float32)
    d = np.tile(np.float32([0, 0, 1]), (N, 1))
    for layers, want_prim in ((5, (6, 7)), (3, (6, 7))):
        scene, rscene = _both(_stack_text(layers))
        rays, rrays = _rays(o, d)
        q0 = st.QUERIES["rays"]
        del ref_st.QUERY_LOG[:]
        h = st.intersect(scene.geometry, rays)
        rh = ref_st.intersect(rscene.geometry, rrays)
        assert st.QUERIES["rays"] - q0 == 4 * N
        assert ref_st.QUERY_LOG == [N] * 4
        _same_hits(h, rh)
        # faces 6 and 7 are the fourth quad with five layers, the wall with
        # three
        assert np.isin(h.prim.numpy(), want_prim).all()
        q0 = st.QUERIES["rays"]
        del ref_st.QUERY_LOG[:]
        occ = st.intersect_p(scene.geometry, rays)
        assert (occ.numpy() == np.asarray(ref_st.intersect_p(
            rscene.geometry, rrays))).all() and occ.numpy().all()
        assert st.QUERIES["rays"] - q0 == 5 * N
        assert ref_st.QUERY_LOG == [N] * 5
        del ref_st.QUERY_LOG[:]


def test_no_texture_table_means_no_alpha():
    """Known behaviour o: a mesh that names an alpha texture in a scene
    with no texture table compiles as an opaque one, in both packages."""
    m, rm = mesh_mod.sphere(nu=8, nv=4), ref_mesh.sphere(nu=8, nv=4)
    m.alpha_tid = rm.alpha_tid = 0
    geom = st.compile_geometry([m])
    rgeom = ref_st.compile_geometry([rm])
    assert not geom.has_alpha and not rgeom.has_alpha
    assert geom.alpha_tid is None and rgeom.alpha_tid is None


def test_alpha_mask_cutout_shows_holes():
    """The reference's tests/test_textures.py case on the port: a
    checkerboard alpha mask on a front quad lets rays through its zero-alpha
    cells to the wall behind."""
    scene = """
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
SurfaceIntegrator "directlighting"
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "distant" "color L" [3 3 3] "point from" [0 0 -5] "point to" [0 0 0]
Texture "cut" "float" "checkerboard"
  "float uscale" [4] "float vscale" [4]
  "float tex1" [1] "float tex2" [0]
AttributeBegin
  Material "matte" "color Kd" [1 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]
    "float uv" [0 0  1 0  1 1  0 1]
    "texture alpha" "cut"
AttributeEnd
AttributeBegin
  Material "matte" "color Kd" [0 0 1]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-4 -4 2  4 -4 2  4 4 2  -4 4 2]
AttributeEnd
WorldEnd
"""
    img = manager.render_pbrt(scene, log=QUIET, device="cpu")
    assert np.isfinite(img).all()
    c = img[8:24, 8:24]
    red = (c[..., 0] > 2 * c[..., 2] + 1e-3)
    blue = (c[..., 2] > 2 * c[..., 0] + 1e-3)
    assert red.mean() > 0.2, red.mean()
    assert blue.mean() > 0.2, blue.mean()


def test_render_pbrt_matches_the_references_golden_image():
    """scenes/alpha.pbrt through the port's front door on the CPU against
    the reference's render_pbrt of the same file."""
    img = manager.render_pbrt(golden.ALPHA, log=QUIET, device="cpu")
    ref = np.load(golden.GOLDEN)["alpha"]
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(img - ref).max())
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()
