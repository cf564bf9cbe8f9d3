"""PyTorch port, the direct-lighting, Whitted and ambient-occlusion
integrators and what they stand on (``uniform_sample_sphere``, the delta
lights of ``sample_li``, ``estimate_direct`` and its helpers), against the
JAX reference on the same inputs.

The reference runs un-jitted, its ``fori_loop`` over lights or probes as a
Python loop (compiled, it would build a traversal loop for a minute), its
Pallas traversal kernel in interpret mode over the SAME packed scene, carried
across by ``from_reference``. Units: rtol 1e-5 / atol 1e-6 (the same f32
operations; the compilers may contract a multiply-add differently). Whole
waves: >= 99 % of pixels within rtol 1e-3 / atol 1e-4 and the image mean
within 1e-3: a ray through a shared edge may pick the other triangle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu import bsdf as ref_bx
from dartray_tpu import cameras as ref_cam
from dartray_tpu import film as ref_film
from dartray_tpu import lights as ref_lt
from dartray_tpu import materials as ref_mat
from dartray_tpu import samplers as ref_samplers
from dartray_tpu.core import sampling as ref_smp
from dartray_tpu.core import transform as ref_tr
from dartray_tpu.integrators import ao as ref_ao
from dartray_tpu.integrators import common as ref_common
from dartray_tpu.integrators import direct as ref_di
from dartray_tpu.integrators import whitted as ref_wh
from dartray_tpu.renderers import sampler as ref_rend
from dartray_tpu.scene import build as ref_sb
from dartray_tpu.scene import types as ref_st

from dartray_tpu_torch import bsdf as bx
from dartray_tpu_torch import cameras, samplers
from dartray_tpu_torch import lights as lt_mod
from dartray_tpu_torch import materials as mat_mod
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.core import sampling as smp
from dartray_tpu_torch.core import transform as tr
from dartray_tpu_torch.integrators import ao, common, direct, path, whitted
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.renderers import sampler as rend
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene import build as sb
from dartray_tpu_torch.scene import mesh as mesh_mod
from dartray_tpu_torch.scene import types as st

import torchhelp as th

torch.set_num_threads(1)

W = H = 16
SPP = 2
DEPTH = 2
EYE, LOOK, UP, FOV = [0, 1, -3.2], [0, 1, 0], [0, 1, 0], 40.0
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def interpret_kernel(request):
    """The reference's traversal kernel runs in interpret mode and its
    ``fori_loop`` bodies run eagerly, for every test of this file."""
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    th.eager_reference(mp)


def _add_delta_lights(b, mod, trm):
    """A point, a spot and a distant light beside the box's area light."""
    b.add_light(mod.point_light((0.3, 1.6, -0.2), intensity=(2.0, 1.5, 1.0)))
    w2l = np.asarray(trm.look_at([-0.5, 1.8, -0.5], [0.2, 0.0, 0.3],
                                 [0, 1, 0]).m_inv, np.float32)
    b.add_light(mod.spot_light((-0.5, 1.8, -0.5), w2l,
                               intensity=(6.0, 6.0, 8.0), cone_angle=40.0,
                               cone_delta=15.0))
    b.add_light(mod.distant_light((0.2, 1.0, -0.6), radiance=(0.5, 0.6, 0.7)))
    return b


@pytest.fixture(scope="module")
def lit(interpret_kernel):
    """The Cornell box with four lights of four kinds, in both packages; one
    camera wave's hits and everything ``estimate_direct`` takes."""
    host = _add_delta_lights(ref_sb.cornell_box(), ref_lt, ref_tr).build()
    rscene = ref_st.to_device(host)
    scene = st.to_device(adapt.from_reference(th.np_tree(host)), "cpu")
    n = W * H
    rng = np.random.RandomState(3)
    rcam = ref_cam.perspective(ref_tr.look_at(EYE, LOOK, UP), FOV, W, H)
    rsmp = ref_samplers.make_sampler("lowdiscrepancy", spp=1)
    rpx, rpy = ref_rend.pixel_grid(W, H)
    rcs = ref_samplers.camera_samples(rsmp, rpx, rpy,
                                      jnp.zeros_like(rpx))
    rrays, _, _ = ref_cam.generate_rays(rcam, rcs, W, H)
    o, d = th.n3(rrays.o), th.n3(rrays.d)
    rays = vm.make_rays(th.t3(o), th.t3(d))
    rhits = ref_st.intersect(rscene.geometry, rrays)
    hits = st.intersect(scene.geometry, rays)
    assert (np.asarray(rhits.prim) == hits.prim.numpy()).all()
    rit = ref_st.interaction(rscene.geometry, rrays, rhits)
    it = st.interaction(scene.geometry, rays, hits)
    rframe = ref_bx.make_frame(rit["ns"], rit["dpdu"], rit["ng"])
    frame = bx.make_frame(it["ns"], it["dpdu"], it["ng"])
    rparams = ref_mat.eval_params(rscene.materials, rit["mat_id"], None, rit)
    params = mat_mod.eval_params(scene.materials, it["mat_id"], None, it)
    u = {k: rng.rand(n, 2).astype(np.float32) for k in ("light", "bsdf")}
    uc = {k: rng.rand(n).astype(np.float32)
          for k in ("light", "bsdf", "select")}
    return dict(host=host, rscene=rscene, scene=scene, n=n, rit=rit, it=it,
                rframe=rframe, frame=frame, rparams=rparams, params=params,
                u=u, uc=uc, hit=hits.prim.numpy() >= 0,
                rsctx={"sampler": rsmp, "px": rpx, "py": rpy,
                       "s_idx": jnp.zeros_like(rpx)})


def _close(got, want, mask=None, what=""):
    got, want = np.asarray(got), np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def test_uniform_sample_sphere():
    u = np.random.RandomState(1).rand(4096, 2).astype(np.float32)
    got = smp.uniform_sample_sphere(torch.from_numpy(u))
    want = ref_smp.uniform_sample_sphere(jnp.asarray(u))
    _close(th.n3(got), th.n3(want))
    np.testing.assert_allclose(np.linalg.norm(th.n3(got), axis=-1), 1.0,
                               atol=1e-6)


def test_delta_light_table_matches_reference():
    """The port's own ``build_table`` for point, spot and distant lights
    (and the area light beside them) against the reference's, leaf by leaf
    and bit for bit; ``from_reference`` carries ``p`` and ``w2l``."""
    ref = th.np_tree(_add_delta_lights(ref_sb.cornell_box(), ref_lt,
                                       ref_tr).build())
    own = _add_delta_lights(sb.cornell_box(), lt_mod, tr).build()
    carried = adapt.from_reference(ref)
    for scene in (own, carried):
        leaves = th.port_leaves(scene.lights)
        assert {".p", ".w2l", ".kind", ".power_cdf"} <= set(leaves)
        for path_, leaf in leaves.items():
            want = th.ref_leaf(ref["lights"], path_)
            if isinstance(leaf, np.ndarray):
                assert th.same_bits(leaf, want), path_
            else:
                assert leaf == want, path_
    assert list(own.lights.kind) == [lt_mod.POINT, lt_mod.SPOT,
                                     lt_mod.DISTANT, lt_mod.AREA]
    assert lt_mod.INF_DIST == ref_lt.INF_DIST


@pytest.mark.parametrize("kind", ["point", "spot", "distant", "area",
                                  "mixed"])
def test_sample_li_matches_reference(lit, kind):
    n = lit["n"]
    idx = {"point": 0, "spot": 1, "distant": 2, "area": 3}.get(kind)
    li = (np.random.RandomState(5).randint(0, 4, n) if idx is None
          else np.full(n, idx)).astype(np.int32)
    want = ref_lt.sample_li(lit["rscene"].lights, lit["rscene"].geometry,
                            jnp.asarray(li), lit["rit"]["p"],
                            jnp.asarray(lit["u"]["light"]),
                            jnp.asarray(lit["uc"]["light"]))
    got = lt_mod.sample_li(lit["scene"].lights, lit["scene"].geometry,
                           torch.from_numpy(li), lit["it"]["p"],
                           torch.from_numpy(lit["u"]["light"]),
                           torch.from_numpy(lit["uc"]["light"]))
    m = lit["hit"]
    _close(th.n3(got.wi), th.n3(want.wi), m, "wi")
    _close(th.n3(got.li), th.n3(want.li), m, "li")
    _close(got.pdf, want.pdf, m, "pdf")
    _close(got.dist, want.dist, m, "dist")
    assert (got.is_delta.numpy() == np.asarray(want.is_delta)).all()
    if kind == "spot":      # the cone is partly lit: the falloff is exercised
        lum = th.n3(got.li)[m].sum(-1)
        assert (lum == 0).any() and (lum > 0).any()


def _ed_args(lit, side):
    """The sample arguments of estimate_direct for one package."""
    conv = jnp.asarray if side == "ref" else torch.from_numpy
    return (conv(lit["u"]["light"]), conv(lit["uc"]["light"]),
            conv(lit["u"]["bsdf"]), conv(lit["uc"]["bsdf"]))


@pytest.mark.parametrize("light", [0, 1, 2, 3])
def test_estimate_direct_matches_reference(lit, light):
    """One light of each kind: a delta light takes the plain estimate, the
    area light the MIS pair (any-hit shadow wave + closest-hit BSDF wave)."""
    n = lit["n"]
    li = np.full(n, light, np.int32)
    want = ref_common.estimate_direct(
        lit["rscene"], lit["rit"], lit["rframe"], lit["rparams"],
        lit["rit"]["wo"], jnp.asarray(li), *_ed_args(lit, "ref"))
    got = common.estimate_direct(
        lit["scene"], lit["it"], lit["frame"], lit["params"],
        lit["it"]["wo"], torch.from_numpy(li), *_ed_args(lit, "port"))
    m = lit["hit"]
    close = np.isclose(th.n3(got)[m], th.n3(want)[m], rtol=RTOL,
                       atol=ATOL).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert th.n3(got)[m].sum() > 0


def test_uniform_sample_one_and_all_lights_match_reference(lit):
    want_one = ref_common.uniform_sample_one_light(
        lit["rscene"], lit["rit"], lit["rframe"], lit["rparams"],
        lit["rit"]["wo"], jnp.asarray(lit["uc"]["select"]),
        *_ed_args(lit, "ref"))
    want_all = ref_common.uniform_sample_all_lights(
        lit["rscene"], lit["rit"], lit["rframe"], lit["rparams"],
        lit["rit"]["wo"], lit["rsctx"], dim0=5)
    got_one = common.uniform_sample_one_light(
        lit["scene"], lit["it"], lit["frame"], lit["params"],
        lit["it"]["wo"], torch.from_numpy(lit["uc"]["select"]),
        *_ed_args(lit, "port"))
    px, py = rend.pixel_grid(W, H, device="cpu")
    sctx = {"sampler": samplers.make_sampler("lowdiscrepancy", spp=1),
            "px": px, "py": py, "s_idx": torch.zeros_like(px)}
    got_all = common.uniform_sample_all_lights(
        lit["scene"], lit["it"], lit["frame"], lit["params"],
        lit["it"]["wo"], sctx, dim0=5)
    m = lit["hit"]
    for got, want in ((got_one, want_one), (got_all, want_all)):
        close = np.isclose(th.n3(got)[m], th.n3(want)[m], rtol=RTOL,
                           atol=ATOL).all(-1)
        assert close.mean() >= 0.99, close.mean()
        assert th.n3(got)[m].sum() > 0


# --------------------------------------------------------------------------
# whole waves
# --------------------------------------------------------------------------

def _reference_image(host, li, spp=SPP):
    scene = ref_st.to_device(host)
    cam = ref_cam.perspective(ref_tr.look_at(EYE, LOOK, UP), FOV, W, H)
    smp_ = ref_samplers.make_sampler("lowdiscrepancy", spp=spp)
    film = ref_film.make_film(W, H)
    px, py = ref_rend.pixel_grid(W, H)
    for s in range(smp_.spp):
        film = ref_rend.render_wave(
            scene, cam, smp_, film, px, py,
            jnp.full(px.shape, s, jnp.int32), li_fn=li, width=W,
            height=H, spp=smp_.spp)
    return np.asarray(ref_film.to_rgb(film))


def _port_image(host, li, spp=SPP):
    cam = cameras.perspective(tr.look_at(EYE, LOOK, UP), FOV, W, H,
                              device="cpu")
    smp_ = samplers.make_sampler("lowdiscrepancy", spp=spp)
    return rend.render(host, cam, smp_, li, W, H, device="cpu")


def _check_image(img, ref):
    assert img.shape == ref.shape == (H, W, 3) and np.isfinite(img).all()
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(img - ref).max())
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()


@pytest.fixture(scope="module")
def cornell(interpret_kernel):
    """(reference host scene, the same scene carried across to the port)."""
    host = ref_sb.cornell_box().build()
    return host, adapt.from_reference(th.np_tree(host))


def _integrators(name):
    """(reference li, port li) of one configuration."""
    if name in ("direct_all", "direct_one"):
        strat = 0 if name == "direct_all" else 1
        assert (direct.STRATEGY_ALL, direct.STRATEGY_ONE) == \
            (ref_di.STRATEGY_ALL, ref_di.STRATEGY_ONE) == (0, 1)
        rig = ref_di.DirectLightingIntegrator(strategy=strat, max_depth=DEPTH)
        ig = direct.DirectLightingIntegrator(strategy=strat, max_depth=DEPTH)
        return (lambda s, r, d, c: ref_di.li(rig, s, r, d, c),
                lambda s, r, d, c: direct.li(ig, s, r, d, c))
    if name == "whitted":
        rig = ref_wh.WhittedIntegrator(max_depth=DEPTH)
        ig = whitted.WhittedIntegrator(max_depth=DEPTH)
        return (lambda s, r, d, c: ref_wh.li(rig, s, r, d, c),
                lambda s, r, d, c: whitted.li(ig, s, r, d, c))
    rig = ref_ao.AOIntegrator(n_samples=4)
    ig = ao.AOIntegrator(n_samples=4)
    return (lambda s, r, d, c: ref_ao.li(rig, s, r, d, c),
            lambda s, r, d, c: ao.li(ig, s, r, d, c))


@pytest.mark.parametrize("name", ["direct_all", "direct_one", "whitted",
                                  "ao"])
def test_wave_matches_reference(cornell, name):
    """Cornell box 16 x 16, 2 spp, depth 2, pixel by pixel, the same samples
    by the counter-based sampler."""
    host, carried = cornell
    rli, pli = _integrators(name)
    ref = _reference_image(host, rli)
    tc.reset_launches()
    img = _port_image(carried, pli)
    _check_image(img, ref)
    assert sum(tc.LAUNCHES.values()) == 0       # the CPU ran plain versions
    if name == "ao":
        assert img.min() >= 0.0 and img.max() <= 1.0
        assert 0.0 < img.mean() < 1.0


def test_whitted_with_several_lights_matches_reference(lit):
    """Whitted samples EVERY light: the four-light box, 1 spp."""
    rli, pli = _integrators("whitted")
    ref = _reference_image(lit["host"], rli, spp=1)
    img = _port_image(adapt.from_reference(th.np_tree(lit["host"])), pli,
                      spp=1)
    _check_image(img, ref)


def test_point_light_inverse_square():
    """A plane facing a point light: Lo = rho / pi * I * cos / d^2 at the
    centre pixel, the reference's own analytic test, in the port."""
    rho = 0.8
    b = sb.SceneBuilder()
    m = b.add_material(mat_mod.matte(kd=(rho,) * 3))
    b.add_mesh(mesh_mod.make_mesh(
        [[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]],
        [[0, 1, 2], [0, 2, 3]]), m)
    b.add_light(lt_mod.point_light((0, 0, -2), intensity=(10.0,) * 3))
    ig = direct.DirectLightingIntegrator(max_depth=1)
    cam = cameras.perspective(tr.look_at((0, 0, -4), (0, 0, 0), [0, 1, 0]),
                              30.0, 16, 16, device="cpu")
    img = rend.render(b.build(), cam,
                      samplers.make_sampler("lowdiscrepancy", spp=16),
                      lambda s, r, d, c: direct.li(ig, s, r, d, c), 16, 16,
                      device="cpu")
    np.testing.assert_allclose(img[8, 8, 0], rho / np.pi * 10.0 / 4.0,
                               rtol=0.05)


@pytest.mark.parametrize("which", ["v3", "v1"])
def test_direct_lighting_over_a_binary_tree_kernel(cornell, monkeypatch,
                                                   which):
    """``DEFAULT_KERNEL`` set to a binary-tree kernel for every kind of
    wave: the direct-lighting image equals the v6 image."""
    _, carried = cornell
    _, pli = _integrators("direct_all")
    base = _port_image(carried, pli, spp=1)
    calls = []
    name = {"v1": "traverse", "v3": "traverse3"}[which]
    real = getattr(tc, name)
    monkeypatch.setattr(tc, name, lambda *a, **k: (calls.append(
        k.get("any_hit", False)), real(*a, **k))[1])
    for key in tc.DEFAULT_KERNEL:
        monkeypatch.setitem(tc.DEFAULT_KERNEL, key, which)
    img = _port_image(carried, pli, spp=1)
    # depth 2, one light: three levels of closest, any, closest
    assert calls == [False, True, False] * (DEPTH + 1)
    close = np.isclose(img, base, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    assert abs(img.mean() - base.mean()) <= 1e-3 * base.mean()


def test_path_image_is_brighter_than_direct(cornell):
    """The relation the reference's own Cornell test holds: indirect light
    only adds, so the path image's mean exceeds the direct image's."""
    _, carried = cornell
    ig = path.PathIntegrator(max_depth=3)
    p_img = _port_image(carried, lambda s, r, d, c: path.li(ig, s, r, d, c))
    d_img = _port_image(carried, _integrators("direct_all")[1])
    assert p_img.mean() > d_img.mean() > 0


def test_environment_light_still_raises(lit):
    """What raised before the remaining lights were ported: estimate_direct
    with an infinite light in the table equals the reference's, toward the
    infinite light (its map sampled; an escaped BSDF ray gathers Le,
    MIS-weighted by env_pdf) and toward the area light beside it."""
    rng = np.random.RandomState(12)
    env = (rng.rand(8, 16, 3).astype(np.float32) ** 2) * 2.0
    env[2, 5] = 25.0
    w2l = np.asarray(ref_tr.rotate_y(35.0).m, np.float64)
    rb = ref_sb.cornell_box()
    rb.add_light(ref_lt.infinite_light(env, w2l=w2l, L_scale=(1.0, 0.9, 0.8)))
    host = rb.build()
    assert host.lights.env_light_index == 0
    rscene = ref_st.to_device(host)
    scene = st.to_device(adapt.from_reference(th.np_tree(host)), "cpu")
    m = lit["hit"]
    for light in (0, 1):
        li = np.full(lit["n"], light, np.int32)
        want = ref_common.estimate_direct(
            rscene, lit["rit"], lit["rframe"], lit["rparams"],
            lit["rit"]["wo"], jnp.asarray(li), *_ed_args(lit, "ref"))
        got = common.estimate_direct(
            scene, lit["it"], lit["frame"], lit["params"], lit["it"]["wo"],
            torch.from_numpy(li), *_ed_args(lit, "port"))
        close = np.isclose(th.n3(got)[m], th.n3(want)[m], rtol=RTOL,
                           atol=ATOL).all(-1)
        assert close.mean() >= 0.99, (light, close.mean())
        assert th.n3(got)[m].sum() > 0


@pytest.mark.parametrize("scene", ["alpha.pbrt", "lights.pbrt"])
def test_alpha_and_env_scenes_run_on_the_card_by_default(scene):
    """No CUDA device here: an alpha scene and an environment-lit scene
    asked for with the default device raise; nothing falls back."""
    import os
    from dartray_tpu_torch.renderers import manager
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", scene)
    with pytest.raises(RuntimeError, match="cuda"):
        manager.render_pbrt(path, overrides={"quick_render": True},
                            log=lambda *a, **k: None)


@pytest.mark.parametrize("entry", ["direct", "whitted", "ao"])
def test_new_integrators_run_on_the_card_by_default(entry):
    """No CUDA device here: rendering with the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    li = {"direct": lambda s, r, d, c: direct.li(
              direct.DirectLightingIntegrator(), s, r, d, c),
          "whitted": lambda s, r, d, c: whitted.li(
              whitted.WhittedIntegrator(), s, r, d, c),
          "ao": lambda s, r, d, c: ao.li(ao.AOIntegrator(4), s, r, d, c)}
    cam = cameras.perspective(tr.look_at(EYE, LOOK, UP), FOV, 4, 4,
                              device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        rend.render(sb.cornell_box().build(), cam,
                    samplers.make_sampler("lowdiscrepancy", spp=1),
                    li[entry], 4, 4)
