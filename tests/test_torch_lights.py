"""PyTorch port, the remaining lights: the infinite (environment), projection
and goniometric lights, ``sample_le`` for every kind, and the escaped-ray
terms, against the JAX reference on the same seeded inputs.

The tables are host numpy on both sides and are held bit for bit. Device
functions run un-jitted on the reference side, its ``fori_loop``s (the
environment map's conditional search, the area light's triangle search) as
Python loops (``torchhelp.eager_reference``). Units: rtol 1e-5 / atol 1e-6
on at least 99.5 % of lanes (the same f32 operations; the two libraries'
sin / cos / atan2 / acos may differ by an ulp, which can move a lane across
a texel edge). Whole renders of ``scenes/lights.pbrt``: against
``tools/lights_golden.npz``, the reference's render (made by
``tools/make_lights_golden.py``), at least 99 % of pixels within rtol 1e-3 /
atol 1e-4 and the mean within 1e-3 relative.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu import lights as ref_lt
from dartray_tpu.core import spectrum as ref_spec
from dartray_tpu.core import transform as ref_tr
from dartray_tpu.scene import build as ref_sb
from dartray_tpu.scene import types as ref_st

from dartray_tpu_torch import lights as lt_mod
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene import types as st

import torchhelp as th

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_lights_golden as golden  # noqa: E402

torch.set_num_threads(1)

N = 512
RTOL, ATOL = 1e-5, 1e-6
QUIET = lambda *a, **k: None   # noqa: E731
ATTR = np.zeros((1, 48), np.float32)


@pytest.fixture(scope="module", autouse=True)
def eager(request):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    th.eager_reference(mp)


def _maps():
    rng = np.random.RandomState(5)
    env = (rng.rand(16, 32, 3).astype(np.float32) ** 2) * 3.0
    env[4, 10] = 40.0                   # a bright texel (sun)
    proj = rng.rand(6, 9, 3).astype(np.float32)
    gonio = rng.rand(8, 12, 3).astype(np.float32)
    return env, proj, gonio


def _lights(mod, trm):
    """One light of every kind beside the box's area light (index 7):
    0 point, 1 spot, 2 distant, 3 infinite, 4 goniometric, 5 projection,
    6 a second projection light whose map is the table's (last wins)."""
    env, proj, gonio = _maps()
    w2l = lambda eye, at: np.asarray(trm.look_at(eye, at, [0, 1, 0]).m_inv,
                                     np.float64)
    return [
        mod.point_light((0.3, 1.6, -0.2), (2.0, 1.5, 1.0)),
        mod.spot_light((-0.5, 1.8, -0.5), w2l([-0.5, 1.8, -0.5],
                                              [0.2, 0, 0.3]),
                       (6.0, 6.0, 8.0), 40.0, 15.0),
        mod.distant_light((0.2, 1.0, -0.6), (0.5, 0.6, 0.7)),
        mod.infinite_light(env, w2l=np.asarray(trm.rotate(35.0, [0, 1, 0]).m,
                                               np.float64),
                           L_scale=(1.0, 0.9, 0.8)),
        mod.goniometric_light((0.4, 1.7, 0.1), w2l([0.4, 1.7, 0.1],
                                                   [0.0, 0.0, 0.0]),
                              (3.0, 3.0, 3.0), gonio_map=gonio),
        mod.projection_light((0.0, 1.9, -0.3), w2l([0.0, 1.9, -0.3],
                                                    [0.1, 0.0, 0.2]),
                             (8.0, 7.0, 6.0), fov=50.0, proj_map=gonio),
        mod.projection_light((-0.2, 1.8, 0.4), w2l([-0.2, 1.8, 0.4],
                                                    [0.0, 0.0, 0.0]),
                             (5.0, 5.0, 5.0), fov=35.0, proj_map=proj),
    ]


@pytest.fixture(scope="module")
def box():
    """The Cornell box lit by every kind, in both packages (the port's
    table carried from the reference's scene, then the port's own build)."""
    rb = ref_sb.cornell_box()
    for s in _lights(ref_lt, ref_tr):
        rb.add_light(s)
    host = rb.build()
    rscene = ref_st.to_device(host)
    scene = st.to_device(adapt.from_reference(th.np_tree(host)), "cpu")
    rng = np.random.RandomState(9)
    p = (rng.rand(N, 3) * [1.8, 1.8, 1.8] + [-0.9, 0.05, -0.9]).astype(
        np.float32)
    d = rng.randn(N, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u = {k: rng.rand(N, 2).astype(np.float32) for k in ("a", "b")}
    uc = rng.rand(N).astype(np.float32)
    return dict(host=host, rlt=rscene.lights, lt=scene.lights,
                geom=scene.geometry, rgeom=rscene.geometry, p=p, d=d, u=u,
                uc=uc)


def _close(got, want, what="", share=0.995):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    ok = np.isclose(got, want, rtol=RTOL, atol=ATOL)
    ok = ok.reshape(ok.shape[0], -1).all(-1) if ok.ndim > 1 else ok
    assert ok.mean() >= share, (what, ok.mean(),
                                np.abs(got - want).max())


# --- the table -----------------------------------------------------------

TABLES = {
    "infinite": lambda m, t: [_lights(m, t)[3]],
    "goniometric": lambda m, t: [_lights(m, t)[4]],
    "projection": lambda m, t: [_lights(m, t)[5]],
    "every_kind": lambda m, t: _lights(m, t),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_build_table_is_the_references(name):
    """Leaf by leaf, bit for bit: the env map's Distribution2D (its cond_* /
    marg_* leaves), env_w / env_h, proj_map, the powers' CDF."""
    from dartray_tpu_torch.core import transform as tr
    port = lt_mod.build_table(TABLES[name](lt_mod, tr), scene_radius=7.5,
                              attr=ATTR)
    ref = th.np_tree(ref_lt.build_table(TABLES[name](ref_lt, ref_tr),
                                        scene_radius=7.5, attr=ATTR))
    n = 0
    for path, leaf in th.port_leaves(port).items():
        want = th.ref_leaf(ref, path)
        if isinstance(leaf, np.ndarray):
            assert th.same_bits(leaf, want), path
        else:
            assert leaf == want, path
        n += 1
    assert n == 26
    assert (port.env_light_index >= 0) == (name in ("infinite",
                                                    "every_kind"))


def test_one_map_serves_every_projection_light(box):
    """Known behaviour n: the table keeps one proj_map, the last projection
    or goniometric light's; the first projection light (and the goniometric
    one) read it too."""
    env, proj, gonio = _maps()
    assert th.same_bits(box["lt"].proj_map.numpy(), proj)
    assert th.same_bits(np.asarray(box["rlt"].proj_map), proj)
    for idx in (4, 5):
        li = np.full(N, idx, np.int32)
        got = lt_mod.sample_li(box["lt"], None, torch.from_numpy(li),
                               th.t3(box["p"]), torch.from_numpy(box["u"]["a"]))
        want = ref_lt.sample_li(box["rlt"], None, jnp.asarray(li),
                                th.j3(box["p"]), jnp.asarray(box["u"]["a"]))
        _close(th.n3(got.li), th.n3(want.li), f"light {idx}")
        assert th.n3(got.li).max() > 0


# --- the environment map ---------------------------------------------------

def test_env_lookup_sample_le_pdf_are_the_references(box):
    lt, rlt = box["lt"], box["rlt"]
    uv = box["u"]["a"]
    _close(th.n3(lt_mod._env_lookup(lt, torch.from_numpy(uv[:, 0]),
                                    torch.from_numpy(uv[:, 1]))),
           th.n3(ref_lt._env_lookup(rlt, jnp.asarray(uv[:, 0]),
                                    jnp.asarray(uv[:, 1]))), "lookup")
    d, L, pdf = lt_mod._env_sample(lt, torch.from_numpy(box["u"]["b"]))
    rd, rL, rpdf = ref_lt._env_sample(rlt, jnp.asarray(box["u"]["b"]))
    _close(th.n3(d), th.n3(rd), "sample dir")
    _close(th.n3(L), th.n3(rL), "sample L")
    _close(pdf, rpdf, "sample pdf")
    _close(th.n3(lt_mod.env_le(lt, th.t3(box["d"]))),
           th.n3(ref_lt.env_le(rlt, th.j3(box["d"]))), "env_le")
    _close(lt_mod.env_pdf(lt, th.t3(box["d"])),
           ref_lt.env_pdf(rlt, th.j3(box["d"])), "env_pdf")


def _env_table(img):
    return st.to_device(lt_mod.build_table([lt_mod.infinite_light(img)],
                                           scene_radius=10.0, attr=ATTR),
                        "cpu")


def _envmap_fixture():
    """The map of the reference's tests/test_envmap.py."""
    rng = np.random.RandomState(0)
    img = (rng.rand(16, 32, 3).astype(np.float32) ** 2) * 3.0
    img[4, 32 // 3] = 40.0
    return _env_table(img), img


def _unit_dirs(n, seed):
    d = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_env_pdf_integrates_to_one():
    """MC over uniform sphere directions: E[pdf] * 4 pi == 1."""
    lt, _ = _envmap_fixture()
    pdf = lt_mod.env_pdf(lt, th.t3(_unit_dirs(200_000, 1))).numpy()
    est = pdf.mean() * 4.0 * np.pi
    assert abs(est - 1.0) < 0.03, est


def test_env_sample_pdf_consistency():
    """The sampler's pdf equals env_pdf at the sampled direction (up to the
    texel grid's quantisation)."""
    lt, _ = _envmap_fixture()
    u = np.random.RandomState(2).rand(4096, 2).astype(np.float32)
    dir_l, _, pdf_s = lt_mod._env_sample(lt, torch.from_numpy(u))
    pdf_e = lt_mod.env_pdf(lt, dir_l).numpy()
    pdf_s = pdf_s.numpy()
    ok = pdf_s > 1e-6
    ratio = pdf_e[ok] / pdf_s[ok]
    assert np.median(np.abs(ratio - 1.0)) < 1e-3
    assert (np.abs(ratio - 1.0) < 1e-2).mean() > 0.97


def test_env_sample_histogram_matches_luminance():
    """Per-texel sample frequency tracks luminance x sin(theta)."""
    lt, img = _envmap_fixture()
    h, w = img.shape[:2]
    u = np.random.RandomState(3).rand(400_000, 2).astype(np.float32)
    dir_l, _, _ = lt_mod._env_sample(lt, torch.from_numpy(u))
    d = th.n3(dir_l)
    theta = np.arccos(np.clip(d[:, 2], -1, 1))
    phi = np.arctan2(d[:, 1], d[:, 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    iu = np.clip((phi / (2 * np.pi) * w).astype(int), 0, w - 1)
    iv = np.clip((theta / np.pi * h).astype(int), 0, h - 1)
    counts = np.zeros((h, w))
    np.add.at(counts, (iv, iu), 1.0)
    lum = img @ np.asarray(ref_spec.RGB_TO_XYZ)[1]
    sin_t = np.sin(np.pi * (np.arange(h) + 0.5) / h)
    target = lum * sin_t[:, None] + 1e-9
    target /= target.sum()
    got = counts / counts.sum()
    assert np.abs(got - target).sum() < 0.05
    bright = np.unravel_index(np.argmax(target), target.shape)
    assert got[bright] / target[bright] == pytest.approx(1.0, rel=0.1)


def test_env_bilinear_lookup_interpolates():
    """Le varies smoothly between texel centres (bilinear, not nearest)."""
    img = np.zeros((8, 16, 3), np.float32)
    img[:, :8] = 1.0                    # a step in phi
    lt = _env_table(img)
    phis = np.linspace(np.pi - 0.5, np.pi + 0.5, 9)
    d = np.stack([np.cos(phis), np.sin(phis), np.zeros_like(phis)], -1)
    le = th.n3(lt_mod.env_le(lt, th.t3(d)))[:, 0]
    assert le[0] > 0.95 and le[-1] < 0.05
    assert ((le > 0.1) & (le < 0.9)).any(), le


# --- sample_li and sample_le of every kind -----------------------------------

KIND_NAMES = ["point", "spot", "distant", "infinite", "goniometric",
              "projection", "projection_last", "area"]


@pytest.mark.parametrize("idx", range(len(KIND_NAMES)),
                         ids=KIND_NAMES)
def test_sample_li_and_sample_le_are_the_references(box, idx):
    """Every lane toward light `idx`: sample_li's wi, li, pdf, dist and
    is_delta, and sample_le's o, d and alpha."""
    li = np.full(N, idx, np.int32)
    lt, rlt = box["lt"], box["rlt"]
    got = lt_mod.sample_li(lt, box["geom"], torch.from_numpy(li),
                           th.t3(box["p"]), torch.from_numpy(box["u"]["a"]),
                           torch.from_numpy(box["uc"]))
    want = ref_lt.sample_li(rlt, box["rgeom"], jnp.asarray(li),
                            th.j3(box["p"]), jnp.asarray(box["u"]["a"]),
                            jnp.asarray(box["uc"]))
    for f in ("wi", "li"):
        _close(th.n3(getattr(got, f)), th.n3(getattr(want, f)), f)
    _close(got.pdf, want.pdf, "pdf")
    _close(got.dist, want.dist, "dist")
    assert (got.is_delta.numpy() == np.asarray(want.is_delta)).all()
    assert got.is_delta.numpy().all() == (KIND_NAMES[idx] not in
                                          ("infinite", "area"))
    pdf = np.random.RandomState(idx).rand(N).astype(np.float32) + 0.1
    got = lt_mod.sample_le(lt, box["geom"], torch.from_numpy(li),
                           torch.from_numpy(pdf),
                           torch.from_numpy(box["u"]["a"]),
                           torch.from_numpy(box["uc"]),
                           torch.from_numpy(box["u"]["b"]))
    want = ref_lt.sample_le(rlt, box["rgeom"], jnp.asarray(li),
                            jnp.asarray(pdf), jnp.asarray(box["u"]["a"]),
                            jnp.asarray(box["uc"]),
                            jnp.asarray(box["u"]["b"]))
    for f in ("o", "d", "alpha"):
        _close(th.n3(getattr(got, f)), th.n3(getattr(want, f)), f"le {f}")
    assert np.isfinite(th.n3(got.alpha)).all()


def test_mixed_light_indices_are_the_references(box):
    """One wave whose lanes pick lights of every kind by the power CDF."""
    u = torch.from_numpy(box["uc"])
    idx, pdf = lt_mod.sample_light_index(box["lt"], u)
    ridx, rpdf = ref_lt.sample_light_index(box["rlt"], jnp.asarray(box["uc"]))
    assert (idx.numpy() == np.asarray(ridx)).all()
    assert len(set(idx.tolist())) == 8
    got = lt_mod.sample_li(box["lt"], box["geom"], idx, th.t3(box["p"]),
                           torch.from_numpy(box["u"]["a"]), u)
    want = ref_lt.sample_li(box["rlt"], box["rgeom"], ridx, th.j3(box["p"]),
                            jnp.asarray(box["u"]["a"]),
                            jnp.asarray(box["uc"]))
    _close(th.n3(got.li), th.n3(want.li), "li")
    _close(got.pdf, want.pdf, "pdf")
    le = lt_mod.sample_le(box["lt"], box["geom"], idx, pdf,
                          torch.from_numpy(box["u"]["a"]), u,
                          torch.from_numpy(box["u"]["b"]))
    rle = ref_lt.sample_le(box["rlt"], box["rgeom"], ridx, rpdf,
                           jnp.asarray(box["u"]["a"]),
                           jnp.asarray(box["uc"]),
                           jnp.asarray(box["u"]["b"]))
    _close(th.n3(le.alpha), th.n3(rle.alpha), "le alpha")


def test_port_builds_the_references_light_table(box):
    """The port's own scene compiler for the box with every kind."""
    from dartray_tpu_torch.core import transform as tr
    from dartray_tpu_torch.scene import build as sb
    b = sb.cornell_box()
    for s in _lights(lt_mod, tr):
        b.add_light(s)
    own = b.build()
    ref = th.np_tree(box["host"])["lights"]
    for path, leaf in th.port_leaves(own.lights).items():
        want = th.ref_leaf(ref, path)
        assert (th.same_bits(leaf, want) if isinstance(leaf, np.ndarray)
                else leaf == want), path


# --- whole renders -----------------------------------------------------------

def _check_image(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(img - ref).max())
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()


@pytest.mark.parametrize("name", ["lights", "lights_direct",
                                  "lights_whitted"])
def test_render_pbrt_matches_the_references_golden_image(name):
    """scenes/lights.pbrt through render_pbrt on the CPU, by the path, the
    direct-lighting and the Whitted integrators."""
    img = manager.render_pbrt(golden.variant_text(name),
                              search_paths=[golden.SCENES], log=QUIET,
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
