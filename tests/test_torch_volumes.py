"""PyTorch port, participating media: the volume table, its properties, the
emission and single-scattering integrators, their composition in the render
manager and ``nee_one_light``, against the JAX reference on the same seeded
inputs.

The table is host numpy on both sides and is held bit for bit (its three
region kinds). Device functions run un-jitted on the reference side, its
``fori_loop``s as Python loops (``torchhelp.eager_reference``) and its
traversal as its own CPU walk over the cluster BVH, compiled once
(``torchhelp.reference_cluster_walk``; its kernel in interpret mode takes
ten seconds to compile). Units: rtol 1e-5 /
atol 1e-6 on at least 99.5 % of lanes (the same f32 operations; an any-hit
decision at an edge or an ulp of exp may differ). The units march 8
(emission) and 3 (single scattering) steps; the whole renders run the
integrators' 32. Whole renders of scenes/smoke.pbrt and
scenes/volumes.pbrt are held against ``tools/volume_golden.npz``
(``tools/make_volume_golden.py``): at least 99 % of pixels within rtol 1e-3 /
atol 1e-4, the mean within 1e-3 relative, and the traversal launches a wave
exact.
"""
import collections
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu import bsdf as ref_bx
from dartray_tpu import materials as ref_mat
from dartray_tpu import samplers as ref_samplers
from dartray_tpu import volumes as ref_vol
from dartray_tpu.accel import traverse as ref_tv
from dartray_tpu.core import math as ref_vm
from dartray_tpu.core import sampling as ref_smp
from dartray_tpu.integrators import common as ref_common
from dartray_tpu.integrators import volume as ref_vi
from dartray_tpu.scene import parser as ref_parser
from dartray_tpu.scene import types as ref_st

from dartray_tpu_torch import bsdf as bx
from dartray_tpu_torch import materials as mat_mod
from dartray_tpu_torch import samplers
from dartray_tpu_torch import volumes as vol
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.core import sampling as smp
from dartray_tpu_torch.integrators import common
from dartray_tpu_torch.integrators import volume as vi
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.renderers import sampler as rend
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import types as st

import torchhelp as th

sys.path.insert(0, os.path.join(th.ROOT, "tools"))
import make_volume_golden as golden  # noqa: E402

torch.set_num_threads(1)

N = 512
RTOL, ATOL = 1e-5, 1e-6
QUIET = lambda *a, **k: None   # noqa: E731
HEAD = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "lowdiscrepancy" "integer pixelsamples" [2]
SurfaceIntegrator "directlighting"
VolumeIntegrator "single"
LookAt 0 1 -4  0 0.8 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "point" "point from" [1 3 -1] "rgb I" [10 10 10]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 4 4]
  Translate 0 2.5 0
  Shape "trianglemesh" "integer indices" [0 2 1 0 3 2]
    "point P" [-0.5 0 -0.5  0.5 0 -0.5  0.5 0 0.5  -0.5 0 0.5]
AttributeEnd
"""
VOLUMES = {
    "homogeneous": """
Volume "homogeneous" "point p0" [-1.5 0 -1] "point p1" [-0.1 1.3 0.6]
  "rgb sigma_a" [0.3 0.5 0.8] "rgb sigma_s" [0.6 0.6 0.6]
  "rgb Le" [0.3 0.1 0.05] "float g" [0.4]
""",
    "exponential": """
AttributeBegin
  Translate 0.8 0 0.1
  Rotate -90 1 0 0
  Volume "exponential" "point p0" [-0.7 -0.7 0] "point p1" [0.7 0.7 2]
    "float a" [1.5] "float b" [1.8] "rgb sigma_a" [0.5 0.5 0.5]
    "rgb sigma_s" [1 0.8 0.6] "rgb Le" [0.05 0.2 0.1] "float g" [-0.3]
AttributeEnd
""",
    "volumegrid": """
AttributeBegin
  Translate -0.2 0.1 0.3
  Scale 1.2 1 0.9
  Volume "volumegrid" "point p0" [-0.6 0 -0.6] "point p1" [0.6 1.5 0.6]
    "integer nx" [3] "integer ny" [2] "integer nz" [4]
    "rgb sigma_a" [0.2 0.2 0.2] "rgb sigma_s" [0.9 0.9 0.9]
    "float density" [0.2 0.5 0.1  0.9 1.4 0.3  0.4 2.0 0.6  1.1 0.2 0.8
                     0.3 0.7 1.5  0.6 0.1 1.9  0.8 1.2 0.4  0.0 0.5 1.0]
AttributeEnd
""",
}
TAIL = """
Material "matte" "rgb Kd" [0.6 0.6 0.55]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
AttributeBegin
  Material "plastic" "rgb Kd" [0.2 0.3 0.6] "rgb Ks" [0.3 0.3 0.3]
  Translate 0.1 0.5 0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
WorldEnd
"""
SCENE = HEAD + "".join(VOLUMES.values()) + TAIL


@pytest.fixture(scope="module", autouse=True)
def eager(request):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    th.eager_reference(mp)
    th.reference_cluster_walk(mp)


@pytest.fixture(scope="module")
def media():
    """The scene in both packages (the port's carried from the reference's
    host scene), seeded points, directions, rays and sample contexts."""
    ref = ref_parser.parse(SCENE, log=QUIET)
    rscene = ref_st.to_device(ref.scene)
    scene = st.to_device(adapt.from_reference(th.np_tree(ref.scene)), "cpu")
    rng = np.random.RandomState(11)
    p = (rng.rand(N, 3) * [3.4, 2.2, 2.4] + [-1.7, -0.1, -1.1]).astype(
        np.float32)
    dirs = []
    for _ in range(2):
        d = rng.randn(N, 3).astype(np.float32)
        dirs.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    eye = np.float32([0.0, 1.0, -4.0])
    tgt = (rng.rand(N, 3) * [3.0, 1.6, 1.0] + [-1.5, 0.0, -0.5]).astype(
        np.float32)
    d = tgt - eye
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(eye, (N, 1))
    seg = (rng.rand(N) * 6 + 2).astype(np.float32)
    px = (np.arange(N) % 16).astype(np.int32)
    py = (np.arange(N) // 16).astype(np.int32)
    rs = ref_samplers.make_sampler("lowdiscrepancy", spp=4)
    ps = samplers.make_sampler("lowdiscrepancy", spp=4)
    return dict(
        ref=ref, rscene=rscene, scene=scene, p=p, wo=dirs[0], wi=dirs[1],
        o=o, d=d, seg=seg, off=rng.rand(N).astype(np.float32),
        rrays=ref_vm.make_rays(jnp.asarray(o), jnp.asarray(d)),
        rays=vm.make_rays(th.t3(o), th.t3(d)),
        rsctx={"sampler": rs, "px": jnp.asarray(px), "py": jnp.asarray(py),
               "s_idx": jnp.full((N,), 1, jnp.int32)},
        sctx={"sampler": ps, "px": torch.from_numpy(px),
              "py": torch.from_numpy(py),
              "s_idx": torch.full((N,), 1, dtype=torch.int32)})


def _close(got, want, what="", share=0.995):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    ok = np.isclose(got, want, rtol=RTOL, atol=ATOL)
    ok = ok.reshape(ok.shape[0], -1).all(-1) if ok.ndim > 1 else ok
    assert ok.mean() >= share, (what, ok.mean(),
                                np.abs(got - want).max())


def _v(x):
    """V3 of either package (or an array) -> numpy."""
    return th.n3(x) if hasattr(x, "x") else np.asarray(x)


@pytest.mark.parametrize("kind", ["homogeneous", "exponential",
                                  "volumegrid"])
def test_build_volume_is_the_references(kind):
    """Each kind alone, and the three together, parsed by each package:
    the volume table leaf for leaf."""
    for text in (HEAD + VOLUMES[kind] + TAIL, SCENE):
        port = parser.parse(text, log=QUIET, device="cpu")
        ref = ref_parser.parse(text, log=QUIET)
        want = th.np_tree(ref.scene.volume)
        for path, leaf in th.port_leaves(port.scene.volume).items():
            w = th.ref_leaf(want, path)
            assert (th.same_bits(leaf, w) if isinstance(leaf, np.ndarray)
                    else leaf == w), path
    assert port.scene.volume.n == 3


def test_properties_match_the_reference(media):
    """sigma_t, sigma_s, Lve and the phase function at seeded points."""
    rv, pv = media["rscene"].volume, media["scene"].volume
    rp, pp = th.j3(media["p"]), th.t3(media["p"])
    for name in ("sigma_t", "sigma_s", "lve"):
        _close(_v(getattr(vol, name)(pv, pp)),
               _v(getattr(ref_vol, name)(rv, rp)), name)
    got = vol.phase(pv, pp, th.t3(media["wo"]), th.t3(media["wi"]))
    want = ref_vol.phase(rv, rp, th.j3(media["wo"]), th.j3(media["wi"]))
    _close(got, want, "phase")
    assert (_v(vol.sigma_t(pv, pp)) > 0).any(-1).mean() > 0.3


def test_bounds_tau_and_transmittance_match_the_reference(media):
    rv, pv = media["rscene"].volume, media["scene"].volume
    seg = torch.from_numpy(media["seg"])
    rays = media["rays"]._replace(tmax=seg)
    rrays = media["rrays"]._replace(tmax=jnp.asarray(media["seg"]))
    got = vol.intersect_bounds(pv, rays)
    want = ref_vol.intersect_bounds(rv, rrays)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0.2 < got[2].float().mean() < 1.0
    for a, b in zip(got[:2], want[:2]):
        _close(a, b, "bounds")
    off = media["off"]
    _close(_v(vol.tau(pv, rays, 0.5, torch.from_numpy(off), n_steps=8)),
           _v(ref_vol.tau(rv, rrays, 0.5, jnp.asarray(off), n_steps=8)),
           "tau")
    _close(_v(vi.transmittance(pv, rays, torch.from_numpy(off), 8)),
           _v(ref_vi.transmittance(rv, rrays, jnp.asarray(off), 8)),
           "transmittance")


def test_hg_sampling_matches_the_reference(media):
    rng = np.random.RandomState(2)
    u = rng.rand(N, 2).astype(np.float32)
    cos = rng.uniform(-1, 1, N).astype(np.float32)
    for g in (0.0, 0.6, -0.45):
        got = smp.sample_hg(th.t3(media["wo"]), torch.from_numpy(u), g)
        want = ref_smp.sample_hg(th.j3(media["wo"]), jnp.asarray(u), g)
        _close(_v(got), _v(want), f"sample_hg {g}")
        _close(smp.hg_pdf(torch.from_numpy(cos), np.float32(g)),
               ref_smp.hg_pdf(jnp.asarray(cos), jnp.float32(g)), "hg_pdf")


def test_emission_li_matches_the_reference(media):
    seg = torch.from_numpy(media["seg"])
    lv, tr = vi.emission_li(vi.EmissionIntegrator(n_steps=8),
                            media["scene"], media["rays"], seg, media["sctx"])
    rlv, rtr = ref_vi.emission_li(ref_vi.EmissionIntegrator(n_steps=8),
                                  media["rscene"], media["rrays"],
                                  jnp.asarray(media["seg"]), media["rsctx"])
    _close(_v(lv), _v(rlv), "Lv")
    _close(_v(tr), _v(rtr), "T")
    assert _v(lv).sum() > 0 and (_v(tr) < 1).any()


def test_single_scatter_li_matches_the_reference(media):
    """Three steps (one any-hit traversal each) on both sides."""
    seg = torch.from_numpy(media["seg"])
    lv, tr = vi.single_scatter_li(vi.SingleScatteringIntegrator(n_steps=3),
                                  media["scene"], media["rays"], seg,
                                  media["sctx"])
    rlv, rtr = ref_vi.single_scatter_li(
        ref_vi.SingleScatteringIntegrator(n_steps=3), media["rscene"],
        media["rrays"], jnp.asarray(media["seg"]), media["rsctx"])
    _close(_v(lv), _v(rlv), "Lv")
    _close(_v(tr), _v(rtr), "T")
    assert _v(lv).sum() > 0


def test_nee_one_light_matches_the_reference(media):
    """The traced light-sampling half of estimate_direct at the camera
    rays' hits (the port's, handed to both), on every hit lane."""
    rscene, scene = media["rscene"], media["scene"]
    h = st.intersect(scene.geometry, media["rays"])
    rh = ref_tv.Hits(*(jnp.asarray(a.numpy()) for a in h[:4]))
    rit = ref_st.interaction(rscene.geometry, media["rrays"], rh)
    it = st.interaction(scene.geometry, media["rays"], h)
    rframe = ref_bx.make_frame(rit["ns"], rit["dpdu"], rit["ng"])
    frame = bx.make_frame(it["ns"], it["dpdu"], it["ng"])
    rparams = ref_mat.eval_params(rscene.materials, rit["mat_id"], None, rit)
    params = mat_mod.eval_params(scene.materials, it["mat_id"], None, it)
    rng = np.random.RandomState(4)
    us, uc = rng.rand(N).astype(np.float32), rng.rand(N).astype(np.float32)
    u2 = rng.rand(N, 2).astype(np.float32)
    hit = h.prim.numpy() >= 0
    want = ref_common.nee_one_light(
        rscene, rit, rframe, rparams, rit["wo"], jnp.asarray(us),
        jnp.asarray(u2), jnp.asarray(uc), jnp.asarray(hit))
    got = common.nee_one_light(
        scene, it, frame, params, it["wo"], torch.from_numpy(us),
        torch.from_numpy(u2), torch.from_numpy(uc), torch.from_numpy(hit))
    _close(_v(got)[hit], _v(want)[hit], "nee")
    assert _v(got)[hit].sum() > 0


# --- known behaviours of the reference, kept ---------------------------------

def test_stepsize_is_read_and_not_used(media):
    """Known behaviour t: the step is the overlap over n_steps whatever
    step_size or tau's step says; a shadow transmittance is 8 steps."""
    seg = torch.from_numpy(media["seg"])
    a = vi.emission_li(vi.EmissionIntegrator(step_size=0.01),
                       media["scene"], media["rays"], seg, media["sctx"])
    b = vi.emission_li(vi.EmissionIntegrator(step_size=5.0),
                       media["scene"], media["rays"], seg, media["sctx"])
    assert all(torch.equal(x, y) for u, v in zip(a, b) for x, y in zip(u, v))
    off = torch.from_numpy(media["off"])
    pv = media["scene"].volume
    assert all(torch.equal(x, y) for x, y in zip(
        vol.tau(pv, media["rays"], 0.01, off), vol.tau(pv, media["rays"],
                                                        9.0, off)))
    job = parser.parse(golden.variant_text("smoke"), log=QUIET, device="cpu")
    assert job.vol_params.find_one_float("stepsize", 1.0) == 0.25


def test_single_scatter_shadow_rays_and_steps(media, monkeypatch):
    """Known behaviours t and v: one shadow ray a step, from the sample
    point itself with tmin 1e-4, and its transmittance an 8-step march."""
    seen, steps = [], []
    real_p, real_tau = st.intersect_p, vol.tau
    monkeypatch.setattr(st, "intersect_p", lambda g, r, **k: (
        seen.append(r), real_p(g, r, **k))[1])
    monkeypatch.setattr(vol, "tau", lambda v, r, s, o, n_steps=64: (
        steps.append(n_steps), real_tau(v, r, s, o, n_steps))[1])
    seg = torch.from_numpy(media["seg"])
    vi.single_scatter_li(vi.SingleScatteringIntegrator(n_steps=3),
                         media["scene"], media["rays"], seg, media["sctx"])
    assert len(seen) == 3 and steps == [8, 8, 8]
    t0, t1, _ = vol.intersect_bounds(media["scene"].volume,
                                     media["rays"]._replace(tmax=seg))
    for r in seen:
        assert (r.tmin == 1e-4).all()
    u0 = samplers.sample_1d(media["sctx"]["sampler"], media["sctx"]["px"],
                            media["sctx"]["py"], media["sctx"]["s_idx"], 210)
    dt = ((t1 - t0) / 3).clamp_min(1e-8)
    p = media["rays"].at(t0 + u0 * dt)
    assert all(torch.equal(a, b) for a, b in zip(seen[0].o, p))


def test_exponential_up_axis_and_last_grid_wins():
    """Known behaviour u: the exponential density varies along
    volume-space z alone (no updir); of two volumegrid regions, both read
    the last one's densities."""
    text = SCENE.replace('Volume "homogeneous"', 'Volume "volumegrid" '
                         '"integer nx" [1] "integer ny" [1] "integer nz" [2] '
                         '"float density" [7 9]')
    job = parser.parse(text.replace('"float a" [1.5]', '"float a" [1.5] '
                                    '"vector updir" [1 0 0]'), log=QUIET,
                       device="cpu")
    v = st.to_device(job.scene.volume, "cpu")
    assert v.kind.tolist() == [2, 1, 2] and v.grid.shape == (4, 2, 3)
    # the exponential region's local frame: z is world +y
    xs = torch.linspace(0.45, 1.15, 5)
    for y in (0.2, 0.9):
        pts = vm.V3(xs, torch.full_like(xs, y), torch.full_like(xs, 0.1))
        d = vol._density(v, 1, vol._to_local(v, 1, pts))
        assert torch.allclose(d, torch.full_like(d, 1.5 * np.exp(-1.8 * y)),
                              rtol=1e-5)


def test_only_the_camera_segment_is_attenuated(media):
    """Known behaviour v: build_li is T * Ls + Lv with Ls the surface
    integrator's own radiance, unattenuated inside the medium, and the
    segment ends at the camera ray's first hit (1e7 where it misses)."""
    job = parser.parse(SCENE.replace('VolumeIntegrator "single"', ''),
                       log=QUIET, device="cpu")
    assert job.vol_integrator == "emission"
    li = manager.build_li(job, log=QUIET, device="cpu")
    surf = manager.build_surface_li(job, log=QUIET, device="cpu")
    scene, rays, sctx = media["scene"], media["rays"], media["sctx"]
    ls = surf(scene, rays, None, sctx)
    h = st.intersect(scene.geometry, rays)
    assert h.hit.any() and not h.hit.all()
    lv, tr = vi.emission_li(vi.EmissionIntegrator(), scene, rays,
                            torch.where(h.hit, h.t, 1e7), sctx)
    got = li(scene, rays, None, sctx)
    want = tr * ls + lv
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (th.n3(tr) < 1).any() and (th.n3(ls) > 0).any()


# --- whole renders -----------------------------------------------------------

def _check_image(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(img - ref).max())
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()


def _count(monkeypatch):
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


@pytest.mark.parametrize("name", ["smoke", "volumes", "volumes_single"])
def test_render_pbrt_matches_the_references_golden_image(name, monkeypatch):
    """The files through render_pbrt on the CPU; a wave's launches are the
    surface integrator's (one wave of it alone, counted) plus one
    closest-hit launch, plus 32 any-hit launches under single scattering."""
    text = golden.variant_text(name)
    counts = _count(monkeypatch)
    img = manager.render_pbrt(text, search_paths=[golden.SCENES], log=QUIET,
                              device="cpu")
    whole = collections.Counter(counts)
    _check_image(img, np.load(golden.GOLDEN)[name])
    job = parser.parse(text, log=QUIET, device="cpu")
    counts.clear()
    px, py = rend.pixel_grid(job.width, job.height, device="cpu")
    film = rend.film_mod.make_film(job.width, job.height, device="cpu")
    rend.render_wave(st.to_device(job.scene, "cpu"), job.camera,
                     job.sampler, film, px, py, torch.zeros_like(px),
                     li_fn=manager.build_surface_li(job, log=QUIET,
                                                    device="cpu"),
                     width=job.width, height=job.height, spp=job.sampler.spp,
                     device="cpu")
    extra = {"closest": 1, "any": 32} if job.vol_integrator == "single" \
        else {"closest": 1}
    want = collections.Counter({k: v * job.sampler.spp
                                for k, v in counts.items()})
    want.update({k: v * job.sampler.spp for k, v in extra.items()})
    assert whole == want, (whole, counts)


def test_volume_render_runs_on_the_card_by_default():
    """No CUDA device here: a volume scene asked for with the default
    device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        manager.render_pbrt(golden.variant_text("smoke"), log=QUIET)


@pytest.mark.slow
def test_golden_file_is_the_references_render():
    """The reference, run again, gives the committed golden images and VPL
    set."""
    ref = np.load(golden.GOLDEN)
    images, _ = golden.make()
    assert sorted(images) == sorted(ref.files)
    for name, img in images.items():
        assert np.array_equal(img, ref[name]), name
