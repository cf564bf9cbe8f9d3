"""PyTorch port, precomputed radiance transfer: ``core/sh.py``, the
``diffuseprt`` and ``glossyprt`` integrators, the ``createprobes`` renderer
and the ``useprobes`` integrator, against the JAX reference.

Units on seeded inputs: the SH functions within 1e-6 absolute; the transfer
of both PRT integrators at 8 samples on 16 camera hits of scenes/prt.pbrt
(the reference un-jitted, its sample loop a Python loop, its traversal its
own CPU cluster walk) within rtol 1e-5 / atol 1e-6: the port sums a batch of
sample indices at once, in another order; ``probe_lookup`` and
``probes_li`` on a seeded probe grid within rtol 1e-5 / atol 1e-6. Against
``tools/prt_golden.npz`` (``tools/make_prt_golden.py``): the incident
radiance and the baked probes within rtol 1e-4 (atol 1e-6 of the largest
coefficient), the images of the diffuseprt, glossyprt and useprobes
variants with >= 0.999 of pixels within rtol 1e-3 / atol 1e-4 and the mean
within 1e-3 relative; the traversal launches exact.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu.core import sh as ref_sh
from dartray_tpu.integrators import prt as ref_prt
from dartray_tpu.scene import parser as ref_parser
from dartray_tpu.scene import resources as ref_res
from dartray_tpu.scene import types as ref_st

from dartray_tpu_torch import cameras
from dartray_tpu_torch import samplers
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.core import sh
from dartray_tpu_torch.integrators import prt
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.renderers import probes
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import resources
from dartray_tpu_torch.scene import types as st

import torchhelp as th

sys.path.insert(0, os.path.join(th.ROOT, "tools"))
import make_prt_golden as golden  # noqa: E402

torch.set_num_threads(1)

QUIET = lambda *a, **k: None   # noqa: E731
N = 16                         # camera hits of the live units
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def ref():
    return np.load(golden.GOLDEN)


@pytest.fixture(scope="module", autouse=True)
def eager(request):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    th.eager_reference(mp)
    th.reference_cluster_walk(mp)


def _job(name="diffuseprt", text=None):
    return parser.parse(text or golden.variant_text(name),
                        resolver=resources.Resolver([golden.SCENES]),
                        log=QUIET, device="cpu")


def _ref_scene(name="diffuseprt"):
    rjob = ref_parser.parse(golden.variant_text(name),
                            resolver=ref_res.Resolver([golden.SCENES]),
                            log=QUIET)
    return ref_st.to_device(rjob.scene)


def _camera_rays(job, n=N):
    """Camera rays through n pixels of `job` (lowdiscrepancy, 1 spp)."""
    px = torch.arange(n, dtype=torch.int32) * 7 % job.width
    py = torch.arange(n, dtype=torch.int32) * 5 % job.height
    smp = samplers.make_sampler("lowdiscrepancy", spp=1)
    cs = samplers.camera_samples(smp, px, py, torch.zeros_like(px))
    rays, _, _ = cameras.generate_rays(job.camera, cs, job.width, job.height)
    sctx = {"sampler": smp, "px": px, "py": py, "s_idx": torch.zeros_like(px)}
    return rays, sctx


def _ref_rays(rays):
    from dartray_tpu.core import math as ref_vm
    return ref_vm.Rays(o=th.j3(th.n3(rays.o)), d=th.j3(th.n3(rays.d)),
                       tmin=jnp.asarray(rays.tmin.numpy()),
                       tmax=jnp.asarray(rays.tmax.numpy()),
                       time=jnp.asarray(rays.time.numpy()))


def _dirs(n=61, seed=0):
    """Seeded unit directions, the two poles and a direction 1e-7 off
    one."""
    d = np.random.RandomState(seed).randn(n, 3)
    d = np.concatenate([d, [[0, 0, 1], [0, 0, -1], [1e-7, 0, 1]]])
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _rotation(seed=1):
    q, _ = np.linalg.qr(np.random.RandomState(seed).randn(3, 3))
    return q * np.sign(np.linalg.det(q))


# --- core/sh.py --------------------------------------------------------------

@pytest.mark.parametrize("fn", ["eval_basis", "project_directions",
                                "convolve_cos_theta", "reduce_ringing",
                                "rotation_matrix"])
def test_sh_matches_the_reference(fn):
    """Each SH function on seeded directions and coefficients, lmax 0-6
    (the basis) or 4, within 1e-6 absolute."""
    d = _dirs()
    rng = np.random.RandomState(2)
    if fn == "eval_basis":
        pairs = [(sh.eval_basis(torch.from_numpy(d), l).numpy(),
                  np.asarray(ref_sh.eval_basis(jnp.asarray(d), l)))
                 for l in range(7)]
        # a V3 of lanes as well as an (R, 3) array
        pairs.append((sh.eval_basis(th.t3(d), 4).numpy(),
                      np.asarray(ref_sh.eval_basis(th.j3(d), 4))))
    elif fn == "project_directions":
        v = rng.rand(len(d), 3).astype(np.float32)
        w = rng.rand(len(d)).astype(np.float32)
        pairs = [(sh.project_directions(*(torch.from_numpy(a) for a in
                                          (d, v, w)), 4).numpy(),
                  np.asarray(ref_sh.project_directions(
                      *(jnp.asarray(a) for a in (d, v, w)), 4)))]
    elif fn in ("convolve_cos_theta", "reduce_ringing"):
        c = rng.randn(sh.n_terms(4), 3).astype(np.float32)
        pairs = [(getattr(sh, fn)(torch.from_numpy(c), 4).numpy(),
                  np.asarray(getattr(ref_sh, fn)(jnp.asarray(c), 4)))]
    else:
        R = _rotation()
        c = rng.randn(sh.n_terms(4), 3).astype(np.float32)
        pairs = [(sh.rotation_matrix(R, 4), ref_sh.rotation_matrix(R, 4)),
                 (sh.rotate(c, R, 4), ref_sh.rotate(c, R, 4))]
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --- the PRT integrators -----------------------------------------------------

def _close_coeffs(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


def test_incident_radiance_matches_the_golden(ref, monkeypatch):
    """c_in at the world bound's centre at the defaults (lmax 4, 4,096
    directions, seed 7): one closest-hit launch."""
    job = _job()
    counts = th.count_launches(monkeypatch)
    c_in = prt.project_incident_radiance(
        job.scene, manager.scene_center(job.scene), 4, 4096, device="cpu")
    assert counts == {"closest": 1}
    assert c_in.shape == (25, 3) and (ref["c_in"][0] > 0).all()
    _close_coeffs(c_in.numpy(), ref["c_in"])


@pytest.mark.parametrize("kind", ["diffuse", "glossy"])
def test_transfer_matches_the_reference(kind, ref, monkeypatch):
    """diffuse_li / glossy_li at 8 samples on 16 camera hits over the
    golden c_in, LANE_BUDGET cut to 48 (3 sample indices a launch): the
    camera's closest-hit launch and ceil(8 / 3) any-hit launches."""
    job = _job()
    rays, sctx = _camera_rays(job)
    scene = st.to_device(job.scene, "cpu")
    c_in = ref["c_in"]
    counts = th.count_launches(monkeypatch)
    monkeypatch.setattr(prt, "LANE_BUDGET", 48)
    cls, li = ((prt.DiffusePRTIntegrator, prt.diffuse_li) if kind == "diffuse"
               else (prt.GlossyPRTIntegrator, prt.glossy_li))
    L = th.n3(li(cls(lmax=4, n_samples=8), scene, rays, None, sctx,
                 torch.from_numpy(c_in)))
    assert counts == {"closest": 1, "any": 3}
    rcls, rli = ((ref_prt.DiffusePRTIntegrator, ref_prt.diffuse_li)
                 if kind == "diffuse"
                 else (ref_prt.GlossyPRTIntegrator, ref_prt.glossy_li))
    want = th.n3(rli(rcls(lmax=4, n_samples=8), _ref_scene(), _ref_rays(rays),
                     None, None, jnp.asarray(c_in)))
    assert (want > 0).any(1).sum() >= N // 2
    np.testing.assert_allclose(L, want, rtol=RTOL, atol=ATOL)


def _seeded_probes(seed=4, res=(3, 4, 2), lmax=2):
    rng = np.random.RandomState(seed)
    coeffs = rng.randn(int(np.prod(res)), sh.n_terms(lmax), 3).astype(
        np.float32)
    lo = np.float32([-1.0, 0.0, -1.0])
    hi = np.float32([1.0, 2.0, 1.0])
    port = prt.SHProbes(coeffs=torch.from_numpy(coeffs),
                        bbox_lo=torch.from_numpy(lo),
                        bbox_hi=torch.from_numpy(hi), lmax=lmax, res=res)
    refp = ref_prt.SHProbes(coeffs=jnp.asarray(coeffs),
                            bbox_lo=jnp.asarray(lo), bbox_hi=jnp.asarray(hi),
                            lmax=lmax, res=res)
    return port, refp


def test_probe_lookup_matches_the_reference():
    """Trilinear lookups at 32 seeded points, some outside the grid (the
    clamp), on a 3 x 4 x 2 grid."""
    port, refp = _seeded_probes()
    p = (np.random.RandomState(5).rand(32, 3) * 2.4
         - [1.2, 0.2, 1.2]).astype(np.float32)
    got = prt.probe_lookup(port, th.t3(p)).numpy()
    want = np.asarray(ref_prt.probe_lookup(refp, th.j3(p)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_probes_li_matches_the_reference():
    """probes_li on 16 camera hits of scenes/prt.pbrt over a seeded grid
    (lmax 2)."""
    port, refp = _seeded_probes()
    job = _job()
    rays, sctx = _camera_rays(job)
    L = th.n3(prt.probes_li(prt.UseProbesIntegrator(lmax=2),
                            st.to_device(job.scene, "cpu"), rays, None, sctx,
                            port))
    want = th.n3(ref_prt.probes_li(ref_prt.UseProbesIntegrator(lmax=2),
                                   _ref_scene(), _ref_rays(rays), None, None,
                                   refp))
    assert (want > 0).any(1).mean() > 0.5
    np.testing.assert_allclose(L, want, rtol=RTOL, atol=ATOL)


# --- the front door against the golden ---------------------------------------

# launches of render_pbrt of each variant (16 x 16, 2 waves): the
# preprocess's, then a wave's camera closest-hit launch and its transfer's
# ceil(64 * 256 / LANE_BUDGET) = 1 any-hit launch; createprobes: 16 chunks
# of a path wave at depth 2 (1 closest, 2 mixed, 1 any)
FILE_LAUNCHES = {
    "diffuseprt": {"closest": 1 + 2, "any": 2},
    "glossyprt": {"closest": 1 + 2, "any": 2},
    "createprobes": {"closest": 16, "mixed": 16 * 2, "any": 16},
    "useprobes": {"closest": 2},
}


def test_render_pbrt_matches_the_golden(ref, monkeypatch, tmp_path):
    """diffuseprt, glossyprt, then createprobes (its probe file in the
    working directory against the reference's) and useprobes over that
    file, through render_pbrt on the CPU."""
    monkeypatch.chdir(tmp_path)
    for name in golden.VARIANTS[:4]:
        counts = th.count_launches(monkeypatch)
        img = manager.render_pbrt(golden.variant_text(name),
                                  search_paths=[golden.SCENES], log=QUIET,
                                  device="cpu")
        assert counts == FILE_LAUNCHES[name], (name, counts)
        if name == "createprobes":
            assert not img.any()
            z = np.load("probes.npz")
            assert tuple(z["res"]) == (4, 4, 4) and int(z["lmax"]) == 4
            for k in ("bbox_lo", "bbox_hi"):
                assert th.same_bits(z[k], ref[f"probes_{k}"]), k
            _close_coeffs(z["coeffs"], ref["probes_coeffs"])
        else:
            th.check_golden_image(img, ref[name])


def test_prt_transfer_batches_sample_indices(monkeypatch):
    """A 512 x 512 wave of diffuseprt at the defaults would take
    ceil(4,096 * 262,144 / 2^21) = 512 any-hit launches, not 4,096; here
    24 lanes and 100 samples with LANE_BUDGET 240 (10 indices a launch):
    10 launches, and the same L as with one index a launch."""
    job = _job()
    rays, sctx = _camera_rays(job, 24)
    scene = st.to_device(job.scene, "cpu")
    c_in = torch.ones((25, 3))
    out = []
    for budget, launches in ((240, 10), (24, 100)):
        monkeypatch.setattr(prt, "LANE_BUDGET", budget)
        counts = th.count_launches(monkeypatch)
        out.append(th.n3(prt.diffuse_li(prt.DiffusePRTIntegrator(
            n_samples=100), scene, rays, None, sctx, c_in)))
        assert counts == {"closest": 1, "any": launches}
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5, atol=1e-7)
    assert -(-4096 * 512 * 512 // (1 << 21)) == 512


# --- known behaviours of the reference, kept ---------------------------------

def test_prt_sees_only_area_emission_and_the_environment():
    """Known behaviour aa: c_in holds the area light's emission and the
    environment, and nothing of a point, spot or distant light: adding them
    changes neither c_in nor the diffuseprt image, bit for bit."""
    lights = ('AttributeBegin\nTranslate 0 1.5 0\nLightSource "point" '
              '"rgb I" [9 9 9]\nAttributeEnd\nLightSource "spot" "point from" '
              '[0 1.8 0] "point to" [0 0 0] "rgb I" [9 9 9]\n'
              'LightSource "distant" "point from" [0 1 -1] "point to" '
              '[0 0 0] "rgb L" [3 3 3]\n')
    text = golden.variant_text("diffuseprt").replace(
        "WorldBegin\n", "WorldBegin\n" + lights)
    imgs, cins = [], []
    for t in (golden.variant_text("diffuseprt"), text):
        job = _job(text=t)
        cins.append(prt.project_incident_radiance(
            job.scene, manager.scene_center(job.scene), 4, 256,
            device="cpu").numpy())
        imgs.append(manager.render_pbrt(t, search_paths=[golden.SCENES],
                                        log=QUIET, device="cpu"))
    assert _job(text=text).scene.lights.n == _job().scene.lights.n + 3
    assert (cins[0][0] > 0).all()
    assert th.same_bits(cins[0], cins[1]) and th.same_bits(imgs[0], imgs[1])


def test_one_direction_sequence_for_every_lane():
    """Known behaviour ab: the transfer never reads the sampler: the same
    rays under another sampler, other pixels and another sample index give
    the same L bit for bit, and two lanes on one ray the same value."""
    job = _job()
    rays, sctx = _camera_rays(job)
    rays = vm.Rays(*(vm.V3(*(torch.cat([a, a]) for a in v))
                     if isinstance(v, vm.V3) else torch.cat([v, v])
                     for v in rays))
    scene = st.to_device(job.scene, "cpu")
    c_in = torch.from_numpy(np.random.RandomState(6).rand(25, 3).astype(
        np.float32))
    out = []
    for kind, s in (("lowdiscrepancy", 0), ("random", 3)):
        px = torch.arange(2 * N, dtype=torch.int32) * (s + 1)
        c = {"sampler": samplers.make_sampler(kind, spp=4, seed=s), "px": px,
             "py": px, "s_idx": torch.full_like(px, s)}
        for li, ig in ((prt.diffuse_li, prt.DiffusePRTIntegrator(
                n_samples=16)), (prt.glossy_li, prt.GlossyPRTIntegrator(
                    n_samples=16))):
            out.append(th.n3(li(ig, scene, rays, None, c, c_in)))
    for a, b in zip(out[:2], out[2:]):
        assert th.same_bits(a, b)
    for a in out:
        assert th.same_bits(a[:N], a[N:]) and (a > 0).any()


def test_prt_material_terms():
    """Known behaviour ac: diffuseprt takes rho = kd whatever the material
    (the plastic sphere as a matte of the same Kd renders the same image,
    bit for bit), and glossyprt leaves out specular lobes and clamps the SH
    radiance at 0 (under c_in <= 0 every hit gives its emission only)."""
    plastic = ('Material "plastic" "rgb Kd" [0.6 0.4 0.1] "rgb Ks" '
               '[0.4 0.4 0.4] "float roughness" [0.05]')
    text = golden.variant_text("diffuseprt")
    imgs = [manager.render_pbrt(t, search_paths=[golden.SCENES], log=QUIET,
                                device="cpu")
            for t in (text, text.replace(
                plastic, 'Material "matte" "rgb Kd" [0.6 0.4 0.1]'))]
    assert th.same_bits(imgs[0], imgs[1])
    job = _job()
    rays, sctx = _camera_rays(job)
    scene = st.to_device(job.scene, "cpu")
    c_in = torch.zeros((25, 3))
    c_in[0] = -1.0
    L = prt.glossy_li(prt.GlossyPRTIntegrator(n_samples=8), scene, rays,
                      None, sctx, c_in)
    hits = st.intersect(scene.geometry, rays)
    it = st.interaction(scene.geometry, rays, hits)
    le = prt._emitted(scene.lights, scene.geometry, hits, it, rays)
    assert th.same_bits(th.n3(L), th.n3(le))


def test_createprobes_and_useprobes_options(monkeypatch, tmp_path):
    """Known behaviour ad: createprobes reads only lmax, indirectsamples and
    filename (the grid is 4 x 4 x 4 over the world bound, seed 11, chunks
    of 4), each chunk's rays are pixels 0 .. 4 S - 1 of row 0 at sample 0
    of the random sampler, so every chunk draws the same randoms; useprobes
    loads its file relative to the working directory, not the scene's, and
    takes lmax from the file."""
    monkeypatch.chdir(tmp_path)
    line = ('Renderer "createprobes" "integer indirectsamples" [4] '
            '"integer lmax" [2] "string filename" ["p.npz"] '
            '"integer xres" [8] "integer seed" [5]')
    text = golden.variant_text("createprobes").replace(
        golden.LINES["createprobes"][golden.RENDERER_LINE], line)
    seen = []
    real = probes.render

    def spy(scene, li_fn, **kw):
        def li(s, r, d, c):
            seen.append(c)
            return li_fn(s, r, d, c)
        return real(scene, li, **kw)

    monkeypatch.setattr(probes, "render", spy)
    manager.render_pbrt(text, search_paths=[golden.SCENES], log=QUIET,
                        device="cpu")
    z = np.load(tmp_path / "p.npz")
    assert tuple(z["res"]) == (4, 4, 4) and int(z["lmax"]) == 2
    assert z["coeffs"].shape == (64, 9, 3) and len(seen) == 16
    for c in seen:
        assert c["sampler"].kind == samplers.RANDOM and c["sampler"].seed == 11
        assert th.same_bits(c["px"].numpy(), np.arange(16, dtype=np.int32))
        assert not c["py"].any() and not c["s_idx"].any()
    # the scene lies in another directory than the probe file
    sub = tmp_path / "scene"
    sub.mkdir()
    (sub / "s.pbrt").write_text(golden.variant_text("useprobes").replace(
        'SurfaceIntegrator "useprobes"',
        'SurfaceIntegrator "useprobes" "string filename" ["p.npz"]'))
    used = []
    real_li = prt.probes_li
    monkeypatch.setattr(prt, "probes_li", lambda ig, *a: (
        used.append(ig.lmax), real_li(ig, *a))[1])
    img = manager.render_pbrt(str(sub / "s.pbrt"),
                              search_paths=[golden.SCENES], log=QUIET,
                              device="cpu")
    assert used == [2, 2] and np.isfinite(img).all() and img.any()


def test_prt_runs_on_the_card_by_default():
    """No CUDA device here: the preprocess and the probe file asked for
    with the default device raise; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        manager.build_surface_li(_job(), log=QUIET)
    with pytest.raises(RuntimeError, match="cuda"):
        probes.render(_job().scene, None)


@pytest.mark.slow
def test_golden_file_is_the_references(ref):
    """The reference, run again, gives the committed golden arrays."""
    got, _ = golden.make()
    for k, v in got.items():
        assert np.array_equal(v, ref[k]), k
