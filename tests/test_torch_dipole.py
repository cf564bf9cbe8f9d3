"""PyTorch port, dipole subsurface scattering: the ``surfacepoints``
renderer, the irradiance preprocess, the diffusion reflectance, Mo, the
``dipolesubsurface`` integrator and the ``subsurface`` materials, against the
JAX reference.

The reference runs un-jitted where it is not jitted itself, its traversal
its own CPU cluster walk. Surface points are held slot by slot (the same
points in the same order; p within rtol 1e-5 / atol 1e-6), their irradiance
within rtol 1e-5 / atol 1e-6 on >= 0.995 of points, Rd within rtol 1e-5,
Mo within rtol 1e-5 (a sum of positive terms in another order), li within
rtol 1e-5 / atol 1e-6 on >= 0.995 of lanes. The render of the dipole
variant of scenes/caches.pbrt against ``tools/cache_golden.npz``: >= 0.999
of pixels within rtol 1e-3 / atol 1e-4; the traversal launches exact.
"""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu import samplers as ref_samplers
from dartray_tpu.core import math as ref_vm
from dartray_tpu.integrators import dipole as ref_dp
from dartray_tpu.renderers import surface_points as ref_sp
from dartray_tpu.scene import parser as ref_parser
from dartray_tpu.scene import resources as ref_res
from dartray_tpu.scene import types as ref_st

from dartray_tpu_torch import __main__ as cli
from dartray_tpu_torch import samplers
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.integrators import dipole as dp
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.renderers import surface_points as sp_mod
from dartray_tpu_torch.scene import paramset
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import resources
from dartray_tpu_torch.scene import types as st

import torchhelp as th

sys.path.insert(0, os.path.join(th.ROOT, "tools"))
import make_cache_golden as golden  # noqa: E402

torch.set_num_threads(1)

QUIET = lambda *a, **k: None   # noqa: E731
SMALL = dict(min_sample_dist=0.2, n_rounds=4, rays_per_round=1024)
R = 64


@pytest.fixture(scope="module")
def world(request):
    """The dipole variant of scenes/caches.pbrt parsed by both packages, and
    the reference's surface points (4 rounds of 1,024 rays, spacing 0.2)
    and irradiance points over it."""
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    th.eager_reference(mp)
    th.reference_cluster_walk(mp)
    text = golden.variant_text("dipole")
    rjob = ref_parser.parse(text, resolver=ref_res.Resolver([golden.SCENES]),
                            log=QUIET)
    job = parser.parse(text, resolver=resources.Resolver([golden.SCENES]),
                       log=QUIET, device="cpu")
    rsp = ref_sp.render(rjob.scene, **SMALL)
    return dict(rjob=rjob, job=job, rsp=rsp,
                rip=ref_dp.prepare(rjob.scene, rsp),
                scene=st.to_device(job.scene, "cpu"),
                rscene=ref_st.to_device(rjob.scene))


def test_fdr_and_dipole_rd_match_the_reference():
    rng = np.random.RandomState(0)
    d2 = (rng.rand(40, 30) ** 3 * 4).astype(np.float32)
    for name in ("skin1", "marble", "ketchup", "spectralon"):
        s, a = dp.media_params(name)
        rs, ra = ref_dp.media_params(name)
        assert th.same_bits(s, rs) and th.same_bits(a, ra)
        want = np.asarray(ref_dp.dipole_rd(jnp.asarray(d2), jnp.asarray(rs),
                                           jnp.asarray(ra), 1.3))
        got = dp.dipole_rd(torch.from_numpy(d2), torch.from_numpy(s),
                           torch.from_numpy(a), 1.3).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
    assert dp.fdr(1.3) == ref_dp.fdr(1.3)
    assert dp.media_params("nosuch")[0].tolist() == \
        dp.media_params("skin1")[0].tolist()


def _points(n, seed):
    rng = np.random.RandomState(seed)
    p = (rng.rand(n, 3) * 2 - 1).astype(np.float32)
    e = (rng.rand(n, 3) * 0.01).astype(np.float32)
    q = (rng.rand(R, 3) * 2 - 1).astype(np.float32)
    return (ref_dp.IrradiancePoints(p=jnp.asarray(p),
                                    E_times_area=jnp.asarray(e), n=n),
            dp.IrradiancePoints(p=torch.from_numpy(p),
                                E_times_area=torch.from_numpy(e), n=n), q)


def test_mo_matches_the_reference_on_whole_blocks(monkeypatch):
    """2,048 points (two whole blocks of 1,024), the lanes in blocks of 16
    (MO_BUDGET cut)."""
    monkeypatch.setattr(dp, "MO_BUDGET", 16 * 1024)
    rip, ip, q = _points(2048, 1)
    s, a = dp.media_params("skin1")
    want = np.asarray(ref_dp.mo(rip, jnp.asarray(q), jnp.asarray(s),
                                jnp.asarray(a), 1.3))
    got = dp.mo(ip, torch.from_numpy(q), torch.from_numpy(s),
                torch.from_numpy(a), 1.3).numpy()
    assert np.isfinite(want).all() and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_mo_is_nan_unless_the_points_fill_whole_blocks():
    """Known behaviour z: the last block is padded with points at 1e30,
    whose squared distance is inf in float32, and Rd(inf) is inf * 0: Mo is
    NaN on every lane in both packages, and the film zeroes such samples."""
    rip, ip, q = _points(300, 2)
    s, a = dp.media_params("skin1")
    want = np.asarray(ref_dp.mo(rip, jnp.asarray(q), jnp.asarray(s),
                                jnp.asarray(a), 1.3))
    got = dp.mo(ip, torch.from_numpy(q), torch.from_numpy(s),
                torch.from_numpy(a), 1.3).numpy()
    assert np.isnan(want).all() and np.isnan(got).all()


def test_surface_points_match_the_reference(world):
    sp = sp_mod.render(world["job"].scene, device="cpu", **SMALL)
    rsp = world["rsp"]
    assert len(rsp.p) > 50
    assert sp.p.shape == rsp.p.shape
    for f in ("mat_id", "area"):
        assert th.same_bits(getattr(sp, f), np.asarray(getattr(rsp, f))), f
    for f in ("p", "n", "ray_eps"):
        np.testing.assert_allclose(getattr(sp, f), getattr(rsp, f),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def test_prepare_matches_the_reference(world):
    """The irradiance of the reference's own surface points from the area
    light: 4 samples, one any-hit launch each."""
    rsp = world["rsp"]
    ip = dp.prepare(world["job"].scene, rsp, device="cpu")
    got, want = ip.E_times_area.numpy(), np.asarray(world["rip"].E_times_area)
    assert ((got > 0) == (want > 0)).all() and (want > 0).any()
    ok = np.isclose(got, want, rtol=1e-5, atol=1e-6).all(1)
    assert ok.mean() >= 0.995, ok.mean()


def _camera_rays(job):
    rng = np.random.RandomState(8)
    o = np.tile(np.float32([0.0, 1.0, -3.4]), (R, 1))
    d = np.stack([rng.uniform(-0.35, 0.35, R), rng.uniform(-0.35, 0.35, R),
                  np.ones(R)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    px = (np.arange(R) % 8).astype(np.int32)
    py = (np.arange(R) // 8).astype(np.int32)
    rsctx = {"sampler": ref_samplers.make_sampler("lowdiscrepancy", spp=2),
             "px": jnp.asarray(px), "py": jnp.asarray(py),
             "s_idx": jnp.full((R,), 1, jnp.int32)}
    sctx = {"sampler": samplers.make_sampler("lowdiscrepancy", spp=2),
            "px": torch.from_numpy(px), "py": torch.from_numpy(py),
            "s_idx": torch.full((R,), 1, dtype=torch.int32)}
    return (ref_vm.make_rays(jnp.asarray(o), jnp.asarray(d)), rsctx,
            vm.make_rays(th.t3(o), th.t3(d)), sctx)


def test_li_matches_the_reference(world):
    """Camera rays into the box with the reference's irradiance points
    tiled to 1,024 (a whole block: Mo is finite), the skin1 sphere as the
    job's only subsurface material."""
    rip = world["rip"]
    k = np.arange(1024) % rip.n
    rip = ref_dp.IrradiancePoints(p=rip.p[k], E_times_area=rip.E_times_area[k],
                                  n=1024)
    ip = dp.IrradiancePoints(p=torch.from_numpy(np.asarray(rip.p)),
                             E_times_area=torch.from_numpy(
                                 np.asarray(rip.E_times_area)), n=1024)
    job, rjob = world["job"], world["rjob"]
    assert job.sss == rjob.sss and len(job.sss) == 1
    [mid] = list(job.sss)
    sps, sa, mask = manager.dipole_medium(job, device="cpu")
    rmask = np.zeros(rjob.scene.materials.n, bool)
    rmask[mid] = True
    rrays, rsctx, rays, sctx = _camera_rays(job)
    ig = manager.dipole_integrator(job.surf_params)
    want = ref_dp.li(ref_dp.DipoleSubsurfaceIntegrator(min_sample_dist=0.1),
                     world["rscene"], rrays, None, rsctx, rip,
                     sigma_prime_s=jnp.asarray(rjob.sss[mid][0], jnp.float32),
                     sigma_a=jnp.asarray(rjob.sss[mid][1], jnp.float32),
                     sss_mask=jnp.asarray(rmask))
    got = dp.li(ig, world["scene"], rays, None, sctx, ip, sigma_prime_s=sps,
                sigma_a=sa, sss_mask=mask)
    g, w = th.n3(got), th.n3(want)
    assert np.isfinite(w).all() and (w > 0).any()
    ok = np.isclose(g, w, rtol=1e-5, atol=1e-6).all(1)
    assert ok.mean() >= 0.995, (ok.mean(), np.abs(g - w).max())


def test_render_pbrt_matches_the_golden(monkeypatch):
    """The dipole variant through render_pbrt on the CPU: 32 closest-hit
    launches to spread the surface points, 4 any-hit for their irradiance
    (one area light), then a wave of 1 camera closest and the sampled
    light's closest and any-hit; the image against the reference's, whose
    subsurface sphere is black (its point count is not a whole block)."""
    counts = th.count_launches(monkeypatch)
    img = manager.render_pbrt(golden.variant_text("dipole"),
                              search_paths=[golden.SCENES], log=QUIET,
                              device="cpu")
    assert counts == {"closest": 32 + 2 * 2, "any": 4 + 2}, counts
    th.check_golden_image(img, np.load(golden.GOLDEN)["dipole"])


CUBE = """Film "image" "integer xresolution" [4] "integer yresolution" [4]
LookAt 0 0 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
Material "subsurface" "string name" ["marble"]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3  4 6 5 4 7 6  0 4 5 0 5 1
  3 2 6 3 6 7  0 3 7 0 7 4  1 5 6 1 6 2]
  "point P" [-1 -1 -1  1 -1 -1  1 1 -1  -1 1 -1  -1 -1 1  1 -1 1  1 1 1
             -1 1 1]
WorldEnd
"""


def test_surfacepoints_renderer_writes_a_file_both_packages_read(tmp_path):
    """``Renderer "surfacepoints"`` through ``python -m dartray_tpu_torch``
    on a cube: a black image, and the points in the reference's .npz
    layout, spaced at least minsampledistance apart."""
    path = str(tmp_path / "pts.npz")
    text = (f'Renderer "surfacepoints" "float minsampledistance" [0.3] '
            f'"string filename" ["{path}"]\n' + CUBE)
    scene_file = tmp_path / "sp.pbrt"
    scene_file.write_text(text)
    out = str(tmp_path / "black.pfm")
    assert cli.main([str(scene_file), "-q", "--device", "cpu", "-o",
                     out]) == 0
    mine, theirs = sp_mod.load(path), ref_sp.load(path)
    for f in mine._fields:
        assert th.same_bits(getattr(mine, f), getattr(theirs, f)), f
    p = mine.p.astype(np.float64)
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1) + np.eye(len(p)) * 1e9
    assert len(p) > 20 and d2.min() >= 0.3 ** 2 * (1 - 1e-5)
    from dartray_tpu_torch.io import image as io_img
    assert not io_img.load(open(out, "rb").read(), out).any()


# --- known behaviours of the reference, kept ---------------------------------

def test_dipole_options_and_media_as_the_reference_reads_them(world):
    """Known behaviour z: maxerror is read and never used; the first medium
    of the job's subsurface materials serves all of them; the integrator's
    eta (1.3) is used, not the material's index; li follows no specular
    bounce (one camera launch and the sampled light's two, with a glass
    sphere in view); without a subsurface material, skin1 on every
    surface."""
    ps = paramset.ParamSet()
    ps.add("float maxerror", [0.5])
    assert manager.dipole_integrator(ps).max_error == 0.5
    text = golden.variant_text("dipole").replace(
        '"float scale" [2]', '"float scale" [2] "float index" [1.9]'
    ).replace('Material "glass" "float index" [1.5]',
              'Material "subsurface" "string name" ["marble"]')
    job = parser.parse(text, resolver=resources.Resolver([golden.SCENES]),
                       log=QUIET, device="cpu")
    assert len(job.sss) == 2
    first = next(iter(job.sss.values()))
    assert first[2] == 1.9
    logs = []
    sps, sa, mask = manager.dipole_medium(job, log=logs.append,
                                          device="cpu")
    assert sps.tolist() == list(np.float32(first[0]))
    assert mask.nonzero().flatten().tolist() == sorted(job.sss)
    assert logs and "first" in logs[0]
    rip = world["rip"]
    ip = dp.IrradiancePoints(p=torch.from_numpy(np.asarray(rip.p)),
                             E_times_area=torch.from_numpy(
                                 np.asarray(rip.E_times_area)), n=rip.n)
    _, _, rays, sctx = _camera_rays(job)
    scene = st.to_device(job.scene, "cpu")
    outs = []
    for ig in (dp.DipoleSubsurfaceIntegrator(),
               dp.DipoleSubsurfaceIntegrator(max_error=0.5)):
        mp = pytest.MonkeyPatch()
        counts = th.count_launches(mp)
        outs.append(th.n3(dp.li(ig, scene, rays, None, sctx, ip, sps, sa,
                                mask)))
        mp.undo()
        assert counts == {"closest": 2, "any": 1}, counts
    assert th.same_bits(outs[0], outs[1])
    assert manager.dipole_medium(dataclasses.replace(world["job"], sss={}),
                                 device="cpu") == (None, None, None)
    got = th.n3(dp.li(dp.DipoleSubsurfaceIntegrator(), scene, rays, None,
                      sctx, ip))
    hit = st.intersect(scene.geometry, rays).hit.numpy()
    assert np.isnan(got[hit]).all() and not np.isnan(got[~hit]).any()


def test_dipolesubsurface_runs_on_the_card_by_default():
    """No CUDA device here: the surface points asked for with the default
    device raise; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    job = parser.parse(golden.variant_text("dipole"),
                       resolver=resources.Resolver([golden.SCENES]),
                       log=QUIET, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        manager.build_surface_li(job, log=QUIET)


@pytest.mark.slow
def test_golden_image_is_the_references():
    """The reference, run again, gives the committed dipole image."""
    got, _ = golden.make(["dipole"])
    assert np.array_equal(got["dipole"], np.load(golden.GOLDEN)["dipole"])
