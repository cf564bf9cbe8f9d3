"""PyTorch port, the irradiance cache integrator (``irradiancecache``): the
hemisphere estimate, the prime pass, the interpolation and the manager's
branch, against the JAX reference.

Units on seeded inputs: the hemisphere estimate (the reference un-jitted,
its sample loop as a Python loop, its traversal its own CPU cluster walk)
within rtol 1e-5 / atol 1e-6: the port sums a batch of sample indices at
once, in another order; the interpolation (both sides with MAX_SCAN cut to
4 so that a cell's budget binds) within rtol 1e-5 / atol 1e-7. The prime
pass and the render of scenes/caches.pbrt against ``tools/cache_golden.npz``
(``tools/make_cache_golden.py``): the cache in the reference's order
(>= 0.999 of slots paired, >= 0.995 close), >= 0.999 of pixels within
rtol 1e-3 / atol 1e-4; the traversal launches exact.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu.integrators import irradiance_cache as ref_ic
from dartray_tpu.scene import parser as ref_parser
from dartray_tpu.scene import resources as ref_res

from dartray_tpu_torch import lights as lt_mod
from dartray_tpu_torch import materials as mat_mod
from dartray_tpu_torch import samplers
from dartray_tpu_torch import stats
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.integrators import irradiance_cache as ic
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.scene import build as sb
from dartray_tpu_torch.scene import mesh
from dartray_tpu_torch.scene import paramset
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import resources
from dartray_tpu_torch.scene import types as st

import torchhelp as th

sys.path.insert(0, os.path.join(th.ROOT, "tools"))
import make_cache_golden as golden  # noqa: E402

torch.set_num_threads(1)

QUIET = lambda *a, **k: None   # noqa: E731
N = 16


@pytest.fixture(scope="module")
def ref():
    return np.load(golden.GOLDEN)


def _job(name="irradiancecache", text=None):
    return parser.parse(text or golden.variant_text(name),
                        resolver=resources.Resolver([golden.SCENES]),
                        log=QUIET, device="cpu")


def _camera_hits(job, n=N):
    """The port's first hits of camera rays through n pixels of `job`."""
    px = torch.arange(n, dtype=torch.int32) * 7 % job.width
    py = torch.arange(n, dtype=torch.int32) * 5 % job.height
    smp = samplers.make_sampler("lowdiscrepancy", spp=1)
    from dartray_tpu_torch import cameras
    cs = samplers.camera_samples(smp, px, py, torch.zeros_like(px))
    rays, _, _ = cameras.generate_rays(job.camera, cs, job.width, job.height)
    scene = st.to_device(job.scene, "cpu")
    hits = st.intersect(scene.geometry, rays)
    it = st.interaction(scene.geometry, rays, hits)
    return scene, rays, hits, it


def test_hemisphere_E_matches_the_reference(monkeypatch):
    """8 (0,2)-sequence directions at 16 camera hits of scenes/caches.pbrt,
    batched 2 indices a launch (LANE_BUDGET cut to 40): 4 closest-hit
    launches."""
    th.eager_reference(monkeypatch)
    th.reference_cluster_walk(monkeypatch)
    job = _job()
    scene, _, hits, it = _camera_hits(job)
    assert hits.hit.all()
    ns = vm.face_forward(it["ns"], it["wo"])
    counts = th.count_launches(monkeypatch)
    monkeypatch.setattr(ic, "LANE_BUDGET", 40)
    E, dmean = ic.hemisphere_E(scene, it["p"], ns, it["ng"], it["t"], 8, 5,
                               3.0)
    assert counts == {"closest": 4}
    rjob = ref_parser.parse(golden.variant_text("irradiancecache"),
                            resolver=ref_res.Resolver([golden.SCENES]),
                            log=QUIET)
    from dartray_tpu.scene import types as ref_st
    rE, rd = ref_ic._hemisphere_E(
        ref_st.to_device(rjob.scene), th.j3(th.n3(it["p"])),
        th.j3(th.n3(ns)), th.j3(th.n3(it["ng"])), jnp.asarray(it["t"]), 8,
        5, 3.0)
    assert (th.n3(rE) > 0).any()
    np.testing.assert_allclose(th.n3(E), th.n3(rE), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dmean.numpy(), np.asarray(rd), rtol=1e-5)


def _seeded_cache(n, seed, cell=0.2):
    """n cache points in a unit cube, hashed and ordered as the reference's
    build_cache orders them, in both packages."""
    rng = np.random.RandomState(seed)
    p = rng.rand(n, 3).astype(np.float32)
    nn = rng.randn(n, 3).astype(np.float32)
    nn[:, 1] = np.abs(nn[:, 1]) + 1.0
    nn /= np.linalg.norm(nn, axis=1, keepdims=True)
    E = rng.rand(n, 3).astype(np.float32)
    d = (rng.rand(n) * 0.5 + 0.1).astype(np.float32)
    cellid = np.asarray(ref_ic._hash_cells(jnp.asarray(
        np.floor(p / cell).astype(np.int32))))
    o = np.argsort(cellid)
    arrays = [a[o] for a in (p, nn, E, d, cellid)]
    rcache = ref_ic.IrradianceCache(*(jnp.asarray(a) for a in arrays),
                                    cell_size=cell, count=n)
    cache = ic.IrradianceCache(*(torch.from_numpy(a) for a in arrays),
                               cell_size=cell, count=n)
    return rcache, cache


def test_interpolate_matches_the_reference(monkeypatch):
    """400 cached points in a unit cube, cells of 0.2, 32 queries."""
    th.eager_reference(monkeypatch)
    monkeypatch.setattr(ref_ic, "MAX_SCAN", 4)
    monkeypatch.setattr(ic, "MAX_SCAN", 4)
    rcache, cache = _seeded_cache(400, 1)
    rng = np.random.RandomState(2)
    q = rng.rand(32, 3).astype(np.float32)
    nq = np.tile(np.float32([0, 1, 0]), (32, 1))
    rig = ref_ic.IrradianceCacheIntegrator(min_weight=0.3)
    rE, rw = ref_ic.interpolate(rcache, rig, th.j3(q), th.j3(nq))
    E, w = ic.interpolate(cache, ic.IrradianceCacheIntegrator(
        min_weight=0.3), th.t3(q), th.t3(nq))
    assert (np.asarray(rw) > 0).mean() > 0.5
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(th.n3(E), th.n3(rE), rtol=1e-5, atol=1e-7)


def test_build_cache_matches_the_golden(ref):
    """The prime pass of the irradiancecache variant: 9 points of a 24 x 24
    image, 64 directions each, in the reference's order."""
    job = _job()
    cache = ic.build_cache(manager.irradiance_cache_integrator(
        job.surf_params), job.scene, job.camera, job.width, job.height,
        device="cpu")
    got = golden.cache_arrays(cache)
    assert np.array_equal(got["ic_cell"], ref["ic_cell"])
    slots, close, n, _ = golden.agreement(got, ref, "ic_",
                                       ("p", "n", "E", "dmean"))
    assert slots == 1.0 and close >= 0.995 and n == 9, (slots, close, n)


def test_render_pbrt_matches_the_golden(ref, monkeypatch):
    """render_pbrt on the CPU: the prime pass is 1 camera + 1 hemisphere
    launch (9 x 64 lanes), a wave 1 camera closest, the sampled light's
    closest and any-hit and 1 fallback hemisphere launch (16 x 576 lanes);
    the image against the reference's."""
    counts = th.count_launches(monkeypatch)
    img = manager.render_pbrt(golden.variant_text("irradiancecache"),
                              search_paths=[golden.SCENES], log=QUIET,
                              device="cpu")
    assert counts == {"closest": 2 + 3 * 2, "any": 2}, counts
    th.check_golden_image(img, ref["irradiancecache"])


# --- known behaviours of the reference, kept ---------------------------------

def test_cached_light_is_area_emission_and_environment():
    """Known behaviour y: the cached irradiance is the emission of hit area
    lights (and the environment), which li's sampled light counts again: it
    is positive under the area light of scenes/caches.pbrt, and nothing in
    a box lit by a point light only, whose light reaches li through the
    sampled light alone."""
    job = _job()
    scene, _, _, it = _camera_hits(job)
    E, _ = ic.hemisphere_E(scene, it["p"], vm.face_forward(it["ns"],
                                                           it["wo"]),
                           it["ng"], it["t"], 16, 5, 3.0)
    assert (th.n3(E) > 0).all(1).any()
    b = sb.SceneBuilder()
    b.add_material(mat_mod.matte(kd=(0.5, 0.5, 0.5)))
    b.add_mesh(mesh.make_mesh([[-2, 0, -2], [2, 0, -2], [2, 0, 2],
                               [-2, 0, 2]], [[0, 1, 2], [0, 2, 3]]), 0)
    b.add_light(lt_mod.point_light((0.0, 1.0, 0.0), (4.0, 4.0, 4.0)))
    scene = st.to_device(b.build(), "cpu")
    o = np.tile(np.float32([0, 2, -3]), (N, 1))
    d = np.stack([np.linspace(-0.3, 0.3, N), -np.ones(N) * 0.6,
                  np.ones(N)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = vm.make_rays(th.t3(o), th.t3(d))
    hits = st.intersect(scene.geometry, rays)
    it = st.interaction(scene.geometry, rays, hits)
    ns = vm.face_forward(it["ns"], it["wo"])
    E, _ = ic.hemisphere_E(scene, it["p"], ns, it["ng"], it["t"], 16, 5,
                           3.0)
    assert hits.hit.all() and not th.n3(E).any()
    cache = ic.IrradianceCache(
        p=vm.to_arr(it["p"]), n=vm.to_arr(ns), E=vm.to_arr(E),
        dmean=torch.ones(N), cell=torch.zeros(N, dtype=torch.int32),
        cell_size=0.5, count=N)
    sctx = {"sampler": samplers.make_sampler("lowdiscrepancy", spp=1),
            "px": torch.arange(N, dtype=torch.int32),
            "py": torch.zeros(N, dtype=torch.int32),
            "s_idx": torch.zeros(N, dtype=torch.int32)}
    L = ic.li(ic.IrradianceCacheIntegrator(), scene, rays, None, sctx, cache)
    assert (th.n3(L) > 0).all()


def test_maxdepth_is_read_and_never_used(monkeypatch):
    """Known behaviour y: no specular continuation; maxdepth 1 and 5 give
    the same wave, launch for launch. And the prime pass ignores the
    scene's sampler: a scene that names the random sampler primes the same
    cache."""
    job = _job()
    cache = ic.build_cache(ic.IrradianceCacheIntegrator(n_samples=4),
                           job.scene, job.camera, job.width, job.height,
                           device="cpu")
    scene, rays, _, _ = _camera_hits(job)
    sctx = {"sampler": samplers.make_sampler("lowdiscrepancy", spp=1),
            "px": torch.arange(N, dtype=torch.int32),
            "py": torch.zeros(N, dtype=torch.int32),
            "s_idx": torch.zeros(N, dtype=torch.int32)}
    out = []
    for depth in (1, 5):
        ps = paramset.ParamSet()
        ps.add("integer maxdepth", [depth])
        ig = manager.irradiance_cache_integrator(ps)
        assert ig.max_depth == depth
        counts = th.count_launches(monkeypatch)
        out.append((th.n3(ic.li(ig, scene, rays, None, sctx, cache)),
                    dict(counts)))
    assert th.same_bits(out[0][0], out[1][0]) and out[0][1] == out[1][1]
    text = golden.variant_text("irradiancecache").replace(
        'Sampler "lowdiscrepancy"', 'Sampler "random"')
    rjob = _job(text=text)
    assert rjob.sampler.kind != job.sampler.kind
    again = ic.build_cache(ic.IrradianceCacheIntegrator(n_samples=4),
                           rjob.scene, rjob.camera, rjob.width, rjob.height,
                           device="cpu")
    for k, v in golden.cache_arrays(cache).items():
        assert th.same_bits(v, golden.cache_arrays(again)[k]), k


def test_interpolation_host_operations_do_not_depend_on_density(
        monkeypatch):
    """The interpolation issues the same number of torch operations over
    100 and over 3,000 cached points, and with MAX_SCAN 32 and 4."""
    q = th.t3(np.random.RandomState(3).rand(32, 3).astype(np.float32))
    nq = th.t3(np.tile(np.float32([0, 1, 0]), (32, 1)))
    n_ops = []
    for n, scan in ((100, 32), (3000, 32), (3000, 4)):
        monkeypatch.setattr(ic, "MAX_SCAN", scan)
        _, cache = _seeded_cache(n, 4)
        with stats.TorchOps() as ops:
            ic.interpolate(cache, ic.IrradianceCacheIntegrator(), q, nq)
        n_ops.append(ops.n)
    assert n_ops[0] == n_ops[1] == n_ops[2], n_ops


def test_irradiancecache_runs_on_the_card_by_default():
    """No CUDA device here: the prime pass asked for with the default
    device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        manager.build_surface_li(_job(), log=QUIET)


@pytest.mark.slow
def test_golden_cache_and_image_are_the_references(ref):
    """The reference, run again, gives the committed irradiancecache image
    and cache."""
    got, _ = golden.make(["irradiancecache"])
    for k, v in got.items():
        assert np.array_equal(v, ref[k]), k
