"""PyTorch port, the photon map integrator (``photonmap`` / ``exphotonmap``):
the hash-grid maps, the density estimate, the photon shooting and the
manager's branch, against the JAX reference.

Units on seeded inputs: ``build_map`` bit for bit; the density estimate
(the reference un-jitted, its scan loop as a Python loop, both sides with
MAX_SCAN cut to 4 so that a cell's budget binds) within rtol 1e-5 /
atol 1e-7 on every lane: the port sums its (query, photon) pairs with one
scatter-add, in another order than the reference's loop. The photon maps
and the renders of scenes/caches.pbrt against ``tools/cache_golden.npz``
(``tools/make_cache_golden.py``): >= 0.999 of photon slots paired and
>= 0.995 of them close (rtol 1e-4 / atol 1e-5: the reference shoots in one
jitted program, and an ulp of a direction grows over the bounces), >= 0.999
of pixels within
rtol 1e-3 / atol 1e-4 and the mean within 1e-3 relative; the traversal
launches exact.
"""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu import bsdf as ref_bx
from dartray_tpu.integrators import photonmap as ref_pm

from dartray_tpu_torch import bsdf as bx
from dartray_tpu_torch import stats
from dartray_tpu_torch.integrators import photonmap as pm
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.scene import paramset
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import resources

import torchhelp as th

sys.path.insert(0, os.path.join(th.ROOT, "tools"))
import make_cache_golden as golden  # noqa: E402

torch.set_num_threads(1)

QUIET = lambda *a, **k: None   # noqa: E731
R = 32


@pytest.fixture(scope="module")
def ref():
    return np.load(golden.GOLDEN)


def _job(name):
    return parser.parse(golden.variant_text(name),
                        resolver=resources.Resolver([golden.SCENES]),
                        log=QUIET, device="cpu")


def _photons(n, seed, lo=-1.5, hi=1.5):
    rng = np.random.RandomState(seed)
    p = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    wi = rng.randn(n, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    al = (rng.rand(n, 3) * 1e-3).astype(np.float32)
    return p, wi, al


def _port_map(p, wi, al, cell):
    return pm.build_map(th.t3(p), th.t3(wi), th.t3(al), cell)


def test_build_map_is_bit_equal():
    """The int32 hash (wrap-around products, the reference's saturating
    float -> int32 conversion for a photon at 1e30) and the stable sort."""
    p, wi, al = _photons(700, 0)
    p[5] = 1e30
    p[9] = -1e30
    p[11:40] = p[10]                 # one crowded cell, in deposit order
    want = ref_pm.build_map(jnp.asarray(p), jnp.asarray(wi),
                            jnp.asarray(al), 0.15)
    got = _port_map(p, wi, al, 0.15)
    assert th.same_bits(got.cell.numpy(), np.asarray(want.cell))
    for f in ("p", "wi", "alpha"):
        assert th.same_bits(th.n3(getattr(got, f)),
                            th.n3(getattr(want, f))), f
    assert (got.n, got.cell_size) == (want.n, want.cell_size)


def _lanes(seed):
    """R query lanes in the photons' cube: points, a shading frame, wo and
    plastic-like BSDF parameters, in both packages."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)
    n = rng.randn(R, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    dp = rng.randn(R, 3).astype(np.float32)
    wo = rng.randn(R, 3).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wo *= np.sign((wo * n).sum(1, keepdims=True))
    kd = rng.rand(R, 3).astype(np.float32)
    ks = (rng.rand(R, 3) * 0.5).astype(np.float32)
    ex = (rng.rand(R) * 50 + 2).astype(np.float32)
    rp = ref_bx.zero_params(R)._replace(kd=th.j3(kd), ks=th.j3(ks),
                                        exponent=jnp.asarray(ex))
    pp = bx.zero_params(R, "cpu")._replace(kd=th.t3(kd), ks=th.t3(ks),
                                           exponent=torch.from_numpy(ex))
    return (dict(q=th.j3(q), frame=ref_bx.make_frame(th.j3(n), th.j3(dp),
                                                     th.j3(n)),
                 params=rp, wo=th.j3(wo)),
            dict(q=th.t3(q), frame=bx.make_frame(th.t3(n), th.t3(dp),
                                                 th.t3(n)),
                 params=pp, wo=th.t3(wo)))


@pytest.mark.parametrize("diffuse_only", [True, False])
def test_density_radiance_matches_the_reference(diffuse_only, monkeypatch):
    """A dense map (500 photons in a 0.6 cube, cells of 0.15): every scanned
    cell holds more than MAX_SCAN photons."""
    th.eager_reference(monkeypatch)
    monkeypatch.setattr(ref_pm, "MAX_SCAN", 4)
    monkeypatch.setattr(pm, "MAX_SCAN", 4)
    p, wi, al = _photons(500, 1, -0.3, 0.3)
    rmap = ref_pm.build_map(jnp.asarray(p), jnp.asarray(wi),
                            jnp.asarray(al), 0.15)
    rl, pl = _lanes(2)
    want = th.n3(ref_pm.density_radiance(
        rmap, rl["q"], rl["frame"], rl["params"], rl["wo"], 0.15,
        diffuse_only=diffuse_only))
    got = th.n3(pm.density_radiance(
        _port_map(p, wi, al, 0.15), pl["q"], pl["frame"], pl["params"],
        pl["wo"], 0.15, diffuse_only=diffuse_only))
    assert (want > 0).any(1).mean() > 0.9
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_shoot_photons_match_the_golden(ref):
    """The three maps of the photonmap variant of scenes/caches.pbrt: 3,072
    paths, 5 bounces, shot on the CPU."""
    job = _job("photonmap")
    ig = manager.photonmap_integrator(job.surf_params)
    got = golden.map_arrays(pm.shoot_photons(ig, job.scene, device="cpu"))
    for name in golden.MAPS:
        pre = f"pm_{name}_"
        slots, close, n, _ = golden.agreement(got, ref, pre,
                                           ("p", "wi", "alpha"),
            **golden.PHOTON_TOL)
        assert slots >= 0.999 and close >= 0.995, (name, slots, close)
        assert n >= 20, name


@pytest.mark.parametrize("name", ["photonmap", "exphotonmap"])
def test_render_pbrt_matches_the_golden(name, ref, monkeypatch):
    """The variant through render_pbrt on the CPU: 5 closest-hit launches to
    shoot the photons, then a wave of 6 depths x (1 closest + the sampled
    light's closest and any-hit) plus, with the final gather, its 4 gather
    rays; the image against the reference's."""
    counts = th.count_launches(monkeypatch)
    img = manager.render_pbrt(golden.variant_text(name),
                              search_paths=[golden.SCENES], log=QUIET,
                              device="cpu")
    spp = 2
    gather = 4 if name == "photonmap" else 0
    assert counts == {"closest": 5 + (12 + gather) * spp,
                      "any": 6 * spp}, counts
    th.check_golden_image(img, ref[name])


# --- known behaviours of the reference, kept ---------------------------------

def test_photon_map_options_as_the_reference_reads_them():
    """Known behaviour w: nused is read and never used; maxspeculardepth
    and maxphotondepth are not read (both stay 5); exphotonmap is photonmap;
    causticphotons + indirectphotons only sets the number of paths, each of
    which deposits into the map its prefix picks."""
    ps = paramset.ParamSet()
    for k, v in (("nused", 7), ("maxspeculardepth", 2),
                 ("maxphotondepth", 1), ("causticphotons", 96),
                 ("indirectphotons", 32)):
        ps.add(f"integer {k}", [v])
    ig = manager.photonmap_integrator(ps)
    assert (ig.n_lookup, ig.max_specular_depth, ig.max_photon_depth) == (
        7, 5, 5)
    job = _job("photonmap")
    ex = _job("exphotonmap")
    assert ex.surf_integrator == "exphotonmap"
    assert manager.photonmap_integrator(ex.surf_params) == dataclasses.replace(
        manager.photonmap_integrator(job.surf_params), final_gather=False)
    a = pm.shoot_photons(ig, job.scene, device="cpu")
    b = pm.shoot_photons(pm.PhotonMapIntegrator(n_caustic=0, n_indirect=128),
                         job.scene, device="cpu")
    assert len(a[0].cell) > 0 and len(a[2].cell) > 0
    for x, y in zip(golden.map_arrays(a).values(),
                    golden.map_arrays(b).values()):
        assert th.same_bits(x, y)


def _colliding_cells():
    """Two cells of the grid [0, 80)^3 with the same hash id."""
    g = np.stack(np.meshgrid(*[np.arange(80)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.int64)
    h = (g[:, 0] * 73856093 ^ g[:, 1] * 19349663
         ^ g[:, 2] * 83492791) & 0x7fffffff
    order = np.argsort(h, kind="stable")
    dup = np.nonzero(np.diff(h[order]) == 0)[0][0]
    return g[order[dup]], g[order[dup + 1]]


def test_a_lookup_takes_the_first_64_of_a_hash_id():
    """Known behaviour x: not k-nearest. Two far-apart cells share a hash
    id; 40 photons of the far cell were deposited before 40 of the queried
    cell, so the query's scan of that id stops after 24 of its own. Every
    photon here lies within maxdist of the query."""
    cell = 0.5
    a, b = _colliding_cells()
    rng = np.random.RandomState(3)
    inside = lambda c: ((c + 0.45 + rng.rand(40, 3) * 0.1) * cell).astype(
        np.float32)   # noqa: E731
    p = np.concatenate([inside(b), inside(a)])
    wi = np.tile(np.float32([0, 0, 1]), (80, 1))
    al = np.ones((80, 3), np.float32)
    m = _port_map(p, wi, al, cell)
    assert th.same_bits(m.cell.numpy(), np.asarray(ref_pm.build_map(
        jnp.asarray(p), jnp.asarray(wi), jnp.asarray(al), cell).cell))
    q = ((a + 0.5) * cell).astype(np.float32)[None]
    kd = np.float32([[1.0, 1.0, 1.0]])
    params = bx.zero_params(1, "cpu")._replace(kd=th.t3(kd))
    n = np.float32([[0, 0, 1]])
    got = th.n3(pm.density_radiance(m, th.t3(q), bx.make_frame(
        th.t3(n), th.t3(n[:, [2, 0, 1]]), th.t3(n)), params, th.t3(n),
        cell, diffuse_only=True))[0]
    r2 = cell * cell
    d2 = ((p[40:64] - q) ** 2).sum(1)
    want = (3.0 / np.pi / r2 * (1.0 - d2 / r2) ** 2).sum() / np.pi
    np.testing.assert_allclose(got, [want] * 3, rtol=1e-5)


def test_gather_host_operations_do_not_depend_on_density_or_budget(
        monkeypatch):
    """The density estimate issues the same number of torch operations
    over 100 and over 1,500 photons, and with MAX_SCAN 64 and 8: no loop
    over cells or slots."""
    _, pl = _lanes(4)
    n_ops = []
    for n, scan in ((100, 64), (1500, 64), (1500, 8)):
        monkeypatch.setattr(pm, "MAX_SCAN", scan)
        m = _port_map(*_photons(n, 5, -0.3, 0.3), 0.15)
        with stats.TorchOps() as ops:
            pm.density_radiance(m, pl["q"], pl["frame"], pl["params"],
                                pl["wo"], 0.15)
        n_ops.append(ops.n)
    assert n_ops[0] == n_ops[1] == n_ops[2], n_ops


def test_photonmap_runs_on_the_card_by_default():
    """No CUDA device here: the photon shooting asked for with the default
    device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        manager.build_surface_li(_job("photonmap"), log=QUIET)


@pytest.mark.slow
def test_golden_maps_and_images_are_the_references(ref):
    """The reference, run again, gives the committed photonmap images and
    maps."""
    got, _ = golden.make(["photonmap", "exphotonmap"])
    for k, v in got.items():
        assert np.array_equal(v, ref[k]), k
