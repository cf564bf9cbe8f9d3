"""Make the goldens that ``tests/test_torch_photonmap.py``,
``tests/test_torch_irradiance_cache.py``, ``tests/test_torch_dipole.py`` and
``chip_smoke.py`` hold the PyTorch port's cache-and-gather integrators
against.

    JAX_PLATFORMS=cpu python tools/make_cache_golden.py [--out FILE]

It renders scenes/caches.pbrt (24x24, 2 spp: a Cornell-style box, a glass
sphere, a skin1 subsurface sphere, an area light) with the JAX reference's
own ``dartray_tpu.renderers.manager.render_pbrt`` on the CPU, in four
variants of its SurfaceIntegrator line, into ``tools/cache_golden.npz``:

  photonmap        as written: 1,024 caustic + 2,048 indirect photon paths,
                   maxdist 0.2, a final gather of 4 samples
  exphotonmap      the same photons, no final gather (the indirect map)
  irradiancecache  nsamples 64: 9 prime points (stride 8)
  dipole           dipolesubsurface, minsampledistance 0.1

and the preprocess of each: the three photon maps of ``photonmap``
(pm_{caustic,direct,indirect}_{p,wi,alpha,cell}) and the irradiance cache of
``irradiancecache`` (ic_{p,n,E,dmean,cell}). The dipole's surface points
and their irradiance are cheap enough for the tests to recompute.

The reference's render loop runs un-jitted, its ``fori_loop``s with Python
bounds as Python loops, its traversal through its own CPU walk over the
cluster BVH, each walk jitted once (as ``tests/torchhelp.py``'s
``eager_reference`` and ``reference_cluster_walk``), and its photon gather
``photonmap.density_radiance`` jitted with its own ``fori_loop``s (27 cells
x 64 slots of eager operations take 12-40 s a call; unrolled into one
trace they take tens of GB to compile).
``main`` prints the seconds each render took; the tests read the file and
their slow cases call ``make`` again and compare.
"""
import argparse
import contextlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tools", "cache_golden.npz")
SCENES = os.path.join(ROOT, "scenes")
SCENE = os.path.join(SCENES, "caches.pbrt")
PHOTONMAP_LINE = ('SurfaceIntegrator "photonmap" "integer causticphotons" '
                  '[1024] "integer indirectphotons" [2048] "float maxdist" '
                  '[0.2] "integer finalgathersamples" [4]')
LINES = {
    "photonmap": PHOTONMAP_LINE,
    "exphotonmap": PHOTONMAP_LINE.replace('"photonmap"', '"exphotonmap"')
    + ' "bool finalgather" ["false"]',
    "irradiancecache": 'SurfaceIntegrator "irradiancecache" '
                       '"integer nsamples" [64]',
    "dipole": 'SurfaceIntegrator "dipolesubsurface" '
              '"float minsampledistance" [0.1]',
}
VARIANTS = tuple(LINES)
MAPS = ("caustic", "direct", "indirect")


def variant_text(name):
    """The scene text of a variant: caches.pbrt with its integrator line
    swapped."""
    with open(SCENE) as f:
        text = f.read()
    assert text.count(PHOTONMAP_LINE) == 1
    return text.replace(PHOTONMAP_LINE, LINES[name])


@contextlib.contextmanager
def reference():
    """The JAX reference as the goldens are made: un-jitted render loop,
    Python-bound ``fori_loop``s as Python loops (the body sees an int32
    index, as traced), the CPU cluster walks jitted once."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import functools
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from dartray_tpu.accel import cluster
    from dartray_tpu.integrators import photonmap as pm
    from dartray_tpu.renderers import sampler as ref_sampler
    from dartray_tpu.scene import types as ref_st

    real = jax.lax.fori_loop

    def fori_loop(lower, upper, body, init):
        if not (isinstance(lower, int) and isinstance(upper, int)):
            return real(lower, upper, body, init)
        val = init
        for i in range(lower, upper):
            val = body(jnp.int32(i), val)
        return val

    class Unjitted:
        """jax as the reference's render loop sees it, jit left out."""

        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def jit(fn, **_):
            return fn

    saved = (ref_st.FORCE_PALLAS_INTERPRET, ref_sampler.jax,
             cluster.intersect, cluster.intersect_p, pm.density_radiance)
    ref_st.FORCE_PALLAS_INTERPRET, ref_sampler.jax = False, Unjitted()
    cluster.intersect = jax.jit(saved[2])
    cluster.intersect_p = jax.jit(saved[3])
    @functools.wraps(saved[4])
    def density_radiance(*a, **k):     # traced with the real fori_loop
        jax.lax.fori_loop = real
        try:
            return saved[4](*a, **k)
        finally:
            jax.lax.fori_loop = fori_loop

    pm.density_radiance = jax.jit(
        density_radiance, static_argnames=("max_dist", "diffuse_only"))
    jax.lax.fori_loop = fori_loop
    try:
        yield
    finally:
        jax.lax.fori_loop = real
        (ref_st.FORCE_PALLAS_INTERPRET, ref_sampler.jax, cluster.intersect,
         cluster.intersect_p, pm.density_radiance) = saved


def _parse(text):
    from dartray_tpu.scene import parser, resources
    return parser.parse(text, resolver=resources.Resolver([SCENES]),
                        log=lambda *a, **k: None)


def reference_maps():
    """The reference's photon maps of the photonmap variant, as
    {pm_<map>_<field>: array}."""
    from dartray_tpu.integrators import photonmap as pm
    job = _parse(variant_text("photonmap"))
    p = job.surf_params
    ig = pm.PhotonMapIntegrator(
        n_caustic=p.find_one_int("causticphotons", 20_000),
        n_indirect=p.find_one_int("indirectphotons", 100_000),
        n_lookup=p.find_one_int("nused", 50),
        max_dist=p.find_one_float("maxdist", 0.1),
        final_gather=p.find_one_bool("finalgather", True),
        gather_samples=p.find_one_int("finalgathersamples", 32))
    return map_arrays(pm.shoot_photons(ig, job.scene))


def reference_cache():
    """The reference's irradiance cache of the irradiancecache variant, as
    {ic_<field>: array}."""
    from dartray_tpu.integrators import irradiance_cache as ic
    job = _parse(variant_text("irradiancecache"))
    p = job.surf_params
    ig = ic.IrradianceCacheIntegrator(
        min_weight=p.find_one_float("minweight", 0.5),
        max_angle_deg=p.find_one_float("maxanglediff", 10.0),
        n_samples=p.find_one_int("nsamples", 4096),
        max_depth=p.find_one_int("maxdepth", 5))
    return cache_arrays(ic.build_cache(ig, job.scene, job.camera, job.width,
                                       job.height))


def map_arrays(maps):
    """Photon maps of either package (caustic, direct, indirect) ->
    {pm_<map>_<field>: numpy}, the golden's layout."""
    out = {}
    v3 = lambda a: np.stack([np.asarray(_host(c)) for c in a], -1)  # noqa
    for name, m in zip(MAPS, maps):
        out.update({f"pm_{name}_p": v3(m.p), f"pm_{name}_wi": v3(m.wi),
                    f"pm_{name}_alpha": v3(m.alpha),
                    f"pm_{name}_cell": np.asarray(_host(m.cell))})
    return out


def cache_arrays(c):
    """An irradiance cache of either package -> {ic_<field>: numpy}."""
    return {f"ic_{k}": np.asarray(_host(getattr(c, k)))
            for k in ("p", "n", "E", "dmean", "cell")}


def _host(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else a


PHOTON_TOL = dict(rtol=1e-4, atol=1e-5)


def _pairs(got, want, prefix):
    """Indices (ia, ib) of paired points: the k-th of a hash id in one set
    with the k-th of the same id in the other (both sorted by hash id)."""
    def keys(c):
        first = np.searchsorted(c, c, side="left")
        return c.astype(np.int64) * (1 << 32) + (np.arange(len(c)) - first)

    _, ia, ib = np.intersect1d(keys(got[prefix + "cell"]),
                               keys(want[prefix + "cell"]),
                               return_indices=True)
    return ia, ib


def agreement(got, want, prefix, fields, rtol=1e-5, atol=1e-6):
    """How far two point sets sorted by hash id agree (``_pairs``).
    Returns (paired slots over the larger set's size, share of pairs whose
    every field is close, pairs, the (got, want) indices of the pairs not
    close).
    Photons take PHOTON_TOL: the reference shoots them in one jitted
    program, the port op by op, and float32 differences of an ulp in a
    direction grow over the bounces to 5e-5 of a position in
    scenes/caches.pbrt."""
    ia, ib = _pairs(got, want, prefix)
    ok = np.ones(len(ia), bool)
    for f in fields:
        a, b = got[prefix + f][ia], want[prefix + f][ib]
        ok &= np.isclose(a, b, rtol=rtol, atol=atol).reshape(len(ia),
                                                             -1).all(1)
    n = max(len(got[prefix + "cell"]), len(want[prefix + "cell"]), 1)
    return (len(ia) / n, float(ok.mean()) if len(ia) else 1.0, len(ia),
            list(zip(ia[~ok].tolist(), ib[~ok].tolist())))


def make(names=VARIANTS):
    """({name: float32 image} plus the preprocess arrays, seconds per
    image), from the reference's ``render_pbrt``."""
    out, seconds = {}, {}
    with reference():
        from dartray_tpu.renderers import manager
        for name in names:
            t0 = time.time()
            img = manager.render_pbrt(variant_text(name),
                                      search_paths=[SCENES],
                                      log=lambda *a, **k: None)
            out[name] = np.asarray(img, np.float32)
            seconds[name] = time.time() - t0
        if "photonmap" in names:
            out.update(reference_maps())
        if "irradiancecache" in names:
            out.update(reference_cache())
    return out, seconds


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=GOLDEN)
    out = ap.parse_args().out
    images, seconds = make()
    np.savez_compressed(out, **images)
    print("wrote", out, {k: round(v, 1) for k, v in seconds.items()})


if __name__ == "__main__":
    main()
