"""Make the golden images that ``tests/test_torch_volumes.py``,
``tests/test_torch_igi.py`` and ``chip_smoke.py`` hold the PyTorch port's
participating media and IGI integrator against.

    JAX_PLATFORMS=cpu python tools/make_volume_golden.py [--out FILE]

It renders, with the JAX reference's own
``dartray_tpu.renderers.manager.render_pbrt`` on the CPU, into
``tools/volume_golden.npz``:

  smoke           scenes/smoke.pbrt as the file sets it: 32x32, 4 spp,
                  direct lighting, single scattering in a 4x4x4 volumegrid
  volumes         scenes/volumes.pbrt as the file sets it: 32x32, 4 spp,
                  path depth 3, a homogeneous and an exponential region
                  (both emissive) through the emission integrator
  volumes_single  scenes/volumes.pbrt with single scattering under direct
                  lighting (depth 2)
  igi_env         scenes/igi-env.pbrt as the file sets it: 64x32, 4 spp,
                  nlights 16, maxdepth 3, an infinite light
  igi_vpl_p, igi_vpl_n, igi_vpl_alpha (S, K, 3) and igi_vpl_valid (S, K):
                  the VPL set the reference's ``igi.preprocess`` shoots for
                  igi_env (S = 4 sets, K = 16 paths x 3 depths)

The reference's wave runs un-jitted (``unjitted``); ``main`` prints the
seconds each render took, so the tests read the file and their slow cases
call ``make`` again and compare.
"""
import argparse
import contextlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tools", "volume_golden.npz")
SCENES = os.path.join(ROOT, "scenes")
FILES = {"smoke": "smoke.pbrt", "volumes": "volumes.pbrt",
         "volumes_single": "volumes.pbrt", "igi_env": "igi-env.pbrt"}
EMISSION_LINES = ('SurfaceIntegrator "path" "integer maxdepth" [3]\n'
                  'VolumeIntegrator "emission" "float stepsize" [0.1]')
SINGLE_LINES = ('SurfaceIntegrator "directlighting" "integer maxdepth" [2]\n'
                'VolumeIntegrator "single" "float stepsize" [0.1]')
VARIANTS = tuple(FILES)


def variant_text(name):
    """The scene text of a golden image: a file as it is, or volumes.pbrt
    with single scattering under direct lighting."""
    with open(os.path.join(SCENES, FILES[name])) as f:
        text = f.read()
    if name == "volumes_single":
        assert EMISSION_LINES in text
        text = text.replace(EMISSION_LINES, SINGLE_LINES)
    return text


@contextlib.contextmanager
def unjitted():
    """The reference as its render loop runs un-jitted on the CPU (a jitted
    wave compiles for a minute or more): the wave's operations run one by
    one, the Pallas traversal kernel in interpret mode, and a ``fori_loop``
    with Python-int bounds as a Python loop whose body sees an int32 index,
    as it would traced (``tests/torchhelp.py``'s ``eager_reference``)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
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

    saved = ref_st.FORCE_PALLAS_INTERPRET, ref_sampler.jax
    ref_st.FORCE_PALLAS_INTERPRET, ref_sampler.jax = True, Unjitted()
    jax.lax.fori_loop = fori_loop
    try:
        yield
    finally:
        jax.lax.fori_loop = real
        ref_st.FORCE_PALLAS_INTERPRET, ref_sampler.jax = saved


def reference_vpls(text):
    """The reference's VPL set for a scene text with an igi integrator, as
    {igi_vpl_*: array}."""
    from dartray_tpu.integrators import igi
    from dartray_tpu.scene import parser, resources
    job = parser.parse(text, resolver=resources.Resolver([SCENES]),
                       log=lambda *a, **k: None)
    p = job.surf_params
    ig = igi.IGIIntegrator(n_light_paths=p.find_one_int("nlights", 64),
                           n_light_sets=p.find_one_int("nsets", 4),
                           max_depth=p.find_one_int("maxdepth", 5),
                           g_limit=p.find_one_float("glimit", 10.0))
    v = igi.preprocess(ig, job.scene)
    v3 = lambda a: np.stack([np.asarray(c) for c in a], -1)
    return {"igi_vpl_p": v3(v.p), "igi_vpl_n": v3(v.n),
            "igi_vpl_alpha": v3(v.alpha),
            "igi_vpl_valid": np.asarray(v.valid)}


def make(names=VARIANTS):
    """({name: float32 image} plus the igi_env VPL set, seconds per
    image), rendered by the reference's ``render_pbrt`` un-jitted."""
    out, seconds = {}, {}
    with unjitted():
        from dartray_tpu.renderers import manager
        for name in names:
            t0 = time.time()
            img = manager.render_pbrt(variant_text(name),
                                      search_paths=[SCENES],
                                      log=lambda *a, **k: None)
            out[name] = np.asarray(img, np.float32)
            seconds[name] = time.time() - t0
        if "igi_env" in names:
            out.update(reference_vpls(variant_text("igi_env")))
    return out, seconds


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=GOLDEN)
    out = ap.parse_args().out
    images, seconds = make()
    np.savez(out, **images)
    print("wrote", out, {k: round(v, 1) for k, v in seconds.items()})


if __name__ == "__main__":
    main()
