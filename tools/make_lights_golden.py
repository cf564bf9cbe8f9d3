"""Make the golden images that ``tests/test_torch_alpha.py``,
``tests/test_torch_lights.py`` and ``chip_smoke.py`` hold the PyTorch port's
alpha cut-outs and remaining lights against.

    JAX_PLATFORMS=cpu python tools/make_lights_golden.py [--out FILE]

It renders, with the JAX reference's own
``dartray_tpu.renderers.manager.render_pbrt`` on the CPU, into
``tools/lights_golden.npz``:

  alpha           scenes/alpha.pbrt as the file sets it: 32x32, 2 spp,
                  direct lighting to depth 1, four stacked checker-masked
                  quads before a wall under a distant light
  lights          scenes/lights.pbrt as the file sets it: 32x32, 4 spp, path
                  depth 3, an infinite, a goniometric and a projection light
  lights_direct   scenes/lights.pbrt through the direct-lighting integrator
                  (depth 2, 1 spp)
  lights_whitted  scenes/lights.pbrt through the Whitted integrator (depth 2,
                  1 spp)

The reference's wave runs un-jitted (see ``make``): the four renders took
24.7, 36.2, 19.2 and 5.2 s on a shared CPU (``main`` prints them), so the
tests read the file; their slow case calls ``make`` again and compares.
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tools", "lights_golden.npz")
SCENES = os.path.join(ROOT, "scenes")
ALPHA = os.path.join(SCENES, "alpha.pbrt")
LIGHTS = os.path.join(SCENES, "lights.pbrt")
PATH_LINE = 'SurfaceIntegrator "path" "integer maxdepth" [3]'
SPP_LINE = 'Sampler "lowdiscrepancy" "integer pixelsamples" [4]'


def variant_text(name):
    """The scene text of a golden image: a file as it is, or lights.pbrt
    with its integrator and sample count replaced."""
    path = ALPHA if name == "alpha" else LIGHTS
    with open(path) as f:
        text = f.read()
    integ = {"lights_direct": "directlighting",
             "lights_whitted": "whitted"}.get(name)
    if integ is not None:
        assert PATH_LINE in text and SPP_LINE in text
        text = text.replace(PATH_LINE, f'SurfaceIntegrator "{integ}" '
                            '"integer maxdepth" [2]')
        text = text.replace(SPP_LINE, 'Sampler "lowdiscrepancy" '
                            '"integer pixelsamples" [1]')
    return text


VARIANTS = ("alpha", "lights", "lights_direct", "lights_whitted")


def make(names=VARIANTS):
    """{name: (32, 32, 3) float32} rendered by the reference's
    ``render_pbrt`` with its wave un-jitted (a jitted wave compiles for a
    minute or more on the CPU). The wave's operations then run one by one,
    the Pallas traversal kernel in interpret mode, and a ``fori_loop`` with
    Python-int bounds as a Python loop whose body sees an int32 index, as it
    would traced (``tests/torchhelp.py``'s ``eager_reference``). Returns
    (images, seconds per image)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from dartray_tpu.renderers import manager
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
    images, seconds = {}, {}
    try:
        for name in names:
            t0 = time.time()
            img = manager.render_pbrt(variant_text(name),
                                      search_paths=[SCENES],
                                      log=lambda *a, **k: None)
            images[name] = np.asarray(img, np.float32)
            seconds[name] = time.time() - t0
    finally:
        jax.lax.fori_loop = real
        ref_st.FORCE_PALLAS_INTERPRET, ref_sampler.jax = saved
    return images, seconds


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=GOLDEN)
    out = ap.parse_args().out
    images, seconds = make()
    np.savez(out, **images)
    print("wrote", out, {k: round(v, 1) for k, v in seconds.items()})


if __name__ == "__main__":
    main()
