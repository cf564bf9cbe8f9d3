"""Make the golden images that ``tests/test_torch_parser.py`` and
``chip_smoke.py`` hold the PyTorch port's samplers, filters, cameras,
sampled-spectrum mode and adaptive renderer against.

    JAX_PLATFORMS=cpu python tools/make_sampling_golden.py [--out FILE]

It renders ``scenes/sampling.pbrt`` (a Cornell-like box under a blackbody
area light, an RGB image texture on the back wall, path integrator to depth
3) with the JAX reference's own ``dartray_tpu.renderers.manager.render_pbrt``
on the CPU, in five variants, each made by replacing the statements before
``WorldBegin``, into ``tools/sampling_golden.npz``:

  v1  the file as it is: orthographic camera over a screen window, 32x32,
      stratified 2x2 jittered, mitchell filter
  v2  environment camera from the middle of the box, 64x32, halton at 4 spp,
      gaussian filter
  v3  perspective camera with an animated transform (a translation at the
      shutter's end, which the reference stores and never applies), 32x32,
      random at 4 spp, sinc filter
  v4  perspective, 16x16, bestcandidate at 32 spp (so the tile repeats
      under its shift), triangle filter, in the sampled spectrum mode
  v5  perspective, 32x32, the adaptive sampler (minsamples 2, maxsamples
      8), a box of xwidth 1.5; ``v5_n_refined`` holds the refined pixels

The reference's wave runs un-jitted (see ``make``), so the tests read the
file; the slow case of the test calls ``make`` again and compares.
"""
import argparse
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tools", "sampling_golden.npz")
SCENES = os.path.join(ROOT, "scenes")
SCENE = os.path.join(SCENES, "sampling.pbrt")

_PATH = 'SurfaceIntegrator "path" "integer maxdepth" [3]\n'
_FRONT = 'LookAt 0 1 -3.6  0 1 0  0 1 0\n'
_FILM = 'Film "image" "integer xresolution" [{}] "integer yresolution" [{}]\n'
HEADERS = {
    "v2": (_FILM.format(64, 32) + 'Sampler "halton" "integer pixelsamples" '
           '[4]\nPixelFilter "gaussian"\n' + _PATH
           + 'LookAt 0 1 0  0 1 1  0 1 0\nCamera "environment"\n'),
    "v3": (_FILM.format(32, 32) + 'Sampler "random" "integer pixelsamples" '
           '[4]\nPixelFilter "sinc"\n' + _PATH + _FRONT
           + 'ActiveTransform EndTime\nTranslate 0.15 0 0\n'
           'ActiveTransform All\nCamera "perspective" "float fov" [40]\n'),
    "v4": (_FILM.format(16, 16) + 'Sampler "bestcandidate" "integer '
           'pixelsamples" [32]\nPixelFilter "triangle"\n' + _PATH + _FRONT
           + 'Camera "perspective" "float fov" [40]\n'),
    "v5": (_FILM.format(32, 32) + 'Sampler "adaptive" "integer minsamples" '
           '[2] "integer maxsamples" [8]\nPixelFilter "box" "float xwidth" '
           '[1.5]\n' + _PATH + _FRONT
           + 'Camera "perspective" "float fov" [40]\n'),
}
VARIANTS = ("v1", "v2", "v3", "v4", "v5")
# the render overrides of a variant: v4 renders in the sampled spectrum mode
OVERRIDES = {"v4": {"spectrum": "sampled"}}
REFINED = re.compile(r"adaptive: refined (\d+) pixels")


def variant_text(name):
    """The scene text of a variant: the file, or its world after the
    variant's own options."""
    with open(SCENE) as f:
        text = f.read()
    if name == "v1":
        return text
    return HEADERS[name] + text[text.index("\nWorldBegin") + 1:]


def refined_from(messages):
    """The adaptive renderer's refined-pixel count from its log line."""
    hits = [int(m.group(1)) for m in map(REFINED.search, messages) if m]
    assert len(hits) == 1, messages
    return hits[0]


def make(names=VARIANTS):
    """{name: image float32, "v5_n_refined": int} rendered by the
    reference's ``render_pbrt`` with its wave un-jitted (a jitted wave
    compiles for a minute or more on the CPU): the wave's operations run
    one by one, the Pallas traversal kernel in interpret mode, and a
    ``fori_loop`` with Python-int bounds as a Python loop whose body sees
    an int32 index, as it would traced. The spectrum mode goes back to
    "rgb" after each variant. Returns (results, seconds per variant)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from dartray_tpu.core import spectrum as ref_spec
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
    out, seconds = {}, {}
    try:
        for name in names:
            messages = []
            t0 = time.time()
            try:
                img = manager.render_pbrt(
                    variant_text(name), search_paths=[SCENES],
                    overrides=OVERRIDES.get(name),
                    log=lambda m, *a, **k: messages.append(str(m)))
            finally:
                ref_spec.set_mode("rgb")
            out[name] = np.asarray(img, np.float32)
            if name == "v5":
                out["v5_n_refined"] = refined_from(messages)
            seconds[name] = time.time() - t0
    finally:
        jax.lax.fori_loop = real
        ref_st.FORCE_PALLAS_INTERPRET, ref_sampler.jax = saved
    return out, seconds


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=GOLDEN)
    ap.add_argument("--only", nargs="*", default=list(VARIANTS))
    a = ap.parse_args()
    out, seconds = make(a.only)
    np.savez(a.out, **out)
    print("wrote", a.out, {k: round(v, 1) for k, v in seconds.items()},
          "n_refined", out.get("v5_n_refined"))


if __name__ == "__main__":
    main()
