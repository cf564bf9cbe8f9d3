"""Make the data of ``scenes/materials.pbrt`` and the golden image that
``tests/test_torch_materials.py`` and ``chip_smoke.py`` hold the PyTorch
port's material system against.

    JAX_PLATFORMS=cpu python tools/make_materials_golden.py [--out FILE]

It writes, from fixed seeds with numpy:

  scenes/materials.pfm   a 24x20 RGB image map (not a power of two, so the
                         mip pyramid starts with the Lanczos resample)
  scenes/materials.merl  an 8x8x16 MERL half-angle table (a glossy lobe with
                         noise), the format ``io/merl.py`` reads

and then renders the scene with the JAX reference's own
``dartray_tpu.renderers.manager.render_pbrt`` on the CPU into
``tools/materials_golden.npz``: 40x40 pixels, lowdiscrepancy 4 spp, path
depth 3, box filter, 28,686 triangles, 14 materials, 14 textures. The
reference's wave runs un-jitted (see ``make``) and took 6 min 3 s on a
shared CPU, so the tests read the file; the test file's slow case calls
``make`` again and compares.
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tools", "materials_golden.npz")
SCENE = os.path.join(ROOT, "scenes", "materials.pbrt")
PFM = os.path.join(ROOT, "scenes", "materials.pfm")
MERL = os.path.join(ROOT, "scenes", "materials.merl")
MERL_DIMS = (8, 8, 16)
MERL_SCALES = (1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0)


def pfm_bytes(seed=10):
    """A 24x20 image: two colour gradients, a grid of dots and noise."""
    h, w = 20, 24
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([x / w, y / h, 0.5 + 0.5 * np.sin(x * 0.7) * np.cos(
        y * 0.9)], -1)
    img[(x.astype(int) % 6 < 2) & (y.astype(int) % 5 < 2)] = (0.9, 0.9, 0.1)
    img = np.clip(img * 0.8 + 0.1 * rng.rand(h, w, 3), 0.0, 1.0)
    # PFM: little-endian, bottom row first
    return (b"PF\n%d %d\n-1.0\n" % (w, h)
            + img.astype("<f4")[::-1].tobytes())


def merl_bytes(seed=11):
    """A MERL binary: three int32 dims, then the doubles channel-major,
    stored so that the reader's channel scales give a glossy lobe about
    the half vector plus a coloured diffuse floor and noise."""
    nth, ntd, npd = MERL_DIMS
    rng = np.random.RandomState(seed)
    th_h = ((np.arange(nth) + 0.5) / nth) ** 2 * (np.pi / 2)
    lobe = np.exp(-(th_h / 0.15) ** 2)[:, None, None]
    base = np.ones((nth, ntd, npd))
    chans = []
    for c, (diff, spec) in enumerate(((0.25, 2.0), (0.12, 1.6),
                                      (0.05, 1.2))):
        v = diff * base + spec * lobe + 0.02 * rng.rand(nth, ntd, npd)
        chans.append((v / MERL_SCALES[c]).reshape(-1))
    return (np.asarray(MERL_DIMS, "<i4").tobytes()
            + np.concatenate(chans).astype("<f8").tobytes())


def write_data():
    for path, data in ((PFM, pfm_bytes()), (MERL, merl_bytes())):
        with open(path, "wb") as f:
            f.write(data)


def make(overrides=None):
    """{"image": (40, 40, 3) float32} rendered by the reference's
    ``render_pbrt`` with its wave un-jitted: a jitted wave of this scene
    takes tens of GB to compile on the CPU. The wave's operations then run
    one by one (each compiled alone), the Pallas traversal kernel in
    interpret mode, and a ``fori_loop`` with Python-int bounds as a Python
    loop whose body sees an int32 index, as it would traced
    (``tests/torchhelp.py``'s ``eager_reference``)."""
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
    try:
        img = manager.render_pbrt(SCENE, overrides=overrides,
                                  log=lambda *a, **k: None)
    finally:
        jax.lax.fori_loop = real
        ref_st.FORCE_PALLAS_INTERPRET, ref_sampler.jax = saved
    return {"image": np.asarray(img, np.float32)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=GOLDEN)
    out = ap.parse_args().out
    write_data()
    np.savez(out, **make())
    print("wrote", PFM, MERL, out)


if __name__ == "__main__":
    main()
