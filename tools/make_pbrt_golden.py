"""Make the golden image that ``tests/test_torch_manager.py`` holds the
PyTorch port's scene front door against, from the JAX reference's own
``dartray_tpu.renderers.manager.render_pbrt``.

    JAX_PLATFORMS=cpu python tools/make_pbrt_golden.py [--out FILE]

The scene is ``scenes/cornell.pbrt`` as the file sets it: 48x48 pixels,
lowdiscrepancy 8 spp, path depth 5, box filter. The reference compiles its
wave on the CPU for about a minute, so the test reads this file; its slow
case calls ``make`` again and compares.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tools", "pbrt_golden.npz")
SCENE = os.path.join(ROOT, "scenes", "cornell.pbrt")


def make():
    """{"image": (48, 48, 3) float32} rendered by the reference."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    sys.path.insert(0, ROOT)
    from dartray_tpu.renderers import manager

    img = manager.render_pbrt(SCENE, log=lambda *a, **k: None)
    return {"image": np.asarray(img, np.float32)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=GOLDEN)
    out = ap.parse_args().out
    import numpy as np
    np.savez(out, **make())
    print("wrote", out)


if __name__ == "__main__":
    main()
