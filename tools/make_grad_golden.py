"""Make the golden gradient that ``tests/test_torch_grad.py`` holds the
PyTorch port against, from the JAX reference's own
``dartray_tpu.grad.render_pixel_jacobian_sum``.

    JAX_PLATFORMS=cpu python tools/make_grad_golden.py [--out FILE]

The scene is the box of the reference's gradient tests
(``tests/torchhelp.ref_box_scene``); 8x8 pixels, lowdiscrepancy 2 spp, path
depth 3 without remat, the gradient of the image mean w.r.t.
``materials.kd`` and ``lights.intensity``. The reference's traversal runs
its Pallas kernel in interpret mode (the kernel the port's v6 mirrors). The
reference takes minutes on the CPU to compile the gradient, so the test
reads this file; its slow case calls ``make`` again and compares.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tools", "grad_golden.npz")
WIDTH = 8
SPP = 2
DEPTH = 3
PATHS = ("materials.kd", "lights.intensity")
# the reference gradient tests' camera (tests/test_grad.py:44)
EYE, LOOK, UP, FOV = [0, 1.0, -3.2], [0, 0.8, 0], [0, 1, 0], 35.0


def make():
    """{"loss": (), path: gradient} from the reference, as numpy."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torchhelp as th
    from dartray_tpu import cameras, grad, samplers
    from dartray_tpu.core import transform as tr
    from dartray_tpu.integrators import path as pi
    from dartray_tpu.scene import types as st

    host = th.ref_box_scene()
    cam = cameras.perspective(tr.look_at(EYE, LOOK, UP), FOV, WIDTH, WIDTH)
    smp = samplers.make_sampler("lowdiscrepancy", spp=SPP)
    ig = pi.PathIntegrator(max_depth=DEPTH, remat=False)
    li = lambda s, r, d, c: pi.li(ig, s, r, d, c)
    theta, inject = grad.select(host, list(PATHS))
    saved = st.FORCE_PALLAS_INTERPRET
    st.FORCE_PALLAS_INTERPRET = True
    try:
        val, g = grad.render_pixel_jacobian_sum(host, cam, smp, li, WIDTH,
                                                WIDTH, theta, inject)
    finally:
        st.FORCE_PALLAS_INTERPRET = saved
    return {"loss": np.asarray(val), **{p: np.asarray(g[p]) for p in PATHS}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=GOLDEN)
    out = ap.parse_args().out
    import numpy as np
    np.savez(out, **make())
    print("wrote", out)


if __name__ == "__main__":
    main()
