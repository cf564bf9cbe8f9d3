"""Make the golden images that ``tests/test_torch_accels.py`` and
``chip_smoke.py`` hold the PyTorch port's grid and kd-tree accelerators
against.

    JAX_PLATFORMS=cpu python tools/make_accel_golden.py [--out FILE]

It renders, with the JAX reference's own
``dartray_tpu.renderers.manager.render_pbrt`` on the CPU, into
``tools/accel_golden.npz``, each scene under ``Accelerator "grid"`` and
under ``Accelerator "kdtree"`` (``sphere_grid``, ``sphere_kdtree``,
``cornell_grid``, ``cornell_kdtree``):

  sphere   the scene of ``tests/test_alt_accels.py``: 12x12, 2 spp, direct
           lighting (strategy one), a matte sphere under a point light
  cornell  scenes/cornell.pbrt: 48x48, path depth 5, with the render
           override {"spp": 1} (1 wave of the file's 8)

The reference's wave runs un-jitted (``make_volume_golden.unjitted``); its
grid and kd-tree walks are XLA while loops, compiled at each call. ``main``
prints the seconds each render took, so the tests read the file and their
slow case calls ``make`` again and compares.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_volume_golden as vg  # noqa: E402

GOLDEN = os.path.join(vg.ROOT, "tools", "accel_golden.npz")
SPHERE = """
Film "image" "integer xresolution" [12] "integer yresolution" [12]
Sampler "lowdiscrepancy" "integer pixelsamples" [2]
Accelerator "{name}"
SurfaceIntegrator "directlighting" "string strategy" ["one"]
LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
Material "matte" "color Kd" [0.6 0.6 0.6]
Shape "sphere" "float radius" [1]
LightSource "point" "point from" [2 4 -2] "color I" [30 30 30]
WorldEnd
"""
OVERRIDES = {"cornell": {"spp": 1}}
ACCELS = ("grid", "kdtree")
VARIANTS = tuple(f"{s}_{a}" for s in ("sphere", "cornell") for a in ACCELS)


def variant_text(name):
    """The scene text of a golden image: the sphere scene, or
    scenes/cornell.pbrt with an Accelerator statement before WorldBegin."""
    scene, accel = name.split("_")
    if scene == "sphere":
        return SPHERE.replace("{name}", accel)
    with open(os.path.join(vg.SCENES, "cornell.pbrt")) as f:
        text = f.read()
    return text.replace("WorldBegin", f'Accelerator "{accel}"\nWorldBegin',
                        1)


def overrides(name):
    return OVERRIDES.get(name.split("_")[0])


def make(names=VARIANTS):
    """({name: float32 image}, seconds per image), rendered by the
    reference's ``render_pbrt`` un-jitted."""
    out, seconds = {}, {}
    with vg.unjitted():
        from dartray_tpu.renderers import manager
        for name in names:
            t0 = time.time()
            img = manager.render_pbrt(variant_text(name),
                                      search_paths=[vg.SCENES],
                                      overrides=overrides(name),
                                      log=lambda *a, **k: None)
            out[name] = np.asarray(img, np.float32)
            seconds[name] = time.time() - t0
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
