"""Command line: python -m dartray_tpu_torch scene.pbrt [-o out.png]
(counterpart of the JAX reference's ``__main__.py``, with ``--device``).

Renders on the card unless ``--device cpu`` is given; asking for a card that
is not there raises.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="dartray_tpu_torch",
        description="PBRT-v2-compatible wavefront renderer (PyTorch / CUDA)")
    ap.add_argument("scene", help=".pbrt scene file (or archive)")
    ap.add_argument("-o", "--output", default=None,
                    help="output image (.pfm is written linear, anything "
                         "else as a gamma 2.2 PNG); default: out.png")
    ap.add_argument("--spp", type=int, default=None,
                    help="override samples per pixel")
    ap.add_argument("--scale", type=float, default=None,
                    help="resolution scale override")
    ap.add_argument("--quick", action="store_true",
                    help="quick render (quarter res, 1 spp)")
    ap.add_argument("-I", "--include", action="append", default=[],
                    help="additional search path(s)")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    from .io import image as io_img
    from .renderers import manager

    log = (lambda *a, **k: None) if args.quiet else print
    overrides = {}
    if args.quick:
        overrides["quick_render"] = True
    if args.spp is not None:
        overrides["spp"] = args.spp
    if args.scale is not None:
        overrides["resolution_scale"] = args.scale

    t0 = time.time()
    last = [0.0]

    def progress(done, total, film):
        now = time.time()
        if now - last[0] > 2.0 or done == total:
            last[0] = now
            log(f"[{now - t0:7.1f}s] wave {done}/{total}")

    img = manager.render_pbrt(args.scene, search_paths=args.include,
                              overrides=overrides or None,
                              progress=None if args.quiet else progress,
                              device=args.device)
    out = args.output or "out.png"
    io_img.save(out, np.clip(img, 0.0, 1.0))
    log(f"wrote {out} ({img.shape[1]}x{img.shape[0]}) "
        f"in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
