#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: path-tracing rays/s on one GPU.

    python3 bench_torch.py

The counterpart of ``bench.py``, importing only the port. Scene: the bench
scene (``scene.build.bench_scene``: a ~100k-triangle displaced sphere, a
glass sphere, a matte floor, an area light); path integrator (depth 5, NEE
+ MIS), lowdiscrepancy sampler, 512x512, up to 64 waves of one sample each
through ``renderers.sampler.render_wave`` on the card. ``BENCH_RES``,
``BENCH_SPP`` and ``BENCH_SECONDS`` set the resolution, the sample budget
and the time after which the timed waves stop, as in ``bench.py``.

Rays are counted as ``bench.py`` counts them: every bounce of a wave traces
two full wavefronts (the extension ray and the shadow ray), so a wave is
R * 2 * (depth + 1) rays. The first wave (the kernels' build included) is
timed apart as ``warmup_s``.

Then the gradient probe of ``bench.py``: the gradient of
``(img ** 2).mean()`` of a 96x96, 8 spp render w.r.t. ``materials.kd``
through ``grad.render_loss_grad`` (``grad_probe``, which ``chip_smoke.py``
calls too). Unlike ``bench.py`` a failing probe is not swallowed: it raises
and the script exits non-zero.

Prints ONE JSON line with ``bench.py``'s keys, ``platform`` "gpu". Needs a
CUDA device and raises without one; writes no file (the kernels build into
the git-ignored ``dartray_tpu_torch/_build/``).
"""
import json
import os
import sys
import time

import torch

from dartray_tpu_torch import cameras, grad, samplers
from dartray_tpu_torch import device as device_mod
from dartray_tpu_torch import film as film_mod
from dartray_tpu_torch.core import transform as tr
from dartray_tpu_torch.integrators import path as pi
from dartray_tpu_torch.renderers import sampler as rend
from dartray_tpu_torch.scene import build as sb
from dartray_tpu_torch.scene import types as st

MAX_DEPTH = 5
EYE, LOOK, UP, FOV = [0, 2.2, -5.0], [0, 0.9, 0], [0, 1, 0], 42.0
# bench.py's gradient probe (BENCH_GRAD's default "96:8")
GRAD_RES = 96
GRAD_SPP = 8
GRAD_PATHS = ("materials.kd",)
# the JAX reference's values for this scene (BENCH_r05.json, on the TPU):
# correctness values, not speeds
REFERENCE_IMG_MEAN = 0.1352919
REFERENCE_GRAD_NORM = 0.11520525068044662


def path_li():
    """The bench's path integrator (depth 5) as an ``li_fn``."""
    ig = pi.PathIntegrator(max_depth=MAX_DEPTH)
    return lambda s, r, d, c: pi.li(ig, s, r, d, c)


def grad_probe(scene, dev, res=GRAD_RES, spp=GRAD_SPP):
    """d (img ** 2).mean() / d materials.kd of a res x res, spp-sample
    render of the bench camera, depth 5 (per-bounce remat on, as its rule
    says for depth > 3). Returns (loss, {path: grad}, seconds, grad_norm);
    the seconds end on the norm's read-back."""
    cam = cameras.perspective(tr.look_at(EYE, LOOK, UP), FOV, res, res,
                              device=dev)
    smp = samplers.make_sampler("lowdiscrepancy", spp=spp)
    theta, inject = grad.select(scene, list(GRAD_PATHS))
    torch.cuda.synchronize(dev)
    t0 = time.time()
    val, grads = grad.render_loss_grad(scene, cam, smp, path_li(), res, res,
                                       theta, inject,
                                       lambda img: (img ** 2).mean(), spp=spp,
                                       device=dev)
    norm = float(torch.linalg.norm(grads["materials.kd"]))
    return val, grads, time.time() - t0, norm


def main():
    width = height = int(os.environ.get("BENCH_RES", "512"))
    spp_budget = int(os.environ.get("BENCH_SPP", "64"))
    max_seconds = float(os.environ.get("BENCH_SECONDS", "60"))
    dev = device_mod.resolve("cuda")
    torch.zeros(8, device=dev)          # the CUDA context, before any timing
    torch.cuda.synchronize(dev)

    t0 = time.time()
    host = sb.bench_scene().build()
    build_s = time.time() - t0
    print(f"[bench_torch] scene+bvh build: {build_s:.1f}s", file=sys.stderr,
          flush=True)

    cam = cameras.perspective(tr.look_at(EYE, LOOK, UP), FOV, width, height,
                              device=dev)
    smp = samplers.make_sampler("lowdiscrepancy", spp=spp_budget)
    li = path_li()
    px, py = rend.pixel_grid(width, height, device=dev)

    def step(film, s):
        return rend.render_wave(
            scene, cam, smp, film, px, py,
            torch.full(px.shape, s, dtype=torch.int32, device=dev),
            li_fn=li, width=width, height=height, spp=smp.spp, device=dev)

    with torch.no_grad():
        # warmup: the scene's transfer, the kernels' build, the first wave
        t0 = time.time()
        scene = st.to_device(host, dev)
        film = step(film_mod.make_film(width, height, device=dev), 0)
        torch.cuda.synchronize(dev)
        warmup_s = time.time() - t0
        print(f"[bench_torch] warmup (build + first wave): {warmup_s:.1f}s",
              file=sys.stderr, flush=True)
        done = 1
        t0 = time.time()
        for s in range(1, smp.spp):
            film = step(film, s)
            done += 1
            if s % 4 == 0:
                torch.cuda.synchronize(dev)
                if time.time() - t0 > max_seconds:
                    break
        torch.cuda.synchronize(dev)
        dt = time.time() - t0
        img = film_mod.to_rgb(film).cpu().numpy()
    timed_waves = done - 1
    rays_per_wave = px.shape[0] * 2 * (MAX_DEPTH + 1)
    rays_s = rays_per_wave * timed_waves / max(dt, 1e-9)

    _, _, grad_s, g_norm = grad_probe(scene, dev)
    print(f"[bench_torch] grad probe {GRAD_RES}x{GRAD_RES} spp{GRAD_SPP}: "
          f"{grad_s:.2f}s, |dL/dkd| = {g_norm:.3e}", file=sys.stderr,
          flush=True)

    print(json.dumps({
        "metric": "rays/s/chip (path, %dx%d, depth %d)" % (width, height,
                                                           MAX_DEPTH),
        "value": round(rays_s),
        "unit": "rays/s",
        "vs_baseline": round(rays_s / 1e9, 4),
        "platform": "gpu",
        "tris": host.geometry.n_prims,
        "waves": timed_waves,
        "secs": round(dt, 2),
        "bvh_build_s": round(build_s, 2),
        "warmup_s": round(warmup_s, 2),
        "img_mean": float(img.mean()),
        "grad_s": round(grad_s, 2),
        "grad_norm": g_norm,
    }), flush=True)


if __name__ == "__main__":
    main()
