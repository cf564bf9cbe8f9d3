#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, `nvcc` (the traversal kernel is built from
`dartray_tpu_torch/csrc/traverse6.cu` at first use) and no network. It
imports only the port. Phases, each printing one JSON line; any failure
raises and the script exits non-zero:

  env         device name; name and power limit as nvidia-smi reports them
  build       builds and loads the kernel library, prints seconds and the
              assembler's resource report
  kernels     bench scene (~100k triangles): the traversal kernel in its
              three modes (closest / any / mixed) at the main path's shapes
              against the plain PyTorch version on the same tensors on the
              card (finished t/prim agree on >= 0.999 of lanes, any-hit masks
              equal, stack-overflow flag 0); median kernel and plain times
  small_scene Cornell box 32x32: the whole render on the card against the
              same render on the CPU (plain traversal), pixel by pixel
  main_path   bench scene, 512x512, path depth 5, lowdiscrepancy 64 spp
              through renderers.sampler.render_wave on the card; asserts 7
              kernel launches per wave, a finite image and the image mean
              within 1 % of the JAX reference's value for the same scene

Then one line {"kernels": [...]} (per kernel mode: launches counted on the
main path, error against the plain version, times, and the least time the
card could take), the nvidia-smi line again, and as the last line
{"ok": true, "device": {...}}.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dartray_tpu_torch import cameras, samplers
from dartray_tpu_torch import film as film_mod
from dartray_tpu_torch.accel import native
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.core import transform as tr
from dartray_tpu_torch.integrators import path as pi
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.renderers import sampler as rend
from dartray_tpu_torch.scene import build as sb
from dartray_tpu_torch.scene import types as st

# the JAX reference's image mean for the bench scene at 512x512, depth 5,
# 64 spp: a correctness value (what the image must look like), not a speed
REFERENCE_IMG_MEAN = 0.1352919
WIDTH = HEIGHT = 512
SPP = 64
MAX_DEPTH = 5
AGREE_MIN = 0.999          # share of lanes whose finished t and prim agree
T_RTOL = 1e-5              # finished t: both sides finish with the same ops
# H100 SXM data-sheet peaks: HBM bytes/s, f32 FLOP/s outside tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# arithmetic of the walk, counted from the source: one interior pop
# slab-tests 8 boxes (6 sub, 6 mul, 12 min/max, 1 compare each), one
# triangle test is a Moeller-Trumbore evaluation
FLOPS_PER_NODE_POP = 8 * 25
FLOPS_PER_TRI_TEST = 50
KERNEL_SOURCE = "dartray_tpu_torch/csrc/traverse6.cu"
REPLACES = "dartray_tpu/ops/traverse_pallas.py:1150"


def require(ok, what):
    """A failed check ends the run (not an assert: those vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, repeats=5, warmup=1):
    """Median wall time of fn() on the device, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def camera_wave(dev):
    """The first camera wave of the main path: 512x512 rays, Morton order."""
    c2w = tr.look_at([0, 2.2, -5.0], [0, 0.9, 0], [0, 1, 0])
    cam = cameras.perspective(c2w, 42.0, WIDTH, HEIGHT, device=dev)
    smp = samplers.make_sampler("lowdiscrepancy", spp=SPP)
    px, py = rend.pixel_grid(WIDTH, HEIGHT, device=dev)
    cs = samplers.camera_samples(smp, px, py, torch.zeros_like(px))
    rays, _, _ = cameras.generate_rays(cam, cs, WIDTH, HEIGHT)
    return cam, smp, px, py, rays


def random_rays(n, lo, hi, seed, dev):
    """Incoherent rays: origins uniform in the scene bounds, directions
    uniform on the sphere (numpy, from a seed)."""
    rng = np.random.RandomState(seed)
    o = (lo + rng.rand(n, 3) * (hi - lo)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return vm.make_rays(torch.from_numpy(o).to(dev),
                        torch.from_numpy(d).to(dev))


def sort_planes(geom, rays, anyf=None):
    """Order the ray planes as the main path hands them to the kernel."""
    oc, dc = tc._components(rays.o, rays.d)
    key = tc.sort_key_i32(oc, dc, rays.tmin, rays.tmax, geom.world_bound[0],
                          geom.world_bound[1], anyflag=anyf)
    order = torch.sort(key, stable=True).indices
    g = lambda x: x[order].contiguous()
    srt = vm.Rays(vm.V3(*(g(c) for c in oc)), vm.V3(*(g(c) for c in dc)),
                  g(rays.tmin), g(rays.tmax), g(rays.time))
    return srt, (None if anyf is None else g(anyf))


def check_mode(name, geom, rays, any_hit, anyf):
    """Kernel vs plain version on the same device tensors; times of both."""
    bvh = geom.packed
    n = rays.n
    run_k = lambda: tc.traverse6(bvh, rays.o, rays.d, rays.tmin, rays.tmax,
                                 any_hit=any_hit, anyf=anyf)
    stats = {}
    run_p = lambda s=None: tc.traverse6_plain(
        bvh, rays.o, rays.d, rays.tmin, rays.tmax, any_hit=any_hit,
        anyf=anyf, stats=s)
    t_k, p_k = run_k()
    torch.cuda.synchronize()
    t_p, p_p = run_p(stats)
    # compare after the finish step: exact t, original prim ids
    fin = lambda t, p: tc.finish_hits(bvh, geom.perm, rays.o, rays.d,
                                      rays.tmin, t, p)
    ft_k, fp_k, _, _ = fin(t_k, p_k)
    ft_p, fp_p, _, _ = fin(t_p, p_p)
    closest = torch.ones(n, dtype=torch.bool, device=t_k.device) \
        if anyf is None else anyf <= 0
    if any_hit:
        closest = ~closest
    hit_same = (p_k >= 0) == (p_p >= 0)
    both = (p_k >= 0) & (p_p >= 0)
    t_close = torch.isclose(ft_k, ft_p, rtol=T_RTOL, atol=0.0) | ~both
    # any-hit lanes only promise the mask: any blocker will do
    agree = hit_same & ((t_close & (fp_k == fp_p)) | ~closest)
    share = float(agree.float().mean())
    err = torch.where(both & closest, (ft_k - ft_p).abs(),
                      torch.zeros_like(ft_k))
    max_abs_err = float(err.max())
    masks_equal = bool(hit_same[~closest].all())
    require(share >= AGREE_MIN, f"{name}: kernel and plain version agree "
            f"on {share} of lanes")
    require(masks_equal, f"{name}: any-hit masks differ")
    ms = time_ms(run_k, repeats=7, warmup=2)
    plain_ms = time_ms(run_p, repeats=5, warmup=0)
    # the floor: every ray plane read once, (t, prim) written once. What the
    # walk fetches from the tables through L1/L2 depends on the rays and is
    # NOT in the bound; table_bytes (their whole size) is printed beside it
    n_planes = 8 + (1 if anyf is not None else 0)
    table_bytes = sum(x.numel() * x.element_size()
                      for x in (bvh.wbounds, bvh.worder, bvh.soup16))
    bytes_ms = n * (n_planes * 4 + 8) / PEAK_BYTES_S * 1e3
    flops = (stats["node_pops"] * FLOPS_PER_NODE_POP
             + stats["tri_tests"] * FLOPS_PER_TRI_TEST)
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    return {
        "name": f"traverse6:{name}", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES, "launches": 0,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "lanes": n, "agree": share, "hit_share": float((p_k >= 0).float()
                                                       .mean()),
        "node_pops": stats["node_pops"], "tri_tests": stats["tri_tests"],
        "bytes_ms": bytes_ms, "ops_ms": ops_ms, "table_bytes": table_bytes,
    }


def kernels_phase(scene, dev):
    geom = scene.geometry
    wb = geom.world_bound.cpu().numpy()
    n = WIDTH * HEIGHT
    _, _, _, _, cam_rays = camera_wave(dev)
    inc, _ = sort_planes(geom, random_rays(n, wb[0], wb[1], 11, dev))
    # mixed: n extension lanes (closest) + n shadow lanes (any-hit), part of
    # both dead, as a bounce of the path integrator builds them
    ext = random_rays(n, wb[0], wb[1], 12, dev)
    sh = random_rays(n, wb[0], wb[1], 13, dev)
    rng = np.random.RandomState(14)
    dead = torch.from_numpy(rng.rand(2 * n) < 0.3).to(dev)
    cat = lambda a, b: torch.cat([a, b])
    both = vm.Rays(vm.V3(*(cat(a, b) for a, b in zip(ext.o, sh.o))),
                   vm.V3(*(cat(a, b) for a, b in zip(ext.d, sh.d))),
                   cat(ext.tmin, sh.tmin), cat(ext.tmax, sh.tmax),
                   cat(ext.time, sh.time))
    both = both._replace(tmax=torch.where(dead, -1.0, both.tmax))
    af = cat(torch.zeros(n, device=dev), torch.ones(n, device=dev))
    mixed, af_s = sort_planes(geom, both, af)

    tc.reset_overflow(dev)
    results = [
        check_mode("closest", geom, cam_rays, False, None),
        check_mode("closest_incoherent", geom, inc, False, None),
        check_mode("any", geom, inc, True, None),
        check_mode("mixed", geom, mixed, False, af_s),
    ]
    overflow = int(tc.overflow_flag(dev).item())
    require(overflow == 0, "per-ray stack overflow in the kernel")
    say("kernels",
        kernels=["traverse6:closest", "traverse6:any", "traverse6:mixed"],
        overflow=overflow, results=results)
    return results


def small_scene_phase(dev):
    """Cornell box, 32x32, 4 spp, depth 3: card (kernel) vs CPU (plain)."""
    w = h = 32
    host = sb.cornell_box().build()
    ig = pi.PathIntegrator(max_depth=3)
    li = lambda s, r, d, c: pi.li(ig, s, r, d, c)
    c2w = tr.look_at([0, 1, -3.2], [0, 1, 0], [0, 1, 0])
    imgs = {}
    for where in ("cpu", dev):
        cam = cameras.perspective(c2w, 40.0, w, h, device=where)
        smp = samplers.make_sampler("lowdiscrepancy", spp=4)
        imgs[str(where)] = rend.render(host, cam, smp, li, w, h, device=where)
    a, b = imgs["cpu"], imgs[str(dev)]
    close = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(-1).mean()
    rel_mean = abs(a.mean() - b.mean()) / a.mean()
    say("small_scene", pixels_close=float(close), rel_mean=float(rel_mean),
        mean=float(b.mean()))
    # a tie or an ulp at a shared edge may pick another triangle
    require(np.isfinite(b).all(), "small scene: image not finite")
    require(close >= 0.99 and rel_mean < 1e-3,
            f"small scene: card vs CPU {close} close, mean off {rel_mean}")


def main_path_phase(scene, dev):
    cam, smp, px, py, _ = camera_wave(dev)
    ig = pi.PathIntegrator(max_depth=MAX_DEPTH)
    li = lambda s, r, d, c: pi.li(ig, s, r, d, c)
    film = film_mod.make_film(WIDTH, HEIGHT, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc.reset_overflow(dev)
    tc.reset_launches()
    t0 = time.time()
    t_first = None
    with torch.no_grad():
        for s in range(smp.spp):
            film = rend.render_wave(
                scene, cam, smp, film, px, py,
                torch.full(px.shape, s, dtype=torch.int32, device=dev),
                li_fn=li, width=WIDTH, height=HEIGHT, spp=smp.spp,
                device=dev)
            if s == 0:
                torch.cuda.synchronize()
                t_first = time.time() - t0
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(tc.LAUNCHES)
    waves = smp.spp
    img = film_mod.to_rgb(film).cpu().numpy()
    img_mean = float(img.mean())
    overflow = int(tc.overflow_flag(dev).item())
    rays = px.shape[0] * 2 * (MAX_DEPTH + 1) * waves
    say("main_path", waves=waves, seconds=secs, first_wave_seconds=t_first,
        rays_per_s=rays / secs, launches=launches, img_mean=img_mean,
        reference_img_mean=REFERENCE_IMG_MEAN, overflow=overflow,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        tris=scene.geometry.n_prims)
    require(launches == {"closest": waves, "mixed": MAX_DEPTH * waves,
                         "any": waves} and sum(launches.values()) == 7 * waves,
            f"main path: kernel launches {launches}, expected 7 per wave")
    require(overflow == 0, "per-ray stack overflow in the kernel")
    require(img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(img).all(),
            "main path: image not finite or of the wrong shape")
    require(abs(img_mean - REFERENCE_IMG_MEAN) <= 0.01 * REFERENCE_IMG_MEAN,
            f"main path: image mean {img_mean} is not within 1 % of "
            f"{REFERENCE_IMG_MEAN}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    say("env", device=kind, nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda)

    t0 = time.time()
    tc.load_kernel()
    say("build", seconds=time.time() - t0, source=KERNEL_SOURCE,
        flags=tc.NVCC_FLAGS, ptxas=tc.BUILD_LOG)

    t0 = time.time()
    host = sb.bench_scene().build()
    scene = st.to_device(host, dev)
    say("scene", seconds=time.time() - t0, tris=host.geometry.n_prims,
        wide_nodes=host.geometry.packed.n_wnodes,
        clusters=host.geometry.packed.n_clusters,
        bvh_builder=native.LAST_BUILDER)

    results = kernels_phase(scene, dev)
    small_scene_phase(dev)
    launches = main_path_phase(scene, dev)

    # the main path's three launch shapes (its sorted closest-hit lanes
    # travel inside the mixed launches)
    line = [{**r, "launches": launches[r["name"].split(":")[1]]}
            for r in results if r["name"].split(":")[1] in launches]
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
