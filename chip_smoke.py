#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, `nvcc` (the seven traversal kernel libraries are
built from `dartray_tpu_torch/csrc/*.cu` at first use, all `nvcc` runs started
together) and no network. It imports only the port. Phases, each printing one
JSON line; any failure raises and the script exits non-zero:

  env          device name; name and power limit as nvidia-smi reports them
  build        builds and loads every kernel library; seconds and the
               assembler's resource report for each source
  scene        the bench scene (~100k triangles), static and with its big
               sphere translating over the shutter
  kernels      every kernel at the main paths' shapes against its plain
               PyTorch version on the same tensors on the card (finished
               t/prim agree on >= 0.999 of lanes, any-hit masks equal,
               stack-overflow flag 0); median kernel and plain times:
               v6 closest / any / mixed on the static scene and its motion
               mode closest / any / mixed on the moving scene (raw (t, prim)
               EQUAL to the plain version's on every lane), the v5 and v7
               packet walks on the camera wave (closest) and on sorted
               incoherent rays (any): raw (t, prim) and their counters
               EQUAL to the plain version's, and the four walks over the
               binary tree (v1-v4) on the same two ray sets: raw (t, prim)
               and v3's counters EQUAL to the plain version's, hit masks
               equal to v6's on the same rays
  small_scene  Cornell box 32x32: the whole render on the card against the
               same render on the CPU (plain traversal), pixel by pixel
  motion_small the same with one sphere translating: card against CPU, and
               the zero-delta scene against the static scene on the card
  main_path    bench scene, 512x512, path depth 5, lowdiscrepancy 64 spp
               through renderers.sampler.render_wave on the card; asserts 7
               launches of the static v6 kernel per wave and of no other, a
               finite image and the image mean within 1 % of the JAX
               reference's value for the same scene
  motion_path  the moving bench scene through the same path: 7 launches of
               the motion kernel per wave and of no other, a finite image
               that differs from the static one
  alt_kernels  the Cornell render with DEFAULT_KERNEL's camera wave routed
               to v5 and then to v7, against the v6 render
  alt_path     the packet kernels' path at full width: a few waves of the
               bench scene at 512x512 through render_wave with the camera
               wave routed to v5 and then to v7 (1 packet launch + 6 v6
               launches a wave, image mean within 1 % of the v6 render's),
               and one any-hit call each of intersect_rays(kernel=) on
               sorted incoherent rays, masks against v6's
  attic_small  the Cornell box through the direct-lighting integrator, with
               DEFAULT_KERNEL as it is and then with every kind of wave
               routed to v1, v2, v3 and v4: each image against the v6 image
  direct_path  the direct-lighting integrator at full width: the bench scene,
               512x512, strategy ALL, depth 5, 64 spp: 18 launches a wave
               (6 levels of closest, any, closest), all of the v6 kernel; the
               path image's mean must exceed this image's
  attic_path   a few waves of the same render for each of v1-v4 set in
               DEFAULT_KERNEL: every launch of that kernel, image against
               direct_path's first waves
  ao_path      a few waves of the ambient-occlusion integrator with 64 probes
               (n_samples + 1 launches a wave; the default of 2,048 probes is
               2,049 launches a wave and belongs to no smoke run)
  whitted_path a few waves of the Whitted integrator, depth 5

Then one line {"kernels": [...]} (per kernel and mode: launches counted on
its path, error against the plain version, times, the least time the card
could take, and the registers and spill bytes ptxas gave its kernel
function), the nvidia-smi line again, and as the last line
{"ok": true, "device": {...}}.
"""
import dataclasses
import json
import os
import re
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
from dartray_tpu_torch.integrators import ao as ao_mod
from dartray_tpu_torch.integrators import direct as di
from dartray_tpu_torch.integrators import path as pi
from dartray_tpu_torch.integrators import whitted as wh
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
SMALL = 32                 # the Cornell renders: SMALL x SMALL pixels,
SMALL_SPP = 4              # SMALL_SPP samples (one wave each), depth 3
ALT_WAVES = 4              # waves of the bench scene per packet kernel
ATTIC_WAVES = 4            # ... per binary-tree kernel, and of AO and Whitted
AO_SAMPLES = 64            # probes a wave of ao_path
SAME_MIN = 0.999           # share of pixels two renders of one scene share
AGREE_MIN = 0.999          # share of lanes whose finished t and prim agree
T_RTOL = 1e-5              # finished t: both sides finish with the same ops
# H100 SXM data-sheet peaks: HBM bytes/s, f32 FLOP/s outside tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# arithmetic of the walks, counted from the sources: one interior pop
# slab-tests 8 boxes (6 sub, 6 mul, 12 min/max, 1 compare each), one
# Moeller-Trumbore test (ray_tests.cuh), the motion lerp of its 9 inputs
# (a multiply and an add each), one Woop test (traverse7.cu: 20 mul, 18 add,
# 1 divide, 1 negate, 5 compares)
FLOPS_PER_NODE_POP = 8 * 25
FLOPS_PER_TRI_TEST = 50
FLOPS_PER_LERP = 18
FLOPS_PER_WOOP_TEST = 45
CSRC = "dartray_tpu_torch/csrc/"
# kernel -> (source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "traverse6": (CSRC + "traverse6.cu",
                  "dartray_tpu/ops/traverse_pallas.py:1150"),
    "traverse6_motion": (CSRC + "traverse6.cu",
                         "dartray_tpu/ops/traverse_pallas.py:1150"),
    "traverse5": (CSRC + "traverse5.cu",
                  "dartray_tpu/ops/traverse_pallas.py:521"),
    "traverse7": (CSRC + "traverse7.cu",
                  "dartray_tpu/ops/kernels_attic.py:1169"),
    "traverse1": (CSRC + "traverse1.cu",
                  "dartray_tpu/ops/kernels_attic.py:197"),
    "traverse2": (CSRC + "traverse2.cu",
                  "dartray_tpu/ops/kernels_attic.py:890"),
    "traverse3": (CSRC + "traverse3.cu",
                  "dartray_tpu/ops/kernels_attic.py:843"),
    "traverse4": (CSRC + "traverse4.cu",
                  "dartray_tpu/ops/kernels_attic.py:438"),
}
# the binary-tree kernels: library -> (name in DEFAULT_KERNEL, wrapper, plain)
ATTIC = {
    "traverse1": ("v1", tc.traverse, tc.traverse_plain),
    "traverse2": ("v2", tc.traverse2, tc.traverse2_plain),
    "traverse3": ("v3", tc.traverse3, tc.traverse3_plain),
    "traverse4": ("v4", tc.traverse4, tc.traverse4_plain),
}
MOTION_SHIFT = [0.6, 0.0, 0.0]     # the big sphere's travel over the shutter


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


def ptxas_resources(kern):
    """Registers and spill bytes (stores) of the kernel function behind
    `kern`, from the assembler's report of its library's build (nvcc runs
    with -Xptxas -v). traverse6.cu holds two: the motion instantiation is
    the one with ``ILb1E`` in its name."""
    lib = "traverse6" if kern.startswith("traverse6") else kern
    found = {}
    fn = None
    for line in tc.BUILD_LOG.get(lib, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            found[fn] = {"regs": None, "spill_bytes": 0}
        elif fn is not None:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                found[fn]["regs"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                found[fn]["spill_bytes"] = int(m.group(1))
    if lib == "traverse6":
        found = {f: v for f, v in found.items()
                 if ("ILb1E" in f) == (kern == "traverse6_motion")}
    require(len(found) == 1, f"{kern}: the build log names {sorted(found)}")
    return next(iter(found.values()))


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
    uniform on the sphere, times uniform in [0, 1] (numpy, from a seed)."""
    rng = np.random.RandomState(seed)
    o = (lo + rng.rand(n, 3) * (hi - lo)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return vm.make_rays(torch.from_numpy(o).to(dev),
                        torch.from_numpy(d).to(dev),
                        time=seeded_times(n, seed + 100, dev))


def seeded_times(n, seed, dev):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(n).astype(np.float32)).to(dev)


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


def check_kernel(kern, mode, geom, rays, anyf=None, label=None, need=None):
    """One kernel in one mode against its plain version on the same device
    tensors, after the finish step; times of both; the bound.

    need: the node pops and triangle tests the FUNCTION needs on these rays,
    where they are not the plain version's own counts. A packet walk does
    redundant work (every live lane tests every node and leaf any lane of its
    packet reaches), so the packet kernels' bound takes the per-ray walk's
    counts on the same rays, and their own are printed beside it.

    Every kernel must give its plain version's raw (t, prim) on EVERY lane:
    the packet walks (v5, v7 and the binary-tree kernels of ``ATTIC``) and
    their counters (v5, v7 in a call of their own, which is not timed; v3
    in every call), since kernel and plain version share the tables, the
    packet, the order of pops and the fold; and the per-ray walk (v6,
    static and motion), any-hit lanes included, since every ray pops its
    own stack in the plain version's order, whichever lanes of its warp do
    the arithmetic."""
    bvh = geom.packed
    n = rays.n
    any_hit = mode == "any"
    name = f"{kern}:{label or mode}"
    kw = {"any_hit": any_hit}
    time = None
    tri_flops = FLOPS_PER_TRI_TEST
    if kern in ("traverse6", "traverse6_motion"):
        fn, plain = tc.traverse6, tc.traverse6_plain
        kw["anyf"] = anyf
        if kern == "traverse6_motion":
            kw["time"] = time = rays.time
            tri_flops += FLOPS_PER_LERP
    elif kern in ATTIC:
        _, fn, plain = ATTIC[kern]
        if kern == "traverse3":
            kw["counters"] = True
    else:
        fn, plain = getattr(tc, kern), getattr(tc, kern + "_plain")
        if kern == "traverse7":
            tri_flops = FLOPS_PER_WOOP_TEST
    args = (bvh, rays.o, rays.d, rays.tmin, rays.tmax)
    run_k = lambda: fn(*args, **kw)
    run_p = lambda s=None: plain(*args, **kw, stats=s)
    stats = {}
    before = dict(tc.LAUNCHES)
    t_k, p_k, *cnt_k = run_k()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in tc.LAUNCHES.items()
                if v != before[k]}
    require(launched == {f"{kern}:{mode}": 1},
            f"{name}: the wrapper counted {launched}")
    t_p, p_p, *cnt_p = run_p(stats)
    extra = {}
    require(torch.equal(t_k, t_p) and torch.equal(p_k, p_p),
            f"{name}: raw (t, prim) differs from the plain version's")
    if kern in ("traverse5", "traverse7"):
        cnt_k = [fn(*args, **kw, counters=True)[2]]
        cnt_p = [plain(*args, **kw, counters=True)[2]]
    if cnt_k:
        require(torch.equal(cnt_k[0], cnt_p[0]),
                f"{name}: counters differ from the plain version's")
        extra = {"packets": cnt_k[0].shape[0],
                 "node_steps": int(cnt_k[0][:, 0].sum()),
                 "leaf_rounds": int(cnt_k[0][:, 1].sum())}
    # compare after the finish step: exact t, original prim ids
    fin = lambda t, p: tc.finish_hits(bvh, geom.perm, rays.o, rays.d,
                                      rays.tmin, t, p, time=time)
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
    # `ms` is one launch through the wrapper between two events, so it holds
    # the host's time to enqueue it, which a short kernel does not hide;
    # beside it, the device's time a launch with 20 queued back to back
    ms_queued = time_ms(lambda: [run_k() for _ in range(20)], repeats=3,
                        warmup=1) / 20
    # the packet walks' plain versions take seconds: fewer repeats
    plain_ms = time_ms(run_p, warmup=0, repeats=5 if kern.startswith(
        "traverse6") else (1 if kern in ATTIC else 3))
    # the floor: every ray plane read once, (t, prim) written once. What the
    # walk fetches from the tables through L1/L2 depends on the rays and is
    # NOT in the bound; table_bytes (their whole size) is printed beside it
    n_planes = 8 + (anyf is not None) + (time is not None)
    if kern in ATTIC:
        tables = [bvh.bounds, bvh.meta2 if tc.ATTIC[kern]["compact"]
                  else bvh.meta, bvh.soup16]
    else:
        tables = [bvh.wbounds, bvh.worder,
                  bvh.woop if kern == "traverse7" else bvh.soup16]
    if time is not None:
        tables.append(bvh.soup16d)
    table_bytes = sum(x.numel() * x.element_size() for x in tables)
    bytes_ms = n * (n_planes * 4 + 8) / PEAK_BYTES_S * 1e3
    need = need or stats
    flops = (need["node_pops"] * FLOPS_PER_NODE_POP
             + need["tri_tests"] * tri_flops)
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    source, replaces = KERNELS[kern]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "ms_queued": ms_queued,
        "counter": f"{kern}:{mode}", "lanes": n, "agree": share,
        "hit_share": float((p_k >= 0).float().mean()),
        "node_pops": need["node_pops"], "tri_tests": need["tri_tests"],
        **({} if need is stats else {
            "packet_node_pops": stats["node_pops"],
            "packet_tri_tests": stats["tri_tests"]}),
        "bytes_ms": bytes_ms, "ops_ms": ops_ms, "table_bytes": table_bytes,
        **extra,
    }, p_k, ft_k


def wave_shapes(geom, dev, cam_rays):
    """The three launch shapes of the main path on `geom`: the unsorted
    camera wave, sorted incoherent rays, and a sorted mixed wave of n
    extension lanes (closest) + n shadow lanes (any-hit), part of both dead,
    as a bounce of the path integrator builds them."""
    wb = geom.world_bound.cpu().numpy()
    n = WIDTH * HEIGHT
    inc, _ = sort_planes(geom, random_rays(n, wb[0], wb[1], 11, dev))
    ext = random_rays(n, wb[0], wb[1], 12, dev)
    sh = random_rays(n, wb[0], wb[1], 13, dev)
    rng = np.random.RandomState(14)
    dead = torch.from_numpy(rng.rand(2 * n) < 0.3).to(dev)
    cat = lambda a, b: torch.cat([a, b])
    both = vm.Rays(vm.V3(*(cat(a, b) for a, b in zip(ext.o, sh.o))),
                   vm.V3(*(cat(a, b) for a, b in zip(ext.d, sh.d))),
                   cat(ext.tmin, sh.tmin), cat(ext.tmax, sh.tmax),
                   cat(ext.time, ext.time))   # a shadow lane carries its
    #                                           surface ray's time
    both = both._replace(tmax=torch.where(dead, -1.0, both.tmax))
    af = cat(torch.zeros(n, device=dev), torch.ones(n, device=dev))
    mixed, af_s = sort_planes(geom, both, af)
    cam = cam_rays._replace(time=seeded_times(n, 15, dev))
    return cam, inc, mixed, af_s


def kernels_phase(geom, geom_w, shapes, moving, cam_rays, dev):
    """geom: the static bench scene; geom_w: the same with the Woop table;
    shapes: its ``wave_shapes``; moving: the moving bench scene."""
    cam, inc, mixed, af_s = shapes
    tc.reset_overflow(dev)
    results = []
    hits, finished = {}, {}

    def run(kern, mode, g, rays, anyf=None, label=None, need=None):
        r, p_k, ft_k = check_kernel(kern, mode, g, rays, anyf, label, need)
        results.append(r)
        hits[r["name"]] = p_k >= 0
        finished[r["name"]] = ft_k
        return {k: r[k] for k in ("node_pops", "tri_tests")}

    per_ray = {"closest": run("traverse6", "closest", geom, cam)}
    run("traverse6", "closest", geom, inc, label="closest_incoherent")
    per_ray["any"] = run("traverse6", "any", geom, inc)
    run("traverse6", "mixed", geom, mixed, af_s)
    # the same two ray sets over the same tree: the packet kernels are
    # bounded by what the per-ray walk needed there
    for kern in ("traverse5", "traverse7"):
        run(kern, "closest", geom_w, cam, need=per_ray["closest"])
        run(kern, "any", geom_w, inc, need=per_ray["any"])
    # the four walks over the BINARY tree, on the same two ray sets, bounded
    # like the packet walks by what the per-ray walk needed there. Against v6
    # after the finish step: hit masks EQUAL; closest-hit t within T_RTOL on
    # all lanes but those where the packed fold (t rounded down by up to 127
    # ulps, 1.5e-5) took a triangle of a near tie that v6 did not
    attic_vs_v6 = {}
    for kern in ATTIC:
        run(kern, "closest", geom, cam, need=per_ray["closest"])
        run(kern, "any", geom, inc, need=per_ray["any"])
        for mode in ("closest", "any"):
            same = hits[f"{kern}:{mode}"] == hits[f"traverse6:{mode}"]
            require(bool(same.all()), f"{kern}:{mode}: hit mask differs "
                    f"from v6's on {int((~same).sum())} lanes")
        hit = hits[f"{kern}:closest"]
        t_a, t_6 = finished[f"{kern}:closest"], finished["traverse6:closest"]
        close = torch.isclose(t_a, t_6, rtol=T_RTOL, atol=0.0) | ~hit
        share = float(close.float().mean())
        require(share >= AGREE_MIN, f"{kern}:closest: finished t agrees "
                f"with v6's on {share} of lanes")
        attic_vs_v6[kern] = {
            "masks_equal": True, "t_close_share": share,
            "t_max_rel_diff": float(((t_a - t_6).abs() / t_6)[hit].max())}
    # the Woop test rounds differently from Moeller-Trumbore and may miss
    # sliver triangles: printed beside v6 on the same rays, not required equal
    v7_vs_v6 = {
        mode: {"v6_hit_share": float(hits[f"traverse6:{mode}"].float().mean()),
               "v7_hit_share": float(hits[f"traverse7:{mode}"].float().mean()),
               "masks_agree": float((hits[f"traverse6:{mode}"]
                                     == hits[f"traverse7:{mode}"])
                                    .float().mean())}
        for mode in ("closest", "any")}
    # what the motion mode costs by itself: the SAME rays over the SAME tree
    # with an all-zero delta table (v + t * 0 == v, so the same walk and,
    # required here, the same result), against the static kernel's time
    zero = dataclasses.replace(geom.packed, soup16d=torch.zeros_like(
        geom.packed.soup16))
    lerp_cost = {}
    for mode, rays, anyf in (("closest", cam, None), ("any", inc, None),
                             ("mixed", mixed, af_s)):
        args = (rays.o, rays.d, rays.tmin, rays.tmax)
        kw = dict(any_hit=mode == "any", anyf=anyf)
        still = tc.traverse6(geom.packed, *args, **kw)
        lerped = tc.traverse6(zero, *args, **kw, time=rays.time)
        require(all(torch.equal(a, b) for a, b in zip(still, lerped)),
                f"zero deltas, {mode}: the motion kernel's result differs "
                "from the static kernel's")
        lerp_cost[mode] = {
            "static_ms": time_ms(lambda: tc.traverse6(geom.packed, *args,
                                                      **kw), 7, 2),
            "zero_delta_motion_ms": time_ms(lambda: tc.traverse6(
                zero, *args, **kw, time=rays.time), 7, 2)}
    gm = moving.geometry
    cam_m, inc_m, mixed_m, af_m = wave_shapes(gm, dev, cam_rays)
    run("traverse6_motion", "closest", gm, cam_m)
    run("traverse6_motion", "any", gm, inc_m)
    run("traverse6_motion", "mixed", gm, mixed_m, af_m)
    overflow = int(tc.overflow_flag(dev).item())
    require(overflow == 0, "stack overflow in a kernel")
    say("kernels", kernels=[r["name"] for r in results], overflow=overflow,
        v7_vs_v6=v7_vs_v6, attic_vs_v6=attic_vs_v6,
        packet_lanes={k: v["packet"] for k, v in tc.ATTIC.items()},
        lerp_cost_same_tree_same_rays=lerp_cost, results=results)
    return results


def cornell(shift=None):
    """Host Cornell box; with `shift` its matte sphere translates by it."""
    b = sb.cornell_box()
    if shift is not None:
        sphere = b.meshes[-2]
        sphere.verts_end = sphere.verts + np.asarray(shift, np.float32)
    return b.build()


def render_small(host, where):
    """Cornell box, 32x32, SMALL_SPP spp, depth 3, on `where`."""
    w = h = SMALL
    ig = pi.PathIntegrator(max_depth=3)
    li = lambda s, r, d, c: pi.li(ig, s, r, d, c)
    c2w = tr.look_at([0, 1, -3.2], [0, 1, 0], [0, 1, 0])
    cam = cameras.perspective(c2w, 40.0, w, h, device=where)
    smp = samplers.make_sampler("lowdiscrepancy", spp=SMALL_SPP)
    return rend.render(host, cam, smp, li, w, h, device=where)


def compare_images(what, a, b):
    """Share of pixels within rtol 1e-3 / atol 1e-4 and the means' distance;
    a tie or an ulp at a shared edge may pick another triangle."""
    close = float(np.isclose(a, b, rtol=1e-3, atol=1e-4).all(-1).mean())
    rel_mean = float(abs(a.mean() - b.mean()) / a.mean())
    require(np.isfinite(b).all(), f"{what}: image not finite")
    require(close >= 0.99 and rel_mean < 1e-3,
            f"{what}: {close} of pixels close, mean off {rel_mean}")
    return close, rel_mean


def small_scene_phase(dev):
    """Cornell box: card (kernel) vs CPU (plain version)."""
    host = cornell()
    a, b = render_small(host, "cpu"), render_small(host, dev)
    close, rel_mean = compare_images("small scene, card vs CPU", a, b)
    say("small_scene", pixels_close=close, rel_mean=rel_mean,
        mean=float(b.mean()))
    return b


def motion_small_phase(dev, static_img):
    """Cornell box with one sphere translating: card (motion kernel) vs CPU
    (plain version); and the zero-delta scene on the card against the static
    scene on the card. ``v + t * 0 == v`` bit for bit, so both kernels must
    return the same hits; the images agree to rounding only, because a moving
    scene takes its hit point from the ray (o + t d) and a static one from
    the barycentrics, as the reference does."""
    host = cornell([0.5, 0.0, 0.0])
    a, b = render_small(host, "cpu"), render_small(host, dev)
    close, rel_mean = compare_images("moving small scene, card vs CPU", a, b)
    require(not np.allclose(b, static_img, rtol=1e-3, atol=1e-4),
            "moving small scene: image equals the static one")
    zero = render_small(cornell([0.0, 0.0, 0.0]), dev)
    z_close, z_rel = compare_images("zero-delta scene vs static scene",
                                    static_img, zero)
    # the traversal itself must be EQUAL: one camera wave through both
    gz = st.to_device(cornell([0.0, 0.0, 0.0]), dev).geometry
    gs = st.to_device(cornell(), dev).geometry
    cam = cameras.perspective(tr.look_at([0, 1, -3.2], [0, 1, 0], [0, 1, 0]),
                              40.0, SMALL, SMALL, device=dev)
    smp = samplers.make_sampler("lowdiscrepancy", spp=SMALL_SPP)
    px, py = rend.pixel_grid(SMALL, SMALL, device=dev)
    rays, _, _ = cameras.generate_rays(
        cam, samplers.camera_samples(smp, px, py, torch.zeros_like(px)),
        SMALL, SMALL)
    hz, hs = st.intersect(gz, rays), st.intersect(gs, rays)
    hits_equal = all(torch.equal(x, y) for x, y in zip(hz[:4], hs[:4]))
    require(hits_equal, "zero-delta scene: the motion kernel's hits differ "
            "from the static kernel's")
    say("motion_small", pixels_close=close, rel_mean=rel_mean,
        mean=float(b.mean()), static_mean=float(static_img.mean()),
        zero_delta_hits_equal=hits_equal, zero_delta_pixels_close=z_close,
        zero_delta_images_equal=bool(np.array_equal(zero, static_img)),
        zero_delta_max_abs_diff=float(np.abs(zero - static_img).max()))


def alt_kernels_phase(dev, v6_img):
    """The Cornell render with the camera wave (the unsorted closest-hit
    wave, ``closest_coherent``) routed to v5 and then to v7."""
    host = cornell()
    host = dataclasses.replace(host, geometry=dataclasses.replace(
        host.geometry, packed=tc.with_woop(host.geometry.packed)))
    saved = tc.DEFAULT_KERNEL["closest_coherent"]
    out = {}
    try:
        for which, kern in (("v5", "traverse5"), ("v7", "traverse7")):
            tc.DEFAULT_KERNEL["closest_coherent"] = which
            tc.reset_launches()
            img = render_small(host, dev)
            n = tc.LAUNCHES[f"{kern}:closest"]
            require(n == SMALL_SPP and tc.LAUNCHES["traverse6:closest"] == 0,
                    f"alt kernels: {which} launched {n} times in "
                    f"{SMALL_SPP} waves")
            close, rel_mean = compare_images(f"{which} render vs v6 render",
                                             v6_img, img)
            out[which] = {"pixels_close": close, "rel_mean": rel_mean,
                          "launches": n}
    finally:
        tc.DEFAULT_KERNEL["closest_coherent"] = saved
    say("alt_kernels", **out)


def drive_waves(phase, scene, dev, li, waves, want, snapshot_at=None):
    """`waves` waves of the integrator `li` over `scene` through
    render_wave, every count set to 0 just before and read just after;
    requires the launches `want` (counter -> launches a wave) and no other, a
    finite image and no stack overflow. Rays are counted as launches times
    the lanes of a wave. snapshot_at: also return the image after that many
    waves."""
    cam, smp, px, py, _ = camera_wave(dev)
    film = film_mod.make_film(WIDTH, HEIGHT, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc.reset_overflow(dev)
    tc.reset_launches()
    t0 = time.time()
    t_first = snap = None
    with torch.no_grad():
        for s in range(waves):
            film = rend.render_wave(
                scene, cam, smp, film, px, py,
                torch.full(px.shape, s, dtype=torch.int32, device=dev),
                li_fn=li, width=WIDTH, height=HEIGHT, spp=smp.spp,
                device=dev)
            if s == 0:
                torch.cuda.synchronize()
                t_first = time.time() - t0
            if s + 1 == snapshot_at:
                snap = film_mod.to_rgb(film).cpu().numpy()
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(tc.LAUNCHES)
    img = film_mod.to_rgb(film).cpu().numpy()
    overflow = int(tc.overflow_flag(dev).item())
    n_launches = sum(launches.values())
    info = dict(waves=waves, seconds=secs, first_wave_seconds=t_first,
                launches={k: v for k, v in launches.items() if v},
                launches_per_wave=n_launches / waves,
                launched_rays_per_s=n_launches * px.shape[0] / secs,
                img_mean=float(img.mean()), overflow=overflow,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                tris=scene.geometry.n_prims)
    want = {k: v * waves for k, v in want.items()}
    require(info["launches"] == want,
            f"{phase}: kernel launches {info['launches']}, expected {want}")
    require(overflow == 0, f"{phase}: stack overflow in the kernel")
    require(img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(img).all(),
            f"{phase}: image not finite or of the wrong shape")
    return launches, img, info, snap


def drive_path(phase, scene, dev, kern, camera_kern=None, waves=None):
    """`waves` waves (default: all 64) of the path integrator over `scene`;
    requires 7 launches of `kern` per wave and of no other kernel, or, with
    `camera_kern`, 1 closest-hit launch of that and the other 6 of `kern`."""
    ig = pi.PathIntegrator(max_depth=MAX_DEPTH)
    launches, img, info, _ = drive_waves(
        phase, scene, dev, lambda s, r, d, c: pi.li(ig, s, r, d, c),
        waves or SPP, {f"{camera_kern or kern}:closest": 1,
                       f"{kern}:mixed": MAX_DEPTH, f"{kern}:any": 1})
    # as the reference's benchmark counts them: two rays a lane and level
    info["rays_per_s"] = (WIDTH * HEIGHT * 2 * (MAX_DEPTH + 1) * info["waves"]
                          / info["seconds"])
    return launches, img, info


def main_path_phase(scene, dev):
    launches, img, info = drive_path("main_path", scene, dev, "traverse6")
    say("main_path", reference_img_mean=REFERENCE_IMG_MEAN, **info)
    require(abs(info["img_mean"] - REFERENCE_IMG_MEAN)
            <= 0.01 * REFERENCE_IMG_MEAN,
            f"main path: image mean {info['img_mean']} is not within 1 % of "
            f"{REFERENCE_IMG_MEAN}")
    return launches, img


def motion_path_phase(moving, dev, static_img):
    """This slice's path at full width: the moving bench scene. No reference
    mean is stated: the JAX package has none for this scene."""
    launches, img, info = drive_path("motion_path", moving, dev,
                                     "traverse6_motion")
    differs = float((~np.isclose(img, static_img, rtol=1e-3, atol=1e-4)
                     .all(-1)).mean())
    say("motion_path", static_img_mean=float(static_img.mean()),
        pixels_that_differ_from_static=differs, shift=MOTION_SHIFT, **info)
    require(differs > 0.01, "motion path: the image equals the static one")
    return launches


def alt_path_phase(scene_w, dev, inc):
    """The packet kernels' path at full width. A few waves of the bench
    scene (packed with the Woop table) with ``closest_coherent`` routed to v5
    and then to v7, against the same waves through v6; then the any-hit side
    of ``intersect_rays(kernel=...)``, one call each on the sorted incoherent
    rays, masks against v6's (v5 runs the same triangle test, so EQUAL; the
    Woop test may miss a sliver, so v7's share is printed and held to 0.99).
    Returns the launches of the packet kernels, each run counted from 0."""
    saved = tc.DEFAULT_KERNEL["closest_coherent"]
    _, v6_img, v6_info = drive_path("alt_path v6", scene_w, dev, "traverse6",
                                    waves=ALT_WAVES)
    out = {"v6": {"img_mean": v6_info["img_mean"],
                  "seconds": v6_info["seconds"]}}
    counted = {}
    geom = scene_w.geometry
    lo, hi = geom.world_bound[0], geom.world_bound[1]
    hit = {}
    try:
        for which, kern in (("v6", "traverse6"), ("v5", "traverse5"),
                            ("v7", "traverse7")):
            if which != "v6":
                tc.DEFAULT_KERNEL["closest_coherent"] = which
                launches, img, info = drive_path(
                    f"alt_path {which}", scene_w, dev, "traverse6",
                    camera_kern=kern, waves=ALT_WAVES)
                counted[f"{kern}:closest"] = launches[f"{kern}:closest"]
                rel = abs(info["img_mean"] - v6_info["img_mean"]) \
                    / v6_info["img_mean"]
                require(rel <= 0.01, f"alt path: {which} image mean "
                        f"{info['img_mean']} against v6's "
                        f"{v6_info['img_mean']}")
                out[which] = {
                    "img_mean": info["img_mean"], "rel_mean": rel,
                    "pixels_close": float(np.isclose(
                        img, v6_img, rtol=1e-3, atol=1e-4).all(-1).mean()),
                    "launches": info["launches"],
                    "seconds": info["seconds"]}
            tc.reset_launches()
            t, prim, _, _ = tc.intersect_rays(
                geom.packed, geom.perm, lo, hi, inc.o, inc.d, inc.tmin,
                inc.tmax, any_hit=True, sort=True, kernel=which)
            torch.cuda.synchronize()
            hit[which] = prim >= 0
            require(bool(torch.isfinite(t[hit[which]]).all()),
                    f"intersect_rays(kernel={which!r}): t not finite")
            require(tc.LAUNCHES[f"{kern}:any"] == 1,
                    f"intersect_rays(kernel={which!r}, any_hit=True) "
                    f"counted {dict(tc.LAUNCHES)}")
            if which != "v6":
                counted[f"{kern}:any"] = tc.LAUNCHES[f"{kern}:any"]
                out[which]["any_masks_agree_with_v6"] = float(
                    (hit[which] == hit["v6"]).float().mean())
    finally:
        tc.DEFAULT_KERNEL["closest_coherent"] = saved
    require(out["v5"]["any_masks_agree_with_v6"] == 1.0,
            "alt path: v5's any-hit mask differs from v6's")
    require(out["v7"]["any_masks_agree_with_v6"] >= 0.99,
            "alt path: v7's any-hit mask agrees with v6's on "
            f"{out['v7']['any_masks_agree_with_v6']} of lanes")
    say("alt_path", waves=ALT_WAVES, **out)
    return counted


def direct_li(strategy=di.STRATEGY_ALL, depth=MAX_DEPTH):
    ig = di.DirectLightingIntegrator(strategy=strategy, max_depth=depth)
    return lambda s, r, d, c: di.li(ig, s, r, d, c)


def same_image(what, ref, img, mean_tol=None):
    """Two renders of one scene that differ only in the traversal kernel:
    >= SAME_MIN of pixels within rtol 1e-3 / atol 1e-4 and, where asked, the
    means within `mean_tol`. A near tie may go to another triangle: the
    strict fold keeps the first of equal t, the packed fold the lower slot of
    any two t within 127 ulps."""
    close = float(np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(-1).mean())
    rel_mean = float(abs(img.mean() - ref.mean()) / ref.mean())
    require(close >= SAME_MIN
            and (mean_tol is None or rel_mean <= mean_tol),
            f"{what}: {close} of pixels close, mean off {rel_mean}")
    return {"pixels_close": close, "rel_mean": rel_mean}


class default_kernel:
    """``with default_kernel("v3"):`` routes every kind of wave to one
    kernel and puts ``DEFAULT_KERNEL`` back on the way out."""

    def __init__(self, which):
        self.which = which

    def __enter__(self):
        self.saved = dict(tc.DEFAULT_KERNEL)
        tc.DEFAULT_KERNEL.update({k: self.which for k in tc.DEFAULT_KERNEL})

    def __exit__(self, *exc):
        tc.DEFAULT_KERNEL.update(self.saved)


def attic_small_phase(dev):
    """The Cornell box through the direct-lighting integrator (32x32, depth
    3): on the card against the CPU with the default kernels, then every
    kind of wave routed to each binary-tree kernel against the v6 image."""
    host = cornell()
    w = h = SMALL

    def render(where):
        cam = cameras.perspective(
            tr.look_at([0, 1, -3.2], [0, 1, 0], [0, 1, 0]), 40.0, w, h,
            device=where)
        smp = samplers.make_sampler("lowdiscrepancy", spp=SMALL_SPP)
        return rend.render(host, cam, smp, direct_li(depth=3), w, h,
                           device=where)

    tc.reset_launches()
    v6_img = render(dev)
    per_wave = {"traverse6:closest": 8, "traverse6:any": 4}
    require({k: v for k, v in tc.LAUNCHES.items() if v}
            == {k: v * SMALL_SPP for k, v in per_wave.items()},
            f"attic small: default kernels launched {dict(tc.LAUNCHES)}")
    close, rel_mean = compare_images("direct lighting, card vs CPU",
                                     render("cpu"), v6_img)
    out = {"v6": {"pixels_close_to_cpu": close, "rel_mean_to_cpu": rel_mean,
                  "mean": float(v6_img.mean())}}
    for kern, (which, _, _) in ATTIC.items():
        with default_kernel(which):
            tc.reset_launches()
            img = render(dev)
        launched = {k: v for k, v in tc.LAUNCHES.items() if v}
        require(launched == {f"{kern}:closest": 8 * SMALL_SPP,
                             f"{kern}:any": 4 * SMALL_SPP},
                f"attic small: {which} launched {launched}")
        out[which] = same_image(f"{which} render vs v6 render", v6_img, img,
                                mean_tol=1e-4)
    require(tc.DEFAULT_KERNEL == dict(closest_coherent="v6", closest="v6",
                                      any="v6"),
            "attic small: DEFAULT_KERNEL was not restored")
    say("attic_small", **out)


def direct_path_phase(scene, dev, path_img):
    """This slice's path at full width. A level is one closest-hit wave and,
    for the scene's one light, estimate_direct's any-hit shadow wave and
    closest-hit BSDF wave: 18 launches a wave at depth 5. The JAX package
    states no mean for this image; what is held is its own relation, that
    the path image (indirect light added) is brighter."""
    launches, img, info, first = drive_waves(
        "direct_path", scene, dev, direct_li(), SPP,
        {"traverse6:closest": 2 * (MAX_DEPTH + 1),
         "traverse6:any": MAX_DEPTH + 1}, snapshot_at=ATTIC_WAVES)
    say("direct_path", path_img_mean=float(path_img.mean()), **info)
    require(path_img.mean() > img.mean() > 0,
            f"direct path: image mean {img.mean()} is not under the path "
            f"image's {path_img.mean()}")
    return first


def attic_path_phase(scene, dev, v6_first):
    """ATTIC_WAVES waves of direct_path's render for each binary-tree kernel
    set in DEFAULT_KERNEL: all 18 launches a wave are that kernel's; the
    image against direct_path's first waves. Returns the kernels' launches,
    each run counted from 0."""
    out, counted = {}, {}
    for kern, (which, _, _) in ATTIC.items():
        with default_kernel(which):
            launches, img, info, _ = drive_waves(
                f"attic_path {which}", scene, dev, direct_li(), ATTIC_WAVES,
                {f"{kern}:closest": 2 * (MAX_DEPTH + 1),
                 f"{kern}:any": MAX_DEPTH + 1})
        counted.update({k: v for k, v in launches.items() if v})
        out[which] = {**same_image(f"attic path, {which} vs v6", v6_first,
                                   img),
                      **{k: info[k] for k in (
                          "seconds", "launches", "launches_per_wave",
                          "launched_rays_per_s", "img_mean")}}
    say("attic_path", waves=ATTIC_WAVES,
        v6_img_mean=float(v6_first.mean()), **out)
    return counted


def ao_whitted_phase(scene, dev):
    """ATTIC_WAVES waves each of the ambient-occlusion integrator (AO_SAMPLES
    probes: one closest-hit launch and AO_SAMPLES any-hit launches a wave)
    and of the Whitted integrator (depth 5, one light: a closest-hit and an
    any-hit launch a level)."""
    ig = ao_mod.AOIntegrator(n_samples=AO_SAMPLES)
    _, img, info, _ = drive_waves(
        "ao_path", scene, dev, lambda s, r, d, c: ao_mod.li(ig, s, r, d, c),
        ATTIC_WAVES, {"traverse6:closest": 1, "traverse6:any": AO_SAMPLES})
    # a pixel is a weighted mean of values in [0, 1]: 1e-5 for its rounding
    require(img.min() >= 0.0 and img.max() <= 1.0 + 1e-5
            and 0.0 < img.mean() < 1.0,
            f"ao path: image in [{img.min()}, {img.max()}], mean "
            f"{img.mean()}")
    say("ao_path", n_samples=AO_SAMPLES, img_min=float(img.min()),
        img_max=float(img.max()), **info)
    wig = wh.WhittedIntegrator(max_depth=MAX_DEPTH)
    _, img, info, _ = drive_waves(
        "whitted_path", scene, dev,
        lambda s, r, d, c: wh.li(wig, s, r, d, c), ATTIC_WAVES,
        {"traverse6:closest": MAX_DEPTH + 1, "traverse6:any": MAX_DEPTH + 1})
    require(img.mean() > 0, "whitted path: black image")
    say("whitted_path", **info)


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
    tc.load_kernels()
    say("build", seconds=time.time() - t0, flags=tc.NVCC_FLAGS,
        sources={name: {"source": os.path.relpath(src),
                        "seconds": tc.BUILD_SECONDS.get(name),
                        "ptxas": tc.BUILD_LOG.get(name)}
                 for name, src in tc.KERNEL_SOURCES.items()})

    t0 = time.time()
    host = sb.bench_scene().build()
    scene = st.to_device(host, dev)
    mb = sb.bench_scene()
    mb.meshes[0].verts_end = mb.meshes[0].verts + np.asarray(MOTION_SHIFT,
                                                            np.float32)
    moving = st.to_device(mb.build(), dev)
    require(moving.geometry.has_motion and not scene.geometry.has_motion,
            "scene: the moving bench scene did not compile as moving")
    say("scene", seconds=time.time() - t0, tris=host.geometry.n_prims,
        wide_nodes=host.geometry.packed.n_wnodes,
        clusters=host.geometry.packed.n_clusters,
        moving_wide_nodes=moving.geometry.packed.n_wnodes,
        bvh_builder=native.LAST_BUILDER)

    geom_w = dataclasses.replace(scene.geometry, packed=tc.with_woop(
        host.geometry.packed).to(dev))
    _, _, _, _, cam_rays = camera_wave(dev)
    shapes = wave_shapes(scene.geometry, dev, cam_rays)
    results = kernels_phase(scene.geometry, geom_w, shapes, moving, cam_rays,
                            dev)
    small_img = small_scene_phase(dev)
    motion_small_phase(dev, small_img)
    launches, static_img = main_path_phase(scene, dev)
    launches_m = motion_path_phase(moving, dev, static_img)
    alt_kernels_phase(dev, small_img)

    # every kernel's launches on ITS path, each path counted from zero: the
    # static v6 modes on the main path (its sorted closest-hit lanes travel
    # inside the mixed launches), the motion modes on the moving path, the
    # packet kernels on the bench scene's camera waves (closest) and through
    # intersect_rays(kernel=...) at full width (any), the binary-tree
    # kernels on the direct-lighting waves of attic_path
    launches_alt = alt_path_phase(
        dataclasses.replace(scene, geometry=geom_w), dev, shapes[1])
    # this slice's paths: direct lighting with the default kernels, then
    # with each binary-tree kernel serving every launch, AO and Whitted
    attic_small_phase(dev)
    direct_first = direct_path_phase(scene, dev, static_img)
    launches_attic = attic_path_phase(scene, dev, direct_first)
    ao_whitted_phase(scene, dev)
    counted = {**{k: v for k, v in launches.items()
                  if k.startswith("traverse6:")},
               **{k: v for k, v in launches_m.items()
                  if k.startswith("traverse6_motion:")},
               **{k: v for k, v in launches_alt.items()
                  if k.startswith(("traverse5:", "traverse7:"))},
               **launches_attic}
    line = []
    for r in results:
        if r["name"] != r["counter"]:
            continue        # a second ray set of a mode already listed
        require(counted[r["counter"]] > 0,
                f"{r['name']} was never launched on its path")
        line.append({**r, "launches": counted[r["counter"]],
                     **ptxas_resources(r["counter"].split(":")[0])})
    require(len(line) == 18, f"kernels line lists {len(line)} kernels")
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
