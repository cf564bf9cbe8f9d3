#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, `nvcc` (the seven traversal kernel libraries are
built from `dartray_tpu_torch/csrc/*.cu` at first use, all `nvcc` runs started
together) and no network. It imports only the port and its bench
(`bench_torch.py`). Phases, each printing one JSON line with the script's
wall clock at its end (at_s) and the seconds of its parts by kind (parts_s:
golden renders, driven waves, waves in turns, card and CPU windows, profiled
waves, the plain versions' checks and timing); any failure raises and the
script exits non-zero:

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
               equal to v6's on the same rays; the sampler's hashing
               (csrc/sample_hash.cu) through each routed draw at the main
               path's lanes and at a 3840x2160 wave's: 1-D and 2-D draws of
               the lowdiscrepancy and stratified kinds, the camera's
               draws, the AO scramble pair and an AO probe, each EQUAL bit
               for bit to its plain version on the same tensors
  small_scene  Cornell box 32x32: the whole render on the card against the
               same render on the CPU (plain traversal), pixel by pixel
  motion_small the same with one sphere translating: card against CPU, and
               the zero-delta scene against the static scene on the card
  main_path    bench scene, 512x512, path depth 5, lowdiscrepancy 64 spp
               through renderers.sampler.render_wave on the card; asserts 7
               launches of the static v6 kernel per wave and of no other,
               MAIN_SAMPLER_LAUNCHES of the sampler's hashing per wave, a
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
               512x512, strategy ALL, depth 5, 16 spp: 18 launches a wave
               (6 levels of closest, any, closest), all of the v6 kernel; the
               path image's mean must exceed this image's
  attic_path   a few waves of the same render for each of v1-v4 set in
               DEFAULT_KERNEL: every launch of that kernel, image against
               direct_path's first waves
  ao_path      a few waves of the ambient-occlusion integrator with 64 probes
               (n_samples + 1 launches a wave; the default of 2,048 probes is
               2,049 launches a wave and belongs to no smoke run), and
               AO_SAMPLER_LAUNCHES of the sampler's hashing a wave
  whitted_path a few waves of the Whitted integrator, depth 5
  pbrt_path    the scene front door on the card: (a) `python -m
               dartray_tpu_torch scenes/cornell.pbrt` (``__main__.main``): 7
               v6 launches a wave and no other kernel, a PNG that decodes to
               the tonemap of the same command's .pfm image, which matches
               render_pbrt on the CPU; (b) the bench scene written as a
               .pbrt file (world-space triangle meshes, every float as its
               repr) and read back by scene.parser at full width: the
               SceneBuilder's packed BVH and triangle soup bit for bit, 64
               waves of 7 v6 launches through manager.run, the traversal
               queries it counts equal to the launches times their lanes,
               main_path's image, the mean within 1 % of the reference's;
               parse, build
               and render seconds and rays/s; (c) the aggregatetest renderer
               on the Cornell text: 0 mismatches against the exhaustive
               intersector (rays with inconsistent bounds counted apart)
  materials_path  the material system on the card: (a) render_pbrt of
               scenes/materials.pbrt (every ported material kind, image map,
               procedural, combinator, planar and spherical mappings, bump
               map, measured BRDF) against tools/materials_golden.npz, the
               JAX reference's render of it, by compare_images; 5 v6
               launches a wave (depth 3) and no other kernel; (b) the bench
               scene at full width with its displaced sphere split into 8
               material bands and a checkerboard floor under a planar
               mapping, written as .pbrt and run through manager.run: 16
               waves of exactly 7 v6 launches and no other kernel, a finite
               image, render seconds and rays/s beside main_path's; (c) a
               32x32 window of (b) about the sphere's pole, where every band
               is hit, its first 2 waves on the card against the CPU by
               compare_images
  alpha_env_path  alpha cut-outs and the remaining lights: scenes/alpha.pbrt
               and scenes/lights.pbrt against tools/lights_golden.npz; the
               bench scene under an environment light with an alpha-masked
               floor at full width (48 closest launches a wave); a window
               card vs CPU
  sampling_path  samplers, filters, cameras, the sampled spectrum mode,
               checkpoints and the adaptive renderer: (a) five variants of
               scenes/sampling.pbrt (orthographic / stratified / mitchell,
               environment / halton / gaussian, an animated camera / random
               / sinc, bestcandidate at 32 spp / triangle in the sampled
               mode, adaptive / a wide box) through render_pbrt against
               tools/sampling_golden.npz, 5 v6 launches a wave and no other
               kernel, the adaptive renderer's refined pixels equal; a
               render stopped after wave 2 and resumed from its checkpoint
               equal to the uninterrupted one bit for bit; (b1) the bench
               scene through render with stratified 4x4 and mitchell (a 5x5
               footprint on every sample), (b2) its .pbrt text with the
               environment camera, halton, gaussian in the sampled mode
               through render_pbrt: 16 waves of 7 v6 launches and no other
               kernel, render seconds, rays/s beside main_path's, device
               kernels a wave; (c) 32x32 windows of (b1) and (b2) at the
               image's corner, first 2 waves, card vs CPU
  accel_path   the grid and kd-tree accelerators (plain torch walks, no
               kernel): (a) render_pbrt of tests/test_alt_accels.py's sphere
               scene and of scenes/cornell.pbrt (1 spp) under each against
               tools/accel_golden.npz, no kernel launched; (b) the bench
               scene, nothing cut, under each: build seconds, closest hits of
               the camera wave and of sorted incoherent rays equal to v6's
               (rays hit outside their triangle's own box counted apart), the
               camera query's host torch operations against its DDA steps /
               nodes, 1 path wave (ms a wave, steps a query, image against
               v6's); (c) a 32x32 window about the displaced sphere, 1 wave,
               card vs CPU
  walks_path   the reference's own traversal walks (plain torch, no kernel;
               v6 only as their oracle), the bench scene with nothing cut:
               (a) the per-triangle SAH BVH's build seconds, nodes and
               depth; (b) closest hits of the camera wave and of sorted
               incoherent rays by the stackless walk and by the cluster
               packet walk, equal to v6's (rays hit outside their
               triangle's own box counted apart, ties at the same t
               counted); (c) each walk's occlusion mask equal to v6's
               any-hit mask on the camera wave and on the incoherent rays
               cut at tmax 1, but for rays counted apart; (d) the moving
               scene's packet walk on the camera wave with seeded times
               against v6's motion mode; (e) 4,096 camera rays, each walk
               on the card and on the CPU; ms a query beside v6's, steps
               and flushes a query, host torch operations a step
  volume_path  participating media: (a) scenes/smoke.pbrt and both variants
               of scenes/volumes.pbrt against tools/volume_golden.npz, a
               wave's launches the surface integrator's + 1 closest (+ 32
               any under single scattering); (b) the bench scene in a
               seeded 32^3 volumegrid with single scattering: 4 waves of 40
               launches (2 closest, 5 mixed, 33 any) and no other kernel,
               rays/s and device kernels a wave beside main_path's, wave ms
               in turns; (c) a window, card vs CPU
  igi_path     the IGI integrator: (a) scenes/igi-env.pbrt and its VPL set
               against tools/volume_golden.npz (3 closest launches to shoot,
               then 2 closest + 49 any a wave); (b) the bench scene through
               igi's defaults: 2 waves of 2 closest + 321 any launches, wave
               ms in turns; (c) a window, 1 wave, card vs CPU, and the VPL
               sets shot on each
  cache_path   the photon map, irradiance cache and dipole integrators:
               (a) the four variants of scenes/caches.pbrt against
               tools/cache_golden.npz, launches exact; the photon maps and
               the irradiance cache against the reference's, the surface
               points and their irradiance card vs CPU; (b) the bench
               scene at 512x512 through each at its defaults (photonmap:
               44 closest + 6 any a wave; irradiancecache: 4 closest + 1
               any; dipolesubsurface with the displaced sphere in skin1:
               2 closest + 1 any), preprocess seconds and sizes, rays/s
               and wave ms in turns beside main_path's, the host torch
               operations of one gather at two densities (equal); (c) a
               window, card vs CPU, over the card's preprocess
  prt_path     precomputed radiance transfer and the SH probes: (a) c_in and
               the diffuseprt, glossyprt, createprobes and useprobes
               variants of scenes/prt.pbrt against tools/prt_golden.npz,
               launches exact; (b) the bench scene at 512x512 through
               diffuseprt and glossyprt at their defaults (1 closest + 512
               any launches a wave: 4,096 directions batched 8 sample
               indices a launch), createprobes through path (64 probes x
               512) and useprobes over its file, wave ms in turns beside
               main_path's; (c) a window of each PRT integrator at 128
               directions, card vs CPU
  mlt_path     bidirectional paths and the Metropolis renderer: (a) path_l
               at depth 4 on fixed primary samples and the two Metropolis
               variants of scenes/prt.pbrt against the golden, chains that
               part from the CPU run counted; (b) the bench scene at
               512x512 through Renderer "metropolis" at depth 7, 8,192
               chains, 32 steps of 21 closest + 56 any launches: ms a
               step, mutations/s, b, acceptance, the direct pass; (c)
               path_l at depth 7 on 1,024 lanes of the bench scene, card
               vs CPU
  mesh_path    band-sharded rendering (parallel/mesh.py): (a) the one-process
               4 x 2 mesh of tools/mesh_golden.npz's two configurations
               against the reference's sharded images (rtol 2e-3 / atol
               2e-4), launches exact, the share of bit-equal pixels; (b) 4
               ranks spawned on the one card over gloo render the bench scene
               at 512x512, depth 5: 4 x 1, box, 16 spp equal to render's
               image bit for bit, each rank launching exactly 16 closest, 80
               mixed, 16 any and no other kernel; 2 x 2, gaussian, 8 spp
               within tolerance of render's; spawn and set-up seconds apart
               from render seconds, rays/s beside main_path's, each rank's
               backend and device; (c) the NCCL branch is not exercised (one
               card)
  grad_small   the gradient of the Cornell render's mean w.r.t. materials.kd
               and lights.intensity (32x32, 4 spp, depth 3): card against
               CPU (plain traversal) within 2e-3 of the largest element,
               autodiff against central differences for one light channel
               within 2 % on the card, remat on and off equal to rtol 1e-4
  grad_path    the gradient at full width (bench scene, depth 5, per-bounce
               remat on): bench.py's probe (96x96, 8 spp, (img ** 2).mean()
               w.r.t. materials.kd) with its norm within 2 % of the JAX
               reference's, then the same loss at 512x512 with 2 and 8 spp:
               finite, 20 v6 launches a gradient wave (2 closest, 15 mixed,
               3 any: forward, the wave's recompute, the bounces' recomputes;
               measured on an H100) and no other, the 8-spp peak memory
               above the start at most 1.25 times the 2-spp one

Then the script's wall time so far ({"phase": "wall", ...}), one line
{"kernels": [...]} (per kernel and mode, and per entry of the sampler's
hashing: launches counted on its path (the front door's and the gradient's
launches are on pbrt_path's and grad_path's lines; the hashing's on
main_path's and ao_path's), error against
the plain version, times, the least time the card could take, and the
registers and spill bytes ptxas gave its kernel function), the nvidia-smi
line again, and as the last line
{"ok": true, "device": {...}}.
"""
import collections
import contextlib
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import bench_torch
from dartray_tpu_torch import __main__ as cli
from dartray_tpu_torch import cameras, grad, samplers
from dartray_tpu_torch import film as film_mod
from dartray_tpu_torch import stats as stats_mod
from dartray_tpu_torch.accel import bvh as bvh_mod
from dartray_tpu_torch.accel import cluster as cluster_mod
from dartray_tpu_torch.accel import grid as grid_mod
from dartray_tpu_torch.accel import kdtree as kd_mod
from dartray_tpu_torch.accel import native
from dartray_tpu_torch.accel import traverse as tv
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.core import sampling as sampling_mod
from dartray_tpu_torch.core import spectrum as spec
from dartray_tpu_torch.core import transform as tr
from dartray_tpu_torch.integrators import ao as ao_mod
from dartray_tpu_torch.integrators import bdpt
from dartray_tpu_torch.integrators import dipole as dp_mod
from dartray_tpu_torch.integrators import direct as di
from dartray_tpu_torch.integrators import igi as igi_mod
from dartray_tpu_torch.integrators import irradiance_cache as ic_mod
from dartray_tpu_torch.integrators import path as pi
from dartray_tpu_torch.integrators import photonmap as pm_mod
from dartray_tpu_torch.integrators import prt as prt_mod
from dartray_tpu_torch.integrators import whitted as wh
from dartray_tpu_torch.io import image as io_img
from dartray_tpu_torch.ops import sampler_cuda as sc
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.parallel import mesh as pm
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.renderers import metropolis as mlt_mod
from dartray_tpu_torch.renderers import sampler as rend
from dartray_tpu_torch.renderers import surface_points as sp_mod
from dartray_tpu_torch.scene import build as sb
from dartray_tpu_torch.scene import paramset
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import resources
from dartray_tpu_torch.scene import types as st

T_START = time.time()      # the script's wall time counts from here

# the JAX reference's image mean for the bench scene at 512x512, depth 5,
# 64 spp, and its gradient probe's norm: correctness values, not speeds
REFERENCE_IMG_MEAN = bench_torch.REFERENCE_IMG_MEAN
REFERENCE_GRAD_NORM = bench_torch.REFERENCE_GRAD_NORM
WIDTH = HEIGHT = 512
SPP = 64
DRIVEN_SPP = 16            # waves of the full-width renders after the main
                           # path (motion, direct lighting, materials, alpha
                           # and environment, samplers): launches are held a
                           # wave, so fewer waves keep every gate
MAX_DEPTH = 5
SMALL = 32                 # the Cornell renders: SMALL x SMALL pixels,
SMALL_SPP = 4              # SMALL_SPP samples (one wave each), depth 3
ALT_WAVES = 4              # waves of the bench scene per packet kernel
ATTIC_WAVES = 4            # ... per binary-tree kernel, and of AO and Whitted
AO_SAMPLES = 64            # probes a wave of ao_path
# the sampler's hashing a wave (entry -> launches): the main path draws its
# camera samples in one launch, then at each of its MAX_DEPTH + 1 levels a
# light sample (three draws), at each level but the last a BSDF sample (two)
# and past the Russian roulette's depth (3) its draw; ao_path the camera's,
# the scramble pair and one a probe
MAIN_SAMPLER_LAUNCHES = {"camera": 1, "draw": 3 * (MAX_DEPTH + 1)
                         + 2 * MAX_DEPTH + (MAX_DEPTH - 1 - 3)}
AO_SAMPLER_LAUNCHES = {"camera": 1, "ao_scrambles": 1,
                       "ao_probe": AO_SAMPLES}
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
# the sampler's hashing has no TPU kernel behind it: the reference draws with
# XLA's uint32 ops, here the lines of the draws each entry computes
SAMPLE_HASH = {
    "draw": "dartray_tpu/samplers.py:158,217",
    "camera": "dartray_tpu/samplers.py:241",
    "ao_scrambles": "dartray_tpu/integrators/ao.py:46",
    "ao_probe": "dartray_tpu/integrators/ao.py:58",
}
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


# seconds by kind of part (golden renders, driven waves, waves in turns,
# card and CPU windows, profiled waves) since the last phase line
PART_SECONDS = collections.Counter()


@contextlib.contextmanager
def part(kind):
    t0 = time.time()
    try:
        yield
    finally:
        PART_SECONDS[kind] += time.time() - t0


def timed_part(kind):
    """Decorator: every call of the function counts as a part `kind`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            with part(kind):
                return fn(*a, **k)
        return inner
    return wrap


def say(phase, **kw):
    """One JSON line for `phase`; at_s: the script's wall time at the end of
    the phase, so that differences give each phase's seconds; parts_s: the
    seconds of its parts, by kind."""
    print(json.dumps({"phase": phase, **kw, "parts_s": dict(PART_SECONDS),
                      "at_s": time.time() - T_START}), flush=True)
    PART_SECONDS.clear()


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_resources(counter):
    """Registers and spill bytes (stores) of the kernel function behind
    `counter` (library:mode), from the assembler's report of its library's
    build (nvcc runs with -Xptxas -v). traverse6.cu holds two: the motion
    instantiation is the one with ``ILb1E`` in its name; sample_hash.cu one
    a launcher: the entry's ``<entry>_kernel``."""
    kern, _, mode = counter.partition(":")
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
    elif lib == "sample_hash":
        found = {f: v for f, v in found.items() if f"{mode}_kernel" in f}
    require(len(found) == 1,
            f"{counter}: the build log names {sorted(found)}")
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
    with part("plain_checks"):
        t_p, p_p, *cnt_p = run_p(stats)
    extra = {}
    require(torch.equal(t_k, t_p) and torch.equal(p_k, p_p),
            f"{name}: raw (t, prim) differs from the plain version's")
    if kern in ("traverse5", "traverse7"):
        cnt_k = [fn(*args, **kw, counters=True)[2]]
        with part("plain_checks"):
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
    # the packet walks' plain versions take seconds: one run
    with part("plain_timing"):
        plain_ms = time_ms(run_p, warmup=0, repeats=3 if kern.startswith(
            "traverse6") else 1)
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


def check_sampler(entry, label, lanes, run_k, run_p, bytes_a_lane,
                  as_plain=lambda x: x):
    """One routed draw of the sampler's hashing (`entry` of
    ``sampler_cuda.LAUNCHES``) against its plain version on the same device
    tensors: exactly one launch, every output plane EQUAL bit for bit
    (`as_plain` maps a kernel plane to the plain version's dtype); times of
    both; the bound, the lanes' bytes in and out once each."""
    name = f"sample_hash:{entry}" + (label and f"_{label}")
    before = dict(sc.LAUNCHES)
    got = run_k()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in sc.LAUNCHES.items()
                if v != before[k]}
    require(launched == {entry: 1}, f"{name}: the wrapper counted {launched}")
    with part("plain_checks"):
        want = run_p()
    require(len(got) == len(want) and all(
        torch.equal(as_plain(g), w) for g, w in zip(got, want)),
        f"{name}: differs from the plain version's bits")
    ms = time_ms(run_k, repeats=7, warmup=2)
    ms_queued = time_ms(lambda: [run_k() for _ in range(20)], repeats=3,
                        warmup=1) / 20
    with part("plain_timing"):
        plain_ms = time_ms(run_p, repeats=3, warmup=1)
    return {
        "name": name, "route": "cuda", "source": CSRC + "sample_hash.cu",
        "replaces": SAMPLE_HASH[entry], "launches": 0, "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": lanes * bytes_a_lane / PEAK_BYTES_S * 1e3,
        "bound_by": "bytes", "library_ms": None, "ms_queued": ms_queued,
        "counter": f"sample_hash:{entry}", "lanes": lanes, "equal": True,
        "bytes_a_lane": bytes_a_lane}


def sampler_checks(width, height, dev, suffix=""):
    """Each routed draw of the sampler's hashing over a width x height wave
    (Morton-ordered pixels as the main path's, a seeded sample index a
    lane): 2-D and 1-D draws of the lowdiscrepancy and stratified kinds at
    SPP, the camera's draws, the AO scramble pair and probe 37 of
    AO_SAMPLES. `suffix` labels every row (a second lane count)."""
    px, py = rend.pixel_grid(width, height, device=dev)
    n = px.shape[0]
    s = torch.from_numpy(np.random.RandomState(16).randint(
        0, SPP, n).astype(np.int32)).to(dev)
    ld = samplers.make_sampler("lowdiscrepancy", SPP)
    strat = samplers.make_sampler("stratified", SPP)
    n_bits = max(int(AO_SAMPLES - 1).bit_length(), 1)
    scr_k = ao_mod.scrambles(px, py, s)
    scr_p = ao_mod.scrambles_plain(px, py, s)
    probe = torch.full((n,), 37, dtype=torch.int64, device=dev)

    def camera(fn):
        c = fn(ld, px, py, s)
        return (*c.image_xy, *c.lens_uv, c.time_u)

    rows = []
    for label, smp in (("", ld), ("stratified", strat)):
        rows.append(check_sampler(
            "draw", label, n, lambda: samplers.sample_2d(smp, px, py, s, 7),
            lambda: samplers.sample_2d_plain(smp, px, py, s, 7), 12 + 8))
        rows.append(check_sampler(
            "draw", "1d" + (label and "_" + label), n,
            lambda: (samplers.sample_1d(smp, px, py, s, 9),),
            lambda: (samplers.sample_1d_plain(smp, px, py, s, 9),), 12 + 4))
    rows.append(check_sampler(
        "camera", "", n, lambda: camera(samplers.camera_samples),
        lambda: camera(samplers.camera_samples_plain), 12 + 20))
    rows.append(check_sampler(
        "ao_scrambles", "", n, lambda: ao_mod.scrambles(px, py, s),
        lambda: ao_mod.scrambles_plain(px, py, s), 12 + 8,
        as_plain=lambda x: x.to(torch.int64) & sampling_mod.M32))
    rows.append(check_sampler(
        "ao_probe", "", n, lambda: ao_mod.probe(scr_k, 37, n_bits),
        lambda: sampling_mod.sample02(probe, scr_p, n_bits), 8 + 8))
    for r in rows:
        r["name"] += suffix and "@" + suffix
    return rows


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
    # the sampler's hashing at the main path's lanes (the kernels line's
    # rows) and at a 3840x2160 wave's, the benchmark's render cells'
    results += sampler_checks(WIDTH, HEIGHT, dev)
    results += sampler_checks(3840, 2160, dev, suffix="2160p")
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


@timed_part("driven_waves")
def drive_waves(phase, scene, dev, li, waves, want, snapshot_at=None,
                want_draws=None):
    """`waves` waves of the integrator `li` over `scene` through
    render_wave, every count set to 0 just before and read just after;
    requires the launches `want` (counter -> launches a wave) and no other, a
    finite image and no stack overflow. Rays are counted as launches times
    the lanes of a wave. The sampler's hashing launches go on the line as
    ``sampler_launches`` (``sample_hash:<entry>``); want_draws: require
    those (entry -> launches a wave) and no other. snapshot_at: also return
    the image after that many waves."""
    cam, smp, px, py, _ = camera_wave(dev)
    film = film_mod.make_film(WIDTH, HEIGHT, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc.reset_overflow(dev)
    tc.reset_launches()
    sc.LAUNCHES.update(dict.fromkeys(sc.LAUNCHES, 0))
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
    draws = {f"sample_hash:{k}": v for k, v in sc.LAUNCHES.items() if v}
    img = film_mod.to_rgb(film).cpu().numpy()
    overflow = int(tc.overflow_flag(dev).item())
    n_launches = sum(launches.values())
    info = dict(waves=waves, seconds=secs, first_wave_seconds=t_first,
                launches={k: v for k, v in launches.items() if v},
                sampler_launches=draws,
                launches_per_wave=n_launches / waves,
                launched_rays_per_s=n_launches * px.shape[0] / secs,
                img_mean=float(img.mean()), overflow=overflow,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                tris=scene.geometry.n_prims)
    want = {k: v * waves for k, v in want.items()}
    require(info["launches"] == want,
            f"{phase}: kernel launches {info['launches']}, expected {want}")
    if want_draws is not None:
        want_draws = {f"sample_hash:{k}": v * waves
                      for k, v in want_draws.items()}
        require(draws == want_draws, f"{phase}: the sampler's hashing "
                f"launched {draws}, expected {want_draws}")
    require(overflow == 0, f"{phase}: stack overflow in the kernel")
    require(img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(img).all(),
            f"{phase}: image not finite or of the wrong shape")
    return launches, img, info, snap


def drive_path(phase, scene, dev, kern, camera_kern=None, waves=None,
               snapshot_at=None, want_draws=None):
    """`waves` waves (default: all 64) of the path integrator over `scene`;
    requires 7 launches of `kern` per wave and of no other kernel, or, with
    `camera_kern`, 1 closest-hit launch of that and the other 6 of `kern`.
    snapshot_at: also put the image after that many waves in info["snap"];
    want_draws: as drive_waves'."""
    ig = pi.PathIntegrator(max_depth=MAX_DEPTH)
    launches, img, info, snap = drive_waves(
        phase, scene, dev, lambda s, r, d, c: pi.li(ig, s, r, d, c),
        waves or SPP, {f"{camera_kern or kern}:closest": 1,
                       f"{kern}:mixed": MAX_DEPTH, f"{kern}:any": 1},
        snapshot_at=snapshot_at, want_draws=want_draws)
    # as the reference's benchmark counts them: two rays a lane and level
    info["rays_per_s"] = (WIDTH * HEIGHT * 2 * (MAX_DEPTH + 1) * info["waves"]
                          / info["seconds"])
    if snapshot_at is not None:
        info["snap"] = snap
    return launches, img, info


def main_path_phase(scene, dev):
    """Returns the launches (the sampler's hashing's among them), the
    image, the image after DRIVEN_SPP waves and rays/s."""
    launches, img, info = drive_path("main_path", scene, dev, "traverse6",
                                     snapshot_at=DRIVEN_SPP,
                                     want_draws=MAIN_SAMPLER_LAUNCHES)
    snap = info.pop("snap")
    say("main_path", reference_img_mean=REFERENCE_IMG_MEAN, **info)
    require(abs(info["img_mean"] - REFERENCE_IMG_MEAN)
            <= 0.01 * REFERENCE_IMG_MEAN,
            f"main path: image mean {info['img_mean']} is not within 1 % of "
            f"{REFERENCE_IMG_MEAN}")
    return ({**launches, **info["sampler_launches"]}, img, snap,
            info["rays_per_s"])


def motion_path_phase(moving, dev, static_img):
    """This slice's path at full width: the moving bench scene, DRIVEN_SPP
    waves, against the static scene's image after as many waves. No
    reference mean is stated: the JAX package has none for this scene."""
    launches, img, info = drive_path("motion_path", moving, dev,
                                     "traverse6_motion", waves=DRIVEN_SPP)
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
        "direct_path", scene, dev, direct_li(), DRIVEN_SPP,
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
    probes: one closest-hit launch and AO_SAMPLES any-hit launches a wave,
    and AO_SAMPLER_LAUNCHES of the sampler's hashing) and of the Whitted
    integrator (depth 5, one light: a closest-hit and an any-hit launch a
    level). Returns the AO waves' launches of the sampler's hashing."""
    ig = ao_mod.AOIntegrator(n_samples=AO_SAMPLES)
    _, img, info, _ = drive_waves(
        "ao_path", scene, dev, lambda s, r, d, c: ao_mod.li(ig, s, r, d, c),
        ATTIC_WAVES, {"traverse6:closest": 1, "traverse6:any": AO_SAMPLES},
        want_draws=AO_SAMPLER_LAUNCHES)
    ao_draws = info["sampler_launches"]
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
    return ao_draws


# the scene front door: where its files go (git-ignored), the Cornell file
PBRT_DIR = os.path.join(tc.BUILD_DIR, "pbrt")
CORNELL_PBRT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "scenes", "cornell.pbrt")
QUIET = lambda *a, **k: None   # noqa: E731


def pbrt_numbers(a):
    """Every float32 of `a` as Python's repr: it parses back exactly."""
    return " ".join(repr(float(x)) for x in np.asarray(a).reshape(-1))


def pbrt_material(row):
    """The Material statement of a matte, mirror or glass row."""
    if any(row["kt"]):
        return (f'Material "glass" "rgb Kr" [{pbrt_numbers(row["kr"])}] '
                f'"rgb Kt" [{pbrt_numbers(row["kt"])}] '
                f'"float index" [{float(row["eta"])!r}]')
    if any(row["kr"]):
        return f'Material "mirror" "rgb Kr" [{pbrt_numbers(row["kr"])}]'
    return f'Material "matte" "rgb Kd" [{pbrt_numbers(row["kd"])}]'


def trianglemesh(m, faces):
    """A Shape statement of the triangles `faces` of mesh `m` with the
    vertices they use (their normals and uvs too), renumbered in order,
    every float as its repr."""
    used, inv = np.unique(faces.reshape(-1), return_inverse=True)
    shape = (f'Shape "trianglemesh" "integer indices" '
             f'[{" ".join(map(str, inv))}] '
             f'"point P" [{pbrt_numbers(m.verts[used])}]')
    if m.normals is not None:
        shape += f' "normal N" [{pbrt_numbers(m.normals[used])}]'
    if m.uvs is not None:
        shape += f' "float uv" [{pbrt_numbers(m.uvs[used])}]'
    return shape


def bench_scene_pbrt(path, spp=SPP):
    """Write ``sb.bench_scene()`` as a .pbrt file: the camera of
    ``camera_wave``, 512x512, lowdiscrepancy `spp`, path depth 5, and every
    mesh, in the SceneBuilder's order, as a world-space trianglemesh with its
    material (and area light) in an attribute block."""
    b = sb.bench_scene()
    out = [f'Film "image" "integer xresolution" [{WIDTH}] '
           f'"integer yresolution" [{HEIGHT}]',
           f'Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]',
           f'SurfaceIntegrator "path" "integer maxdepth" [{MAX_DEPTH}]',
           "LookAt 0 2.2 -5  0 0.9 0  0 1 0",
           'Camera "perspective" "float fov" [42]', "WorldBegin"]
    for m, mat, light in zip(b.meshes, b.mesh_mat, b.mesh_area_light):
        out += ["AttributeBegin", pbrt_material(b.mat_rows[mat])]
        if light is not None:
            out.append(f'AreaLightSource "diffuse" "rgb L" '
                       f'[{pbrt_numbers(light[0])}]')
        out += [trianglemesh(m, m.faces), "AttributeEnd"]
    out.append("WorldEnd")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return b


def same_leaves(a, b, path=""):
    """Paths of the leaves where two host trees (dataclasses, tuples,
    numpy arrays, scalars) differ; arrays by their bytes."""
    if dataclasses.is_dataclass(a):
        return [p for f in dataclasses.fields(a) for p in same_leaves(
            getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")]
    if isinstance(a, (tuple, list)):
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in same_leaves(x, y, f"{path}[{i}]")]
    if isinstance(a, np.ndarray):
        return [] if (a.dtype == b.dtype and a.shape == b.shape
                      and a.tobytes() == b.tobytes()) else [path]
    return [] if a == b else [path]


def path_launches(waves, depth=MAX_DEPTH):
    """The v6 launches of `waves` path waves at `depth`."""
    return {"traverse6:closest": waves, "traverse6:mixed": depth * waves,
            "traverse6:any": waves}


def counted_launches():
    return {k: v for k, v in tc.LAUNCHES.items() if v}


def pbrt_path_phase(dev, static_img):
    """The scene front door on the card, through the v6 kernel.
    (a) ``python -m dartray_tpu_torch scenes/cornell.pbrt`` (``__main__.main``)
    on the card: 7 v6 launches a wave and no other kernel, a PNG that
    decodes to the image of the same command's .pfm output, which matches
    ``render_pbrt`` on the CPU (``compare_images``). (b) The bench scene
    written as a .pbrt file and read back at full width: ``scene.parser``
    gives the SceneBuilder's packed BVH and triangle soup bit for bit, and
    ``manager.run`` renders it in 64 waves of 7 v6 launches, with the
    traversal queries it counts equal to the launches times their lanes, to
    ``main_path``'s image (``compare_images``) and within 1 % of the
    reference's mean. (c) The ``aggregatetest`` renderer on the Cornell
    text: random rays through the BVH on the card against the exhaustive
    intersector, 0 mismatches."""
    os.makedirs(PBRT_DIR, exist_ok=True)
    out = {}
    # (a) the command line on the Cornell file
    png, pfm = (os.path.join(PBRT_DIR, "cornell" + e) for e in (".png",
                                                              ".pfm"))
    tc.reset_overflow(dev)
    tc.reset_launches()
    t0 = time.time()
    require(cli.main([CORNELL_PBRT, "-q", "-o", png]) == 0, "cli: exit code")
    cli_s = time.time() - t0
    launches = counted_launches()
    waves = 8                      # the file's pixelsamples
    require(launches == path_launches(waves),
            f"pbrt cli: kernel launches {launches}")
    with open(png, "rb") as f:
        png_img = io_img.load(f.read(), png)
    require(png_img.shape == (48, 48, 3) and np.isfinite(png_img).all(),
            "pbrt cli: the PNG does not decode to a 48x48 image")
    require(cli.main([CORNELL_PBRT, "-q", "-o", pfm]) == 0, "cli: exit code")
    with open(pfm, "rb") as f:
        card = io_img.load(f.read(), pfm)
    again = os.path.join(PBRT_DIR, "cornell_again.png")
    io_img.save(again, card)
    with open(png, "rb") as f, open(again, "rb") as g:
        require(f.read() == g.read(), "pbrt cli: the PNG is not the tonemap "
                "of the same command's .pfm image")
    t0 = time.time()
    cpu = manager.render_pbrt(CORNELL_PBRT, log=QUIET, device="cpu")
    cpu_s = time.time() - t0
    close, rel_mean = compare_images("pbrt cli, card vs CPU",
                                     np.clip(cpu, 0.0, 1.0), card)
    out["cli"] = {"launches": launches, "seconds": cli_s,
                  "cpu_render_pbrt_seconds": cpu_s, "pixels_close": close,
                  "rel_mean": rel_mean, "img_mean": float(card.mean())}
    # (b) the bench scene through the front door at full width
    path = os.path.join(PBRT_DIR, "bench.pbrt")
    t0 = time.time()
    b = bench_scene_pbrt(path)
    write_s = time.time() - t0
    t0 = time.time()
    direct = b.build()
    build_s = time.time() - t0
    t0 = time.time()
    with open(path) as f:
        job = parser.parse(f.read(), log=QUIET, device=dev)
    parse_s = time.time() - t0
    g, want = job.scene.geometry, direct.geometry
    differ = same_leaves((g.packed, g.v0, g.e1, g.e2),
                         (want.packed, want.v0, want.e1, want.e2))
    require(not differ, f"pbrt bench: the parsed scene's BVH or soup "
            f"differs from the SceneBuilder's at {differ[:5]}")
    stats = stats_mod.RenderStats()
    tc.reset_overflow(dev)
    tc.reset_launches()
    t0 = time.time()
    img = manager.run(job, log=QUIET, stats=stats, device=dev)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches = counted_launches()
    require(launches == path_launches(SPP),
            f"pbrt bench: kernel launches {launches}")
    require(int(tc.overflow_flag(dev).item()) == 0,
            "pbrt bench: stack overflow in the kernel")
    lanes = WIDTH * HEIGHT
    queries = stats.counters["rays/traversal_queries"]
    launched = lanes * (launches["traverse6:closest"]
                        + 2 * launches["traverse6:mixed"]
                        + launches["traverse6:any"])
    require(queries == launched, f"pbrt bench: {queries} traversal queries "
            f"counted, {launched} lanes launched")
    close, rel_mean = compare_images("pbrt bench vs main path", static_img,
                                     img)
    img_mean = float(img.mean())
    require(abs(img_mean - REFERENCE_IMG_MEAN) <= 0.01 * REFERENCE_IMG_MEAN,
            f"pbrt bench: image mean {img_mean} is not within 1 % of "
            f"{REFERENCE_IMG_MEAN}")
    rays = lanes * 2 * (MAX_DEPTH + 1) * SPP
    out["bench"] = {
        "file_bytes": os.path.getsize(path), "write_s": write_s,
        "parse_s": parse_s, "build_s": build_s, "render_s": render_s,
        "stats_timings": stats.timings, "rays_per_s": rays / render_s,
        "rays/traversal_queries": queries, "launches": launches,
        "img_mean": img_mean, "pixels_close_to_main_path": close,
        "rel_mean_to_main_path": rel_mean,
        "bit_identical_to_main_path": bool(np.array_equal(img, static_img)),
        "tris": g.n_prims}
    # (c) the aggregatetest renderer on the Cornell text
    with open(CORNELL_PBRT) as f:
        text = 'Renderer "aggregatetest"\n' + f.read()
    lines = []
    tc.reset_launches()
    t0 = time.time()
    manager.render_pbrt(text, log=lines.append, device=dev)
    agg_s = time.time() - t0
    m = re.search(r"(\d+) rays, (\d+) hit mismatches, max\|dt\|=(\S+), "
                  r"(\d+) with inconsistent bounds", " ".join(lines))
    require(m is not None and int(m.group(2)) == 0,
            f"pbrt aggregatetest: {lines}")
    out["aggregatetest"] = {"rays": int(m.group(1)),
                            "mismatches": int(m.group(2)),
                            "max_dt": float(m.group(3)),
                            "inconsistent_bounds": int(m.group(4)),
                            "launches": counted_launches(),
                            "seconds": agg_s}
    say("pbrt_path", **out)


# the material system: its fixture scene and the reference's render of it
SCENES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scenes")
MATERIALS_PBRT = os.path.join(SCENES_DIR, "materials.pbrt")
MATERIALS_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tools", "materials_golden.npz")
MATERIALS_WAVES = 4        # materials.pbrt: 4 spp, path depth 3
MATERIALS_DEPTH = 3
WINDOW = 32                # (c): a WINDOW x WINDOW window, WINDOW_WAVES waves
WINDOW_WAVES = 2
# the displaced sphere's 8 bands (longitude wedges meeting at its poles)
BANDS = [
    ['Material "plastic" "texture Kd" "picture" "rgb Ks" [0.3 0.3 0.3] '
     '"float roughness" [0.05] "texture bumpmap" "bumps"'],
    ['Material "metal" "float roughness" [0.03]'],
    ['Material "shinymetal" "rgb Ks" [0.4 0.35 0.3] "rgb Kr" [0.5 0.5 0.5] '
     '"float roughness" [0.08]'],
    ['Material "substrate" "rgb Kd" [0.14 0.45 0.09] "rgb Ks" [0.2 0.2 0.2] '
     '"float uroughness" [0.05] "float vroughness" [0.3]'],
    ['Material "translucent" "rgb Kd" [0.5 0.4 0.3] "rgb Ks" [0.2 0.2 0.2] '
     '"float roughness" [0.1]'],
    ['Material "uber" "rgb Kd" [0.3 0.2 0.5] "rgb Ks" [0.3 0.3 0.3] '
     '"float roughness" [0.15] "rgb opacity" [0.6 0.6 0.6]'],
    ['MakeNamedMaterial "red_plastic" "string type" "plastic" '
     '"rgb Kd" [0.6 0.1 0.1] "rgb Ks" [0.4 0.4 0.4] "float roughness" [0.1]',
     'MakeNamedMaterial "gold" "string type" "metal" "float roughness" '
     '[0.02]',
     'Material "mix" "string namedmaterial1" "red_plastic" '
     '"string namedmaterial2" "gold" "rgb amount" [0.3 0.3 0.3]'],
    ['Material "measured" "string filename" "materials.merl"'],
]
BAND_TEXTURES = [
    'Texture "picture" "color" "imagemap" "string filename" '
    '"materials.pfm" "float uscale" [8] "float vscale" [4]',
    'Texture "noise" "float" "fbm" "integer octaves" [8]',
    'Texture "depth" "float" "constant" "float value" [0.02]',
    'Texture "bumps" "float" "scale" "texture tex1" "noise" '
    '"texture tex2" "depth"',
]
FLOOR_MATERIAL = [
    'Texture "tiles" "color" "checkerboard" "string mapping" "planar" '
    '"vector v1" [1 0 0] "vector v2" [0 0 1] "rgb tex1" [0.4 0.4 0.45] '
    '"rgb tex2" [0.15 0.15 0.2]',
    'Material "matte" "texture Kd" "tiles"']




def materials_bench_pbrt(path):
    """The bench scene with the material system on it, as a .pbrt file:
    ``bench_scene_pbrt``'s camera, film, sampler and integrator; the
    displaced sphere's triangles, unchanged, split into 8 trianglemesh bands
    (its longitude wedges) with the BANDS materials; the floor matte with a
    checkerboard Kd under a planar mapping; the glass sphere and the light
    as before. Returns the number of triangles in each band."""
    b = sb.bench_scene()
    out = [f'Film "image" "integer xresolution" [{WIDTH}] '
           f'"integer yresolution" [{HEIGHT}]',
           f'Sampler "lowdiscrepancy" "integer pixelsamples" [{DRIVEN_SPP}]',
           f'SurfaceIntegrator "path" "integer maxdepth" [{MAX_DEPTH}]',
           "LookAt 0 2.2 -5  0 0.9 0  0 1 0",
           'Camera "perspective" "float fov" [42]', "WorldBegin",
           *BAND_TEXTURES]
    sphere = b.meshes[0]
    bands = np.array_split(sphere.faces, len(BANDS))
    for band, mat in zip(bands, BANDS):
        out += ["AttributeBegin", *mat, trianglemesh(sphere, band),
                "AttributeEnd"]
    for m, mat, light in list(zip(b.meshes, b.mesh_mat,
                                  b.mesh_area_light))[1:]:
        floor = m.n_faces == 2 and light is None
        out += ["AttributeBegin", *(FLOOR_MATERIAL if floor else
                                    [pbrt_material(b.mat_rows[mat])])]
        if light is not None:
            out.append(f'AreaLightSource "diffuse" "rgb L" '
                       f'[{pbrt_numbers(light[0])}]')
        out += [trianglemesh(m, m.faces), "AttributeEnd"]
    out.append("WorldEnd")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return [len(band) for band in bands]


def window_render(job, where, x0, y0, waves=WINDOW_WAVES, li=None):
    """The first `waves` waves of `job` over the WINDOW x WINDOW pixels at
    (x0, y0) on `where`, into a full-size film under the job's filter (the
    same samples as the whole render's first waves); returns the window's
    pixels. `li`: the radiance function (default: the job's, built on
    `where`)."""
    with part(f"window_{'cpu' if str(where) == 'cpu' else 'card'}"):
        return _window_render(job, where, x0, y0, waves, li)


def _window_render(job, where, x0, y0, waves, li):
    scene = st.to_device(job.scene, where)
    if li is None:
        li = manager.build_li(job, log=QUIET, device=where)
    px, py = rend.pixel_grid(WINDOW, WINDOW, x0=x0, y0=y0, device=where)
    film = film_mod.make_film(job.width, job.height,
                              filter_name=job.filter_name,
                              filter_params=job.filter_params, device=where)
    with torch.no_grad():
        for s in range(waves):
            film = rend.render_wave(
                scene, job.camera, job.sampler, film, px, py,
                torch.full(px.shape, s, dtype=torch.int32, device=where),
                li_fn=li, width=job.width, height=job.height,
                spp=job.sampler.spp, device=where)
    img = film_mod.to_rgb(film).cpu().numpy()
    return img[y0:y0 + WINDOW, x0:x0 + WINDOW]


def window_materials(job, x0, y0):
    """The material ids the window's first camera rays hit (CPU)."""
    px, py = rend.pixel_grid(WINDOW, WINDOW, x0=x0, y0=y0, device="cpu")
    cs = samplers.camera_samples(job.sampler, px, py, torch.zeros_like(px))
    rays, _, _ = cameras.generate_rays(job.camera, cs, job.width, job.height)
    geom = st.to_device(job.scene.geometry, "cpu")
    hits = st.intersect(geom, rays)
    it = st.interaction(geom, rays, hits)
    return set(it["mat_id"][hits.prim >= 0].tolist())


def materials_path_phase(dev, main_rays_per_s):
    """The material system on the card, through the v6 kernel. (a)
    ``render_pbrt`` of scenes/materials.pbrt against the JAX reference's
    render of it (tools/materials_golden.npz) by ``compare_images``: 5 v6
    launches a wave (depth 3) and no other kernel. (b) The bench scene at
    full width (103,956 triangles, 512x512, DRIVEN_SPP spp, depth 5) with
    its displaced sphere split into 8 material bands, a checkerboard floor
    under a planar mapping, through ``manager.run``: 7 v6 launches a wave
    and no other kernel, a finite image; render seconds and rays/s
    beside main_path's. (c) A WINDOW x WINDOW window of (b) about the
    sphere's pole, where all 8 bands meet (every band's material is hit),
    the first WINDOW_WAVES waves on the card against the same waves on the
    CPU by ``compare_images``."""
    os.makedirs(PBRT_DIR, exist_ok=True)
    out = {}
    # (a) the small scene against the reference
    golden = np.load(MATERIALS_GOLDEN)["image"]
    tc.reset_overflow(dev)
    tc.reset_launches()
    t0 = time.time()
    img = manager.render_pbrt(MATERIALS_PBRT, log=QUIET, device=dev)
    torch.cuda.synchronize()
    small_s = time.time() - t0
    launches = counted_launches()
    want = {"traverse6:closest": MATERIALS_WAVES,
            "traverse6:mixed": MATERIALS_DEPTH * MATERIALS_WAVES,
            "traverse6:any": MATERIALS_WAVES}
    require(launches == want, f"materials small: kernel launches {launches}")
    close, rel_mean = compare_images("materials scene vs the reference",
                                     golden, img)
    out["small"] = {"seconds": small_s, "launches": launches,
                    "pixels_close": close, "rel_mean": rel_mean,
                    "img_mean": float(img.mean()),
                    "golden_mean": float(golden.mean())}
    # (b) the bench scene with 8 material bands at full width
    path = os.path.join(PBRT_DIR, "materials_bench.pbrt")
    t0 = time.time()
    band_tris = materials_bench_pbrt(path)
    write_s = time.time() - t0
    with open(path) as f:
        text = f.read()
    resolver = resources.Resolver([PBRT_DIR, SCENES_DIR])
    t0 = time.time()
    job = parser.parse(text, resolver=resolver, log=QUIET, device=dev)
    parse_s = time.time() - t0
    mats = job.scene.materials
    require(job.scene.geometry.n_prims == 103956 and mats.has_measured
            and job.scene.textures is not None,
            "materials bench: the scene did not compile as written")
    stats = stats_mod.RenderStats()
    tc.reset_overflow(dev)
    tc.reset_launches()
    t0 = time.time()
    img = manager.run(job, log=QUIET, stats=stats, device=dev)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches = counted_launches()
    require(launches == path_launches(DRIVEN_SPP),
            f"materials bench: kernel launches {launches}")
    require(int(tc.overflow_flag(dev).item()) == 0,
            "materials bench: stack overflow in the kernel")
    require(img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(img).all()
            and img.mean() > 0, "materials bench: image not finite")
    rays = WIDTH * HEIGHT * 2 * (MAX_DEPTH + 1) * DRIVEN_SPP
    out["bench"] = {
        "file_bytes": os.path.getsize(path), "write_s": write_s,
        "parse_s": parse_s, "render_s": render_s,
        "stats_timings": stats.timings, "rays_per_s": rays / render_s,
        "main_path_rays_per_s": main_rays_per_s,
        "waves": DRIVEN_SPP, "launches": launches, "launches_per_wave": {
            k: v / DRIVEN_SPP for k, v in launches.items()},
        "img_mean": float(img.mean()), "band_tris": band_tris,
        "tris": job.scene.geometry.n_prims, "materials": mats.n,
        "textures": job.scene.textures.n,
        "texture_kinds": list(job.scene.textures.kinds_present),
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    # (c) a window across every band: card against CPU
    cpu_job = parser.parse(text, resolver=resolver, log=QUIET, device="cpu")
    sphere = sb.bench_scene().meshes[0]
    pole = sphere.verts[sphere.uvs[:, 1] == 0.0][0]   # v = 0 faces the camera
    x0, y0 = window_origin(cpu_job.camera, pole)
    hit = window_materials(cpu_job, x0, y0)
    bands = set(range(len(BANDS)))
    require(bands <= hit, f"materials window at {(x0, y0)} hits materials "
            f"{sorted(hit)}, not every band {sorted(bands)}")
    t0 = time.time()
    card = window_render(job, dev, x0, y0)
    card_s = time.time() - t0
    t0 = time.time()
    cpu = window_render(cpu_job, "cpu", x0, y0)
    cpu_s = time.time() - t0
    close, rel_mean = compare_images("materials window, card vs CPU", cpu,
                                     card)
    out["window"] = {"x0": x0, "y0": y0, "waves": WINDOW_WAVES,
                     "materials_hit": sorted(hit), "card_s": card_s,
                     "cpu_s": cpu_s, "pixels_close": close,
                     "rel_mean": rel_mean, "img_mean": float(card.mean())}
    say("materials_path", **out)


# alpha cut-outs and the remaining lights: the two fixture scenes and the
# reference's renders of them (tools/make_lights_golden.py)
ALPHA_PBRT = os.path.join(SCENES_DIR, "alpha.pbrt")
LIGHTS_PBRT = os.path.join(SCENES_DIR, "lights.pbrt")
LIGHTS_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tools", "lights_golden.npz")
# alpha.pbrt: direct lighting to depth 1 (2 levels), 2 spp, one light: a
# level is the surface query and estimate_direct's occlusion and BSDF
# queries, each ALPHA_ROUNDS closest-hit launches on an alpha scene
ALPHA_FILE_LAUNCHES = {"traverse6:closest": 2 * 2 * 3 * st.ALPHA_ROUNDS}
LIGHTS_WAVES = 4           # lights.pbrt: 4 spp, path depth 3
LIGHTS_DEPTH = 3
# a path wave at depth MAX_DEPTH on an alpha scene: 1 camera, MAX_DEPTH
# extension and MAX_DEPTH + 1 shadow queries, each ALPHA_ROUNDS closest-hit
# launches (48), and no any-hit or mixed launch
ALPHA_WAVE_LAUNCHES = {"traverse6:closest": st.ALPHA_ROUNDS * (
    1 + MAX_DEPTH + MAX_DEPTH + 1)}
# ... and its traversal queries in lanes: a closest-hit query counts its
# rays ALPHA_ROUNDS times, an occlusion query once more
ALPHA_WAVE_QUERIES = (st.ALPHA_ROUNDS * (1 + MAX_DEPTH)
                      + (st.ALPHA_ROUNDS + 1) * (MAX_DEPTH + 1))
ALPHA_FLOOR = [
    'Texture "floorcut" "float" "checkerboard" "float uscale" [16] '
    '"float vscale" [16] "float tex1" [1] "float tex2" [0]',
    "AttributeBegin", "Rotate -90 1 0 0",
    'LightSource "infinite" "string mapname" ["envmap.pfm"]',
    "AttributeEnd"]
# (c)'s window: centred on this floor point, a corner of four checker cells
# under the displaced sphere's front (cut and kept cells, the sphere and the
# rays that fall through the floor all in view)
ALPHA_WINDOW_POINT = (-0.75, 0.0, 0.0)


def alpha_env_bench_pbrt(path):
    """``bench_scene_pbrt``'s file with two changes: an infinite light over
    envmap.pfm (z up, turned to y up) beside the area light, and the 12 x 12
    floor under a 16 x 16 checkerboard alpha mask (its trianglemesh gains
    uv coordinates and the mask), so that half its cells are cut. Every
    other line is the writer's, byte for byte."""
    b = bench_scene_pbrt(path, DRIVEN_SPP)
    floor = b.meshes[2]
    require(floor.n_faces == 2 and b.mesh_area_light[2] is None,
            "alpha bench: the bench scene's third mesh is not the floor")
    line = trianglemesh(floor, floor.faces) + "\n"
    with open(path) as f:
        text = f.read()
    require(text.count(line) == 1 and text.count("WorldBegin\n") == 1,
            "alpha bench: the floor's line is not in the file once")
    text = text.replace(line, line[:-1] + ' "float uv" [0 0 1 0 1 1 0 1] '
                        '"texture alpha" "floorcut"\n')
    text = text.replace("WorldBegin\n",
                        "WorldBegin\n" + "\n".join(ALPHA_FLOOR) + "\n")
    with open(path, "w") as f:
        f.write(text)


def window_kinds(job, x0, y0):
    """What the window's first camera rays see (CPU): "floor" (a kept cell),
    "sphere" (anything above the floor) and "through" (no hit: a cut cell
    or the sky)."""
    px, py = rend.pixel_grid(WINDOW, WINDOW, x0=x0, y0=y0, device="cpu")
    cs = samplers.camera_samples(job.sampler, px, py, torch.zeros_like(px))
    rays, _, _ = cameras.generate_rays(job.camera, cs, job.width, job.height)
    geom = st.to_device(job.scene.geometry, "cpu")
    hits = st.intersect(geom, rays)
    y = st.interaction(geom, rays, hits)["p"].y
    kinds = set()
    if (hits.prim < 0).any():
        kinds.add("through")
    if (hits.hit & (y.abs() < 1e-3)).any():
        kinds.add("floor")
    if (hits.hit & (y > 1e-2)).any():
        kinds.add("sphere")
    return kinds


def alpha_round(geom, dev):
    """One continuation round on (b)'s scene: the camera wave's first hits,
    the lanes whose hit is cut re-traced and every other lane dead. Times
    (CUDA events) of the whole round through ``scene.types`` (sort, gather,
    launch, unsort, finish), of its sort alone and of the kernel alone on the
    sorted planes, beside the kernel on the whole live camera wave."""
    _, _, _, _, rays = camera_wave(dev)
    with torch.no_grad():
        h = st._closest(geom, rays, False)
        cut = st._alpha_cut(geom, h)
        cont = rays._replace(
            tmin=torch.where(cut, h.t + st.ray_epsilon(h.t), rays.tmin),
            tmax=torch.where(cut, rays.tmax, -1.0))
        lo, hi = geom.world_bound[0], geom.world_bound[1]
        oc, dc = tc._components(cont.o, cont.d)
        key = tc.sort_key_i32(oc, dc, cont.tmin, cont.tmax, lo, hi)
        order = torch.sort(key, stable=True).indices
        s = [p[order] for p in (*oc, *dc, cont.tmin, cont.tmax)]
        so, sd = vm.V3(*s[0:3]), vm.V3(*s[3:6])
        return {
            "lanes": int(cut.numel()), "live_lanes": int(cut.sum()),
            "round_ms": time_ms(lambda: st._closest(geom, cont, True)),
            "sort_ms": time_ms(lambda: torch.sort(key, stable=True)),
            "kernel_ms": time_ms(lambda: tc.traverse6(
                geom.packed, so, sd, s[6], s[7])),
            "kernel_whole_camera_wave_ms": time_ms(lambda: tc.traverse6(
                geom.packed, rays.o, rays.d, rays.tmin, rays.tmax))}


def alpha_env_path_phase(dev, main_rays_per_s):
    """Alpha cut-outs and the remaining lights on the card, through the v6
    kernel's closest-hit mode inside the static continuation loop and its
    three modes with escaped rays carrying radiance. (a) ``render_pbrt`` of
    scenes/alpha.pbrt (direct lighting, 4 rounds a query: 48 closest-hit
    launches and no other kernel) and scenes/lights.pbrt (path depth 3: 1
    closest, 3 mixed, 1 any-hit launch a wave) against the reference's
    renders by ``compare_images``. (b) The bench scene at full width with
    an infinite light over envmap.pfm and its floor under a checkerboard
    alpha mask, through ``manager.run``: 48 closest-hit launches a wave and
    no other kernel, the traversal queries as the reference counts them, a
    finite image; render seconds and rays/s beside main_path's; one
    continuation round timed. (c) A WINDOW x WINDOW window of (b) where cut
    and kept floor cells and the sphere meet, its first WINDOW_WAVES waves
    on the card against the CPU by ``compare_images``."""
    os.makedirs(PBRT_DIR, exist_ok=True)
    golden = np.load(LIGHTS_GOLDEN)
    out = {}
    # (a) the two fixtures against the reference
    for name, path, want in (
            ("alpha", ALPHA_PBRT, ALPHA_FILE_LAUNCHES),
            ("lights", LIGHTS_PBRT, {
                "traverse6:closest": LIGHTS_WAVES,
                "traverse6:mixed": LIGHTS_DEPTH * LIGHTS_WAVES,
                "traverse6:any": LIGHTS_WAVES})):
        tc.reset_overflow(dev)
        tc.reset_launches()
        t0 = time.time()
        img = manager.render_pbrt(path, log=QUIET, device=dev)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = counted_launches()
        require(launches == want, f"{name} scene: kernel launches {launches}")
        close, rel_mean = compare_images(f"{name} scene vs the reference",
                                         golden[name], img)
        out[name] = {"seconds": secs, "launches": launches,
                     "pixels_close": close, "rel_mean": rel_mean,
                     "img_mean": float(img.mean()),
                     "golden_mean": float(golden[name].mean())}
    # (b) the bench scene with an environment light and an alpha floor
    path = os.path.join(PBRT_DIR, "alpha_env_bench.pbrt")
    alpha_env_bench_pbrt(path)
    with open(path) as f:
        text = f.read()
    resolver = resources.Resolver([PBRT_DIR, SCENES_DIR])
    t0 = time.time()
    job = parser.parse(text, resolver=resolver, log=QUIET, device=dev)
    parse_s = time.time() - t0
    g, lt = job.scene.geometry, job.scene.lights
    require(g.n_prims == 103956 and g.has_alpha and lt.env_light_index >= 0
            and job.sampler.spp == DRIVEN_SPP,
            "alpha bench: the scene did not compile as written")
    stats = stats_mod.RenderStats()
    tc.reset_overflow(dev)
    tc.reset_launches()
    t0 = time.time()
    img = manager.run(job, log=QUIET, stats=stats, device=dev)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches = counted_launches()
    want = {k: v * DRIVEN_SPP for k, v in ALPHA_WAVE_LAUNCHES.items()}
    require(launches == want, f"alpha bench: kernel launches {launches}, "
            f"expected {want}")
    require(int(tc.overflow_flag(dev).item()) == 0,
            "alpha bench: stack overflow in the kernel")
    require(img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(img).all()
            and img.mean() > 0, "alpha bench: image not finite")
    lanes = WIDTH * HEIGHT
    queries = stats.counters["rays/traversal_queries"]
    require(queries == lanes * ALPHA_WAVE_QUERIES * DRIVEN_SPP,
            f"alpha bench: {queries} traversal queries counted")
    rays = lanes * 2 * (MAX_DEPTH + 1) * DRIVEN_SPP
    out["bench"] = {
        "file_bytes": os.path.getsize(path), "parse_s": parse_s,
        "waves": DRIVEN_SPP, "render_s": render_s,
        "rays_per_s": rays / render_s,
        "main_path_rays_per_s": main_rays_per_s,
        "rays_per_s_over_main_path": rays / render_s / main_rays_per_s,
        "stats_timings": stats.timings, "launches": launches,
        "launches_per_wave": {k: v / DRIVEN_SPP
                              for k, v in launches.items()},
        "rays/traversal_queries": queries, "img_mean": float(img.mean()),
        "tris": g.n_prims, "env_map": list(lt.env_map.shape),
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    out["alpha_round"] = alpha_round(st.to_device(g, dev), dev)
    # (c) a window where cut and kept cells and the sphere meet: card
    # against CPU
    cpu_job = parser.parse(text, resolver=resolver, log=QUIET, device="cpu")
    x0, y0 = window_origin(cpu_job.camera, ALPHA_WINDOW_POINT)
    kinds = window_kinds(cpu_job, x0, y0)
    require(kinds == {"floor", "sphere", "through"},
            f"alpha window at {(x0, y0)} sees only {sorted(kinds)}")
    t0 = time.time()
    card = window_render(job, dev, x0, y0)
    card_s = time.time() - t0
    t0 = time.time()
    cpu = window_render(cpu_job, "cpu", x0, y0)
    cpu_s = time.time() - t0
    close, rel_mean = compare_images("alpha window, card vs CPU", cpu, card)
    out["window"] = {"x0": x0, "y0": y0, "waves": WINDOW_WAVES,
                     "sees": sorted(kinds), "card_s": card_s, "cpu_s": cpu_s,
                     "pixels_close": close, "rel_mean": rel_mean,
                     "img_mean": float(card.mean())}
    say("alpha_env_path", **out)


sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tools"))
import make_sampling_golden as sampling_golden  # noqa: E402

SAMPLING_DEPTH = 3            # scenes/sampling.pbrt's path depth
SAMPLING_WAVES = {"v4": 32, "v5": 8}      # the others: 4 waves


@timed_part("profiled_waves")
def device_kernels_a_wave(wave):
    """Device kernels one call of `wave` runs, from a torch.profiler trace
    (an entry with device time and no host time lies on the card's
    timeline). The trace records the card's activity alone: host operator
    events add nothing to the count, and building them took 41 s of
    sampling_path and 68 s of volume_path on an H100's host."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wave()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.cpu_time_total == 0 and e.self_device_time_total > 0)
    require(n > 0, "device_kernels_a_wave: the trace holds no device kernel")
    return n


def profiled_wave(job, dev, s):
    """One wave of `job` at sample index `s` into a film of its filter, for
    ``device_kernels_a_wave``."""
    scene = st.to_device(job.scene, dev)
    li = manager.build_li(job, log=QUIET, device=dev)
    px, py = rend.pixel_grid(job.width, job.height, device=dev)
    film = film_mod.make_film(job.width, job.height,
                              filter_name=job.filter_name,
                              filter_params=job.filter_params, device=dev)

    def wave():
        with torch.no_grad():
            rend.render_wave(
                scene, job.camera, job.sampler, film, px, py,
                torch.full(px.shape, s, dtype=torch.int32, device=dev),
                li_fn=li, width=job.width, height=job.height,
                spp=job.sampler.spp, device=dev)
    return wave


def wave_ms(wave, waves=2):
    """Host-clock ms a call of `wave` takes, after one warm-up call, over
    `waves` calls ended by a synchronize."""
    wave()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(waves):
        wave()
    torch.cuda.synchronize()
    return (time.time() - t0) / waves * 1e3


def sampling_bench_b2(path):
    """The bench scene's .pbrt text with the environment camera (from the
    bench camera's eye), halton at DRIVEN_SPP and the gaussian filter."""
    bench_scene_pbrt(path, DRIVEN_SPP)
    with open(path) as f:
        text = f.read()
    for old, new in (
            (f'Sampler "lowdiscrepancy" "integer pixelsamples" '
             f'[{DRIVEN_SPP}]',
             f'Sampler "halton" "integer pixelsamples" [{DRIVEN_SPP}]\n'
             'PixelFilter "gaussian"'),
            ('Camera "perspective" "float fov" [42]',
             'Camera "environment"')):
        require(old in text, f"bench .pbrt text lacks {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return text


def sampling_path_phase(dev, main_rays_per_s):
    """Samplers, filters, cameras, the sampled spectrum mode, checkpoints
    and the adaptive renderer on the card, through the v6 kernel. (a) The
    five variants of scenes/sampling.pbrt through ``render_pbrt`` against
    the reference's renders (tools/sampling_golden.npz) by
    ``compare_images``: 1 closest, 3 mixed and 1 any-hit launch a wave and
    no other kernel, the adaptive renderer's refinement waves included, its
    refined pixels equal to the reference's; V1 stopped after wave 2 and
    resumed from its checkpoint equals the uninterrupted render bit for
    bit. (b1) The bench scene through ``render`` with stratified 4x4 and
    mitchell, (b2) its .pbrt text with the environment camera, halton and
    gaussian in the sampled mode through ``render_pbrt``: every lane live,
    7 v6 launches a wave and no other kernel, a finite image; render
    seconds and rays/s beside main_path's and device kernels a wave beside
    main_path's wave, and the three waves' host-clock ms timed in turns
    (main, b1, b2, b2, b1, main). (c) A WINDOW x WINDOW window of each at
    the image's lower left corner (footprints cross the edge), first
    WINDOW_WAVES waves, card against CPU by ``compare_images``. The spectrum mode is "rgb" again
    after each sampled render. Returns the main path's device kernels a
    wave."""
    os.makedirs(PBRT_DIR, exist_ok=True)
    golden = np.load(sampling_golden.GOLDEN)
    out = {}
    # (a) the five variants against the reference
    for name in sampling_golden.VARIANTS:
        waves = SAMPLING_WAVES.get(name, 4)
        messages = []
        tc.reset_overflow(dev)
        tc.reset_launches()
        t0 = time.time()
        try:
            img = manager.render_pbrt(
                sampling_golden.variant_text(name),
                search_paths=[SCENES_DIR],
                overrides=sampling_golden.OVERRIDES.get(name),
                log=lambda m, *a, **k: messages.append(str(m)), device=dev)
            torch.cuda.synchronize()
        finally:
            spec.set_mode("rgb")
        secs = time.time() - t0
        launches = counted_launches()
        want = {"traverse6:closest": waves,
                "traverse6:mixed": SAMPLING_DEPTH * waves,
                "traverse6:any": waves}
        require(launches == want, f"sampling {name}: kernel launches "
                f"{launches}, expected {want}")
        require(int(tc.overflow_flag(dev).item()) == 0,
                f"sampling {name}: stack overflow in the kernel")
        close, rel_mean = compare_images(f"sampling {name} vs the reference",
                                         golden[name], img)
        out[name] = {"seconds": secs, "launches": launches,
                     "pixels_close": close, "rel_mean": rel_mean,
                     "img_mean": float(img.mean())}
        if name == "v5":
            refined = sampling_golden.refined_from(messages)
            require(refined == int(golden["v5_n_refined"]),
                    f"adaptive: {refined} pixels refined, the reference "
                    f"{int(golden['v5_n_refined'])}")
            out[name]["n_refined"] = refined
    # a V1 render stopped after wave 2 and resumed from its checkpoint
    job = parser.parse(sampling_golden.variant_text("v1"),
                       resolver=resources.Resolver([SCENES_DIR]), log=QUIET,
                       device=dev)
    li = manager.build_surface_li(job, log=QUIET)
    args = (job.scene, job.camera, job.sampler, li, job.width, job.height)
    kw = dict(filter_name=job.filter_name, filter_params=job.filter_params,
              device=dev)
    whole = rend.render(*args, **kw)
    ck = os.path.join(PBRT_DIR, "sampling_v1.ckpt.npz")
    if os.path.exists(ck):
        os.remove(ck)

    class Stop(Exception):
        pass

    def stop_after_2(s, spp, film):
        if s > 2:           # the wave-2 checkpoint is written after wave 2
            raise Stop()
    try:
        rend.render(*args, checkpoint_path=ck, checkpoint_every=2,
                    progress=stop_after_2, **kw)
        require(False, "checkpoint: the render was not stopped")
    except Stop:
        pass
    resumed = rend.render(*args, checkpoint_path=ck, checkpoint_every=2,
                          **kw)
    require(np.array_equal(resumed, whole),
            "checkpoint: the resumed render differs from the whole one")
    out["checkpoint"] = {"resumed_equals_whole": True, "waves": job.sampler.spp}
    # the main path's wave, for the device kernels a wave
    main_job = bench_job(dev)
    main_kernels = device_kernels_a_wave(profiled_wave(main_job, dev, 1))
    rays = WIDTH * HEIGHT * 2 * (MAX_DEPTH + 1) * DRIVEN_SPP

    def drive(what, run):
        tc.reset_overflow(dev)
        tc.reset_launches()
        t0 = time.time()
        img, stats = run()
        torch.cuda.synchronize()
        wall_s = time.time() - t0
        launches = counted_launches()
        want = path_launches(DRIVEN_SPP)
        require(launches == want, f"{what}: kernel launches {launches}, "
                f"expected {want}")
        require(int(tc.overflow_flag(dev).item()) == 0,
                f"{what}: stack overflow in the kernel")
        require(img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(img).all()
                and img.mean() > 0, f"{what}: image not finite")
        render_s = sum(stats.timings.values())
        return img, {"waves": DRIVEN_SPP, "wall_s": wall_s,
                     "render_s": render_s,
                     "rays_per_s": rays / render_s,
                     "main_path_rays_per_s": main_rays_per_s,
                     "rays_per_s_over_main_path":
                         rays / render_s / main_rays_per_s,
                     "launches": launches,
                     "launches_per_wave": {k: v / DRIVEN_SPP
                                           for k, v in launches.items()},
                     "img_mean": float(img.mean()),
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    def window(what, gpu_job, cpu_job):
        """(c): the window at the image's lower left corner (the floor in
        both views), card against CPU."""
        y0 = HEIGHT - WINDOW
        t0 = time.time()
        card = window_render(gpu_job, dev, 0, y0)
        card_s = time.time() - t0
        cpu = window_render(cpu_job, "cpu", 0, y0)
        close, rel_mean = compare_images(
            f"sampling window {what}, card vs CPU", cpu, card)
        out[f"window_{what}"] = {
            "x0": 0, "y0": y0, "waves": WINDOW_WAVES, "card_s": card_s,
            "pixels_close": close, "rel_mean": rel_mean,
            "img_mean": float(card.mean())}
    # (b1) the bench scene through render: stratified 4x4, mitchell
    b1 = dataclasses.replace(
        main_job, sampler=samplers.make_sampler("stratified", DRIVEN_SPP),
        filter_name="mitchell")
    require(b1.sampler.nx == b1.sampler.ny == 4, "b1: not 4x4 strata")
    ig = pi.PathIntegrator(max_depth=MAX_DEPTH)
    li = lambda s_, r, d, c: pi.li(ig, s_, r, d, c)

    def run_b1():
        stats = stats_mod.RenderStats()
        img = rend.render(st.to_device(b1.scene, dev), b1.camera, b1.sampler,
                          li, WIDTH, HEIGHT, filter_name="mitchell",
                          stats=stats, device=dev)
        return img, stats
    _, out["b1"] = drive("sampling b1", run_b1)
    out["b1"]["device_kernels_a_wave"] = device_kernels_a_wave(
        profiled_wave(b1, dev, 1))
    out["b1"]["main_path_device_kernels_a_wave"] = main_kernels
    window("b1", b1, on_cpu(b1))
    # (b2) its .pbrt text: environment camera, halton, gaussian, sampled
    path = os.path.join(PBRT_DIR, "sampling_bench.pbrt")
    text = sampling_bench_b2(path)

    def run_b2():
        stats = stats_mod.RenderStats()
        img = manager.render_pbrt(path, search_paths=[SCENES_DIR],
                                  overrides={"spectrum": "sampled"},
                                  log=QUIET, stats=stats, device=dev)
        return img, stats
    try:
        _, out["b2"] = drive("sampling b2", run_b2)
        resolver = resources.Resolver([PBRT_DIR, SCENES_DIR])
        b2 = parser.parse(text, resolver=resolver, log=QUIET, device=dev)
        require(b2.camera.kind == cameras.ENVIRONMENT
                and b2.sampler.kind == samplers.HALTON
                and b2.filter_name == "gaussian",
                "b2: the scene did not compile as written")
        out["b2"]["device_kernels_a_wave"] = device_kernels_a_wave(
            profiled_wave(b2, dev, 1))
        out["b2"]["main_path_device_kernels_a_wave"] = main_kernels
        window("b2", b2, parser.parse(text, resolver=resolver, log=QUIET,
                                      device="cpu"))
        # the three waves in turns, each in its own spectrum mode, so that
        # their ratios are read under the same host conditions
        waves = {"main": (profiled_wave(main_job, dev, 1), "rgb"),
                 "b1": (profiled_wave(b1, dev, 1), "rgb"),
                 "b2": (profiled_wave(b2, dev, 1), "sampled")}
        turns = {k: [] for k in waves}
        for k in ("main", "b1", "b2", "b2", "b1", "main"):
            spec.set_mode(waves[k][1])
            turns[k].append(wave_ms(waves[k][0]))
        out["wave_ms_in_turns"] = turns
        out["wave_ms_over_main"] = {
            k: sum(turns[k]) / sum(turns["main"]) for k in ("b1", "b2")}
    finally:
        spec.set_mode("rgb")
    say("sampling_path", **out)
    return main_kernels


import make_accel_golden as accel_golden  # noqa: E402
import make_cache_golden as cache_golden  # noqa: E402
import make_volume_golden as volume_golden  # noqa: E402

ACCEL_WAVES = 1             # (b): path waves of the bench scene a walk
ACCEL_WINDOW_WAVES = 1      # (c): its window's waves on each side
# (c)'s window: centred on the displaced sphere's centre
SPHERE_POINT = (-0.4, 1.05, 0.2)


def own_hit(geom, rays, prim, deltas=None):
    """Triangle `prim` of each ray (lerped to its time by `deltas`) tested
    by ONE routine, whichever walk found it: (t, outside) where outside
    marks a hit on a ray that misses the triangle's own box (a hit no box
    walk need find: ``aggregate_compare``)."""
    j = prim.clamp_min(0).long()
    tri = [vm.to_arr(a)[j] for a in (geom.v0, geom.e1, geom.e2)]
    if deltas is not None:
        tri = [a + rays.time[:, None] * da[j] for a, da in zip(tri, deltas)]
    o, d = vm.to_arr(rays.o), vm.to_arr(rays.d)
    _, t, _, _ = tv.mt_test_plain(o, d, *tri, rays.tmin, rays.tmax)
    v0, e1, e2 = tri
    corners = torch.stack([v0, v0 + e1, v0 + e2])
    inside = tv._slab_test(o, tv.inv_dir(d), corners.amin(0),
                           corners.amax(0), rays.tmin, rays.tmax)
    return t, (prim >= 0) & ~inside


def hits_compare(what, h, h6, geom, rays, deltas=None):
    """An alternate walk's closest hits `h` against v6's `h6` on the same
    rays: prim equal on every ray but those where a side hits outside its
    triangle's own box (counted apart, as ``aggregate_compare`` does) and
    ties, where the two triangles meet the ray at the same t bit for bit
    (a ray through an edge two triangles share: each walk keeps the one it
    tests first), both tested by one routine (``own_hit``); t within
    T_RTOL where both hit the same triangle."""
    differ = h.prim != h6.prim
    t_w, out_w = own_hit(geom, rays, h.prim, deltas)
    t_6, out_6 = own_hit(geom, rays, h6.prim, deltas)
    apart = differ & (out_w | out_6)
    tie = differ & ~apart & (h.prim >= 0) & (h6.prim >= 0) & (t_w == t_6)
    same = ~differ & (h.prim >= 0)
    rel = ((h.t - h6.t).abs() / h6.t.abs())[same]
    out = {"rays": rays.n, "hits": int(same.sum()),
           "prim_differ": int(differ.sum()), "apart": int(apart.sum()),
           "ties": int(tie.sum()),
           "max_rel_dt": float(rel.max()) if rel.numel() else 0.0}
    require(int((differ & ~apart & ~tie).sum()) == 0,
            f"{what}: prims differ from v6's on {out}")
    require(out["max_rel_dt"] <= T_RTOL, f"{what}: t off v6's: {out}")
    return out


def accel_path_phase(dev, scene, inc):
    """The grid and kd-tree accelerators on the card: plain torch walks, no
    kernel. (a) ``render_pbrt`` of the sphere scene of
    tests/test_alt_accels.py and of scenes/cornell.pbrt (1 spp) under each
    accelerator against tools/accel_golden.npz by ``compare_images``, with
    no kernel launched. (b) The bench scene, nothing cut, compiled with each
    accelerator: build seconds; the camera wave's and the sorted incoherent
    rays' closest hits against v6's (``hits_compare``); the camera
    query's host torch operations against its steps (DDA steps or nodes);
    ACCEL_WAVES path waves at depth MAX_DEPTH, no kernel launched, ms a wave
    and steps a query, the image against the same waves through v6; the
    scene written as _build/pbrt/accel_bench_{grid,kdtree}.pbrt. (c) A
    WINDOW x WINDOW window about the displaced sphere, ACCEL_WINDOW_WAVES
    waves, card against CPU."""
    t_phase = time.time()
    os.makedirs(PBRT_DIR, exist_ok=True)
    golden = np.load(accel_golden.GOLDEN)
    out = {}
    for name in accel_golden.VARIANTS:
        tc.reset_launches()
        t0 = time.time()
        img = manager.render_pbrt(
            accel_golden.variant_text(name), search_paths=[SCENES_DIR],
            overrides=accel_golden.overrides(name), log=QUIET, device=dev)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = counted_launches()
        require(launches == {}, f"accel {name}: kernels launched {launches}")
        close, rel_mean = compare_images(f"accel {name} vs the reference",
                                         golden[name], img)
        out[name] = {"seconds": secs, "pixels_close": close,
                     "rel_mean": rel_mean, "img_mean": float(img.mean())}
    _, _, _, _, cam_rays = camera_wave(dev)
    ig = pi.PathIntegrator(max_depth=MAX_DEPTH)
    li = lambda s_, r, d, c: pi.li(ig, s_, r, d, c)
    _, v6_img, v6_info, _ = drive_waves(
        "accel_path v6", scene, dev, li, ACCEL_WAVES,
        path_launches(1))
    for kind, mod in (("grid", grid_mod), ("kdtree", kd_mod)):
        t0 = time.time()
        host = sb.bench_scene().build(accelerator=kind)
        res = {"build_s": time.time() - t0, "tris": host.geometry.n_prims}
        alt = host.geometry.alt
        res.update({"max_cell": alt.max_cell, "voxels": list(alt.nv),
                    "tri_ids": int(alt.tri_ids.size)} if kind == "grid"
                   else {"max_leaf": alt.max_leaf, "nodes": alt.n_nodes})
        g = st.to_device(host, dev)
        tc.reset_launches()
        for key, rays in (("camera", cam_rays), ("incoherent", inc)):
            res[key] = hits_compare(
                f"{kind} {key} rays", st.intersect(g.geometry, rays),
                st.intersect(scene.geometry, rays), scene.geometry, rays)
        # the camera query: its time, and its host operations (counted in
        # a second call) against its steps
        torch.cuda.synchronize()
        t0 = time.time()
        st.intersect(g.geometry, cam_rays)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        steps = mod.STEPS["steps"]
        with stats_mod.TorchOps() as ops:
            st.intersect(g.geometry, cam_rays)
        steps = mod.STEPS["steps"] - steps
        res["camera_query"] = {"ms": ms, "steps": steps, "torch_ops": ops.n,
                               "torch_ops_per_step": ops.n / steps}
        queries, steps = mod.STEPS["queries"], mod.STEPS["steps"]
        _, img, info, _ = drive_waves(f"accel_path {kind}", g, dev, li,
                                      ACCEL_WAVES, {})
        queries = mod.STEPS["queries"] - queries
        steps = mod.STEPS["steps"] - steps
        close, rel_mean = compare_images(f"accel {kind} waves vs v6's",
                                         v6_img, img)
        res["waves"] = {
            "waves": ACCEL_WAVES, "ms_a_wave": info["seconds"] / ACCEL_WAVES
            * 1e3, "v6_ms_a_wave": v6_info["seconds"] / ACCEL_WAVES * 1e3,
            "queries": queries, "steps": steps,
            "steps_per_query": steps / queries, "pixels_close_to_v6": close,
            "rel_mean_to_v6": rel_mean, "img_mean": info["img_mean"],
            "peak_mem_bytes": info["peak_mem_bytes"]}
        job = bench_job(dev, host)
        x0, y0 = window_origin(job.camera, SPHERE_POINT)
        t0 = time.time()
        card = window_render(job, dev, x0, y0, waves=ACCEL_WINDOW_WAVES)
        card_s = time.time() - t0
        t0 = time.time()
        cpu = window_render(on_cpu(job), "cpu", x0, y0,
                            waves=ACCEL_WINDOW_WAVES)
        cpu_s = time.time() - t0
        close, rel_mean = compare_images(f"accel {kind} window, card vs CPU",
                                         cpu, card)
        res["window"] = {"x0": x0, "y0": y0, "waves": ACCEL_WINDOW_WAVES,
                         "card_s": card_s, "cpu_s": cpu_s,
                         "pixels_close": close, "rel_mean": rel_mean}
        out[kind] = res
        # the same scene as a file, for tools/profile_torch_wave.py --pbrt
        bench_text_with(os.path.join(PBRT_DIR, f"accel_bench_{kind}.pbrt"),
                        {PATH_LINE: f'{PATH_LINE}\nAccelerator "{kind}"'})
    say("accel_path", seconds=time.time() - t_phase, **out)


WALK_SHADOW_TMAX = 1.0      # (c): the incoherent rays cut to shadow rays
WALK_CPU_RAYS = 4096        # (e): every 64th camera ray


def map_rays(fn, rays):
    """`fn` applied to every tensor plane of `rays` (a selection, a move)."""
    return vm.Rays(*(vm.V3(*(fn(c) for c in f)) if isinstance(f, vm.V3)
                     else fn(f) for f in rays))


def soup_deltas(cl, n):
    """A moving cluster tree's (close - open) triangle deltas, put back in
    prim order: three (n, 3) arrays (zero for a prim the tree lacks)."""
    ok = cl.tri_id >= 0
    out = []
    for a in (cl.tri_dv0, cl.tri_de1, cl.tri_de2):
        x = np.zeros((n, 3), np.float32)
        x[cl.tri_id[ok]] = a[ok]
        out.append(x)
    return out


def walk_occlusion_compare(what, occ, walk, geom, rays):
    """A walk's occlusion mask against v6's any-hit mask: equal but on rays
    counted apart (the closest hit of either side, on the rays where the
    masks differ, outside its triangle's own box)."""
    occ6 = st.intersect_p(geom, rays)
    differ = torch.nonzero(occ != occ6)[:, 0]
    apart = 0
    if differ.numel():
        sub = map_rays(lambda x: x[differ], rays)
        _, out_w = own_hit(geom, sub, walk(sub).prim)
        _, out_6 = own_hit(geom, sub, st.intersect(geom, sub).prim)
        apart = int((out_w | out_6).sum())
    out = {"rays": rays.n, "occluded": int(occ6.sum()),
           "differ": int(differ.numel()), "apart": apart}
    require(out["differ"] == apart,
            f"{what}: occlusion differs from v6's on {out}")
    return out


def timed_walk(walk, counters, rays, key="first_ms"):
    """A walk's query: (result, {`key`: its wall ms on the card, and the
    walk's counters it moved})."""
    torch.cuda.synchronize()
    before = dict(counters)
    t0 = time.time()
    res = walk(rays)
    torch.cuda.synchronize()
    out = {key: (time.time() - t0) * 1e3}
    out.update({k: counters[k] - before[k] for k in counters
                if k != "queries"})
    return res, out


def torch_ops_a_step(walk, counters, rays):
    """Host torch operations of one query (a second call), over the loop
    rounds (steps, and flushes) it took."""
    before = dict(counters)
    with stats_mod.TorchOps() as ops:
        walk(rays)
    rounds = sum(counters[k] - before[k] for k in counters if k != "queries")
    return {"torch_ops": ops.n, "torch_ops_per_step": ops.n / max(rounds, 1)}


def walks_path_phase(dev, host, scene, moving, shapes):
    """The reference's own traversal walks on the card at full width: the
    stackless walk of the per-triangle SAH BVH (accel/bvh.py,
    accel/traverse.py) and the cluster packet walk (accel/cluster.py),
    plain torch, no kernel of their own; v6 runs as their oracle. (a) The
    per-triangle build: seconds, nodes, depth. (b) Closest hits of the
    camera wave and of the sorted incoherent rays against v6's
    (``hits_compare``). (c) Occlusion masks against v6's any-hit
    masks on the camera wave and on the incoherent rays cut at
    WALK_SHADOW_TMAX (``walk_occlusion_compare``). (d) The moving scene's
    packet walk (build_motion's tree) on the camera wave with seeded times
    against v6's motion mode. (e) WALK_CPU_RAYS camera rays through each
    walk on the card and on the CPU: prim equal, t within T_RTOL, the
    masks equal. Timing: each query's first call (first_ms); a camera
    query of each walk again, warm (ms), beside v6's whole query queued;
    steps and flushes a query, host torch operations a step."""
    t_phase = time.time()
    cam, inc = shapes[0], shapes[1]
    g6 = scene.geometry
    hg = host.geometry
    soup = [vm.to_arr(a).cpu().numpy() for a in (g6.v0, g6.e1, g6.e2)]
    t0 = time.time()
    b = bvh_mod.build(*soup)
    out = {"smi": nvidia_smi_line(),
           "build": {"seconds": time.time() - t0, "tris": hg.n_prims,
                     "nodes": b.n_nodes, "max_depth": b.max_depth}}
    rows = torch.as_tensor(b.rows, device=dev)
    links = torch.as_tensor(b.links, device=dev)
    cl = cluster_mod.to_device(hg.cl, dev)
    walks = {
        "stackless": (lambda r: tv.intersect(rows, links, r),
                      lambda r: tv.intersect_p(rows, links, r), tv.STEPS),
        "packet": (lambda r: cluster_mod.intersect(cl, r),
                   lambda r: cluster_mod.intersect_p(cl, r),
                   cluster_mod.STEPS)}
    shadow = inc._replace(tmax=torch.full_like(inc.tmax, WALK_SHADOW_TMAX))
    for name, (closest, anyhit, counters) in walks.items():
        with part("walks"):
            h_cam, q_cam = timed_walk(closest, counters, cam)
            occ_sh, q_sh = timed_walk(anyhit, counters, shadow)
            res = {
                "camera": hits_compare(
                    f"{name} camera wave", h_cam, st.intersect(g6, cam), g6,
                    cam),
                "incoherent": hits_compare(
                    f"{name} incoherent rays", closest(inc),
                    st.intersect(g6, inc), g6, inc),
                "occlusion_camera": walk_occlusion_compare(
                    f"{name} camera occlusion", anyhit(cam), closest, g6,
                    cam),
                "occlusion_shadow": walk_occlusion_compare(
                    f"{name} shadow occlusion", occ_sh, closest, g6,
                    shadow),
                "camera_query": {**q_cam,
                                 **timed_walk(closest, counters, cam, "ms")[1],
                                 **torch_ops_a_step(closest, counters, cam)},
                "shadow_query": q_sh}
        out[name] = res
    # v6's whole query (sort, launch, finish), device ms by CUDA events
    out["v6_camera_ms_queued"] = time_ms(lambda: st.intersect(g6, cam))
    out["v6_motion_camera_ms_queued"] = time_ms(
        lambda: st.intersect(moving.geometry, cam))
    out["v6_shadow_ms_queued"] = time_ms(lambda: st.intersect_p(g6, shadow))
    # (d) the moving tree's packet walk against v6's motion mode
    gm = moving.geometry
    deltas = [torch.from_numpy(a).to(dev)
              for a in soup_deltas(gm.cl, gm.n_prims)]
    cm = cluster_mod.to_device(gm.cl, dev)
    camm = cam._replace(time=st._shutter_time01(gm, cam))   # as v6 reads it
    with part("walks"):
        h, q = timed_walk(lambda r: cluster_mod.intersect(cm, r),
                          cluster_mod.STEPS, camm)
        out["moving"] = {**hits_compare(
            "packet walk, moving scene", h, st.intersect(gm, cam), gm, camm,
            deltas), "query": q}
    # (e) card against CPU on every 64th camera ray
    sel = torch.arange(0, cam.n, cam.n // WALK_CPU_RAYS, device=dev)
    few = map_rays(lambda x: x[sel], cam)
    few_cpu = map_rays(lambda x: x.cpu(), few)
    cpu_walks = {
        "stackless": (lambda r: tv.intersect(b.rows, b.links, r),
                      lambda r: tv.intersect_p(b.rows, b.links, r)),
        "packet": (lambda r: cluster_mod.intersect(hg.cl, r),
                   lambda r: cluster_mod.intersect_p(hg.cl, r))}
    cvc = {}
    with part("card_vs_cpu"):
        for name, (closest, anyhit, _) in walks.items():
            card, cpu = closest(few), cpu_walks[name][0](few_cpu)
            same = card.prim.cpu() == cpu.prim
            hit = same & (cpu.prim >= 0)
            rel = ((card.t.cpu() - cpu.t).abs() / cpu.t.abs())[hit]
            occ_same = torch.equal(anyhit(few).cpu(),
                                   cpu_walks[name][1](few_cpu))
            cvc[name] = {"rays": few.n, "prim_differ": int((~same).sum()),
                         "hits": int(hit.sum()),
                         "max_rel_dt": float(rel.max()) if rel.numel()
                         else 0.0, "occlusion_equal": occ_same}
            require(cvc[name]["prim_differ"] == 0 and occ_same
                    and cvc[name]["max_rel_dt"] <= T_RTOL,
                    f"walks_path {name}: card vs CPU {cvc[name]}")
    out["card_vs_cpu"] = cvc
    say("walks_path", seconds=time.time() - t_phase, **out)


VOLUME_WAVES = 4
VOLUME_RES = 32             # (b)'s density grid: VOLUME_RES^3 from a seed
VOLUME_SEED = 21
# (b)'s volumegrid region: it encloses both spheres
VOLUME_BOUNDS = ((-1.7, -0.05, -1.3), (1.8, 2.3, 1.5))
# a path wave (1 closest, MAX_DEPTH mixed, 1 any) + the camera segment's
# closest + one shadow ray a step of single scattering's 32
VOLUME_WAVE_LAUNCHES = {"traverse6:closest": 2, "traverse6:mixed": MAX_DEPTH,
                        "traverse6:any": 33}
IGI_WAVES = 2
# igi's defaults: 64 paths x depth 5 VPLs a set, one any-hit launch each,
# beside the camera closest and uniform_sample_one_light's closest + any
IGI_WAVE_LAUNCHES = {"traverse6:closest": 2, "traverse6:any": 1 + 64 * 5}
IGI_WINDOW_WAVES = 1


def lanes_a_wave(launches):
    """Traversal lanes a wave launches: a mixed launch takes two waves'
    lanes (extension + shadow)."""
    return WIDTH * HEIGHT * sum(
        v * (2 if k.endswith(":mixed") else 1) for k, v in launches.items())


def surface_launches_a_wave(job, dev):
    """The v6 launches one wave of `job`'s surface integrator alone
    makes."""
    scene = st.to_device(job.scene, dev)
    li = manager.build_surface_li(job, log=QUIET, device=dev)
    px, py = rend.pixel_grid(job.width, job.height, device=dev)
    film = film_mod.make_film(job.width, job.height, device=dev)
    tc.reset_launches()
    with torch.no_grad():
        rend.render_wave(scene, job.camera, job.sampler, film, px, py,
                         torch.zeros_like(px), li_fn=li, width=job.width,
                         height=job.height, spp=job.sampler.spp, device=dev)
    torch.cuda.synchronize()
    return counted_launches()


def bench_text_with(path, replace, world=""):
    """``bench_scene_pbrt``'s text with the lines of `replace` (old: new)
    swapped and `world` put after WorldBegin."""
    bench_scene_pbrt(path)
    with open(path) as f:
        text = f.read()
    for old, new in replace.items():
        require(text.count(old) == 1, f"bench .pbrt text lacks {old!r}")
        text = text.replace(old, new)
    text = text.replace("WorldBegin\n", "WorldBegin\n" + world)
    with open(path, "w") as f:
        f.write(text)
    return text


PATH_LINE = f'SurfaceIntegrator "path" "integer maxdepth" [{MAX_DEPTH}]'


def volume_bench_text(path):
    """The bench scene in a volumegrid region about both spheres with
    VOLUME_RES^3 seeded densities, single scattering."""
    dens = np.random.RandomState(VOLUME_SEED).rand(VOLUME_RES ** 3).astype(
        np.float32) * np.float32(1.5)
    n = VOLUME_RES
    vol = (f'Volume "volumegrid" "point p0" [{pbrt_numbers(VOLUME_BOUNDS[0])}]'
           f' "point p1" [{pbrt_numbers(VOLUME_BOUNDS[1])}]'
           f' "integer nx" [{n}] "integer ny" [{n}] "integer nz" [{n}]'
           ' "rgb sigma_a" [0.05 0.05 0.05] "rgb sigma_s" [0.3 0.3 0.3]'
           f' "float g" [0.2] "float density" [{pbrt_numbers(dens)}]\n')
    return bench_text_with(path, {PATH_LINE: PATH_LINE + '\nVolumeIntegrator '
                                  '"single"'}, vol)


def once_ms(wave):
    """Host-clock ms of one call of `wave`, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.time()
    wave()
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3


@timed_part("waves_in_turns")
def turns_once(waves, order):
    """``once_ms`` of each wave of `waves`, in the turns `order`."""
    turns = {k: [] for k in waves}
    for k in order:
        turns[k].append(once_ms(waves[k]))
    return turns


def card_vs_cpu_window(what, job, text, resolver, waves, point, dev):
    """(c): the WINDOW x WINDOW window about `point`, `waves` waves of
    `job` on `dev` against the same text parsed for the CPU."""
    cpu_job = parser.parse(text, resolver=resolver, log=QUIET, device="cpu")
    x0, y0 = window_origin(cpu_job.camera, point)
    t0 = time.time()
    card = window_render(job, dev, x0, y0, waves=waves)
    card_s = time.time() - t0
    t0 = time.time()
    cpu = window_render(cpu_job, "cpu", x0, y0, waves=waves)
    cpu_s = time.time() - t0
    close, rel_mean = compare_images(f"{what} window, card vs CPU", cpu, card)
    return {"x0": x0, "y0": y0, "waves": waves, "card_s": card_s,
            "cpu_s": cpu_s, "pixels_close": close, "rel_mean": rel_mean,
            "img_mean": float(card.mean())}


def volume_path_phase(dev, main_rays_per_s, main_kernels):
    """Participating media on the card, through the v6 kernel. (a)
    ``render_pbrt`` of scenes/smoke.pbrt and both variants of
    scenes/volumes.pbrt against tools/volume_golden.npz: a wave's launches
    are the surface integrator's (one wave of it alone, counted) plus 1
    closest-hit launch, plus 32 any-hit launches under single scattering.
    (b) The bench scene inside a VOLUME_RES^3 volumegrid with single
    scattering, through ``build_li``: VOLUME_WAVES waves of exactly
    VOLUME_WAVE_LAUNCHES and no other kernel, a finite image; rays/s
    (lanes launched) and device kernels a wave beside main_path's, and the
    two waves' host-clock ms in turns (main, volume, volume, main). (c) A
    WINDOW x WINDOW window about the displaced sphere, card against CPU.
    main_kernels: the main path's device kernels a wave (sampling_path's
    count)."""
    t_phase = time.time()
    golden = np.load(volume_golden.GOLDEN)
    out = {}
    for name in ("smoke", "volumes", "volumes_single"):
        text = volume_golden.variant_text(name)
        job = parser.parse(text, resolver=resources.Resolver([SCENES_DIR]),
                           log=QUIET, device=dev)
        surf = surface_launches_a_wave(job, dev)
        extra = {"traverse6:closest": 1}
        if job.vol_integrator == "single":
            extra["traverse6:any"] = 32
        want = {k: (surf.get(k, 0) + extra.get(k, 0)) * job.sampler.spp
                for k in {**surf, **extra}}
        tc.reset_overflow(dev)
        tc.reset_launches()
        t0 = time.time()
        img = manager.render_pbrt(text, search_paths=[SCENES_DIR],
                                  log=QUIET, device=dev)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = counted_launches()
        require(launches == want, f"volume {name}: kernel launches "
                f"{launches}, expected {want}")
        close, rel_mean = compare_images(f"volume {name} vs the reference",
                                         golden[name], img)
        out[name] = {"seconds": secs, "launches": launches,
                     "surface_launches_a_wave": surf,
                     "pixels_close": close, "rel_mean": rel_mean,
                     "img_mean": float(img.mean())}
    os.makedirs(PBRT_DIR, exist_ok=True)
    path = os.path.join(PBRT_DIR, "volume_bench.pbrt")
    text = volume_bench_text(path)
    resolver = resources.Resolver([PBRT_DIR, SCENES_DIR])
    t0 = time.time()
    job = parser.parse(text, resolver=resolver, log=QUIET, device=dev)
    parse_s = time.time() - t0
    v = job.scene.volume
    require(v is not None and v.kind.tolist() == [2]
            and v.grid.shape == (VOLUME_RES,) * 3
            and job.vol_integrator == "single",
            "volume bench: the scene did not compile as written")
    scene = st.to_device(job.scene, dev)
    li = manager.build_li(job, log=QUIET, device=dev)
    _, img, info, _ = drive_waves("volume_path", scene, dev, li,
                                  VOLUME_WAVES, VOLUME_WAVE_LAUNCHES)
    require(img.mean() > 0, "volume bench: image black")
    lanes = lanes_a_wave(VOLUME_WAVE_LAUNCHES) * VOLUME_WAVES
    main_job = bench_job(dev)
    waves = {"main": profiled_wave(main_job, dev, 1),
             "volume": profiled_wave(job, dev, 1)}
    turns = turns_once(waves, ("main", "volume", "volume", "main"))
    out["bench"] = {
        "parse_s": parse_s, "file_bytes": os.path.getsize(path), **info,
        "rays_per_s": lanes / info["seconds"],
        "main_path_rays_per_s": main_rays_per_s,
        "rays_per_s_over_main_path": lanes / info["seconds"]
        / main_rays_per_s,
        "device_kernels_a_wave": device_kernels_a_wave(waves["volume"]),
        "main_path_device_kernels_a_wave": main_kernels,
        "wave_ms_in_turns": turns,
        "wave_ms_over_main": sum(turns["volume"]) / sum(turns["main"])}
    out["window"] = card_vs_cpu_window("volume", job, text, resolver,
                                       WINDOW_WAVES, SPHERE_POINT, dev)
    say("volume_path", seconds=time.time() - t_phase, **out)


def vpl_agreement(a, b):
    """Share of VPL slots whose validity agrees, and of the slots valid in
    both whose p, n and alpha agree to rtol 1e-5 / atol 1e-6."""
    va, vb = np.asarray(a["igi_vpl_valid"]), np.asarray(b["igi_vpl_valid"])
    both = va & vb
    ok = np.ones(int(both.sum()), bool)
    for k in ("igi_vpl_p", "igi_vpl_n", "igi_vpl_alpha"):
        ok &= np.isclose(np.asarray(a[k])[both], np.asarray(b[k])[both],
                         rtol=1e-5, atol=1e-6).all(-1)
    return float((va == vb).mean()), float(ok.mean()), int(both.sum())


def vpl_arrays(v):
    v3 = lambda t: np.stack([c.cpu().numpy() for c in t], -1)
    return {"igi_vpl_p": v3(v.p), "igi_vpl_n": v3(v.n),
            "igi_vpl_alpha": v3(v.alpha),
            "igi_vpl_valid": v.valid.cpu().numpy()}


def igi_path_phase(dev, main_rays_per_s):
    """The IGI integrator on the card, through the v6 kernel. (a)
    ``render_pbrt`` of scenes/igi-env.pbrt as written against
    tools/volume_golden.npz's image, its VPL set from ``preprocess`` against
    the reference's (valid slots equal, >= 0.995 of values close): 3
    closest-hit launches to shoot them, then a wave of 1 camera closest, 1
    closest + 1 any-hit for the sampled light and 48 any-hit for the VPLs.
    (b) The bench scene through igi at its defaults (64 paths, 4 sets, depth
    5): IGI_WAVES waves of exactly IGI_WAVE_LAUNCHES and no other kernel;
    rays/s beside main_path's, wave ms in turns (main, igi, igi, main, one
    wave each, warm from the driven waves). (c) A WINDOW x WINDOW window about the
    displaced sphere, IGI_WINDOW_WAVES waves, card against CPU, each with
    the VPLs it shot (their agreement printed)."""
    t_phase = time.time()
    golden = np.load(volume_golden.GOLDEN)
    text = volume_golden.variant_text("igi_env")
    job = parser.parse(text, resolver=resources.Resolver([SCENES_DIR]),
                       log=QUIET, device=dev)
    vpls = vpl_arrays(igi_mod.preprocess(
        manager.igi_integrator(job.surf_params), job.scene, device=dev))
    valid_eq, close, n_valid = vpl_agreement(vpls, golden)
    require(valid_eq == 1.0 and close >= 0.995,
            f"igi-env VPLs: valid slots agree {valid_eq}, values {close}")
    tc.reset_launches()
    t0 = time.time()
    img = manager.render_pbrt(text, search_paths=[SCENES_DIR], log=QUIET,
                              device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    spp = job.sampler.spp
    launches = counted_launches()
    want = {"traverse6:closest": 3 + 2 * spp, "traverse6:any": 49 * spp}
    require(launches == want, f"igi-env: kernel launches {launches}, "
            f"expected {want}")
    close_img, rel_mean = compare_images("igi-env vs the reference",
                                         golden["igi_env"], img)
    out = {"igi_env": {"seconds": secs, "launches": launches,
                       "vpls_valid": n_valid, "vpl_values_close": close,
                       "pixels_close": close_img, "rel_mean": rel_mean,
                       "img_mean": float(img.mean())}}
    os.makedirs(PBRT_DIR, exist_ok=True)
    path = os.path.join(PBRT_DIR, "igi_bench.pbrt")
    text = bench_text_with(path, {PATH_LINE: 'SurfaceIntegrator "igi"'})
    resolver = resources.Resolver([PBRT_DIR, SCENES_DIR])
    job = parser.parse(text, resolver=resolver, log=QUIET, device=dev)
    require(job.surf_integrator == "igi", "igi bench: not an igi job")
    scene = st.to_device(job.scene, dev)
    t0 = time.time()
    li = manager.build_li(job, log=QUIET, device=dev)
    torch.cuda.synchronize()
    preprocess_s = time.time() - t0
    _, img, info, _ = drive_waves("igi_path", scene, dev, li, IGI_WAVES,
                                  IGI_WAVE_LAUNCHES)
    require(img.mean() > 0, "igi bench: image black")
    lanes = lanes_a_wave(IGI_WAVE_LAUNCHES) * IGI_WAVES
    waves = {"main": profiled_wave(bench_job(dev), dev, 1),
             "igi": profiled_wave(job, dev, 1)}
    turns = turns_once(waves, ("main", "igi", "igi", "main"))
    out["bench"] = {
        "preprocess_s": preprocess_s, **info,
        "rays_per_s": lanes / info["seconds"],
        "main_path_rays_per_s": main_rays_per_s,
        "rays_per_s_over_main_path": lanes / info["seconds"]
        / main_rays_per_s,
        "wave_ms_in_turns": turns,
        "wave_ms_over_main": sum(turns["igi"]) / sum(turns["main"])}
    cpu_job = parser.parse(text, resolver=resolver, log=QUIET, device="cpu")
    ig = manager.igi_integrator(job.surf_params)
    out["vpls_card_vs_cpu"] = dict(zip(
        ("valid_agree", "values_close", "valid"), vpl_agreement(
            vpl_arrays(igi_mod.preprocess(ig, job.scene, device=dev)),
            vpl_arrays(igi_mod.preprocess(ig, cpu_job.scene,
                                          device="cpu")))))
    out["window"] = card_vs_cpu_window("igi", job, text, resolver,
                                       IGI_WINDOW_WAVES, SPHERE_POINT, dev)
    say("igi_path", seconds=time.time() - t_phase, **out)


CACHE_WAVES = 2            # (b): waves of the bench scene an integrator
CACHE_WINDOW_WAVES = 1
# a photon map wave at the defaults: 6 depths of (1 closest + the sampled
# light's closest and any-hit), and the 32 final-gather rays at the first
PM_WAVE_LAUNCHES = {"traverse6:closest": 2 * 6 + 32, "traverse6:any": 6}
# an irradiance cache wave: the camera, the sampled light, and the 16
# fallback directions of every lane batched into LANE_BUDGET launches
IC_WAVE_LAUNCHES = {"traverse6:closest": 2 + -(-16 * WIDTH * HEIGHT
                                              // ic_mod.LANE_BUDGET),
                    "traverse6:any": 1}
DP_WAVE_LAUNCHES = {"traverse6:closest": 2, "traverse6:any": 1}
# (a): launches of render_pbrt of each variant of scenes/caches.pbrt
# (24 x 24, 2 spp): the preprocess's, then the waves'
CACHE_FILE_LAUNCHES = {
    "photonmap": {"traverse6:closest": 5 + 16 * 2, "traverse6:any": 6 * 2},
    "exphotonmap": {"traverse6:closest": 5 + 12 * 2,
                    "traverse6:any": 6 * 2},
    "irradiancecache": {"traverse6:closest": 2 + 3 * 2,
                        "traverse6:any": 2},
    "dipole": {"traverse6:closest": 32 + 2 * 2, "traverse6:any": 4 + 2},
}
BENCH_GRAY = 'Material "matte" "rgb Kd" [0.6 0.6 0.6]'   # the sphere's
# (c)'s window of the dipole: the floor before the displaced sphere and its
# foot (the sphere's own samples are NaN, zeroed by the film: known
# behaviour z)
DIPOLE_WINDOW_POINT = (-0.4, 0.0, -1.1)
CACHE_LINES = {
    "photonmap": 'SurfaceIntegrator "photonmap"',
    "irradiancecache": 'SurfaceIntegrator "irradiancecache"',
    "dipolesubsurface": 'SurfaceIntegrator "dipolesubsurface"',
}


class Recorded:
    """While active, the return values of ``module.name`` calls."""

    def __init__(self, module, name):
        self.module, self.name, self.values = module, name, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def rec(*a, **k):
            self.values.append(self.real(*a, **k))
            return self.values[-1]
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def points_agreement(a, b):
    """Surface points of two runs: (share of slots where both runs kept
    the same material's point, share of those whose p and n agree to
    rtol 1e-5 / atol 1e-6, points)."""
    n = min(len(a.p), len(b.p))
    same = a.mat_id[:n] == b.mat_id[:n]
    ok = (np.isclose(a.p[:n], b.p[:n], rtol=1e-5, atol=1e-6).all(1)
          & np.isclose(a.n[:n], b.n[:n], rtol=1e-5, atol=1e-6).all(1))
    return (float(same.sum()) / max(len(a.p), len(b.p), 1),
            float(ok[same].mean()) if same.any() else 1.0, n)


def li_wave(job, li, dev, s):
    """One wave of `job` with the radiance function `li` at sample index
    `s` (``profiled_wave`` without building the job's radiance again)."""
    scene = st.to_device(job.scene, dev)
    px, py = rend.pixel_grid(job.width, job.height, device=dev)
    film = film_mod.make_film(job.width, job.height, device=dev)

    def wave():
        with torch.no_grad():
            rend.render_wave(
                scene, job.camera, job.sampler, film, px, py,
                torch.full(px.shape, s, dtype=torch.int32, device=dev),
                li_fn=li, width=job.width, height=job.height,
                spp=job.sampler.spp, device=dev)
    return wave


def gather_ops(fn):
    """Host torch operations of one call of `fn`."""
    with stats_mod.TorchOps() as ops:
        fn()
    torch.cuda.synchronize()
    return ops.n


@timed_part("golden")
def cache_golden_part(dev):
    """(a) of cache_path: each variant of scenes/caches.pbrt through
    render_pbrt against the reference's image, launches exact; the photon
    maps and the irradiance cache against the reference's; the dipole's
    surface points and their irradiance against the CPU's."""
    golden = np.load(cache_golden.GOLDEN)
    resolver = resources.Resolver([SCENES_DIR])
    out = {}
    for name in cache_golden.VARIANTS:
        text = cache_golden.variant_text(name)
        tc.reset_launches()
        t0 = time.time()
        img = manager.render_pbrt(text, search_paths=[SCENES_DIR],
                                  log=QUIET, device=dev)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = counted_launches()
        require(launches == CACHE_FILE_LAUNCHES[name],
                f"caches {name}: kernel launches {launches}, expected "
                f"{CACHE_FILE_LAUNCHES[name]}")
        close, rel_mean = compare_images(f"caches {name} vs the reference",
                                         golden[name], img)
        require(close >= 0.999, f"caches {name}: {close} of pixels close")
        out[name] = {"seconds": secs, "launches": launches,
                     "pixels_close": close, "rel_mean": rel_mean,
                     "img_mean": float(img.mean())}
    job = parser.parse(cache_golden.variant_text("photonmap"),
                       resolver=resolver, log=QUIET, device=dev)
    maps = cache_golden.map_arrays(pm_mod.shoot_photons(
        manager.photonmap_integrator(job.surf_params), job.scene,
        device=dev))
    for name in cache_golden.MAPS:
        slots, close, n, bad = cache_golden.agreement(
            maps, golden, f"pm_{name}_", ("p", "wi", "alpha"),
            **cache_golden.PHOTON_TOL)
        require(slots >= 0.999 and close >= 0.995,
                f"caches photon map {name}: slots {slots}, values {close}")
        out[f"photons_{name}"] = {
            "slots_agree": slots, "values_close": close, "photons": n,
            "not_close": [(j, float(max(np.abs(
                maps[f"pm_{name}_{f}"][i] - golden[f"pm_{name}_{f}"][j]).max()
                for f in ("p", "wi", "alpha")))) for i, j in bad[:8]]}
    job = parser.parse(cache_golden.variant_text("irradiancecache"),
                       resolver=resolver, log=QUIET, device=dev)
    cache = cache_golden.cache_arrays(ic_mod.build_cache(
        manager.irradiance_cache_integrator(job.surf_params), job.scene,
        job.camera, job.width, job.height, device=dev))
    slots, close, n, bad = cache_golden.agreement(
        cache, golden, "ic_", ("p", "n", "E", "dmean"))
    require(slots >= 0.999 and close >= 0.995,
            f"caches irradiance cache: slots {slots}, values {close}")
    out["cache_samples"] = {"slots_agree": slots, "values_close": close,
                            "samples": n, "not_close": bad[:8]}
    job = parser.parse(cache_golden.variant_text("dipole"),
                       resolver=resolver, log=QUIET, device=dev)
    ig = manager.dipole_integrator(job.surf_params)
    pts = {w: sp_mod.render(job.scene, min_sample_dist=ig.min_sample_dist,
                            device=w) for w in (dev, "cpu")}
    slots, close, n = points_agreement(pts[dev], pts["cpu"])
    require(slots >= 0.999 and close >= 0.995,
            f"caches surface points card vs CPU: slots {slots}, "
            f"values {close}")
    e = {w: dp_mod.prepare(job.scene, pts["cpu"], device=w)
         .E_times_area.cpu().numpy() for w in (dev, "cpu")}
    e_close = float(np.isclose(e[dev], e["cpu"], rtol=1e-5,
                               atol=1e-6).all(1).mean())
    require(e_close >= 0.995, f"caches surface irradiance: {e_close} close")
    out["surface_points"] = {"slots_agree": slots, "values_close": close,
                             "points": n, "irradiance_close": e_close}
    return out


def cache_path_phase(dev, main_rays_per_s):
    """The photon map, irradiance cache and dipole integrators on the card,
    through the v6 kernel. (a) ``cache_golden_part``. (b) The bench scene
    at 512 x 512 through each integrator at its defaults (photonmap: 20k +
    100k photon paths, maxdist 0.1, a final gather of 32; irradiancecache:
    nsamples 4096; dipolesubsurface with the displaced sphere in skin1,
    minsampledistance 0.25), its preprocess through ``build_li``: the
    preprocess seconds and sizes, CACHE_WAVES waves of exactly
    {PM,IC,DP}_WAVE_LAUNCHES and no other kernel, rays/s beside
    main_path's, one wave's ms in turns with main_path's (main, x, x,
    main); the host torch operations of a density estimate over the
    indirect map and of an interpolation over the cache on 4,096 camera
    hits, and again over every 8th photon / sample: equal. (c) A WINDOW x
    WINDOW window about the displaced sphere, card against CPU, both with
    the card's preprocess."""
    t_phase = time.time()
    out = {"golden": cache_golden_part(dev)}
    os.makedirs(PBRT_DIR, exist_ok=True)
    resolver = resources.Resolver([PBRT_DIR, SCENES_DIR])
    main_wave = li_wave(bench_job(dev), manager.build_li(
        bench_job(dev), log=QUIET, device=dev), dev, 1)
    recorded = {"photonmap": (pm_mod, "shoot_photons"),
                "irradiancecache": (ic_mod, "build_cache"),
                "dipolesubsurface": (dp_mod, "prepare")}
    wants = {"photonmap": PM_WAVE_LAUNCHES,
             "irradiancecache": IC_WAVE_LAUNCHES,
             "dipolesubsurface": DP_WAVE_LAUNCHES}
    for name, line in CACHE_LINES.items():
        t_int = time.time()
        path = os.path.join(PBRT_DIR, f"{name}_bench.pbrt")
        swap = {PATH_LINE: line}
        if name == "dipolesubsurface":
            swap[BENCH_GRAY] = 'Material "subsurface" "string name" ["skin1"]'
        text = bench_text_with(path, swap)
        job = parser.parse(text, resolver=resolver, log=QUIET, device=dev)
        require(job.surf_integrator == name, f"{name} bench: not its job")
        scene = st.to_device(job.scene, dev)
        t0 = time.time()
        with Recorded(*recorded[name]) as rec:
            li = manager.build_li(job, log=QUIET, device=dev)
        torch.cuda.synchronize()
        info = {"preprocess_s": time.time() - t0}
        data = rec.values[0]
        if name == "photonmap":
            info["photons"] = {k: m.n for k, m in zip(cache_golden.MAPS,
                                                      data)}
        elif name == "irradiancecache":
            info["cache_samples"] = data.count
        else:
            info["surface_points"] = data.n
            info["sss_materials"] = sorted(job.sss)
        _, img, winfo, _ = drive_waves(f"{name}_path", scene, dev, li,
                                       CACHE_WAVES, wants[name])
        lanes = lanes_a_wave(wants[name]) * CACHE_WAVES
        turns = turns_once({"main": main_wave,
                            name: li_wave(job, li, dev, 1)},
                           ("main", name, name, "main"))
        info.update(winfo, rays_per_s=lanes / winfo["seconds"],
                    main_path_rays_per_s=main_rays_per_s,
                    rays_per_s_over_main_path=lanes / winfo["seconds"]
                    / main_rays_per_s, wave_ms_in_turns=turns,
                    wave_ms_over_main=sum(turns[name]) / sum(turns["main"]))
        if name in ("photonmap", "irradiancecache"):
            info["gather_torch_ops"] = gather_ops_two_densities(
                name, job, scene, data, dev)
        else:
            info["mo_card_vs_cpu"] = mo_card_vs_cpu(job, scene, data, dev)
        cpu_job = parser.parse(text, resolver=resolver, log=QUIET,
                               device="cpu")
        info["window"] = card_vs_cpu_window_li(
            name, job, cpu_job, li, cache_li(name, cpu_job,
                                             st.to_device(data, "cpu")), dev,
            DIPOLE_WINDOW_POINT if name == "dipolesubsurface"
            else SPHERE_POINT)
        info["seconds"] = time.time() - t_int
        out[name] = info
    say("cache_path", seconds=time.time() - t_phase, **out)


def cache_li(name, job, data):
    """The radiance of `job`'s cache integrator over the preprocess `data`
    it already has (the manager's composition without its preprocess)."""
    p = job.surf_params
    if name == "photonmap":
        ig = manager.photonmap_integrator(p)
        return lambda s, r, d, c: pm_mod.li(ig, s, r, d, c, data)
    if name == "irradiancecache":
        ig = manager.irradiance_cache_integrator(p)
        return lambda s, r, d, c: ic_mod.li(ig, s, r, d, c, data)
    ig = manager.dipole_integrator(p)
    sps, sa, mask = manager.dipole_medium(job, device="cpu")
    return lambda s, r, d, c: dp_mod.li(ig, s, r, d, c, data, sps, sa, mask)


def camera_hits(scene, dev, n=4096):
    """Every (W*H / n)-th camera ray of ``camera_wave`` and its first hit:
    (rays, hits, interaction)."""
    cam, smp, px, py, _ = camera_wave(dev)
    sel = torch.arange(0, px.shape[0], max(1, px.shape[0] // n),
                       device=dev)
    cs = samplers.camera_samples(smp, px[sel], py[sel],
                                 torch.zeros_like(px[sel]))
    rays, _, _ = cameras.generate_rays(cam, cs, WIDTH, HEIGHT)
    hits = st.intersect(scene.geometry, rays)
    return rays, hits, st.interaction(scene.geometry, rays, hits)


def mo_card_vs_cpu(job, scene, ip, dev):
    """Mo of the job's medium at 4,096 camera hits over the card's
    irradiance points tiled to whole blocks of 1,024 (so that it is
    finite), on the card and on the CPU: share within rtol 1e-4."""
    _, hits, it = camera_hits(scene, dev)
    sps, sa, _ = manager.dipole_medium(job, device=dev)
    n = -(-ip.n // 1024) * 1024
    k = torch.arange(n, device=dev) % ip.n
    q = vm.to_arr(it["p"])[hits.hit]
    got = {}
    for w in (dev, "cpu"):
        tiled = dp_mod.IrradiancePoints(p=ip.p[k].to(w),
                                        E_times_area=ip.E_times_area[k].to(w),
                                        n=n)
        got[w] = dp_mod.mo(tiled, q.to(w), sps.to(w), sa.to(w),
                           dp_mod.DipoleSubsurfaceIntegrator().eta).cpu()
    ok = torch.isclose(got[dev], got["cpu"], rtol=1e-4, atol=0.0).all(1)
    share = float(ok.float().mean())
    require(bool(torch.isfinite(got[dev]).all()) and share >= 0.995,
            f"dipole Mo card vs CPU: {share} close")
    return {"lanes": int(q.shape[0]), "points": n, "close": share,
            "mean": float(got[dev].mean())}


def card_vs_cpu_window_li(what, job, cpu_job, li, cpu_li, dev, point):
    """(c) with given radiance functions on each side, about `point`."""
    x0, y0 = window_origin(cpu_job.camera, point)
    t0 = time.time()
    card = window_render(job, dev, x0, y0, CACHE_WINDOW_WAVES, li=li)
    card_s = time.time() - t0
    t0 = time.time()
    cpu = window_render(cpu_job, "cpu", x0, y0, CACHE_WINDOW_WAVES,
                        li=cpu_li)
    cpu_s = time.time() - t0
    close, rel_mean = compare_images(f"{what} window, card vs CPU", cpu, card)
    return {"x0": x0, "y0": y0, "waves": CACHE_WINDOW_WAVES,
            "card_s": card_s, "cpu_s": cpu_s, "pixels_close": close,
            "rel_mean": rel_mean, "img_mean": float(card.mean())}


def gather_ops_two_densities(name, job, scene, data, dev):
    """Host torch operations of one gather on 4,096 camera hits over the
    whole preprocess and over every 8th point of it: they must be equal."""
    rays, hits, it = camera_hits(scene, dev)
    from dartray_tpu_torch import bsdf as bx
    from dartray_tpu_torch import materials as mat_mod
    frame = bx.make_frame(it["ns"], it["dpdu"], it["ng"])
    params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                 scene.textures, it)
    ns = vm.face_forward(it["ns"], it["wo"])
    if name == "photonmap":
        ig = manager.photonmap_integrator(job.surf_params)
        full = data[2]
        k = torch.arange(0, full.n, 8, device=dev)
        sparse = pm_mod.PhotonMap(
            p=vm.V3(*(c[k] for c in full.p)),
            wi=vm.V3(*(c[k] for c in full.wi)),
            alpha=vm.V3(*(c[k] for c in full.alpha)), cell=full.cell[k],
            cell_size=full.cell_size, n=int(k.shape[0]))
        run = lambda m: pm_mod.density_radiance(  # noqa: E731
            m, it["p"], frame, params, it["wo"], ig.max_dist)
        points = (full.n, sparse.n)
    else:
        ig = manager.irradiance_cache_integrator(job.surf_params)
        full = data
        k = torch.arange(0, full.count, 8, device=dev)
        sparse = ic_mod.IrradianceCache(
            p=full.p[k], n=full.n[k], E=full.E[k], dmean=full.dmean[k],
            cell=full.cell[k], cell_size=full.cell_size,
            count=int(k.shape[0]))
        run = lambda c: ic_mod.interpolate(c, ig, it["p"], ns)  # noqa: E731
        points = (full.count, sparse.count)
    run(full)
    ops = (gather_ops(lambda: run(full)), gather_ops(lambda: run(sparse)))
    require(ops[0] == ops[1], f"{name}: host torch operations of a gather "
            f"{ops} differ between two densities")
    return {"lanes": int(rays.n), "points": points, "ops": ops}


def bench_job(dev, host=None):
    """The main path's render as a RenderJob: the bench scene (or `host`),
    ``camera_wave``'s camera and sampler, the path integrator at its
    default depth (MAX_DEPTH)."""
    cam, smp, _, _, _ = camera_wave(dev)
    return manager.RenderJob(
        scene=sb.bench_scene().build() if host is None else host,
        camera=cam, sampler=smp, width=WIDTH, height=HEIGHT,
        filter_name="box", filter_params=None, surf_integrator="path",
        surf_params=paramset.ParamSet(),
        vol_integrator="emission", vol_params=paramset.ParamSet(),
        renderer="sampler", renderer_params=paramset.ParamSet())


def on_cpu(job):
    """`job` with its camera on the CPU (the scene is host numpy)."""
    return dataclasses.replace(job, camera=dataclasses.replace(
        job.camera, device=torch.device("cpu")))


def window_origin(camera, p):
    """The top-left pixel of the WINDOW x WINDOW window centred on the
    image of world point `p`."""
    c2w = np.asarray(camera.cam2world.m, np.float64)
    pc = np.linalg.inv(c2w) @ np.append(np.asarray(p, np.float64), 1.0)
    r2c = np.asarray(camera.raster2camera, np.float64)
    # the raster point whose camera-space direction is pc's
    c2r = np.linalg.inv(r2c)
    q = c2r @ np.append(pc[:3] / pc[2], 1.0)
    x, y = q[0] / q[3], q[1] / q[3]
    return (int(np.clip(round(x) - WINDOW // 2, 0, WIDTH - WINDOW)),
            int(np.clip(round(y) - WINDOW // 2, 0, HEIGHT - WINDOW)))


import make_prt_golden as prt_golden  # noqa: E402

# (b) of prt_path: the PRT integrators at their defaults (lmax 4, 4,096
# directions): a wave is the camera's closest-hit launch and one any-hit
# launch a chunk of LANE_BUDGET // (W H) sample indices
PRT_SAMPLES = 4096
PRT_WAVE_LAUNCHES = {
    "traverse6:closest": 1,
    "traverse6:any": -(-PRT_SAMPLES // (prt_mod.LANE_BUDGET
                                        // (WIDTH * HEIGHT)))}
PRT_WINDOW_SAMPLES = 128   # (c): the window's nsamples (CPU side ~ 5 s)
USEPROBES_WAVES = 2
# createprobes at its defaults through the bench's path integrator: 64
# probes in chunks of 4, a path wave (depth 5) a chunk
PROBE_LAUNCHES = {"traverse6:closest": 16, "traverse6:mixed": 16 * MAX_DEPTH,
                  "traverse6:any": 16}
# (a): launches of render_pbrt of each variant of scenes/prt.pbrt (16 x 16,
# 2 waves): the preprocess's, then a wave's camera closest-hit launch and
# its transfer's one any-hit launch; createprobes: 16 chunks of a path wave
# at depth 2
PRT_FILE_LAUNCHES = {
    "diffuseprt": {"traverse6:closest": 3, "traverse6:any": 2},
    "glossyprt": {"traverse6:closest": 3, "traverse6:any": 2},
    "createprobes": {"traverse6:closest": 16, "traverse6:mixed": 32,
                     "traverse6:any": 16},
    "useprobes": {"traverse6:closest": 2},
}
MLT_DEPTH = 7
# a chain step's radiance at depth D: D closest-hit launches for each of
# the eye and the light subpath, and for each eye vertex's direct estimate
# one closest (its BSDF ray) and one any-hit (its shadow ray); D^2 any-hit
# launches for the connections
MLT_STEP_LAUNCHES = {"traverse6:closest": 3 * MLT_DEPTH,
                     "traverse6:any": MLT_DEPTH + MLT_DEPTH ** 2}
MLT_CHAINS = 8192
MLT_SPP = 1                # 512 x 512 / 8,192 chains = 32 steps
MLT_WINDOW_LANES = 1024    # (c): path_l card vs CPU on the bench scene
PARTED = 1e-3              # a chain whose final state moved this far


def coeffs_close(got, want):
    """Share of SH coefficients within rtol 1e-4 (atol 1e-6 of the
    largest)."""
    return float(np.isclose(got, want, rtol=1e-4,
                            atol=1e-6 * np.abs(want).max()).mean())


@timed_part("golden")
def prt_golden_part(dev):
    """(a) of prt_path: c_in at the defaults and each variant of
    scenes/prt.pbrt through render_pbrt against tools/prt_golden.npz,
    launches exact, in PBRT_DIR as the working directory (createprobes
    writes probes.npz there, useprobes reads it)."""
    golden = np.load(prt_golden.GOLDEN)
    job = parser.parse(prt_golden.variant_text("diffuseprt"),
                       resolver=resources.Resolver([SCENES_DIR]), log=QUIET,
                       device=dev)
    c_in = prt_mod.project_incident_radiance(
        job.scene, manager.scene_center(job.scene), 4, PRT_SAMPLES,
        device=dev).cpu().numpy()
    close = coeffs_close(c_in, golden["c_in"])
    require(close == 1.0, f"prt c_in: {close} of coefficients close")
    out = {"c_in_close": close}
    os.makedirs(PBRT_DIR, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(PBRT_DIR)
    try:
        for name in prt_golden.VARIANTS[:4]:
            tc.reset_launches()
            t0 = time.time()
            img = manager.render_pbrt(prt_golden.variant_text(name),
                                      search_paths=[SCENES_DIR], log=QUIET,
                                      device=dev)
            torch.cuda.synchronize()
            info = {"seconds": time.time() - t0,
                    "launches": counted_launches()}
            require(info["launches"] == PRT_FILE_LAUNCHES[name],
                    f"prt {name}: kernel launches {info['launches']}, "
                    f"expected {PRT_FILE_LAUNCHES[name]}")
            if name == "createprobes":
                z = np.load("probes.npz")
                info["coeffs_close"] = coeffs_close(z["coeffs"],
                                                    golden["probes_coeffs"])
                require(info["coeffs_close"] == 1.0,
                        f"prt probes: {info['coeffs_close']} close")
            else:
                close, rel_mean = compare_images(
                    f"prt {name} vs the reference", golden[name], img)
                require(close >= 0.999, f"prt {name}: {close} of pixels "
                        "close")
                info.update(pixels_close=close, rel_mean=rel_mean,
                            img_mean=float(img.mean()))
            out[name] = info
    finally:
        os.chdir(cwd)
    return out


def prt_path_phase(dev, main_rays_per_s):
    """Precomputed radiance transfer and the SH probes on the card, through
    the v6 kernel. (a) ``prt_golden_part``. (b) The bench scene at 512 x
    512: diffuseprt and glossyprt at their defaults (one closest-hit launch
    of 4,096 directions to project c_in, then a wave of PRT_WAVE_LAUNCHES:
    the transfer's sample indices batched 8 a launch), createprobes through
    the bench's path integrator at its defaults (64 probes x 512 directions:
    PROBE_LAUNCHES) and useprobes over its file (USEPROBES_WAVES waves of 1
    closest-hit launch): preprocess seconds, launches, lanes launched a
    second, one wave's ms in turns with main_path's (main, x, main). (c) A
    WINDOW x WINDOW window about the displaced sphere of diffuseprt and
    glossyprt at PRT_WINDOW_SAMPLES directions, 1 wave, card against CPU."""
    t_phase = time.time()
    out = {"golden": prt_golden_part(dev)}
    resolver = resources.Resolver([PBRT_DIR, SCENES_DIR])
    main_wave = profiled_wave(bench_job(dev), dev, 1)
    base = bench_text_with(os.path.join(PBRT_DIR, "prt_base.pbrt"), {})

    def variant(name, line):
        """The bench text with PATH_LINE swapped for `line`, written to
        _build/pbrt/<name>_bench.pbrt."""
        require(base.count(PATH_LINE) == 1, "bench text lacks PATH_LINE")
        text = base.replace(PATH_LINE, line)
        with open(os.path.join(PBRT_DIR, f"{name}_bench.pbrt"), "w") as f:
            f.write(text)
        return text

    for name in ("diffuseprt", "glossyprt"):
        t_int = time.time()
        text = variant(name, f'SurfaceIntegrator "{name}"')
        job = parser.parse(text, resolver=resolver, log=QUIET, device=dev)
        require(job.surf_integrator == name, f"{name} bench: not its job")
        scene = st.to_device(job.scene, dev)
        tc.reset_launches()
        t0 = time.time()
        li = manager.build_li(job, log=QUIET, device=dev)
        torch.cuda.synchronize()
        info = {"preprocess_s": time.time() - t0,
                "preprocess_launches": counted_launches()}
        require(info["preprocess_launches"] == {"traverse6:closest": 1},
                f"{name} bench: preprocess launches "
                f"{info['preprocess_launches']}")
        # the wave in turns: main, this wave, main
        before = once_ms(main_wave)
        _, img, winfo, _ = drive_waves(f"{name}_path", scene, dev, li, 1,
                                       PRT_WAVE_LAUNCHES)
        turns = {"main": [before, once_ms(main_wave)],
                 name: [winfo["seconds"] * 1e3]}
        require(img.mean() > 0, f"{name} bench: image black")
        lanes = WIDTH * HEIGHT * (1 + PRT_SAMPLES)
        info.update(winfo, lanes_a_wave=lanes,
                    lanes_per_s=lanes / winfo["seconds"],
                    main_path_rays_per_s=main_rays_per_s,
                    wave_ms_in_turns=turns,
                    wave_ms_over_main=turns[name][0]
                    / statistics.mean(turns["main"]))
        wline = (f'SurfaceIntegrator "{name}" "integer nsamples" '
                 f'[{PRT_WINDOW_SAMPLES}]')
        wparams = paramset.ParamSet()
        wparams.add("integer nsamples", [PRT_WINDOW_SAMPLES])
        info["window"] = card_vs_cpu_window(
            name, dataclasses.replace(job, surf_params=wparams),
            base.replace(PATH_LINE, wline), resolver, 1, SPHERE_POINT, dev)
        info["total_s"] = time.time() - t_int
        out[name] = info
    t_int = time.time()
    probe_file = os.path.join(PBRT_DIR, "bench_probes.npz")
    text = variant("createprobes", PATH_LINE + '\nRenderer "createprobes" '
                   f'"string filename" ["{probe_file}"]')
    job = parser.parse(text, resolver=resolver, log=QUIET, device=dev)
    tc.reset_launches()
    t0 = time.time()
    img = manager.run(job, log=QUIET, device=dev)
    torch.cuda.synchronize()
    probes_info = {"seconds": time.time() - t0,
                   "launches": counted_launches()}
    require(probes_info["launches"] == PROBE_LAUNCHES,
            f"createprobes bench: launches {probes_info['launches']}")
    z = np.load(probe_file)
    require(z["coeffs"].shape == (64, 25, 3) and np.isfinite(z["coeffs"]).all()
            and not img.any(), "createprobes bench: probes not finite")
    probes_info["coeffs_abs_mean"] = float(np.abs(z["coeffs"]).mean())
    text = variant("useprobes", 'SurfaceIntegrator "useprobes" "string '
                   f'filename" ["{probe_file}"]')
    job = parser.parse(text, resolver=resolver, log=QUIET, device=dev)
    li = manager.build_li(job, log=QUIET, device=dev)
    _, img, winfo, _ = drive_waves("useprobes_path", st.to_device(job.scene,
                                                                  dev),
                                   dev, li, USEPROBES_WAVES,
                                   {"traverse6:closest": 1})
    require(img.mean() > 0, "useprobes bench: image black")
    turns = turns_once({"main": main_wave, "useprobes": li_wave(job, li, dev,
                                                                1)},
                       ("main", "useprobes", "useprobes", "main"))
    out["createprobes"] = probes_info
    out["useprobes"] = {**winfo, "wave_ms_in_turns": turns,
                        "wave_ms_over_main": sum(turns["useprobes"])
                        / sum(turns["main"]),
                        "total_s": time.time() - t_int}
    say("prt_path", seconds=time.time() - t_phase, **out)


class Spied:
    """While active, ``module.name`` runs with the keyword arguments
    `extra` added; the calls' keyword arguments are kept."""

    def __init__(self, module, name, **extra):
        self.module, self.name, self.extra, self.calls = (module, name,
                                                          extra, [])

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def spy(*a, **k):
            k.update(self.extra)
            self.calls.append(k)
            return self.real(*a, **k)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def mlt_variant(name, where):
    """render_pbrt of the MLT variant `name` of scenes/prt.pbrt on `where`:
    (image, the chains' final states)."""
    with Recorded(mlt_mod, "mlt_step") as rec:
        img = manager.render_pbrt(prt_golden.variant_text(name),
                                  search_paths=[SCENES_DIR], log=QUIET,
                                  device=where)
    return img, rec.values[-1][0][0].cpu().numpy()


def path_l_on(job, where, u, depth):
    """``_radiance_for`` with ``bdpt.path_l`` at `depth` of the primary
    samples u (numpy) over `job`'s scene on `where`, as (R, 3) numpy."""
    camera = dataclasses.replace(job.camera,
                                 device=torch.device(where)) \
        if str(where) == "cpu" else job.camera
    L, _ = mlt_mod._radiance_for(
        st.to_device(job.scene, where), camera, job.width, job.height,
        lambda s, r, d, c: bdpt.path_l(s, r, d, c, max_depth=depth),
        torch.from_numpy(u).to(where))
    return vm.to_arr(L).cpu().numpy()


def lanes_close(what, got, want):
    close = float(np.isclose(got, want, rtol=1e-3, atol=1e-4).all(1).mean())
    require(np.isfinite(got).all() and close >= 0.999,
            f"{what}: {close} of lanes close")
    return close


def mlt_path_phase(dev):
    """Bidirectional paths and the Metropolis renderer on the card, through
    the v6 kernel. (a) ``bdpt.path_l`` at depth 4 on the golden's 4,096
    primary-sample vectors over scenes/prt.pbrt against
    tools/prt_golden.npz (>= 0.999 of lanes close); the two Metropolis
    variants through render_pbrt against the golden images (>= 0.99 of
    pixels close, the mean within 1e-3), and the chains whose final state
    parts from the CPU run's (by more than PARTED in a dimension). (b) The
    bench scene at 512 x 512 through the front door: Renderer "metropolis"
    at maxdepth MLT_DEPTH, 8,192 chains, 4,096 bootstrap samples,
    samplesperpixel MLT_SPP (32 steps): MLT_STEP_LAUNCHES a step, ms a
    step, mutations a second, b, the acceptance rate, the direct pass's
    seconds, a finite image. (c) path_l at MLT_DEPTH on MLT_WINDOW_LANES
    vectors over the bench scene, card against CPU."""
    t_phase = time.time()
    golden = np.load(prt_golden.GOLDEN)
    job = parser.parse(prt_golden.variant_text("mlt"),
                       resolver=resources.Resolver([SCENES_DIR]), log=QUIET,
                       device=dev)
    tc.reset_launches()
    got = path_l_on(job, dev, prt_golden.path_l_u(), prt_golden.PATH_L_DEPTH)
    d = prt_golden.PATH_L_DEPTH
    launches = counted_launches()
    require(launches == {"traverse6:closest": 3 * d,
                         "traverse6:any": d + d * d},
            f"path_l launches {launches}")
    out = {"path_l": {"launches": launches, "lanes_close": lanes_close(
        "path_l vs the reference", got, golden["path_l"])}}
    for name in ("mlt", "mlt_nodirect"):
        t0 = time.time()
        img, u_card = mlt_variant(name, dev)
        secs = time.time() - t0
        close, rel_mean = compare_images(f"{name} vs the reference",
                                         golden[name], img)
        _, u_cpu = mlt_variant(name, "cpu")
        parted = int((np.abs(u_card - u_cpu) > PARTED).any(1).sum())
        out[name] = {"seconds": secs, "pixels_close": close,
                     "rel_mean": rel_mean, "img_mean": float(img.mean()),
                     "chains_parted_from_cpu": parted,
                     "chains": int(u_card.shape[0])}
    os.makedirs(PBRT_DIR, exist_ok=True)
    text = bench_text_with(
        os.path.join(PBRT_DIR, "metropolis_bench.pbrt"),
        {PATH_LINE: PATH_LINE + '\nRenderer "metropolis" "integer '
         f'samplesperpixel" [{MLT_SPP}] "integer maxdepth" [{MLT_DEPTH}]'})
    resolver = resources.Resolver([PBRT_DIR, SCENES_DIR])
    job = parser.parse(text, resolver=resolver, log=QUIET, device=dev)
    steps = []
    real_step = mlt_mod.mlt_step

    def counted_step(*a, **k):
        tc.reset_launches()
        r = real_step(*a, **k)
        torch.cuda.synchronize()
        steps.append(counted_launches())
        return r

    stats = {}
    mlt_mod.mlt_step = counted_step
    try:
        with Spied(mlt_mod, "render", stats=stats) as spied:
            t0 = time.time()
            img = manager.run(job, log=QUIET, device=dev)
            secs = time.time() - t0
    finally:
        mlt_mod.mlt_step = real_step
    kw = spied.calls[0]
    require(kw["max_depth"] == MLT_DEPTH and kw["n_bootstrap"] == 4096
            and stats["chains"] == MLT_CHAINS
            and stats["steps"] == WIDTH * HEIGHT * MLT_SPP // MLT_CHAINS,
            f"metropolis bench: {kw}, {stats}")
    require(all(s == MLT_STEP_LAUNCHES for s in steps),
            f"metropolis bench: launches a step {steps[:2]}")
    require(img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(img).all()
            and img.mean() > 0, "metropolis bench: image not finite")
    n_mut = stats["steps"] * stats["chains"]
    out["bench"] = {
        "seconds": secs, "steps": stats["steps"], "chains": stats["chains"],
        "launches_a_step": steps[0], "ms_a_step":
        stats["chains_s"] / stats["steps"] * 1e3,
        "mutations_per_s": n_mut / stats["chains_s"], "b": stats["b"],
        "acceptance": stats["accepted"] / n_mut,
        "bootstrap_s": stats["bootstrap_s"], "direct_s": stats["direct_s"],
        "img_mean": float(img.mean())}
    u = prt_golden.path_l_u(MLT_WINDOW_LANES, MLT_DEPTH)
    t0 = time.time()
    card = path_l_on(job, dev, u, MLT_DEPTH)
    card_s = time.time() - t0
    t0 = time.time()
    cpu = path_l_on(job, "cpu", u, MLT_DEPTH)
    out["path_l_card_vs_cpu"] = {
        "lanes": MLT_WINDOW_LANES, "card_s": card_s,
        "cpu_s": time.time() - t0,
        "lanes_close": lanes_close("path_l card vs CPU", card, cpu),
        "nonzero": float((np.abs(cpu) > 0).any(1).mean())}
    say("mlt_path", seconds=time.time() - t_phase, **out)


import make_mesh_golden as mesh_golden  # noqa: E402

# (b) of mesh_path: ranks sharing the card over gloo, at full width
MESH_RUNS = (((4, 1), "box", 16), ((2, 2), "gaussian", 8))
MESH_RANKS = 4
MESH_TOL = dict(rtol=2e-3, atol=2e-4)    # tests/test_sharding.py's
MESH_DIR = os.path.join(tc.BUILD_DIR, "mesh")


def mesh_rank(rank, world, t_spawn, out_dir):
    """One rank of mesh_path (b), spawned by the parent: joins a gloo
    process group on the shared card (rendezvous through a file in
    `out_dir`), builds the bench scene, and renders MESH_RUNS through
    ``render_sharded``, every count set to 0 just before each render and
    read just after. Writes its images (rank<r>_<i>.npy) and a JSON record
    (rank<r>.json): backend, device, seconds from the parent's spawn call
    to ready, render seconds, launches and overflow a run."""
    import torch.distributed as dist
    from dartray_tpu_torch.parallel import mesh as pm
    require(pm.init_distributed(f"file://{os.path.join(out_dir, 'rdzv')}",
                                world, rank),
            "mesh rank: no process group")
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        host = sb.bench_scene().build()
        cam, _, _, _, _ = camera_wave(dev)
        ig = pi.PathIntegrator(max_depth=MAX_DEPTH)
        li = lambda s, r, d, c: pi.li(ig, s, r, d, c)  # noqa: E731
        meshes = [pm.make_device_mesh(*shape) for shape, _, _ in MESH_RUNS]
        dist.barrier()
        rec = {"rank": rank, "backend": dist.get_backend(),
               "device": f"{dev} {torch.cuda.get_device_name(dev)}",
               "ready_s": time.time() - t_spawn, "runs": []}
        for i, ((shape, filt, spp), m) in enumerate(zip(MESH_RUNS, meshes)):
            smp = samplers.make_sampler("lowdiscrepancy", spp=spp)
            dist.barrier()
            torch.cuda.synchronize()
            tc.reset_overflow(dev)
            tc.reset_launches()
            t0 = time.time()
            img = pm.render_sharded(host, cam, smp, li, WIDTH, HEIGHT, m,
                                    filter_name=filt, device=dev)
            torch.cuda.synchronize()
            rec["runs"].append({"render_s": time.time() - t0,
                                "cell": list(m.coordinate()),
                                "launches": counted_launches(),
                                "overflow": int(tc.overflow_flag(dev).item())})
            np.save(os.path.join(out_dir, f"rank{rank}_{i}.npy"), img)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def bit_equal_share(a, b):
    return float((a == b).all(-1).mean())


def mesh_path_phase(host, dev, main_rays_per_s):
    """Band-sharded rendering (``parallel/mesh.py``) on the card. (a) The
    one-process 4 x 2 mesh of tools/mesh_golden.npz's two configurations
    against the reference's sharded images, within MESH_TOL, with the
    share of pixels that are bit-equal. (b) MESH_RANKS ranks spawned on the
    one card over gloo render the bench scene at 512 x 512, depth 5: 4 x 1
    with the box filter at 16 spp must equal ``render``'s image bit for bit,
    each rank launching exactly 16 camera-wave waves' worth (1 closest, 5
    mixed, 1 any a wave) and no other kernel; 2 x 2 with the gaussian
    filter at 8 spp must be within MESH_TOL of ``render``'s. Spawn and
    set-up seconds apart from render seconds, rays/s as bench.py counts
    them beside main_path's, the backend and device of each rank, the
    host's CPU count. (c) The NCCL branch needs a card a rank. `host`: the
    bench scene's host tree, built once by ``main``."""
    t_phase = time.time()
    golden = np.load(mesh_golden.GOLDEN)
    out = {"golden": {}}
    t_golden = time.time()
    for name in mesh_golden.CONFIGS:
        small, cam, smp, li, filt = mesh_golden.port_setup(name, dev)
        tc.reset_launches()
        t0 = time.time()
        img = pm.render_sharded(small, cam, smp, li, mesh_golden.W,
                                mesh_golden.H,
                                pm.make_device_mesh(*mesh_golden.MESH),
                                filter_name=filt, device=dev)
        want = golden[f"{name}_img"]
        require(img.shape == want.shape and np.isfinite(img).all()
                and np.allclose(img, want, **MESH_TOL),
                f"mesh {name}: max abs diff {np.abs(img - want).max()}")
        n_tiles, n_spp = mesh_golden.MESH
        launches = counted_launches()
        waves = n_tiles * n_spp * -(-smp.spp // n_spp)
        require(launches == path_launches(waves, mesh_golden.CONFIGS[name][5]),
                f"mesh {name}: launches {launches}")
        out["golden"][name] = {
            "seconds": time.time() - t0, "launches": launches,
            "max_abs_diff": float(np.abs(img - want).max()),
            "pixels_bit_equal": bit_equal_share(img, want)}
    PART_SECONDS["golden"] += time.time() - t_golden
    os.makedirs(MESH_DIR, exist_ok=True)
    for f in os.listdir(MESH_DIR):
        os.remove(os.path.join(MESH_DIR, f))
    torch.cuda.empty_cache()
    t_spawn = time.time()
    torch.multiprocessing.spawn(mesh_rank, args=(MESH_RANKS, t_spawn,
                                                 MESH_DIR),
                                nprocs=MESH_RANKS, join=True)
    spawn_wall = time.time() - t_spawn
    recs = []
    for r in range(MESH_RANKS):
        with open(os.path.join(MESH_DIR, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    cam, _, _, _, _ = camera_wave(dev)
    ig = pi.PathIntegrator(max_depth=MAX_DEPTH)
    li = lambda s, r, d, c: pi.li(ig, s, r, d, c)  # noqa: E731
    runs = []
    for i, (shape, filt, spp) in enumerate(MESH_RUNS):
        smp = samplers.make_sampler("lowdiscrepancy", spp=spp)
        t0 = time.time()
        ref = rend.render(host, cam, smp, li, WIDTH, HEIGHT,
                          filter_name=filt, device=dev)
        render_s = time.time() - t0
        want = path_launches(spp // shape[1])
        imgs = [np.load(os.path.join(MESH_DIR, f"rank{r}_{i}.npy"))
                for r in range(MESH_RANKS)]
        for r, rec in enumerate(recs):
            run = rec["runs"][i]
            require(run["launches"] == want and run["overflow"] == 0,
                    f"mesh {shape} rank {r}: launches {run['launches']}, "
                    f"expected {want}; overflow {run['overflow']}")
            require(np.array_equal(imgs[r], imgs[0]),
                    f"mesh {shape}: rank {r}'s image differs from rank 0's")
        img = imgs[0]
        require(img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(img).all(),
                f"mesh {shape}: image not finite")
        if filt == "box" and shape[1] == 1:
            require(np.array_equal(img, ref),
                    f"mesh {shape}: not render's image bit for bit (max abs "
                    f"diff {np.abs(img - ref).max()})")
        else:
            require(np.allclose(img, ref, **MESH_TOL),
                    f"mesh {shape}: max abs diff {np.abs(img - ref).max()}")
        ranks_s = max(rec["runs"][i]["render_s"] for rec in recs)
        rays = WIDTH * HEIGHT * 2 * (MAX_DEPTH + 1) * spp
        runs.append({
            "mesh": list(shape), "filter": filt, "spp": spp,
            "launches_a_rank": want,
            "cells": [rec["runs"][i]["cell"] for rec in recs],
            "render_s_ranks": ranks_s, "render_s_one_process": render_s,
            "rays_per_s": rays / ranks_s,
            "render_rays_per_s": rays / render_s,
            "main_path_rays_per_s": main_rays_per_s,
            "max_abs_diff_vs_render": float(np.abs(img - ref).max()),
            "pixels_bit_equal_vs_render": bit_equal_share(img, ref)})
    out["ranks"] = {
        "ranks": MESH_RANKS, "host_cpus": os.cpu_count(),
        "backends": [rec["backend"] for rec in recs],
        "devices": [rec["device"] for rec in recs],
        "spawn_and_setup_s": max(rec["ready_s"] for rec in recs),
        "spawn_wall_s": spawn_wall, "runs": runs}
    out["nccl"] = ("not exercised: one card here, and NCCL takes one rank a "
                   "device")
    say("mesh_path", seconds=time.time() - t_phase, **out)


SMALL_GRAD_PATHS = ["materials.kd", "lights.intensity"]
GRAD_CPU_REL = 2e-3        # card vs CPU gradient: share of the largest |g|
GRAD_SPPS = (2, 8)         # the full-width gradient's two sample counts
# v6 launches of one gradient wave at depth 5 with per-bounce remat: the
# forward pass (1 closest, 5 mixed, 1 any), the wave's recompute in the
# backward pass (the same 7) and each bounce's recompute inside it (5 mixed,
# 1 any); 20 in all, measured on the card
GRAD_WAVE_LAUNCHES = {"traverse6:closest": 2, "traverse6:mixed": 3 * MAX_DEPTH,
                      "traverse6:any": 3}


def small_jacobian(host, where, remat=None):
    """d mean(img) / d SMALL_GRAD_PATHS of the Cornell render of
    ``render_small`` on `where`, as numpy."""
    cam = cameras.perspective(tr.look_at([0, 1, -3.2], [0, 1, 0], [0, 1, 0]),
                              40.0, SMALL, SMALL, device=where)
    smp = samplers.make_sampler("lowdiscrepancy", spp=SMALL_SPP)
    ig = pi.PathIntegrator(max_depth=3, remat=remat)
    theta, inject = grad.select(host, SMALL_GRAD_PATHS)
    _, g = grad.render_pixel_jacobian_sum(
        host, cam, smp, lambda s, r, d, c: pi.li(ig, s, r, d, c), SMALL,
        SMALL, theta, inject, device=where)
    return {k: v.cpu().numpy() for k, v in g.items()}, cam, smp, ig


def grad_small_phase(dev):
    """The gradient on the Cornell box (32x32, SMALL_SPP spp, depth 3):
    card (kernel) against CPU (plain traversal), max |g_card - g_cpu| <=
    GRAD_CPU_REL x max |g_cpu| for each parameter (an elementwise limit
    would judge the ties at shared edges that ``compare_images`` allows);
    autodiff against central differences for lights.intensity[0, 1] on the
    card, within 2 % of |fd|; remat on and off equal to rtol 1e-4."""
    host = cornell()
    tc.reset_launches()
    g_card, cam, smp, ig = small_jacobian(host, dev)
    launches = {k: v for k, v in tc.LAUNCHES.items() if v}
    g_cpu, _, _, _ = small_jacobian(host, "cpu")
    out = {"launches": launches}
    for p in SMALL_GRAD_PATHS:
        a, b = g_card[p], g_cpu[p]
        require(np.isfinite(a).all(), f"grad small: {p} not finite")
        err = np.abs(a - b)
        worst = np.unravel_index(int(err.argmax()), err.shape)
        rel = float(err.max() / np.abs(b).max())
        out[p] = {"rel_to_max": rel, "worst_index": list(map(int, worst)),
                  "card": float(a[worst]), "cpu": float(b[worst]),
                  "max_abs_cpu": float(np.abs(b).max())}
        require(rel <= GRAD_CPU_REL, f"grad small: {p} card vs CPU {rel} of "
                "the largest element")
    inten = host.lights.intensity

    def inject_l(scene, t):
        table = torch.as_tensor(inten).clone()
        table[0, 1] = t["L"]
        return dataclasses.replace(scene, lights=dataclasses.replace(
            scene.lights, intensity=table))

    fd = grad.finite_difference(
        host, cam, smp, lambda s, r, d, c: pi.li(ig, s, r, d, c), SMALL,
        SMALL, {"L": inten[0, 1]}, inject_l, lambda img: img.mean(),
        eps=5e-2, device=dev)["L"]
    ad = float(g_card["lights.intensity"][0, 1])
    out["ad_vs_fd"] = {"ad": ad, "fd": float(fd),
                       "rel": abs(ad - fd) / max(abs(fd), 1e-4)}
    require(abs(ad - fd) < 0.02 * max(abs(fd), 1e-4),
            f"grad small: autodiff {ad} against finite differences {fd}")
    g_on, _, _, _ = small_jacobian(host, dev, remat=True)
    g_off, _, _, _ = small_jacobian(host, dev, remat=False)
    for p in SMALL_GRAD_PATHS:
        require(np.allclose(g_on[p], g_off[p], rtol=1e-4, atol=1e-7),
                f"grad small: remat changes the gradient of {p}")
    out["remat_max_abs_diff"] = max(float(np.abs(g_on[p] - g_off[p]).max())
                                    for p in SMALL_GRAD_PATHS)
    say("grad_small", **out)


def grad_run(scene, dev, res, spp):
    """One ``bench_torch.grad_probe`` with the counts and the peak memory
    counted from 0 just before it; requires finite gradients with a nonzero
    norm, GRAD_WAVE_LAUNCHES a wave and no other launch, and no stack
    overflow."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    tc.reset_overflow(dev)
    tc.reset_launches()
    val, g, secs, norm = bench_torch.grad_probe(scene, dev, res=res, spp=spp)
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in tc.LAUNCHES.items() if v}
    overflow = int(tc.overflow_flag(dev).item())
    what = f"grad path {res}x{res} spp {spp}"
    require(all(bool(torch.isfinite(x).all()) for x in g.values())
            and norm > 0, f"{what}: gradient not finite or zero")
    require(launches == {k: v * spp for k, v in GRAD_WAVE_LAUNCHES.items()},
            f"{what}: kernel launches {launches}")
    require(overflow == 0, f"{what}: stack overflow in the kernel")
    return {"res": res, "spp": spp, "grad_s": secs, "grad_norm": norm,
            "loss": float(val), "launches": launches,
            "peak_mem_bytes": peak, "mem_at_start_bytes": start,
            "overflow": overflow}


def grad_path_phase(scene, dev):
    """The gradient at full width through the v6 kernel, per-bounce remat on
    (depth 5): (a) bench.py's probe (96x96, 8 spp, (img ** 2).mean() w.r.t.
    materials.kd), its norm within 2 % of the reference's; (b) the same
    loss at 512x512 (262,144 lanes a wave, as main_path) with GRAD_SPPS
    samples: the peak memory above the start at 8 spp at most 1.25 times
    that at 2 spp (each wave is checkpointed, so memory is O(1) in spp)."""
    probe = grad_run(scene, dev, bench_torch.GRAD_RES, bench_torch.GRAD_SPP)
    probe["reference_grad_norm"] = REFERENCE_GRAD_NORM
    probe["rel_to_reference"] = (abs(probe["grad_norm"] - REFERENCE_GRAD_NORM)
                                 / REFERENCE_GRAD_NORM)
    require(probe["rel_to_reference"] <= 0.02,
            f"grad path: probe norm {probe['grad_norm']} is not within 2 % "
            f"of {REFERENCE_GRAD_NORM}")
    full = {spp: grad_run(scene, dev, WIDTH, spp) for spp in GRAD_SPPS}
    lo, hi = (full[s]["peak_mem_bytes"] - full[s]["mem_at_start_bytes"]
              for s in GRAD_SPPS)
    require(hi <= 1.25 * lo, f"grad path: peak memory {hi} B at spp "
            f"{GRAD_SPPS[1]} against {lo} B at spp {GRAD_SPPS[0]}")
    say("grad_path", probe=probe,
        **{f"spp{s}": r for s, r in full.items()},
        peak_mem_ratio=hi / lo, launches_per_wave=GRAD_WAVE_LAUNCHES,
        tris=scene.geometry.n_prims)


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
    launches, static_img, static_snap, main_rays_per_s = main_path_phase(
        scene, dev)
    launches_m = motion_path_phase(moving, dev, static_snap)
    alt_kernels_phase(dev, small_img)

    # every kernel's launches on ITS path, each path counted from zero: the
    # static v6 modes on the main path (its sorted closest-hit lanes travel
    # inside the mixed launches) and the sampler's draws and camera samples
    # there, the AO scramble pair and probes on ao_path, the motion modes on
    # the moving path, the packet kernels on the bench scene's camera waves
    # (closest) and through intersect_rays(kernel=...) at full width (any),
    # the binary-tree kernels on the direct-lighting waves of attic_path
    launches_alt = alt_path_phase(
        dataclasses.replace(scene, geometry=geom_w), dev, shapes[1])
    # this slice's paths: direct lighting with the default kernels, then
    # with each binary-tree kernel serving every launch, AO and Whitted
    attic_small_phase(dev)
    direct_first = direct_path_phase(scene, dev, static_img)
    launches_attic = attic_path_phase(scene, dev, direct_first)
    launches_ao = ao_whitted_phase(scene, dev)
    # the scene front door (its launches are printed on pbrt_path's line)
    pbrt_path_phase(dev, static_img)
    # the material system (its launches are printed on materials_path's
    # line)
    materials_path_phase(dev, main_rays_per_s)
    # alpha cut-outs and the remaining lights (their launches are printed on
    # alpha_env_path's line)
    alpha_env_path_phase(dev, main_rays_per_s)
    # samplers, filters, cameras, the sampled mode, checkpoints and the
    # adaptive renderer (their launches are printed on sampling_path's line)
    main_kernels = sampling_path_phase(dev, main_rays_per_s)
    # the grid and kd-tree walks (no kernel), participating media and the
    # IGI integrator (their launches are printed on their own lines)
    accel_path_phase(dev, scene, shapes[1])
    # the reference's own walks (no kernel; v6 as their oracle)
    walks_path_phase(dev, host, scene, moving, shapes)
    volume_path_phase(dev, main_rays_per_s, main_kernels)
    igi_path_phase(dev, main_rays_per_s)
    # the photon map, irradiance cache and dipole integrators (their
    # launches are printed on cache_path's line)
    cache_path_phase(dev, main_rays_per_s)
    # precomputed radiance transfer, the probes, bidirectional paths and the
    # Metropolis renderer (their launches are printed on their own lines)
    prt_path_phase(dev, main_rays_per_s)
    mlt_path_phase(dev)
    # band-sharded rendering, in one process and over ranks sharing the card
    # (each rank's launches are checked and printed on mesh_path's line)
    mesh_path_phase(host, dev, main_rays_per_s)
    # the differentiable render: its launches are printed on grad_path's
    # line, not counted into the kernels line (main_path's are)
    grad_small_phase(dev)
    grad_path_phase(scene, dev)
    counted = {**{k: v for k, v in launches.items()
                  if k.startswith(("traverse6:", "sample_hash:"))},
               **{k: v for k, v in launches_ao.items()
                  if k.startswith("sample_hash:ao_")},
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
                     **ptxas_resources(r["counter"])})
    require(len(line) == 22, f"kernels line lists {len(line)} kernels")
    say("wall", seconds=time.time() - T_START, limit_seconds=1200)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
