"""Precomputed radiance transfer: the ``diffuseprt``, ``glossyprt`` and
``useprobes`` surface integrators (counterpart of the JAX reference's
``integrators/prt.py``), built on ``core/sh.py``.

``project_incident_radiance`` is both PRT integrators' preprocess: one
closest-hit launch of ``n_samples`` (0,2)-sequence directions over the
sphere from one point (the world bound's centre), each carrying the emitted
light of the area light it hits or the environment where it escapes, projected
onto SH. No other light reaches a PRT render.

``diffuse_li``: L = kd / pi * (T_p . c_in) with the transfer vector
T_p = int V(p, w) max(0, n . w) Y(w) dw; ``glossy_li``: L = int f(wo, wi)
V(wi) max(0, sum_i c_i Y_i(wi)) |cos| dwi over the BSDF's non-specular
lobes; both plus the hit's emission, or the environment on a miss. The
integrals are Monte-Carlo sums over ``n_samples`` directions of the
(0,2)-sequence under constant scrambles: direction i is the same for every
lane. So the transfer batches sample indices as lanes: one any-hit launch
covers a chunk of ``max(1, LANE_BUDGET // lanes)`` indices times all lanes
(at 512 x 512 and 4,096 samples, 512 launches a wave), and sums the chunk
at once, in another order than the reference's sample-by-sample loop.

``useprobes`` interpolates a baked probe grid (``renderers/probes.py``)
trilinearly at the hit and evaluates the cosine-convolved irradiance at the
viewer-side shading normal: L = kd / pi * max(E, 0).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import bsdf as bx
from .. import device as device_mod
from .. import lights as lt_mod
from .. import materials as mat_mod
from ..core import math as vm
from ..core import sampling as smp
from ..core import sh
from ..core.math import V3
from ..scene import types as st

FOUR_PI = float(4.0 * np.pi)
LANE_BUDGET = 1 << 21   # traversal lanes of one transfer launch at most
DIFFUSE_SCRAMBLE = (0x9E3779B9, 0x85EBCA6B)
GLOSSY_SCRAMBLE = (0xC2B2AE35, 0x27D4EB2F)


@dataclasses.dataclass
class DiffusePRTIntegrator:
    lmax: int = 4
    n_samples: int = 4096


@dataclasses.dataclass
class GlossyPRTIntegrator:
    lmax: int = 4
    n_samples: int = 4096


def scrambles(words, dev):
    """Two uint32 scramble words of the (0,2)-sequence as int64 tensors."""
    return tuple(torch.tensor(int(w), dtype=torch.int64, device=dev)
                 for w in words)


@torch.no_grad()
def project_incident_radiance(scene: st.CompiledScene, p, lmax: int,
                              n_samples: int = 4096, seed: int = 7,
                              device=device_mod.DEFAULT):
    """(T, 3) SH coefficients of the incident radiance at point p (3,), on
    `device` (the scene is moved there): one closest-hit launch of
    n_samples directions, scrambled by two words of
    ``numpy.random.default_rng(seed)``."""
    scene = st.to_device(scene, device)
    geom = scene.geometry
    lt = scene.lights
    dev = geom.mat_id.device
    n = int(n_samples)
    scr_np = np.random.default_rng(seed).integers(0, 2 ** 32, 2,
                                                  dtype=np.uint32)
    u = smp.sample02(torch.arange(n, dtype=torch.int64, device=dev),
                     scrambles(scr_np, dev))
    d = smp.uniform_sample_sphere(u)
    pj = torch.as_tensor(np.asarray(p, np.float32), device=dev)
    o = V3(*(pj[k].expand(n).contiguous() for k in range(3)))
    rays = vm.Rays(o=o, d=d,
                   tmin=torch.full((n,), 1e-4, dtype=torch.float32,
                                   device=dev),
                   tmax=torch.full((n,), float("inf"), dtype=torch.float32,
                                   device=dev),
                   time=torch.zeros((n,), dtype=torch.float32, device=dev))
    hits = st.intersect(geom, rays)
    L = vm.v3zeros((n,), dev)
    if lt is not None and lt.env_light_index >= 0:
        L = L + vm.where3(hits.hit, 0.0, lt_mod.env_le(lt, d))
    if lt is not None:
        it = st.interaction(geom, rays, hits)
        le = lt_mod.le_emitted(lt, geom, hits.prim, it["wo"], it["ns"])
        L = L + vm.where3(hits.hit, le, 0.0)
    w = torch.full((n,), FOUR_PI / n, dtype=torch.float32, device=dev)
    return sh.project_directions(d, vm.to_arr(L), w, lmax)


def _tile(x, c):
    """Lane-major `x` (a tensor, V3, Frame or BSDFParams) repeated c times
    along its lanes."""
    return bx.cat_lanes([x] * c)


def _transfer(scene, it, frame, hit_mask, n_samples, scramble, body):
    """sum_i body(...) * 4 pi / n_samples over the (0,2)-sequence
    directions i, with visibility from each hit (an any-hit launch a chunk
    of sample indices). body(wd, wi, cos_s, vis, c) gets the chunk's c
    directions wd (V3 of (c,)), and per (index, lane) pair (index-major,
    c * R lanes) the direction wi, n . wi and the visibility; it returns
    the chunk's (R, K) sum."""
    geom = scene.geometry
    r = it["t"].shape[0]
    dev = it["t"].device
    scr = scrambles(scramble, dev)
    eps = st.ray_epsilon(it["t"])
    chunk = max(1, LANE_BUDGET // max(r, 1))
    acc = 0.0
    for i0 in range(0, n_samples, chunk):
        c = min(chunk, n_samples - i0)
        u = smp.sample02(torch.arange(i0, i0 + c, dtype=torch.int64,
                                      device=dev), scr)
        wd = smp.uniform_sample_sphere(u)
        wi = V3(*(a[:, None].expand(c, r).reshape(-1) for a in wd))
        cos_s = vm.dot(wi, _tile(frame.n, c))
        live = hit_mask.repeat(c)
        # a lane that hit nothing traces nothing (its visibility is masked)
        rays = vm.Rays(
            o=_tile(it["p"], c) + vm.face_forward(_tile(it["ng"], c), wi)
            * eps.repeat(c), d=wi,
            tmin=torch.zeros((c * r,), dtype=torch.float32, device=dev),
            tmax=torch.where(live, float("inf"), -1.0),
            time=torch.zeros((c * r,), dtype=torch.float32, device=dev))
        vis = ~st.intersect_p(geom, rays) & live
        acc = acc + body(wd, wi, cos_s, vis, c)
    return acc * (FOUR_PI / n_samples)


def _emitted(lt, geom, hits, it, rays):
    """The hit's emitted light, or the environment where the ray missed."""
    r, dev = rays.n, rays.tmin.device
    le = vm.v3zeros((r,), dev)
    if lt is not None:
        le = lt_mod.le_emitted(lt, geom, hits.prim, it["wo"], it["ns"])
        if lt.env_light_index >= 0:
            le = vm.where3(hits.hit, le, lt_mod.env_le(lt, rays.d))
    return le


def _shading(scene, rays):
    geom = scene.geometry
    hits = st.intersect(geom, rays)
    it = st.interaction(geom, rays, hits)
    # two-sided: the transfer hemisphere lies on the viewer's side
    ns_v = vm.face_forward(it["ns"], it["wo"])
    frame = bx.make_frame(ns_v, it["dpdu"], it["ng"])
    params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                 scene.textures, it)
    return hits, it, frame, params


def diffuse_li(ig: DiffusePRTIntegrator, scene: st.CompiledScene, rays,
               diffs, sctx, c_in):
    """L = kd / pi * (T_p . c_in) plus emission, whatever the material."""
    hits, it, frame, params = _shading(scene, rays)

    def body(wd, wi, cos_s, vis, c):
        Y = sh.eval_basis(wd, ig.lmax)                        # (c, T)
        w = torch.where(vis, cos_s.clamp_min(0.0), 0.0)
        return w.reshape(c, -1).T @ Y                         # (R, T)

    transfer = _transfer(scene, it, frame, hits.hit, ig.n_samples,
                         DIFFUSE_SCRAMBLE, body)
    E = vm.from_arr(transfer @ c_in)
    L = params.kd * E * (1.0 / np.pi)
    le = _emitted(scene.lights, scene.geometry, hits, it, rays)
    return vm.where3(hits.hit, L + le, le)


def glossy_li(ig: GlossyPRTIntegrator, scene: st.CompiledScene, rays,
              diffs, sctx, c_in):
    """L = int f(wo, wi) V(wi) max(0, L_SH(wi)) |cos| dwi over the
    non-specular lobes, plus emission."""
    hits, it, frame, params = _shading(scene, rays)
    wo = it["wo"]
    flags = bx.ALL & ~bx.SPECULAR

    def body(wd, wi, cos_s, vis, c):
        L_in = (sh.eval_basis(wd, ig.lmax) @ c_in).clamp_min(0.0)   # (c, 3)
        f_v = bx.f(_tile(params, c), _tile(frame, c), _tile(wo, c), wi,
                   flags)
        w = torch.where(vis, torch.abs(cos_s), 0.0).reshape(c, -1)
        return V3(*((fc.reshape(c, -1) * L_in[:, k, None] * w).sum(0)
                    for k, fc in enumerate(f_v)))

    L = _transfer(scene, it, frame, hits.hit, ig.n_samples, GLOSSY_SCRAMBLE,
                  body)
    le = _emitted(scene.lights, scene.geometry, hits, it, rays)
    return vm.where3(hits.hit, L + le, le)


# --- useprobes: interpolate a baked SH probe grid ----------------------------

@dataclasses.dataclass
class SHProbes:
    """A baked probe grid: coeffs (nx * ny * nz, T, 3), probe (x, y, z) at
    row (x * ny + y) * nz + z; the grid spans the box bbox_lo .. bbox_hi."""
    coeffs: Any
    bbox_lo: Any
    bbox_hi: Any
    lmax: int
    res: tuple


@dataclasses.dataclass
class UseProbesIntegrator:
    lmax: int = 4


def probe_lookup(probes: SHProbes, p):
    """(R, T, 3) coefficients at points p (V3 or (R, 3)), trilinear between
    the probes at cell centres, clamped to the grid."""
    p = vm.from_arr(p)
    nx, ny, nz = probes.res
    lo, hi = probes.bbox_lo, probes.bbox_hi
    ext = (hi - lo).clamp_min(1e-9)
    gx = ((p.x - lo[0]) / ext[0] * nx - 0.5).clamp(0.0, nx - 1.0)
    gy = ((p.y - lo[1]) / ext[1] * ny - 0.5).clamp(0.0, ny - 1.0)
    gz = ((p.z - lo[2]) / ext[2] * nz - 0.5).clamp(0.0, nz - 1.0)
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    z0 = torch.floor(gz).to(torch.int64)
    fx = (gx - x0)[:, None, None]
    fy = (gy - y0)[:, None, None]
    fz = (gz - z0)[:, None, None]
    x1 = (x0 + 1).clamp_max(nx - 1)
    y1 = (y0 + 1).clamp_max(ny - 1)
    z1 = (z0 + 1).clamp_max(nz - 1)

    def at(xi, yi, zi):
        return probes.coeffs[(xi * ny + yi) * nz + zi]

    return (at(x0, y0, z0) * (1 - fx) * (1 - fy) * (1 - fz)
            + at(x1, y0, z0) * fx * (1 - fy) * (1 - fz)
            + at(x0, y1, z0) * (1 - fx) * fy * (1 - fz)
            + at(x1, y1, z0) * fx * fy * (1 - fz)
            + at(x0, y0, z1) * (1 - fx) * (1 - fy) * fz
            + at(x1, y0, z1) * fx * (1 - fy) * fz
            + at(x0, y1, z1) * (1 - fx) * fy * fz
            + at(x1, y1, z1) * fx * fy * fz)


def probes_li(ig: UseProbesIntegrator, scene: st.CompiledScene, rays, diffs,
              sctx, probes: SHProbes):
    """L = kd / pi * max(E(n), 0) from the interpolated, cosine-convolved
    coefficients at the viewer-side shading normal, plus emission."""
    geom = scene.geometry
    hits = st.intersect(geom, rays)
    it = st.interaction(geom, rays, hits)
    params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                 scene.textures, it)
    c = probe_lookup(probes, it["p"])
    c = sh.convolve_cos_theta(c.movedim(1, 0), ig.lmax).movedim(0, 1)
    ns_v = vm.face_forward(it["ns"], it["wo"])
    Y = sh.eval_basis(ns_v, ig.lmax)
    E = vm.from_arr(torch.einsum("rt,rtc->rc", Y, c))
    L = params.kd * V3(*(a.clamp_min(0.0) for a in E)) * (1.0 / np.pi)
    le = _emitted(scene.lights, geom, hits, it, rays)
    return vm.where3(hits.hit, L + le, le)
