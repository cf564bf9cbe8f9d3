"""Photon mapping surface integrator (counterpart of the JAX reference's
``integrators/photonmap.py``: ``photonmap`` and ``exphotonmap``).

``shoot_photons`` is the preprocess: one emission wave of
``n_caustic + n_indirect`` light paths (``lights.sample_le``), bounced
``max_photon_depth`` times, one closest-hit traversal a bounce over every
path. A path deposits (p, wi, alpha) at each hit whose material has a
diffuse or glossy weight: into the direct map at its first hit, the caustic
map after an all-specular prefix, the indirect map otherwise. The maps are
hash grids: photons sorted (stably) by the spatial hash of their cell, the
cell as wide as the gather radius.

A lookup is not k-nearest: it takes every photon within ``max_dist`` among
the first ``MAX_SCAN`` of each of the 27 hashed cells around the query (two
neighbour cells that share a hash id each scan it). ``scan_pairs`` expands
those (query, photon) pairs for all queries at once, without a loop over
cells or slots: the host issues a fixed number of torch operations for each
chunk of at most ``PAIR_BUDGET`` pairs, whatever the photon density.

``li`` adds the emitted light, one light sampled with MIS, the caustic
density estimate at every specular depth and, at the first hit, the indirect
light: a final gather of ``gather_samples`` BSDF rays, each estimating the
exitant light at its hit from all three maps as diffuse, or the indirect
map's estimate. Specular paths continue up to ``max_specular_depth``. A wave
is ``2 * (max_specular_depth + 1) + gather_samples`` closest-hit and
``max_specular_depth + 1`` any-hit traversals.

As in the reference, ``nused`` is read and never used, and the options
``maxspeculardepth`` / ``maxphotondepth`` are not read (both stay 5).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import bsdf as bx
from .. import device as device_mod
from .. import lights as lt_mod
from .. import materials as mat_mod
from .. import samplers as smp_mod
from ..core import math as vm
from ..core import sampling as smp
from ..core.math import V2, V3
from ..scene import types as st
from . import common

INV_PI = float(1.0 / np.pi)
MAX_SCAN = 64           # photons scanned at most per hashed cell
PAIR_BUDGET = 1 << 24   # (query, photon) pairs evaluated at most in one pass


@dataclasses.dataclass
class PhotonMapIntegrator:
    n_caustic: int = 20_000
    n_indirect: int = 100_000
    n_lookup: int = 50
    max_dist: float = 0.1
    max_specular_depth: int = 5
    max_photon_depth: int = 5
    final_gather: bool = True
    gather_samples: int = 32
    seed: int = 0


@dataclasses.dataclass
class PhotonMap:
    """Photons sorted by spatial-hash cell id."""
    p: V3                  # V3 of (N,)
    wi: V3                 # incident direction (toward the photon's origin)
    alpha: V3              # power / n_paths
    cell: torch.Tensor     # (N,) int32 hash ids, ascending
    cell_size: float
    n: int


_NEIGHBORS = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], np.int64)


def cell_coords(c, cell_size: float):
    """floor(c / cell_size) as the reference's float32 -> int32 conversion
    makes it: saturated at the int32 range, NaN to 0 (an int64 tensor)."""
    f = torch.floor(c / cell_size).to(torch.float64)
    return torch.nan_to_num(f, nan=0.0).clamp(-2.0 ** 31,
                                              2.0 ** 31 - 1).to(torch.int64)


def hash_cells(ix, iy, iz):
    """Integer cell coordinates -> the int32 spatial hash (ix * 73856093 ^
    iy * 19349663 ^ iz * 83492791) & 0x7fffffff. The reference multiplies
    in int32 with wrap-around; only the low 31 bits survive the mask, and
    those are the same for the int64 products taken here."""
    h = (ix * 73856093) ^ (iy * 19349663) ^ (iz * 83492791)
    return (h & 0x7fffffff).to(torch.int32)


def build_map(p: V3, wi: V3, alpha: V3, cell_size: float) -> PhotonMap:
    """Sort photons by hash cell, stably (the first MAX_SCAN of a cell are
    the first in deposit order)."""
    cell = hash_cells(*(cell_coords(c, cell_size) for c in p))
    order = torch.argsort(cell, stable=True)
    g = lambda v: V3(*(c[order] for c in v))   # noqa: E731
    return PhotonMap(p=g(p), wi=g(wi), alpha=g(alpha), cell=cell[order],
                     cell_size=float(cell_size), n=int(cell.shape[0]))


def scan_pairs(cell, cell_size: float, q: V3, max_scan: int,
               budget: int = PAIR_BUDGET):
    """The scanned (query, point) pairs of the 27 neighbour cells of each
    query, for a table sorted by hash id `cell`: a list of chunks
    ``(lane, idx)`` of int64 tensors, in (query, neighbour, slot) order,
    each chunk the queries of a contiguous range whose pairs stay within
    `budget` (a query's own pairs are never split). A neighbour contributes
    the first ``min(count, max_scan)`` points of its hash id."""
    dev = q.x.device
    r = q.x.shape[0]
    if r == 0:
        return []
    iq = [cell_coords(c, cell_size) for c in q]
    off = torch.from_numpy(_NEIGHBORS).to(dev)
    hid = hash_cells(iq[0][:, None] + off[:, 0], iq[1][:, None] + off[:, 1],
                     iq[2][:, None] + off[:, 2])             # (R, 27)
    lo = torch.searchsorted(cell, hid)
    cnt = (torch.searchsorted(cell, hid, right=True) - lo).clamp_max(max_scan)
    lo, cnt = lo.reshape(-1), cnt.reshape(-1)
    ends = torch.cumsum(cnt.reshape(r, 27).sum(1), 0)          # (R,)
    total = int(ends[-1])                                      # a host read
    if total <= budget:
        bounds, ends_h = [0, r], {r - 1: total}
    else:   # cut the queries where the running count passes the budget
        cuts = torch.searchsorted(ends, torch.arange(
            budget, total, budget, device=dev), right=True).tolist()
        bounds = sorted({0, r, *(c for c in cuts if 0 < c < r)})
        ends_h = dict(enumerate(ends.tolist()))
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        total = ends_h[b - 1] - (ends_h[a - 1] if a > 0 else 0)
        c = cnt[a * 27:b * 27]
        seg = torch.repeat_interleave(
            torch.arange(a * 27, b * 27, device=dev), c, output_size=total)
        start = torch.cumsum(c, 0) - c
        k = torch.arange(total, device=dev) - start[seg - a * 27]
        out.append((torch.div(seg, 27, rounding_mode="floor"), lo[seg] + k))
    return out


def _take3(v: V3, i) -> V3:
    return V3(v.x[i], v.y[i], v.z[i])


def _take_params(p: bx.BSDFParams, i) -> bx.BSDFParams:
    """The lanes `i` of a BSDFParams (the measured pool stays whole)."""
    out = {}
    for name, val in p._asdict().items():
        if val is None:
            out[name] = None
        elif name == "meas":
            out[name] = (val[0][i], val[1])
        elif isinstance(val, V3):
            out[name] = _take3(val, i)
        else:
            out[name] = val[i]
    return bx.BSDFParams(**out)


def density_radiance(pm: PhotonMap, q: V3, frame, params, wo: V3,
                     max_dist: float, diffuse_only: bool = False) -> V3:
    """L = sum_j k(d_j) f(wo, wi_j) alpha_j over the scanned photons within
    max_dist, with the Simpson kernel k = 3 / (pi r^2) (1 - d^2 / r^2)^2.
    `diffuse_only` takes f = kd / pi (the final gather's estimate)."""
    r2max = max_dist * max_dist
    r = q.x.shape[0]
    acc = torch.zeros((r, 3), dtype=torch.float32, device=q.x.device)
    kd_pi = params.kd * INV_PI if diffuse_only else None
    for lane, idx in scan_pairs(pm.cell, pm.cell_size, q, MAX_SCAN):
        pp = _take3(pm.p, idx)
        d2 = vm.length_sq(pp - _take3(q, lane))
        inside = d2 < r2max
        k = 3.0 * INV_PI / r2max * (1.0 - d2 / r2max) ** 2
        if diffuse_only:
            f_v = _take3(kd_pi, lane)
        else:
            f_v = bx.f(_take_params(params, lane),
                       bx.Frame(*(_take3(v, lane) for v in frame)),
                       _take3(wo, lane), _take3(pm.wi, idx),
                       bx.ALL & ~bx.SPECULAR)
        c = vm.where3(inside, f_v * _take3(pm.alpha, idx) * k, 0.0)
        acc.index_add_(0, lane, vm.to_arr(c))
    return vm.from_arr(acc)


def _empty_map(cell_size, dev) -> PhotonMap:
    """One photon at 1e30 with alpha 0: a map nothing finds."""
    z = torch.zeros(1, dtype=torch.float32, device=dev)
    return build_map(V3(z + 1e30, z + 1e30, z + 1e30), V3(z, z, z),
                     V3(z * 0, z * 0, z * 0), cell_size)


@torch.no_grad()
def shoot_photons(ig: PhotonMapIntegrator, scene: st.CompiledScene,
                  device=device_mod.DEFAULT):
    """Trace the photon paths on `device` (the scene is moved there once);
    returns the (caustic, direct, indirect) maps. A path's numbers are
    counter-based: draw `ctr` of path i is rng_uniform(key ^ hash(ctr), i)
    with the key from ``numpy.random.default_rng(seed + 101)``."""
    scene = st.to_device(scene, device)
    geom = scene.geometry
    lt = scene.lights
    dev = geom.mat_id.device
    n = max(ig.n_caustic + ig.n_indirect, 1)
    rng = np.random.default_rng(ig.seed + 101)
    key = int(rng.integers(0, 2 ** 32, 2, dtype=np.uint32)[0])
    lanes = torch.arange(n, dtype=torch.int64, device=dev)

    def u1(ctr):
        k = key ^ smp.hash_u32(torch.tensor(ctr, dtype=torch.int64,
                                            device=dev))
        return smp.rng_uniform(k, lanes)

    def u2(ctr):
        return V2(u1(ctr * 2 + 1), u1(ctr * 2 + 2))

    li_idx, li_pdf = lt_mod.sample_light_index(lt, u1(0))
    em = lt_mod.sample_le(lt, geom, li_idx, li_pdf, u2(1), u1(2), u2(3))
    alpha = em.alpha / float(n)        # the estimator: sum alpha / n_paths
    cur = vm.Rays(o=em.o, d=em.d,
                  tmin=torch.full((n,), 1e-4, device=dev),
                  tmax=torch.full((n,), float("inf"), device=dev),
                  time=torch.zeros((n,), device=dev))
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    specular_only = torch.ones((n,), dtype=torch.bool, device=dev)
    ps, wis, als, kinds = [], [], [], []   # kind: 0 direct, 1 caustic, 2 ind
    for bounce in range(ig.max_photon_depth):
        hits = st.intersect(geom, cur)
        hit = hits.hit & active
        it = st.interaction(geom, cur, hits)
        frame = bx.make_frame(it["ns"], it["dpdu"], it["ng"])
        params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                     scene.textures, it)
        deposit = hit & (_positive(params.kd) | _positive(params.ks))
        if bounce == 0:
            kind = torch.zeros((n,), dtype=torch.int32, device=dev)
        else:
            kind = torch.where(specular_only, 1, 2).to(torch.int32)
        ps.append(vm.where3(deposit, it["p"], 1e30))
        wis.append(it["wo"])
        als.append(vm.where3(deposit, alpha, 0.0))
        kinds.append(torch.where(deposit, kind, -1))
        # continue the path: a BSDF sample, roulette on the throughput ratio
        bs = bx.sample_f(params, frame, it["wo"], u2(10 + bounce * 4),
                         u1(12 + bounce * 4), flags=bx.ALL)
        cos_s = vm.absdot(bs.wi, frame.n)
        anew = alpha * bs.f * (cos_s / bs.pdf.clamp_min(1e-20))
        ratio = ((anew.x + anew.y + anew.z)
                 / (alpha.x + alpha.y + alpha.z).clamp_min(1e-12))
        cprob = ratio.clamp_max(1.0)
        survive = u1(13 + bounce * 4) < cprob
        anew = anew * (1.0 / cprob.clamp_min(1e-8))
        cont = hit & bs.valid & (bs.pdf > 0) & survive
        alpha = vm.where3(cont, anew, alpha)
        specular_only = specular_only & ((bs.flags & bx.SPECULAR) != 0)
        eps = st.ray_epsilon(it["t"])
        cur = vm.Rays(o=it["p"] + vm.face_forward(it["ng"], bs.wi) * eps,
                      d=bs.wi, tmin=torch.zeros((n,), device=dev),
                      tmax=torch.full((n,), float("inf"), device=dev),
                      time=cur.time)
        active = cont
    cat = lambda vs: V3(*(torch.cat([getattr(v, a) for v in vs])  # noqa
                          for a in "xyz"))
    p, wi, al, kind = cat(ps), cat(wis), cat(als), torch.cat(kinds)

    def compact(sel):
        if not bool(sel.any()):
            return _empty_map(ig.max_dist, dev)
        return build_map(_take3(p, sel), _take3(wi, sel), _take3(al, sel),
                         ig.max_dist)

    return compact(kind == 1), compact(kind == 0), compact(kind == 2)


def _positive(c: V3):
    """(R,) bool: a channel of `c` is above 0."""
    return (c.x > 0) | (c.y > 0) | (c.z > 0)


@torch.no_grad()
def li(ig: PhotonMapIntegrator, scene: st.CompiledScene, rays, diffs, sctx,
       maps):
    """Radiance of the camera rays: emission, MIS direct light, the caustic
    map, the indirect light (final gather or map) at the first hit, and the
    specular continuation."""
    caustic_map, direct_map, indirect_map = maps
    geom = scene.geometry
    lt = scene.lights
    r, dev = rays.n, rays.tmin.device
    L = vm.v3zeros((r,), dev)
    throughput = vm.v3ones((r,), dev)
    active = torch.ones((r,), dtype=torch.bool, device=dev)
    cur = rays
    sd = lambda d: smp_mod.sample_1d(sctx["sampler"], sctx["px"],  # noqa
                                     sctx["py"], sctx["s_idx"], d)
    sd2 = lambda d: smp_mod.sample_2d(sctx["sampler"], sctx["px"],  # noqa
                                      sctx["py"], sctx["s_idx"], d)
    dim = 5
    for depth in range(ig.max_specular_depth + 1):
        hits = st.intersect(geom, cur)
        hit = hits.hit & active
        if lt is not None and lt.env_light_index >= 0:
            L = L + vm.where3(active & ~hits.hit,
                              throughput * lt_mod.env_le(lt, cur.d), 0.0)
        it = st.interaction(geom, cur, hits)
        frame = bx.make_frame(it["ns"], it["dpdu"], it["ng"])
        if lt is not None:
            le = lt_mod.le_emitted(lt, geom, hits.prim, it["wo"], it["ns"])
            L = L + vm.where3(hit, throughput * le, 0.0)
        params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                     scene.textures, it)
        wo = it["wo"]
        if lt is not None and lt.n > 0:
            ld = common.uniform_sample_one_light(
                scene, it, frame, params, wo,
                sd(dim), sd2(dim + 1), sd(dim + 3), sd2(dim + 4), sd(dim + 6))
            L = L + vm.where3(hit, throughput * ld, 0.0)
        lc = density_radiance(caustic_map, it["p"], frame, params, wo,
                              ig.max_dist)
        L = L + vm.where3(hit, throughput * lc, 0.0)
        if depth == 0:      # the indirect light, at the first hit only
            if ig.final_gather:
                li_ind = _final_gather(ig, scene, it, frame, params, wo,
                                       maps, sctx, dim + 10)
            else:
                li_ind = density_radiance(indirect_map, it["p"], frame,
                                          params, wo, ig.max_dist)
            L = L + vm.where3(hit, throughput * li_ind, 0.0)
        if depth == ig.max_specular_depth:
            break
        u_s = sd2(dim + 7)
        uc_s = sd(dim + 9)
        dim += 60
        bs = bx.sample_f(params, frame, wo, u_s, uc_s,
                         flags=bx.SPECULAR | bx.REFLECTION | bx.TRANSMISSION)
        cos_s = vm.absdot(bs.wi, frame.n)
        cont = (hit & bs.valid & (bs.pdf > 0.0)
                & ((bs.f.x != 0.0) | (bs.f.y != 0.0) | (bs.f.z != 0.0)))
        throughput = vm.where3(
            cont, throughput * bs.f * (cos_s / bs.pdf.clamp_min(1e-20)),
            throughput)
        eps = st.ray_epsilon(it["t"])
        cur = vm.Rays(o=it["p"] + vm.face_forward(it["ng"], bs.wi) * eps,
                      d=bs.wi, tmin=torch.zeros((r,), device=dev),
                      tmax=torch.full((r,), float("inf"), device=dev),
                      time=cur.time)
        active = cont
    return L


def _final_gather(ig, scene, it, frame, params, wo, maps, sctx, dim):
    """BSDF-sampled final gather: the light at each gather ray's hit is the
    diffuse estimate of all three maps there."""
    geom = scene.geometry
    t = it["t"]
    r, dev = t.shape[0], t.device
    eps = st.ray_epsilon(t)
    acc = vm.v3zeros((r,), dev)
    for g in range(ig.gather_samples):
        u_g = smp_mod.sample_2d(sctx["sampler"], sctx["px"], sctx["py"],
                                sctx["s_idx"], dim + g * 3)
        uc_g = smp_mod.sample_1d(sctx["sampler"], sctx["px"], sctx["py"],
                                 sctx["s_idx"], dim + g * 3 + 2)
        bs = bx.sample_f(params, frame, wo, u_g, uc_g,
                         flags=bx.ALL & ~bx.SPECULAR)
        ok = bs.valid & (bs.pdf > 0)
        gray = vm.Rays(o=it["p"] + vm.face_forward(it["ng"], bs.wi) * eps,
                       d=bs.wi, tmin=torch.zeros((r,), device=dev),
                       tmax=torch.full((r,), float("inf"), device=dev),
                       time=torch.zeros((r,), device=dev))
        gh = st.intersect(geom, gray)
        git = st.interaction(geom, gray, gh)
        gframe = bx.make_frame(git["ns"], git["dpdu"], git["ng"])
        gparams = mat_mod.eval_params(scene.materials, git["mat_id"],
                                      scene.textures, git)
        lrad = vm.v3zeros((r,), dev)
        for pm in maps:
            lrad = lrad + density_radiance(pm, git["p"], gframe, gparams,
                                           git["wo"], ig.max_dist,
                                           diffuse_only=True)
        cos_g = vm.absdot(bs.wi, frame.n)
        w = torch.where(ok & gh.hit, cos_g / bs.pdf.clamp_min(1e-20), 0.0)
        acc = acc + bs.f * lrad * w
    return acc * (1.0 / float(ig.gather_samples))
