"""Irradiance caching surface integrator (counterpart of the JAX reference's
``integrators/irradiance_cache.py``).

``build_cache`` is the prime pass, the cache's only producer: the camera
rays of every ``prime_stride``-th pixel (the lowdiscrepancy sampler at
1 spp, seed 5, whatever sampler the scene names) and, at each hit, a
cosine-weighted hemisphere estimate of the irradiance from ``n_samples``
directions of the (0,2) sequence, one direction a sample index shared by
every point in its own frame. The incident light is the emission of a hit
area light and the environment where the ray escapes. The samples are
kept in a hash grid sorted by host numpy's ``argsort`` of the hash, as in
the reference (its default kind is not stable: a torch sort would keep
another 32 of a crowded cell).

``li`` adds emission, one light sampled with MIS and kd / pi times the
irradiance interpolated from the cache with the error weight
w = 1 / (|p - p_i| / d_i + sqrt((1 - n . n_i) / (1 - cos max_angle))),
kept where w > min_weight and n . n_i > 0 over the first ``MAX_SCAN`` of
each of the 27 hashed cells around the hit. Where no sample weighs in, a
16-direction hemisphere estimate (seed 17) takes its place; it is computed
on every lane. As in the reference the cached irradiance holds the emitted
light of area lights and the environment, which ``li``'s sampled light
counts again, ``maxdepth`` is read and never used, and there is no
specular continuation.

The hemisphere estimates batch sample indices as lanes: one closest-hit
traversal covers a chunk of ``max(1, LANE_BUDGET // points)`` indices times
all points, so the prime pass at its defaults (4,096 points of a 512 x 512
image, 4,096 samples) is 8 launches and a wave's fallback (16 samples) is
ceil(16 * lanes / LANE_BUDGET) launches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import bsdf as bx
from .. import cameras as cam_mod
from .. import device as device_mod
from .. import lights as lt_mod
from .. import materials as mat_mod
from .. import samplers as smp_mod
from ..core import math as vm
from ..core import sampling as smp
from ..core.math import V3
from ..scene import types as st
from . import common
from .photonmap import scan_pairs

INV_PI = float(1.0 / np.pi)
MAX_SCAN = 32
LANE_BUDGET = 1 << 21   # traversal lanes of one hemisphere launch at most


@dataclasses.dataclass
class IrradianceCacheIntegrator:
    min_weight: float = 0.5
    max_angle_deg: float = 10.0
    n_samples: int = 4096
    max_depth: int = 5
    fallback_samples: int = 16
    prime_stride: int = 8       # the prime pass's pixel stride
    spacing: float = 0.0        # world-space cell size (0: diagonal / 16)


@dataclasses.dataclass
class IrradianceCache:
    p: torch.Tensor       # (P, 3)
    n: torch.Tensor       # (P, 3)
    E: torch.Tensor       # (P, 3)
    dmean: torch.Tensor   # (P,) harmonic-mean hit distance
    cell: torch.Tensor    # (P,) int32 hash ids, ascending
    cell_size: float
    count: int


def hemisphere_E(scene, p: V3, n_vec: V3, ng: V3, t_hit, n_samples: int,
                 seed: int, max_dist: float):
    """Cosine-weighted estimate of the irradiance at points p from hit
    area lights' emission and the environment, and the harmonic mean of the
    hit distances (misses count as max_dist, the mean is capped there).
    Sample i's direction is the (0,2)-sequence point i, scrambled by two
    words of ``numpy.random.default_rng(seed)``, in each point's frame."""
    geom = scene.geometry
    lt = scene.lights
    r, dev = p.x.shape[0], p.x.device
    eps = st.ray_epsilon(t_hit)
    t1, t2 = vm.coordinate_system(n_vec)
    scr_np = np.random.default_rng(seed).integers(0, 2 ** 32, 2,
                                                  dtype=np.uint32)
    scr = tuple(torch.tensor(int(s), dtype=torch.int64, device=dev)
                for s in scr_np)
    E = torch.zeros((3, r), dtype=torch.float32, device=dev)
    inv_d_sum = torch.zeros((r,), dtype=torch.float32, device=dev)
    chunk = max(1, LANE_BUDGET // max(r, 1))
    rep = lambda v, c: V3(*(a.repeat(c) for a in v))   # noqa: E731
    for i0 in range(0, n_samples, chunk):
        c = min(chunk, n_samples - i0)
        u = smp.sample02(torch.arange(i0, i0 + c, dtype=torch.int64,
                                      device=dev), scr)
        d_loc = smp.cosine_sample_hemisphere(u)           # one per index
        col = lambda a: a[:, None]                         # noqa: E731
        wi = vm.normalize(V3(*(
            (ta[None, :] * col(d_loc.x) + tb[None, :] * col(d_loc.y)
             + nv[None, :] * col(d_loc.z)).reshape(-1)
            for ta, tb, nv in zip(t1, t2, n_vec))))
        o = rep(p, c) + vm.face_forward(rep(ng, c), wi) * eps.repeat(c)
        rays = vm.Rays(o=o, d=wi, tmin=torch.zeros((c * r,), device=dev),
                       tmax=torch.full((c * r,), float("inf"), device=dev),
                       time=torch.zeros((c * r,), device=dev))
        hits = st.intersect(geom, rays)
        li_v = vm.v3zeros((c * r,), dev)
        if lt is not None:
            it = st.interaction(geom, rays, hits)
            le = lt_mod.le_emitted(lt, geom, hits.prim, it["wo"], it["ns"])
            li_v = vm.where3(hits.hit, le, li_v)
            if lt.env_light_index >= 0:
                li_v = vm.where3(hits.hit, li_v, lt_mod.env_le(lt, wi))
        # cosine-sampled: E += Li cos / pdf = Li pi
        E = E + (vm.to_arr(li_v * np.pi).reshape(c, r, 3).sum(0)).T
        inv_d = torch.where(hits.hit, 1.0 / hits.t.clamp_min(1e-6),
                            1.0 / max_dist)
        inv_d_sum = inv_d_sum + inv_d.reshape(c, r).sum(0)
    E = V3(*E) * (1.0 / n_samples)
    dmean = n_samples / inv_d_sum.clamp_min(1e-9)
    return E, dmean.clamp_max(max_dist)


def _hash_np(ip):
    """The spatial hash of int32 cell coordinates (P, 3), as int32, in
    numpy (the reference multiplies in int32 with wrap-around; the low 31
    bits kept are those of the int64 products)."""
    ip = ip.astype(np.int64)
    h = ip[:, 0] * 73856093 ^ ip[:, 1] * 19349663 ^ ip[:, 2] * 83492791
    return (h & 0x7fffffff).astype(np.int32)


@torch.no_grad()
def build_cache(ig: IrradianceCacheIntegrator, scene, camera, width: int,
                height: int, seed: int = 5,
                device=device_mod.DEFAULT) -> IrradianceCache:
    """The prime pass on `device` (the scene is moved there once)."""
    scene = st.to_device(scene, device)
    geom = scene.geometry
    dev = geom.mat_id.device
    wb = geom.world_bound.cpu().numpy()
    diag = float(np.linalg.norm(wb[1] - wb[0]))
    max_dist = diag
    stride = ig.prime_stride
    xs = np.arange(stride // 2, width, stride, dtype=np.int32)
    ys = np.arange(stride // 2, height, stride, dtype=np.int32)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    px = torch.from_numpy(gx.reshape(-1)).to(dev)
    py = torch.from_numpy(gy.reshape(-1)).to(dev)
    smp_s = smp_mod.make_sampler("lowdiscrepancy", spp=1, seed=seed)
    cs = smp_mod.camera_samples(smp_s, px, py, torch.zeros_like(px))
    rays, _, _ = cam_mod.generate_rays(camera, cs, width, height, 1.0)
    hits = st.intersect(geom, rays)
    it = st.interaction(geom, rays, hits)
    ns_v = vm.face_forward(it["ns"], it["wo"])
    E, dmean = hemisphere_E(scene, it["p"], ns_v, it["ng"], it["t"],
                            ig.n_samples, seed, max_dist)
    keep = hits.hit
    host = lambda v: vm.to_arr(v)[keep].cpu().numpy()   # noqa: E731
    p_np, n_np, E_np = host(it["p"]), host(ns_v), host(E)
    d_np = dmean[keep].cpu().numpy()
    if p_np.shape[0] == 0:
        p_np = np.full((1, 3), 1e30, np.float32)
        n_np = np.zeros((1, 3), np.float32)
        E_np = np.zeros((1, 3), np.float32)
        d_np = np.ones((1,), np.float32)
    cell_size = ig.spacing if ig.spacing > 0 else diag / 16.0
    cell = _hash_np(np.floor(p_np / cell_size).astype(np.int32))
    order = np.argsort(cell)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return IrradianceCache(p=t(p_np[order]), n=t(n_np[order]),
                           E=t(E_np[order]), dmean=t(d_np[order]),
                           cell=t(cell[order]), cell_size=float(cell_size),
                           count=int(p_np.shape[0]))


def interpolate(cache: IrradianceCache, ig: IrradianceCacheIntegrator,
                q: V3, nq: V3):
    """The cache's weighted irradiance at points q with normals nq:
    (E, weight sum)."""
    r, dev = q.x.shape[0], q.x.device
    cos_max = float(np.cos(np.radians(ig.max_angle_deg)))
    acc = torch.zeros((r, 4), dtype=torch.float32, device=dev)
    for lane, idx in scan_pairs(cache.cell, cache.cell_size, q, MAX_SCAN):
        pi = vm.from_arr(cache.p[idx])
        ni = vm.from_arr(cache.n[idx])
        ql = V3(*(c[lane] for c in q))
        perr = vm.length(ql - pi) / cache.dmean[idx].clamp_min(1e-6)
        ndot = vm.dot(V3(*(c[lane] for c in nq)), ni)
        nerr = torch.sqrt((1.0 - ndot).clamp_min(0.0)
                          / max(1.0 - cos_max, 1e-6))
        w = 1.0 / (perr + nerr).clamp_min(1e-6)
        ok = (w > ig.min_weight) & (ndot > 0.0)
        w = torch.where(ok, w, 0.0)
        acc.index_add_(0, lane, torch.cat([cache.E[idx] * w[:, None],
                                           w[:, None]], 1))
    w_acc = acc[:, 3]
    return vm.from_arr(acc[:, :3]) * (1.0 / w_acc.clamp_min(1e-9)), w_acc


@torch.no_grad()
def li(ig: IrradianceCacheIntegrator, scene: st.CompiledScene, rays, diffs,
       sctx, cache: IrradianceCache):
    """Emission, MIS direct light and the cached (or fallback) diffuse
    indirect light of the camera rays' first hits."""
    geom = scene.geometry
    lt = scene.lights
    r, dev = rays.n, rays.tmin.device
    hits = st.intersect(geom, rays)
    hit = hits.hit
    L = vm.v3zeros((r,), dev)
    if lt is not None and lt.env_light_index >= 0:
        L = L + vm.where3(hit, 0.0, lt_mod.env_le(lt, rays.d))
    it = st.interaction(geom, rays, hits)
    ns_v = vm.face_forward(it["ns"], it["wo"])
    frame = bx.make_frame(ns_v, it["dpdu"], it["ng"])
    params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                 scene.textures, it)
    wo = it["wo"]
    if lt is not None:
        le = lt_mod.le_emitted(lt, geom, hits.prim, wo, it["ns"])
        L = L + vm.where3(hit, le, 0.0)
    if lt is not None and lt.n > 0:
        sd = lambda d: smp_mod.sample_1d(sctx["sampler"], sctx["px"],  # noqa
                                         sctx["py"], sctx["s_idx"], d)
        sd2 = lambda d: smp_mod.sample_2d(sctx["sampler"], sctx["px"],  # noqa
                                          sctx["py"], sctx["s_idx"], d)
        ld = common.uniform_sample_one_light(
            scene, it, frame, params, wo, sd(5), sd2(6), sd(8), sd2(9),
            sd(11))
        L = L + vm.where3(hit, ld, 0.0)
    E, w_sum = interpolate(cache, ig, it["p"], ns_v)
    E_fb, _ = hemisphere_E(scene, it["p"], ns_v, it["ng"], it["t"],
                           ig.fallback_samples, 17, cache.cell_size * 16.0)
    E = vm.where3(w_sum > 0.0, E, E_fb)
    return L + vm.where3(hit, params.kd * E * INV_PI, 0.0)
