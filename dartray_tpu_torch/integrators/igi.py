"""Instant global illumination: virtual point lights (counterpart of the JAX
reference's ``integrators/igi.py``).

``preprocess`` shoots ``n_light_sets * n_light_paths`` light paths from the
lights, chosen by power, and deposits a virtual point light (VPL) at each
surface hit of each path, up to ``max_depth`` hits: one closest-hit
traversal a depth for the whole set. ``li`` shades a camera hit with its
emission, one light sampled by ``uniform_sample_one_light`` and every VPL of
one set (the set chosen per sample), each through the clamped geometric term
min(cos * cos / d^2, g_limit) and a shadow ray: ``n_light_paths *
max_depth`` any-hit traversals a wave, one VPL slot each, whether or not a
path reached that depth.

As in the reference, a light that is not an area light starts its paths at
its ``p`` as if it were a point light, with alpha = intensity * 4 pi (an
infinite light's ``p`` is the origin), and a VPL's throughput carries
``rho = kd + ks`` of the material's fixed-slot BSDF over pi.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import bsdf as bx
from .. import device as device_mod
from .. import lights as lt_mod
from .. import materials as mat_mod
from .. import samplers as smp_mod
from ..core import math as vm
from ..core import sampling as smp
from ..core import spectrum as spec
from ..core.math import V2, V3
from ..scene import types as st
from . import common


@dataclasses.dataclass
class IGIIntegrator:
    n_light_paths: int = 64
    n_light_sets: int = 4
    max_depth: int = 5
    g_limit: float = 10.0


class VPLData(NamedTuple):
    p: V3                  # V3 of (S, K)
    n: V3                  # V3 of (S, K)
    alpha: V3              # V3 of (S, K): path throughput * Le * rho / pi
    valid: torch.Tensor    # (S, K) bool


def _gather(v: V3, idx) -> V3:
    i = idx.long()
    return V3(v.x[i], v.y[i], v.z[i])


@torch.no_grad()
def preprocess(ig: IGIIntegrator, scene: st.CompiledScene, seed: int = 0,
               device=device_mod.DEFAULT) -> VPLData:
    """Shoot the VPL paths on `device` (the scene is moved there once).
    Each path draws its numbers from a hash of (path, dimension)."""
    scene = st.to_device(scene, device)
    lt = scene.lights
    geom = scene.geometry
    dev = geom.mat_id.device
    s_sets = ig.n_light_sets
    n_paths = ig.n_light_paths
    total = s_sets * n_paths
    key = (torch.arange(total, dtype=torch.int64, device=dev)
           + (seed * 7919 + 1)) & smp.M32
    zero = torch.zeros_like(key)

    def u1(d):
        h = (d * 2654435761 + 1) & smp.M32
        return smp.rng_uniform(smp.hash_u32(key ^ h), zero)

    def u2(d):
        return V2(u1(d), u1(d + 97))

    # the light, by the power CDF
    uc = u1(0)
    li_idx = (torch.searchsorted(lt.power_cdf, uc, right=True) - 1).clamp(
        0, lt.n - 1)
    kind = lt.kind[li_idx]
    w_sphere = smp.uniform_sample_sphere(u2(4))
    # an area light emits on its normal's side, cosine-weighted
    cnt = lt.tri_count[li_idx]
    tri = (lt.tri_offset[li_idx] + torch.minimum(
        (u1(5) * cnt.clamp_min(1).to(torch.float32)).to(torch.int32),
        (cnt - 1).clamp_min(0))).clamp_min(0)
    b1, b2 = smp.uniform_sample_triangle(u2(6))
    tv0 = _gather(geom.v0, tri)
    te1 = _gather(geom.e1, tri)
    te2 = _gather(geom.e2, tri)
    p_area = tv0 + te1 * b1 + te2 * b2
    n_area = vm.normalize(vm.cross(te1, te2))
    wl = smp.cosine_sample_hemisphere(u2(7))
    t1, t2 = vm.coordinate_system(n_area)
    w_area = t1 * wl.x + t2 * wl.y + n_area * wl.z
    is_area = kind == lt_mod.AREA
    inten = lt_mod._g3(lt.intensity, li_idx)
    p0 = vm.where3(is_area, p_area, lt_mod._g3(lt.p, li_idx))
    w0 = vm.where3(is_area, w_area, w_sphere)
    # initial alpha = Le pi area (area) or I 4 pi (the others), over the
    # light choice's pdf and the path count
    pdf_choice = (lt.power_cdf[li_idx + 1] - lt.power_cdf[li_idx]).clamp_min(
        1e-9)
    alpha_area = inten * (np.pi * lt.total_area[li_idx])
    alpha_point = inten * (4.0 * np.pi)
    tp = vm.where3(is_area, alpha_area, alpha_point) * (
        1.0 / (pdf_choice * float(n_paths)))

    # the random walk: a VPL at every hit
    cols_p, cols_n, cols_a, cols_ok = [], [], [], []
    cur_o = p0 + w0 * 1e-3
    cur_d = w0
    active = torch.ones(total, dtype=torch.bool, device=dev)
    for depth in range(ig.max_depth):
        rays = vm.make_rays(cur_o, cur_d)
        hits = st.intersect(geom, rays)
        hit = hits.hit & active
        it = st.interaction(geom, rays, hits)
        frame = bx.make_frame(it["ns"], it["dpdu"], it["ng"])
        params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                     scene.textures, it)
        cols_p.append(it["p"])
        cols_n.append(vm.face_forward(it["ns"], it["wo"]))
        # the VPL's contribution carries its surface's BRDF, rho / pi with
        # rho the diffuse + glossy slot weights
        cols_a.append(tp * (params.kd + params.ks) * (1.0 / np.pi))
        cols_ok.append(hit)
        bs = bx.sample_f(params, frame, it["wo"], u2(10 + depth * 3),
                         u1(12 + depth * 3))
        cos_s = vm.absdot(bs.wi, frame.n)
        cont = (hit & bs.valid & (bs.pdf > 0)
                & spec.any_nonzero(bs.f))
        new_tp = tp * bs.f * (cos_s / bs.pdf.clamp_min(1e-20))
        # Russian roulette on the throughput's luminance ratio
        cprob = (spec.luminance(new_tp)
                 / spec.luminance(tp).clamp_min(1e-9)).clamp_max(1.0)
        survive = u1(13 + depth * 3) < cprob
        new_tp = new_tp * (1.0 / cprob.clamp_min(1e-9))
        tp = vm.where3(cont, new_tp, tp)
        active = cont & survive
        eps = st.ray_epsilon(it["t"])
        cur_o = it["p"] + vm.face_forward(it["ng"], bs.wi) * eps
        cur_d = bs.wi
    k = n_paths * ig.max_depth

    def table(cols):
        return V3(*(torch.stack([getattr(c, a) for c in cols], 1)
                    .reshape(s_sets, k) for a in "xyz"))
    return VPLData(p=table(cols_p), n=table(cols_n), alpha=table(cols_a),
                   valid=torch.stack(cols_ok, 1).reshape(s_sets, k))


@torch.no_grad()
def li(ig: IGIIntegrator, scene: st.CompiledScene, rays, diffs, sctx,
       vpls: VPLData = None):
    """Radiance of the camera rays: emission (and the environment where a
    ray escapes), one sampled light, and one VPL set's gather."""
    geom = scene.geometry
    lt = scene.lights
    if vpls is None:
        vpls = preprocess(ig, scene, device=rays.tmin.device)
    r, dev = rays.n, rays.tmin.device
    hits = st.intersect(geom, rays)
    hit = hits.hit
    it = st.interaction(geom, rays, hits)
    frame = bx.make_frame(it["ns"], it["dpdu"], it["ng"])
    params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                 scene.textures, it)
    wo = it["wo"]
    L = vm.v3zeros((r,), dev)
    if lt is not None and lt.env_light_index >= 0:
        L = L + vm.where3(~hit, lt_mod.env_le(lt, rays.d), 0.0)
    if lt is not None:
        le = lt_mod.le_emitted(lt, geom, hits.prim, wo, it["ns"])
        L = L + vm.where3(hit, le, 0.0)
    sd = lambda d: smp_mod.sample_1d(sctx["sampler"], sctx["px"],
                                     sctx["py"], sctx["s_idx"], d)
    sd2 = lambda d: smp_mod.sample_2d(sctx["sampler"], sctx["px"],
                                      sctx["py"], sctx["s_idx"], d)
    if lt is not None and lt.n > 0:
        ld = common.uniform_sample_one_light(
            scene, it, frame, params, wo, sd(5), sd2(6), sd(8), sd2(9),
            sd(11))
        L = L + vm.where3(hit, ld, 0.0)
    # gather one VPL set: a shadow wave per VPL slot
    set_idx = torch.clamp_max((sd(12) * ig.n_light_sets).to(torch.int32),
                              ig.n_light_sets - 1).long()
    eps = st.ray_epsilon(it["t"])
    for j in range(vpls.valid.shape[1]):
        at = lambda a: a[:, j][set_idx]
        vp = V3(*map(at, vpls.p))
        vn = V3(*map(at, vpls.n))
        va = V3(*map(at, vpls.alpha))
        to_v = vp - it["p"]
        d2 = vm.length_sq(to_v).clamp_min(1e-8)
        dist = torch.sqrt(d2)
        wi = to_v * (1.0 / dist)
        cos_s = vm.absdot(wi, frame.n)
        cos_v = vm.dot(vn, -wi).clamp_min(0.0)
        g = (cos_s * cos_v / d2).clamp_max(ig.g_limit)
        contrib = bx.f(params, frame, wo, wi, bx.ALL & ~bx.SPECULAR) * va * g
        worth = (at(vpls.valid) & hit & (g > 0)
                 & spec.any_nonzero(contrib))
        sray = common.shadow_ray(it["p"], it["ng"], frame.n, wi, dist, eps)
        occ = st.intersect_p(geom, sray)
        L = L + vm.where3(worth & ~occ, contrib, 0.0)
    return L
