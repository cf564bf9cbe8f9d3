"""Whitted surface integrator (counterpart of the JAX reference's
``integrators/whitted.py``).

At each hit EVERY light is sampled once with a shadow test and no MIS
(f * Li * |cos| / pdf), then one stochastically chosen specular continuation
per ray is followed down to ``max_depth``, as in ``integrators/direct.py``.
A level costs one closest-hit launch and one any-hit launch per light.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import bsdf as bx
from .. import lights as lt_mod
from .. import samplers as smp_mod
from ..core import math as vm
from ..core import spectrum as spec
from ..scene import types as st
from . import common
from .direct import specular_continuation, surface_hit


@dataclasses.dataclass
class WhittedIntegrator:
    max_depth: int = 5


def li(ig: WhittedIntegrator, scene: st.CompiledScene, rays, diffs, sctx):
    """Radiance (V3) of every camera ray."""
    geom = scene.geometry
    lt = scene.lights
    r = rays.n
    dev = rays.tmin.device
    L = vm.v3zeros((r,), dev)
    throughput = vm.v3ones((r,), dev)
    active = torch.ones((r,), dtype=torch.bool, device=dev)
    sampler, px, py, s_idx = (sctx["sampler"], sctx["px"], sctx["py"],
                              sctx["s_idx"])
    diffs0 = diffs if scene.textures is not None else None
    cur = rays
    dim = 5
    for depth in range(ig.max_depth + 1):
        hits = st.intersect(geom, cur)
        hit = hits.hit & active
        if lt is not None and lt.env_light_index >= 0:
            # an escaped ray sees the environment light
            L = L + vm.where3(active & ~hits.hit,
                              throughput * lt_mod.env_le(lt, cur.d), 0.0)
        it, frame, params = surface_hit(scene, cur, hits,
                                        diffs0 if depth == 0 else None)
        if lt is not None:
            le = lt_mod.le_emitted(lt, geom, hits.prim, it["wo"], it["ns"],
                                   lid=it["light_id"])
            L = L + vm.where3(hit, throughput * le, 0.0)
        # all lights, one sample each, no MIS
        if lt is not None and lt.n > 0:
            eps = st.ray_epsilon(it["t"])
            for li_idx in range(lt.n):
                u_l = smp_mod.sample_2d(sampler, px, py, s_idx, dim)
                uc_l = smp_mod.sample_1d(sampler, px, py, s_idx, dim + 2)
                dim += 3
                idx = torch.full((r,), li_idx, dtype=torch.int32, device=dev)
                ls = lt_mod.sample_li(lt, geom, idx, it["p"], u_l, uc_l)
                f_l = bx.f(params, frame, it["wo"], ls.wi,
                           bx.ALL & ~bx.SPECULAR)
                cos_l = vm.absdot(ls.wi, frame.n)
                usable = ((ls.pdf > 0.0) & spec.any_nonzero(ls.li)
                          & spec.any_nonzero(f_l))
                sray = common.shadow_ray(it["p"], it["ng"], frame.n, ls.wi,
                                         ls.dist, eps)
                occluded = st.intersect_p(geom, sray)
                contrib = f_l * ls.li * (cos_l / ls.pdf.clamp_min(1e-20))
                L = L + vm.where3(hit & usable & ~occluded,
                                  throughput * contrib, 0.0)
        if depth == ig.max_depth:
            break
        cur, active, throughput = specular_continuation(
            scene, it, frame, params, cur, hit, throughput, sctx, dim)
        dim += 3
    return L
