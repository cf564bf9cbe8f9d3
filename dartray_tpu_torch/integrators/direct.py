"""Direct-lighting surface integrator (counterpart of the JAX reference's
``integrators/direct.py``, its pipeline default).

Strategy ``STRATEGY_ALL`` (``uniform_sample_all_lights``) or ``STRATEGY_ONE``
(``uniform_sample_one_light``) at every hit, then ONE stochastically chosen
specular continuation per ray (reflection or transmission, weighted by the
lobe-choice probability) down to ``max_depth``.

Every traversal is a launch of its own: a level costs one closest-hit wave
for the surface rays and, per sampled light, one any-hit shadow wave and one
closest-hit wave for the BSDF sample of ``estimate_direct``. With one light a
wave at depth D is 3 (D + 1) launches, all sorted, so ``DEFAULT_KERNEL``'s
``closest`` and ``any`` entries choose the kernel of every one of them.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import bsdf as bx
from .. import lights as lt_mod
from .. import materials as mat_mod
from .. import samplers as smp_mod
from .. import stats
from ..core import math as vm
from ..core import spectrum as spec
from ..scene import types as st
from . import common

STRATEGY_ALL = 0
STRATEGY_ONE = 1


@dataclasses.dataclass
class DirectLightingIntegrator:
    strategy: int = STRATEGY_ALL
    max_depth: int = 5


def specular_continuation(scene, it, frame, params, cur, hit, throughput,
                          sctx, dim):
    """One stochastic specular bounce per ray (dimensions ``dim .. dim + 2``):
    returns (next rays, the lanes that continue, their new throughput)."""
    sampler, px, py, s_idx = (sctx["sampler"], sctx["px"], sctx["py"],
                              sctx["s_idx"])
    bs = bx.sample_f(params, frame, it["wo"],
                     smp_mod.sample_2d(sampler, px, py, s_idx, dim),
                     smp_mod.sample_1d(sampler, px, py, s_idx, dim + 2),
                     flags=bx.SPECULAR | bx.REFLECTION | bx.TRANSMISSION)
    cos_s = vm.absdot(bs.wi, frame.n)
    cont = hit & bs.valid & (bs.pdf > 0.0) & spec.any_nonzero(bs.f)
    throughput = vm.where3(
        cont, throughput * bs.f * (cos_s / bs.pdf.clamp_min(1e-20)),
        throughput)
    eps = st.ray_epsilon(it["t"])
    ng_f = vm.face_forward(it["ng"], bs.wi)
    nxt = vm.Rays(o=it["p"] + ng_f * eps, d=bs.wi,
                  tmin=torch.zeros_like(eps),
                  tmax=torch.full_like(eps, float("inf")), time=cur.time)
    return nxt, cont, throughput


def surface_hit(scene, cur, hits, diffs):
    """Interaction, shading frame and material parameters of a wave of hits:
    what the direct-lighting and Whitted integrators share per level."""
    it = st.interaction(scene.geometry, cur, hits, diffs=diffs)
    it["ns"] = mat_mod.bump_shading_normal(scene.materials, it["mat_id"],
                                           scene.textures, it)
    frame = bx.make_frame(it["ns"], it["dpdu"], it["ng"])
    params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                 scene.textures, it)
    return it, frame, params


def li(ig: DirectLightingIntegrator, scene: st.CompiledScene, rays, diffs,
       sctx):
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
    sd = lambda d: smp_mod.sample_1d(sampler, px, py, s_idx, d)
    sd2 = lambda d: smp_mod.sample_2d(sampler, px, py, s_idx, d)
    diffs0 = diffs if scene.textures is not None else None
    cur = rays
    dim = 5
    for depth in range(ig.max_depth + 1):
        with stats.span("bounce", index=depth):
            hits = st.intersect(geom, cur)
            hit = hits.hit & active
            with stats.span("shade"):
                if lt is not None and lt.env_light_index >= 0:
                    # an escaped ray sees the environment light
                    L = L + vm.where3(
                        active & ~hits.hit,
                        throughput * lt_mod.env_le(lt, cur.d), 0.0)
                it, frame, params = surface_hit(
                    scene, cur, hits, diffs0 if depth == 0 else None)
                # emitted radiance at the hit (area lights are visible)
                if lt is not None:
                    le = lt_mod.le_emitted(lt, geom, hits.prim, it["wo"],
                                           it["ns"], lid=it["light_id"])
                    L = L + vm.where3(hit, throughput * le, 0.0)
            if lt is not None and lt.n > 0:
                with stats.span("nee"):
                    if ig.strategy == STRATEGY_ALL:
                        ld = common.uniform_sample_all_lights(
                            scene, it, frame, params, it["wo"], sctx,
                            dim0=dim)
                        dim += 6 * lt.n
                    else:
                        ld = common.uniform_sample_one_light(
                            scene, it, frame, params, it["wo"], sd(dim),
                            sd2(dim + 1), sd(dim + 3), sd2(dim + 4),
                            sd(dim + 6))
                        dim += 7
                    L = L + vm.where3(hit, throughput * ld, 0.0)
            if depth == ig.max_depth:
                break
            with stats.span("bsdf"):
                cur, active, throughput = specular_continuation(
                    scene, it, frame, params, cur, hit, throughput, sctx,
                    dim)
            dim += 3
    return L
