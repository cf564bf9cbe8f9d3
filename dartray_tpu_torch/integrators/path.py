"""Path-tracing surface integrator (counterpart of the JAX reference's
``integrators/path.py``).

Iterative bounce loop over the wavefront with an active mask: emitted light
is added at bounce 0 or after a specular bounce at full weight, otherwise
MIS-weighted; one-light next-event estimation with MIS each bounce; Russian
roulette after bounce ``rr_depth`` with continueProb = min(0.5,
luminance(throughput)); hard stop at ``max_depth``.

The path-extension ray doubles as the MIS BSDF-sample ray, so a bounce costs
two traversal queries, and the extension ray of bounce b+1 is traced MERGED
with the shadow ray of bounce b in one mixed launch
(``scene.types.intersect_pair``). A wave at depth D is D + 2 kernel
launches: the camera wave (closest hit, unsorted: it is already
Morton-coherent), D mixed launches, and the last bounce's shadow wave (any
hit). Dead lanes carry tmax < tmin and leave the kernel at once.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import bsdf as bx
from .. import materials as mat_mod
from .. import samplers as smp_mod
from ..core import math as vm
from ..core import spectrum as spec
from ..scene import types as st
from . import common


@dataclasses.dataclass
class PathIntegrator:
    max_depth: int = 5
    rr_depth: int = 3
    # accepted for signature parity and ignored: rematerialisation only
    # shapes the reverse-mode tape, and this slice has no gradient
    remat: bool = None


def li(ig: PathIntegrator, scene: st.CompiledScene, rays, diffs, sctx,
       skip_direct: bool = False):
    """Wavefront path tracer, single-BSDF-sample MIS formulation. Returns
    the V3 radiance of every camera ray."""
    if skip_direct:
        raise NotImplementedError(
            "skip_direct serves the Metropolis renderer (ROADMAP Queue 1)")
    geom = scene.geometry
    lt = scene.lights
    r = rays.n
    dev = rays.tmin.device
    L = vm.v3zeros((r,), dev)
    throughput = vm.v3ones((r,), dev)
    active = torch.ones((r,), dtype=torch.bool, device=dev)
    specular_bounce = torch.zeros((r,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((r,), dtype=torch.float32, device=dev)
    sampler, px, py, s_idx = (sctx["sampler"], sctx["px"], sctx["py"],
                              sctx["s_idx"])
    sd = lambda d: smp_mod.sample_1d(sampler, px, py, s_idx, d)
    sd2 = lambda d: smp_mod.sample_2d(sampler, px, py, s_idx, d)
    do_nee = lt is not None and lt.n > 0
    # nothing reads the uv footprint unless the scene has textures
    diffs0 = diffs if scene.textures is not None else None

    cur = rays
    hits = st.intersect(geom, rays, sort=False)
    for bounce in range(ig.max_depth + 1):
        dim = 5 + bounce * 10
        hit = hits.hit & active
        it = st.interaction(geom, cur, hits,
                            diffs=diffs0 if bounce == 0 else None)
        it["ns"] = mat_mod.bump_shading_normal(scene.materials, it["mat_id"],
                                               scene.textures, it)
        frame = bx.make_frame(it["ns"], it["dpdu"], it["ng"])
        # emitted light gathered by the extension ray (MIS weighted)
        if lt is not None:
            le_w = common.emitter_hit_mis(scene, cur, hits, it, prev_pdf,
                                          specular_bounce, bounce == 0)
            L = L + vm.where3(active, throughput * le_w, 0.0)
        params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                     scene.textures, it)
        wo = it["wo"]
        # NEE shade half: one light, shadow ray built but not yet traced
        if do_nee:
            sray, usable, contrib = common.nee_prepare(
                scene, it, frame, params, wo, sd(dim), sd2(dim + 1),
                sd(dim + 3), mask=hit)
        last = bounce == ig.max_depth
        if not last:
            # BSDF sampling for the next ray (also the MIS light-hit sample)
            bs = bx.sample_f(params, frame, wo, sd2(dim + 7), sd(dim + 9),
                             flags=bx.ALL)
            cos_s = vm.absdot(bs.wi, frame.n)
            cont = hit & bs.valid & (bs.pdf > 0.0) & spec.any_nonzero(bs.f)
            new_tp = throughput * bs.f * (cos_s / bs.pdf.clamp_min(1e-20))
            if bounce > ig.rr_depth:        # Russian roulette
                u_rr = sd(dim + 8)
                cprob = spec.luminance(new_tp).clamp_max(0.5)
                survive = u_rr <= cprob
                new_tp = new_tp * (1.0 / cprob.clamp_min(1e-8))
                cont = cont & survive
            eps = st.ray_epsilon(it["t"])
            ng_f = vm.face_forward(it["ng"], bs.wi)
            next_ray = vm.Rays(
                o=it["p"] + ng_f * eps, d=bs.wi,
                tmin=torch.zeros((r,), dtype=torch.float32, device=dev),
                tmax=torch.where(cont, float("inf"), -1.0),
                time=cur.time)
        # the merged traversal: extension closest-hit + shadow any-hit
        if do_nee and not last:
            hits_next, occluded = st.intersect_pair(geom, next_ray, sray)
        elif do_nee:
            occluded = st.intersect_p(geom, sray)
        elif not last:
            hits_next = st.intersect(geom, next_ray)
        if do_nee:
            # the NEE contribution uses the PRE-update throughput
            L = L + vm.where3(usable & ~occluded, throughput * contrib, 0.0)
        if last:
            break
        throughput = vm.where3(cont, new_tp, throughput)
        specular_bounce = (bs.flags & bx.SPECULAR) != 0
        prev_pdf = bs.pdf
        active, cur, hits = cont, next_ray, hits_next
    return L
