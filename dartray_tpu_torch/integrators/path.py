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

A bounce is a function of the carry ``(L, throughput, active,
specular_bounce, prev_pdf, cur, hits)``, as in the reference. With
``remat`` on and autograd recording, each bounce runs under
``torch.utils.checkpoint``: the backward pass recomputes its activations
(and launches its traversal again) instead of keeping them, so gradient
memory is O(1) in path depth. Under ``torch.no_grad()`` the loop is the
plain one whatever ``remat`` says.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from .. import bsdf as bx
from .. import materials as mat_mod
from .. import samplers as smp_mod
from .. import stats
from ..core import math as vm
from ..core import spectrum as spec
from ..scene import types as st
from . import common

SAMPLE_DEPTH = 3  # structured sample dims for the first bounces (read nowhere)


@dataclasses.dataclass
class PathIntegrator:
    max_depth: int = 5
    rr_depth: int = 3
    # per-bounce rematerialisation under autograd; None = on for
    # max_depth > 3 (the reference's rule). It changes no value, only what
    # the backward pass keeps and what it recomputes
    remat: bool = None


def li(ig: PathIntegrator, scene: st.CompiledScene, rays, diffs, sctx,
       skip_direct: bool = False):
    """Wavefront path tracer, single-BSDF-sample MIS formulation. Returns
    the V3 radiance of every camera ray.

    skip_direct leaves out the camera vertex's direct light: the emission
    the camera ray sees, the first vertex's next-event estimate (bounce 0
    then traces its extension ray alone, closest hit) and the emission its
    extension ray finds unless that bounce was specular. The Metropolis
    renderer's chains measure what is left; its separate direct pass adds
    the rest."""
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
    has_lights = lt is not None and lt.n > 0
    # nothing reads the uv footprint unless the scene has textures
    diffs0 = diffs if scene.textures is not None else None

    def body(carry, bounce):
        with stats.span("bounce", index=bounce):
            return bounce_body(carry, bounce)

    def bounce_body(carry, bounce):
        L, throughput, active, specular_bounce, prev_pdf, cur, hits = carry
        dim = 5 + bounce * 10
        hit = hits.hit & active
        with stats.span("shade"):
            it = st.interaction(geom, cur, hits,
                                diffs=diffs0 if bounce == 0 else None)
            it["ns"] = mat_mod.bump_shading_normal(
                scene.materials, it["mat_id"], scene.textures, it)
            frame = bx.make_frame(it["ns"], it["dpdu"], it["ng"])
            # emitted light gathered by the extension ray (MIS weighted)
            if lt is not None:
                le_w = common.emitter_hit_mis(scene, cur, hits, it, prev_pdf,
                                              specular_bounce, bounce == 0)
                if skip_direct and bounce == 0:
                    gate = torch.zeros_like(active)
                elif skip_direct and bounce == 1:
                    gate = active & specular_bounce
                else:
                    gate = active
                L = L + vm.where3(gate, throughput * le_w, 0.0)
            params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                         scene.textures, it)
        wo = it["wo"]
        # NEE shade half: one light, shadow ray built but not yet traced
        do_nee = has_lights and not (skip_direct and bounce == 0)
        if do_nee:
            with stats.span("nee"):
                sray, usable, contrib = common.nee_prepare(
                    scene, it, frame, params, wo, sd(dim), sd2(dim + 1),
                    sd(dim + 3), mask=hit)
        last = bounce == ig.max_depth
        if not last:
            with stats.span("bsdf"):
                # BSDF sampling for the next ray (also the MIS light-hit
                # sample)
                bs = bx.sample_f(params, frame, wo, sd2(dim + 7),
                                 sd(dim + 9), flags=bx.ALL)
                cos_s = vm.absdot(bs.wi, frame.n)
                cont = (hit & bs.valid & (bs.pdf > 0.0)
                        & spec.any_nonzero(bs.f))
                new_tp = throughput * bs.f * (cos_s
                                              / bs.pdf.clamp_min(1e-20))
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
            return (L, throughput, active, specular_bounce, prev_pdf, cur,
                    hits)
        throughput = vm.where3(cont, new_tp, throughput)
        specular_bounce = (bs.flags & bx.SPECULAR) != 0
        return (L, throughput, cont, specular_bounce, bs.pdf, next_ray,
                hits_next)

    def flat_body(bounce, tree, *leaves):
        carry = body(pytree.tree_unflatten(list(leaves), tree), bounce)
        return tuple(pytree.tree_leaves(carry))

    carry = (L, throughput, active, specular_bounce, prev_pdf, rays,
             st.intersect(geom, rays, sort=False))
    remat = ig.remat if ig.remat is not None else ig.max_depth > 3
    remat = remat and torch.is_grad_enabled()
    for bounce in range(ig.max_depth + 1):
        if remat:
            # the carry goes in as separate tensors: checkpoint keeps a
            # tensor argument through the enclosing saved-tensor hooks, so
            # inside grad.render_image's wave checkpoint no bounce's carry
            # outlives the forward pass (one tuple argument would be held
            # as it is, every wave's six carries until the backward pass)
            leaves, tree = pytree.tree_flatten(carry)
            carry = pytree.tree_unflatten(list(checkpoint(
                flat_body, bounce, tree, *leaves, use_reentrant=False)),
                tree)
        else:
            carry = body(carry, bounce)
    return carry[0]
