"""Shared integrator machinery: MIS direct lighting over wavefronts
(counterpart of the JAX reference's ``integrators/common.py``).

``shadow_ray``, ``nee_prepare`` (the shade half of next-event estimation)
and ``emitter_hit_mis`` (MIS-weighted emission gathered by the extension
ray) serve the path integrator; ``estimate_direct`` (MIS light +
BSDF sampling toward one light, two SEPARATE traversal launches: an any-hit
shadow wave and a closest-hit wave) and ``uniform_sample_one_light`` /
``uniform_sample_all_lights`` built on it serve the direct-lighting
integrator. There is no environment light yet (``env_light_index`` is -1), so
an escaped BSDF-sample ray gathers nothing.
"""
from __future__ import annotations

import torch

from .. import bsdf as bx
from .. import lights as lt_mod
from .. import samplers as smp_mod
from ..core import math as vm
from ..core import sampling as smp
from ..core import spectrum as spec
from ..scene import types as st


def shadow_ray(p, ng, n_side, wi, dist, eps, time=None):
    """Offset shadow ray; `time` carries the surface ray's shutter time."""
    ng_f = vm.face_forward(ng, wi)
    o = p + ng_f * eps
    return vm.Rays(o=o, d=wi,
                   tmin=torch.zeros_like(dist),
                   tmax=dist * (1.0 - 1e-3) - eps,
                   time=torch.zeros_like(dist) if time is None else time)


def require_no_env_light(lt):
    if lt.env_light_index >= 0:
        raise NotImplementedError(
            "infinite (environment) lights are not ported (ROADMAP Queue 1, "
            "remaining lights)")


def estimate_direct(scene, it, frame, params, wo, light_idx,
                    u_light, uc_light, u_bsdf, uc_bsdf,
                    flags=bx.ALL & ~bx.SPECULAR):
    """MIS light + BSDF sampling toward one light per lane. Returns the V3
    direct radiance estimate."""
    geom = scene.geometry
    lt = scene.lights
    require_no_env_light(lt)
    p = it["p"]
    eps = st.ray_epsilon(it["t"])
    ns = frame.n

    # ---- light-sampling term --------------------------------------------
    ls = lt_mod.sample_li(lt, geom, light_idx, p, u_light, uc_light)
    f_l = bx.f(params, frame, wo, ls.wi, flags)
    cos_l = vm.absdot(ls.wi, ns)
    usable = (ls.pdf > 0.0) & spec.any_nonzero(ls.li) & spec.any_nonzero(f_l)
    sray = shadow_ray(p, it["ng"], ns, ls.wi, ls.dist, eps,
                      time=it.get("time"))
    occluded = st.intersect_p(geom, sray)
    # delta lights: plain estimate; others: power heuristic vs bsdf pdf
    bsdf_pdf = bx.pdf(params, frame, wo, ls.wi, flags)
    w_l = torch.where(ls.is_delta, 1.0,
                      smp.power_heuristic(1.0, ls.pdf, 1.0, bsdf_pdf))
    contrib_l = f_l * ls.li * (cos_l * w_l / ls.pdf.clamp_min(1e-20))
    ld = vm.where3(usable & ~occluded, contrib_l, 0.0)

    # ---- BSDF-sampling term (non-delta lights only) ----------------------
    bs = bx.sample_f(params, frame, wo, u_bsdf, uc_bsdf, flags)
    cos_b = vm.absdot(bs.wi, ns)
    sampled_specular = (bs.flags & bx.SPECULAR) != 0
    b_usable = (bs.valid & (bs.pdf > 0.0) & spec.any_nonzero(bs.f)
                & ~ls.is_delta)
    # trace toward the light
    ng_f = vm.face_forward(it["ng"], bs.wi)
    bray = vm.Rays(o=p + ng_f * eps, d=bs.wi,
                   tmin=torch.zeros_like(eps),
                   tmax=torch.full_like(eps, lt_mod.INF_DIST),
                   time=torch.zeros_like(eps))
    bh = st.intersect(geom, bray)
    # the traversal's finish fetched the hit triangle's attr row: its
    # precomputed ng and light id
    hit_light = torch.where(bh.prim >= 0, st._bits_i32(bh.rows[34]), -1)
    same_light = (hit_light >= 0) & (hit_light == light_idx)
    # emitted radiance from the hit light point (facing test)
    cos_hit = vm.dot(st.attr_v3(bh.rows, 9), -bs.wi)
    li_b = vm.where3(same_light & (cos_hit > 0),
                     lt_mod._g3(lt.intensity, hit_light.clamp_min(0).long()),
                     0.0)
    light_pdf_b = torch.where(
        same_light, lt_mod.pdf_li_area(lt, light_idx, p, bs.wi, bh.t,
                                       torch.abs(cos_hit)), 0.0)
    w_b = torch.where(sampled_specular, 1.0,
                      smp.power_heuristic(1.0, bs.pdf, 1.0, light_pdf_b))
    contrib_b = bs.f * li_b * (cos_b * w_b / bs.pdf.clamp_min(1e-20))
    return ld + vm.where3(b_usable & same_light, contrib_b, 0.0)


def nee_prepare(scene, it, frame, params, wo, u_select, u_light, uc_light,
                mask, flags=bx.ALL & ~bx.SPECULAR):
    """The shade half of next-event estimation: sample one light, evaluate
    the BSDF toward it, build the (masked) shadow ray WITHOUT tracing it.
    Returns (sray, usable, contrib): trace sray any-hit, then add
    where3(usable & ~occluded, contrib). Split out so the path integrator
    can trace the shadow ray with the next bounce's extension ray in one
    merged launch (scene/types.intersect_pair)."""
    geom = scene.geometry
    lt = scene.lights
    n_lights = lt.n
    light_idx = torch.clamp_max((u_select * n_lights).to(torch.int32),
                                n_lights - 1)
    p = it["p"]
    eps = st.ray_epsilon(it["t"])
    ns = frame.n
    ls = lt_mod.sample_li(lt, geom, light_idx, p, u_light, uc_light)
    f_l = bx.f(params, frame, wo, ls.wi, flags)
    cos_l = vm.absdot(ls.wi, ns)
    usable = (mask & (ls.pdf > 0.0) & spec.any_nonzero(ls.li)
              & spec.any_nonzero(f_l))
    sray = shadow_ray(p, it["ng"], ns, ls.wi, ls.dist, eps,
                      time=it.get("time"))
    sray = sray._replace(tmax=torch.where(usable, sray.tmax, -1.0))
    pdf_nee = ls.pdf / float(n_lights)
    bsdf_pdf = bx.pdf(params, frame, wo, ls.wi, flags)
    w_l = torch.where(ls.is_delta, 1.0,
                      smp.power_heuristic(1.0, pdf_nee, 1.0, bsdf_pdf))
    contrib = f_l * ls.li * (cos_l * w_l / pdf_nee.clamp_min(1e-20))
    return sray, usable, contrib


def emitter_hit_mis(scene, cur, hits, it, prev_pdf, prev_specular,
                    first_vertex):
    """MIS-weighted emitted radiance gathered by the path-extension ray.

    Returns V3: weighted Le for lanes whose extension ray hit an emissive
    prim. first_vertex / prev_specular lanes get weight 1 (primary
    visibility or delta-sampled)."""
    lt = scene.lights
    geom = scene.geometry
    shape, dev = cur.tmin.shape, cur.tmin.device
    if lt is None or lt.n == 0:
        return vm.v3zeros(shape, dev)
    n_l = float(lt.n)
    # the light id comes from the interaction attr row: no extra gather
    lid = torch.where(hits.prim >= 0, it["light_id"], -1)
    le = lt_mod.le_emitted(lt, geom, hits.prim, it["wo"], it["ns"],
                           lid=it["light_id"])
    cos_hit = vm.absdot(it["ng"], it["wo"])
    pdf_area = lt_mod.pdf_li_area(lt, lid.clamp_min(0), cur.o, cur.d,
                                  hits.t, cos_hit) / n_l
    w_mis = smp.power_heuristic(1.0, prev_pdf, 1.0, pdf_area)
    if first_vertex:
        w_surf = torch.ones_like(w_mis)
    else:
        w_surf = torch.where(prev_specular, 1.0, w_mis)
    return vm.where3(lid >= 0, le * w_surf, 0.0)


def uniform_sample_one_light(scene, it, frame, params, wo, u_select,
                             u_light, uc_light, u_bsdf, uc_bsdf,
                             flags=bx.ALL & ~bx.SPECULAR):
    """Pick one light uniformly, scale by the number of lights."""
    n_lights = scene.lights.n
    if n_lights == 0:
        return vm.v3zeros(it["t"].shape, it["t"].device)
    light_idx = torch.clamp_max((u_select * n_lights).to(torch.int32),
                                n_lights - 1)
    ld = estimate_direct(scene, it, frame, params, wo, light_idx,
                         u_light, uc_light, u_bsdf, uc_bsdf, flags)
    return ld * float(n_lights)


def uniform_sample_all_lights(scene, it, frame, params, wo, sctx, dim0,
                              n_samples_per_light=1,
                              flags=bx.ALL & ~bx.SPECULAR):
    """Sum direct light over every light: one ``estimate_direct`` wave (two
    traversal launches) per (light, sample) pair, each pair drawing its own
    sample dimensions ``dim0 + 6 i ..``."""
    n_lights = scene.lights.n
    t = it["t"]
    ns = int(n_samples_per_light)
    inv_ns = 1.0 / float(ns)
    sampler, px, py, s_idx = (sctx["sampler"], sctx["px"], sctx["py"],
                              sctx["s_idx"])
    total = vm.v3zeros(t.shape, t.device)
    for i in range(n_lights * ns):
        dim = dim0 + i * 6
        idx = torch.full(t.shape, i // ns, dtype=torch.int32,
                         device=t.device)
        ld = estimate_direct(
            scene, it, frame, params, wo, idx,
            smp_mod.sample_2d(sampler, px, py, s_idx, dim),
            smp_mod.sample_1d(sampler, px, py, s_idx, dim + 2),
            smp_mod.sample_2d(sampler, px, py, s_idx, dim + 3),
            smp_mod.sample_1d(sampler, px, py, s_idx, dim + 5), flags)
        total = total + ld * inv_ns
    return total
