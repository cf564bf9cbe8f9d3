"""Shared integrator machinery: MIS direct lighting over wavefronts
(counterpart of the JAX reference's ``integrators/common.py``).

Ported: what the path integrator uses, ``shadow_ray``, ``nee_prepare`` (the
shade half of next-event estimation) and ``emitter_hit_mis`` (MIS-weighted
emission gathered by the extension ray). ``estimate_direct`` and the
all-lights / one-light helpers built on it serve the direct-lighting and
Whitted integrators and come with them.
"""
from __future__ import annotations

import torch

from .. import bsdf as bx
from .. import lights as lt_mod
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
