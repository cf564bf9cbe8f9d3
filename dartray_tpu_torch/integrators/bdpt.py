"""Bidirectional path radiance for the Metropolis renderer (counterpart of the
JAX reference's ``integrators/bdpt.py``).

``path_l`` is a pure function of the chains' primary-sample matrix u
(R, D), held in ``sctx["sampler"].u_vec``; every sampling decision reads a
column of it, modulo D (``_col``). Layout after the 5 camera dims:

  eye path i   (4 each): uc, u1, u2, rr
  lighting  i  (7 each): lightNum, light uc/u1/u2, bsdf uc/u1/u2
  bidir header (6):      lightNumSample, light pos u1/u2, uc, dir u1/u2
  light path j (4 each): uc, u1, u2, rr

``generate_path`` builds an eye or a light subpath by BSDF sampling with
Russian roulette at every vertex (alpha is the throughput TO the vertex; a
black f, a zero pdf or a roulette kill ends the lane's path), one
closest-hit launch a vertex. ``path_l`` then adds at every eye vertex the
emitted light after a specular prefix (the s = 0 strategy), MIS direct
lighting weighted 1 / (i + 1 - nSpec[i + 1]) (``common.estimate_direct``:
one any-hit and one closest-hit launch) and a connection to every
non-specular light vertex through one any-hit launch each, weighted
1 / (i + j + 2 - nSpec[i + j + 2]), with both f scaled by
(1 + nSpecularComponents); and where an eye path escapes after a specular
prefix, the environment. The BSDFs at both ends of an eye vertex's
connections are evaluated in one call each over all its light vertices'
lanes (the same values lane by lane; the stack's host operations then
count once an eye vertex, not once a connection). At max_depth D a call
launches 3 D closest-hit and D + D^2 any-hit traversals. ``skip_direct``
drops the direct terms of paths whose eye prefix is not all specular (the
Metropolis renderer's separate direct pass).
"""
from __future__ import annotations

import torch

from .. import bsdf as bx
from .. import lights as lt_mod
from .. import materials as mat_mod
from ..core import math as vm
from ..core import spectrum as spec
from ..scene import types as st
from . import common

CAM_DIMS = 5


def dims_for(max_depth: int, bidirectional: bool = True) -> int:
    """Primary-sample dimensions of one chain's vector."""
    d = CAM_DIMS + 4 * max_depth + 7 * max_depth
    if bidirectional:
        d += 6 + 4 * max_depth
    return d


def _col(u, d):
    return u[:, d % u.shape[1]]


def generate_path(scene, rays, alpha, u, base, max_len):
    """(verts, esc_d, esc_alpha): the subpath's vertices (one dict of lane
    arrays each) and, for lanes whose path left the scene, the direction
    and throughput at escape (alpha zero where it never escaped)."""
    geom = scene.geometry
    r = rays.n
    dev = rays.tmin.device
    active = torch.ones((r,), dtype=torch.bool, device=dev)
    esc_alpha = vm.v3zeros((r,), dev)
    esc_d = rays.d
    verts = []
    for i in range(max_len):
        rays = rays._replace(tmax=torch.where(active, rays.tmax, -1.0))
        hits = st.intersect(geom, rays)
        it = st.interaction(geom, rays, hits)
        valid = hits.hit & active
        esc_now = active & ~hits.hit
        esc_alpha = vm.where3(esc_now, alpha, esc_alpha)
        esc_d = vm.where3(esc_now, rays.d, esc_d)
        it["ns"] = mat_mod.bump_shading_normal(scene.materials, it["mat_id"],
                                               scene.textures, it)
        frame = bx.make_frame(it["ns"], it["dpdu"], it["ng"])
        params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                     scene.textures, it)
        uc = _col(u, base + 4 * i)
        u2 = vm.V2(_col(u, base + 4 * i + 1), _col(u, base + 4 * i + 2))
        urr = _col(u, base + 4 * i + 3)
        wo = it["wo"]
        bs = bx.sample_f(params, frame, wo, u2, uc, flags=bx.ALL)
        cos_s = vm.absdot(bs.wi, frame.n)
        f_ok = bs.valid & (bs.pdf > 0.0) & spec.any_nonzero(bs.f)
        path_scale = bs.f * (cos_s / bs.pdf.clamp_min(1e-20))
        rr_prob = spec.luminance(path_scale).clamp_max(1.0)
        survive = urr <= rr_prob
        cont = valid & f_ok & survive
        verts.append(dict(
            p=it["p"], ng=it["ng"], ns=it["ns"], t=hits.t, prim=hits.prim,
            light_id=it["light_id"], time=rays.time, wprev=wo, frame=frame,
            params=params, it=it, alpha=alpha, valid=valid,
            spec=(bs.flags & bx.SPECULAR) != 0,
            nspec=bx.n_specular_components(params)))
        alpha = vm.where3(cont,
                          alpha * path_scale
                          * (1.0 / rr_prob.clamp_min(1e-8)), alpha)
        eps = st.ray_epsilon(it["t"])
        ng_f = vm.face_forward(it["ng"], bs.wi)
        rays = vm.Rays(o=it["p"] + ng_f * eps, d=bs.wi,
                       tmin=torch.zeros((r,), dtype=torch.float32,
                                        device=dev),
                       tmax=torch.where(cont, float("inf"), -1.0),
                       time=rays.time)
        active = cont
    return verts, esc_d, esc_alpha


def path_l(scene, rays, diffs, sctx, *, max_depth: int = 4,
           bidirectional: bool = True, skip_direct: bool = False,
           cam_weight=None):
    """The bidirectional radiance (V3) of the camera rays, driven by the
    primary-sample matrix in ``sctx["sampler"].u_vec``."""
    del diffs
    u = sctx["sampler"].u_vec
    geom = scene.geometry
    lt = scene.lights
    r = rays.n
    dev = rays.tmin.device
    L = vm.v3zeros((r,), dev)
    if lt is None or lt.n == 0:
        return L
    eye_base = CAM_DIMS
    lighting_base = eye_base + 4 * max_depth
    bidir_base = lighting_base + 7 * max_depth
    lpath_base = bidir_base + 6
    ones = torch.ones((r,), dtype=torch.bool, device=dev)

    alpha0 = vm.v3ones((r,), dev) if cam_weight is None else cam_weight
    cam_path, esc_d, esc_alpha = generate_path(scene, rays, alpha0, u,
                                               eye_base, max_depth)

    light_path = []
    if bidirectional:
        lidx, lpdf = lt_mod.sample_light_index(lt, _col(u, bidir_base))
        les = lt_mod.sample_le(
            lt, geom, lidx, lpdf,
            u_pos=torch.stack([_col(u, bidir_base + 1),
                               _col(u, bidir_base + 2)], -1),
            uc=_col(u, bidir_base + 3),
            u_dir=torch.stack([_col(u, bidir_base + 4),
                               _col(u, bidir_base + 5)], -1))
        lrays = vm.Rays(o=les.o, d=les.d,
                        tmin=torch.zeros((r,), dtype=torch.float32,
                                         device=dev),
                        tmax=torch.where(spec.any_nonzero(les.alpha),
                                         float("inf"), -1.0),
                        time=rays.time)
        light_path, _, _ = generate_path(scene, lrays, les.alpha, u,
                                         lpath_base, max_depth)

    # nSpecularVertices[n]: per lane, the (i, j) pairs of path length n
    # with a specular end
    n_verts = 2 * max_depth + 2
    nspec_len = [torch.zeros((r,), dtype=torch.int32, device=dev)
                 for _ in range(n_verts)]
    for i, vc in enumerate(cam_path):
        for j, vl in enumerate(light_path):
            both = vc["valid"] & vl["valid"]
            is_spec = (vc["spec"] | vl["spec"]) & both
            nspec_len[i + j + 2] = nspec_len[i + j + 2] \
                + is_spec.to(torch.int32)

    # the light vertices joined along their lanes, for the connections
    lp = {k: bx.cat_lanes([vl[k] for vl in light_path])
          for k in ("p", "ns", "frame", "params", "wprev", "nspec")} \
        if light_path else None
    prev_spec = ones
    all_spec = ones
    for i, vc in enumerate(cam_path):
        valid = vc["valid"]
        direct_ok = ones if not skip_direct else ~all_spec
        # emitted light at the vertex (the s = 0 strategy)
        le = lt_mod.le_emitted(lt, geom, vc["prim"], vc["wprev"], vc["ns"],
                               lid=vc["light_id"])
        L = L + vm.where3(valid & prev_spec & direct_ok,
                          vc["alpha"] * le, 0.0)
        # MIS direct lighting, weighted over same-length eye strategies
        db = lighting_base + 7 * i
        lidx_d, lpdf_d = lt_mod.sample_light_index(lt, _col(u, db))
        ld = common.estimate_direct(
            scene, vc["it"], vc["frame"], vc["params"], vc["wprev"], lidx_d,
            u_light=vm.V2(_col(u, db + 2), _col(u, db + 3)),
            uc_light=_col(u, db + 1),
            u_bsdf=vm.V2(_col(u, db + 5), _col(u, db + 6)),
            uc_bsdf=_col(u, db + 4))
        w_d = 1.0 / ((i + 1) - nspec_len[i + 1].to(torch.float32)
                     ).clamp_min(1.0)
        L = L + vm.where3(valid & direct_ok,
                          vc["alpha"] * ld * (w_d / lpdf_d), 0.0)
        prev_spec = torch.where(valid, vc["spec"], prev_spec)
        all_spec = all_spec & torch.where(valid, vc["spec"], True)
        # connections to every light-path vertex: both ends' BSDFs of the
        # vertex's J connections in one call each, over J R lanes; each
        # connection keeps its own shadow launch
        if not light_path:
            continue
        J = len(light_path)
        tiled = lambda k: bx.cat_lanes([vc[k]] * J)  # noqa: E731
        to_l = lp["p"] - tiled("p")
        d2 = vm.length_sq(to_l).clamp_min(1e-12)
        dist = torch.sqrt(d2)
        w_dir = to_l * (1.0 / dist)
        fc = bx.f(tiled("params"), tiled("frame"), tiled("wprev"), w_dir) \
            * (1.0 + tiled("nspec").to(torch.float32))
        fl = bx.f(lp["params"], lp["frame"], -w_dir, lp["wprev"]) \
            * (1.0 + lp["nspec"].to(torch.float32))
        eps_c = st.ray_epsilon(vc["t"])
        for j, vl in enumerate(light_path):
            sl = slice(j * r, (j + 1) * r)
            fc_j, fl_j, w_j = (vm.V3(*(a[sl] for a in v))
                               for v in (fc, fl, w_dir))
            ok = valid & vl["valid"] & ~vc["spec"] & ~vl["spec"]
            ok = ok & spec.any_nonzero(fc_j) & spec.any_nonzero(fl_j)
            sray = common.shadow_ray(vc["p"], vc["ng"], vc["ns"], w_j,
                                     dist[sl], eps_c, time=vc["time"])
            sray = sray._replace(tmax=torch.where(ok, sray.tmax, -1.0))
            occ = st.intersect_p(geom, sray)
            g = (vm.absdot(vc["ns"], w_j) * vm.absdot(vl["ns"], w_j)
                 / d2[sl])
            wt = 1.0 / ((i + j + 2)
                        - nspec_len[i + j + 2].to(torch.float32)
                        ).clamp_min(1.0)
            L = L + vm.where3(ok & ~occ,
                              vc["alpha"] * fc_j * fl_j * vl["alpha"]
                              * (g * wt), 0.0)
    # an eye path that escaped after a specular prefix sees the environment
    if lt.env_light_index >= 0:
        direct_ok = ones if not skip_direct else ~all_spec
        le_env = lt_mod.env_le(lt, esc_d)
        L = L + vm.where3(prev_spec & direct_ok
                          & spec.any_nonzero(esc_alpha),
                          esc_alpha * le_env, 0.0)
    return L
