"""The reference's radiance estimators: path tracing with next-event
estimation and MIS, direct lighting over every light with one specular
continuation, and ambient occlusion.

Each takes lanes (pixel x, pixel y, sample index) and draws its numbers
from the frozen sample hashing (``sampling.py``) at the dimensions the
program documents for that integrator, so both sides estimate the same
integral with the same numbers. Traversal is the reference's own
(``geometry.closest`` / ``geometry.occluded``); it carries no gradient, and
a gradient through ``kd_table`` flows through the shading as the program's
detached estimator does.
"""
from __future__ import annotations

import torch

from . import geometry as g
from . import sampling as smp
from . import shading as sh

INF = float("inf")


class Lanes:
    """The lanes of one evaluation and the sampler that feeds them."""

    def __init__(self, sampler: smp.Sampler, px, py, s, dtype):
        self.sampler, self.px, self.py, self.s = sampler, px, py, s
        self.dtype = dtype

    def u1(self, dim):
        return self.sampler.get1(self.px, self.py, self.s, dim).to(self.dtype)

    def u2(self, dim):
        a, b = self.sampler.get2(self.px, self.py, self.s, dim)
        return a.to(self.dtype), b.to(self.dtype)


def camera_rays(cam: sh.Camera, lanes: Lanes):
    """Camera rays of the lanes (image sample = dimensions 0 and 1)."""
    ux, uy = lanes.u2(0)
    x = lanes.px.to(lanes.dtype) + ux
    y = lanes.py.to(lanes.dtype) + uy
    return cam.rays(x, y)


def _masked_closest(sc, o, d, live):
    """Closest hits of the live lanes only (the rest miss)."""
    n = o.shape[0]
    t = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    f = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    b1 = torch.zeros((n,), dtype=o.dtype, device=o.device)
    b2 = torch.zeros_like(b1)
    idx = torch.nonzero(live).squeeze(1)
    if idx.numel():
        z = torch.zeros((idx.numel(),), dtype=o.dtype, device=o.device)
        ti, fi, u, v = g.closest(sc, o[idx].detach(), d[idx].detach(), z,
                                 torch.full_like(z, INF))
        t[idx], f[idx], b1[idx], b2[idx] = ti, fi, u, v
    return t, f, b1, b2


def _masked_occluded(sc, o, d, tmax, live):
    n = o.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    idx = torch.nonzero(live).squeeze(1)
    if idx.numel():
        z = torch.zeros((idx.numel(),), dtype=o.dtype, device=o.device)
        occ[idx] = g.occluded(sc, o[idx].detach(), d[idx].detach(), z,
                              tmax[idx].detach())
    return occ


def _where3(m, a, b=None):
    return torch.where(m[:, None], a, torch.zeros_like(a) if b is None else b)


def path(sc: g.Scene, cam: sh.Camera, lanes: Lanes, max_depth=5,
         rr_depth=3, kd_table=None):
    """Radiance of each lane by the path integrator: emission at the first
    vertex or after a specular bounce at full weight, else MIS-weighted;
    one light chosen uniformly for next-event estimation at every vertex;
    Russian roulette after bounce ``rr_depth``. Dimensions from 5 + 10 b at
    bounce b: light choice +0, light point +1, light face +3, BSDF
    direction +7, roulette +8, lobe choice +9."""
    o, d = camera_rays(cam, lanes)
    n = o.shape[0]
    dt = lanes.dtype
    dev = o.device
    L = torch.zeros((n, 3), dtype=dt, device=dev)
    beta = torch.ones((n, 3), dtype=dt, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    spec_prev = torch.zeros_like(active)
    pdf_prev = torch.zeros((n,), dtype=dt, device=dev)
    n_lights = len(sc.lights)
    t, f, b1, b2 = _masked_closest(sc, o, d, active)
    for bounce in range(max_depth + 1):
        dim = 5 + 10 * bounce
        hit = (f >= 0) & active
        it = sh.interaction(sc, o, d, f, b1, b2)
        pr = sh.Params(sc, it["mat"], kd_table)
        # emission found by the ray that reached this vertex
        le, lid = sh.emitted(sc, it, f)
        if bounce == 0:
            w = torch.ones_like(pdf_prev)
        else:
            cos_hit = torch.abs(g.dot(it["ng"], it["wo"]))
            p_l = sh.light_pdf_hit(sc, lid, t, cos_hit) / n_lights
            w = torch.where(spec_prev, torch.ones_like(p_l),
                            sh.power_heuristic(pdf_prev, p_l))
        L = L + _where3(active & (lid >= 0), beta * le * w[:, None])
        # next-event estimation toward one light
        u_sel = lanes.u1(dim)
        light = torch.clamp_max((u_sel * n_lights).to(torch.int64),
                                n_lights - 1)
        ua, ub = lanes.u2(dim + 1)
        uc = lanes.u1(dim + 3)
        wi, Li, pdf_l, dist = _sample_lights(sc, light, it["p"], ua, ub, uc)
        live = hit & (pdf_l > 0.0) & sh.nonzero3(Li)
        wi_s = torch.where(live[:, None], wi, it["ns"])
        f_l = sh.bsdf_f(pr, it, it["wo"], wi_s)
        usable = live & sh.nonzero3(f_l)
        eps = sh.ray_epsilon(t)
        s_o = sh.shadow_origin(it, wi, eps)
        s_tmax = dist * (1.0 - 1e-3) - eps
        pdf_nee = pdf_l / n_lights
        pdf_b = sh.bsdf_pdf(pr, it, it["wo"], wi_s)
        w_l = sh.power_heuristic(pdf_nee, pdf_b)
        scale = torch.where(usable, torch.abs(g.dot(wi, it["ns"])) * w_l
                            / pdf_nee.clamp_min(1e-20),
                            torch.zeros_like(pdf_nee))
        contrib = f_l * Li * scale[:, None]
        last = bounce == max_depth
        if not last:
            u1, u2 = lanes.u2(dim + 7)
            wi_b, f_b, pdf_bs, is_spec, valid = sh.sample_bsdf(
                pr, it, it["wo"], u1, u2, lanes.u1(dim + 9))
            cos_s = torch.abs(g.dot(wi_b, it["ns"]))
            cont = hit & valid & (pdf_bs > 0.0) & sh.nonzero3(f_b)
            new_beta = beta * f_b * (cos_s / pdf_bs.clamp_min(1e-20))[:, None]
            if bounce > rr_depth:
                q = sh.luminance(new_beta).clamp_max(0.5)
                cont = cont & (lanes.u1(dim + 8) <= q)
                new_beta = new_beta * (1.0 / q.clamp_min(1e-8))[:, None]
            n_o = it["p"] + g.face_forward(it["ng"], wi_b) * eps[:, None]
        occ = _masked_occluded(sc, s_o, wi, s_tmax, usable)
        L = L + _where3(usable & ~occ, beta * contrib)
        if last:
            break
        t, f, b1, b2 = _masked_closest(sc, n_o, wi_b, cont)
        beta = _where3(cont, new_beta, beta)
        spec_prev = is_spec
        pdf_prev = pdf_bs
        active = cont
        o, d = n_o, wi_b
    return L


def _sample_lights(sc, light, p, ua, ub, uc):
    """Per-lane light sample from a per-lane light index (area lights)."""
    out = None
    for k in range(len(sc.lights)):
        s = sh.sample_area_light(sc, k, p, ua, ub, uc)
        if out is None:
            out = list(s)
        else:
            m = light == k
            out = [torch.where(m[:, None] if a.dim() == 2 else m, b, a)
                   for a, b in zip(out, s)]
    return out


def _estimate_direct(sc, it, pr, light, ua, ub, uc, vb1, vb2, vbc, live):
    """MIS estimate toward area light `light` (an int): a light sample and a
    BSDF sample, each with the power heuristic against the other's pdf."""
    n = it["p"].shape[0]
    wi, Li, pdf_l, dist = sh.sample_area_light(sc, light, it["p"], ua, ub, uc)
    f_l = sh.bsdf_f(pr, it, it["wo"], wi)
    usable = live & (pdf_l > 0.0) & sh.nonzero3(Li) & sh.nonzero3(f_l)
    eps = sh.ray_epsilon(it["t_hit"])
    occ = _masked_occluded(sc, sh.shadow_origin(it, wi, eps), wi,
                           dist * (1.0 - 1e-3) - eps, usable)
    pdf_b = sh.bsdf_pdf(pr, it, it["wo"], wi)
    w_l = sh.power_heuristic(pdf_l, pdf_b)
    c_l = f_l * Li * (torch.abs(g.dot(wi, it["ns"])) * w_l
                      / pdf_l.clamp_min(1e-20))[:, None]
    ld = _where3(usable & ~occ, c_l)
    wi_b, f_b, pdf_bs, is_spec, valid = sh.sample_bsdf(
        pr, it, it["wo"], vb1, vb2, vbc, specular=False)
    b_ok = live & valid & (pdf_bs > 0.0) & sh.nonzero3(f_b)
    o_b = it["p"] + g.face_forward(it["ng"], wi_b) * eps[:, None]
    tb, fb, _, _ = _masked_closest(sc, o_b, wi_b, b_ok)
    hit_light = torch.where(fb >= 0, sc.light_id[fb.clamp_min(0)], -1)
    same = hit_light == light
    cos_hit = g.dot(sc.ng[fb.clamp_min(0)], -wi_b)
    Lb = torch.where((same & (cos_hit > 0))[:, None],
                     sc.lights[light]["L"].expand(n, 3),
                     torch.zeros((n, 3), dtype=Li.dtype, device=Li.device))
    p_lb = torch.where(same, (tb * tb) / (torch.abs(cos_hit)
                                          * sc.lights[light]["total_area"]
                                          ).clamp_min(1e-9),
                       torch.zeros_like(tb))
    w_b = sh.power_heuristic(pdf_bs, p_lb)
    c_b = f_b * Lb * (torch.abs(g.dot(wi_b, it["ns"])) * w_b
                      / pdf_bs.clamp_min(1e-20))[:, None]
    return ld + _where3(b_ok & same, c_b)


def direct(sc: g.Scene, cam: sh.Camera, lanes: Lanes, max_depth=5):
    """Radiance of each lane by the direct-lighting integrator (strategy
    all): emission at every vertex, the MIS estimate toward every light
    (light point dims d, d+1, face d+2, BSDF direction d+3, d+4, lobe d+5,
    six a light), then one specular continuation (dims d, d+1 direction,
    d+2 lobe)."""
    o, d = camera_rays(cam, lanes)
    n = o.shape[0]
    dt = lanes.dtype
    dev = o.device
    L = torch.zeros((n, 3), dtype=dt, device=dev)
    beta = torch.ones((n, 3), dtype=dt, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    dim = 5
    for depth in range(max_depth + 1):
        t, f, b1, b2 = _masked_closest(sc, o, d, active)
        hit = (f >= 0) & active
        it = sh.interaction(sc, o, d, f, b1, b2)
        it["t_hit"] = t
        pr = sh.Params(sc, it["mat"])
        le, _ = sh.emitted(sc, it, f)
        L = L + _where3(hit, beta * le)
        for k in range(len(sc.lights)):
            dk = dim + 6 * k
            ua, ub = lanes.u2(dk)
            vb1, vb2 = lanes.u2(dk + 3)
            ld = _estimate_direct(sc, it, pr, k, ua, ub, lanes.u1(dk + 2),
                                  vb1, vb2, lanes.u1(dk + 5), hit)
            L = L + _where3(hit, beta * ld)
        dim += 6 * len(sc.lights)
        if depth == max_depth:
            break
        u1, u2 = lanes.u2(dim)
        wi_b, f_b, pdf_bs, _, valid = sh.sample_bsdf(
            pr, it, it["wo"], u1, u2, lanes.u1(dim + 2), diffuse=False)
        cont = hit & valid & (pdf_bs > 0.0) & sh.nonzero3(f_b)
        cos_s = torch.abs(g.dot(wi_b, it["ns"]))
        beta = _where3(cont, beta * f_b * (cos_s / pdf_bs.clamp_min(1e-20))
                       [:, None], beta)
        eps = sh.ray_epsilon(t)
        o = it["p"] + g.face_forward(it["ng"], wi_b) * eps[:, None]
        d = wi_b
        active = cont
        dim += 3
    return L


def ambient_occlusion(sc: g.Scene, cam: sh.Camera, lanes: Lanes,
                      n_samples=64, min_dist=1e-4, max_dist=INF):
    """Share of ``n_samples`` hemisphere probes about the shading normal
    that leave the hit point unoccluded within [min_dist, max_dist]. The
    probes are a (0,2)-sequence scrambled by a hash of (pixel, sample), the
    same for every probe of a lane, mapped to the sphere and turned into
    the normal's hemisphere."""
    o, d = camera_rays(cam, lanes)
    n = o.shape[0]
    dt = lanes.dtype
    live = torch.ones((n,), dtype=torch.bool, device=o.device)
    t, f, b1, b2 = _masked_closest(sc, o, d, live)
    hit = f >= 0
    it = sh.interaction(sc, o, d, f, b1, b2)
    nrm = g.face_forward(it["ns"], it["wo"])
    base = smp.hash_u32(smp.u32(lanes.px) ^ (smp.u32(lanes.py) << 16)
                        ^ smp.hash_u32(smp.u32(lanes.s)))
    sx = smp.hash_u32(base ^ 0x1234567)
    sy = smp.hash_u32(base ^ 0x89abcdef)
    eps = sh.ray_epsilon(t)
    org = it["p"] + g.face_forward(it["ng"], nrm) * eps[:, None]
    n_bits = max(int(n_samples - 1).bit_length(), 1)
    clear = torch.zeros((n,), dtype=dt, device=o.device)
    tmin = torch.full((n,), min_dist, dtype=dt, device=o.device)
    tmax = torch.full((n,), max_dist, dtype=dt, device=o.device)
    idx = torch.nonzero(hit).squeeze(1)
    for i in range(n_samples):
        ii = torch.full((n,), i, dtype=torch.int64, device=o.device)
        ux, uy = smp.sample02(ii, sx, sy, n_bits)
        ux, uy = ux.to(dt), uy.to(dt)
        z = 1.0 - 2.0 * ux
        r = torch.sqrt((1.0 - z * z).clamp_min(0.0))
        phi = 2.0 * torch.pi * uy
        w = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
        w = g.face_forward(w, nrm)
        occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
        if idx.numel():
            occ[idx] = g.occluded(sc, org[idx], w[idx], tmin[idx], tmax[idx])
        clear = clear + (hit & ~occ).to(dt)
    ao = clear / n_samples
    return torch.where(hit[:, None], ao[:, None].expand(n, 3),
                       torch.zeros((n, 3), dtype=dt, device=o.device))
