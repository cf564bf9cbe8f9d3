"""The reference's camera, surface interaction, BSDFs and area lights.

Plain torch over (N, 3) tensors, following pbrt-v2 and the program's
documented conventions: a perspective pinhole camera through the centre of
the raster, interpolated shading normals turned to the geometric normal's
side, a shading frame from dp/du, Lambertian reflection sampled by the
concentric disk map, dielectric glass and a Fresnel-less mirror chosen by
one uniform number among the specular lobes, one-sided area lights sampled
by area, the power heuristic. Only the material kinds the configurations
use are written: ``matte``, ``glass`` and ``mirror``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .geometry import Scene, cross, dot, face_forward, normalize

INV_PI = float(np.float32(1.0 / np.pi))
LUMA = (0.212671, 0.715160, 0.072169)


def luminance(c):
    return LUMA[0] * c[:, 0] + LUMA[1] * c[:, 1] + LUMA[2] * c[:, 2]


def nonzero3(c):
    return (c != 0).any(-1)


# --- camera ------------------------------------------------------------------

def look_at(eye, look, up):
    """Camera-to-world 4x4 (pbrt's LookAt, inverted), float64."""
    eye, look, up = (np.asarray(x, np.float64) for x in (eye, look, up))
    d = look - eye
    d /= np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, new_up, d, eye
    return m


class Camera:
    def __init__(self, eye, look, up, fov_deg, width, height, dtype,
                 device):
        self.c2w = torch.as_tensor(look_at(eye, look, up).astype(np.float32),
                                   device=device).to(dtype)
        aspect = width / height
        self.window = ((-aspect, aspect, -1.0, 1.0) if aspect > 1.0
                       else (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect))
        self.tan_half = math.tan(math.radians(fov_deg) / 2.0)
        self.width, self.height = width, height

    def rays(self, x, y):
        """Raster positions -> world (o, d) of the pinhole camera."""
        x0, x1, y0, y1 = self.window
        sx = x0 + x * ((x1 - x0) / self.width)
        sy = y1 + y * ((y0 - y1) / self.height)
        dc = normalize(torch.stack([sx * self.tan_half, sy * self.tan_half,
                                    torch.ones_like(sx)], -1))
        m = self.c2w
        d = dc @ m[:3, :3].T
        o = m[:3, 3].expand_as(d)
        return o.contiguous(), d


# --- interaction -------------------------------------------------------------

def interaction(sc: Scene, o, d, face, b1, b2):
    """Shading data of hit points; faces clamped so misses stay finite."""
    f = face.clamp_min(0)
    b0 = 1.0 - b1 - b2
    p = sc.v0[f] + sc.e1[f] * b1[:, None] + sc.e2[f] * b2[:, None]
    ng = sc.ng[f]
    vn = sc.vn[f]
    ns = normalize(vn[:, 0] * b0[:, None] + vn[:, 1] * b1[:, None]
                   + vn[:, 2] * b2[:, None])
    ns = face_forward(ns, ng)
    dpdu = sc.dpdu[f]
    s = normalize(dpdu - ns * dot(ns, dpdu)[:, None])
    degen = dot(s, s) < 1e-12
    s = torch.where(degen[:, None], _any_perpendicular(ns), s)
    t = cross(ns, s)
    return {"p": p, "ng": ng, "ns": ns, "s": s, "t": t, "wo": -d,
            "mat": sc.mat_id[f], "light": sc.light_id[f]}


def _any_perpendicular(n):
    x, y, z = n[:, 0], n[:, 1], n[:, 2]
    big_x = torch.abs(x) > torch.abs(y)
    inv_a = torch.rsqrt(torch.where(big_x, x * x + z * z,
                                    y * y + z * z).clamp_min(1e-30))
    zero = torch.zeros_like(x)
    a = torch.stack([-z * inv_a, zero, x * inv_a], -1)
    b = torch.stack([zero, z * inv_a, -y * inv_a], -1)
    return torch.where(big_x[:, None], a, b)


def to_local(it, w):
    return torch.stack([dot(w, it["s"]), dot(w, it["t"]),
                        dot(w, it["ns"])], -1)


def to_world(it, w):
    return (it["s"] * w[:, 0:1] + it["t"] * w[:, 1:2]
            + it["ns"] * w[:, 2:3])


def ray_epsilon(t):
    return 1e-3 * t.clamp_min(1e-4)


# --- materials ---------------------------------------------------------------

class Params:
    """Per-lane material parameters: kd of the matte lanes (zero elsewhere),
    kr / kt / eta of the specular ones, and which lobes each lane has."""

    def __init__(self, sc: Scene, mat, kd_table=None):
        kinds = sc.materials["kind"]
        kdt = sc.materials["kd"] if kd_table is None else kd_table
        is_matte = torch.tensor([k == "matte" for k in kinds],
                                device=mat.device)[mat]
        is_glass = torch.tensor([k == "glass" for k in kinds],
                                device=mat.device)[mat]
        is_mirror = torch.tensor([k == "mirror" for k in kinds],
                                 device=mat.device)[mat]
        self.kd = torch.where(is_matte[:, None], kdt[mat],
                              torch.zeros_like(kdt[mat]))
        self.kr = sc.materials["kr"][mat]
        self.kt = sc.materials["kt"][mat]
        self.eta = sc.materials["eta"][mat]
        self.diffuse = is_matte & nonzero3(self.kd)
        self.spec_r = (is_glass | is_mirror) & nonzero3(self.kr)
        self.spec_t = is_glass & nonzero3(self.kt)
        self.fresnel = is_glass


def fr_dielectric(cos_i, eta):
    entering = cos_i > 0.0
    one = torch.ones_like(eta)
    ei = torch.where(entering, one, eta)
    et = torch.where(entering, eta, one)
    ci = torch.abs(cos_i.clamp(-1.0, 1.0))
    sint = ei / et * torch.sqrt((1.0 - ci * ci).clamp_min(0.0))
    ct = torch.sqrt((1.0 - sint * sint).clamp_min(0.0))
    r_parl = (et * ci - ei * ct) / (et * ci + ei * ct).clamp_min(1e-12)
    r_perp = (ei * ci - et * ct) / (ei * ci + et * ct).clamp_min(1e-12)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(sint >= 1.0, one, f)


def bsdf_f(pr: Params, it, wo_w, wi_w):
    """The Lambertian lobe's value (the only non-specular one here), with
    the geometric side test. The specular lobes add nothing."""
    wo = to_local(it, wo_w)
    wi = to_local(it, wi_w)
    reflect = dot(wi_w, it["ng"]) * dot(wo_w, it["ng"]) > 0.0
    on = pr.diffuse & reflect & (wo[:, 2] * wi[:, 2] > 0.0)
    return torch.where(on[:, None], pr.kd * INV_PI, torch.zeros_like(pr.kd))


def bsdf_pdf(pr: Params, it, wo_w, wi_w):
    """Cosine pdf of the Lambertian lobe, the one non-specular lobe here
    (the queries that ask for a pdf leave the specular lobes out)."""
    wo = to_local(it, wo_w)
    wi = to_local(it, wi_w)
    on = pr.diffuse & (wo[:, 2] * wi[:, 2] > 0.0)
    return torch.where(on, torch.abs(wi[:, 2]) * INV_PI,
                       torch.zeros_like(wi[:, 2]))


def concentric_disk(ux, uy):
    sx = 2.0 * ux - 1.0
    sy = 2.0 * uy - 1.0
    zero = (sx == 0.0) & (sy == 0.0)
    x_big = torch.abs(sx) > torch.abs(sy)
    r = torch.where(x_big, sx, sy)
    one = torch.ones_like(sx)
    sdiv = lambda a, b: a / torch.where(torch.abs(b) < 1e-30, one, b)
    theta = torch.where(x_big, (math.pi / 4.0) * sdiv(sy, sx),
                        (math.pi / 2.0) - (math.pi / 4.0) * sdiv(sx, sy))
    r = torch.where(zero, torch.zeros_like(r), r)
    return r * torch.cos(theta), r * torch.sin(theta)


def sample_bsdf(pr: Params, it, wo_w, u1, u2, uc, specular=True,
                diffuse=True):
    """One lobe chosen by uc among the admitted ones, then its direction.
    Returns (wi world, f, pdf, is_specular, valid)."""
    wo = to_local(it, wo_w)
    dr = pr.diffuse if diffuse else torch.zeros_like(pr.diffuse)
    sr = pr.spec_r if specular else torch.zeros_like(pr.spec_r)
    stt = pr.spec_t if specular else torch.zeros_like(pr.spec_t)
    n = dr.to(torch.int64) + sr.to(torch.int64) + stt.to(torch.int64)
    which = torch.minimum((uc * n.to(uc.dtype)).to(torch.int64),
                          (n - 1).clamp_min(0))
    # the lobes in slot order: diffuse, specular reflection, transmission
    pick_d = dr & (which == 0)
    pick_r = sr & (which == dr.to(torch.int64))
    pick_t = stt & ~pick_d & ~pick_r
    x, y = concentric_disk(u1, u2)
    z = torch.sqrt((1.0 - x * x - y * y).clamp_min(0.0))
    z = torch.where(wo[:, 2] < 0, -z, z)
    wi_d = torch.stack([x, y, z], -1)
    wi_r = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    # refraction
    entering = wo[:, 2] > 0.0
    one = torch.ones_like(pr.eta)
    ei = torch.where(entering, one, pr.eta)
    et = torch.where(entering, pr.eta, one)
    sini2 = (1.0 - wo[:, 2] ** 2).clamp_min(0.0)
    eta_r = ei / et
    sint2 = eta_r * eta_r * sini2
    t_ok = sint2 < 1.0
    cost = torch.sqrt((1.0 - sint2).clamp_min(0.0))
    cost = torch.where(entering, -cost, cost)
    wi_t = torch.stack([-eta_r * wo[:, 0], -eta_r * wo[:, 1], cost], -1)
    wi = torch.where(pick_r[:, None], wi_r,
                     torch.where(pick_t[:, None], wi_t, wi_d))
    wi_w = to_world(it, wi)
    acx = torch.abs(wi[:, 2]).clamp_min(1e-8)
    fr = torch.where(pr.fresnel, fr_dielectric(wo[:, 2], pr.eta), one)
    f_r = pr.kr * (fr / acx)[:, None]
    f_t = pr.kt * ((1.0 - fr) * (ei * ei) / (et * et) / acx)[:, None]
    f_t = torch.where(t_ok[:, None], f_t, torch.zeros_like(f_t))
    f_d = bsdf_f(pr, it, wo_w, wi_w) if diffuse else torch.zeros_like(f_r)
    is_spec = pick_r | pick_t
    f = torch.where(pick_r[:, None], f_r,
                    torch.where(pick_t[:, None], f_t, f_d))
    nf = n.to(u1.dtype).clamp_min(1.0)
    pdf_d = (torch.where(dr & (wo[:, 2] * wi[:, 2] > 0.0),
                         torch.abs(wi[:, 2]) * INV_PI, torch.zeros_like(nf))
             / nf)
    pdf = torch.where(is_spec, 1.0 / nf, pdf_d)
    valid = (n > 0) & (pdf > 0.0) & (~pick_t | t_ok)
    return wi_w, f, pdf, is_spec, valid


# --- area lights -------------------------------------------------------------

def sample_area_light(sc: Scene, light, p, u1, u2, uc):
    """A point of area light `light` (an int) seen from p: (wi, Li, pdf in
    solid angle, distance)."""
    li = sc.lights[light]
    cdf = li["cdf"]
    k = (torch.searchsorted(cdf, uc.contiguous(), right=True) - 1).clamp(
        0, li["count"] - 1)
    f = li["first"] + k
    su = torch.sqrt(u1)
    b1, b2 = 1.0 - su, u2 * su
    ps = sc.v0[f] + sc.e1[f] * b1[:, None] + sc.e2[f] * b2[:, None]
    to = ps - p
    d2 = dot(to, to).clamp_min(1e-12)
    dist = torch.sqrt(d2)
    wi = to / dist[:, None]
    cos_l = dot(sc.ng[f], -wi)
    Li = torch.where((cos_l > 0)[:, None], li["L"].expand_as(wi),
                     torch.zeros_like(wi))
    pdf = d2 / (torch.abs(cos_l) * li["total_area"]).clamp_min(1e-9)
    return wi, Li, pdf, dist


def light_pdf_hit(sc: Scene, light_ids, t, cos_hit):
    """Solid-angle pdf of sampling the hit point on its area light."""
    area = torch.tensor([li["total_area"] for li in sc.lights],
                        dtype=t.dtype, device=t.device)
    return (t * t) / (cos_hit * area[light_ids.clamp_min(0)]).clamp_min(1e-9)


def emitted(sc: Scene, it, face):
    """Radiance leaving a hit emitter toward wo (one-sided)."""
    lid = torch.where(face >= 0, it["light"], -1)
    on = (lid >= 0) & (dot(it["ns"], it["wo"]) > 0.0)
    L = sc.light_L[lid.clamp_min(0)]
    return torch.where(on[:, None], L, torch.zeros_like(L)), lid


def power_heuristic(f, g):
    return (f * f) / (f * f + g * g).clamp_min(1e-30)


def shadow_origin(it, wi, eps):
    return it["p"] + face_forward(it["ng"], wi) * eps[:, None]
