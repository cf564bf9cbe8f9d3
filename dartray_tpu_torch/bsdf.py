"""Branchless vectorized BSDF: a fixed 6-slot lobe stack evaluated for whole
wavefronts (counterpart of the JAX reference's ``bsdf.py``).

Six fixed lobe slots (diffuse/glossy/specular x reflection/transmission)
whose per-ray parameters come from the material system; a slot with zero
weight is inactive. Every lobe's f / pdf / sample is computed for ALL lanes
and combined by masks: lobe choice by ``uc * matchingComps``, pdf averaging
over the matching lobes and the geometric-normal side test are the
reference's.

Slots: 0=DIFF_R (Lambertian / Oren-Nayar, and the measured BRDF lobe),
1=DIFF_T, 2=GLOSS_R (Torrance-Sparrow with the Ashikhmin-Shirley
distribution, or FresnelBlend), 3=GLOSS_T, 4=SPEC_R, 5=SPEC_T.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .core import math as vm
from .core.math import V3
from .core import sampling as smp

INV_PI = float(1.0 / np.pi)

# slot indices
DIFF_R, DIFF_T, GLOSS_R, GLOSS_T, SPEC_R, SPEC_T = range(6)
N_SLOTS = 6

# fresnel modes for glossy/specular reflection
FR_NOOP = 0
FR_DIELECTRIC = 1
FR_CONDUCTOR = 2
FR_BLEND = 3      # FresnelBlend (substrate): glossy slot only

# BxDF flag masks
REFLECTION = 1
TRANSMISSION = 2
DIFFUSE = 4
GLOSSY = 8
SPECULAR = 16
ALL_TYPES = DIFFUSE | GLOSSY | SPECULAR
ALL_REFLECTION = REFLECTION | ALL_TYPES
ALL = REFLECTION | TRANSMISSION | ALL_TYPES

SLOT_FLAGS = (
    REFLECTION | DIFFUSE, TRANSMISSION | DIFFUSE,
    REFLECTION | GLOSSY, TRANSMISSION | GLOSSY,
    REFLECTION | SPECULAR, TRANSMISSION | SPECULAR,
)


class BSDFParams(NamedTuple):
    """Per-ray lobe parameters (outputs of the material/texture system).
    Colors are V3 of (R,) tensors, scalars (R,). Zero weight disables a
    slot."""
    kd: V3                        # DIFF_R weight
    sigma: torch.Tensor           # Oren-Nayar sigma in degrees; 0 = Lambert
    kd_t: V3                      # DIFF_T weight
    ks: V3                        # GLOSS_R weight
    exponent: torch.Tensor        # Blinn / Ashikhmin-Shirley ex
    gloss_fresnel: torch.Tensor   # int32 FR_* for GLOSS_R
    ks_t: V3                      # GLOSS_T weight
    kr: V3                        # SPEC_R weight
    spec_fresnel: torch.Tensor    # int32 FR_* for SPEC_R
    kt: V3                        # SPEC_T weight
    eta: torch.Tensor             # dielectric ior (R,)
    eta_c: V3                     # conductor eta
    k_c: V3                       # conductor k
    # measured BRDF: None, or (idx (R, 4) int32 [pool_off, nThetaH,
    # nThetaD, nPhiD] with off -1 for non-measured rays, pool V3 of (P,)):
    # an extra reflection lobe sampled through the DIFF_R cosine machinery
    meas: tuple = None
    # Ashikhmin-Shirley ey; None or == exponent is isotropic Blinn (the
    # anisotropic formulas reduce to Blinn exactly at ex == ey)
    exponent_v: torch.Tensor = None


def zero_params(r, device=None) -> BSDFParams:
    z3 = vm.v3zeros((r,), device)
    z1 = torch.zeros((r,), dtype=torch.float32, device=device)
    zi = torch.zeros((r,), dtype=torch.int32, device=device)
    one = torch.ones((r,), dtype=torch.float32, device=device)
    return BSDFParams(kd=z3, sigma=z1, kd_t=z3, ks=z3, exponent=one,
                      gloss_fresnel=zi, ks_t=z3, kr=z3, spec_fresnel=zi,
                      kt=z3, eta=one, eta_c=z3, k_c=z3)


class Frame(NamedTuple):
    """Shading frame (s, t, n) per ray plus the geometric normal."""
    s: V3
    t: V3
    n: V3    # shading normal
    ng: V3   # geometric normal

    def to_local(self, w: V3) -> V3:
        return V3(vm.dot(w, self.s), vm.dot(w, self.t), vm.dot(w, self.n))

    def to_world(self, w: V3) -> V3:
        return self.s * w.x + self.t * w.y + self.n * w.z


def make_frame(ns: V3, dpdu: V3, ng: V3) -> Frame:
    s = vm.normalize(dpdu - ns * vm.dot(ns, dpdu))
    degen = vm.length_sq(s) < 1e-12
    s_fb, _ = vm.coordinate_system(ns)
    s = vm.where3(degen, s_fb, s)
    t = vm.cross(ns, s)
    return Frame(s=s, t=t, n=ns, ng=ng)


def cos_theta(w: V3):
    return w.z


def abs_cos_theta(w: V3):
    return torch.abs(w.z)


def same_hemisphere(w: V3, wp: V3):
    return w.z * wp.z > 0.0


def _flip_z(w: V3) -> V3:
    return V3(w.x, w.y, -w.z)


# --- Fresnel -----------------------------------------------------------------

def fr_dielectric(cos_i, eta):
    """Unpolarized dielectric Fresnel; handles both sides. cos_i signed.
    Returns (R,) reflectance in [0, 1]."""
    entering = cos_i > 0.0
    ei = torch.where(entering, 1.0, eta)
    et = torch.where(entering, eta, 1.0)
    ci = torch.abs(cos_i.clamp(-1.0, 1.0))
    sint = ei / et * torch.sqrt((1.0 - ci * ci).clamp_min(0.0))
    tir = sint >= 1.0
    ct = torch.sqrt((1.0 - sint * sint).clamp_min(0.0))
    r_parl = (et * ci - ei * ct) / (et * ci + ei * ct).clamp_min(1e-12)
    r_perp = (ei * ci - et * ct) / (ei * ci + et * ct).clamp_min(1e-12)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, f)


def fr_conductor(cos_i, eta: V3, k: V3) -> V3:
    """Conductor Fresnel, |cos_i|; eta / k V3."""
    ci = torch.abs(cos_i)
    ci2 = ci * ci

    def chan(e, kk):
        tmp = (e * e + kk * kk) * ci2
        r_parl2 = ((tmp - 2.0 * e * ci + 1.0)
                   / (tmp + 2.0 * e * ci + 1.0).clamp_min(1e-12))
        tmp_f = e * e + kk * kk
        r_perp2 = ((tmp_f - 2.0 * e * ci + ci2)
                   / (tmp_f + 2.0 * e * ci + ci2).clamp_min(1e-12))
        return 0.5 * (r_parl2 + r_perp2)

    return V3(chan(eta.x, k.x), chan(eta.y, k.y), chan(eta.z, k.z))


def schlick(cos_i, rs: V3) -> V3:
    """Schlick's Fresnel approximation (FresnelBlend's specular term)."""
    c = (1.0 - torch.abs(cos_i)).clamp(0.0, 1.0)
    c5 = c * c * c * c * c
    return rs + (1.0 - rs) * c5


def _glossy_fresnel(p: BSDFParams, cos_h) -> V3:
    """F at the half-angle for the glossy slot, per mode (V3)."""
    fd = fr_dielectric(cos_h, p.eta)
    fd3 = V3(fd, fd, fd)
    fc = fr_conductor(cos_h, p.eta_c, p.k_c)
    m = p.gloss_fresnel
    return vm.where3(m == FR_DIELECTRIC, fd3,
                     vm.where3(m == FR_CONDUCTOR, fc, 1.0))


# --- lobe evaluation (all directions in shading-local space) -----------------

def _oren_nayar_ab(sigma_deg):
    s = torch.deg2rad(sigma_deg)
    s2 = s * s
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    return a, b


def _diff_f(kd: V3, sigma, wo: V3, wi: V3) -> V3:
    """Lambertian or Oren-Nayar."""
    a, b = _oren_nayar_ab(sigma)
    sinto = torch.sqrt((1.0 - wo.z * wo.z).clamp_min(0.0))
    sinti = torch.sqrt((1.0 - wi.z * wi.z).clamp_min(0.0))
    # cos(phi_i - phi_o)
    denom = (sinti * sinto).clamp_min(1e-8)
    dcos = (wi.x * wo.x + wi.y * wo.y) / denom
    maxcos = torch.where((sinti > 1e-4) & (sinto > 1e-4),
                         dcos.clamp_min(0.0), 0.0)
    sinalpha = torch.maximum(sinti, sinto)
    tanbeta = torch.minimum(sinti, sinto) / torch.minimum(
        abs_cos_theta(wi), abs_cos_theta(wo)).clamp_min(1e-8)
    on = a + b * maxcos * sinalpha * tanbeta
    on = torch.where(sigma > 0.0, on, 1.0)
    return kd * (INV_PI * on)


def _ey(p: BSDFParams):
    return p.exponent if p.exponent_v is None else p.exponent_v


def _aniso_d(ex, ey, wh: V3):
    """Ashikhmin-Shirley anisotropic D; equals Blinn's D at ex == ey."""
    costh = torch.abs(wh.z)
    ds = (1.0 - costh * costh).clamp_min(1e-12)
    e = (ex * wh.x * wh.x + ey * wh.y * wh.y) / ds
    return (torch.sqrt(((ex + 2.0) * (ey + 2.0)).clamp_min(0.0))
            * (0.5 * INV_PI) * torch.pow(costh.clamp_min(1e-8), e))


def _ts_g(wo: V3, wi: V3, wh: V3):
    """Torrance-Sparrow geometric term."""
    ndoth = abs_cos_theta(wh)
    ndoto = abs_cos_theta(wo)
    ndoti = abs_cos_theta(wi)
    odoth = torch.abs(vm.dot(wo, wh)).clamp_min(1e-8)
    return torch.minimum(2.0 * ndoth * ndoto / odoth,
                         2.0 * ndoth * ndoti / odoth).clamp_max(1.0)


def _gloss_f(p: BSDFParams, ks: V3, wo: V3, wi: V3) -> V3:
    """Microfacet Torrance-Sparrow, or FresnelBlend (Rd = kd, Rs = ks). Glossy
    transmission calls this with wi flipped (BRDF to BTDF)."""
    wh = wi + wo
    wh_len = torch.sqrt(vm.length_sq(wh).clamp_min(1e-12))
    wh = wh * (1.0 / wh_len)
    wh = vm.where3(wh.z < 0, -wh, wh)
    cos_o = abs_cos_theta(wo)
    cos_i = abs_cos_theta(wi)
    d = _aniso_d(p.exponent, _ey(p), wh)
    g = _ts_g(wo, wi, wh)
    f_h = _glossy_fresnel(p, vm.dot(wi, wh))
    micro = ks * f_h * (d * g / (4.0 * cos_i * cos_o).clamp_min(1e-8))
    # FresnelBlend: diffuse term + specular term
    pow5 = lambda x: x * x * x * x * x
    diff = p.kd * (1.0 - p.ks) * (
        (28.0 / (23.0 * np.pi))
        * (1.0 - pow5(1.0 - 0.5 * cos_i))
        * (1.0 - pow5(1.0 - 0.5 * cos_o)))
    spec_blend = schlick(vm.dot(wi, wh), p.ks) * (d / (
        4.0 * torch.abs(vm.dot(wi, wh)) * torch.maximum(cos_i, cos_o)
    ).clamp_min(1e-8))
    blend = diff + spec_blend
    return vm.where3(p.gloss_fresnel == FR_BLEND, blend, micro)


def _aniso_sample_wh(ex, ey, u) -> V3:
    """Anisotropic half-vector sampling: the first-quadrant sample mirrored
    into the quadrant u1 picks; uniform-phi Blinn sampling at ex == ey."""
    u1, u2 = u.x, u.y
    q = (u1 * 4.0).to(torch.int32).clamp_max(3)
    u1q = (u1 * 4.0 - q.to(torch.float32)).clamp(0.0, 1.0 - 1e-7)
    phi_q = torch.atan(torch.sqrt((ex + 1.0) / (ey + 1.0))
                       * torch.tan(0.5 * np.pi * u1q))
    cph = torch.cos(phi_q)
    sph = torch.sin(phi_q)
    ct = torch.pow(u2.clamp_min(1e-9),
                   1.0 / (ex * cph * cph + ey * sph * sph + 1.0))
    phi = torch.where(q == 0, phi_q,
                      torch.where(q == 1, np.pi - phi_q,
                                  torch.where(q == 2, np.pi + phi_q,
                                              2.0 * np.pi - phi_q)))
    st = torch.sqrt((1.0 - ct * ct).clamp_min(0.0))
    return V3(st * torch.cos(phi), st * torch.sin(phi), ct)


def _aniso_pdf(ex, ey, wo: V3, wi: V3):
    """pdf of ``_aniso_sample_wh`` mapped to wi; the Blinn pdf at
    ex == ey."""
    wh = vm.normalize(wo + wi)
    costh = abs_cos_theta(wh)
    ds = (1.0 - costh * costh).clamp_min(1e-12)
    e = (ex * wh.x * wh.x + ey * wh.y * wh.y) / ds
    d = (torch.sqrt(((ex + 1.0) * (ey + 1.0)).clamp_min(0.0))
         * (0.5 * INV_PI) * torch.pow(costh.clamp_min(1e-8), e))
    wodoth = torch.abs(vm.dot(wo, wh))
    pdf_h = d / (4.0 * wodoth).clamp_min(1e-8)
    return torch.where(same_hemisphere(wo, wi), pdf_h, 0.0)


def refract(wo: V3, eta):
    """Specular transmission direction in the local frame.
    Returns (wi, valid, ei, et)."""
    entering = cos_theta(wo) > 0.0
    ei = torch.where(entering, 1.0, eta)
    et = torch.where(entering, eta, 1.0)
    sini2 = (1.0 - cos_theta(wo) ** 2).clamp_min(0.0)
    eta_r = ei / et
    sint2 = eta_r * eta_r * sini2
    valid = sint2 < 1.0
    cost = torch.sqrt((1.0 - sint2).clamp_min(0.0))
    cost = torch.where(entering, -cost, cost)
    wi = V3(-eta_r * wo.x, -eta_r * wo.y, cost)
    return wi, valid, ei, et


# --- the combined BSDF -------------------------------------------------------

def _slot_weights(p: BSDFParams):
    return (p.kd, p.kd_t, p.ks, p.ks_t, p.kr, p.kt)


def _nonzero3(w: V3):
    return (w.x != 0.0) | (w.y != 0.0) | (w.z != 0.0)


def _slot_active(p: BSDFParams, flags: int):
    """6 (R,) bools: the slot has weight and matches the requested flags."""
    act = []
    for s, w in enumerate(_slot_weights(p)):
        fl = SLOT_FLAGS[s]
        if (fl & flags) != fl:
            act.append(torch.zeros_like(w.x, dtype=torch.bool))
            continue
        has_w = _nonzero3(w)
        # substrate uses kd in the glossy slot with ks possibly dark
        if s == GLOSS_R:
            has_w = has_w | ((p.gloss_fresnel == FR_BLEND) & _nonzero3(p.kd))
        # the measured BRDF rides the DIFF_R slot's cosine sampling and pdf
        if s == DIFF_R and p.meas is not None:
            has_w = has_w | (p.meas[0][:, 0] >= 0)
        act.append(has_w)
    return act


def n_specular_components(p: BSDFParams):
    """(R,) int32 count of the active specular components (used by the
    Metropolis bidirectional connection weights)."""
    act = _slot_active(p, ALL)
    return act[SPEC_R].to(torch.int32) + act[SPEC_T].to(torch.int32)


def measured_f(meas, wo: V3, wi: V3) -> V3:
    """Regular half-angle BRDF: map LOCAL (wo, wi) to the half / difference
    angle table index and gather the RGB value."""
    idx, pool = meas
    wh = wo + wi
    flip = wh.z < 0.0
    wo = vm.where3(flip, -wo, wo)
    wi = vm.where3(flip, -wi, wi)
    wh = vm.where3(flip, -wh, wh)
    ok = vm.length_sq(wh) > 1e-12
    wh = wh * (1.0 / vm.length(wh).clamp_min(1e-12))
    cth = wh.z.clamp(-1.0, 1.0)
    sth = torch.sqrt((1.0 - cth * cth).clamp_min(0.0))
    inv_s = 1.0 / sth.clamp_min(1e-9)
    cph = torch.where(sth < 1e-9, 1.0, wh.x * inv_s)
    sph = torch.where(sth < 1e-9, 0.0, wh.y * inv_s)
    whx = V3(cph * cth, sph * cth, -sth)
    why = V3(-sph, cph, torch.zeros_like(sph))
    wd = V3(vm.dot(wi, whx), vm.dot(wi, why), vm.dot(wi, wh))
    wd_theta = torch.arccos(wd.z.clamp(-1.0, 1.0))
    wd_phi = torch.atan2(wd.y, wd.x)
    wd_phi = torch.where(wd_phi < 0, wd_phi + 2 * np.pi, wd_phi)
    wd_phi = torch.where(wd_phi > np.pi, wd_phi - np.pi, wd_phi)
    wh_theta = torch.arccos(cth)
    nth = idx[:, 1]
    ntd = idx[:, 2]
    npd = idx[:, 3]

    def remap(v, vmax, count):
        # float -> int32 truncates toward zero, as the reference's astype
        i = (v / vmax * count.to(torch.float32)).to(torch.int32)
        return torch.minimum(i.clamp_min(0), (count - 1).clamp_min(0))

    i_h = remap(torch.sqrt((wh_theta / (np.pi / 2)).clamp_min(0.0)), 1.0,
                nth)
    i_d = remap(wd_theta, np.pi / 2, ntd)
    i_p = remap(wd_phi, np.pi, npd)
    flat = idx[:, 0] + i_p + npd * (i_d + i_h * ntd)       # int32
    g = flat.clamp_min(0).long()
    val = V3(pool.x[g], pool.y[g], pool.z[g])
    return vm.where3(ok & (idx[:, 0] >= 0), val, 0.0)


def f(p: BSDFParams, frame: Frame, wo_w: V3, wi_w: V3, flags: int = ALL) -> V3:
    """BSDF value, non-specular lobes only. The side test uses the GEOMETRIC
    normal."""
    wo = frame.to_local(wo_w)
    wi = frame.to_local(wi_w)
    reflect = (vm.dot(wi_w, frame.ng) * vm.dot(wo_w, frame.ng)) > 0.0
    out = vm.v3zeros(wo.z.shape, wo.z.device)
    act = _slot_active(p, flags)

    def eff_match(fl):
        # flags with TRANSMISSION/REFLECTION stripped by the geometric side
        m_refl = (fl & (flags & ~TRANSMISSION)) == fl
        m_trans = (fl & (flags & ~REFLECTION)) == fl
        return torch.where(reflect, m_refl, m_trans)

    # diffuse reflection
    m = act[DIFF_R] & eff_match(SLOT_FLAGS[DIFF_R]) & same_hemisphere(wo, wi)
    out = out + vm.where3(m, _diff_f(p.kd, p.sigma, wo, wi), 0.0)
    if p.meas is not None:   # the measured lobe (the same mask family)
        mm = m & (p.meas[0][:, 0] >= 0)
        out = out + vm.where3(mm, measured_f(p.meas, wo, wi), 0.0)
    # diffuse transmission (BRDF to BTDF: evaluated with wi flipped)
    wif = _flip_z(wi)
    m = act[DIFF_T] & eff_match(SLOT_FLAGS[DIFF_T]) & same_hemisphere(wo, wif)
    out = out + vm.where3(m, _diff_f(p.kd_t, p.sigma, wo, wif), 0.0)
    # glossy reflection
    m = act[GLOSS_R] & eff_match(SLOT_FLAGS[GLOSS_R]) & same_hemisphere(wo, wi)
    out = out + vm.where3(m, _gloss_f(p, p.ks, wo, wi), 0.0)
    # glossy transmission
    m = (act[GLOSS_T] & eff_match(SLOT_FLAGS[GLOSS_T])
         & same_hemisphere(wo, wif))
    out = out + vm.where3(m, _gloss_f(p, p.ks_t, wo, wif), 0.0)
    return out


def pdf(p: BSDFParams, frame: Frame, wo_w: V3, wi_w: V3, flags: int = ALL):
    """Average pdf over the matching lobes (specular lobes contribute 0 but
    count in the average)."""
    wo = frame.to_local(wo_w)
    wi = frame.to_local(wi_w)
    act = _slot_active(p, flags)
    n_match = sum(a.to(torch.float32) for a in act)
    # diffuse lobes: cosine-hemisphere pdf on their side
    pd = smp.cosine_hemisphere_pdf(abs_cos_theta(wi))
    total = torch.where(act[DIFF_R] & same_hemisphere(wo, wi), pd, 0.0)
    total = total + torch.where(act[DIFF_T] & ~same_hemisphere(wo, wi), pd,
                                0.0)
    pg = _aniso_pdf(p.exponent, _ey(p), wo, wi)
    total = total + torch.where(act[GLOSS_R], pg, 0.0)
    pgt = _aniso_pdf(p.exponent, _ey(p), wo, _flip_z(wi))
    total = total + torch.where(act[GLOSS_T], pgt, 0.0)
    return total / n_match.clamp_min(1.0)


class BSDFSample(NamedTuple):
    wi: V3                  # world-space sampled direction
    f: V3                   # BSDF value (NOT divided by pdf)
    pdf: torch.Tensor       # (R,)
    flags: torch.Tensor     # (R,) int32 sampled-lobe flags
    valid: torch.Tensor     # (R,) bool


def sample_f(p: BSDFParams, frame: Frame, wo_w: V3, u2, uc,
             flags: int = ALL) -> BSDFSample:
    """Sample the stack: lobe chosen by uc * matchingComps; pdf averaged over
    the matching lobes (specular excluded from the others' pdf); for a
    non-specular choice f is re-evaluated over all matching lobes with the
    geometric side test."""
    u2 = vm.from_arr2(u2)
    wo = frame.to_local(wo_w)
    act = _slot_active(p, flags)
    n_match = sum(a.to(torch.int32) for a in act)                # (R,)
    which = torch.minimum((uc * n_match.to(torch.float32)).to(torch.int32),
                          (n_match - 1).clamp_min(0))
    # chosen[r] = s where act[s] and (# active below s) == which
    cum = torch.zeros_like(n_match)
    chosen = torch.zeros_like(n_match)
    found = torch.zeros_like(n_match, dtype=torch.bool)
    for s in range(N_SLOTS):
        a = act[s]
        hit = a & (cum == which) & ~found
        chosen = torch.where(hit, s, chosen)
        found = found | hit
        cum = cum + a.to(torch.int32)

    # candidate wi per slot family
    wi_dr = smp.cosine_sample_hemisphere(u2)
    wi_dr = vm.where3(wo.z < 0, _flip_z(wi_dr), wi_dr)
    wi_dt = _flip_z(wi_dr)
    wh = _aniso_sample_wh(p.exponent, _ey(p), u2)
    wh = vm.where3(wo.z < 0, _flip_z(wh), wh)
    wi_gr = -wo + wh * (2.0 * vm.dot(wo, wh))
    wi_gt = _flip_z(wi_gr)
    wi_sr = V3(-wo.x, -wo.y, wo.z)
    wi_st, st_valid, ei, et = refract(wo, p.eta)

    wi = vm.where3(chosen == DIFF_R, wi_dr,
         vm.where3(chosen == DIFF_T, wi_dt,
         vm.where3(chosen == GLOSS_R, wi_gr,
         vm.where3(chosen == GLOSS_T, wi_gt,
         vm.where3(chosen == SPEC_R, wi_sr, wi_st)))))
    is_spec = (chosen == SPEC_R) | (chosen == SPEC_T)
    wi_w = frame.to_world(wi)

    # specular f/pdf (delta): f/|cos|, pdf = 1 (per chosen lobe)
    acx = abs_cos_theta(wi).clamp_min(1e-8)
    fr_d = fr_dielectric(cos_theta(wo), p.eta)
    fr_d3 = V3(fr_d, fr_d, fr_d)
    fr_c = fr_conductor(cos_theta(wo), p.eta_c, p.k_c)
    fr_sel = vm.where3(p.spec_fresnel == FR_DIELECTRIC, fr_d3,
                       vm.where3(p.spec_fresnel == FR_CONDUCTOR, fr_c, 1.0))
    inv_acx = 1.0 / acx
    f_sr = p.kr * fr_sel * inv_acx
    # transmission: (1-F) * kt * (ei^2/et^2) / |cos|
    f_st = p.kt * ((1.0 - fr_d) * (ei * ei) / (et * et) * inv_acx)
    f_st = vm.where3(st_valid, f_st, 0.0)
    f_spec = vm.where3(chosen == SPEC_R, f_sr, f_st)

    # non-specular combined f and averaged pdf
    f_ns = f(p, frame, wo_w, wi_w, flags)
    pdf_ns = pdf(p, frame, wo_w, wi_w, flags)

    out_f = vm.where3(is_spec, f_spec, f_ns)
    out_pdf = torch.where(is_spec,
                          1.0 / n_match.to(torch.float32).clamp_min(1.0),
                          pdf_ns)
    valid = ((n_match > 0) & (out_pdf > 0.0)
             & torch.where(chosen == SPEC_T, st_valid, True))
    slot_flags = torch.tensor(SLOT_FLAGS, dtype=torch.int32,
                              device=chosen.device)[chosen.long()]
    return BSDFSample(wi=wi_w, f=out_f, pdf=out_pdf, flags=slot_flags,
                      valid=valid)


def slot_count(p: BSDFParams, flags: int = ALL):
    return sum(a.to(torch.int32) for a in _slot_active(p, flags))


def cat_lanes(xs):
    """Lane-major values of one kind (tensors, V3s, Frames or BSDFParams)
    joined along their lanes, in order: one evaluation then serves them
    all. A measured BRDF's pool is shared by every lane, not joined."""
    x0 = xs[0]
    if x0 is None:
        return None
    if isinstance(x0, BSDFParams):
        fields = {k: cat_lanes([getattr(x, k) for x in xs])
                  for k in x0._fields if k != "meas"}
        meas = None if x0.meas is None else (
            torch.cat([x.meas[0] for x in xs]), x0.meas[1])
        return BSDFParams(meas=meas, **fields)
    if isinstance(x0, (V3, Frame)):
        return type(x0)(*(cat_lanes(list(c)) for c in zip(*xs)))
    return torch.cat(xs)
