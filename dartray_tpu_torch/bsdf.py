"""Branchless vectorized BSDF: fixed lobe slots evaluated for whole
wavefronts (counterpart of the JAX reference's ``bsdf.py``).

The reference stacks six fixed lobe slots (diffuse/glossy/specular x
reflection/transmission) whose per-ray parameters come from the material
system; a slot with zero weight is inactive. This slice ports the slots that
matte, mirror and glass materials use:

  DIFF_R  Lambertian / Oren-Nayar reflection
  SPEC_R  perfect specular reflection (no-op or dielectric Fresnel)
  SPEC_T  perfect specular transmission (dielectric Fresnel, ``refract``)

Slot numbers, flag masks, lobe choice by ``uc * matchingComps``, pdf
averaging over the matching lobes and the geometric-normal side test are the
reference's. The diffuse-transmission and glossy slots, the conductor and
Fresnel-blend modes, the anisotropic distribution and measured BRDFs are not
ported: ``materials.build_table`` raises ``NotImplementedError`` for a
material that needs them (ROADMAP Queue 1, remaining BSDF lobes).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .core import math as vm
from .core.math import V3
from .core import sampling as smp

INV_PI = float(1.0 / np.pi)

# slot indices (the reference's numbering; 1-3 are the slots not ported)
DIFF_R, DIFF_T, GLOSS_R, GLOSS_T, SPEC_R, SPEC_T = range(6)
PORTED_SLOTS = (DIFF_R, SPEC_R, SPEC_T)

# fresnel modes for specular reflection
FR_NOOP = 0
FR_DIELECTRIC = 1
FR_CONDUCTOR = 2      # not ported
FR_BLEND = 3          # not ported

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
    kd: V3                       # DIFF_R weight
    sigma: torch.Tensor          # Oren-Nayar sigma in degrees; 0 = Lambert
    kr: V3                       # SPEC_R weight
    spec_fresnel: torch.Tensor   # int32 FR_* for SPEC_R
    kt: V3                       # SPEC_T weight
    eta: torch.Tensor            # dielectric ior (R,)


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


def _slot_weights(p: BSDFParams):
    return {DIFF_R: p.kd, SPEC_R: p.kr, SPEC_T: p.kt}


def _slot_active(p: BSDFParams, flags: int):
    """{slot: (R,) bool}: slot has weight and matches the requested flags."""
    act = {}
    for s, w in _slot_weights(p).items():
        fl = SLOT_FLAGS[s]
        if (fl & flags) == fl:
            act[s] = (w.x != 0.0) | (w.y != 0.0) | (w.z != 0.0)
        else:
            act[s] = torch.zeros_like(w.x, dtype=torch.bool)
    return act


def f(p: BSDFParams, frame: Frame, wo_w: V3, wi_w: V3, flags: int = ALL) -> V3:
    """BSDF value, non-specular lobes only. The side test uses the GEOMETRIC
    normal."""
    wo = frame.to_local(wo_w)
    wi = frame.to_local(wi_w)
    reflect = (vm.dot(wi_w, frame.ng) * vm.dot(wo_w, frame.ng)) > 0.0
    act = _slot_active(p, flags)
    fl = SLOT_FLAGS[DIFF_R]
    # flags with TRANSMISSION/REFLECTION stripped by the geometric side
    m_refl = (fl & (flags & ~TRANSMISSION)) == fl
    m_trans = (fl & (flags & ~REFLECTION)) == fl
    eff = torch.where(reflect, m_refl, m_trans)
    m = act[DIFF_R] & eff & same_hemisphere(wo, wi)
    return vm.where3(m, _diff_f(p.kd, p.sigma, wo, wi), 0.0)


def pdf(p: BSDFParams, frame: Frame, wo_w: V3, wi_w: V3, flags: int = ALL):
    """Average pdf over matching lobes (specular lobes contribute 0 but
    count in the average)."""
    wo = frame.to_local(wo_w)
    wi = frame.to_local(wi_w)
    act = _slot_active(p, flags)
    n_match = sum(a.to(torch.float32) for a in act.values())
    pd = smp.cosine_hemisphere_pdf(abs_cos_theta(wi))
    total = torch.where(act[DIFF_R] & same_hemisphere(wo, wi), pd, 0.0)
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
    n_match = sum(a.to(torch.int32) for a in act.values())      # (R,)
    which = torch.minimum((uc * n_match.to(torch.float32)).to(torch.int32),
                          (n_match - 1).clamp_min(0))
    # chosen[r] = s where act[s] and (# active below s) == which
    cum = torch.zeros_like(n_match)
    chosen = torch.zeros_like(n_match)
    found = torch.zeros_like(n_match, dtype=torch.bool)
    for s in PORTED_SLOTS:
        a = act[s]
        hit = a & (cum == which) & ~found
        chosen = torch.where(hit, s, chosen)
        found = found | hit
        cum = cum + a.to(torch.int32)

    wi_dr = smp.cosine_sample_hemisphere(u2)
    wi_dr = vm.where3(wo.z < 0, _flip_z(wi_dr), wi_dr)
    wi_sr = V3(-wo.x, -wo.y, wo.z)
    wi_st, st_valid, ei, et = refract(wo, p.eta)
    wi = vm.where3(chosen == DIFF_R, wi_dr,
                   vm.where3(chosen == SPEC_R, wi_sr, wi_st))
    is_spec = (chosen == SPEC_R) | (chosen == SPEC_T)
    wi_w = frame.to_world(wi)

    # specular f/pdf (delta): f/|cos|, pdf = 1 (per chosen lobe)
    acx = abs_cos_theta(wi).clamp_min(1e-8)
    fr_d = fr_dielectric(cos_theta(wo), p.eta)
    fr_sel = torch.where(p.spec_fresnel == FR_DIELECTRIC, fr_d, 1.0)
    inv_acx = 1.0 / acx
    f_sr = p.kr * fr_sel * inv_acx
    # transmission: (1-F) * kt * (ei^2/et^2) / |cos|
    f_st = p.kt * ((1.0 - fr_d) * (ei * ei) / (et * et) * inv_acx)
    f_st = vm.where3(st_valid, f_st, 0.0)
    f_spec = vm.where3(chosen == SPEC_R, f_sr, f_st)

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
