"""Material table: every material compiled to per-lobe parameter rows
(counterpart of the JAX reference's ``materials.py``).

Each material is one row of the 6-slot ``BSDFParams`` layout of ``bsdf.py``
and a wavefront's parameters are one row gather. Texture-driven parameters
override the constant rows through the texture system (``textures.py``):
each parameter slot can carry a texture id (-1 = the constant row value).
Measured BRDF tables live in one pool beside the rows.

Ported: matte, plastic, mirror, glass, metal, shinymetal, substrate,
translucent, uber, mix, measured, subsurface and kdsubsurface, every texture
slot, and bump maps. An
opacity texture id is kept in its slot and, as in the reference, never read:
a row renders with its constant opacity, which ``uber`` bakes into its
transmission. A subsurface row is a plastic row with its medium under
``_sss``, side-channel data the table skips (the dipole integrator reads it
from the job).

Conductor spectra: the RGB-projected copper eta / k are the default of both
metal and shinymetal.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from . import bsdf
from .bsdf import FR_NOOP, FR_DIELECTRIC, FR_CONDUCTOR, FR_BLEND
from .core import math as vm
from .core.math import V3

# RGB-projected copper eta/k (the default conductor spectra)
COPPER_ETA = (0.2004, 0.9240, 1.1022)
COPPER_K = (3.9129, 2.4528, 2.1421)

# texture-slot indices into tex_ids rows (textures overriding params)
TEX_KD, TEX_KS, TEX_KR, TEX_KT, TEX_SIGMA, TEX_ROUGH, TEX_OPACITY, TEX_BUMP \
    = range(8)
N_TEX_SLOTS = 8


@dataclasses.dataclass
class MaterialTable:
    kd: Any             # (M, 3)
    sigma: Any          # (M,)
    kd_t: Any           # (M, 3)
    ks: Any             # (M, 3)
    exponent: Any       # (M,) Blinn / Ashikhmin-Shirley ex
    exponent_v: Any     # (M,) Ashikhmin-Shirley ey (== ex: isotropic)
    gloss_fresnel: Any  # (M,) int32
    ks_t: Any           # (M, 3)
    kr: Any             # (M, 3)
    spec_fresnel: Any   # (M,) int32
    kt: Any             # (M, 3)
    eta: Any            # (M,)
    eta_c: Any          # (M, 3)
    k_c: Any            # (M, 3)
    opacity: Any        # (M, 3)
    tex_ids: Any        # (M, N_TEX_SLOTS) int32, -1 = constant
    meas_meta: Any      # (M, 4) int32 [pool_off|-1, nThH, nThD, nPhD]
    meas_pool: Any      # (P, 3) f32 concatenated half-angle tables
    n: int = 0
    used_tex_slots: tuple = ()  # slots any material textures
    has_measured: bool = False  # gates the measured lobe


def _row(kd=(0, 0, 0), sigma=0.0, kd_t=(0, 0, 0), ks=(0, 0, 0),
         roughness=0.1, gloss_fresnel=FR_DIELECTRIC, ks_t=(0, 0, 0),
         kr=(0, 0, 0), spec_fresnel=FR_NOOP, kt=(0, 0, 0), eta=1.5,
         eta_c=COPPER_ETA, k_c=COPPER_K, opacity=(1, 1, 1), tex_ids=None,
         vroughness=None):
    exponent = 1.0 / max(float(roughness), 1e-4)  # rough -> Blinn exponent
    exponent_v = exponent if vroughness is None \
        else 1.0 / max(float(vroughness), 1e-4)
    t = np.full(N_TEX_SLOTS, -1, np.int32)
    if tex_ids:
        for k, v in tex_ids.items():
            t[k] = v
    return dict(kd=kd, sigma=sigma, kd_t=kd_t, ks=ks, exponent=exponent,
                exponent_v=exponent_v,
                gloss_fresnel=gloss_fresnel, ks_t=ks_t, kr=kr,
                spec_fresnel=spec_fresnel, kt=kt, eta=eta, eta_c=eta_c,
                k_c=k_c, opacity=opacity, tex_ids=t)


# --- builders (defaults are the reference's) ---------------------------------

def matte(kd=(0.5, 0.5, 0.5), sigma=0.0, **tex):
    """Lambertian (sigma 0) or Oren-Nayar diffuse reflection."""
    return _row(kd=kd, sigma=sigma, **tex)


def plastic(kd=(0.25,) * 3, ks=(0.25,) * 3, roughness=0.1, **tex):
    """Lambertian + Blinn microfacet with dielectric Fresnel (eta 1.5)."""
    return _row(kd=kd, ks=ks, roughness=roughness,
                gloss_fresnel=FR_DIELECTRIC, eta=1.5, **tex)


def mirror(kr=(0.9,) * 3, **tex):
    """Specular reflection, no-op Fresnel."""
    return _row(kr=kr, spec_fresnel=FR_NOOP, **tex)


def glass(kr=(1.0,) * 3, kt=(1.0,) * 3, index=1.5, **tex):
    """Fresnel-weighted specular reflection + transmission."""
    return _row(kr=kr, kt=kt, eta=index, spec_fresnel=FR_DIELECTRIC, **tex)


def metal(eta=COPPER_ETA, k=COPPER_K, roughness=0.01, **tex):
    """Conductor Blinn microfacet."""
    return _row(ks=(1.0,) * 3, roughness=roughness,
                gloss_fresnel=FR_CONDUCTOR, eta_c=eta, k_c=k, **tex)


def shinymetal(ks=(1.0,) * 3, kr=(1.0,) * 3, roughness=0.1, **tex):
    """Glossy + perfect specular reflection, both with the conductor
    Fresnel of the copper defaults (known behaviour j)."""
    return _row(ks=ks, kr=kr, roughness=roughness,
                gloss_fresnel=FR_CONDUCTOR,
                spec_fresnel=FR_CONDUCTOR, **tex)


def substrate(kd=(0.5,) * 3, ks=(0.5,) * 3, roughness=0.1, **tex):
    """FresnelBlend (Ashikhmin-Shirley). Pass vroughness for the anisotropic
    distribution; roughness then acts as uroughness. The row's kd also
    activates the diffuse slot (known behaviour i)."""
    return _row(kd=kd, ks=ks, roughness=roughness, gloss_fresnel=FR_BLEND,
                **tex)


def translucent(kd=(0.25,) * 3, ks=(0.25,) * 3, roughness=0.1,
                reflect=(0.5,) * 3, transmit=(0.5,) * 3, **tex):
    """Reflect/transmit-weighted diffuse + glossy lobes on both sides."""
    r = np.asarray(reflect)
    t = np.asarray(transmit)
    return _row(kd=tuple(np.asarray(kd) * r), kd_t=tuple(np.asarray(kd) * t),
                ks=tuple(np.asarray(ks) * r), ks_t=tuple(np.asarray(ks) * t),
                roughness=roughness, eta=1.5, **tex)


def uber(kd=(0.25,) * 3, ks=(0.25,) * 3, kr=(0.0,) * 3, kt=(0.0,) * 3,
         roughness=0.1, index=1.5, opacity=(1.0,) * 3, **tex):
    """Diffuse + glossy + specular; opacity < 1 adds pass-through
    transmission."""
    op = np.asarray(opacity, np.float64)
    row = _row(kd=tuple(np.asarray(kd) * op), ks=tuple(np.asarray(ks) * op),
               kr=tuple(np.asarray(kr) * op), roughness=roughness, eta=index,
               spec_fresnel=FR_DIELECTRIC, opacity=tuple(op), **tex)
    # opacity pass-through: (1-opacity) specular transmission with eta 1
    kt_eff = np.asarray(kt, np.float64) * op + (1.0 - op)
    if (1.0 - op).max() > 0:
        row["kt"] = tuple(kt_eff)
        row["eta"] = 1.0 if (np.asarray(kt) == 0).all() else index
    elif np.asarray(kt).max() > 0:
        row["kt"] = tuple(np.asarray(kt) * op)
    return row


def mix_materials(m1: dict, m2: dict, amount=(0.5,) * 3):
    """A parameter blend of two rows (known behaviour d): colors lerped by
    amount, scalars by its mean; the Fresnel modes by ``amount.mean() >=
    0.5`` and the texture ids of the first material."""
    a = np.asarray(amount, np.float64)
    out = {}
    for key in m1:
        if key.startswith("_"):   # measured / subsurface side-channel data
            out[key] = m1[key]
            continue
        v1 = np.asarray(m1[key], np.float64)
        v2 = np.asarray(m2[key], np.float64)
        if key in ("gloss_fresnel", "spec_fresnel"):
            out[key] = int(m1[key]) if a.mean() >= 0.5 else int(m2[key])
        elif key == "tex_ids":
            out[key] = m1[key]
        elif v1.shape == (3,):
            out[key] = tuple(v1 * a + v2 * (1.0 - a))
        else:
            out[key] = float(v1 * a.mean() + v2 * (1.0 - a.mean()))
    return out


def measured(data: np.ndarray, key: str = "", **tex):
    """Regular half-angle BRDF table (from ``io.merl.load``). data:
    (nThetaH, nThetaD, nPhiD, 3). `key` (the file name) deduplicates tables
    in the pool."""
    row = _row(tex_ids=tex.get("tex_ids"))
    row["_meas_data"] = np.asarray(data, np.float32)
    row["_meas_key"] = key
    return row


def build_table(rows: List[dict]) -> MaterialTable:
    if not rows:
        rows = [matte()]

    def col(k, dt=np.float32):
        return np.asarray([r[k] for r in rows], dt)

    pool = []
    pool_len = 0
    meta = np.full((len(rows), 4), -1, np.int32)
    seen = {}
    for i, r in enumerate(rows):
        d = r.get("_meas_data")
        if d is None:
            continue
        key = r.get("_meas_key") or id(d)
        if key in seen:
            meta[i] = seen[key]
            continue
        nth, ntd, npd = d.shape[0], d.shape[1], d.shape[2]
        meta[i] = (pool_len, nth, ntd, npd)
        seen[key] = meta[i]
        pool.append(d.reshape(-1, 3))
        pool_len += nth * ntd * npd
    meas_pool = (np.concatenate(pool) if pool
                 else np.zeros((1, 3), np.float32))
    return MaterialTable(
        kd=col("kd"), sigma=col("sigma"), kd_t=col("kd_t"), ks=col("ks"),
        exponent=col("exponent"), exponent_v=col("exponent_v"),
        gloss_fresnel=col("gloss_fresnel", np.int32), ks_t=col("ks_t"),
        kr=col("kr"), spec_fresnel=col("spec_fresnel", np.int32),
        kt=col("kt"), eta=col("eta"), eta_c=col("eta_c"), k_c=col("k_c"),
        opacity=col("opacity"), tex_ids=col("tex_ids", np.int32),
        meas_meta=meta, meas_pool=meas_pool,
        n=len(rows),
        used_tex_slots=tuple(sorted({
            s for r in rows for s in range(N_TEX_SLOTS)
            if r["tex_ids"][s] >= 0})),
        has_measured=bool(pool))


def _g3(a, m):
    """Color-column gather: (M, 3) table -> V3 of (R,)."""
    return V3(a[:, 0][m], a[:, 1][m], a[:, 2][m])


def eval_params(table: MaterialTable, mat_id, textures=None,
                it=None) -> bsdf.BSDFParams:
    """Gather per-ray BSDFParams; texture overrides are applied when a
    texture table and an interaction are given."""
    m = mat_id.clamp_min(0).long()
    meas = None
    if table.has_measured:
        pool = V3(table.meas_pool[:, 0], table.meas_pool[:, 1],
                  table.meas_pool[:, 2])
        meas = (table.meas_meta[m], pool)
    p = bsdf.BSDFParams(
        kd=_g3(table.kd, m), sigma=table.sigma[m], kd_t=_g3(table.kd_t, m),
        ks=_g3(table.ks, m), exponent=table.exponent[m],
        exponent_v=table.exponent_v[m],
        gloss_fresnel=table.gloss_fresnel[m], ks_t=_g3(table.ks_t, m),
        kr=_g3(table.kr, m), spec_fresnel=table.spec_fresnel[m],
        kt=_g3(table.kt, m),
        eta=table.eta[m], eta_c=_g3(table.eta_c, m), k_c=_g3(table.k_c, m),
        meas=meas)
    used = table.used_tex_slots
    if textures is not None and it is not None and used:
        from . import textures as tex_mod
        tid = table.tex_ids[m]
        upd = {}
        if TEX_KD in used:
            upd["kd"] = tex_mod.eval_or(textures, tid[:, TEX_KD], it, p.kd)
        if TEX_KS in used:
            upd["ks"] = tex_mod.eval_or(textures, tid[:, TEX_KS], it, p.ks)
        if TEX_KR in used:
            upd["kr"] = tex_mod.eval_or(textures, tid[:, TEX_KR], it, p.kr)
        if TEX_KT in used:
            upd["kt"] = tex_mod.eval_or(textures, tid[:, TEX_KT], it, p.kt)
        if TEX_SIGMA in used:
            upd["sigma"] = tex_mod.eval_or_scalar(
                textures, tid[:, TEX_SIGMA], it, p.sigma)
        if TEX_ROUGH in used:
            new_exp = 1.0 / tex_mod.eval_or_scalar(
                textures, tid[:, TEX_ROUGH], it,
                1.0 / p.exponent.clamp_min(1e-4)).clamp_min(1e-4)
            upd["exponent"] = new_exp
            # a textured roughness sets both axes of isotropic rows only
            upd["exponent_v"] = torch.where(p.exponent_v == p.exponent,
                                            new_exp, p.exponent_v)
        p = p._replace(**upd)
    return p


def bump_shading_normal(table: MaterialTable, mat_id, textures, it):
    """Bump mapping: evaluate the displacement texture at uv, uv+du, uv+dv
    by shifting the interaction, then perturb the shading normal:

        dpdu' = dpdu + (d(u+du)-d)/du * ns
        dpdv' = dpdv + (d(v+dv)-d)/dv * ns
        ns'   = normalize(dpdu' x dpdv')  (flipped into the hemisphere of ns)

    Returns it["ns"] unchanged when no material carries a bump texture."""
    if (textures is None or it is None
            or TEX_BUMP not in table.used_tex_slots):
        return it["ns"]
    from . import textures as tex_mod
    m = mat_id.clamp_min(0).long()
    tid = table.tex_ids[m][:, TEX_BUMP]
    has = tid >= 0
    uv = it["uv"]            # V2
    ns = it["ns"]            # V3
    # half the uv footprint from the camera differentials, else a fixed
    # delta
    du = torch.full_like(uv.x, 5e-4)
    if "tex_width" in it:
        du = 0.5 * it["tex_width"].clamp_min(1e-5)
    dv = du

    def disp(uv_shift, p_shift):
        it2 = dict(it)
        it2["uv"] = uv_shift
        it2["p"] = p_shift
        return tex_mod.eval_or_scalar(textures, tid, it2,
                                      torch.zeros_like(du))

    d0 = disp(uv, it["p"])
    d_u = disp(vm.V2(uv.x + du, uv.y), it["p"] + it["dpdu"] * du)
    d_v = disp(vm.V2(uv.x, uv.y + dv), it["p"] + it["dpdv"] * dv)
    dddu = (d_u - d0) / du.clamp_min(1e-8)
    dddv = (d_v - d0) / dv.clamp_min(1e-8)
    dpdu_b = it["dpdu"] + ns * dddu
    dpdv_b = it["dpdv"] + ns * dddv
    ns_b = vm.normalize(vm.cross(dpdu_b, dpdv_b))
    ns_b = vm.face_forward(ns_b, ns)
    return vm.where3(has, ns_b, ns)
