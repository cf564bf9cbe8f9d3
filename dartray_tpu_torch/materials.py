"""Material table: every material compiled to per-lobe parameter rows
(counterpart of the JAX reference's ``materials.py``).

Each material is one row of the lobe-slot layout of ``bsdf.py`` and a
wavefront's parameters are one row gather. Ported: ``matte``, ``mirror`` and
``glass`` (the diffuse and the two specular slots). A row that needs any
other lobe (plastic, metal, shinymetal, substrate, translucent, uber, mix,
measured) raises ``NotImplementedError`` in ``build_table`` (ROADMAP Queue 1,
remaining BSDF lobes). Bump maps need image/procedural textures and wait for
them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np

from . import bsdf
from .bsdf import FR_NOOP, FR_DIELECTRIC, FR_CONDUCTOR
from .core.math import V3

# RGB-projected copper eta/k: the reference's default conductor columns,
# carried so that tables compare leaf by leaf
COPPER_ETA = (0.2004, 0.9240, 1.1022)
COPPER_K = (3.9129, 2.4528, 2.1421)

# texture-slot indices into tex_ids rows (textures overriding params)
TEX_KD, TEX_KS, TEX_KR, TEX_KT, TEX_SIGMA, TEX_ROUGH, TEX_OPACITY, TEX_BUMP \
    = range(8)
N_TEX_SLOTS = 8
_PORTED_TEX_SLOTS = (TEX_KD, TEX_KR, TEX_KT, TEX_SIGMA)


@dataclasses.dataclass
class MaterialTable:
    kd: Any             # (M, 3)
    sigma: Any          # (M,)
    kd_t: Any           # (M, 3)  must be zero (slot not ported)
    ks: Any             # (M, 3)  must be zero (slot not ported)
    exponent: Any       # (M,)
    exponent_v: Any     # (M,)
    gloss_fresnel: Any  # (M,) int32
    ks_t: Any           # (M, 3)  must be zero (slot not ported)
    kr: Any             # (M, 3)
    spec_fresnel: Any   # (M,) int32
    kt: Any             # (M, 3)
    eta: Any            # (M,)
    eta_c: Any          # (M, 3)
    k_c: Any            # (M, 3)
    opacity: Any        # (M, 3)
    tex_ids: Any        # (M, N_TEX_SLOTS) int32, -1 = constant
    n: int = 0
    used_tex_slots: tuple = ()
    has_measured: bool = False


def _row(kd=(0, 0, 0), sigma=0.0, kd_t=(0, 0, 0), ks=(0, 0, 0),
         roughness=0.1, gloss_fresnel=FR_DIELECTRIC, ks_t=(0, 0, 0),
         kr=(0, 0, 0), spec_fresnel=FR_NOOP, kt=(0, 0, 0), eta=1.5,
         eta_c=COPPER_ETA, k_c=COPPER_K, opacity=(1, 1, 1), tex_ids=None,
         vroughness=None):
    exponent = 1.0 / max(float(roughness), 1e-4)
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


def matte(kd=(0.5, 0.5, 0.5), sigma=0.0, **tex):
    """Lambertian (sigma 0) or Oren-Nayar diffuse reflection."""
    return _row(kd=kd, sigma=sigma, **tex)


def mirror(kr=(0.9,) * 3, **tex):
    """Specular reflection, no-op Fresnel."""
    return _row(kr=kr, spec_fresnel=FR_NOOP, **tex)


def glass(kr=(1.0,) * 3, kt=(1.0,) * 3, index=1.5, **tex):
    """Fresnel-weighted specular reflection + transmission."""
    return _row(kr=kr, kt=kt, eta=index, spec_fresnel=FR_DIELECTRIC, **tex)


def _not_ported(name):
    def builder(*a, **k):
        raise NotImplementedError(
            f"material {name!r} needs BSDF lobes that are not ported yet "
            "(ROADMAP Queue 1, remaining BSDF lobes)")
    builder.__name__ = name
    return builder


plastic = _not_ported("plastic")
metal = _not_ported("metal")
shinymetal = _not_ported("shinymetal")
substrate = _not_ported("substrate")
translucent = _not_ported("translucent")
uber = _not_ported("uber")
mix_materials = _not_ported("mix")
measured = _not_ported("measured")


def check_supported(table: MaterialTable):
    """Raise NotImplementedError for a table that needs a lobe, Fresnel mode
    or texture slot this slice does not evaluate."""
    def nonzero(a):
        return bool(np.any(np.asarray(a) != 0))
    bad = [nm for nm in ("kd_t", "ks", "ks_t") if nonzero(getattr(table, nm))]
    if bad:
        raise NotImplementedError(
            f"material columns {bad} need the glossy / diffuse-transmission "
            "lobes (ROADMAP Queue 1, remaining BSDF lobes)")
    if np.any(np.asarray(table.spec_fresnel) >= FR_CONDUCTOR):
        raise NotImplementedError(
            "conductor Fresnel on the specular slot is not ported "
            "(ROADMAP Queue 1, remaining BSDF lobes)")
    if table.has_measured:
        raise NotImplementedError(
            "measured BRDFs are not ported (ROADMAP Queue 1, remaining "
            "BSDF lobes)")
    extra = set(table.used_tex_slots) - set(_PORTED_TEX_SLOTS)
    if extra:
        raise NotImplementedError(
            f"texture slots {sorted(extra)} (ks / roughness / opacity / "
            "bump) are not ported (ROADMAP Queue 1, textures)")


def build_table(rows: List[dict]) -> MaterialTable:
    if not rows:
        rows = [matte()]
    if any(r.get("_meas_data") is not None for r in rows):
        measured()

    def col(k, dt=np.float32):
        return np.asarray([r[k] for r in rows], dt)

    table = MaterialTable(
        kd=col("kd"), sigma=col("sigma"), kd_t=col("kd_t"), ks=col("ks"),
        exponent=col("exponent"), exponent_v=col("exponent_v"),
        gloss_fresnel=col("gloss_fresnel", np.int32), ks_t=col("ks_t"),
        kr=col("kr"), spec_fresnel=col("spec_fresnel", np.int32),
        kt=col("kt"), eta=col("eta"), eta_c=col("eta_c"), k_c=col("k_c"),
        opacity=col("opacity"), tex_ids=col("tex_ids", np.int32),
        n=len(rows),
        used_tex_slots=tuple(sorted({
            s for r in rows for s in range(N_TEX_SLOTS)
            if r["tex_ids"][s] >= 0})))
    check_supported(table)
    return table


def _g3(a, m):
    """Color-column gather: (M, 3) table -> V3 of (R,)."""
    return V3(a[:, 0][m], a[:, 1][m], a[:, 2][m])


def eval_params(table: MaterialTable, mat_id, textures=None,
                it=None) -> bsdf.BSDFParams:
    """Gather per-ray BSDFParams; constant-texture overrides are applied when
    a texture table and an interaction are given."""
    m = mat_id.clamp_min(0).long()
    p = bsdf.BSDFParams(
        kd=_g3(table.kd, m), sigma=table.sigma[m], kr=_g3(table.kr, m),
        spec_fresnel=table.spec_fresnel[m], kt=_g3(table.kt, m),
        eta=table.eta[m])
    used = table.used_tex_slots
    if textures is not None and it is not None and used:
        from . import textures as tex_mod
        tid = table.tex_ids[m]
        upd = {}
        if TEX_KD in used:
            upd["kd"] = tex_mod.eval_or(textures, tid[:, TEX_KD], it, p.kd)
        if TEX_KR in used:
            upd["kr"] = tex_mod.eval_or(textures, tid[:, TEX_KR], it, p.kr)
        if TEX_KT in used:
            upd["kt"] = tex_mod.eval_or(textures, tid[:, TEX_KT], it, p.kt)
        if TEX_SIGMA in used:
            upd["sigma"] = tex_mod.eval_or_scalar(
                textures, tid[:, TEX_SIGMA], it, p.sigma)
        p = p._replace(**upd)
    return p


def bump_shading_normal(table: MaterialTable, mat_id, textures, it):
    """Bump mapping perturbs the shading normal by a displacement texture;
    it needs non-constant textures, so a table that asks for it has already
    been refused by ``check_supported`` and the shading normal is returned
    as it is."""
    if TEX_BUMP in table.used_tex_slots:
        raise NotImplementedError(
            "bump maps are not ported (ROADMAP Queue 1, textures)")
    return it["ns"]
