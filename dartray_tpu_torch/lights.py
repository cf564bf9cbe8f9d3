"""Light table: all lights flattened into typed parameter rows + CDF arrays
(counterpart of the JAX reference's ``lights.py``).

An area light references a contiguous triangle range of the global prim
arrays with a per-light area CDF; its sampled triangles come from a compact
``tri_rows`` table [v0 e1 e2 ng] copied out of the geometry attr table at
build. ``sample_li`` is evaluated for a wavefront with per-ray light
indices: each light type present in the table is evaluated for all lanes and
the row's type selects the result.

Ported: diffuse area lights and the three delta lights, point, spot and
distant (``area_light``, ``point_light``, ``spot_light``, ``distant_light``,
their branches of ``sample_li``, ``pdf_li_area``, ``le_emitted``,
``sample_light_index``). Projection, goniometric and infinite (environment)
lights need image maps and raise ``NotImplementedError`` in ``build_table``
(ROADMAP Queue 1 item 5, remaining lights); ``env_light_index`` stays -1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .core import math as vm
from .core import sampling as smp
from .core import spectrum as spec
from .core.math import V3

POINT = 0
SPOT = 1
DISTANT = 2
AREA = 3
INFINITE = 4
PROJECTION = 5
GONIOMETRIC = 6
_PORTED = (POINT, SPOT, DISTANT, AREA)

INF_DIST = 1e7  # "escaped" shadow-ray length for distant lights


@dataclasses.dataclass
class LightTable:
    kind: Any            # (L,) int32
    p: Any               # (L, 3) position (point/spot) | direction (distant)
    intensity: Any       # (L, 3) I / L / radiance scale
    params: Any          # (L, 8): spot: [cosTotal, cosFalloff, ...]
    w2l: Any             # (L, 4, 4) world->light (spot)
    tri_offset: Any      # (L,) int32 first prim id
    tri_count: Any       # (L,) int32
    tri_area_cdf: Any    # (sum_tris + L,) flattened per-light CDFs
    cdf_offset: Any      # (L,) int32 offset into tri_area_cdf
    total_area: Any      # (L,)
    power_cdf: Any       # (L+1,) power distribution CDF
    tri_rows: Any        # (T, 12) [v0 e1 e2 ng] of the emissive triangles
    tri_row_offset: Any  # (L,) int32
    scene_radius: float = 10.0
    n: int = 0
    env_light_index: int = -1     # no infinite light in this slice


class LightSpec(NamedTuple):
    """Host-side description used by the scene compiler."""
    kind: int
    p: tuple = (0.0, 0.0, 0.0)
    intensity: tuple = (1.0, 1.0, 1.0)
    params: tuple = (0.0,) * 8
    w2l: Optional[np.ndarray] = None
    tri_offset: int = 0
    tri_count: int = 0
    tri_areas: Optional[np.ndarray] = None


def point_light(p, intensity=(1.0,) * 3):
    return LightSpec(POINT, p=tuple(p), intensity=tuple(intensity))


def spot_light(p, w2l, intensity=(1.0,) * 3, cone_angle=30.0,
               cone_delta=5.0):
    """Falloff between cos(total) and cos(total - delta)."""
    ct = float(np.cos(np.radians(cone_angle)))
    cf = float(np.cos(np.radians(cone_angle - cone_delta)))
    return LightSpec(SPOT, p=tuple(p), intensity=tuple(intensity),
                     params=(ct, cf) + (0.0,) * 6, w2l=w2l)


def distant_light(direction, radiance=(1.0,) * 3):
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    return LightSpec(DISTANT, p=tuple(d), intensity=tuple(radiance))


def area_light(tri_offset, tri_areas, L=(1.0,) * 3, n_samples=1):
    return LightSpec(AREA, intensity=tuple(L), tri_offset=tri_offset,
                     tri_count=len(tri_areas),
                     tri_areas=np.asarray(tri_areas, np.float64),
                     params=(float(n_samples),) + (0.0,) * 7)


def build_table(specs, scene_radius=10.0, attr=None) -> LightTable:
    """attr: the geometry's (F, 48) attr-row table (scene/types._pack_attr);
    the area lights' triangle rows [v0 e1 e2 ng] are copied out of it."""
    if attr is None:
        raise ValueError("build_table needs the geometry attr table")
    for s in specs:
        if s.kind not in _PORTED:
            raise NotImplementedError(
                f"light kind {s.kind}: infinite, projection and goniometric "
                "lights are not ported (ROADMAP Queue 1 item 5, remaining lights)")
    l = max(len(specs), 1)
    kind = np.zeros(l, np.int32)
    p = np.zeros((l, 3), np.float32)
    inten = np.zeros((l, 3), np.float32)
    params = np.zeros((l, 8), np.float32)
    w2l = np.tile(np.eye(4, dtype=np.float32), (l, 1, 1))
    tri_offset = np.zeros(l, np.int32)
    tri_count = np.zeros(l, np.int32)
    cdf_offset = np.zeros(l, np.int32)
    total_area = np.zeros(l, np.float32)
    cdfs = []
    tri_row_offset = np.zeros(l, np.int32)
    tri_row_chunks = []
    tri_row_off = 0
    off = 0
    for i, s in enumerate(specs):
        kind[i] = s.kind
        p[i] = s.p
        inten[i] = s.intensity
        params[i] = s.params
        if s.w2l is not None:
            w2l[i] = np.asarray(s.w2l, np.float32)
        if s.kind != AREA:
            continue
        cdf = np.concatenate([[0.0], np.cumsum(s.tri_areas)])
        total_area[i] = cdf[-1]
        cdf = cdf / max(cdf[-1], 1e-20)
        tri_offset[i] = s.tri_offset
        tri_count[i] = s.tri_count
        cdf_offset[i] = off
        cdfs.append(cdf.astype(np.float32))
        off += len(cdf)
        tri_row_offset[i] = tri_row_off
        tri_row_chunks.append(np.ascontiguousarray(
            attr[s.tri_offset:s.tri_offset + s.tri_count, :12]))
        tri_row_off += s.tri_count
    tri_area_cdf = (np.concatenate(cdfs) if cdfs
                    else np.zeros(1, np.float32))
    # power CDF over the lights
    powers = np.zeros(l, np.float32)
    for i, s in enumerate(specs):
        lum = float(np.dot(spec.RGB_TO_XYZ[1], np.asarray(s.intensity)))
        if s.kind == POINT:
            powers[i] = 4 * np.pi * lum
        elif s.kind == SPOT:
            powers[i] = 2 * np.pi * (1 - 0.5 * (params[i, 0]
                                                + params[i, 1])) * lum
        elif s.kind == DISTANT:
            powers[i] = np.pi * scene_radius ** 2 * lum
        else:
            powers[i] = np.pi * total_area[i] * lum
    pc = np.concatenate([[0.0], np.cumsum(powers)])
    pc = pc / max(pc[-1], 1e-20)
    return LightTable(
        kind=kind, p=p, intensity=inten, params=params, w2l=w2l,
        tri_offset=tri_offset, tri_count=tri_count,
        tri_area_cdf=tri_area_cdf, cdf_offset=cdf_offset,
        total_area=total_area, power_cdf=np.asarray(pc, np.float32),
        tri_rows=(np.concatenate(tri_row_chunks) if tri_row_chunks
                  else np.zeros((1, 12), np.float32)),
        tri_row_offset=tri_row_offset,
        scene_radius=float(np.float32(scene_radius)), n=len(specs))


def _g3(a, idx):
    """(L, 3) table -> V3 of (R,) component gathers."""
    return V3(a[:, 0][idx], a[:, 1][idx], a[:, 2][idx])


class LiSample(NamedTuple):
    wi: V3                   # direction to light
    li: V3                   # incident radiance
    pdf: torch.Tensor        # (R,) solid-angle pdf
    dist: torch.Tensor       # (R,) shadow-ray length
    is_delta: torch.Tensor   # (R,) bool


def _kinds_present(lt: LightTable):
    """The light kinds of the table, read once per table object (the only
    read of ``lt.kind`` on the host) and kept on it: ``sample_li`` evaluates
    no branch that no light of the table takes."""
    kinds = lt.__dict__.get("_kinds")
    if kinds is None:
        kinds = frozenset(int(k) for k in lt.kind[:lt.n].tolist())
        lt.__dict__["_kinds"] = kinds
    return kinds


def _sample_area(lt: LightTable, li_, inten, p_surf: V3, u, uc):
    """CDF-sample a triangle of the light by `uc`, a uniform point on it by
    `u`. Returns (wi, li, pdf, dist)."""
    nt = lt.tri_count[li_].clamp_min(1).long()
    # fixed-trip binary search for uc in the light's cdf segment
    lo = lt.cdf_offset[li_].long()
    left = torch.zeros_like(nt)
    right = nt
    max_iter = int(np.ceil(np.log2(max(int(lt.tri_area_cdf.shape[0]), 2)))) + 1
    for _ in range(max_iter):
        mid = (left + right) // 2
        go_right = lt.tri_area_cdf[lo + mid] <= uc
        left = torch.where(go_right, mid + 1, left)
        right = torch.where(go_right, right, mid)
    tri_k = torch.minimum((left - 1).clamp_min(0), nt - 1)
    b1, b2 = smp.uniform_sample_triangle(u)
    ridx = (lt.tri_row_offset[li_].long() + tri_k).clamp(
        0, lt.tri_rows.shape[0] - 1)
    rows = lt.tri_rows[ridx].t()
    tv0 = V3(rows[0], rows[1], rows[2])
    te1 = V3(rows[3], rows[4], rows[5])
    te2 = V3(rows[6], rows[7], rows[8])
    ps = tv0 + te1 * b1 + te2 * b2
    ns = V3(rows[9], rows[10], rows[11])
    to_s = ps - p_surf
    d2a = vm.length_sq(to_s).clamp_min(1e-12)
    dist_a = torch.sqrt(d2a)
    wi_area = to_s * (1.0 / dist_a)
    cos_l = vm.dot(ns, -wi_area)
    # one-sided emission
    li_area = vm.where3(cos_l > 0, inten, 0.0)
    # pdf: uniform by area -> solid angle: dist^2 / (cos * A)
    pdf_area = d2a / (torch.abs(cos_l) * lt.total_area[li_]).clamp_min(1e-9)
    return wi_area, li_area, pdf_area, dist_a


def sample_li(lt: LightTable, geom, light_idx, p_surf: V3, u,
              uc=None) -> LiSample:
    """Per-ray light sampling.

    light_idx: (R,) int32. u: V2 (or (R, 2)). uc: optional (R,) component
    sample for an area light's triangle choice. Point and spot lights sit at
    ``lt.p`` (delta, inverse-square; the spot's falloff between its two
    cosines), a distant light shines along ``lt.p`` from ``INF_DIST``."""
    u = vm.from_arr2(u)
    li_ = light_idx.clamp_min(0).long()
    inten = _g3(lt.intensity, li_)
    if uc is None:
        uc = u.x
    kinds = _kinds_present(lt)
    if AREA in kinds:
        wi_area, li_area, pdf_area, dist_a = _sample_area(lt, li_, inten,
                                                          p_surf, u, uc)
        if kinds == {AREA}:
            return LiSample(wi=wi_area, li=li_area, pdf=pdf_area, dist=dist_a,
                            is_delta=torch.zeros_like(pdf_area,
                                                      dtype=torch.bool))
    kind = lt.kind[li_]
    lp = _g3(lt.p, li_)
    # --- point / spot (delta, at a position) ------------------------------
    to_l = lp - p_surf
    d2 = vm.length_sq(to_l).clamp_min(1e-12)
    dist = torch.sqrt(d2)
    wi = to_l * (1.0 / dist)
    li_v = inten * (1.0 / d2)
    if SPOT in kinds:
        # falloff: the local -wi angle against the cone
        m = [[lt.w2l[:, i, j][li_] for j in range(3)] for i in range(3)]
        nwi = -wi
        wl = vm.normalize(V3(*(m[i][0] * nwi.x + m[i][1] * nwi.y
                               + m[i][2] * nwi.z for i in range(3))))
        cos_t = wl.z
        ct = lt.params[:, 0][li_]
        cf = lt.params[:, 1][li_]
        delta = ((cos_t - ct) / (cf - ct).clamp_min(1e-8)).clamp(0.0, 1.0)
        d2_ = delta * delta
        falloff = torch.where(cos_t < ct, 0.0,
                              torch.where(cos_t > cf, 1.0, d2_ * d2_))
        li_v = vm.where3(kind == SPOT, li_v * falloff, li_v)
    pdf = torch.ones_like(dist)
    if DISTANT in kinds:
        is_dist = kind == DISTANT
        wi = vm.where3(is_dist, lp, wi)
        li_v = vm.where3(is_dist, inten, li_v)
        dist = torch.where(is_dist, INF_DIST, dist)
    if AREA in kinds:
        is_area = kind == AREA
        wi = vm.where3(is_area, wi_area, wi)
        li_v = vm.where3(is_area, li_area, li_v)
        pdf = torch.where(is_area, pdf_area, pdf)
        dist = torch.where(is_area, dist_a, dist)
    return LiSample(wi=wi, li=li_v, pdf=pdf, dist=dist, is_delta=kind != AREA)


def pdf_li_area(lt: LightTable, light_idx, p_surf, wi, hit_t, hit_cos):
    """Solid-angle pdf that area light `light_idx` generates direction wi
    from p_surf, given the ray actually hit it at distance hit_t with |cos|
    hit_cos."""
    return (hit_t * hit_t) / (
        hit_cos * lt.total_area[light_idx.clamp_min(0).long()]
    ).clamp_min(1e-9)


def le_emitted(lt: LightTable, geom, prim_id, wo: V3, ns: V3,
               lid=None) -> V3:
    """Emitted radiance when a ray hits an emissive prim. Pass `lid` (the
    interaction's light_id) to skip the per-prim gather."""
    if lid is None:
        lid = geom.light_id[prim_id.clamp_min(0).long()]
    emissive = (prim_id >= 0) & (lid >= 0)
    l_emit = _g3(lt.intensity, lid.clamp_min(0).long())
    facing = vm.dot(ns, wo) > 0.0
    return vm.where3(emissive & facing, l_emit, 0.0)


def sample_light_index(lt: LightTable, u):
    """Sample a light ~ power CDF -> (idx int32, pdf)."""
    idx = (torch.searchsorted(lt.power_cdf, u.contiguous(), right=True)
           - 1).clamp(0, lt.n - 1)
    pdf = lt.power_cdf[idx + 1] - lt.power_cdf[idx]
    return idx.to(torch.int32), pdf.clamp_min(1e-12)
