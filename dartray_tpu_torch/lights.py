"""Light table: diffuse area lights flattened into parameter rows + CDF
arrays (counterpart of the JAX reference's ``lights.py``).

An area light references a contiguous triangle range of the global prim
arrays with a per-light area CDF; its sampled triangles come from a compact
``tri_rows`` table [v0 e1 e2 ng] copied out of the geometry attr table at
build. ``sample_li`` is evaluated for a wavefront with per-ray light indices.

Ported: diffuse area lights (``area_light``, the area branch of
``sample_li``, ``pdf_li_area``, ``le_emitted``, ``sample_light_index``).
Point, spot, distant, projection, goniometric and infinite (environment)
lights raise ``NotImplementedError`` in ``build_table`` (ROADMAP Queue 1,
remaining lights).
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


@dataclasses.dataclass
class LightTable:
    kind: Any            # (L,) int32
    intensity: Any       # (L, 3) emitted radiance
    params: Any          # (L, 8): area: [n_samples, ...]
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
    tri_offset: int = 0
    tri_count: int = 0
    tri_areas: Optional[np.ndarray] = None


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
        if s.kind != AREA:
            raise NotImplementedError(
                f"light kind {s.kind}: only diffuse area lights are ported "
                "(ROADMAP Queue 1, remaining lights)")
    l = max(len(specs), 1)
    kind = np.zeros(l, np.int32)
    inten = np.zeros((l, 3), np.float32)
    params = np.zeros((l, 8), np.float32)
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
        inten[i] = s.intensity
        params[i] = s.params
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
        powers[i] = np.pi * total_area[i] * lum
    pc = np.concatenate([[0.0], np.cumsum(powers)])
    pc = pc / max(pc[-1], 1e-20)
    return LightTable(
        kind=kind, intensity=inten, params=params,
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


def sample_li(lt: LightTable, geom, light_idx, p_surf: V3, u,
              uc=None) -> LiSample:
    """Per-ray light sampling (area lights): CDF-sample a triangle of the
    light by `uc`, a uniform point on it by `u`.

    light_idx: (R,) int32. u: V2 (or (R, 2)). uc: optional (R,) component
    sample for the triangle choice."""
    u = vm.from_arr2(u)
    li_ = light_idx.clamp_min(0).long()
    inten = _g3(lt.intensity, li_)
    if uc is None:
        uc = u.x
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
    return LiSample(wi=wi_area, li=li_area, pdf=pdf_area, dist=dist_a,
                    is_delta=torch.zeros_like(cos_l, dtype=torch.bool))


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
