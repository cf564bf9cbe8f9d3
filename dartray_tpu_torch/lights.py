"""Light table: all lights flattened into typed parameter rows + CDF arrays
(counterpart of the JAX reference's ``lights.py``).

An area light references a contiguous triangle range of the global prim
arrays with a per-light area CDF; its sampled triangles come from a compact
``tri_rows`` table [v0 e1 e2 ng] copied out of the geometry attr table at
build. ``sample_li`` and ``sample_le`` are evaluated for a wavefront with
per-ray light indices: each light type present in the table is evaluated
for all lanes and the row's type selects the result; a type the table does
not hold costs nothing.

Every kind of the reference: diffuse area lights; point, spot and distant;
projection (a perspective-projected image) and goniometric (a lat-long
angular intensity map); infinite (an environment map importance-sampled by
a ``Distribution2D`` of luminance x sin(theta), with ``env_le`` /
``env_pdf`` for escaped rays). ``sample_le`` emits photon rays from every
kind. One ``proj_map`` and one ``env_map`` serve the whole table: with two
projection or goniometric lights the last one's map wins, as in the
reference. In the sampled-spectrum mode (``spec.mode() == "sampled"``)
the power CDF weighs luminance through the bands, and the environment and
projection maps, given in RGB, are turned into bands as illuminants.
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

INF_DIST = 1e7  # "escaped" shadow-ray length for distant / infinite lights


@dataclasses.dataclass
class LightTable:
    kind: Any            # (L,) int32
    p: Any               # (L, 3) position | direction (distant)
    intensity: Any       # (L, 3) I / L / radiance scale
    params: Any          # (L, 8): spot [cosTotal, cosFalloff], projection
    #                      [cosTotal, s1, s0], area [n_samples]
    w2l: Any             # (L, 4, 4) world->light (spot/proj/gonio/infinite)
    tri_offset: Any      # (L,) int32 first prim id
    tri_count: Any       # (L,) int32
    tri_area_cdf: Any    # (sum_tris + L,) flattened per-light CDFs
    cdf_offset: Any      # (L,) int32 offset into tri_area_cdf
    total_area: Any      # (L,)
    power_cdf: Any       # (L+1,) power distribution CDF
    tri_rows: Any        # (T, 12) [v0 e1 e2 ng] of the emissive triangles
    tri_row_offset: Any  # (L,) int32
    # the infinite light's lat-long radiance map and its Distribution2D (a
    # (1, 1, 3) zero map when the table has no infinite light)
    env_map: Any         # (He, We, 3)
    env_cond_cdf: Any    # (He, We + 1)
    env_cond_func: Any   # (He, We)
    env_cond_int: Any    # (He,)
    env_marg_cdf: Any    # (He + 1,)
    env_marg_func: Any   # (He,)
    env_marg_int: Any    # ()
    proj_map: Any        # (Hp, Wp, 3) projection / goniometric map (shared)
    scene_radius: float = 10.0
    n: int = 0
    env_light_index: int = -1     # -1: no infinite light
    env_w: int = 1
    env_h: int = 1


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
    env_map: Optional[np.ndarray] = None     # (He, We, 3)
    proj_map: Optional[np.ndarray] = None


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


def infinite_light(env_map, w2l=None, L_scale=(1.0,) * 3):
    return LightSpec(INFINITE, intensity=tuple(L_scale),
                     env_map=np.asarray(env_map, np.float32), w2l=w2l)


def projection_light(p, w2l, intensity=(1.0,) * 3, fov=45.0, proj_map=None):
    """A perspective-projected image light: the map fills the frustum of
    `fov` about the light's +z, its longer side across the full angle."""
    if proj_map is None:
        proj_map = np.ones((1, 1, 3), np.float32)
    aspect = proj_map.shape[1] / proj_map.shape[0]
    t = np.tan(np.radians(fov) / 2.0)
    if aspect > 1.0:
        s1, s0 = t, t / aspect
    else:
        s1, s0 = t * aspect, t
    cos_total = float(1.0 / np.sqrt(1.0 + s0 * s0 + s1 * s1))
    return LightSpec(PROJECTION, p=tuple(p), intensity=tuple(intensity),
                     params=(cos_total, float(s1), float(s0)) + (0.0,) * 5,
                     w2l=w2l, proj_map=np.asarray(proj_map, np.float32))


def goniometric_light(p, w2l, intensity=(1.0,) * 3, gonio_map=None):
    """A point light scaled by a lat-long map of the light-space
    direction."""
    if gonio_map is None:
        gonio_map = np.ones((1, 1, 3), np.float32)
    return LightSpec(GONIOMETRIC, p=tuple(p), intensity=tuple(intensity),
                     w2l=w2l, proj_map=np.asarray(gonio_map, np.float32))


def build_table(specs, scene_radius=10.0, attr=None) -> LightTable:
    """attr: the geometry's (F, 48) attr-row table (scene/types._pack_attr);
    the area lights' triangle rows [v0 e1 e2 ng] are copied out of it."""
    if attr is None:
        raise ValueError("build_table needs the geometry attr table")
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
    env_idx, env_map = -1, np.zeros((1, 1, 3), np.float32)
    proj_map = np.ones((1, 1, 3), np.float32)
    off = 0
    for i, s in enumerate(specs):
        kind[i] = s.kind
        p[i] = s.p
        inten[i] = s.intensity
        params[i] = s.params
        if s.w2l is not None:
            w2l[i] = np.asarray(s.w2l, np.float32)
        if s.kind == AREA:
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
        if s.kind == INFINITE:
            env_idx = i
            env_map = s.env_map
        if s.kind in (PROJECTION, GONIOMETRIC) and s.proj_map is not None:
            proj_map = s.proj_map
    tri_area_cdf = (np.concatenate(cdfs) if cdfs
                    else np.zeros(1, np.float32))
    # power CDF over the lights
    powers = np.zeros(l, np.float32)
    lum_w = (spec.BANDS_TO_XYZ[1] if spec.mode() == "sampled"
             else spec.RGB_TO_XYZ[1])
    for i, s in enumerate(specs):
        lum = float(np.dot(lum_w, np.asarray(s.intensity)))
        if s.kind == POINT:
            powers[i] = 4 * np.pi * lum
        elif s.kind == SPOT:
            powers[i] = 2 * np.pi * (1 - 0.5 * (params[i, 0]
                                                + params[i, 1])) * lum
        elif s.kind == DISTANT:
            powers[i] = np.pi * scene_radius ** 2 * lum
        elif s.kind == AREA:
            powers[i] = np.pi * total_area[i] * lum
        elif s.kind == INFINITE:
            m = float(np.dot(np.asarray(s.env_map).reshape(-1, 3).mean(0),
                             lum_w)) * lum
            powers[i] = np.pi * scene_radius ** 2 * m
        else:
            powers[i] = 4 * np.pi * lum
    pc = np.concatenate([[0.0], np.cumsum(powers)])
    pc = pc / max(pc[-1], 1e-20)
    if spec.mode() == "sampled":
        # the maps are RGB illuminants: to bands through the D65-shaped
        # basis (the infinite light's power above read the RGB map)
        env_map = spec.rgb_to_bands(env_map, illuminant=True).astype(
            np.float32)
        proj_map = spec.rgb_to_bands(proj_map, illuminant=True).astype(
            np.float32)
    # the infinite light's importance: luminance x sin(theta) per texel
    he, we = env_map.shape[:2]
    lum_img = env_map @ lum_w
    sin_t = np.sin(np.pi * (np.arange(he) + 0.5) / he)
    d2 = smp.Distribution2D(np.asarray(lum_img * sin_t[:, None] + 1e-9))
    return LightTable(
        kind=kind, p=p, intensity=inten, params=params, w2l=w2l,
        tri_offset=tri_offset, tri_count=tri_count,
        tri_area_cdf=tri_area_cdf, cdf_offset=cdf_offset,
        total_area=total_area, power_cdf=np.asarray(pc, np.float32),
        tri_rows=(np.concatenate(tri_row_chunks) if tri_row_chunks
                  else np.zeros((1, 12), np.float32)),
        tri_row_offset=tri_row_offset,
        env_map=np.asarray(env_map, np.float32),
        env_cond_cdf=d2.cond_cdf, env_cond_func=d2.cond_func,
        env_cond_int=d2.cond_int, env_marg_cdf=d2.marg_cdf,
        env_marg_func=d2.marg_func, env_marg_int=d2.marg_int,
        proj_map=np.asarray(proj_map, np.float32),
        scene_radius=float(np.float32(scene_radius)), n=len(specs),
        env_light_index=env_idx, env_w=we, env_h=he)


def _g3(a, idx):
    """(L, 3) table -> V3 of (R,) component gathers."""
    return V3(a[:, 0][idx], a[:, 1][idx], a[:, 2][idx])


def _w2l_rows(lt: LightTable, idx):
    """Per-ray world->light 3x4 rows as component gathers."""
    return [[lt.w2l[:, i, j][idx] for j in range(4)] for i in range(3)]


def _rows_xform_v(mr, v: V3) -> V3:
    return V3(mr[0][0] * v.x + mr[0][1] * v.y + mr[0][2] * v.z,
              mr[1][0] * v.x + mr[1][1] * v.y + mr[1][2] * v.z,
              mr[2][0] * v.x + mr[2][1] * v.y + mr[2][2] * v.z)


def _rows_xform_v_t(mr, v: V3) -> V3:
    """The transpose (light->world rotation) applied to v."""
    return V3(mr[0][0] * v.x + mr[1][0] * v.y + mr[2][0] * v.z,
              mr[0][1] * v.x + mr[1][1] * v.y + mr[2][1] * v.z,
              mr[0][2] * v.x + mr[1][2] * v.y + mr[2][2] * v.z)


class LiSample(NamedTuple):
    wi: V3                   # direction to light
    li: V3                   # incident radiance
    pdf: torch.Tensor        # (R,) solid-angle pdf
    dist: torch.Tensor       # (R,) shadow-ray length
    is_delta: torch.Tensor   # (R,) bool


def _kinds_present(lt: LightTable):
    """The light kinds of the table, read once per table object (the only
    read of ``lt.kind`` on the host) and kept on it: no branch that no light
    of the table takes is evaluated."""
    kinds = lt.__dict__.get("_kinds")
    if kinds is None:
        kinds = frozenset(int(k) for k in lt.kind[:lt.n].tolist())
        lt.__dict__["_kinds"] = kinds
    return kinds


# --- the environment map --------------------------------------------------

def _env_lookup(lt: LightTable, u, v):
    """Bilinear texel fetch of the lat-long radiance map: phi (u) wraps,
    theta (v) clamps. u, v (R,) -> V3."""
    xx = u * lt.env_w - 0.5
    yy = v * lt.env_h - 0.5
    x0 = torch.floor(xx).to(torch.int32)
    y0 = torch.floor(yy).to(torch.int32)
    fx = xx - x0
    fy = yy - y0
    flat = lt.env_map.reshape(-1, 3)
    er, eg, eb = flat[:, 0], flat[:, 1], flat[:, 2]

    def at(x, y):
        x = x % lt.env_w
        y = y.clamp(0, lt.env_h - 1)
        i = (y * lt.env_w + x).long()
        return V3(er[i], eg[i], eb[i])

    c00 = at(x0, y0)
    c10 = at(x0 + 1, y0)
    c01 = at(x0, y0 + 1)
    c11 = at(x0 + 1, y0 + 1)
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def _env_sample(lt: LightTable, u):
    """Distribution2D sample of the lat-long map -> (light-space direction,
    radiance, solid-angle pdf)."""
    u = vm.from_arr2(u)
    nu, nv = lt.env_w, lt.env_h
    u0, u1 = u.x, u.y
    # the marginal over rows (v)
    v_off = (torch.searchsorted(lt.env_marg_cdf, u1.contiguous(), right=True)
             - 1).clamp(0, nv - 1)
    mlo = lt.env_marg_cdf[v_off]
    mhi = lt.env_marg_cdf[v_off + 1]
    dv = (u1 - mlo) / (mhi - mlo).clamp_min(1e-30)
    pdf_v = lt.env_marg_func[v_off] / lt.env_marg_int.clamp_min(1e-30)
    v = (v_off.to(torch.float32) + dv) / nv
    # the conditional over u given row v_off: a fixed-trip binary search on
    # the flat cdf, so that ties resolve as in the reference
    flat_cdf = lt.env_cond_cdf.reshape(-1)
    base = v_off * (nu + 1)
    left = torch.zeros_like(v_off)
    right = torch.full_like(v_off, nu)
    for _ in range(int(np.ceil(np.log2(max(nu + 1, 2)))) + 1):
        mid = (left + right) // 2
        go = flat_cdf[base + mid] <= u0
        left, right = torch.where(go, mid + 1, left), torch.where(go, right,
                                                                  mid)
    u_off = (left - 1).clamp(0, nu - 1)
    clo = flat_cdf[base + u_off]
    chi = flat_cdf[base + u_off + 1]
    du = (u0 - clo) / (chi - clo).clamp_min(1e-30)
    pdf_u = (lt.env_cond_func.reshape(-1)[v_off * nu + u_off]
             / lt.env_cond_int[v_off].clamp_min(1e-30))
    uu = (u_off.to(torch.float32) + du) / nu
    map_pdf = pdf_u * pdf_v
    theta = v * np.pi
    phi = uu * 2.0 * np.pi
    sin_t = torch.sin(theta)
    dir_l = V3(sin_t * torch.cos(phi), sin_t * torch.sin(phi),
               torch.cos(theta))
    pdf_sa = map_pdf / (2.0 * np.pi * np.pi * sin_t).clamp_min(1e-8)
    L = _env_lookup(lt, uu, v)
    return dir_l, L, torch.where(sin_t > 1e-8, pdf_sa, 0.0)


def _env_dir(lt: LightTable, d_world: V3) -> V3:
    """World direction -> the infinite light's frame, normalised."""
    m = lt.w2l[lt.env_light_index]
    return vm.normalize(V3(
        m[0, 0] * d_world.x + m[0, 1] * d_world.y + m[0, 2] * d_world.z,
        m[1, 0] * d_world.x + m[1, 1] * d_world.y + m[1, 2] * d_world.z,
        m[2, 0] * d_world.x + m[2, 1] * d_world.y + m[2, 2] * d_world.z))


def env_le(lt: LightTable, d_world: V3) -> V3:
    """Radiance Le of an escaped ray along d_world from the infinite light
    (zero without one)."""
    if lt.env_light_index < 0:
        return vm.v3zeros(d_world.x.shape, d_world.x.device)
    d = _env_dir(lt, d_world)
    u = vm.spherical_phi(d) * (0.5 / np.pi)
    v = vm.spherical_theta(d) / np.pi
    inten = lt.intensity[lt.env_light_index]
    return _env_lookup(lt, u, v) * V3(inten[0], inten[1], inten[2])


def env_pdf(lt: LightTable, d_world: V3):
    """Solid-angle pdf with which the infinite light samples d_world."""
    if lt.env_light_index < 0:
        return torch.zeros_like(d_world.x)
    d = _env_dir(lt, d_world)
    theta = vm.spherical_theta(d)
    phi = vm.spherical_phi(d)
    sin_t = torch.sin(theta)
    iu = (phi * (0.5 / np.pi) * lt.env_w).to(torch.int32).clamp(
        0, lt.env_w - 1)
    iv = (theta / np.pi * lt.env_h).to(torch.int32).clamp(0, lt.env_h - 1)
    map_pdf = (lt.env_cond_func.reshape(-1)[(iv * lt.env_w + iu).long()]
               / lt.env_marg_int.clamp_min(1e-30))
    return torch.where(
        sin_t > 1e-8,
        map_pdf / (2.0 * np.pi * np.pi * sin_t).clamp_min(1e-8), 0.0)


# --- area lights --------------------------------------------------------------

def _area_point(lt: LightTable, li_, u, uc):
    """CDF-sample a triangle of the light by `uc`, a uniform point on it by
    `u`. Returns (point, the triangle's geometric normal)."""
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
    return tv0 + te1 * b1 + te2 * b2, V3(rows[9], rows[10], rows[11])


def _sample_area(lt: LightTable, li_, inten, p_surf: V3, u, uc):
    """A point of the area light seen from p_surf. Returns (wi, li, pdf,
    dist)."""
    ps, ns = _area_point(lt, li_, u, uc)
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
    sample for an area light's triangle choice. Point, spot, projection and
    goniometric lights sit at ``lt.p`` (delta, inverse-square; the spot's
    falloff between its two cosines, the projection's and the goniometric
    light's map looked up by the light-space direction), a distant light
    shines along ``lt.p`` from ``INF_DIST``, an infinite light is sampled by
    its map's distribution and casts its shadow ray ``INF_DIST`` long."""
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
    # --- point / spot / projection / goniometric (delta, at a position) ---
    to_l = lp - p_surf
    d2 = vm.length_sq(to_l).clamp_min(1e-12)
    dist = torch.sqrt(d2)
    wi = to_l * (1.0 / dist)
    li_point = inten * (1.0 / d2)
    li_v = li_point
    if kinds & {SPOT, PROJECTION, GONIOMETRIC, INFINITE}:
        w2l = _w2l_rows(lt, li_)
    if kinds & {SPOT, PROJECTION, GONIOMETRIC}:
        # the local -wi direction and its angle to the light's axis
        wl = vm.normalize(_rows_xform_v(w2l, -wi))
        cos_t = wl.z
        ct = lt.params[:, 0][li_]
    if SPOT in kinds:
        cf = lt.params[:, 1][li_]
        delta = ((cos_t - ct) / (cf - ct).clamp_min(1e-8)).clamp(0.0, 1.0)
        d2_ = delta * delta
        falloff = torch.where(cos_t < ct, 0.0,
                              torch.where(cos_t > cf, 1.0, d2_ * d2_))
        li_v = vm.where3(kind == SPOT, li_point * falloff, li_v)
    if kinds & {PROJECTION, GONIOMETRIC}:
        hp, wp = lt.proj_map.shape[0], lt.proj_map.shape[1]
        pflat = lt.proj_map.reshape(-1, 3)
        pr, pg, pb = pflat[:, 0], pflat[:, 1], pflat[:, 2]
    if PROJECTION in kinds:
        # the map in projective coordinates
        s1 = lt.params[:, 1][li_]
        s0 = lt.params[:, 2][li_]
        pz = cos_t.clamp_min(1e-6)
        px_ = wl.x / pz
        py_ = wl.y / pz
        inside = ((cos_t > ct) & (torch.abs(px_) < s1 + 1e-9)
                  & (torch.abs(py_) < s0 + 1e-9))
        pu = (px_ / s1.clamp_min(1e-9) + 1) * 0.5
        pv = (py_ / s0.clamp_min(1e-9) + 1) * 0.5
        pxi = (pu * wp).to(torch.int32).clamp(0, wp - 1)
        pyi = (pv * hp).to(torch.int32).clamp(0, hp - 1)
        pi_ = (pyi * wp + pxi).long()
        proj_tex = V3(pr[pi_], pg[pi_], pb[pi_])
        li_v = vm.where3(kind == PROJECTION,
                         li_point * vm.where3(inside, proj_tex, 0.0), li_v)
    if GONIOMETRIC in kinds:
        # the map in lat-long coordinates of the local direction
        gphi = vm.spherical_phi(wl) * (0.5 / np.pi)
        gth = vm.spherical_theta(wl) / np.pi
        gxi = (gphi * wp).to(torch.int32).clamp(0, wp - 1)
        gyi = (gth * hp).to(torch.int32).clamp(0, hp - 1)
        gi_ = (gyi * wp + gxi).long()
        li_v = vm.where3(kind == GONIOMETRIC,
                         li_point * V3(pr[gi_], pg[gi_], pb[gi_]), li_v)
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
    is_delta = kind != AREA
    if INFINITE in kinds:
        dir_l, li_env, pdf_env = _env_sample(lt, u)
        is_env = kind == INFINITE
        wi = vm.where3(is_env, vm.normalize(_rows_xform_v_t(w2l, dir_l)), wi)
        li_v = vm.where3(is_env, li_env * inten, li_v)
        pdf = torch.where(is_env, pdf_env, pdf)
        dist = torch.where(is_env, INF_DIST, dist)
        is_delta = is_delta & ~is_env
    return LiSample(wi=wi, li=li_v, pdf=pdf, dist=dist, is_delta=is_delta)


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


class LeSample(NamedTuple):
    """A photon-emission sample."""
    o: V3                 # ray origin
    d: V3                 # ray direction
    alpha: V3             # power / (pdf_pos * pdf_dir * light_pdf)


def sample_le(lt: LightTable, geom, light_idx, light_pdf,
              u_pos, uc, u_dir) -> LeSample:
    """Emit photon rays from lights (photon shooting, VPL generation).

    light_idx (R,) int32; light_pdf (R,); u_pos / u_dir (R, 2) or V2; uc
    (R,). alpha carries radiance / intensity over all the pdfs, so that the
    sum of alpha over photons estimates the total power. Point, projection
    and goniometric lights emit uniformly over the sphere from ``lt.p``, a
    spot uniformly over its cone; distant and infinite lights from a disk
    of the scene's bounding radius; area lights cosine-weighted from a
    sampled point, offset 1e-4 along the normal."""
    u_pos = vm.from_arr2(u_pos)
    u_dir = vm.from_arr2(u_dir)
    li_ = light_idx.clamp_min(0).long()
    kind = lt.kind[li_]
    kinds = _kinds_present(lt)
    lp = _g3(lt.p, li_)
    inten = _g3(lt.intensity, li_)
    # POINT (and projection / goniometric): the whole sphere from lt.p
    o = lp
    d = smp.uniform_sample_sphere(u_dir)
    alpha = inten * (1.0 / smp.UNIFORM_SPHERE_PDF)
    if kinds & {SPOT, INFINITE}:
        w2l = _w2l_rows(lt, li_)
    if SPOT in kinds:
        # uniform over the cone about the light-space +z
        ct = lt.params[:, 0][li_]
        d_cone_l = smp.uniform_sample_cone(u_dir, ct)
        cos_s = d_cone_l.z
        cf = lt.params[:, 1][li_]
        delta = ((cos_s - ct) / (cf - ct).clamp_min(1e-8)).clamp(0.0, 1.0)
        d2_ = delta * delta
        falloff = torch.where(cos_s < ct, 0.0,
                              torch.where(cos_s > cf, 1.0, d2_ * d2_))
        is_spot = kind == SPOT
        d = vm.where3(is_spot, vm.normalize(_rows_xform_v_t(w2l, d_cone_l)),
                      d)
        alpha = vm.where3(is_spot,
                          inten * (falloff / smp.uniform_cone_pdf(ct)), alpha)
    if kinds & {DISTANT, INFINITE}:
        # origins on a disk of the scene's bounding radius about its centre
        wb = geom.world_bound
        center = V3(0.5 * (wb[0, 0] + wb[1, 0]), 0.5 * (wb[0, 1] + wb[1, 1]),
                    0.5 * (wb[0, 2] + wb[1, 2]))
        radius = 0.5 * torch.sqrt((wb[1, 0] - wb[0, 0]) ** 2
                                  + (wb[1, 1] - wb[0, 1]) ** 2
                                  + (wb[1, 2] - wb[0, 2]) ** 2) + 1e-3
        dx, dy = smp.concentric_sample_disk(u_pos)
        area_disk = np.pi * radius * radius
    if DISTANT in kinds:
        ldir = vm.normalize(lp)            # the stored direction TO the light
        t1, t2 = vm.coordinate_system(ldir)
        is_dist = kind == DISTANT
        o = vm.where3(is_dist, center + (ldir + t1 * dx + t2 * dy) * radius, o)
        d = vm.where3(is_dist, -ldir, d)
        alpha = vm.where3(is_dist, inten * area_disk, alpha)
    if AREA in kinds:
        # a sampled point, cosine-weighted about the triangle's normal
        p_area, n_area = _area_point(lt, li_, u_pos, uc)
        d_loc = smp.cosine_sample_hemisphere(u_dir)
        ta1, ta2 = vm.coordinate_system(n_area)
        is_area = kind == AREA
        o = vm.where3(is_area, p_area + n_area * 1e-4, o)
        d = vm.where3(is_area, vm.normalize(
            ta1 * d_loc.x + ta2 * d_loc.y + n_area * d_loc.z), d)
        # L cos / (pdf_pos pdf_dir) = L pi A
        alpha = vm.where3(is_area, inten * (np.pi * lt.total_area[li_]),
                          alpha)
    if INFINITE in kinds:
        # a map-sampled direction toward the scene from a far disk
        dir_l, li_env, pdf_env = _env_sample(lt, u_dir)
        d_env = -vm.normalize(_rows_xform_v_t(w2l, dir_l))
        t1e, t2e = vm.coordinate_system(d_env)
        is_env = kind == INFINITE
        o = vm.where3(is_env, center - d_env * radius
                      + (t1e * dx + t2e * dy) * radius, o)
        d = vm.where3(is_env, d_env, d)
        alpha = vm.where3(is_env, li_env * inten * (
            area_disk / pdf_env.clamp_min(1e-9)), alpha)
    alpha = alpha * (1.0 / light_pdf)
    return LeSample(o=o, d=vm.normalize(d), alpha=alpha)
