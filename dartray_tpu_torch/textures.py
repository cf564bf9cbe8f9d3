"""Texture system: every texture kind as one table (counterpart of the JAX
reference's ``textures.py``).

Constant, imagemap, uv, fbm, wrinkled, marble and windy leaves; scale, mix,
checkerboard (2D and 3D), dots and bilerp combinators over leaf children (one
combinator level, which covers the reference scenes' graphs); the uv,
spherical, cylindrical and planar 2D mappings and the 3D world-to-texture
transform. Image maps live in one flat texel pool holding every mip level,
with per-texture (offset, width, height, levels) and per-level offsets; the
pyramid is built on the host in numpy. Evaluation is masked selects over
whole wavefronts; a family absent from the table (``kinds_present``) or a
mapping nobody uses (``has_mapping``) is not computed at all.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from .core import math as vm
from .core import spectrum as spec

CONST = 0
IMAGEMAP = 1
UV = 2
FBM = 3
WRINKLED = 4
MARBLE = 5
WINDY = 6
SCALE = 7
MIX = 8
CHECKER2D = 9
CHECKER3D = 10
DOTS = 11
BILERP = 12

# 2D texture mappings, stored in params[..., 8]
MAP_UV = 0
MAP_SPHERICAL = 1
MAP_CYLINDRICAL = 2
MAP_PLANAR = 3         # vs = world2tex row 0, vt = row 1; offsets du/dv

MAX_MIP = 16


@dataclasses.dataclass
class TextureData:
    kind: Any         # (T,) int32
    value: Any        # (T, 3) const value / v00 for bilerp
    params: Any       # (T, 10): [su, sv, du, dv, octaves, omega/rough,
                      #           scale/variation, extra, map2d, spare]
    sub: Any          # (T, 2) int32 child texture ids (-1)
    img_meta: Any     # (T, 4) int32 [offset, width, height, n_levels]
    mip_off: Any      # (T, MAX_MIP) int32 per-level pool offsets
    texels: Any       # (P, 3) flat texel pool (all mip levels)
    world2tex: Any    # (T, 4, 4) 3D-mapping transform
    n: int = 0
    kinds_present: tuple = (CONST,)   # sorted kinds in the table
    has_mapping: bool = False         # any non-UV 2D mapping present


def _round_up_pow2(x):
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


def _lanczos_resample_1d(img, new_n, axis):
    """Separable Lanczos-windowed sinc resample to a pow-2 size (tau = 2,
    4 taps)."""
    old_n = img.shape[axis]
    if old_n == new_n:
        return img
    filt = 2.0
    centers = (np.arange(new_n) + 0.5) * old_n / new_n
    first = np.floor(centers - filt + 0.5).astype(np.int64)
    offs = np.arange(4)
    pos = first[:, None] + offs[None, :]                    # (new_n, 4)
    x = np.abs(pos + 0.5 - centers[:, None]) / filt
    x = np.minimum(x, 1.0 - 1e-6)
    w = np.sinc(x) * np.sinc(x)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-9)
    pos = np.clip(pos, 0, old_n - 1)
    moved = np.moveaxis(img, axis, 0)                       # (old_n, ...)
    out = np.einsum("nk,nk...->n...", w, moved[pos])
    return np.moveaxis(out, 0, axis)


def build_pyramid(image: np.ndarray):
    """Full mip pyramid: pow-2 Lanczos resample, then 2x2 box levels down to
    1x1. Returns a list of (H_l, W_l, 3) arrays."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[0], img.shape[1]
    pw, ph = _round_up_pow2(w), _round_up_pow2(h)
    if (pw, ph) != (w, h):
        img = _lanczos_resample_1d(img, pw, axis=1)
        img = _lanczos_resample_1d(img, ph, axis=0)
    levels = [img]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        prev = levels[-1]
        p = prev
        if prev.shape[0] > 1 and prev.shape[0] % 2:
            p = p[:-1]
        if prev.shape[1] > 1 and prev.shape[1] % 2:
            p = p[:, :-1]
        if prev.shape[0] == 1:
            nxt = 0.5 * (p[:, 0::2] + p[:, 1::2])
        elif prev.shape[1] == 1:
            nxt = 0.5 * (p[0::2] + p[1::2])
        else:
            nxt = 0.25 * (p[0::2, 0::2] + p[1::2, 0::2]
                          + p[0::2, 1::2] + p[1::2, 1::2])
        levels.append(nxt.astype(np.float32))
        if len(levels) >= MAX_MIP:
            break
    return levels


class TextureBuilder:
    """The texture table, one row per ``add`` (the scene API adds one per
    ``Texture`` statement, and one per constant child of a combinator)."""

    def __init__(self):
        self.rows: List[dict] = []
        self.pool: List[np.ndarray] = []
        self.pool_len = 0

    def add(self, kind, value=(0.0, 0.0, 0.0),
            params=(1, 1, 0, 0, 8, 0.5, 1, 0), sub=(-1, -1),
            image: Optional[np.ndarray] = None, world2tex=None,
            mapping: int = MAP_UV) -> int:
        off, w, h, nlev = 0, 0, 0, 0
        mip_off = np.zeros(MAX_MIP, np.int32)
        if image is not None:
            levels = build_pyramid(image)
            nlev = len(levels)
            off = self.pool_len
            h, w = levels[0].shape[0], levels[0].shape[1]
            for li, lv in enumerate(levels):
                mip_off[li] = self.pool_len
                flat = lv.reshape(-1, 3)
                self.pool.append(flat)
                self.pool_len += flat.shape[0]
            mip_off[nlev:] = mip_off[nlev - 1]
        p = np.zeros(10, np.float32)
        p[:len(params)] = params
        p[8] = float(mapping)
        self.rows.append(dict(
            kind=kind, value=np.asarray(value, np.float32), params=p,
            sub=np.asarray(sub, np.int32),
            img_meta=np.asarray([off, w, h, nlev], np.int32),
            mip_off=mip_off,
            world2tex=np.eye(4, dtype=np.float32) if world2tex is None
            else np.asarray(world2tex, np.float32)))
        return len(self.rows) - 1

    def build(self) -> TextureData:
        if not self.rows:
            self.add(CONST, (1.0, 1.0, 1.0))
        # a resampled finest level is float64 on the host: the table holds
        # float32, as the reference's device copy does
        texels = (np.concatenate(self.pool).astype(np.float32) if self.pool
                  else np.zeros((1, 3), np.float32))
        if spec.mode() == "sampled":
            # image files are RGB: texels become band averages
            texels = spec.rgb_to_bands(texels).astype(np.float32)
        col = lambda k, dt=np.float32: \
            np.stack([r[k] for r in self.rows]).astype(dt)
        return TextureData(
            kind=np.asarray([r["kind"] for r in self.rows], np.int32),
            value=col("value"), params=col("params"),
            sub=col("sub", np.int32), img_meta=col("img_meta", np.int32),
            mip_off=col("mip_off", np.int32),
            texels=texels, world2tex=col("world2tex"),
            n=len(self.rows),
            kinds_present=tuple(sorted({r["kind"] for r in self.rows})),
            has_mapping=any(float(r["params"][8]) != 0.0
                            for r in self.rows))


# --- Perlin noise ------------------------------------------------------------
# the reference's permutation and gradient tables, drawn on the host from the
# same seeds

_PERM = np.random.RandomState(151).permutation(256)
_PERM2 = np.concatenate([_PERM, _PERM]).astype(np.int32)
_G = np.random.RandomState(7).randn(256, 3)
_G /= np.linalg.norm(_G, axis=-1, keepdims=True)
_NOISE_TABLES = {}
# the lattice corners in the order the reference sums them
_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def _noise_tables(device):
    """(perm (512,) long, gradients (256, 3) float32, corner offsets
    (3, 8) int32) on `device`, made once per device."""
    key = str(device)
    if key not in _NOISE_TABLES:
        _NOISE_TABLES[key] = (
            torch.as_tensor(_PERM2, dtype=torch.long, device=device),
            torch.as_tensor(_G, dtype=torch.float32, device=device),
            torch.as_tensor(np.asarray(_CORNERS, np.int32).T,
                            device=device))
    return _NOISE_TABLES[key]


def perlin(p):
    """Classic gradient noise at V3 points (tensors of any shape), in
    [-1, 1]. The eight lattice corners are hashed and dotted in one batch;
    each corner's value is the reference's to the bit."""
    p = vm.from_arr(p)
    perm, grad, corners = _noise_tables(p.x.device)
    off = corners.reshape(3, 8, *(1,) * p.x.dim())
    fl = [torch.floor(c) for c in p]
    pf = [c - f for c, f in zip(p, fl)]
    idx = [((f.to(torch.int32) + o) & 255).long() for f, o in zip(fl, off)]
    h = perm[perm[perm[idx[0]] + idx[1]] + idx[2]]      # (8, ...)
    g = grad[h]                                         # (8, ..., 3)
    offf = off.to(torch.float32)
    d = (g[..., 0] * (pf[0] - offf[0]) + g[..., 1] * (pf[1] - offf[1])
         + g[..., 2] * (pf[2] - offf[2]))
    sm = lambda t: t * t * t * (t * (t * 6.0 - 15.0) + 10.0)  # smootherstep
    wx, wy, wz = (sm(t) for t in pf)

    def lerp(t, a, b):
        return a + t * (b - a)

    x00 = lerp(wx, d[0], d[1])
    x10 = lerp(wx, d[2], d[3])
    x01 = lerp(wx, d[4], d[5])
    x11 = lerp(wx, d[6], d[7])
    y0 = lerp(wy, x00, x10)
    y1 = lerp(wy, x01, x11)
    return lerp(wz, y0, y1)


def _octaves(p, octaves, omega, shape):
    """sum_k omega^k shape(perlin(p * 1.99^k)), every octave's noise in one
    batch, summed in the reference's order."""
    p = vm.from_arr(p)
    lams = [1.99 ** 0]
    for _ in range(int(octaves) - 1):
        lams.append(lams[-1] * 1.99)
    n = shape(perlin(vm.V3(*(torch.stack([c * lam for lam in lams])
                            for c in p))))
    out = torch.zeros_like(p.x)
    o = 1.0
    for k in range(int(octaves)):
        out = out + o * n[k]
        o *= omega
    return out


def fbm(p, octaves=8, omega=0.5):
    """Fixed-octave fractal sum of ``perlin``. p: V3."""
    return _octaves(p, octaves, omega, lambda n: n)


def turbulence(p, octaves=8, omega=0.5):
    return _octaves(p, octaves, omega, torch.abs)


# --- evaluation --------------------------------------------------------------
# colors flow as component-SoA V3; it["uv"] is a V2 and it["p"] a V3. Texture
# ids (tid) are long tensors inside this module.

def _xform_pt(tex: TextureData, tid, p):
    """Per-ray world2tex point transform with component gathers."""
    w = tex.world2tex
    m = [[w[:, i, j][tid] for j in range(4)] for i in range(3)]
    return vm.V3(m[0][0] * p.x + m[0][1] * p.y + m[0][2] * p.z + m[0][3],
                 m[1][0] * p.x + m[1][1] * p.y + m[1][2] * p.z + m[1][3],
                 m[2][0] * p.x + m[2][1] * p.y + m[2][2] * p.z + m[2][3])


def _map_uv(tex: TextureData, tid, it):
    """2D mapping -> (u, v) per ray. MAP_UV: u = su*u + du. MAP_SPHERICAL:
    theta/pi, phi/2pi of the world2tex-transformed point. MAP_CYLINDRICAL:
    phi/2pi, z. MAP_PLANAR: p.vs + du, p.vt + dv with vs/vt as world2tex
    rows 0/1."""
    su = tex.params[:, 0][tid]
    sv = tex.params[:, 1][tid]
    du = tex.params[:, 2][tid]
    dv = tex.params[:, 3][tid]
    uv = it["uv"]
    u0 = uv.x * su + du
    v0 = uv.y * sv + dv
    if not tex.has_mapping:
        return u0, v0
    mode = tex.params[:, 8][tid].to(torch.int32)
    pt = _xform_pt(tex, tid, it["p"])
    r_len = torch.sqrt((pt.x * pt.x + pt.y * pt.y + pt.z * pt.z)
                       .clamp_min(1e-18))
    theta = torch.arccos((pt.z / r_len).clamp(-1.0, 1.0))
    phi = torch.atan2(pt.y, pt.x)
    phi = torch.where(phi < 0, phi + 2.0 * np.pi, phi)
    u_s = theta * (1.0 / np.pi)
    v_s = phi * (0.5 / np.pi)
    u_c = phi * (0.5 / np.pi)
    v_c = pt.z
    u_p = pt.x + du
    v_p = pt.y + dv
    u = torch.where(mode == MAP_SPHERICAL, u_s,
                    torch.where(mode == MAP_CYLINDRICAL, u_c,
                                torch.where(mode == MAP_PLANAR, u_p, u0)))
    v = torch.where(mode == MAP_SPHERICAL, v_s,
                    torch.where(mode == MAP_CYLINDRICAL, v_c,
                                torch.where(mode == MAP_PLANAR, v_p, v0)))
    return u, v


def _bilinear_level(tex: TextureData, tid, u, v, level):
    """Bilinear lookup at an integer mip level (int32 (R,)), repeat wrap.
    Returns V3."""
    w0 = tex.img_meta[:, 1][tid]
    h0 = tex.img_meta[:, 2][tid]
    off = tex.mip_off[tid, level.long()]
    w = (w0 >> level).clamp_min(1)
    h = (h0 >> level).clamp_min(1)
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    uu = (u % 1.0) * wf - 0.5
    vv = (v % 1.0) * hf - 0.5
    x0 = torch.floor(uu).to(torch.int32)
    y0 = torch.floor(vv).to(torch.int32)
    fx = uu - x0
    fy = vv - y0
    tr, tg, tb = tex.texels[:, 0], tex.texels[:, 1], tex.texels[:, 2]

    def at(x, y):
        xm = torch.where(w0 > 0, x % w, 0)
        ym = torch.where(h0 > 0, y % h, 0)
        i = (off + ym * w + xm).long()
        return vm.V3(tr[i], tg[i], tb[i])

    c00 = at(x0, y0)
    c10 = at(x0 + 1, y0)
    c01 = at(x0, y0 + 1)
    c11 = at(x0 + 1, y0 + 1)
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def _img_lookup(tex: TextureData, tid, u, v, width=None):
    """Trilinear mip lookup: level = nLevels-1 + log2(max(width, tiny)),
    lerped between the two bracketing bilinear levels. width = uv-space
    footprint from ray differentials (None: the finest level, the
    no-differentials behaviour)."""
    nlev = tex.img_meta[:, 3][tid]
    if width is None:
        return _bilinear_level(tex, tid, u, v, torch.zeros_like(nlev))
    top = (nlev - 1).clamp_min(0)
    lvl_f = (nlev - 1).to(torch.float32) + torch.log2(width.clamp_min(1e-8))
    lvl_f = torch.minimum(lvl_f.clamp_min(0.0), top.to(torch.float32))
    l0 = torch.floor(lvl_f).to(torch.int32)
    l1 = torch.minimum(l0 + 1, top)
    t = lvl_f - l0
    c0 = _bilinear_level(tex, tid, u, v, l0)
    c1 = _bilinear_level(tex, tid, u, v, l1)
    return c0 * (1 - t) + c1 * t


ANISO_PROBES = 4       # fixed probe count in place of the data-dependent
MAX_ANISO = 8.0        # EWA texel loop


def _img_lookup_aniso(tex: TextureData, tid, u, v, duv):
    """Anisotropic imagemap filtering: ANISO_PROBES trilinear probes spaced
    along the MAJOR footprint axis at the mip level the MINOR axis chooses,
    Gaussian-weighted; anisotropy clamped to MAX_ANISO by widening the minor
    axis.

    duv: 4-tuple (dudx, dvdx, dudy, dvdy) of (R,) uv-footprint axes."""
    dudx, dvdx, dudy, dvdy = duv
    l0 = dudx * dudx + dvdx * dvdx
    l1 = dudy * dudy + dvdy * dvdy
    swap = l1 > l0
    major_u = torch.where(swap, dudy, dudx)
    major_v = torch.where(swap, dvdy, dvdx)
    maj_len = torch.sqrt(torch.maximum(l0, l1).clamp_min(1e-16))
    min_len = torch.sqrt(torch.minimum(l0, l1).clamp_min(1e-16))
    min_len = torch.maximum(min_len, maj_len / MAX_ANISO)
    acc = None
    wsum = 0.0
    for i in range(ANISO_PROBES):
        t = (i + 0.5) / ANISO_PROBES - 0.5          # [-0.5, 0.5)
        w_i = float(np.exp(-2.0 * (2.0 * t) ** 2))  # gaussian falloff
        c = _img_lookup(tex, tid, u + major_u * t, v + major_v * t, min_len)
        acc = c * w_i if acc is None else acc + c * w_i
        wsum += w_i
    return acc * (1.0 / wsum)


def _value3(tex: TextureData, tid):
    return vm.V3(tex.value[:, 0][tid], tex.value[:, 1][tid],
                 tex.value[:, 2][tid])


def _eval_leaf(tex: TextureData, tid, it):
    """Every leaf kind present in the table for all rays (masked select).
    Returns V3."""
    present = set(tex.kinds_present)
    kind = tex.kind[tid]
    su = tex.params[:, 0][tid]
    sv = tex.params[:, 1][tid]
    u, v = _map_uv(tex, tid, it)
    out = _value3(tex, tid)                                # CONST
    if IMAGEMAP in present:
        duv = it.get("tex_duv")
        if duv is not None:
            # the uv footprint axes scaled by the mapping scale
            sc = (duv[0] * su, duv[1] * sv, duv[2] * su, duv[3] * sv)
            img = _img_lookup_aniso(tex, tid, u, v, sc) * _value3(tex, tid)
        else:
            width = it.get("tex_width")
            if width is not None:
                width = width * torch.maximum(torch.abs(su), torch.abs(sv))
            img = _img_lookup(tex, tid, u, v, width) * _value3(tex, tid)
        out = vm.where3(kind == IMAGEMAP, img, out)
    if UV in present:
        uvv = vm.V3(u % 1.0, v % 1.0, torch.zeros_like(u))
        out = vm.where3(kind == UV, uvv, out)
    if present & {FBM, WRINKLED, MARBLE, WINDY}:
        pt = _xform_pt(tex, tid, it["p"])
        octv = 8
        if FBM in present:
            fv = fbm(pt, octv, 0.5)
            out = vm.where3(kind == FBM, _value3(tex, tid) * fv, out)
        if WRINKLED in present:
            t = turbulence(pt, octv, 0.5)
            out = vm.where3(kind == WRINKLED, _value3(tex, tid) * t, out)
        if MARBLE in present:
            p6 = tex.params[:, 6][tid]
            p7 = tex.params[:, 7][tid]
            scale_ = torch.where(p6 == 0.0, 1.0, p6)
            var = torch.where(p7 == 0.0, 0.2, p7)
            mar = torch.sin(pt.y * scale_
                            + var * fbm(pt * scale_, octv, 0.5))
            mar01 = 0.5 + 0.5 * mar
            marble_rgb = vm.V3(0.35 + 0.6 * mar01, 0.3 + 0.5 * mar01,
                               0.27 + 0.4 * mar01)
            out = vm.where3(kind == MARBLE, marble_rgb, out)
        if WINDY in present:
            wind = torch.abs(fbm(pt * 0.1, 3, 0.5)) * fbm(pt, 6, 0.5)
            out = vm.where3(kind == WINDY, vm.V3(wind, wind, wind), out)
    return out


_COMBINATORS = {SCALE, MIX, CHECKER2D, CHECKER3D, DOTS, BILERP}


def evaluate(tex: TextureData, tid, it):
    """Leaves + one combinator level, each family only where the table has
    it. Returns V3."""
    present = set(tex.kinds_present)
    tid = tid.clamp_min(0).long()
    kind = tex.kind[tid]
    out = _eval_leaf(tex, tid, it)
    if not (present & _COMBINATORS):
        return out
    sub1 = tex.sub[:, 0][tid].clamp_min(0).long()
    sub2 = tex.sub[:, 1][tid].clamp_min(0).long()
    c1 = _eval_leaf(tex, sub1, it)
    c2 = _eval_leaf(tex, sub2, it)
    u, v = _map_uv(tex, tid, it)
    if SCALE in present:
        out = vm.where3(kind == SCALE, c1 * c2, out)
    if MIX in present:
        amt = tex.params[:, 4][tid]
        out = vm.where3(kind == MIX, c1 * (1 - amt) + c2 * amt, out)
    if CHECKER2D in present:
        # point-sampled
        check = ((torch.floor(u) + torch.floor(v)).to(torch.int32) % 2) == 0
        out = vm.where3(kind == CHECKER2D, vm.where3(check, c1, c2), out)
    if CHECKER3D in present:
        pt = _xform_pt(tex, tid, it["p"])
        check3 = ((torch.floor(pt.x) + torch.floor(pt.y)
                   + torch.floor(pt.z)).to(torch.int32) % 2) == 0
        out = vm.where3(kind == CHECKER3D, vm.where3(check3, c1, c2), out)
    if DOTS in present:
        cx = torch.floor(u + 0.5)
        cy = torch.floor(v + 0.5)
        rad = 0.35
        zero = torch.zeros_like(cx)
        jx = perlin(vm.V3(cx + 0.5, cy + 0.5, zero)) * 0.5
        jy = perlin(vm.V3(cx + 1.5, cy + 2.8, zero)) * 0.5
        inside = ((u - (cx + jx)) ** 2 + (v - (cy + jy)) ** 2) < rad * rad
        out = vm.where3(kind == DOTS, vm.where3(inside, c1, c2), out)
    if BILERP in present:
        v00 = _value3(tex, tid)
        v01 = vm.V3(tex.params[:, 4][tid], tex.params[:, 5][tid],
                    tex.params[:, 6][tid])
        p7 = tex.params[:, 7][tid]
        v10 = vm.V3(p7, p7, p7)
        bl = (v00 * ((1 - u) * (1 - v)) + v01 * ((1 - u) * v)
              + v10 * (u * (1 - v)) + c1 * (u * v))
        out = vm.where3(kind == BILERP, bl, out)
    return out


def eval_or(tex: Optional[TextureData], tid, it, fallback):
    """Evaluate textures where tid >= 0, else use the fallback (V3)."""
    if tex is None:
        return fallback
    return vm.where3(tid >= 0, evaluate(tex, tid, it), fallback)


def eval_or_scalar(tex: Optional[TextureData], tid, it, fallback):
    """Scalar-parameter texture override: first channel, (R,) in/out."""
    if tex is None:
        return fallback
    return torch.where(tid >= 0, evaluate(tex, tid, it).x, fallback)
