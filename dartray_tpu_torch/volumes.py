"""Volume regions: homogeneous, exponential and a 3-D density grid
(counterpart of the JAX reference's ``volumes.py``).

Regions are rows of a small table; the properties (sigma_a, sigma_s, Lve,
density, the phase function) are evaluated for whole wavefronts, one region
after another, and summed (the union of the aggregate volume). The table's
rows stay host numpy, so a region's kind, transform and coefficients enter
the device operations as float32-valued scalars and only the density grid
moves to the device: one (nz, ny, nx) array that every ``volumegrid`` region
reads (the last region's densities win), interpolated trilinearly.

An exponential region's density is a * exp(-b * h), h the height above p0
along volume-space +z: the ``updir`` parameter is not read, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from .core import math as vm
from .core import sampling as smp

HOMOGENEOUS = 0
EXPONENTIAL = 1
GRID = 2


@dataclasses.dataclass
class VolumeData:
    kind: np.ndarray       # (V,) int32
    w2v: np.ndarray        # (V, 4, 4) world -> volume space
    bounds: np.ndarray     # (V, 2, 3) in volume space
    sigma_a: np.ndarray    # (V, 3)
    sigma_s: np.ndarray    # (V, 3)
    le: np.ndarray         # (V, 3)
    g: np.ndarray          # (V,)
    params: np.ndarray     # (V, 4): exponential a, b
    grid: Any              # (nz, ny, nx) density (shared; zeros if unused)
    n: int
    grid_shape: tuple

    # the region rows are read as scalars on the host; only the grid moves
    _HOST_FIELDS = ("kind", "w2v", "bounds", "sigma_a", "sigma_s", "le", "g",
                    "params")


def build_volume(specs: List[tuple]) -> Optional[VolumeData]:
    """specs: list of (name, ParamSet, object-to-world 4x4) from the scene
    API; None when there are none."""
    if not specs:
        return None
    n = len(specs)
    kind = np.zeros(n, np.int32)
    w2v = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    bounds = np.zeros((n, 2, 3), np.float32)
    sa = np.zeros((n, 3), np.float32)
    ss = np.zeros((n, 3), np.float32)
    le = np.zeros((n, 3), np.float32)
    g = np.zeros(n, np.float32)
    params = np.zeros((n, 4), np.float32)
    grid = np.zeros((1, 1, 1), np.float32)
    grid_shape = (1, 1, 1)
    for i, (name, p, o2w) in enumerate(specs):
        w2v[i] = np.linalg.inv(np.asarray(o2w, np.float64)).astype(np.float32)
        p0 = p.find_one_point("p0", (0, 0, 0))
        p1 = p.find_one_point("p1", (1, 1, 1))
        bounds[i, 0] = np.minimum(p0, p1)
        bounds[i, 1] = np.maximum(p0, p1)
        sa[i] = p.find_one_spectrum("sigma_a", (1.0,) * 3)
        ss[i] = p.find_one_spectrum("sigma_s", (1.0,) * 3)
        le[i] = p.find_one_spectrum("Le", (0.0,) * 3)
        g[i] = p.find_one_float("g", 0.0)
        if name == "homogeneous":
            kind[i] = HOMOGENEOUS
        elif name == "exponential":
            kind[i] = EXPONENTIAL
            params[i, 0] = p.find_one_float("a", 1.0)
            params[i, 1] = p.find_one_float("b", 1.0)
        elif name == "volumegrid":
            kind[i] = GRID
            nx = p.find_one_int("nx", 1)
            ny = p.find_one_int("ny", 1)
            nz = p.find_one_int("nz", 1)
            d = p.find_floats("density")
            if d is not None:
                grid = np.asarray(d, np.float32).reshape(nz, ny, nx)
                grid_shape = (nz, ny, nx)
        else:
            raise ValueError(f"unknown volume {name!r}")
    return VolumeData(kind=kind, w2v=w2v, bounds=bounds, sigma_a=sa,
                      sigma_s=ss, le=le, g=g, params=params, grid=grid, n=n,
                      grid_shape=grid_shape)


def _density(vol: VolumeData, i: int, p: vm.V3):
    """Density multiplier of region i at volume-space points p: 0 outside
    its bounds."""
    lo = vol.bounds[i, 0]
    hi = vol.bounds[i, 1]
    f = lambda a: float(a)
    inside = ((p.x >= f(lo[0])) & (p.x <= f(hi[0]))
              & (p.y >= f(lo[1])) & (p.y <= f(hi[1]))
              & (p.z >= f(lo[2])) & (p.z <= f(hi[2])))
    kind = int(vol.kind[i])
    if kind == HOMOGENEOUS:
        return torch.where(inside, 1.0, 0.0)
    if kind == EXPONENTIAL:
        a = f(vol.params[i, 0])
        b = f(vol.params[i, 1])
        d = a * torch.exp(-b * (p.z - f(lo[2])))
        return torch.where(inside, d, 0.0)
    # trilinear over the region's [p0, p1], voxel centres at +0.5
    nz, ny, nx = vol.grid_shape
    ext = np.maximum(hi - lo, np.float32(1e-9))
    gx = (p.x - f(lo[0])) / f(ext[0]) * nx - 0.5
    gy = (p.y - f(lo[1])) / f(ext[1]) * ny - 0.5
    gz = (p.z - f(lo[2])) / f(ext[2]) * nz - 0.5
    x0 = torch.floor(gx).to(torch.int32).clamp(0, nx - 1)
    y0 = torch.floor(gy).to(torch.int32).clamp(0, ny - 1)
    z0 = torch.floor(gz).to(torch.int32).clamp(0, nz - 1)
    x1 = (x0 + 1).clamp_max(nx - 1)
    y1 = (y0 + 1).clamp_max(ny - 1)
    z1 = (z0 + 1).clamp_max(nz - 1)
    fx = (gx - x0).clamp(0.0, 1.0)
    fy = (gy - y0).clamp(0.0, 1.0)
    fz = (gz - z0).clamp(0.0, 1.0)
    g_ = vol.grid
    at = lambda z, y, x: g_[z.long(), y.long(), x.long()]
    c00 = at(z0, y0, x0) * (1 - fx) + at(z0, y0, x1) * fx
    c01 = at(z0, y1, x0) * (1 - fx) + at(z0, y1, x1) * fx
    c10 = at(z1, y0, x0) * (1 - fx) + at(z1, y0, x1) * fx
    c11 = at(z1, y1, x0) * (1 - fx) + at(z1, y1, x1) * fx
    d = (c00 * (1 - fy) + c01 * fy) * (1 - fz) + (c10 * (1 - fy)
                                                  + c11 * fy) * fz
    return torch.where(inside, d, 0.0)


def _to_local(vol: VolumeData, i: int, p):
    return vm.xform_point3(vol.w2v[i], vm.from_arr(p))


def _weighted(vol: VolumeData, p, coef):
    """sum over regions of density * coef[i] (a (V, 3) table): V3."""
    p = vm.from_arr(p)
    out = vm.v3zeros(p.x.shape, p.x.device)
    for i in range(vol.n):
        d = _density(vol, i, _to_local(vol, i, p))
        c = coef[i]
        out = out + vm.V3(d * float(c[0]), d * float(c[1]), d * float(c[2]))
    return out


def sigma_t(vol: VolumeData, p, _w=None):
    """V3 extinction at world points p (sum over regions)."""
    return _weighted(vol, p, vol.sigma_a + vol.sigma_s)


def sigma_s(vol: VolumeData, p, _w=None):
    return _weighted(vol, p, vol.sigma_s)


def lve(vol: VolumeData, p, _w=None):
    return _weighted(vol, p, vol.le)


def phase(vol: VolumeData, p, wo, wi):
    """Density-weighted Henyey-Greenstein phase function (the aggregate
    volume's p)."""
    p = vm.from_arr(p)
    out = torch.zeros(p.x.shape, device=p.x.device)
    wsum = torch.zeros_like(out)
    for i in range(vol.n):
        d = _density(vol, i, _to_local(vol, i, p))
        out = out + d * smp.hg_pdf(vm.dot(-wo, wi), vol.g[i])
        wsum = wsum + d
    return out / wsum.clamp_min(1e-9)


def intersect_bounds(vol: VolumeData, rays):
    """(t0, t1, hit): the union of the regions' [t0, t1] overlaps along
    each ray, clipped to [tmin, tmax]; 0 where a ray misses them all."""
    t0 = torch.full(rays.tmin.shape, float("inf"), device=rays.tmin.device)
    t1 = torch.full_like(t0, float("-inf"))
    ro = vm.from_arr(rays.o)
    rd = vm.from_arr(rays.d)

    def slab(oc, dc, lo_c, hi_c):
        inv = 1.0 / torch.where(torch.abs(dc) < 1e-12,
                                torch.where(dc < 0, -1e-12, 1e-12), dc)
        ta = (float(lo_c) - oc) * inv
        tb = (float(hi_c) - oc) * inv
        return torch.minimum(ta, tb), torch.maximum(ta, tb)

    for i in range(vol.n):
        m = vol.w2v[i]
        o = vm.xform_point3(m, ro)
        d = vm.xform_vector3(m, rd)
        b = vol.bounds[i]
        nx_, fx_ = slab(o.x, d.x, b[0, 0], b[1, 0])
        ny_, fy_ = slab(o.y, d.y, b[0, 1], b[1, 1])
        nz_, fz_ = slab(o.z, d.z, b[0, 2], b[1, 2])
        tn = torch.maximum(torch.maximum(nx_, ny_),
                           torch.maximum(nz_, rays.tmin))
        tf = torch.minimum(torch.minimum(fx_, fy_),
                           torch.minimum(fz_, rays.tmax))
        ok = tn <= tf
        t0 = torch.where(ok, torch.minimum(t0, tn), t0)
        t1 = torch.where(ok, torch.maximum(t1, tf), t1)
    hit = t1 > t0
    return torch.where(hit, t0, 0.0), torch.where(hit, t1, 0.0), hit


def tau(vol: VolumeData, rays, step: float, offset, n_steps: int = 64):
    """Optical thickness along [tmin, tmax] by jittered ray marching:
    n_steps equal steps over the rays' overlap with the regions, each
    sampled at (k + offset) of its length. `step` is not read: the step is
    the overlap's length over n_steps, as in the reference. offset: (R,)
    jitter in [0, 1). Returns V3."""
    del step
    t0, t1, hit = intersect_bounds(vol, rays)
    dt = ((t1 - t0) / n_steps).clamp_min(1e-8)
    acc = vm.v3zeros(rays.tmin.shape, rays.tmin.device)
    for k in range(n_steps):
        t = t0 + (float(k) + offset) * dt
        acc = acc + sigma_t(vol, rays.at(t)) * dt
    return vm.where3(hit, acc, 0.0)
