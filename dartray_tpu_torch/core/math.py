"""Vectorized 3D math over SoA tensors (counterpart of
the JAX reference's ``core/math.py``).

Vectors, points, normals and colors on the wavefront are component-SoA
NamedTuples (``V3``/``V2``) of ``(R,)`` float32 tensors; rays are SoA
NamedTuples of tensors so a whole wavefront lives in a few flat buffers and
neighbouring threads touch neighbouring addresses.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

F32 = torch.float32
INF = float("inf")
EPS = float(np.float32(1e-7))
MACHINE_EPSILON = float(np.finfo(np.float32).eps) * 0.5


class V3(NamedTuple):
    """Component-SoA 3-vector / RGB color: three (R,) tensors."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __rtruediv__(self, o):
        return V3(o / self.x, o / self.y, o / self.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    @property
    def shape(self):
        return tuple(self.x.shape)


class V2(NamedTuple):
    """Component-SoA 2-vector (uv coords, 2D samples)."""
    x: torch.Tensor
    y: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V2):
            return V2(self.x + o.x, self.y + o.y)
        return V2(self.x + o, self.y + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V2):
            return V2(self.x - o.x, self.y - o.y)
        return V2(self.x - o, self.y - o)

    def __mul__(self, o):
        if isinstance(o, V2):
            return V2(self.x * o.x, self.y * o.y)
        return V2(self.x * o, self.y * o)

    __rmul__ = __mul__

    @property
    def shape(self):
        return tuple(self.x.shape)


def v3zeros(shape, device):
    z = torch.zeros(shape, dtype=F32, device=device)
    return V3(z, z, z)


def v3ones(shape, device):
    o = torch.ones(shape, dtype=F32, device=device)
    return V3(o, o, o)


def from_arr(a):
    """(..., 3) tensor -> V3 (boundary adapter; avoid in hot loops)."""
    if isinstance(a, V3):
        return a
    return V3(a[..., 0], a[..., 1], a[..., 2])


def to_arr(v):
    """V3 -> (..., 3) tensor (boundary adapter)."""
    if not isinstance(v, V3):
        return v
    return torch.stack([v.x, v.y, v.z], dim=-1)


def from_arr2(a):
    if isinstance(a, V2):
        return a
    return V2(a[..., 0], a[..., 1])


def where3(m, a, b):
    """Masked select; a/b may be V3 or scalar."""
    ax, ay, az = (a.x, a.y, a.z) if isinstance(a, V3) else (a, a, a)
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, V3) else (b, b, b)
    return V3(torch.where(m, ax, bx), torch.where(m, ay, by),
              torch.where(m, az, bz))


def dot(a, b):
    return a.x * b.x + a.y * b.y + a.z * b.z


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length_sq(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_sq(v))


def normalize(v):
    """Safe normalize: zero vectors stay zero (no NaN poisoning)."""
    return v * torch.rsqrt(length_sq(v).clamp_min(1e-30))


def distance(a, b):
    return length(b - a)


def distance_sq(a, b):
    return length_sq(b - a)


def face_forward(n, v):
    """Flip n to lie in the hemisphere of v."""
    return where3(dot(n, v) < 0.0, -n, n)


def coordinate_system(v1):
    """Orthonormal basis around v1: returns (v2, v3) with v1 x v2 = v3."""
    x, y, z = v1.x, v1.y, v1.z
    big_x = torch.abs(x) > torch.abs(y)
    inv_a = torch.rsqrt(
        torch.where(big_x, x * x + z * z, y * y + z * z).clamp_min(1e-30))
    zero = torch.zeros_like(x)
    v2 = where3(big_x, V3(-z * inv_a, zero, x * inv_a),
                V3(zero, z * inv_a, -y * inv_a))
    return v2, cross(v1, v2)


def spherical_direction(sintheta, costheta, phi) -> V3:
    return V3(sintheta * torch.cos(phi), sintheta * torch.sin(phi), costheta)


def spherical_direction_basis(sintheta, costheta, phi, x: V3, y: V3,
                              z: V3) -> V3:
    """The direction of spherical_direction in the frame (x, y, z)."""
    return (x * (sintheta * torch.cos(phi)) + y * (sintheta * torch.sin(phi))
            + z * costheta)


def spherical_theta(v: V3):
    return torch.arccos(v.z.clamp(-1.0, 1.0))


def spherical_phi(v: V3):
    p = torch.atan2(v.y, v.x)
    return torch.where(p < 0.0, p + 2.0 * np.pi, p)


def xform_point3(m, p: V3) -> V3:
    """Apply a (4,4) host matrix (numpy) to a V3 point wavefront; the matrix
    entries enter as float32-valued Python scalars."""
    f = lambda i, j: float(m[i][j])
    return V3(f(0, 0) * p.x + f(0, 1) * p.y + f(0, 2) * p.z + f(0, 3),
              f(1, 0) * p.x + f(1, 1) * p.y + f(1, 2) * p.z + f(1, 3),
              f(2, 0) * p.x + f(2, 1) * p.y + f(2, 2) * p.z + f(2, 3))


def xform_vector3(m, v: V3) -> V3:
    f = lambda i, j: float(m[i][j])
    return V3(f(0, 0) * v.x + f(0, 1) * v.y + f(0, 2) * v.z,
              f(1, 0) * v.x + f(1, 1) * v.y + f(1, 2) * v.z,
              f(2, 0) * v.x + f(2, 1) * v.y + f(2, 2) * v.z)


def xform_vector3_rows(mr, v: V3) -> V3:
    """Per-ray matrices as a V3 of V3 rows: mr[i][j] is the (R,) tensor of
    matrix entry (i, j)."""
    return V3(mr[0][0] * v.x + mr[0][1] * v.y + mr[0][2] * v.z,
              mr[1][0] * v.x + mr[1][1] * v.y + mr[1][2] * v.z,
              mr[2][0] * v.x + mr[2][1] * v.y + mr[2][2] * v.z)


def lerp(t, a, b):
    return a + t * (b - a)


def quadratic(a, b, c):
    """Stable quadratic solve, branch-free: (has_roots, t0, t1) with
    t0 <= t1; where has_roots is False, t0 / t1 are garbage."""
    disc = b * b - 4.0 * a * c
    has = disc >= 0.0
    root = torch.sqrt(disc.clamp_min(0.0))
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    # guard the divisions; masked out where has is False or degenerate
    t0 = q / torch.where(torch.abs(a) < 1e-30, 1.0, a)
    t1 = c / torch.where(torch.abs(q) < 1e-30, 1.0, q)
    return has, torch.minimum(t0, t1), torch.maximum(t0, t1)


class Rays(NamedTuple):
    """SoA ray wavefront: o, d are V3 of (N,) tensors; tmin/tmax/time (N,).
    A lane with tmax < tmin is dead and is skipped by the traversal."""
    o: V3
    d: V3
    tmin: torch.Tensor
    tmax: torch.Tensor
    time: torch.Tensor

    @property
    def n(self):
        return self.o.x.shape[0]

    def at(self, t):
        return self.o + self.d * t


def make_rays(o, d, tmin=None, tmax=None, time=None):
    o = from_arr(o)
    d = from_arr(d)
    n = o.x.shape[0]
    dev = o.x.device

    def plane(v, default):
        if v is None:
            v = default
        if not torch.is_tensor(v):
            return torch.full((n,), float(v), dtype=F32, device=dev)
        if v.dim() == 0:
            return v.to(F32).expand(n).contiguous()
        return v

    return Rays(o=o, d=d, tmin=plane(tmin, 0.0), tmax=plane(tmax, INF),
                time=plane(time, 0.0))


# --- BBox ops on (2, 3) or (N, 2, 3) tensors ---------------------------------

def bbox_empty(device):
    """The empty box: lo = +inf, hi = -inf."""
    return torch.tensor([[INF] * 3, [-INF] * 3], dtype=F32, device=device)


def bbox_union(a, b):
    return torch.stack([torch.minimum(a[..., 0, :], b[..., 0, :]),
                        torch.maximum(a[..., 1, :], b[..., 1, :])], dim=-2)


def bbox_union_point(b, p):
    return torch.stack([torch.minimum(b[..., 0, :], p),
                        torch.maximum(b[..., 1, :], p)], dim=-2)


def bbox_surface_area(b):
    d = (b[..., 1, :] - b[..., 0, :]).clamp_min(0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def bbox_intersect_p(bounds_lo, bounds_hi, o, inv_d, tmin, tmax):
    """Slab test over trailing-3 tensors (all broadcast); the hit mask."""
    t0 = (bounds_lo - o) * inv_d
    t1 = (bounds_hi - o) * inv_d
    t_enter = torch.maximum(torch.minimum(t0, t1).amax(-1), tmin)
    t_exit = torch.minimum(torch.maximum(t0, t1).amin(-1), tmax)
    return t_enter <= t_exit
