"""4x4 transforms built on the host (counterpart of the JAX reference's
``core/transform.py``).

A Transform is a pair of (4, 4) float32 numpy arrays (m, m_inv). Scene
compilation composes them on the host; wavefront code receives the final
matrices and applies them component-wise (``core.math.xform_point3``).
Quaternions, their slerp and the two-keyframe ``AnimatedTransform`` (a
polar decomposition of each key) are here too; ``interpolate_matrix`` is
the only part that runs on a wave's tensors.
"""
from __future__ import annotations

import math as _pymath
from typing import NamedTuple

import numpy as np
import torch


class Transform(NamedTuple):
    m: np.ndarray       # (4, 4)
    m_inv: np.ndarray   # (4, 4)

    def inverse(self):
        return Transform(self.m_inv, self.m)

    def __mul__(self, other: "Transform"):
        """Composition t1 * t2 applies t2 first."""
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def xform_point(self, p):
        """(..., 3) float32 points, homogeneous divide included."""
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3] + self.m[3, 3]
        w = np.where(np.abs(w) < 1e-30, np.float32(1.0), w)
        return r / np.asarray(w, r.dtype)[..., None]

    def swaps_handedness(self):
        return np.linalg.det(np.asarray(self.m)[:3, :3]) < 0.0

    def has_scale(self):
        la = np.sum(np.asarray(self.m)[:3, :3] ** 2, axis=1)
        return bool(np.any(np.abs(la - 1.0) > 1e-3))


def identity() -> Transform:
    return Transform(np.eye(4, dtype=np.float32),
                     np.eye(4, dtype=np.float32))


def from_matrix(m) -> Transform:
    m = np.asarray(m, np.float32).reshape(4, 4)
    return Transform(m, np.linalg.inv(m).astype(np.float32))


def translate(d) -> Transform:
    d = np.asarray(d, np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = d
    mi = np.eye(4, dtype=np.float32)
    mi[:3, 3] = -d
    return Transform(m, mi)


def scale(x, y, z) -> Transform:
    s = np.asarray([x, y, z], np.float32)
    m = np.diag(np.concatenate([s, np.ones(1, np.float32)]))
    mi = np.diag(np.concatenate([1.0 / s, np.ones(1, np.float32)]))
    return Transform(m, mi)


def _rot(axis_idx, angle_deg):
    a = _pymath.radians(float(angle_deg))
    c, s = _pymath.cos(a), _pymath.sin(a)
    m = np.eye(4, dtype=np.float32)
    i, j = [(1, 2), (0, 2), (0, 1)][axis_idx]
    if axis_idx == 1:  # about y the sines swap sides
        m[i, i] = c; m[i, j] = s; m[j, i] = -s; m[j, j] = c
    else:
        m[i, i] = c; m[i, j] = -s; m[j, i] = s; m[j, j] = c
    return Transform(m, m.T.copy())


def rotate_x(deg) -> Transform:
    return _rot(0, deg)


def rotate_y(deg) -> Transform:
    return _rot(1, deg)


def rotate_z(deg) -> Transform:
    return _rot(2, deg)


def rotate(deg, axis) -> Transform:
    """Rotation by `deg` degrees about an arbitrary axis: built in float64,
    then rounded to float32 (the inverse is the transpose)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s = _pymath.sin(_pymath.radians(float(deg)))
    c = _pymath.cos(_pymath.radians(float(deg)))
    x, y, z = a
    m = np.eye(4)
    m[0, 0] = x * x + (1 - x * x) * c
    m[0, 1] = x * y * (1 - c) - z * s
    m[0, 2] = x * z * (1 - c) + y * s
    m[1, 0] = x * y * (1 - c) + z * s
    m[1, 1] = y * y + (1 - y * y) * c
    m[1, 2] = y * z * (1 - c) - x * s
    m[2, 0] = x * z * (1 - c) - y * s
    m[2, 1] = y * z * (1 - c) + x * s
    m[2, 2] = z * z + (1 - z * z) * c
    mj = np.asarray(m, np.float32)
    return Transform(mj, mj.T.copy())


def look_at(eye, look, up) -> Transform:
    """Camera-to-world transform."""
    eye = np.asarray(eye, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    nl = np.linalg.norm(left)
    if nl < 1e-12:
        # up parallel to dir; pick any orthogonal
        up = (np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9
              else np.array([1.0, 0.0, 0.0]))
        left = np.cross(up, d)
        nl = np.linalg.norm(left)
    left /= nl
    new_up = np.cross(d, left)
    m = np.eye(4)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    mj = np.asarray(m, np.float32)
    return Transform(mj, np.asarray(np.linalg.inv(m), np.float32))


def orthographic(znear, zfar) -> Transform:
    """Map z in [znear, zfar] to [0, 1]."""
    return scale(1.0, 1.0, 1.0 / (zfar - znear)) * translate([0.0, 0.0,
                                                             -znear])


def perspective(fov_deg, n, f) -> Transform:
    """Project z to [0,1], divide by z."""
    persp = np.asarray([
        [1, 0, 0, 0],
        [0, 1, 0, 0],
        [0, 0, f / (f - n), -f * n / (f - n)],
        [0, 0, 1, 0]], np.float32)
    inv_tan = 1.0 / _pymath.tan(_pymath.radians(float(fov_deg)) / 2.0)
    return scale(inv_tan, inv_tan, 1.0) * from_matrix(persp)


# --- Quaternions + AnimatedTransform ----------------------------------------

def quat_from_matrix(m):
    """Rotation matrix (the 3x3 block of a 4x4) -> float32 quaternion
    (x, y, z, w), by the numerically stable trace branch (host, float64)."""
    m = np.asarray(m, np.float64)
    trace = m[0, 0] + m[1, 1] + m[2, 2]
    q = np.zeros(4)
    if trace > 0.0:
        s = _pymath.sqrt(trace + 1.0)
        q[3] = s / 2.0
        s = 0.5 / s
        q[0] = (m[2, 1] - m[1, 2]) * s
        q[1] = (m[0, 2] - m[2, 0]) * s
        q[2] = (m[1, 0] - m[0, 1]) * s
    else:
        nxt = [1, 2, 0]
        i = 0
        if m[1, 1] > m[0, 0]:
            i = 1
        if m[2, 2] > m[i, i]:
            i = 2
        j, k = nxt[i], nxt[nxt[i]]
        s = _pymath.sqrt((m[i, i] - (m[j, j] + m[k, k])) + 1.0)
        qv = np.zeros(3)
        qv[i] = s * 0.5
        if s != 0.0:
            s = 0.5 / s
        q[3] = (m[k, j] - m[j, k]) * s
        qv[j] = (m[j, i] + m[i, j]) * s
        qv[k] = (m[k, i] + m[i, k]) * s
        q[:3] = qv
    return q.astype(np.float32)


def quat_to_matrix(q):
    """Quaternion tensor (..., 4) -> rotation (..., 4, 4), m[row][col]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rows = [
        [1 - 2 * (yy + zz), 2 * (xy + wz), 2 * (xz - wy), zero],
        [2 * (xy - wz), 1 - 2 * (xx + zz), 2 * (yz + wx), zero],
        [2 * (xz + wy), 2 * (yz - wx), 1 - 2 * (xx + yy), zero],
        [zero, zero, zero, one],
    ]
    m = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    # the rows above are the transpose of m[row][col]
    return m.transpose(-1, -2)


def slerp(t, q1, q2):
    """Spherical lerp of quaternion tensors (..., 4) at t (...,),
    branch-free: a normalised lerp where the two are nearly parallel."""
    cos_theta = (q1 * q2).sum(-1)
    near = cos_theta > 0.9995
    q_lin = (1.0 - t)[..., None] * q1 + t[..., None] * q2
    q_lin = q_lin / torch.linalg.vector_norm(q_lin, dim=-1, keepdim=True)
    theta = torch.arccos(cos_theta.clamp(-1.0, 1.0))
    thetap = theta * t
    qperp = q2 - q1 * cos_theta[..., None]
    qperp = qperp / torch.linalg.vector_norm(
        qperp, dim=-1, keepdim=True).clamp_min(1e-12)
    q_sl = (q1 * torch.cos(thetap)[..., None]
            + qperp * torch.sin(thetap)[..., None])
    return torch.where(near[..., None], q_lin, q_sl)


class AnimatedTransform(NamedTuple):
    """Two-keyframe animated transform, decomposed on the host into
    translation t (2, 3), rotation quaternion r (2, 4) and scale s
    (2, 4, 4), all float32 numpy; the keys themselves are kept."""
    start_time: float
    end_time: float
    t: np.ndarray
    r: np.ndarray
    s: np.ndarray
    actually_animated: bool
    start: Transform
    end: Transform

    def interpolate_matrix(self, time):
        """time (N,) float32 tensor -> matrices (N, 4, 4) on its device."""
        on = lambda a: torch.as_tensor(a, device=time.device)
        dt = ((time - self.start_time)
              / max(self.end_time - self.start_time, 1e-30)).clamp(0.0, 1.0)
        t, r, s = on(self.t), on(self.r), on(self.s)
        trans = (1.0 - dt)[:, None] * t[0] + dt[:, None] * t[1]
        rot = slerp(dt, r[0].expand(dt.shape + (4,)),
                    r[1].expand(dt.shape + (4,)))
        sc = (1.0 - dt)[:, None, None] * s[0] + dt[:, None, None] * s[1]
        m = quat_to_matrix(rot) @ sc
        m[..., :3, 3] += trans
        return m


def decompose(m):
    """Affine matrix -> (translation (3,), rotation quaternion (4,), scale
    (4, 4)), float32, by a polar decomposition: the rotation is the limit
    of averaging a matrix with its inverse transpose (host, float64)."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    M = m.copy()
    M[:3, 3] = 0.0
    M[3, :] = [0, 0, 0, 1]
    R = M.copy()
    for _ in range(100):
        Rnext = 0.5 * (R + np.linalg.inv(R.T))
        norm = np.max(np.sum(np.abs(R - Rnext), axis=1))
        R = Rnext
        if norm < 1e-4:
            break
    S = np.linalg.inv(R) @ M
    return (t.astype(np.float32), quat_from_matrix(R),
            S.astype(np.float32))


def animated(start: Transform, end: Transform, t0=0.0,
             t1=1.0) -> AnimatedTransform:
    t_s, r_s, s_s = decompose(start.m)
    t_e, r_e, s_e = decompose(end.m)
    if float(np.sum(r_s * r_e)) < 0.0:     # the shorter way round
        r_e = -r_e
    return AnimatedTransform(
        start_time=float(np.float32(t0)), end_time=float(np.float32(t1)),
        t=np.stack([t_s, t_e]), r=np.stack([r_s, r_e]),
        s=np.stack([s_s, s_e]),
        actually_animated=not bool(np.allclose(start.m, end.m)),
        start=start, end=end)
