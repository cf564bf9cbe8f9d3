"""4x4 transforms built on the host (counterpart of the JAX reference's
``core/transform.py``; the factories this slice uses).

A Transform is a pair of (4, 4) float32 numpy arrays (m, m_inv). Scene
compilation composes them on the host; wavefront code receives the final
matrices and applies them component-wise (``core.math.xform_point3``).
Quaternions and animated transforms are not ported yet (an animated camera
raises, ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import math as _pymath
from typing import NamedTuple

import numpy as np


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


def perspective(fov_deg, n, f) -> Transform:
    """Project z to [0,1], divide by z."""
    persp = np.asarray([
        [1, 0, 0, 0],
        [0, 1, 0, 0],
        [0, 0, f / (f - n), -f * n / (f - n)],
        [0, 0, 1, 0]], np.float32)
    inv_tan = 1.0 / _pymath.tan(_pymath.radians(float(fov_deg)) / 2.0)
    return scale(inv_tan, inv_tan, 1.0) * from_matrix(persp)
