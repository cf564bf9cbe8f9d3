"""4x4 transforms built on the host (counterpart of the JAX reference's
``core/transform.py``; the factories this slice uses).

A Transform is a pair of (4, 4) float32 numpy arrays (m, m_inv). Scene
compilation composes them on the host; wavefront code receives the final
matrices and applies them component-wise (``core.math.xform_point3``).
Rotations, quaternions and animated transforms are not ported yet.
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
