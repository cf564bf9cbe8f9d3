"""Color handling: RGB channel tensors, XYZ at the film (counterpart of the
JAX reference's ``core/spectrum.py``).

All radiometric quantities are RGB, stored component-SoA over the wavefront
(``V3``) and converted to XYZ only at film accumulation. The reference's
``sampled`` spectrum mode and its SPD tables are not ported (``set_mode``
raises for it).
"""
from __future__ import annotations

import numpy as np
import torch

from . import math as vm

# PBRT XYZ<->RGB matrices
XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], np.float32)
RGB_TO_XYZ = np.array([
    [0.412453, 0.357580, 0.180423],
    [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227]], np.float32)


def set_mode(mode: str):
    if mode != "rgb":
        raise NotImplementedError(
            f"spectrum mode {mode!r}: only 'rgb' is ported (ROADMAP Queue 1)")


def _mat3(m, c):
    """Apply a 3x3 constant matrix to a color: V3 -> V3 (componentwise) or
    (..., 3) -> (..., 3)."""
    if isinstance(c, vm.V3):
        return vm.V3(
            float(m[0][0]) * c.x + float(m[0][1]) * c.y + float(m[0][2]) * c.z,
            float(m[1][0]) * c.x + float(m[1][1]) * c.y + float(m[1][2]) * c.z,
            float(m[2][0]) * c.x + float(m[2][1]) * c.y + float(m[2][2]) * c.z)
    return c @ torch.as_tensor(m, dtype=c.dtype, device=c.device).T


def rgb_to_xyz(rgb):
    return _mat3(RGB_TO_XYZ, rgb)


def xyz_to_rgb(xyz):
    return _mat3(XYZ_TO_RGB, xyz)


def to_xyz(c):
    """Radiance channels -> XYZ (the film accumulation conversion)."""
    return rgb_to_xyz(c)


def luminance(c):
    """Y channel of a V3 color."""
    w = RGB_TO_XYZ[1]
    return float(w[0]) * c.x + float(w[1]) * c.y + float(w[2]) * c.z


def any_nonzero(c):
    return (c.x != 0.0) | (c.y != 0.0) | (c.z != 0.0)


def all_finite(c):
    return torch.isfinite(c.x) & torch.isfinite(c.y) & torch.isfinite(c.z)
