"""Color handling: RGB channel tensors, XYZ at the film (counterpart of the
JAX reference's ``core/spectrum.py``).

All radiometric quantities are RGB, stored component-SoA over the wavefront
(``V3``) and converted to XYZ only at film accumulation. Sampled SPD data
(``spectrum`` and ``blackbody`` scene parameters) converts to RGB at scene
compile time (``spd_to_rgb``, numpy). The reference's ``sampled`` spectrum
mode is not ported (``set_mode`` raises for it).
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
            f"spectrum mode {mode!r}: only 'rgb' is ported (ROADMAP Queue 1 "
            "item 7)")


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


def blackbody(wavelengths_nm, temperature):
    """Planck's law emission at the given wavelengths (host, numpy)."""
    w = np.asarray(wavelengths_nm, np.float64) * 1e-9
    h = 6.62606957e-34
    c = 299792458.0
    kb = 1.3806488e-23
    return (2.0 * h * c * c) / (w ** 5 * (np.expm1(h * c / (w * kb * temperature))))


# SPDs are resampled every 5 nm over 380-780 nm and integrated against an
# analytic multi-lobe gaussian fit of the CIE 1931 observer (Wyman et al.
# 2013)
_CIE_LAMBDA = np.arange(380.0, 781.0, 5.0)


def _g(x, mu, s1, s2):
    t = (x - mu) * np.where(x < mu, 1.0 / s1, 1.0 / s2)
    return np.exp(-0.5 * t * t)


def cie_xyz_fit(lam):
    lam = np.asarray(lam, np.float64)
    x = (1.056 * _g(lam, 599.8, 37.9, 31.0)
         + 0.362 * _g(lam, 442.0, 16.0, 26.7)
         - 0.065 * _g(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _g(lam, 568.8, 46.9, 40.5)
         + 0.286 * _g(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _g(lam, 437.0, 11.8, 36.0)
         + 0.681 * _g(lam, 459.0, 26.0, 13.8))
    return np.stack([x, y, z], axis=-1)


def spd_to_rgb(lambdas, values):
    """Piecewise-linear SPD -> (3,) float32 RGB: resampled on the 5 nm grid,
    integrated against the observer and normalised by its Y integral (the
    same normalisation for reflectances and illuminants)."""
    lambdas = np.asarray(lambdas, np.float64)
    values = np.asarray(values, np.float64)
    order = np.argsort(lambdas)
    lambdas, values = lambdas[order], values[order]
    v = np.interp(_CIE_LAMBDA, lambdas, values)
    cmf = cie_xyz_fit(_CIE_LAMBDA)
    xyz = (v[:, None] * cmf).sum(axis=0) * 5.0
    xyz /= (cmf[:, 1].sum() * 5.0)
    rgb = XYZ_TO_RGB.astype(np.float64) @ xyz
    return rgb.astype(np.float32)
