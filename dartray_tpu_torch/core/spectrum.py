"""Color handling: 3-channel tensors, XYZ at the film (counterpart of the
JAX reference's ``core/spectrum.py``).

Radiometric quantities are stored component-SoA over the wavefront (``V3``)
and converted to XYZ only at film accumulation. A global mode (``set_mode``,
set BEFORE a scene is parsed: the conversions are baked into its tables)
says what the three channels are: "rgb" primaries, or in "sampled" mode the
averages of three wavelength bands (400-500-600-700 nm), which transport
multiplies per band. Sampled SPD data (``spectrum`` and ``blackbody`` scene
parameters) converts at scene compile time (numpy): to RGB through the CIE
observer (``spd_to_rgb``), or to band averages (``spd_to_bands``); RGB
values convert to bands with the same XYZ (``rgb_to_bands``; illuminants
through a D65-shaped basis).
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
    """Radiance channels -> XYZ under the current mode (the film
    accumulation conversion)."""
    if _mode == "sampled":
        return _mat3(BANDS_TO_XYZ, c)
    return rgb_to_xyz(c)


def luminance(c):
    """Y of a V3 color under the current mode."""
    w = BANDS_TO_XYZ[1] if _mode == "sampled" else RGB_TO_XYZ[1]
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


# --- the sampled-spectrum mode ----------------------------------------------
# Three bands ride the 3-channel layout of every color table: the arrays are
# reinterpreted, not widened.

N_BANDS = 3
BAND_EDGES = np.array([400.0, 500.0, 600.0, 700.0])   # nm

_mode = "rgb"


def set_mode(mode: str):
    """The global spectral representation, "rgb" or "sampled"."""
    global _mode
    if mode not in ("rgb", "sampled"):
        raise ValueError(f"spectrum mode {mode!r}: 'rgb' or 'sampled'")
    _mode = mode


def mode() -> str:
    return _mode


def _bands_cmf():
    cmf = cie_xyz_fit(_CIE_LAMBDA)
    m = np.zeros((3, N_BANDS))
    for b in range(N_BANDS):
        sel = ((_CIE_LAMBDA >= BAND_EDGES[b])
               & (_CIE_LAMBDA < BAND_EDGES[b + 1]))
        m[:, b] = cmf[sel].sum(axis=0) * 5.0
    # a flat spectrum of 1 has Y = 1, as (1, 1, 1) has in rgb mode
    return m / (cmf[:, 1].sum() * 5.0)


BANDS_TO_XYZ = _bands_cmf().astype(np.float32)          # (3 xyz, 3 bands)
_XYZ_TO_BANDS = np.linalg.inv(BANDS_TO_XYZ).astype(np.float32)


def spd_to_bands(lambdas, values):
    """Piecewise-linear SPD -> (3,) float32 band averages (resampled every
    2 nm over 400-700 nm)."""
    lambdas = np.asarray(lambdas, np.float64)
    values = np.asarray(values, np.float64)
    order = np.argsort(lambdas)
    lambdas, values = lambdas[order], values[order]
    grid = np.arange(BAND_EDGES[0], BAND_EDGES[-1], 2.0)
    v = np.interp(grid, lambdas, values)
    out = np.zeros(N_BANDS)
    for b in range(N_BANDS):
        sel = (grid >= BAND_EDGES[b]) & (grid < BAND_EDGES[b + 1])
        out[b] = v[sel].mean()
    return out.astype(np.float32)


def _d65_bands():
    """CIE D65 band averages (its relative SPD every 20 nm over 400-700
    nm), normalised to luminance 1."""
    lam = np.arange(400.0, 701.0, 20.0)
    d65 = np.array([82.75, 93.43, 104.86, 117.01, 115.92, 114.86, 108.81,
                    104.79, 107.69, 104.41, 104.05, 100.00, 96.33, 95.79,
                    88.69, 90.01], np.float64)
    out = np.zeros(N_BANDS)
    for b in range(N_BANDS):
        sel = (lam >= BAND_EDGES[b]) & (lam < BAND_EDGES[b + 1])
        out[b] = d65[sel].mean()
    y = float(BANDS_TO_XYZ[1] @ out)
    return (out / max(y, 1e-12)).astype(np.float32)


_D65_BANDS = _d65_bands()
# illuminant XYZ -> bands: white maps to the D65 band shape, XYZ kept
# exactly: diag(d65) @ inv(BANDS_TO_XYZ @ diag(d65))
_XYZ_TO_BANDS_ILLUM = (np.diag(_D65_BANDS)
                       @ np.linalg.inv(BANDS_TO_XYZ @ np.diag(_D65_BANDS))
                       ).astype(np.float32)


def rgb_to_bands(rgb, illuminant=False):
    """RGB (..., 3) -> bands with the same XYZ, clamped >= 0 (float32
    numpy). illuminant=True takes the D65-shaped basis: a white illuminant
    has D65's band shape, a white reflectance is flat."""
    xyz = np.asarray(rgb, np.float32) @ RGB_TO_XYZ.T
    basis = _XYZ_TO_BANDS_ILLUM if illuminant else _XYZ_TO_BANDS
    return np.maximum(xyz @ basis.T, 0.0)
