"""Real spherical harmonics over direction wavefronts (counterpart of the JAX
reference's ``core/sh.py``).

``eval_basis`` evaluates the real SH basis up to ``lmax`` on a batch of
directions as float32 torch operations, with static Python loops over
(l, m): the associated Legendre recurrence one m-column at a time and the
(cos m phi, sin m phi) recurrence from (x, y), guarded at the poles
(sin theta < 1e-12). ``project_directions`` is the Monte-Carlo projection
sum_i w_i v_i Y(d_i); ``convolve_cos_theta`` and ``reduce_ringing`` scale
each band.

Rotation is host numpy in float64 around the float32 basis: a dense
(T, T) matrix by a Gauss-Legendre x uniform-phi quadrature exact for the
degree 2 lmax products, M[i, j] = int Y_i(R d) Y_j(d) dOmega.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def n_terms(lmax: int) -> int:
    """(lmax + 1)^2 coefficients."""
    return (lmax + 1) * (lmax + 1)


def index(l: int, m: int) -> int:
    """Flat index of (l, m), m in [-l, l]."""
    return l * l + l + m


def _K(l: int, m: int) -> float:
    m = abs(m)
    num = (2 * l + 1) * math.factorial(l - m)
    den = 4.0 * math.pi * math.factorial(l + m)
    return math.sqrt(num / den)


def eval_basis(w, lmax: int):
    """Real SH basis: w, a V3 of (R,) or an (R, 3) tensor of unit
    directions -> (R, n_terms(lmax)) float32 (z = cos theta is the polar
    axis)."""
    if hasattr(w, "x"):
        x, y, z = w.x, w.y, w.z
    else:
        x, y, z = w[..., 0], w[..., 1], w[..., 2]
    ct = z.clamp(-1.0, 1.0)
    s2 = (1.0 - ct * ct).clamp_min(0.0)
    st = torch.sqrt(s2)
    r_inv = 1.0 / st.clamp_min(1e-12)
    pole = st < 1e-12
    cp1 = torch.where(pole, 1.0, x * r_inv)
    sp1 = torch.where(pole, 0.0, y * r_inv)

    out = [None] * n_terms(lmax)
    cm, sm = torch.ones_like(ct), torch.zeros_like(ct)
    pmm = torch.ones_like(ct)         # P_m^m, (1 - x^2)^{m/2} folded in
    for m in range(lmax + 1):
        if m > 0:
            cm, sm = cm * cp1 - sm * sp1, sm * cp1 + cm * sp1
            pmm = pmm * float(-(2 * m - 1)) * st
        p_prev2 = pmm
        for l in range(m, lmax + 1):
            if l == m:
                p = pmm
            elif l == m + 1:
                p = ct * float(2 * m + 1) * pmm
                p_prev1 = p
            else:
                p = (float(2 * l - 1) * ct * p_prev1
                     - float(l + m - 1) * p_prev2) / float(l - m)
                p_prev2, p_prev1 = p_prev1, p
            k = _K(l, m)
            if m == 0:
                out[index(l, 0)] = k * p
            else:
                s2k = math.sqrt(2.0) * k
                out[index(l, m)] = s2k * cm * p
                out[index(l, -m)] = s2k * sm * p
    return torch.stack(out, dim=-1)


def project_directions(dirs, values, weights, lmax: int):
    """sum_i w_i v_i Y(d_i): dirs (N, 3) or V3, values (N, C), weights
    (N,) -> (n_terms, C)."""
    Y = eval_basis(dirs, lmax)
    return torch.einsum("nt,nc,n->tc", Y, values, weights)


def _band_scale(coeffs, scale):
    sc = torch.from_numpy(scale).to(coeffs.device)
    return coeffs * sc.reshape((-1,) + (1,) * (coeffs.dim() - 1))


def convolve_cos_theta(coeffs, lmax: int):
    """Coefficients (T, ...) convolved with the clamped cosine: band l
    scaled by A_l (A_0 = pi, A_1 = 2 pi / 3, odd l > 1 -> 0, even l ->
    2 pi (-1)^(l/2 - 1) / ((l + 2)(l - 1)) l! / (2^l ((l/2)!)^2)), so that
    sum_lm A_l c_lm Y_lm(n) is the irradiance at normal n."""
    scale = np.zeros(n_terms(lmax), np.float32)
    for l in range(lmax + 1):
        if l == 0:
            a = math.pi
        elif l == 1:
            a = 2.0 * math.pi / 3.0
        elif l % 2 == 1:
            a = 0.0
        else:
            h = l // 2
            a = (2.0 * math.pi * (-1.0) ** (h - 1) / ((l + 2) * (l - 1))
                 * math.factorial(l) / (2 ** l * math.factorial(h) ** 2))
        for m in range(-l, l + 1):
            scale[index(l, m)] = a
    return _band_scale(coeffs, scale)


def reduce_ringing(coeffs, lmax: int, lam: float = 0.005):
    """Tikhonov windowing: band l scaled by 1 / (1 + lam l^2 (l + 1)^2)."""
    scale = np.zeros(n_terms(lmax), np.float32)
    for l in range(lmax + 1):
        s = 1.0 / (1.0 + lam * l * l * (l + 1.0) * (l + 1.0))
        for m in range(-l, l + 1):
            scale[index(l, m)] = s
    return _band_scale(coeffs, scale)


def _quadrature_dirs(lmax: int):
    """(dirs (N, 3), weights (N,)) of a spherical quadrature exact for
    polynomials of degree 2 lmax: Gauss-Legendre nodes in cos theta times
    uniform phi; the weights sum to 4 pi."""
    n_ct = 2 * lmax + 2
    n_ph = 4 * lmax + 4
    ct, wct = np.polynomial.legendre.leggauss(n_ct)
    ph = (np.arange(n_ph) + 0.5) * (2.0 * np.pi / n_ph)
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
    d = np.stack(np.broadcast_arrays(
        st[:, None] * np.cos(ph)[None, :],
        st[:, None] * np.sin(ph)[None, :],
        ct[:, None] * np.ones_like(ph)[None, :]), axis=-1).reshape(-1, 3)
    w = np.broadcast_to(wct[:, None] * (2.0 * np.pi / n_ph),
                        (n_ct, n_ph)).reshape(-1)
    return d, w


def _basis_np(d, lmax):
    return eval_basis(torch.from_numpy(np.asarray(d, np.float32)),
                      lmax).numpy()


def rotation_matrix(R3: np.ndarray, lmax: int) -> np.ndarray:
    """Dense (T, T) float64 SH rotation matrix of a 3x3 rotation (host)."""
    d, w = _quadrature_dirs(lmax)
    Y = _basis_np(d, lmax)
    Yr = _basis_np(d @ np.asarray(R3, np.float64).T, lmax)
    return (Yr * w[:, None]).T @ Y


def rotate(coeffs: np.ndarray, R3: np.ndarray, lmax: int) -> np.ndarray:
    """Rotate host coefficient vector(s) (T,) or (T, C)."""
    M = rotation_matrix(R3, lmax)
    return (M @ np.asarray(coeffs, np.float64)).astype(
        np.asarray(coeffs).dtype)
