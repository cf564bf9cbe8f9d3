"""Measured-BRDF loaders (counterpart of the JAX reference's ``io/merl.py``,
numpy only): MERL regular-halfangle binaries (.merl) and irregular isotropic
(theta, phi) text data (.brdf).

Both formats load into the SAME regular half-angle table: irregular samples
are resampled onto the grid at load time, on the host, with inverse-distance
weighting in the BRDFRemap coordinate space, so the device side evaluates
one gather path with no per-ray branching.
"""
from __future__ import annotations

import re

import numpy as np

# MERL channel scales (PBRT-v2's measured.cpp)
MERL_SCALES = (1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0)


def read_merl(data: bytes) -> np.ndarray:
    """MERL binary -> (nThetaH, nThetaD, nPhiD, 3) f32 table.

    Layout: 3 little-endian int32 dims, then 3*n doubles channel-major
    (all R, all G, all B), each scaled by MERL_SCALES on read."""
    dims = np.frombuffer(data[:12], "<i4")
    nth, ntd, npd = (int(dims[0]), int(dims[1]), int(dims[2]))
    # MERL files store phi_d in [0, pi) as 180 but some list 360; the PBRT
    # reader treats the product as authoritative.
    n = nth * ntd * npd
    vals = np.frombuffer(data[12:12 + n * 3 * 8], "<f8")
    if vals.size < 3 * n:
        raise ValueError(f"truncated MERL file: {vals.size} < {3 * n}")
    out = np.empty((3, n), np.float32)
    for c in range(3):
        out[c] = np.maximum(vals[c * n:(c + 1) * n], 0.0) * MERL_SCALES[c]
    return out.T.reshape(nth, ntd, npd, 3).astype(np.float32)


def _spherical_dir(sintheta, costheta, phi):
    return np.stack([sintheta * np.cos(phi), sintheta * np.sin(phi),
                     costheta], axis=-1)


def brdf_remap(wo, wi):
    """BRDFRemap: (wo, wi) -> isotropic 3D coordinate
    (dphi/pi, costhetai, costhetao) used as the interpolation space."""
    wo = np.asarray(wo, np.float64)
    wi = np.asarray(wi, np.float64)
    dphi = np.arctan2(wi[..., 1], wi[..., 0]) - np.arctan2(wo[..., 1],
                                                           wo[..., 0])
    dphi = np.where(dphi < 0, dphi + 2 * np.pi, dphi)
    dphi = np.where(dphi > 2 * np.pi, dphi - 2 * np.pi, dphi)
    dphi = np.where(dphi > np.pi, 2 * np.pi - dphi, dphi)
    return np.stack([dphi / np.pi, wi[..., 2], wo[..., 2]], axis=-1)


def _wavelengths_to_rgb(wls, vals):
    """Crude sampled-spectrum -> RGB: average per broad band (B<500,
    500<=G<600, R>=600 nm); falls back to the overall mean per channel."""
    wls = np.asarray(wls, np.float64)
    vals = np.asarray(vals, np.float64)       # (..., numWls)
    bands = [(wls >= 600), (wls >= 500) & (wls < 600), (wls < 500)]
    out = []
    for b in bands:
        if b.any():
            out.append(vals[..., b].mean(axis=-1))
        else:
            out.append(vals.mean(axis=-1))
    return np.stack(out, axis=-1)             # (..., 3) RGB


def read_brdf_text(text: str, grid=(32, 16, 16)) -> np.ndarray:
    """Irregular isotropic (theta, phi) text data -> regular half-angle
    table (nThetaH, nThetaD, nPhiD, 3) by inverse-distance resampling.

    File format: numWls, wavelengths, then records (thetai, phii, thetao, phio, spectrum[numWls])."""
    toks = [t for t in re.split(r"\s+", re.sub(r"#[^\n]*", " ", text))
            if t]
    values = np.asarray([float(t) for t in toks], np.float64)
    pos = 0
    num_wls = int(values[pos]); pos += 1
    if (values.size - 1 - num_wls) % (4 + num_wls) != 0:
        raise ValueError("excess or insufficient data in .brdf file")
    wls = values[pos:pos + num_wls]; pos += num_wls
    rec = values[pos:].reshape(-1, 4 + num_wls)
    thetai, phii, thetao, phio = rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]
    rgb = _wavelengths_to_rgb(wls, rec[:, 4:])
    wo = _spherical_dir(np.sin(thetao), np.cos(thetao), phio)
    wi = _spherical_dir(np.sin(thetai), np.cos(thetai), phii)
    pts = brdf_remap(wo, wi)                  # (S, 3)

    nth, ntd, npd = grid
    # target grid cell centers expressed as (wo, wi) dirs -> remap coords
    th_h = ((np.arange(nth) + 0.5) / nth) ** 2 * (np.pi / 2)
    th_d = (np.arange(ntd) + 0.5) / ntd * (np.pi / 2)
    ph_d = (np.arange(npd) + 0.5) / npd * np.pi
    TH, TD, PD = np.meshgrid(th_h, th_d, ph_d, indexing="ij")
    # reconstruct wo/wi from half/diff angles (isotropic, phi_h = 0)
    wh = _spherical_dir(np.sin(TH), np.cos(TH), np.zeros_like(TH))
    wd = _spherical_dir(np.sin(TD), np.cos(TD), PD)
    # frame (whx, why, wh)
    whx = np.stack([np.cos(TH), np.zeros_like(TH), -np.sin(TH)], axis=-1)
    why = np.stack([np.zeros_like(TH), np.ones_like(TH),
                    np.zeros_like(TH)], axis=-1)
    wi_g = (wd[..., 0:1] * whx + wd[..., 1:2] * why + wd[..., 2:3] * wh)
    wo_g = 2 * np.sum(wi_g * wh, axis=-1, keepdims=True) * wh - wi_g
    q = brdf_remap(wo_g.reshape(-1, 3), wi_g.reshape(-1, 3))   # (G, 3)

    out = np.zeros((q.shape[0], 3), np.float32)
    chunk = 8192
    for s in range(0, q.shape[0], chunk):
        d2 = ((q[s:s + chunk, None, :] - pts[None, :, :]) ** 2).sum(-1)
        w = 1.0 / np.maximum(d2, 1e-6)
        k = min(8, pts.shape[0])
        sel = np.argpartition(-w, k - 1, axis=1)[:, :k]
        wsel = np.take_along_axis(w, sel, axis=1)
        out[s:s + chunk] = ((wsel[..., None] * rgb[sel]).sum(1)
                            / wsel.sum(1)[..., None])
    return out.reshape(nth, ntd, npd, 3).astype(np.float32)


def load(data: bytes, filename: str) -> np.ndarray:
    """Dispatch by suffix -> (nThetaH, nThetaD, nPhiD, 3) table."""
    if filename.lower().endswith(".brdf"):
        return read_brdf_text(data.decode("utf-8", "replace"))
    return read_merl(data)
