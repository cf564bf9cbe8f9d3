"""The reference's pixel values and its inverse-rendering gradient.

An estimator is ``estimate(scene, camera, lanes, kd=None)`` -> (N, 3)
radiance (``integrators.py``). ``pixel_values`` averages the radiance of
samples 0 .. n-1 of each asked pixel, as a box-filtered film of those
samples resolves it (a sample that is not finite, or of negative
luminance, carries no weight).
``loss_grad`` renders the whole image in blocks of pixels with autograd on
the shading, and returns mean((img - target)**2), its gradient with
respect to the material albedo table and the image. The lanes of a block
are evaluated in chunks of ``LANES`` so that the reference fits beside
nothing else.
"""
from __future__ import annotations

import torch

from . import integrators as ig
from . import sampling as smp
from . import shading as sh

LANES = 1 << 16


def _deposit_weight(L):
    ok = torch.isfinite(L).all(-1) & (sh.luminance(L) > -1e-5)
    return torch.where(ok[:, None], L, torch.zeros_like(L)), ok


@torch.no_grad()
def pixel_values(sc, cam, sampler: smp.Sampler, estimate, px, py,
                 n_samples: int, dtype=torch.float32):
    """(K, 3) RGB of pixels (px, py) over sample indices 0 .. n-1."""
    k = px.shape[0]
    dev = px.device
    lane_px = px.repeat_interleave(n_samples)
    lane_py = py.repeat_interleave(n_samples)
    lane_s = torch.arange(n_samples, device=dev).repeat(k)
    acc = torch.zeros((k, 3), dtype=torch.float64, device=dev)
    wsum = torch.zeros((k,), dtype=torch.float64, device=dev)
    owner = torch.arange(k, device=dev).repeat_interleave(n_samples)
    for a in range(0, lane_px.shape[0], LANES):
        b = min(a + LANES, lane_px.shape[0])
        lanes = ig.Lanes(sampler, lane_px[a:b], lane_py[a:b], lane_s[a:b],
                         dtype)
        L, ok = _deposit_weight(estimate(sc, cam, lanes).float())
        acc.index_add_(0, owner[a:b], L.double())
        wsum.index_add_(0, owner[a:b], ok.double())
    return (acc / wsum.clamp_min(1.0)[:, None]).float()


def loss_grad(sc, cam, sampler: smp.Sampler, estimate, width, height,
              spp, kd_table, target, dtype=torch.float32):
    """(loss, d loss / d kd_table, image) of mean((img - target)**2) over
    the whole width x height image at `spp` samples a pixel."""
    dev = kd_table.device
    kd = kd_table.detach().clone().to(dtype).requires_grad_(True)
    n_px = width * height
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    tgt = target.reshape(-1, 3)
    per_block = max(LANES // spp, 1)
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    grad = torch.zeros_like(kd, dtype=torch.float64)
    image = torch.zeros((n_px, 3), dtype=torch.float32, device=dev)
    for a in range(0, n_px, per_block):
        b = min(a + per_block, n_px)
        m = b - a
        lanes = ig.Lanes(sampler, xs[a:b].repeat_interleave(spp),
                         ys[a:b].repeat_interleave(spp),
                         torch.arange(spp, device=dev).repeat(m), dtype)
        with torch.enable_grad():
            L, ok = _deposit_weight(estimate(sc, cam, lanes, kd))
            L = L.float().reshape(m, spp, 3)
            w = ok.float().reshape(m, spp, 1)
            img = (L * w).sum(1) / w.sum(1).clamp_min(1.0)
            part = ((img - tgt[a:b]) ** 2).sum() / (n_px * 3)
            (g,) = torch.autograd.grad(part, kd, allow_unused=True)
        loss += part.detach().double()
        image[a:b] = img.detach()
        if g is not None:
            grad += g.double()
    return loss.float(), grad.float(), image.reshape(height, width, 3)
