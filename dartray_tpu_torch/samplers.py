"""Wavefront sample generation (counterpart of the JAX reference's
``samplers.py``).

Every sample value is a pure function of (pixel, sample index, dimension,
seed), so a wave needs no generator state and any partition of the image
draws the same numbers. Dimension convention: dims 0,1 = image offset;
2,3 = lens; 4 = time; integrators draw dims >= 5 via sample_1d/2d.

Ported: the ``lowdiscrepancy`` ((0,2)-sequence) sampler. ``stratified``,
``random``, ``halton``, ``bestcandidate`` and the primary-sample-space vector
sampler raise ``NotImplementedError`` (ROADMAP Queue 1 item 7, samplers).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .core import sampling as smp
from .core.math import V2

LOWDISCREPANCY = 0


class CameraSamples(NamedTuple):
    """SoA camera samples: continuous image position (pixel + jitter), lens
    uv, time u."""
    image_xy: V2
    lens_uv: V2
    time_u: torch.Tensor


@dataclasses.dataclass
class Sampler:
    kind: int
    spp: int
    seed: int = 0


def _round_pow2(n):
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def make_sampler(kind: str, spp: int = 4, seed: int = 0) -> Sampler:
    if kind in ("lowdiscrepancy", "02sequence"):
        # spp rounds up to a power of two
        return Sampler(LOWDISCREPANCY, _round_pow2(spp), int(seed) & smp.M32)
    raise NotImplementedError(
        f"sampler {kind!r}: only 'lowdiscrepancy' is ported "
        "(ROADMAP Queue 1 item 7, samplers)")


def _pixel_key(sampler: Sampler, px, py, dim: int):
    """Per-(pixel, dimension) u32 scramble key (u32-in-int64 tensor)."""
    d = ((int(dim) + 1) * 0x9e3779b9) & smp.M32
    h = smp.hash_u32(smp.as_u32(px) ^ ((smp.as_u32(py) << 16) & smp.M32) ^ d)
    return smp.hash_u32(h ^ sampler.seed)


def _n_bits(sampler: Sampler) -> int:
    # index_permute returns values < spp: higher Sobol' bits fold in zero
    return max(int(sampler.spp - 1).bit_length(), 1)


def sample_2d(sampler: Sampler, px, py, s_idx, dim: int) -> V2:
    """(R,) pixel coords + sample indices -> V2 in [0,1)^2."""
    scr = (_pixel_key(sampler, px, py, dim),
           _pixel_key(sampler, px, py, dim + 1000))
    # independent draw ORDER per dimension group
    sp = smp.index_permute(smp.as_u32(s_idx), sampler.spp,
                           _pixel_key(sampler, px, py, dim + 2000))
    return smp.sample02(sp, scr, _n_bits(sampler))


def sample_1d(sampler: Sampler, px, py, s_idx, dim: int):
    scr = _pixel_key(sampler, px, py, dim)
    sp = smp.index_permute(smp.as_u32(s_idx), sampler.spp,
                           _pixel_key(sampler, px, py, dim + 2000))
    return smp.van_der_corput(sp, scr)


def camera_samples(sampler: Sampler, px, py, s_idx) -> CameraSamples:
    """Image/lens/time sample triple for a wavefront. px/py int32 raster
    pixel; returns continuous raster image_xy = pixel + [0,1)^2 offset."""
    img = sample_2d(sampler, px, py, s_idx, 0)
    lens = sample_2d(sampler, px, py, s_idx, 2)
    time_u = sample_1d(sampler, px, py, s_idx, 4)
    image_xy = V2(px.to(torch.float32) + img.x, py.to(torch.float32) + img.y)
    return CameraSamples(image_xy=image_xy, lens_uv=lens, time_u=time_u)
