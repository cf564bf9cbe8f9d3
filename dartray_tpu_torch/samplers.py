"""Wavefront sample generation (counterpart of the JAX reference's
``samplers.py``).

Every sample value is a pure function of (pixel, sample index, dimension,
seed), so a wave needs no generator state and any partition of the image
draws the same numbers. Dimension convention: dims 0,1 = image offset;
2,3 = lens; 4 = time; integrators draw dims >= 5 via sample_1d/2d.

Kinds: ``lowdiscrepancy`` ((0,2)-sequence), ``stratified`` (jittered strata
in a shuffled order), ``random``, ``halton`` (radical inverses indexed by a
pixel hash plus the sample index), ``bestcandidate`` (a blue-noise tile
made on the host by Mitchell's best-candidate algorithm for the image
dimensions, the (0,2)-sequence for the others) and the primary-sample-space
vector sampler (``vector_sampler``: every draw reads an explicit (R, D)
tensor, as the Metropolis renderer drives the integrators).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .core import sampling as smp
from .core.math import V2

LOWDISCREPANCY = 0
STRATIFIED = 1
RANDOM = 2
HALTON = 3
BESTCANDIDATE = 4
VECTOR = 5   # primary-sample-space vector (Metropolis chains)


class CameraSamples(NamedTuple):
    """SoA camera samples: continuous image position (pixel + jitter), lens
    uv, time u."""
    image_xy: V2
    lens_uv: V2
    time_u: torch.Tensor


# --- best-candidate (Poisson-disk) image-sample tile ------------------------
# A toroidal tile of BC_TILE x BC_TILE pixels holding BC_SMAX samples each,
# made once on the host (numpy, seeded) and repeated across the film.

BC_TILE = 16
BC_SMAX = 16
_BC_CACHE = {}


def _bc_tile(seed: int = 0):
    """(T, T, SMAX, 2) float32 toroidal best-candidate intra-pixel offsets:
    Mitchell's algorithm (12 candidates a point, the farthest from the
    points so far wins), then bucketed into pixels in a random order, a
    pixel's deficit filled with uniform points."""
    key = int(seed)
    if key in _BC_CACHE:
        return _BC_CACHE[key]
    t = BC_TILE
    m = t * t * BC_SMAX
    rng = np.random.RandomState(1234 + seed)
    pts = np.empty((m, 2), np.float32)
    pts[0] = rng.rand(2) * t
    # the coordinates apart, so each step is two (12, i) passes: the same
    # float32 operations (|c - p|, its toroidal min, dx*dx + dy*dy), the
    # same distances bit for bit
    xs, ys = np.empty(m, np.float32), np.empty(m, np.float32)
    xs[0], ys[0] = pts[0]
    tf = np.float32(t)
    n_cand = 12
    for i in range(1, m):
        cand = rng.rand(n_cand, 2).astype(np.float32) * t
        dx = np.abs(cand[:, 0:1] - xs[None, :i])
        dx = np.minimum(dx, tf - dx)
        dy = np.abs(cand[:, 1:2] - ys[None, :i])
        dy = np.minimum(dy, tf - dy)
        pts[i] = cand[int(np.argmax((dx * dx + dy * dy).min(axis=1)))]
        xs[i], ys[i] = pts[i]
    table = np.empty((t, t, BC_SMAX, 2), np.float32)
    ix = np.minimum(pts[:, 0].astype(np.int64), t - 1)
    iy = np.minimum(pts[:, 1].astype(np.int64), t - 1)
    for y in range(t):
        for x in range(t):
            sel = pts[(ix == x) & (iy == y)] - (x, y)
            sel = sel[rng.permutation(len(sel))]
            if len(sel) >= BC_SMAX:
                cell = sel[:BC_SMAX]
            else:
                pad = rng.rand(BC_SMAX - len(sel), 2).astype(np.float32)
                cell = np.concatenate([sel, pad]) if len(sel) else pad
            table[y, x] = cell
    _BC_CACHE[key] = table
    return table


@dataclasses.dataclass
class Sampler:
    kind: int
    spp: int
    seed: int = 0
    nx: int = 1                 # stratified strata
    ny: int = 1
    jitter: bool = True
    u_vec: torch.Tensor = None  # (R, D) primary samples (VECTOR kind only)
    bc: np.ndarray = None       # (T, T, SMAX, 2) tile (BESTCANDIDATE only)
    _bc_on: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def bc_tile(self, device):
        """The best-candidate tile as a tensor on `device` (copied once)."""
        key = str(device)
        if key not in self._bc_on:
            self._bc_on[key] = torch.from_numpy(self.bc).to(device)
        return self._bc_on[key]


def vector_sampler(u_vec) -> Sampler:
    """Sampler whose draws read the explicit primary-sample vector u_vec
    (R, D): dimension d -> u_vec[:, d mod D]."""
    return Sampler(VECTOR, 1, 0, u_vec=u_vec)


def _round_pow2(n):
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def make_sampler(kind: str, spp: int = 4, seed: int = 0,
                 jitter=True) -> Sampler:
    seed = int(seed) & smp.M32
    if kind in ("lowdiscrepancy", "02sequence"):
        # spp rounds up to a power of two
        return Sampler(LOWDISCREPANCY, _round_pow2(spp), seed)
    if kind == "stratified":
        nx = max(int(np.round(np.sqrt(spp))), 1)
        ny = max((spp + nx - 1) // nx, 1)
        return Sampler(STRATIFIED, nx * ny, seed, nx, ny, bool(jitter))
    if kind == "random":
        return Sampler(RANDOM, spp, seed)
    if kind == "halton":
        return Sampler(HALTON, spp, seed)
    if kind == "bestcandidate":
        # spp > BC_SMAX repeats the tile under a per-repeat shift
        return Sampler(BESTCANDIDATE, _round_pow2(spp), seed,
                       bc=_bc_tile(seed))
    raise ValueError(f"unknown sampler {kind}")


def _pixel_key(sampler: Sampler, px, py, dim: int):
    """Per-(pixel, dimension) u32 scramble key (u32-in-int64 tensor)."""
    d = ((int(dim) + 1) * 0x9e3779b9) & smp.M32
    h = smp.hash_u32(smp.as_u32(px) ^ ((smp.as_u32(py) << 16) & smp.M32) ^ d)
    return smp.hash_u32(h ^ sampler.seed)


def _n_bits(sampler: Sampler) -> int:
    # index_permute returns values < spp (a power of two for the kinds that
    # draw the (0,2)-sequence): higher Sobol' bits fold in zero
    return max(int(sampler.spp - 1).bit_length(), 1)


def _halton_index(sampler: Sampler, px, py, s):
    # the pixel key of dimension 0 offsets the index of EVERY dimension
    return s ^ (_pixel_key(sampler, px, py, 0) >> 8)


def sample_2d(sampler: Sampler, px, py, s_idx, dim: int) -> V2:
    """(R,) pixel coords + sample indices -> V2 in [0,1)^2."""
    if sampler.kind == VECTOR:
        d = sampler.u_vec.shape[1]
        return V2(sampler.u_vec[:, dim % d], sampler.u_vec[:, (dim + 1) % d])
    s = smp.as_u32(s_idx)
    if sampler.kind == BESTCANDIDATE and dim == 0:
        t = BC_TILE
        bc = sampler.bc_tile(px.device)
        iy, ix = (py.to(torch.int64) % t), (px.to(torch.int64) % t)
        sl = s % BC_SMAX
        x, y = bc[iy, ix, sl, 0], bc[iy, ix, sl, 1]
        if sampler.spp > BC_SMAX:
            # repeat r > 0 of the tile: a toroidal (Cranley-Patterson)
            # shift drawn per repeat; repeat 0 is the table verbatim
            rep = s // BC_SMAX
            kcp = sampler.seed ^ 0xBC5D1234
            ox = smp.rng_uniform(kcp, (rep * 2) & smp.M32)
            oy = smp.rng_uniform(kcp, (rep * 2 + 1) & smp.M32)
            shift = rep > 0
            x = torch.where(shift, torch.fmod(x + ox, 1.0), x)
            y = torch.where(shift, torch.fmod(y + oy, 1.0), y)
        return V2(x, y)
    if sampler.kind in (LOWDISCREPANCY, BESTCANDIDATE):
        scr = (_pixel_key(sampler, px, py, dim),
               _pixel_key(sampler, px, py, dim + 1000))
        # independent draw ORDER per dimension group
        sp = smp.index_permute(s, sampler.spp,
                               _pixel_key(sampler, px, py, dim + 2000))
        return smp.sample02(sp, scr, _n_bits(sampler))
    if sampler.kind == STRATIFIED:
        k = _pixel_key(sampler, px, py, dim)
        perm_idx = smp.index_permute(s, sampler.spp, k)
        sx = (perm_idx % sampler.nx).to(torch.float32)
        sy = (perm_idx // sampler.nx).to(torch.float32)
        if sampler.jitter:
            jx = smp.rng_uniform(k, (s * 2) & smp.M32)
            jy = smp.rng_uniform(k, (s * 2 + 1) & smp.M32)
        else:
            jx = jy = 0.5
        return V2((sx + jx) / sampler.nx, (sy + jy) / sampler.ny)
    if sampler.kind == HALTON:
        n = _halton_index(sampler, px, py, s)
        b1 = int(smp._PRIMES[(2 * dim) % 40])
        b2 = int(smp._PRIMES[(2 * dim + 1) % 40])
        return V2(smp.radical_inverse(n, b1), smp.radical_inverse(n, b2))
    k = _pixel_key(sampler, px, py, dim)    # RANDOM
    return V2(smp.rng_uniform(k, (s * 2) & smp.M32),
              smp.rng_uniform(k, (s * 2 + 1) & smp.M32))


def sample_1d(sampler: Sampler, px, py, s_idx, dim: int):
    if sampler.kind == VECTOR:
        return sampler.u_vec[:, dim % sampler.u_vec.shape[1]]
    s = smp.as_u32(s_idx)
    if sampler.kind in (LOWDISCREPANCY, BESTCANDIDATE):
        scr = _pixel_key(sampler, px, py, dim)
        sp = smp.index_permute(s, sampler.spp,
                               _pixel_key(sampler, px, py, dim + 2000))
        return smp.van_der_corput(sp, scr)
    if sampler.kind == STRATIFIED:
        k = _pixel_key(sampler, px, py, dim)
        perm_idx = smp.index_permute(s, sampler.spp, k)
        j = smp.rng_uniform(k, s) if sampler.jitter else 0.5
        return (perm_idx.to(torch.float32) + j) / sampler.spp
    if sampler.kind == HALTON:
        n = _halton_index(sampler, px, py, s)
        return smp.radical_inverse(n, int(smp._PRIMES[(2 * dim) % 40]))
    return smp.rng_uniform(_pixel_key(sampler, px, py, dim), s)


def camera_samples(sampler: Sampler, px, py, s_idx) -> CameraSamples:
    """Image/lens/time sample triple for a wavefront. px/py int32 raster
    pixel; returns continuous raster image_xy = pixel + [0,1)^2 offset."""
    img = sample_2d(sampler, px, py, s_idx, 0)
    lens = sample_2d(sampler, px, py, s_idx, 2)
    time_u = sample_1d(sampler, px, py, s_idx, 4)
    image_xy = V2(px.to(torch.float32) + img.x, py.to(torch.float32) + img.y)
    return CameraSamples(image_xy=image_xy, lens_uv=lens, time_u=time_u)
