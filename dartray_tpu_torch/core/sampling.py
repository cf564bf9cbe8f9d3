"""Monte-Carlo sampling utilities, vectorized over wavefronts (counterpart of
the JAX reference's ``core/sampling.py``).

The random numbers are counter-based hashes, deterministic in (pixel,
sample index, dimension, seed), and the (0,2)-sequence bit tricks are
reproduced BIT-EXACTLY. PyTorch has no full set of uint32 operations, so
every "uint32" value here is an int64 tensor holding a value in [0, 2^32):
each multiply, add and left shift is followed by ``& M32``, and right shifts
always see a non-negative value, so they are logical shifts.

Ported: the hash RNG, ``index_permute``, ``van_der_corput``, ``sobol2``,
``sample02`` and the warps the integrators use (concentric disk, cosine
hemisphere, uniform sphere, uniform triangle, power heuristic). Halton / radical inverse,
stratified and Latin-hypercube helpers and the 1D/2D distributions are not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from . import math as vm

M32 = 0xFFFFFFFF
ONE_MINUS_EPS = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
_INV_2_32 = float(np.float32(2.3283064365386963e-10))
_INV_2_24 = float(np.float32(1.0 / (1 << 24)))


def as_u32(x):
    """int tensor -> int64 tensor holding the value's uint32 bit pattern."""
    return x.to(torch.int64) & M32


def hash_u32(x):
    """Finalizer-style integer hash (murmur3 fmix32) on u32-in-int64."""
    x = x & M32
    x = x ^ (x >> 16)
    x = (x * 0x7feb352d) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846ca68b) & M32
    x = x ^ (x >> 16)
    return x


def index_permute(i, n: int, key):
    """Deterministic pseudo-random permutation of [0, n) (Kensler's
    cycle-walking hash bijection): each dimension group draws the sample
    sequence in an independent order. i, key: u32-in-int64 tensors."""
    if n <= 1:
        return torch.zeros_like(i)
    w = n - 1
    w |= w >> 1
    w |= w >> 2
    w |= w >> 4
    w |= w >> 8
    w |= w >> 16
    p = key.expand_as(i) if key.shape != i.shape else key
    i = i & w

    def mix(x):
        x = x ^ p
        x = (x * 0xe170893d) & M32
        x = x ^ (p >> 16)
        x = x ^ ((x & w) >> 4)
        x = x ^ (p >> 8)
        x = (x * 0x0929eb3f) & M32
        x = x ^ (p >> 23)
        x = x ^ ((x & w) >> 1)
        x = (x * (1 | (p >> 27))) & M32
        x = (x * 0x6935fa69) & M32
        x = x ^ ((x & w) >> 11)
        x = (x * 0x74dcb303) & M32
        x = x ^ ((x & w) >> 2)
        x = (x * 0x9e501cc3) & M32
        x = x ^ ((x & w) >> 2)
        x = (x * 0xc860a3df) & M32
        x = x & w
        x = x ^ (x >> 5)
        return x

    x = mix(i)
    if n != w + 1:
        # cycle walk: re-mix lanes that landed >= n. For a power of two
        # (every low-discrepancy sample count) mix() already ends in
        # [0, n) and the walk would change nothing.
        for _ in range(7):
            x = torch.where(x >= n, mix(x), x)
        x = torch.where(x >= n, i, x)  # astronomically rare fallback
    return ((x + p) & M32) % n


def uniform_from_bits(bits):
    """u32 -> float32 in [0, 1). Uses the top 24 bits."""
    return ((bits >> 8).to(torch.float32) * _INV_2_24).clamp_max(
        ONE_MINUS_EPS)


def rng_uniform(key, counter):
    """Deterministic uniform [0,1) from (key, counter) u32 pairs."""
    return uniform_from_bits(hash_u32(key ^ hash_u32(counter)))


def van_der_corput(n, scramble):
    """Bit-reversed base-2 radical inverse with XOR scramble."""
    n = n & M32
    n = ((n << 16) & M32) | (n >> 16)
    n = ((n & 0x00ff00ff) << 8) | ((n & 0xff00ff00) >> 8)
    n = ((n & 0x0f0f0f0f) << 4) | ((n & 0xf0f0f0f0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xcccccccc) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xaaaaaaaa) >> 1)
    n = n ^ scramble
    return (n.to(torch.float32) * _INV_2_32).clamp_max(ONE_MINUS_EPS)


def sobol2(n, scramble, n_bits: int = 32):
    """Second Sobol' dimension: generator-matrix XOR fold over the bits of
    n. `n_bits`: callers that know n < 2**n_bits may stop the fold there
    (the skipped steps would XOR in zero)."""
    n = n & M32
    s = scramble.expand_as(n) if scramble.shape != n.shape else scramble
    v = 1 << 31
    for i in range(n_bits):
        s = s ^ (((n >> i) & 1) * v)
        v ^= v >> 1
    return (s.to(torch.float32) * _INV_2_32).clamp_max(ONE_MINUS_EPS)


def sample02(n, scramble2, n_bits: int = 32):
    """(0,2)-sequence 2D sample; scramble2 is a pair of u32 tensors."""
    return vm.V2(van_der_corput(n, scramble2[0]),
                 sobol2(n, scramble2[1], n_bits))


# --- Geometric sampling transforms -----------------------------------------

def concentric_sample_disk(u):
    """Shirley-Chiu concentric disk mapping, branch-free over the wedges."""
    u = vm.from_arr2(u)
    sx = 2.0 * u.x - 1.0
    sy = 2.0 * u.y - 1.0
    zero = (sx == 0.0) & (sy == 0.0)
    abs_x_big = torch.abs(sx) > torch.abs(sy)
    r = torch.where(abs_x_big, sx, sy)
    safe = lambda a, b: a / torch.where(torch.abs(b) < 1e-30, 1.0, b)
    theta = torch.where(abs_x_big,
                        (np.pi / 4.0) * safe(sy, sx),
                        (np.pi / 2.0) - (np.pi / 4.0) * safe(sx, sy))
    r = torch.where(zero, 0.0, r)
    return r * torch.cos(theta), r * torch.sin(theta)


def cosine_sample_hemisphere(u):
    """pdf = cos(theta)/pi. Returns V3."""
    x, y = concentric_sample_disk(u)
    z = torch.sqrt((1.0 - x * x - y * y).clamp_min(0.0))
    return vm.V3(x, y, z)


def cosine_hemisphere_pdf(costheta):
    return costheta * float(np.float32(1.0 / np.pi))


def uniform_sample_sphere(u):
    """pdf = 1 / (4 pi). Returns V3."""
    u = vm.from_arr2(u)
    z = 1.0 - 2.0 * u.x
    r = torch.sqrt((1.0 - z * z).clamp_min(0.0))
    phi = 2.0 * np.pi * u.y
    return vm.V3(r * torch.cos(phi), r * torch.sin(phi), z)


def uniform_sample_triangle(u):
    """Barycentric (b1, b2) of a uniform point on a triangle."""
    u = vm.from_arr2(u)
    su1 = torch.sqrt(u.x)
    return 1.0 - su1, u.y * su1


# --- MIS heuristic ----------------------------------------------------------

def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / (f * f + g * g).clamp_min(1e-30)
