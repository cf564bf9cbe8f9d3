"""Sample values of the samplers the benchmark's traffic uses, frozen here.

A copy of the counter-based hashing of ``dartray_tpu_torch/core/sampling.py``
(``hash_u32``, ``index_permute``, ``rng_uniform``, ``van_der_corput``,
``sobol2``) and of the ``lowdiscrepancy`` and ``stratified`` branches of
``dartray_tpu_torch/samplers.py`` (``_pixel_key``, ``sample_1d``,
``sample_2d``), taken at the port's seventeenth slice. Every value is a pure
function of (pixel, sample index, dimension, seed), so the reference draws
the same numbers as the program for any lane without sharing its state.
Unsigned 32-bit values are int64 tensors holding [0, 2**32); the float
results are float32 (a control casts them afterwards).
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
ONE_MINUS_EPS = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
INV_2_32 = float(np.float32(2.3283064365386963e-10))
INV_2_24 = float(np.float32(1.0 / (1 << 24)))


def u32(x):
    return x.to(torch.int64) & M32


def hash_u32(x):
    x = x & M32
    x = x ^ (x >> 16)
    x = (x * 0x7feb352d) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846ca68b) & M32
    return x ^ (x >> 16)


def index_permute(i, n, key):
    """Kensler's hashed permutation of [0, n), n a power of two or not."""
    if n <= 1:
        return torch.zeros_like(i)
    w = n - 1
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    p = key
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
        return x ^ (x >> 5)

    x = mix(i)
    if n != w + 1:
        for _ in range(7):
            x = torch.where(x >= n, mix(x), x)
        x = torch.where(x >= n, i, x)
    return ((x + p) & M32) % n


def uniform_from_bits(bits):
    return ((bits >> 8).to(torch.float32) * INV_2_24).clamp_max(
        ONE_MINUS_EPS)


def rng_uniform(key, counter):
    return uniform_from_bits(hash_u32(key ^ hash_u32(counter)))


def van_der_corput(n, scramble):
    n = n & M32
    n = ((n << 16) & M32) | (n >> 16)
    n = ((n & 0x00ff00ff) << 8) | ((n & 0xff00ff00) >> 8)
    n = ((n & 0x0f0f0f0f) << 4) | ((n & 0xf0f0f0f0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xcccccccc) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xaaaaaaaa) >> 1)
    n = n ^ scramble
    return (n.to(torch.float32) * INV_2_32).clamp_max(ONE_MINUS_EPS)


def sobol2(n, scramble, n_bits=32):
    n = n & M32
    s = scramble.expand_as(n)
    v = 1 << 31
    for i in range(n_bits):
        s = s ^ (((n >> i) & 1) * v)
        v ^= v >> 1
    return (s.to(torch.float32) * INV_2_32).clamp_max(ONE_MINUS_EPS)


def sample02(n, scr_x, scr_y, n_bits=32):
    return van_der_corput(n, scr_x), sobol2(n, scr_y, n_bits)


class Sampler:
    """The sampler of a traffic mix: ``kind`` is "lowdiscrepancy" or
    "stratified"; ``spp`` the samples of a frame as the program rounds them
    (a power of two for lowdiscrepancy, nx * ny for stratified)."""

    def __init__(self, kind: str, spp: int, seed: int):
        self.kind = kind
        self.seed = int(seed) & M32
        if kind == "lowdiscrepancy":
            self.spp = 1 << max(int(np.ceil(np.log2(max(spp, 1)))), 0)
        elif kind == "stratified":
            self.nx = max(int(np.round(np.sqrt(spp))), 1)
            self.ny = max((spp + self.nx - 1) // self.nx, 1)
            self.spp = self.nx * self.ny
        else:
            raise ValueError(f"the reference has no {kind!r} sampler")
        self.n_bits = max(int(self.spp - 1).bit_length(), 1)

    def key(self, px, py, dim):
        d = ((int(dim) + 1) * 0x9e3779b9) & M32
        h = hash_u32(u32(px) ^ ((u32(py) << 16) & M32) ^ d)
        return hash_u32(h ^ self.seed)

    def get2(self, px, py, s, dim):
        s = u32(s)
        if self.kind == "lowdiscrepancy":
            sp = index_permute(s, self.spp, self.key(px, py, dim + 2000))
            return sample02(sp, self.key(px, py, dim),
                            self.key(px, py, dim + 1000), self.n_bits)
        k = self.key(px, py, dim)
        perm = index_permute(s, self.spp, k)
        sx = (perm % self.nx).to(torch.float32)
        sy = (perm // self.nx).to(torch.float32)
        jx = rng_uniform(k, (s * 2) & M32)
        jy = rng_uniform(k, (s * 2 + 1) & M32)
        return (sx + jx) / self.nx, (sy + jy) / self.ny

    def get1(self, px, py, s, dim):
        s = u32(s)
        if self.kind == "lowdiscrepancy":
            sp = index_permute(s, self.spp, self.key(px, py, dim + 2000))
            return van_der_corput(sp, self.key(px, py, dim))
        k = self.key(px, py, dim)
        perm = index_permute(s, self.spp, k)
        return (perm.to(torch.float32) + rng_uniform(k, s)) / self.spp
