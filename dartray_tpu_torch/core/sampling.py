"""Monte-Carlo sampling utilities, vectorized over wavefronts (counterpart of
the JAX reference's ``core/sampling.py``).

The random numbers are counter-based hashes, deterministic in (pixel,
sample index, dimension, seed), and the (0,2)-sequence bit tricks are
reproduced BIT-EXACTLY. PyTorch has no full set of uint32 operations, so
every "uint32" value here is an int64 tensor holding a value in [0, 2^32):
each multiply, add and left shift is followed by ``& M32``, and right shifts
always see a non-negative value, so they are logical shifts.

Every public name of the reference's module has its counterpart here but
``U32`` (the "uint32" convention above stands for it). A key-taking helper
(``stratified_sample_1d`` / ``_2d``, ``shuffle_permutation``,
``latin_hypercube``) takes its key as a u32-in-int64 tensor and returns
tensors on the key's device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
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


def hash_combine(a, b):
    """hash(a ^ (0x9e3779b9 + (b << 6))) in u32; a, b: u32-in-int64
    tensors or Python ints (at least one a tensor)."""
    return hash_u32((a & M32) ^ ((0x9e3779b9 + ((b << 6) & M32)) & M32))


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


def ld_shuffle_scrambled_1d(n_samples_log2_rounded: int):
    raise NotImplementedError  # covered by the samplers' wave layouts


# --- Radical inverse (the Halton sampler) ----------------------------------

_PRIMES = np.array([
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149,
    151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229],
    np.int64)


def radical_inverse(n, base: int):
    """Radical inverse of `n` (u32-in-int64, read as int32) in `base`:
    a fixed trip of ceil(32 / log2 base) + 1 digits, each added in float32
    as one fused multiply-add ``fma(digit, base**-k, val)`` (the reference's
    loop compiles to one), with base**-k the float32 running product of
    1/base. The fused step is taken in float64: the product of a digit and
    a float32 is exact there, and so is the sum for every index below
    2**24, so rounding it to float32 rounds once, as the fused op does."""
    n_digits = int(np.ceil(32 / np.log2(base))) + 1
    inv_base = np.float32(1.0 / base)
    nn = ((n.to(torch.int64) & M32) ^ 0x80000000) - 0x80000000   # int32
    val = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    inv_bi = inv_base
    for _ in range(n_digits):
        val = (val.to(torch.float64)
               + (nn % base).to(torch.float64) * float(inv_bi)
               ).to(torch.float32)
        inv_bi = np.float32(inv_bi * inv_base)
        nn = nn // base
    return val.clamp_max(ONE_MINUS_EPS)


def permuted_radical_inverse(n, base: int, perm):
    """Digit-scrambled radical inverse (PermutedHalton): radical_inverse
    with each digit d replaced by perm[d]; perm: (base,) int tensor on n's
    device. The same float32 fused step as radical_inverse."""
    n_digits = int(np.ceil(32 / np.log2(base))) + 1
    inv_base = np.float32(1.0 / base)
    nn = ((n.to(torch.int64) & M32) ^ 0x80000000) - 0x80000000   # int32
    perm = perm.to(torch.float64)
    val = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    inv_bi = inv_base
    for _ in range(n_digits):
        val = (val.to(torch.float64) + perm[nn % base] * float(inv_bi)
               ).to(torch.float32)
        inv_bi = np.float32(inv_bi * inv_base)
        nn = nn // base
    return val.clamp_max(ONE_MINUS_EPS)


def halton_permutations(n_dims: int, seed: int = 0,
                        device=device_mod.DEFAULT):
    """Random digit permutations for PermutedHalton, made on the host from
    `seed`: (bases, [(base,) int32 tensor on `device` a dimension])."""
    dev = device_mod.resolve(device)
    rng = np.random.RandomState(seed)
    perms = []
    for i in range(n_dims):
        b = int(_PRIMES[i])
        perms.append(torch.as_tensor(rng.permutation(b).astype(np.int32),
                                     device=dev))
    return [int(_PRIMES[i]) for i in range(n_dims)], perms


# --- Geometric sampling transforms -----------------------------------------

def uniform_sample_hemisphere(u):
    """2D sample -> V3 direction about +z, pdf = 1 / (2 pi)."""
    u = vm.from_arr2(u)
    z = u.x
    r = torch.sqrt((1.0 - z * z).clamp_min(0.0))
    phi = 2.0 * np.pi * u.y
    return vm.V3(r * torch.cos(phi), r * torch.sin(phi), z)


UNIFORM_HEMISPHERE_PDF = float(1.0 / (2.0 * np.pi))


def uniform_sample_disk(u):
    """2D sample -> (x, y) uniform on the unit disk (polar map)."""
    u = vm.from_arr2(u)
    r = torch.sqrt(u.x)
    theta = 2.0 * np.pi * u.y
    return r * torch.cos(theta), r * torch.sin(theta)


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


UNIFORM_SPHERE_PDF = float(1.0 / (4.0 * np.pi))


def uniform_sample_cone(u, cos_theta_max):
    """Direction in the cone of half-angle acos(cos_theta_max) about +z."""
    u = vm.from_arr2(u)
    costheta = (1.0 - u.x) + u.x * cos_theta_max
    sintheta = torch.sqrt((1.0 - costheta * costheta).clamp_min(0.0))
    phi = u.y * 2.0 * np.pi
    return vm.V3(torch.cos(phi) * sintheta, torch.sin(phi) * sintheta,
                 costheta)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * np.pi * (1.0 - cos_theta_max).clamp_min(1e-8))


def uniform_sample_triangle(u):
    """Barycentric (b1, b2) of a uniform point on a triangle."""
    u = vm.from_arr2(u)
    su1 = torch.sqrt(u.x)
    return 1.0 - su1, u.y * su1


# --- MIS heuristics ---------------------------------------------------------

def balance_heuristic(nf, f_pdf, ng, g_pdf):
    return (nf * f_pdf) / (nf * f_pdf + ng * g_pdf).clamp_min(1e-30)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / (f * f + g * g).clamp_min(1e-30)


# --- Stratified / LHS / shuffle ---------------------------------------------

def stratified_sample_1d(n: int, key, jitter=True):
    """n stratified samples in [0, 1); key: 0-d u32-in-int64 tensor."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    u = (rng_uniform(key.expand(n), i) if jitter
         else torch.full((n,), 0.5, dtype=torch.float32, device=key.device))
    return ((i.to(torch.float32) + u) / n).clamp_max(ONE_MINUS_EPS)


def stratified_sample_2d(nx: int, ny: int, key):
    """(nx * ny, 2) jittered grid samples, x fastest; key as above."""
    dev = key.device
    gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=dev),
                            torch.arange(nx, dtype=torch.float32, device=dev),
                            indexing="ij")
    flat = torch.arange(nx * ny, dtype=torch.int64, device=dev)
    keyb = key.expand(nx * ny)
    jx = rng_uniform(keyb, (flat * 2) & M32)
    jy = rng_uniform(keyb, (flat * 2 + 1) & M32)
    sx = ((gx.reshape(-1) + jx) / nx).clamp_max(ONE_MINUS_EPS)
    sy = ((gy.reshape(-1) + jy) / ny).clamp_max(ONE_MINUS_EPS)
    return torch.stack([sx, sy], dim=-1)


def shuffle_permutation(n: int, key):
    """Pseudo-random permutation of [0, n) from a u32 key: the stable
    argsort of hashed keys."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    k = hash_u32(key.expand(n) ^ hash_u32(i))
    return torch.argsort(k, stable=True)


def latin_hypercube(n: int, dims: int, key):
    """(n, dims) Latin-hypercube samples: a jittered diagonal, each
    dimension shuffled by its own key."""
    delta = 1.0 / n
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    cols = []
    for d in range(dims):
        keyb = (key + 7919 * d) & M32
        u = rng_uniform(keyb.expand(n), i)
        vals = ((i.to(torch.float32) + u) * delta).clamp_max(ONE_MINUS_EPS)
        perm = shuffle_permutation(n, keyb ^ 0xabcdef01)
        cols.append(vals[perm])
    return torch.stack(cols, dim=-1)


# --- Distribution1D / Distribution2D (host numpy) -----------------------------

class Distribution1D:
    """Piecewise-constant 1D distribution(s) over the last axis, built on the
    host. func: (..., n) non-negative; cdf (..., n+1). An all-zero row falls
    back to the uniform distribution."""

    def __init__(self, func):
        func = np.asarray(func, np.float32)
        n = func.shape[-1]
        cdf = np.concatenate([np.zeros(func.shape[:-1] + (1,), np.float32),
                              np.cumsum(func / n, axis=-1)], axis=-1)
        total = cdf[..., -1:]
        uniform_cdf = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
        uniform_cdf = np.broadcast_to(uniform_cdf, cdf.shape)
        self.degenerate = total[..., 0] == 0.0
        self.cdf = np.where(self.degenerate[..., None], uniform_cdf,
                            cdf / np.where(total == 0.0, 1.0, total))
        self.func = np.where(self.degenerate[..., None], np.ones_like(func),
                             func)
        self.func_int = np.where(self.degenerate, 1.0 / n, total[..., 0])
        self.n = n


class Distribution2D:
    """2D distribution: one conditional per row plus the marginal over rows,
    as flat arrays: cond_cdf (nv, nu+1), cond_func (nv, nu), cond_int (nv,),
    marg_cdf (nv+1,), marg_func (nv,), marg_int ()."""

    def __init__(self, func2d):
        func2d = np.asarray(func2d, np.float32)  # (nv, nu)
        nv, nu = func2d.shape
        self.nu, self.nv = nu, nv
        cond = Distribution1D(func2d)             # batched over rows
        self.cond_cdf = cond.cdf
        self.cond_func = cond.func
        self.cond_int = cond.func_int
        marg = Distribution1D(self.cond_int)
        self.marg_cdf = marg.cdf
        self.marg_func = marg.func
        self.marg_int = marg.func_int


# --- Henyey-Greenstein phase function ---------------------------------------

def _f32(g):
    """A scalar or per-lane asymmetry g as float32: a scalar becomes a 0-dim
    CPU tensor, so that g * g is a float32 product as in the reference."""
    return torch.as_tensor(g, dtype=torch.float32)


def sample_hg(w, u, g):
    """Henyey-Greenstein phase sampling about the V3 direction w (|g| below
    1e-3 samples the sphere uniformly). Returns V3."""
    u = vm.from_arr2(u)
    w = vm.from_arr(w)
    g = _f32(g)
    iso = torch.abs(g) < 1e-3
    den = 1.0 - g + 2.0 * g * u.x
    sq = (1.0 - g * g) / torch.where(torch.abs(den) < 1e-12, 1.0, den)
    two_g = 2.0 * g
    costheta_hg = (1.0 + g * g - sq * sq) / torch.where(
        torch.abs(two_g) < 1e-12, 1.0, two_g)
    costheta = torch.where(iso, 1.0 - 2.0 * u.x, costheta_hg)
    sintheta = torch.sqrt((1.0 - costheta * costheta).clamp_min(0.0))
    phi = 2.0 * np.pi * u.y
    v1, v2 = vm.coordinate_system(w)
    return (v1 * (sintheta * torch.cos(phi)) + v2 * (sintheta * torch.sin(phi))
            + w * costheta)


def hg_pdf(cos_theta, g):
    """Henyey-Greenstein phase function value."""
    g = _f32(g)
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 / (4.0 * np.pi)) * (1.0 - g * g) / (
        denom * torch.sqrt(denom.clamp_min(1e-12))).clamp_min(1e-12)
