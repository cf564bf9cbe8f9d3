"""Counter-based random draws, bit for bit those of ``jax.random`` with its
default threefry2x32 generator and partitionable counters (the draws the
JAX reference's Metropolis renderer makes).

A key is a pair of uint32 words, held here as a numpy ``(2,)`` uint32
array (host). ``threefry2x32`` is the 20-round Threefry-2x32 block cipher
(rotations 13 15 26 6 / 17 29 16 24, key parity 0x1BD11BDA). A draw of
shape S feeds it the counters of a flat uint64 iota over S split into
(high, low) 32-bit words:

* ``split(key, n)``: the n keys are the cipher's (x0, x1) outputs;
* ``uniform(key, shape)``: bits x0 ^ x1, then
  float32 bits ``(b >> 9) | 0x3f800000`` minus 1;
* ``randint(key, shape, lo, hi)`` (int32): the key split in two, high bits
  from the first and low bits from the second, offset
  ``(hi_bits % span) * mult + lo_bits % span`` with
  ``mult = (2^16 % span)^2 % span`` computed in uint32 (it wraps to 0 for
  span 2^31 - 1, so the offset is the low bits' remainder).

Key handling is host numpy; ``uniform`` runs on the device it is given, in
int64 torch operations masked to 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rounds(x0, x1, key, rotl, add):
    """The cipher over counter words (x0, x1) with one key, in a backend
    given by `rotl(x, r)` and `add(a, b)` (both mod 2^32)."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = add(x0, ks[0])
    x1 = add(x1, ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = add(x0, x1)
            x1 = rotl(x1, r) ^ x0
        x0 = add(x0, ks[(i + 1) % 3])
        x1 = add(x1, (ks[(i + 2) % 3] + i + 1) & M32)
    return x0, x1


def _np_rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _np_add(a, b):
    return a + (np.uint32(b) if isinstance(b, int) else b)


def threefry2x32(key, x0, x1):
    """Host: the cipher on uint32 numpy counter words."""
    with np.errstate(over="ignore"):
        return _rounds(np.asarray(x0, np.uint32), np.asarray(x1, np.uint32),
                       key, _np_rotl, _np_add)


def _iota_words(n):
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(M32)).astype(np.uint32))


def PRNGKey(seed: int) -> np.ndarray:
    """The key of an integer seed: [0, seed] for a seed below 2^32."""
    seed = int(seed)
    return np.array([(seed >> 32) & M32, seed & M32], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """(num, 2) uint32 keys."""
    hi, lo = _iota_words(num)
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def _bits_np(key, shape):
    hi, lo = _iota_words(int(np.prod(shape, dtype=np.int64)))
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """int32 draws in [minval, maxval) (host; int32 bounds)."""
    k1, k2 = split(key)
    higher, lower = _bits_np(k1, shape), _bits_np(k2, shape)
    span = np.uint32(max(maxval - minval, 1) & M32)
    with np.errstate(over="ignore"):
        mult = np.uint32(np.uint32(1 << 16) % span)
        mult = np.uint32(mult * mult) % span
        off = (higher % span) * mult + lower % span
    off = off % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def _t_rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def _t_add(a, b):
    return (a + b) & M32


def bits(key, shape, device) -> torch.Tensor:
    """uint32 draws (as int64 in [0, 2^32)) of `shape` on `device`."""
    n = int(np.prod(shape, dtype=np.int64))
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _rounds(i >> 32, i & M32, key, _t_rotl, _t_add)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, device) -> torch.Tensor:
    """float32 draws in [0, 1) of `shape` on `device`."""
    b = (bits(key, shape, device) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0
