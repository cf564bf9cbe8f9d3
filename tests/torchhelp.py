"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made from a seed with numpy and handed to the JAX reference and to
the port; results come back as numpy arrays. The only place where both
packages meet is a test.
"""
import dataclasses

import numpy as np
import torch


def np_tree(x):
    """Reference pytree -> plain containers with numpy leaves: dataclasses
    become dicts keyed by field name, (named) tuples become tuples, arrays
    become numpy arrays. This is what the port's adapter takes."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: np_tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return tuple(np_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: np_tree(v) for k, v in x.items()}
    return np.asarray(x)


def port_leaves(x, prefix=""):
    """Port tree (host or device) -> {path: numpy array or scalar}."""
    out = {}
    if x is None or isinstance(x, (bool, int, float, str)):
        out[prefix] = x
    elif torch.is_tensor(x):
        out[prefix] = x.cpu().numpy()
    elif isinstance(x, np.ndarray):
        out[prefix] = x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            out.update(port_leaves(getattr(x, f.name), f"{prefix}.{f.name}"))
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            out.update(port_leaves(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = x
    return out


def ref_leaf(tree, path):
    """Look a port_leaves path up in an np_tree of the reference."""
    cur = tree
    for part in path.replace("[", ".[").split("."):
        if not part:
            continue
        if part.startswith("["):
            cur = cur[int(part[1:-1])]
        else:
            cur = cur[part]
    return cur


def same_bits(a, b):
    """Bit-exact equality of two arrays (NaN pads and int-in-f32 columns
    included): same dtype, same shape, same bytes."""
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def soup(n=400, seed=0):
    rng = np.random.RandomState(seed)
    v0 = rng.randn(n, 3).astype(np.float32)
    e1 = (rng.randn(n, 3) * 0.4).astype(np.float32)
    e2 = (rng.randn(n, 3) * 0.4).astype(np.float32)
    return v0, e1, e2


def ray_arrays(n=512, seed=1):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32) * 2.0
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def t3(a):
    """(R, 3) numpy -> port V3 on the CPU."""
    from dartray_tpu_torch.core.math import V3
    a = np.ascontiguousarray(a, np.float32)
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, c]))
                for c in range(3)))


def j3(a):
    """(R, 3) numpy -> reference V3."""
    import jax.numpy as jnp
    from dartray_tpu.core.math import V3
    return V3(*(jnp.asarray(a[:, c]) for c in range(3)))


def n3(v):
    """V3 of either package -> (R, 3) numpy."""
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], -1)


def eager_reference(mp):
    """Put the reference into the mode the whole-wave tests compare against,
    through the MonkeyPatch `mp`: its Pallas traversal kernels in interpret
    mode, and ``jax.lax.fori_loop`` as a Python loop where its bounds are
    Python ints (the loops over lights and probes, which would otherwise
    compile a traversal loop for a minute): the body runs eagerly, with an
    int32 array for its index as it would see when traced. A loop with traced
    bounds (inside the Pallas kernels) stays the real one."""
    import jax
    import jax.numpy as jnp
    from dartray_tpu.scene import types as ref_st
    real = jax.lax.fori_loop

    def fori_loop(lower, upper, body, init):
        if not (isinstance(lower, int) and isinstance(upper, int)):
            return real(lower, upper, body, init)
        val = init
        for i in range(lower, upper):
            val = body(jnp.int32(i), val)
        return val

    mp.setattr(ref_st, "FORCE_PALLAS_INTERPRET", True)
    mp.setattr(jax.lax, "fori_loop", fori_loop)


def hold_rays_independent(walk, n, seed):
    """The raw (t, prim) of a ray must not depend on the lanes beside it.

    `walk(sel)` runs the wave made of rays `sel` (indices into a base wave
    of `n` rays; -1 stands for a dead lane put in between) and returns raw
    (t, prim) as numpy arrays. Held against the base wave walked at once: the
    wave permuted, cut into batches of 32 with a ragged tail, and with dead
    lanes interleaved (one after every third ray and a whole batch of 32 in
    the middle). A kernel may hand rays to warps in any of these ways."""
    base_t, base_p = walk(np.arange(n))
    assert (base_p >= 0).any() and (base_p < 0).any()
    perm = np.random.RandomState(seed).permutation(n)
    t, p = walk(perm)
    assert same_bits(t, base_t[perm]) and same_bits(p, base_p[perm])
    m = n - 12                       # the last batch holds 20 rays
    for s in range(0, m, 32):
        sel = np.arange(s, min(s + 32, m))
        t, p = walk(sel)
        assert same_bits(t, base_t[sel]) and same_bits(p, base_p[sel]), s
    sel = []
    for i in range(n):
        sel.append(i)
        if i % 3 == 2:
            sel.append(-1)
        if i == n // 2:
            sel += [-1] * 32
    sel = np.asarray(sel)
    t, p = walk(sel)
    live = sel >= 0
    assert same_bits(t[live], base_t[sel[live]])
    assert same_bits(p[live], base_p[sel[live]])
    assert np.isposinf(t[~live]).all() and (p[~live] == -1).all()
