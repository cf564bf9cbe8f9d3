"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made from a seed with numpy and handed to the JAX reference and to
the port; results come back as numpy arrays. The only place where both
packages meet is a test.
"""
import dataclasses
import multiprocessing
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NATIVE_SO = os.path.join(ROOT, "dartray_tpu_torch", "_build",
                             "ref_native", "libbvh_builder.so")


def _use_safe_reference_builder():
    """Point the reference's native BVH builder at a copy of its library
    built once per tree, atomically and under a lock (the port's
    ``build_library``). The reference compiles its library straight onto its
    shared path (``dartray_tpu/accel/native/__init__.py``), so processes that
    start together on a fresh tree can load a half-written file, and such a
    process silently takes the numpy builder, whose trees differ. Supplied
    from outside the package, as the ``bf16`` name of known behaviour g."""
    from dartray_tpu.accel import native as ref_native
    from dartray_tpu_torch.accel.native import build_library
    build_library(os.path.join(os.path.dirname(ref_native.__file__),
                               "bvh_builder.cpp"), REF_NATIVE_SO)
    with ref_native._lock:
        ref_native._SO = REF_NATIVE_SO
        if ref_native._lib is None:       # not loaded yet, or loaded a bad file
            ref_native._tried = False


# a rank spawned for mesh_rank imports this module and runs only the port
if multiprocessing.parent_process() is None:
    _use_safe_reference_builder()


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


# fields of the port's trees that the reference's have no counterpart of,
# each held by tests of its own: the moving scene's per-time child boxes
# (tests/test_torch_motion.py)
PORT_ONLY = ("wbounds_t",)


def port_leaves(x, prefix="", port_only=False):
    """Port tree (host or device) -> {path: numpy array or scalar}; the
    fields named in ``PORT_ONLY`` are left out unless `port_only`."""
    out = {}
    if x is None or isinstance(x, (bool, int, float, str)):
        out[prefix] = x
    elif torch.is_tensor(x):
        out[prefix] = x.cpu().numpy()
    elif isinstance(x, np.ndarray):
        out[prefix] = x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            if port_only or f.name not in PORT_ONLY:
                out.update(port_leaves(getattr(x, f.name),
                                       f"{prefix}.{f.name}", port_only))
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            out.update(port_leaves(v, f"{prefix}[{i}]", port_only))
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


def ref_box_scene():
    """The small box of the reference's gradient tests
    (``tests/test_grad.py:18-40``: matte floor, back and red side wall, a
    glass sphere, an area light), built by the reference."""
    from dartray_tpu import materials as mat_mod
    from dartray_tpu.core import transform as tr
    from dartray_tpu.scene import build as sb, mesh
    b = sb.SceneBuilder()
    white = b.add_material(mat_mod.matte(kd=(0.6, 0.6, 0.6)))
    red = b.add_material(mat_mod.matte(kd=(0.7, 0.1, 0.1)))
    glass = b.add_material(mat_mod.glass())
    dark = b.add_material(mat_mod.matte(kd=(0.0, 0.0, 0.0)))
    b.add_mesh(mesh.make_mesh([[-1, 0, -1], [1, 0, -1], [1, 0, 1],
                               [-1, 0, 1]], [[0, 1, 2], [0, 2, 3]]), white)
    b.add_mesh(mesh.make_mesh([[-1, 0, 1], [1, 0, 1], [1, 2, 1],
                               [-1, 2, 1]], [[0, 1, 2], [0, 2, 3]]), white)
    b.add_mesh(mesh.make_mesh([[-1, 0, -1], [-1, 0, 1], [-1, 2, 1],
                               [-1, 2, -1]], [[0, 1, 2], [0, 2, 3]]), red)
    s = mesh.sphere(radius=0.3, nu=12, nv=6).transformed(
        np.asarray(tr.translate([0.3, 0.35, 0.2]).m))
    b.add_mesh(s, glass)
    b.add_mesh(mesh.make_mesh([[-0.4, 1.95, -0.4], [0.4, 1.95, -0.4],
                               [0.4, 1.95, 0.4], [-0.4, 1.95, 0.4]],
                              [[0, 1, 2], [0, 2, 3]]), dark,
               area_light_L=(6.0, 6.0, 6.0))
    return b.build()


def count_launches(mp):
    """Through the MonkeyPatch `mp`: a Counter of the port's traversal
    launches by kind ("closest", "any", "mixed"), counted where
    ``traverse6`` is called (its plain version on the CPU counts in
    ``LAUNCHES`` nothing)."""
    import collections
    from dartray_tpu_torch.ops import traverse_cuda as tc
    counts = collections.Counter()
    real = tc.traverse6

    def counted(bvh, o, d, tmin, tmax, *, any_hit=False, anyf=None,
                time=None):
        counts["mixed" if anyf is not None else
               "any" if any_hit else "closest"] += 1
        return real(bvh, o, d, tmin, tmax, any_hit=any_hit, anyf=anyf,
                    time=time)

    mp.setattr(tc, "traverse6", counted)
    return counts


def check_golden_image(img, want, share=0.999):
    """A port render against the reference's: finite, the same shape, at
    least `share` of pixels within rtol 1e-3 / atol 1e-4, and the mean
    within 1e-3 relative."""
    assert img.shape == want.shape and np.isfinite(img).all()
    close = np.isclose(img, want, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= share, (close.mean(), np.abs(img - want).max())
    assert abs(img.mean() - want.mean()) <= 1e-3 * want.mean()


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


def reference_cluster_walk(mp):
    """Through the MonkeyPatch `mp`, after ``eager_reference``: the
    reference traverses with its own CPU walk over the cluster BVH instead
    of its kernel in interpret mode, each of its two walks compiled once
    (``jax.jit``; an un-jitted call compiles its while loop again, 0.8 s a
    query). Same hits as its kernel's but where a ray grazes a shared
    edge."""
    import jax
    from dartray_tpu.accel import cluster as ref_cluster
    from dartray_tpu.scene import types as ref_st
    mp.setattr(ref_st, "FORCE_PALLAS_INTERPRET", False)
    mp.setattr(ref_cluster, "intersect", jax.jit(ref_cluster.intersect))
    mp.setattr(ref_cluster, "intersect_p", jax.jit(ref_cluster.intersect_p))


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


def mesh_rank(rank, world, init_file, shape, name, filter_name, out_dir):
    """One spawned CPU rank of a gloo process group (rendezvous through the
    file `init_file`): ``render_sharded`` and ``sharded_film`` of
    ``tools/make_mesh_golden.py``'s configuration `name` with `filter_name`
    over a `shape` mesh, saved to `out_dir`/rank<rank>.npz as img, pixels
    and the mesh shapes that ``make_device_mesh`` refused (raised)."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_mesh_golden as golden
    from dartray_tpu_torch.parallel import mesh as pm
    assert pm.init_distributed(f"file://{init_file}", world, rank,
                               device="cpu")
    try:
        raised = []             # known behaviour aj: the world must fit
        for cells in ((1, 1), (world, 2)):
            try:
                pm.make_device_mesh(*cells)
            except ValueError:
                raised.append(cells)
        scene, cam, smp, li, _ = golden.port_setup(name, "cpu")
        m = pm.make_device_mesh(*shape)
        img = pm.render_sharded(scene, cam, smp, li, golden.W, golden.H, m,
                                filter_name=filter_name, device="cpu")
        pixels, _ = pm.sharded_film(scene, cam, smp, li, golden.W, golden.H,
                                    m, filter_name=filter_name, device="cpu")
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), img=img,
                 pixels=pixels, raised=np.asarray(raised))
    finally:
        dist.destroy_process_group()
