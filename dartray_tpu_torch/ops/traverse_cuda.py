"""BVH traversal: the CUDA kernels' wrappers, their plain PyTorch versions
and the wavefront glue around them (counterpart of the JAX reference's
``ops/traverse_pallas.py`` and of its ``ops/kernels_attic.py``).

Seven traversal libraries, each built with ``nvcc`` for ``sm_90a`` at first
use from its source under ``csrc/`` and loaded with ``ctypes`` (the same
loader builds the sampler's hashing, which ``ops/sampler_cuda.py``
registers). Over the WIDE (8-ary) tree:

* ``traverse6`` (``csrc/traverse6.cu``) replaces ``_kernel6`` in its
  closest-hit, any-hit and mixed modes: one stack per ray, one thread per
  ray, and every ray pops its own stack in its own octant's order. The warp
  only decides WHEN and BY WHOM a step is done: a lane holds a popped leaf
  until all 32 lanes hold one or have an empty stack; where at most 16
  lanes hold one, the warp tests them one ray at a time, lane j on triangle
  j, and folds the 32 results as the sequential loop would; otherwise every
  lane loops over its own leaf, the next row fetched before the current
  test. A ray's raw ``(t, prim)`` therefore does not depend on the lanes
  beside it and equals ``traverse6_plain``'s bit for bit. With ``time=`` on
  a scene packed with deltas it launches the kernel's motion instantiation,
  which lerps every child box (``wbounds_t``) and leaf triangle to the
  ray's shutter time.
* ``traverse5`` (``csrc/traverse5.cu``) replaces ``_kernel5``: a PACKET walk,
  one shared stack for ``PACKET`` = 32 consecutive rays (a warp), the
  packet's majority octant orders the pushes, a child is pushed if any live
  ray of the packet hits its box, every live ray tests a popped leaf.
  Optional counters (node steps and leaf clusters per packet).
* ``traverse7`` (``csrc/traverse7.cu``) replaces ``_kernel7``: the same packet
  walk with the Woop unit-triangle leaf test over the opt-in ``woop`` table
  (``with_woop``).

Over the BINARY cluster tree (``bounds`` / ``meta`` / ``meta2``), the
reference's four older kernels, one stack a packet; they differ in what
differs as a function (``ATTIC`` holds the table). The block packets v1 and v3
share ``csrc/block_walk.cuh``, the warp packets v2 and v4
``csrc/binary_walk.cuh``, and all four the leaf pieces of
``csrc/leaf_fold.cuh``: a leaf that few lanes of a warp test is served one
ray at a time by the warp, and v2, v3 and v4 stage their buffered clusters in
shared memory as they buffer them:

* ``traverse`` (v1, ``csrc/traverse1.cu``) replaces ``_kernel``: ONE stack for
  a packet of 128 rays (a thread block), the popped node is slab-tested at
  the pop, a popped leaf is tested at once by the lanes that hit its box,
  strict sequential fold.
* ``traverse2`` (v2, ``csrc/traverse2.cu``) replaces ``_kernel2``: a packet of
  32 rays (a warp) with its own stack and a leaf buffer of 8, strict fold.
* ``traverse3`` (v3, ``csrc/traverse3.cu``) replaces ``_kernel3``: v1's packet
  with the compact ``meta2`` table, a leaf buffer of 16 flushed in buffer
  order, the index-packed fold, and optional counters.
* ``traverse4`` (v4, ``csrc/traverse4.cu``) replaces ``_kernel4``: v2's packet
  with ``meta2`` and the packed fold.

Their tie rules are the reference's own and differ from the wide kernels':
the strict fold accepts ``t < t_best`` only (``tmax`` itself is outside the
interval, the first of equal t wins); the packed fold clears the low 7 bits
of t's pattern, puts the triangle's slot there and takes the integer minimum,
so t is rounded DOWN by up to 127 ulps, ``t_best`` culls with the rounded
value and the lowest slot wins a tie. An any-hit lane still folds over all K
triangles of the leaf that blocks it. What has no counterpart here, because
it is a shape of the other machine and not part of the function: the
(rows, 128) ray tiles, the sentinel null node and null cluster that keep
lockstep packets branch-free, the spill round-trip that turns the majority
sign into scalars, and the SMEM-or-VMEM placement of ``meta2``. The triangle
operand stays ``soup16`` (48 B a triangle), not nine (C, K) planes.

All return ``(t, permuted prim)`` only; exact ``t`` and barycentrics are
recomputed for the winners by one gathered Moeller-Trumbore evaluation
(``finish_hits`` / ``finish_hits_rows``), so results are compared after that
finish step, never on a kernel's raw ``t``. Tie rule of every kernel and
plain version here: the nearest accepted ``t`` in ``(tmin, tmax]`` wins, equal
``t`` keeps the first triangle met (cluster order inside a leaf); an any-hit
lane takes the first accepted triangle and stops. That is the rule of the
three wide kernels; the binary-tree kernels keep the reference's, above.

The reference kernels' ablation and work-around switches (the ``DR_V6_*``
environment knobs, ``bf16=``, ``push_bits``, the ``block_rows`` widths) have no
counterpart here: they probe or work around the other machine's compiler,
they are not separate functions. v5's ``counters`` do have one. The chunked
dispatch around a scratch-memory limit is dropped too: one launch covers the
whole wave, and dead lanes (``tmax < tmin``) leave the kernel at once.

Each wrapper takes its plain version (``traverse6_plain``,
``traverse5_plain``, ``traverse7_plain``, ``traverse_plain``,
``traverse2_plain``, ``traverse3_plain``, ``traverse4_plain``) only for
tensors that lie on the CPU. For a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from time import perf_counter

import numpy as np
import torch

from .. import stats
from ..core.math import V3

TRI_EPS = 1e-10
BARY_EPS = 1e-6
STACK_DEPTH = 96          # stack entries per ray (v6) or per packet (the rest)
PACKET = 32               # rays that share a stack in v5 / v7: one warp
IDX_MASK = 127            # the packed fold keeps a triangle's slot here: K <= 128

# the four kernels over the binary tree: library -> lanes that share a stack
# (128: a thread block, 32: a warp), leaf-buffer entries (0: a leaf is tested
# at the pop), which node table, which fold
ATTIC = {
    "traverse1": dict(packet=128, lbuf=0, compact=False, packed=False),
    "traverse2": dict(packet=32, lbuf=8, compact=False, packed=False),
    "traverse3": dict(packet=128, lbuf=16, compact=True, packed=True),
    "traverse4": dict(packet=32, lbuf=8, compact=True, packed=True),
}

MODE_CLOSEST, MODE_ANY, MODE_MIXED = 0, 1, 2
MODE_NAMES = ("closest", "any", "mixed")

# launches by kernel and mode: incremented where a kernel is launched and
# nowhere else
LAUNCHES = {f"{kern}:{mode}": 0
            for kern, modes in (("traverse6", MODE_NAMES),
                                ("traverse6_motion", MODE_NAMES),
                                ("traverse5", MODE_NAMES[:2]),
                                ("traverse7", MODE_NAMES[:2]),
                                *((k, MODE_NAMES[:2]) for k in ATTIC))
            for mode in modes}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass
class PackedBVH:
    """Kernel-ready scene: node tables + cluster-permuted triangle soup.

    The binary cluster tree, read by ``traverse`` .. ``traverse4``:
    bounds: (N, 8) f32 rows [lox loy loz hix hiy hiz 0 0]
    meta:   (N, 4) i32 rows [child0, child1, axis, 0]; a leaf has
            child0 = -(cluster + 1)
    meta2:  (N, 2) i32 rows [child0 * 4 + axis (interior) or -(cluster + 1)
            (leaf), child1]: the compact form v3 and v4 read

    Its 8-ary collapse, read by ``traverse5`` .. ``traverse7``:
    wbounds: (W, 48) f32 rows [lox*8 loy*8 loz*8 hix*8 hiy*8 hiz*8], NaN pads
    worder:  (8 W, 8) i32 rows of far-first child entries per octant,
             entry = ref*8 + slot, ref < 0 -> leaf cluster -ref-1.
    soup16: (C*K, 16) f32 rows [v0 e1 e2 orig_id_bits 0...]: the table the
            kernel's leaf test and the finish step read. Triangle j of
            cluster c has permuted prim id c*K + j; pad slots (id < 0) have
            zero edges (never hit) and TRAIL the real triangles of their
            cluster: the kernel's leaf loop stops at the first one.

    soup16d: (C*K, 16) f32 shutter-close MINUS shutter-open deltas in
            soup16's row layout (col 9 zero, pad rows zero), or None for a
            static scene. Leaf tests and the finish step lerp
            ``v + time * dv``; the two tables are never added as whole rows.
    wbounds_t: (W, 96) f32, with soup16d: each wide node's 8 child boxes at
            shutter open in wbounds' row layout, then their (close - open)
            deltas in the same layout, NaN pads in both. The motion walk
            slab-tests ``open + time * delta``, a box around where the
            child's triangles are at the ray's time, instead of the union
            box over the shutter (``motion_bounds``; ``with_deltas``).
    woop: (C*K, 12) f32 rows [W_0 w_0 | W_1 w_1 | W_2 w_2] of the
          unit-triangle transforms ``traverse7`` reads, or None: ``pack``
          does not build it, ``with_woop`` adds it.
    """
    bounds: object
    meta: object
    meta2: object
    wbounds: object
    worder: object
    soup16: object
    soup16d: object = None
    wbounds_t: object = None
    woop: object = None
    n_nodes: int = 0
    n_clusters: int = 0
    k: int = 0
    n_wnodes: int = 0

    def to(self, device):
        from ..scene.types import to_device
        return to_device(self, device)


def check_pads_trail(tid):
    """Raise unless every cluster's pad slots (id < 0) come after all of its
    real triangles: the kernel ends a leaf at the first pad row."""
    pad = np.asarray(tid).reshape(-1, np.asarray(tid).shape[-1]) < 0
    if np.any(pad[:, :-1] & ~pad[:, 1:]):
        raise ValueError("cluster soup has a pad slot before a real "
                         "triangle: pad slots must trail in every cluster")


def pack(node_lo, node_hi, node_child, node_axis, tv0, te1, te2, tid,
         deltas=None):
    """Build PackedBVH from ClusterBVH-style arrays ((C,K,3) tris, (C,K) ids).

    Returns (packed, perm) where perm (C*K,) maps permuted prim id -> original
    triangle id (-1 for pad slots). Pad slots get zeroed edges. Host numpy.

    deltas: optional (dv0, de1, de2) (C,K,3) shutter-close-minus-open soups
    (moving geometry; the node bounds must already be those of the
    shutter-union tree, ``accel.cluster.build_motion``). Pad slots get zero
    deltas too, or a lerped pad triangle would stop being degenerate."""
    from ..accel.wide import build_wide
    tid = np.asarray(tid, np.int32)
    check_pads_trail(tid)
    pad = tid < 0
    c, k = tid.shape
    perm_flat = tid.reshape(-1)

    def rows16(soups, ids):
        planes = (np.moveaxis(np.where(pad[..., None], 0.0,
                                       np.asarray(a, np.float32)), -1, 0)
                  for a in soups)
        return soup_pack16(*planes, ids)

    n = node_lo.shape[0]
    bounds = np.zeros((n, 8), np.float32)
    bounds[:, 0:3] = np.asarray(node_lo, np.float32)
    bounds[:, 3:6] = np.asarray(node_hi, np.float32)
    meta = np.zeros((n, 4), np.int32)
    meta[:, 0:2] = np.asarray(node_child, np.int32)
    meta[:, 2] = np.asarray(node_axis, np.int32)
    meta2 = np.zeros((n, 2), np.int32)
    meta2[:, 0] = np.where(meta[:, 0] < 0, meta[:, 0],
                           meta[:, 0] * 4 + meta[:, 2])
    meta2[:, 1] = meta[:, 1]
    wbounds, worder, n_w = build_wide(node_lo, node_hi, node_child)
    packed = PackedBVH(
        bounds=bounds, meta=meta, meta2=meta2,
        wbounds=wbounds, worder=worder,
        soup16=rows16((tv0, te1, te2), perm_flat),
        n_nodes=n, n_clusters=c, k=k, n_wnodes=n_w)
    if deltas is not None:
        packed = with_deltas(packed,
                             rows16(deltas, np.zeros_like(perm_flat)))
    return packed, perm_flat


# a float32 rounding's relative error 2^-24, with room: what each of a
# lerp's two roundings (a multiply, then an add) is held to below
_ULP_HALF = 2.0 ** -24 * (1.0 + 2.0 ** -10)


def _to_f32(x, down):
    """float64 -> float32 rounded toward -inf (`down`) or +inf."""
    y = x.astype(np.float32)
    off = (y > x) if down else (y < x)
    y[off] = np.nextafter(y[off], np.float32(-np.inf if down else np.inf))
    return y


def motion_bounds(wbounds, worder, soup16, soup16d, k):
    """The (W, 96) ``wbounds_t`` of a moving scene (host numpy), from its
    packed tables; the tree is theirs, unchanged.

    A child box on an axis along which no triangle of its subtree moves has
    a zero delta, so ``open + time * 0`` is its open box exactly: the
    ``wbounds`` box, grown where a float32 vertex of the subtree lies
    outside it (the shutter-union tree's boxes come from proxy triangles,
    whose corners round), so a tree whose deltas are all zero takes the
    static walk. On an axis along which one moves, the box is lerped: at
    shutter open and at close the least and greatest vertex of the
    subtree's triangles (a leaf child: its cluster's; an interior one: the
    union of its children's at the same instant), v0, v0 + e1 and v0 + e2,
    the close ones with the deltas added. For linear motion the lerp of
    those two boxes holds every lerped vertex at every time in real
    arithmetic; each bound is moved outward by what the leaf test's lerp
    (``v + time * dv``, a rounded multiply and a rounded add on v0, e1, e2)
    and the walk's lerp of the box itself can round, and by the
    barycentric tolerance ``BARY_EPS`` of the edges, then stored rounded
    outward."""
    w = wbounds.shape[0]
    wb = np.asarray(wbounds, np.float32).reshape(w, 6, 8)
    ent = np.asarray(worder, np.int64)[:w]          # octant 0's rows
    refs = np.zeros((w, 8), np.int64)               # by slot
    np.put_along_axis(refs, ent & 7, ent >> 3, axis=1)
    pad = np.isnan(wb[:, 0])                        # (W, 8)

    rows = np.asarray(soup16, np.float32).reshape(-1, k, 16)
    valid = np.ascontiguousarray(rows[..., 9]).view(np.int32) >= 0
    a = rows[..., :9].astype(np.float64)
    d = np.asarray(soup16d, np.float32).reshape(-1, k, 16)[..., :9].astype(
        np.float64)
    v0, e1, e2 = a[..., 0:3], a[..., 3:6], a[..., 6:9]
    dv0, de1, de2 = d[..., 0:3], d[..., 3:6], d[..., 6:9]

    def err(x, dx):          # a lerp's two roundings; none where dx == 0
        return np.where(dx != 0, _ULP_HALF * (np.abs(x) + 2 * np.abs(dx)),
                        0.0)

    ev0 = err(v0, dv0)
    tol = 2 * BARY_EPS * np.maximum(np.abs(e1) + np.abs(e2),
                                    np.abs(e1 + de1) + np.abs(e2 + de2))
    # (C, K, vertex, axis)
    room = np.stack([ev0, ev0 + err(e1, de1), ev0 + err(e2, de2)], 2) + (
        tol[:, :, None])
    at_open = np.stack([v0, v0 + e1, v0 + e2], 2)
    at_close = np.stack([v0 + dv0, v0 + dv0 + e1 + de1,
                         v0 + dv0 + e2 + de2], 2)
    r32 = rows[..., :9]
    still = np.stack([r32[..., 0:3], r32[..., 0:3] + r32[..., 3:6],
                      r32[..., 0:3] + r32[..., 6:9]], 2).astype(np.float64)
    real = valid[..., None, None]
    # (C, 6, 3): lo at open, lo at close, hi at open, hi at close, then
    # the float32 vertices' lo and hi (the axes that do not move)
    leaf = np.stack(
        [np.where(real, p - room, np.inf).min((1, 2))
         for p in (at_open, at_close)]
        + [np.where(real, p + room, -np.inf).max((1, 2))
           for p in (at_open, at_close)]
        + [np.where(real, still, np.inf).min((1, 2)),
           np.where(real, still, -np.inf).max((1, 2))], 1)
    leaf_moves = ((d.reshape(d.shape[:2] + (3, 3)) != 0).any(2)
                  & valid[..., None]).any(1)         # (C, axis)

    # interior children bottom-up: a fixed point, one level a pass
    is_leaf = refs < 0
    cl = np.where(is_leaf, -refs - 1, 0)
    sub = np.where(is_leaf | pad, 0, refs)
    sign = np.asarray([1.0, 1.0, -1.0, -1.0, 1.0, -1.0])[:, None]  # max
    node = np.broadcast_to(sign * np.inf, (w, 6, 3)).copy()   # as -min(-x)
    node_moves = np.zeros((w, 3), bool)
    while True:
        child = np.where(is_leaf[..., None, None], leaf[cl], node[sub])
        child_moves = np.where(is_leaf[..., None], leaf_moves[cl],
                               node_moves[sub])
        signed = np.where(pad[..., None, None], np.inf, child * sign)
        new = signed.min(1) * sign
        new_moves = (child_moves & ~pad[..., None]).any(1)
        if np.array_equal(new, node) and np.array_equal(new_moves,
                                                        node_moves):
            break
        node, node_moves = new, new_moves

    out = np.empty((w, 2, 6, 8), np.float32)
    for c in range(6):
        axis, down = c % 3, c < 3
        b0, b1 = (child[:, :, 0 if down else 2, axis],
                  child[:, :, 1 if down else 3, axis])
        # the walk's own lerp of the box rounds by at most this much
        m = 2 * _ULP_HALF * (np.abs(b0) + 2 * np.abs(b1 - b0))
        s = -1.0 if down else 1.0
        lo0 = _to_f32(b0 + s * m, down)
        dlo = _to_f32(b1 + s * m - lo0.astype(np.float64), down)
        grow = np.minimum if down else np.maximum
        fixed = grow(wb[:, c], child[:, :, 4 if down else 5, axis])
        moves = child_moves[:, :, axis]
        out[:, 0, c] = np.where(moves, lo0, fixed)
        out[:, 1, c] = np.where(moves, dlo, 0.0)
    out[np.broadcast_to(pad[:, None, None, :], out.shape)] = np.nan
    return out.reshape(w, 96)


def with_deltas(packed: PackedBVH, soup16d) -> PackedBVH:
    """`packed` with the delta table `soup16d` (soup16's row layout: col 9
    zero, pad rows zero) and the ``wbounds_t`` made from it. Numpy or
    tensors; tensors come back on their device."""
    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else x

    wbt = motion_bounds(host(packed.wbounds), host(packed.worder),
                        host(packed.soup16), host(soup16d), packed.k)
    if torch.is_tensor(soup16d):
        wbt = torch.from_numpy(wbt).to(soup16d.device)
    return dataclasses.replace(packed, soup16d=soup16d, wbounds_t=wbt)


def soup_pack16(tv0, te1, te2, perm):
    """(3, C, K) soup + perm -> (C*K, 16) row table: cols
    [v0.xyz e1.xyz e2.xyz orig_id_bits pad...] (host numpy). One 64-byte
    row holds everything a triangle test needs; col 9 is an int32 BIT
    PATTERN inside the f32 table and is only ever moved, never computed on."""
    ck = tv0.shape[1] * tv0.shape[2]
    A = np.zeros((ck, 16), np.float32)
    for c in range(3):
        A[:, 0 + c] = np.asarray(tv0[c]).reshape(-1)
        A[:, 3 + c] = np.asarray(te1[c]).reshape(-1)
        A[:, 6 + c] = np.asarray(te2[c]).reshape(-1)
    A[:, 9] = np.asarray(perm, np.int32).view(np.float32)
    return A


def woop_pack(soup16, k):
    """(C*K, 16) soup rows -> (C*K, 12) Woop table (host numpy): for every
    triangle the affine map to the unit triangle {(0,0,0), (1,0,0), (0,1,0)},
    ``W = [e1 e2 e1xe2]^-1`` and ``w = -W v0``, inverted in float64 and stored
    as three rows ``[W_c0 W_c1 W_c2 w_c]``, so that ``o'_c = W_c . o + w_c``
    and ``d'_c = W_c . d``. Degenerate (and pad) triangles get all-zero rows:
    ``d'_z = 0``, never hit."""
    s = np.asarray(soup16, np.float32).reshape(-1, k, 16)
    v0 = s[..., 0:3].astype(np.float64)                     # (C, K, 3)
    e1 = s[..., 3:6].astype(np.float64)
    e2 = s[..., 6:9].astype(np.float64)
    m = np.stack([e1, e2, np.cross(e1, e2)], axis=-1)       # columns
    ok = np.abs(np.linalg.det(m)) > 1e-30
    minv = np.zeros_like(m)
    if ok.any():
        minv[ok] = np.linalg.inv(m[ok])
    w = -np.einsum("ckij,ckj->cki", minv, v0)
    table = np.zeros(s.shape[:2] + (3, 4), np.float32)
    table[..., 0:3] = minv
    table[..., 3] = w
    return table.reshape(-1, 12)


def with_woop(packed: PackedBVH) -> PackedBVH:
    """Attach the table ``traverse7`` reads (host numpy) to a PackedBVH."""
    return dataclasses.replace(packed,
                               woop=woop_pack(packed.soup16, packed.k))


def _components(o, d):
    """V3 or (R, 3) -> component tuples."""
    if isinstance(o, V3):
        return (o.x, o.y, o.z), (d.x, d.y, d.z)
    return ((o[:, 0], o[:, 1], o[:, 2]), (d[:, 0], d[:, 1], d[:, 2]))


# ---------------------------------------------------------------------------
# The CUDA kernels: build, load, launch
# ---------------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# one library per source; every source includes the headers beside it.
# Another module adds a library of its own with ``register_library``
KERNEL_SOURCES = {name: os.path.join(CSRC_DIR, name + ".cu")
                  for name in ("traverse6", "traverse5", "traverse7", *ATTIC)}
_BINDERS = {}             # name -> bind(lib) of a registered library
# -fmad=false: products and sums round as the plain versions' separate ops
# do, so kernel and plain version take the same walk; -Xptxas -v: the
# assembler reports each kernel's registers and spills into BUILD_LOG
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
BUILD_LOG = {}            # name -> nvcc's output of the library's build
BUILD_SECONDS = {}        # name -> seconds that build took
_libs = {}
_lib_lock = threading.Lock()
_overflow = {}            # device -> int32[1] flag the kernels OR into


def _find_nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the traversal kernels are built from "
                       f"{CSRC_DIR} at first use and need the CUDA toolkit")


def build_command(name, so_path):
    return [_find_nvcc(), *NVCC_FLAGS, "-o", so_path, KERNEL_SOURCES[name]]


def _csrc_hash():
    """A hash of every file under csrc/: the libraries' paths carry it, and a
    header is shared, so an edit to any file rebuilds them all."""
    h = hashlib.sha1()
    for fn in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, fn), "rb") as f:
            h.update(fn.encode() + b"\0" + f.read())
    return h.hexdigest()[:12]


def register_library(name, bind):
    """Build and load ``csrc/<name>.cu`` as the traversal libraries are (same
    flags, build directory and hash); ``bind(lib)`` declares its launchers'
    C signatures once it is loaded."""
    KERNEL_SOURCES[name] = os.path.join(CSRC_DIR, name + ".cu")
    _BINDERS[name] = bind


def _bind(name, lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    if name in _BINDERS:
        return _BINDERS[name](lib)
    if name == "traverse6":
        lib.traverse6_launch.restype = i
        lib.traverse6_launch.argtypes = [p] * 15 + [i] * 4 + [p]
        lib.traverse6_motion_launch.restype = i
        lib.traverse6_motion_launch.argtypes = [p] * 18 + [i] * 4 + [p]
    else:
        launch = getattr(lib, name + "_launch")
        launch.restype = i
        launch.argtypes = [p] * 15 + [i] * (3 if name in ATTIC else 4) + [p]
        want = {"packet_width": ATTIC[name]["packet"],
                "leaf_buffer": ATTIC[name]["lbuf"]} if name in ATTIC else {
                    "packet_width": PACKET}
        for what, value in want.items():
            fn = getattr(lib, f"{name}_{what}")
            fn.restype, fn.argtypes = i, []
            if fn() != value:
                raise RuntimeError(f"{name}.cu {what} differs from the "
                                   "wrapper's")
    depth = getattr(lib, name + "_stack_depth")
    depth.restype, depth.argtypes = i, []
    if depth() != STACK_DEPTH:
        raise RuntimeError(f"{name}.cu STACK_DEPTH differs from the wrapper's")


def load_kernels(names=None):
    """Build (where needed, all ``nvcc`` runs started together) and load the
    libraries of `names` (default: every one in ``KERNEL_SOURCES``); raises
    if one fails to build."""
    names = tuple(KERNEL_SOURCES) if names is None else names
    with _lib_lock, stats.span("kernel_load"):
        tag = _csrc_hash()
        path = {name: os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")
                for name in names}
        procs = {}
        for name in names:
            so = path[name]
            if name not in _libs and not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                procs[name] = (perf_counter(), tmp, subprocess.Popen(
                    build_command(name, tmp), stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (t0, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            BUILD_SECONDS[name] = perf_counter() - t0
            BUILD_LOG[name] = out.strip()
            if proc.returncode != 0:
                failed.append(f"nvcc failed building {name}.cu:\n{out}")
            else:
                with open(path[name] + ".log", "w") as f:
                    f.write(BUILD_LOG[name])
                os.replace(tmp, path[name])
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in names:
            if name not in BUILD_LOG and os.path.exists(path[name] + ".log"):
                with open(path[name] + ".log") as f:    # an earlier build's
                    BUILD_LOG[name] = f.read()
            if name not in _libs:
                lib = ctypes.CDLL(path[name])
                _bind(name, lib)
                _libs[name] = lib
        return [_libs[name] for name in names]


def load_kernel(name="traverse6"):
    """Build (if needed) and load one kernel library; raises on failure."""
    lib = _libs.get(name)       # every launch comes through here
    return lib if lib is not None else load_kernels((name,))[0]


def overflow_flag(device):
    """int32[1] on `device`: nonzero once any launch since the last
    ``reset_overflow`` ran out of stack. Reading it synchronises."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _overflow:
        _overflow[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _overflow[device]


def reset_overflow(device):
    overflow_flag(device).zero_()


def _check_plane(x, name, n, device, dtype=torch.float32):
    if (x.device != device or x.dtype != dtype or x.dim() != 1
            or x.shape[0] != n):
        raise ValueError(f"traversal: {name} must be a ({n},) {dtype} tensor "
                         f"on {device}, got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    return x.contiguous()


def _check_table(x, name, shape, device, dtype=torch.float32):
    if (not torch.is_tensor(x) or x.device != device or x.dtype != dtype
            or tuple(x.shape) != shape or not x.is_contiguous()):
        raise ValueError(f"traversal: bvh.{name} must be a contiguous "
                         f"{shape} {dtype} tensor on {device}")
    return x


_PLANE_NAMES = ("ox", "oy", "oz", "dx", "dy", "dz", "tmin", "tmax")


def _ray_args(oc, dc, tmin, tmax):
    """Checked ray planes and fresh outputs of one launch."""
    dev = oc[0].device
    n = oc[0].shape[0]
    planes = [_check_plane(x, nm, n, dev)
              for x, nm in zip((*oc, *dc, tmin, tmax), _PLANE_NAMES)]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    return dev, n, planes, t, prim


def _launch_args(bvh, oc, dc, tmin, tmax):
    """``_ray_args`` and the checked wide-node tables."""
    dev, n, planes, t, prim = _ray_args(oc, dc, tmin, tmax)
    w = bvh.n_wnodes
    wb = _check_table(bvh.wbounds, "wbounds", (w, 48), dev)
    wo = _check_table(bvh.worder, "worder", (8 * w, 8), dev, torch.int32)
    return dev, n, planes, wb, wo, t, prim


def _motion_boxes(bvh):
    if bvh.wbounds_t is None:
        raise ValueError("traversal: a PackedBVH with soup16d needs its "
                         "wbounds_t; make it with pack(deltas=) or "
                         "with_deltas")
    return bvh.wbounds_t


def _traverse6_cuda(bvh, oc, dc, tmin, tmax, mode, anyf, time, counts):
    dev, n, planes, wb, wo, t, prim = _launch_args(bvh, oc, dc, tmin, tmax)
    rows = (bvh.n_clusters * bvh.k, 16)
    soup = _check_table(bvh.soup16, "soup16", rows, dev)
    if mode == MODE_MIXED:
        anyf = _check_plane(anyf, "anyf", n, dev)
    work = None
    if time is not None:
        soupd = _check_table(bvh.soup16d, "soup16d", rows, dev)
        wb = _check_table(_motion_boxes(bvh), "wbounds_t",
                          (bvh.n_wnodes, 96), dev)
        time = _check_plane(time, "time", n, dev)
        if counts is not None:
            work = torch.zeros(2, dtype=torch.int64, device=dev)
            counts.update(node_pops=work[0], tri_tests=work[1])
    if n == 0:                # nothing to launch, nothing to count
        return t, prim
    lib = load_kernel("traverse6")
    ptr = lambda x: x.data_ptr()
    with torch.cuda.device(dev):
        tail = (ptr(t), ptr(prim), ptr(overflow_flag(dev)), n, bvh.n_wnodes,
                bvh.k, mode, torch.cuda.current_stream().cuda_stream)
        af = ptr(anyf) if mode == MODE_MIXED else None
        if time is None:
            rc = lib.traverse6_launch(ptr(wb), ptr(wo), ptr(soup),
                                      *map(ptr, planes), af, *tail)
        else:
            rc = lib.traverse6_motion_launch(
                ptr(wb), ptr(wo), ptr(soup), ptr(soupd), *map(ptr, planes),
                af, ptr(time), *tail[:3],
                None if work is None else ptr(work), *tail[3:])
    if rc != 0:
        raise RuntimeError(f"traverse6 kernel launch failed: CUDA error {rc}")
    kern = "traverse6" if time is None else "traverse6_motion"
    LAUNCHES[f"{kern}:{MODE_NAMES[mode]}"] += 1
    return t, prim


def traverse6(bvh: PackedBVH, o, d, tmin, tmax, *, any_hit: bool = False,
              anyf=None, time=None, counts=None):
    """Walk the wide BVH for every ray: returns ``(t, prim)`` with t f32
    (+inf on a miss; approximate for any-hit lanes) and the permuted prim id
    ``cluster*K + j`` (i32, -1 on a miss).

    anyf: optional (R,) f32 per-lane any-hit flags (mixed waves: lanes with
    anyf > 0 stop at their first hit, the others find the closest).
    time: optional (R,) f32 shutter times in [0, 1]; with a scene packed with
    deltas (``bvh.soup16d``) every child box (``bvh.wbounds_t``) and leaf
    triangle is lerped to its ray's time (the kernel's motion mode);
    ignored for a static scene.
    counts: optional dict that receives the walk's ``node_pops`` and
    ``tri_tests`` (``traverse6_plain``'s ``stats``): on the card those of a
    motion launch, as int64 device tensors its warps add to; on the CPU the
    plain walk's.
    Closest lanes return the nearest t in (tmin, tmax]. CUDA tensors go to
    the kernel, CPU tensors to ``traverse6_plain``."""
    oc, dc = _components(o, d)
    mode = MODE_MIXED if anyf is not None else (
        MODE_ANY if any_hit else MODE_CLOSEST)
    if bvh.soup16d is None:
        time = None
    with torch.no_grad():
        if oc[0].device.type == "cuda":
            return _traverse6_cuda(bvh, oc, dc, tmin, tmax, mode, anyf, time,
                                   counts)
        return traverse6_plain(bvh, o, d, tmin, tmax, any_hit=any_hit,
                               anyf=anyf, time=time, stats=counts)


def _packet_cuda(name, table, bvh, oc, dc, tmin, tmax, any_hit, counters):
    """Launch the packet kernel `name` ("traverse5" / "traverse7") with its
    leaf table (already checked)."""
    dev, n, planes, wb, wo, t, prim = _launch_args(bvh, oc, dc, tmin, tmax)
    cnt = (torch.zeros((-(-n // PACKET), 2), dtype=torch.int32, device=dev)
           if counters else None)
    if n > 0:
        lib = load_kernel(name)
        ptr = lambda x: x.data_ptr()
        with torch.cuda.device(dev):
            rc = getattr(lib, name + "_launch")(
                ptr(wb), ptr(wo), ptr(table), *map(ptr, planes), ptr(t),
                ptr(prim), None if cnt is None else ptr(cnt),
                ptr(overflow_flag(dev)), n, bvh.n_wnodes, bvh.k,
                int(bool(any_hit)), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
        LAUNCHES[f"{name}:{MODE_NAMES[int(bool(any_hit))]}"] += 1
    return (t, prim, cnt) if counters else (t, prim)


def _traverse5_cuda(bvh, oc, dc, tmin, tmax, any_hit, counters):
    soup = _check_table(bvh.soup16, "soup16", (bvh.n_clusters * bvh.k, 16),
                        oc[0].device)
    return _packet_cuda("traverse5", soup, bvh, oc, dc, tmin, tmax, any_hit,
                        counters)


def traverse5(bvh: PackedBVH, o, d, tmin, tmax, *, any_hit: bool = False,
              counters: bool = False):
    """Packet walk of the wide BVH: ``PACKET`` consecutive rays share one
    stack and one (majority) octant order; returns ``(t, prim)`` as
    ``traverse6`` does, for closest-hit or any-hit waves.

    counters=True adds a ``(ceil(R / PACKET), 2)`` int32 tensor: node steps
    and leaf clusters of each packet. CUDA tensors go to the kernel, CPU
    tensors to ``traverse5_plain``."""
    oc, dc = _components(o, d)
    with torch.no_grad():
        if oc[0].device.type == "cuda":
            return _traverse5_cuda(bvh, oc, dc, tmin, tmax, any_hit, counters)
        return traverse5_plain(bvh, o, d, tmin, tmax, any_hit=any_hit,
                               counters=counters)


def _require_woop(bvh):
    if bvh.woop is None:
        raise ValueError("pack() does not build the table traverse7 reads; "
                         "call with_woop(packed) first")


def _traverse7_cuda(bvh, oc, dc, tmin, tmax, any_hit, counters):
    woop = _check_table(bvh.woop, "woop", (bvh.n_clusters * bvh.k, 12),
                        oc[0].device)
    return _packet_cuda("traverse7", woop, bvh, oc, dc, tmin, tmax, any_hit,
                        counters)


def traverse7(bvh: PackedBVH, o, d, tmin, tmax, *, any_hit: bool = False,
              counters: bool = False):
    """``traverse5``'s packet walk with the Woop unit-triangle leaf test over
    ``bvh.woop`` (``with_woop``; raises ValueError without it). Its rounding
    differs from Moeller-Trumbore's, so it may miss sliver triangles the
    other kernels hit; the finish step recomputes the winners from the soup.
    CUDA tensors go to the kernel, CPU tensors to ``traverse7_plain``."""
    _require_woop(bvh)
    oc, dc = _components(o, d)
    with torch.no_grad():
        if oc[0].device.type == "cuda":
            return _traverse7_cuda(bvh, oc, dc, tmin, tmax, any_hit, counters)
        return traverse7_plain(bvh, o, d, tmin, tmax, any_hit=any_hit,
                               counters=counters)


def _binary_cuda(name, bvh, oc, dc, tmin, tmax, any_hit, counters):
    """Launch the binary-tree kernel `name` ("traverse1" .. "traverse4")."""
    cfg = ATTIC[name]
    dev, n, planes, t, prim = _ray_args(oc, dc, tmin, tmax)
    if cfg["packed"] and bvh.k > IDX_MASK + 1:
        raise ValueError(f"{name}: clusters of {bvh.k} triangles, the packed "
                         f"fold holds a slot in {IDX_MASK + 1}")
    bounds = _check_table(bvh.bounds, "bounds", (bvh.n_nodes, 8), dev)
    meta = (_check_table(bvh.meta2, "meta2", (bvh.n_nodes, 2), dev,
                         torch.int32) if cfg["compact"] else
            _check_table(bvh.meta, "meta", (bvh.n_nodes, 4), dev,
                         torch.int32))
    soup = _check_table(bvh.soup16, "soup16", (bvh.n_clusters * bvh.k, 16),
                        dev)
    cnt = (torch.zeros((-(-n // cfg["packet"]), 2), dtype=torch.int32,
                       device=dev) if counters else None)
    if n > 0:
        lib = load_kernel(name)
        ptr = lambda x: x.data_ptr()
        with torch.cuda.device(dev):
            rc = getattr(lib, name + "_launch")(
                ptr(bounds), ptr(meta), ptr(soup), *map(ptr, planes), ptr(t),
                ptr(prim), None if cnt is None else ptr(cnt),
                ptr(overflow_flag(dev)), n, bvh.k, int(bool(any_hit)),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
        LAUNCHES[f"{name}:{MODE_NAMES[int(bool(any_hit))]}"] += 1
    return (t, prim, cnt) if counters else (t, prim)


def _binary_wrapper(name, bvh, o, d, tmin, tmax, any_hit, counters=False):
    oc, dc = _components(o, d)
    with torch.no_grad():
        if oc[0].device.type == "cuda":
            return _binary_cuda(name, bvh, oc, dc, tmin, tmax, any_hit,
                                counters)
        return _binary_plain(bvh, o, d, tmin, tmax, any_hit, **ATTIC[name],
                             counters=counters)


def traverse(bvh: PackedBVH, o, d, tmin, tmax, *, any_hit: bool = False):
    """v1: block walk of the BINARY tree. 128 consecutive rays share one
    stack; the popped node's box is tested at the pop, both children are
    pushed (far first by the packet's majority direction sign on the split
    axis) when any live lane hits it, and a popped leaf is tested at once by
    the lanes that hit its box. Returns ``(t, prim)`` as ``traverse6`` does;
    an any-hit lane's t is the nearest blocker of the leaf that stopped it.
    CUDA tensors go to the kernel, CPU tensors to ``traverse_plain``."""
    return _binary_wrapper("traverse1", bvh, o, d, tmin, tmax, any_hit)


def traverse2(bvh: PackedBVH, o, d, tmin, tmax, *, any_hit: bool = False):
    """v2: every packet of 32 rays walks the binary tree alone, with its own
    stack and its own buffer of 8 hit leaf clusters, flushed when it is full
    or the stack is empty. CUDA tensors go to the kernel, CPU tensors to
    ``traverse2_plain``."""
    return _binary_wrapper("traverse2", bvh, o, d, tmin, tmax, any_hit)


def traverse3(bvh: PackedBVH, o, d, tmin, tmax, *, any_hit: bool = False,
              counters: bool = False):
    """v3: v1's packet over the compact ``meta2`` table; the node loop only
    buffers hit leaf clusters (16), a flush tests them in buffer order with
    the index-packed fold. counters=True adds a ``(ceil(R / 128), 2)`` int32
    tensor: node steps (every pop, missed boxes included) and leaf rounds of
    each packet. CUDA tensors go to the kernel, CPU tensors to
    ``traverse3_plain``."""
    return _binary_wrapper("traverse3", bvh, o, d, tmin, tmax, any_hit,
                           counters)


def traverse4(bvh: PackedBVH, o, d, tmin, tmax, *, any_hit: bool = False):
    """v4: v2's packet with ``meta2`` and the index-packed fold. CUDA tensors
    go to the kernel, CPU tensors to ``traverse4_plain``."""
    return _binary_wrapper("traverse4", bvh, o, d, tmin, tmax, any_hit)


# ---------------------------------------------------------------------------
# Plain PyTorch version: the same walk over the same tables, all rays at once
# ---------------------------------------------------------------------------

def _safe_inv(d):
    tiny = torch.where(d < 0, -1e-30, 1e-30).to(d.dtype)
    return 1.0 / torch.where(torch.abs(d) < 1e-30, tiny, d)


def _mt(oc, dc, tmin, v0, e1, e2):
    """Moeller-Trumbore in the kernel's operation order; broadcasting.
    Returns (ok, t)."""
    px = dc[1] * e2[2] - dc[2] * e2[1]
    py = dc[2] * e2[0] - dc[0] * e2[2]
    pz = dc[0] * e2[1] - dc[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    flat = torch.abs(det) < TRI_EPS
    inv_det = 1.0 / torch.where(flat, 1.0, det)
    tx = oc[0] - v0[0]
    ty = oc[1] - v0[1]
    tz = oc[2] - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (dc[0] * qx + dc[1] * qy + dc[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    ok = (~flat & (u >= -BARY_EPS) & (v >= -BARY_EPS)
          & (u + v <= 1.0 + BARY_EPS) & (t > tmin))
    return ok, t


def _first_least(acc, t, dim):
    """Index along `dim` of the first ACCEPTED slot of the least accepted t,
    the slot the kernels' sequential `nearer` fold keeps; +inf counts (a
    lane without a winner accepts t == tmax == +inf), so an argmin over t
    with +inf for the rejected slots would not do."""
    tm = torch.where(acc, t, float("inf"))
    least = tm.amin(dim, keepdim=True)
    return torch.argmax((acc & (tm == least)).to(torch.uint8), dim)


@torch.no_grad()
def traverse6_plain(bvh: PackedBVH, o, d, tmin, tmax, *,
                    any_hit: bool = False, anyf=None, time=None, stats=None):
    """``traverse6`` in plain PyTorch: every ray keeps its own stack row of a
    ``(R, STACK_DEPTH)`` tensor and all live rays take one pop per round
    (interior refs slab-test 8 children and push the hit ones far first,
    leaf refs test their cluster). Same tables, same order of operations and
    same per-ray walk as the CUDA kernel. With `time` (and ``bvh.soup16d``)
    a node's child boxes (``bvh.wbounds_t``) and a leaf's triangles are
    lerped to each ray's shutter time first, a multiply and then an add per
    component, as the kernel's motion mode does.

    stats: optional dict that receives the work of this walk, ``node_pops``
    (interior nodes slab-tested, summed over rays) and ``tri_tests``
    (triangles tested: an any-hit lane stops counting at its first accepted
    hit, as the kernel stops testing there), for a bound on the kernel's
    time."""
    if stats is not None:
        stats.update(node_pops=0, tri_tests=0, rounds=0)
    oc, dc = _components(o, d)
    dev = oc[0].device
    n = oc[0].shape[0]
    w, k = bvh.n_wnodes, bvh.k
    wb = bvh.wbounds.view(w, 6, 8)
    wo = bvh.worder
    soup = bvh.soup16.view(bvh.n_clusters, k, 16)
    if bvh.soup16d is None:
        time = None
    soupd = None if time is None else bvh.soup16d.view(bvh.n_clusters, k, 16)
    wbt = None if time is None else _motion_boxes(bvh).view(w, 2, 6, 8)
    inv = [_safe_inv(c) for c in dc]
    octant = ((dc[0] < 0).long() + 2 * (dc[1] < 0).long()
              + 4 * (dc[2] < 0).long())
    if anyf is not None:
        any_lane = anyf > 0
    else:
        any_lane = torch.full((n,), bool(any_hit), device=dev)
    inf = float("inf")
    t_best = tmax.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = (tmax >= tmin).long()          # live rays start with the root pushed
    act = torch.nonzero(sp > 0).squeeze(1)
    while act.numel() > 0:
        top = sp[act] - 1
        ref = stack[act, top]
        sp[act] = top
        is_node = ref >= 0
        ni = act[is_node]
        if ni.numel() > 0:
            if stats is not None:
                stats["node_pops"] += int(ni.numel())
            node = ref[is_node].long()
            if wbt is None:
                b = wb[node]                                 # (m, 6, 8)
            else:           # the boxes at each ray's time
                bt = wbt[node]
                b = bt[:, 0] + time[ni, None, None] * bt[:, 1]
            t0 = [(b[:, c] - oc[c][ni, None]) * inv[c][ni, None]
                  for c in range(3)]
            t1 = [(b[:, 3 + c] - oc[c][ni, None]) * inv[c][ni, None]
                  for c in range(3)]
            tn = torch.maximum(
                torch.maximum(torch.minimum(t0[0], t1[0]),
                              torch.minimum(t0[1], t1[1])),
                torch.maximum(torch.minimum(t0[2], t1[2]), tmin[ni, None]))
            tf = torch.minimum(
                torch.minimum(torch.maximum(t0[0], t1[0]),
                              torch.maximum(t0[1], t1[1])),
                torch.minimum(torch.maximum(t0[2], t1[2]),
                              t_best[ni, None]))
            hit = tn <= tf                  # (m, 8) by slot; NaN pads: False
            ent = wo[octant[ni] * w + node]                  # (m, 8) i32
            push = torch.gather(hit, 1, (ent & 7).long())    # in push order
            pos = sp[ni, None] + torch.cumsum(push, 1) - push.long()
            if bool((pos[push] >= STACK_DEPTH).any()):
                raise RuntimeError("traverse6_plain: per-ray stack overflow")
            rows = ni[:, None].expand(-1, 8)[push]
            stack[rows, pos[push]] = (ent >> 3)[push]        # arithmetic >>
            sp[ni] += push.sum(1)
        leaf = ~is_node
        li = act[leaf]
        if li.numel() > 0:
            cl = (-ref[leaf] - 1).long()
            tri = soup[cl]                                   # (m, K, 16)
            valid = tri[:, :, 9].contiguous().view(torch.int32) >= 0
            cols = [tri[:, :, c] for c in range(9)]
            if time is not None:
                trid, tl = soupd[cl], time[li, None]
                cols = [v + tl * trid[:, :, c] for c, v in enumerate(cols)]
            ok, t = _mt([c[li, None] for c in oc], [c[li, None] for c in dc],
                        tmin[li, None], cols[0:3], cols[3:6], cols[6:9])
            tb = t_best[li, None]
            acc = ok & valid & ((t < tb) | ((prim[li] < 0)[:, None]
                                            & (t == tb)))
            got = acc.any(1)
            j_min = _first_least(acc, t, 1)
            j_first = torch.argmax(acc.to(torch.uint8), 1)
            is_any = any_lane[li]
            j = torch.where(is_any, j_first, j_min)
            if stats is not None:
                stopped = (got & is_any)[:, None] & (
                    torch.arange(k, device=dev) > j_first[:, None])
                stats["tri_tests"] += int((valid & ~stopped).sum())
            t_new = torch.gather(t, 1, j[:, None])[:, 0]
            lg = li[got]
            t_best[lg] = t_new[got]
            prim[lg] = (cl * k + j).to(torch.int32)[got]
            sp[li[got & is_any]] = 0    # first blocker is enough
        act = act[sp[act] > 0]
        if stats is not None:
            stats["rounds"] += 1
    t_out = torch.where(prim >= 0, t_best, inf)
    return t_out, prim


def _leaf_mt(bvh):
    """Leaf test of ``traverse5``: Moeller-Trumbore over soup16 rows."""
    soup = bvh.soup16.view(bvh.n_clusters, bvh.k, 16)

    def test(cl, oc, dc, tmin):
        tri = soup[cl][:, None]                              # (m, 1, K, 16)
        return _mt(oc, dc, tmin, [tri[..., c] for c in range(3)],
                   [tri[..., 3 + c] for c in range(3)],
                   [tri[..., 6 + c] for c in range(3)])
    return test


def _leaf_woop(bvh):
    """Leaf test of ``traverse7``: the unit-triangle transform, each sum in
    the kernel's order, ((W0 x + W1 y) + W2 z) + w."""
    woop = bvh.woop.view(bvh.n_clusters, bvh.k, 12)

    def test(cl, oc, dc, tmin):
        w = woop[cl][:, None]                                # (m, 1, K, 12)
        op = [w[..., 4 * c] * oc[0] + w[..., 4 * c + 1] * oc[1]
              + w[..., 4 * c + 2] * oc[2] + w[..., 4 * c + 3]
              for c in range(3)]
        dp = [w[..., 4 * c] * dc[0] + w[..., 4 * c + 1] * dc[1]
              + w[..., 4 * c + 2] * dc[2] for c in range(3)]
        flat = torch.abs(dp[2]) < 1e-30
        t = -op[2] / torch.where(flat, 1e-30, dp[2])
        u = op[0] + t * dp[0]
        v = op[1] + t * dp[1]
        ok = ((u >= -BARY_EPS) & (v >= -BARY_EPS)
              & (u + v <= 1.0 + BARY_EPS) & (t > tmin) & ~flat)
        return ok, t
    return test


@torch.no_grad()
def _packet_plain(bvh, o, d, tmin, tmax, any_hit, leaf_test, counters,
                  stats):
    """The packet walk of ``csrc/packet_walk.cuh`` in plain PyTorch: rays are
    padded with dead lanes to whole packets of ``PACKET``, every packet keeps
    one stack row of a ``(P, STACK_DEPTH)`` tensor and all live packets take
    one pop per round. Same tables, operations and order as the kernels, so
    kernel and plain version agree lane for lane.

    stats: optional dict that receives ``node_pops`` (slab tests of a node,
    one per LIVE lane of the packet that popped it) and ``tri_tests`` (valid
    triangles tested per live lane; an any-hit lane up to its first accepted
    hit), for a bound on the kernel's time."""
    if stats is not None:
        stats.update(node_pops=0, tri_tests=0, rounds=0)
    oc, dc = _components(o, d)
    dev = oc[0].device
    n = oc[0].shape[0]
    w, k = bvh.n_wnodes, bvh.k
    npk = -(-n // PACKET)

    def lanes(x, fill):
        pad = x.new_full((npk * PACKET - n,), fill)
        return torch.cat([x, pad]).view(npk, PACKET)

    oc = [lanes(c, 0.0) for c in oc]
    dc = [lanes(c, 1.0) for c in dc]
    tmin, tmax = lanes(tmin, 0.0), lanes(tmax, -1.0)
    wb = bvh.wbounds.view(w, 6, 8)
    wo = bvh.worder
    ids = bvh.soup16[:, 9].contiguous().view(torch.int32).view(-1, k)
    inv = [_safe_inv(c) for c in dc]
    alive = tmax >= tmin
    neg = [((c < 0).sum(1) > PACKET // 2).long() for c in dc]
    octant = neg[0] + 2 * neg[1] + 4 * neg[2]                # (P,)
    inf = float("inf")
    t_best = tmax.clone()
    prim = torch.full((npk, PACKET), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((npk, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = alive.any(1).long()            # live packets start with the root
    steps = torch.zeros((npk, 2), dtype=torch.int32, device=dev)
    act = torch.nonzero(sp > 0).squeeze(1)
    while act.numel() > 0:
        top = sp[act] - 1
        ref = stack[act, top]
        sp[act] = top
        is_node = ref >= 0
        ni = act[is_node]
        if ni.numel() > 0:
            steps[ni, 0] += 1
            node = ref[is_node].long()
            live = alive[ni]
            if any_hit:
                live = live & (prim[ni] < 0)
            if stats is not None:
                stats["node_pops"] += int(live.sum())
            b = wb[node][:, None]                            # (m, 1, 6, 8)
            t0 = [(b[:, :, c] - oc[c][ni, :, None]) * inv[c][ni, :, None]
                  for c in range(3)]
            t1 = [(b[:, :, 3 + c] - oc[c][ni, :, None]) * inv[c][ni, :, None]
                  for c in range(3)]
            tn = torch.maximum(
                torch.maximum(torch.minimum(t0[0], t1[0]),
                              torch.minimum(t0[1], t1[1])),
                torch.maximum(torch.minimum(t0[2], t1[2]),
                              tmin[ni, :, None]))
            tf = torch.minimum(
                torch.minimum(torch.maximum(t0[0], t1[0]),
                              torch.maximum(t0[1], t1[1])),
                torch.minimum(torch.maximum(t0[2], t1[2]),
                              t_best[ni, :, None]))
            # (m, 8) by slot: any live lane hits the child; NaN pads: False
            hit = ((tn <= tf) & live[:, :, None]).any(1)
            ent = wo[octant[ni] * w + node]                  # (m, 8) i32
            push = torch.gather(hit, 1, (ent & 7).long())    # in push order
            pos = sp[ni, None] + torch.cumsum(push, 1) - push.long()
            if bool((pos[push] >= STACK_DEPTH).any()):
                raise RuntimeError("packet walk: stack overflow")
            rows = ni[:, None].expand(-1, 8)[push]
            stack[rows, pos[push]] = (ent >> 3)[push]        # arithmetic >>
            sp[ni] += push.sum(1)
        li = act[~is_node]
        if li.numel() > 0:
            steps[li, 1] += 1
            cl = (-ref[~is_node] - 1).long()
            live = alive[li]
            if any_hit:
                live = live & (prim[li] < 0)
            ok, t = leaf_test(cl, [c[li, :, None] for c in oc],
                              [c[li, :, None] for c in dc],
                              tmin[li, :, None])             # (m, PACKET, K)
            valid = (ids[cl] >= 0)[:, None]
            tb = t_best[li, :, None]
            acc = ok & valid & live[:, :, None] & (
                (t < tb) | ((prim[li] < 0)[:, :, None] & (t == tb)))
            got = acc.any(2)
            j_first = torch.argmax(acc.to(torch.uint8), 2)
            j = j_first if any_hit else _first_least(acc, t, 2)
            if stats is not None:
                tested = valid & live[:, :, None]
                if any_hit:
                    tested = tested & ~(got[:, :, None] & (
                        torch.arange(k, device=dev) > j_first[:, :, None]))
                stats["tri_tests"] += int(tested.sum())
            t_new = torch.gather(t, 2, j[:, :, None])[:, :, 0]
            t_best[li] = torch.where(got, t_new, t_best[li])
            prim[li] = torch.where(
                got, (cl[:, None] * k + j).to(torch.int32), prim[li])
            if any_hit:     # the packet ends once no live lane lacks a hit
                sp[li[~(alive[li] & (prim[li] < 0)).any(1)]] = 0
        act = act[sp[act] > 0]
        if stats is not None:
            stats["rounds"] += 1
    t_out = torch.where(prim >= 0, t_best, inf).view(-1)[:n]
    prim = prim.view(-1)[:n]
    return (t_out, prim, steps) if counters else (t_out, prim)


def traverse5_plain(bvh: PackedBVH, o, d, tmin, tmax, *,
                    any_hit: bool = False, counters: bool = False,
                    stats=None):
    """``traverse5`` in plain PyTorch (see ``_packet_plain``)."""
    return _packet_plain(bvh, o, d, tmin, tmax, any_hit, _leaf_mt(bvh),
                         counters, stats)


def traverse7_plain(bvh: PackedBVH, o, d, tmin, tmax, *,
                    any_hit: bool = False, counters: bool = False,
                    stats=None):
    """``traverse7`` in plain PyTorch (see ``_packet_plain``)."""
    _require_woop(bvh)
    return _packet_plain(bvh, o, d, tmin, tmax, any_hit, _leaf_woop(bvh),
                         counters, stats)


@torch.no_grad()
def _binary_plain(bvh, o, d, tmin, tmax, any_hit, *, packet, lbuf, compact,
                  packed, counters=False, stats=None):
    """The walk of ``csrc/block_walk.cuh`` (v1, v3) and
    ``csrc/binary_walk.cuh`` (v2, v4) in plain PyTorch: rays are padded
    with dead lanes to whole packets of `packet`, every packet keeps one
    stack row (and one leaf-buffer row of `lbuf` entries; 0: a leaf is tested
    at the pop, by the lanes that hit its box), and every live packet takes
    one node step or one flush per round. Same tables, operations, order of
    pops and fold as the kernels, so kernel and plain version agree lane for
    lane, counters included. `packet` is a parameter so that the walk can
    also be held against the reference's at ITS packet (1,024 lanes).

    stats: optional dict that receives ``node_pops`` (slab tests, one per
    live lane of the packet that popped the node) and ``tri_tests`` (valid
    triangles tested per lane), for the kernel's own work beside its bound."""
    if stats is not None:
        stats.update(node_pops=0, tri_tests=0, rounds=0)
    oc, dc = _components(o, d)
    dev = oc[0].device
    n = oc[0].shape[0]
    k = bvh.k
    npk = -(-n // packet)

    def lanes(x, fill):
        pad = x.new_full((npk * packet - n,), fill)
        return torch.cat([x, pad]).view(npk, packet)

    oc = [lanes(c, 0.0) for c in oc]
    dc = [lanes(c, 1.0) for c in dc]
    tmin, tmax = lanes(tmin, 0.0), lanes(tmax, -1.0)
    soup = bvh.soup16.view(bvh.n_clusters, k, 16)
    ids = bvh.soup16[:, 9].contiguous().view(torch.int32).view(-1, k)
    inv = [_safe_inv(c) for c in dc]
    alive = tmax >= tmin
    # the majority sign counts every lane of the packet, dead pads included
    neg = torch.stack([(c < 0).sum(1) > packet // 2 for c in dc], 1)  # (P, 3)
    inf = float("inf")
    t_best = torch.where(alive, tmax, -inf)
    prim = torch.full((npk, packet), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((npk, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.ones(npk, dtype=torch.long, device=dev)      # the root
    buf = torch.zeros((npk, max(lbuf, 1)), dtype=torch.int32, device=dev)
    nlb = torch.zeros(npk, dtype=torch.long, device=dev)
    steps = torch.zeros((npk, 2), dtype=torch.int32, device=dev)
    slots = torch.arange(k, dtype=torch.int32, device=dev)

    def live_of(pi):
        return alive[pi] & (prim[pi] < 0) if any_hit else alive[pi]

    def leaf_test(pi, cl, mask):
        """Packets `pi` test clusters `cl` on their lanes in `mask`."""
        tri = soup[cl][:, None]                              # (m, 1, K, 16)
        ok, t = _mt([c[pi, :, None] for c in oc], [c[pi, :, None] for c in dc],
                    tmin[pi, :, None], [tri[..., c] for c in range(3)],
                    [tri[..., 3 + c] for c in range(3)],
                    [tri[..., 6 + c] for c in range(3)])     # (m, packet, K)
        tested = (ids[cl] >= 0)[:, None] & mask[:, :, None]
        if stats is not None:
            stats["tri_tests"] += int(tested.sum())
        tm = torch.where(ok & tested, t, inf)
        if packed:      # slot in the low bits of t's pattern, integer minimum
            key = (tm.view(torch.int32) & ~IDX_MASK) | slots
            kmin = key.min(2).values
            j = kmin & IDX_MASK
            t_win = (kmin & ~IDX_MASK).view(torch.float32)
        else:           # strict and sequential: the first of equal t wins
            j = torch.argmin(tm, 2)
            t_win = torch.gather(tm, 2, j[:, :, None])[:, :, 0]
        better = t_win < t_best[pi]
        t_best[pi] = torch.where(better, t_win, t_best[pi])
        prim[pi] = torch.where(better, (cl[:, None] * k + j).to(torch.int32),
                               prim[pi])

    # an any-hit packet with no live lane never starts
    active = (alive.any(1) if any_hit
              else torch.ones(npk, dtype=torch.bool, device=dev))
    act = torch.nonzero(active).squeeze(1)
    while act.numel() > 0:
        stepping = (sp[act] > 0) & (nlb[act] < lbuf) if lbuf else sp[act] > 0
        si, fi = act[stepping], act[~stepping]
        if si.numel() > 0:
            # ---- node step: pop, slab-test the POPPED node, push or keep
            steps[si, 0] += 1
            sp[si] -= 1
            node = stack[si, sp[si]].long()
            b = bvh.bounds[node]                             # (m, 8)
            t0 = [(b[:, c, None] - oc[c][si]) * inv[c][si] for c in range(3)]
            t1 = [(b[:, 3 + c, None] - oc[c][si]) * inv[c][si]
                  for c in range(3)]
            tn = torch.maximum(
                torch.maximum(torch.minimum(t0[0], t1[0]),
                              torch.minimum(t0[1], t1[1])),
                torch.maximum(torch.minimum(t0[2], t1[2]), tmin[si]))
            tf = torch.minimum(
                torch.minimum(torch.maximum(t0[0], t1[0]),
                              torch.maximum(t0[1], t1[1])),
                torch.minimum(torch.maximum(t0[2], t1[2]), t_best[si]))
            live = live_of(si)
            if stats is not None:
                stats["node_pops"] += int(live.sum())
            slab = (tn <= tf) & live                         # (m, packet)
            nhit = slab.any(1)
            if compact:
                m0, c1 = bvh.meta2[node, 0], bvh.meta2[node, 1]
                is_leaf = m0 < 0
                c0, axis, cluster = m0 >> 2, m0 & 3, -m0 - 1
            else:
                c0, c1, axis = (bvh.meta[node, 0], bvh.meta[node, 1],
                                bvh.meta[node, 2])
                is_leaf = c0 < 0
                cluster = -c0 - 1
            ng = torch.gather(neg[si], 1, axis.clamp(0, 2).long()[:, None])
            ng = ng[:, 0]
            near = torch.where(ng, c1, c0)
            far = torch.where(ng, c0, c1)
            push = nhit & ~is_leaf
            pp = si[push]
            if bool((sp[pp] + 2 > STACK_DEPTH).any()):
                raise RuntimeError("binary walk: stack overflow")
            stack[pp, sp[pp]] = far[push]
            stack[pp, sp[pp] + 1] = near[push]
            sp[pp] += 2
            take = nhit & is_leaf
            tk = si[take]
            if lbuf:
                buf[tk, nlb[tk]] = cluster[take]
                nlb[tk] += 1
            elif tk.numel() > 0:
                steps[tk, 1] += 1
                leaf_test(tk, cluster[take].long(), slab[take])
        if fi.numel() > 0:
            # ---- flush: the buffered clusters in buffer order
            for q in range(int(nlb[fi].max())):
                fq = fi[nlb[fi] > q]
                leaf_test(fq, buf[fq, q].long(), live_of(fq))
            steps[fi, 1] += nlb[fi].to(torch.int32)
            nlb[fi] = 0
        going = (sp[act] > 0) | (nlb[act] > 0)
        if any_hit:     # the packet ends once no live lane lacks a hit
            going &= (alive[act] & (prim[act] < 0)).any(1)
        act = act[going]
        if stats is not None:
            stats["rounds"] += 1
    t_out = torch.where(prim >= 0, t_best, inf).view(-1)[:n]
    prim = prim.view(-1)[:n]
    return (t_out, prim, steps) if counters else (t_out, prim)


def _attic_plain(name):
    cfg = ATTIC[name]

    def plain(bvh: PackedBVH, o, d, tmin, tmax, *, any_hit: bool = False,
              counters: bool = False, packet: int = cfg["packet"],
              stats=None):
        return _binary_plain(bvh, o, d, tmin, tmax, any_hit,
                             **{**cfg, "packet": packet}, counters=counters,
                             stats=stats)
    plain.__doc__ = (f"The kernel of ``csrc/{name}.cu`` in plain PyTorch (see "
                     "``_binary_plain``); `packet` overrides the lanes that "
                     "share a stack.")
    return plain


traverse_plain = _attic_plain("traverse1")
traverse2_plain = _attic_plain("traverse2")
traverse3_plain = _attic_plain("traverse3")
traverse4_plain = _attic_plain("traverse4")


# ---------------------------------------------------------------------------
# Wavefront glue: coherence sort + exact hit finishing (plain tensor ops)
# ---------------------------------------------------------------------------

def sort_key_i32(oc, dc, tmin, tmax, lo, hi, anyflag=None):
    """int32 coherence key: dead flag | any-hit flag | direction octant |
    21-bit Morton code of the origin quantised into the scene bounds. Sorted
    waves put rays of one region and one octant into the same warps and the
    dead lanes last; `anyflag` (mixed waves) groups the shadow lanes."""
    def spread7(x):
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    i32 = torch.int32
    octant = ((dc[0] < 0).to(i32) * 1 + (dc[1] < 0).to(i32) * 2
              + (dc[2] < 0).to(i32) * 4)
    dead = (tmax < tmin).to(i32)
    sc = 127.0 / (hi - lo).clamp_min(1e-9)
    qs = [((oc[c] - lo[c]) * sc[c]).clamp(0.0, 127.0).to(i32)
          for c in range(3)]
    m = spread7(qs[0]) | (spread7(qs[1]) << 1) | (spread7(qs[2]) << 2)
    key = (dead << 25) | (octant << 21) | m
    if anyflag is not None:
        key = key | ((anyflag > 0).to(i32) << 24)
    return key


def _exact_mt(oc, dc, v0, e1, e2, hit):
    """Full-precision Moeller-Trumbore over component lists (the finish
    evaluation). Returns (t, u, v); t = +inf, u = v = 0 where not hit."""
    px = dc[1] * e2[2] - dc[2] * e2[1]
    py = dc[2] * e2[0] - dc[0] * e2[2]
    pz = dc[0] * e2[1] - dc[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    inv_det = 1.0 / torch.where(torch.abs(det) < TRI_EPS, 1.0, det)
    tx = oc[0] - v0[0]
    ty = oc[1] - v0[1]
    tz = oc[2] - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (dc[0] * qx + dc[1] * qy + dc[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    return (torch.where(hit, t, float("inf")), torch.where(hit, u, 0.0),
            torch.where(hit, v, 0.0))


def _bits_i32(col):
    """Reinterpret an f32 column holding int32 bit patterns (never cast)."""
    return col.contiguous().view(torch.int32)


def _lerped(bvh, rows, pp, time):
    """v0/e1/e2 component rows of the winners, lerped to the rays' shutter
    times for a moving scene: the kernel's two operations, a multiply and
    then an add. Only columns 0-8 of the delta rows are read."""
    cols = [rows[c] for c in range(9)]
    if time is not None and bvh.soup16d is not None:
        rd = bvh.soup16d[pp].t()
        cols = [a + time * rd[c] for c, a in enumerate(cols)]
    return cols[0:3], cols[3:6], cols[6:9]


def finish_hits(bvh: PackedBVH, perm, o, d, tmin, t_approx, prim_p,
                time=None):
    """Exact (t, b1, b2) + original prim ids for the kernel's winners: one
    row gather from soup16, one Moeller-Trumbore evaluation per ray (on the
    vertices lerped to `time` for a moving scene)."""
    oc, dc = _components(o, d)
    hit = prim_p >= 0
    pp = prim_p.clamp_min(0).long()
    rows = bvh.soup16[pp].t()                   # (16, R)
    t_out, u, v = _exact_mt(oc, dc, *_lerped(bvh, rows, pp, time), hit)
    prim = torch.where(hit, _bits_i32(rows[9]), -1)
    return t_out, prim, u, v


def finish_hits_rows(bvh: PackedBVH, attrp, o, d, tmin, t_approx, prim_p,
                     time=None):
    """finish_hits via the COMBINED finish+interaction table: one row gather
    serves both the exact-hit evaluation (cols 0-8 = the packed soup the
    kernel tested, col 36 = original prim id bits) and the shading
    interaction downstream (cols 9-35, scene/types._pack_attr layout). For a
    moving scene the finish vertices are lerped to `time`; the shading
    columns of the returned rows stay at shutter start.

    Returns (t, prim, b1, b2, rows) with rows (48, R)."""
    oc, dc = _components(o, d)
    hit = prim_p >= 0
    pp = prim_p.clamp_min(0).long()
    rows = attrp[pp].t().contiguous()           # (48, R)
    t_out, u, v = _exact_mt(oc, dc, *_lerped(bvh, rows, pp, time), hit)
    prim = torch.where(hit, _bits_i32(rows[36]), -1)
    return t_out, prim, u, v, rows


# which kernel serves which kind of wave, by name (the reference's table also
# carries a block height; the port's packet width is fixed, so there is none
# to choose). v6 everywhere, as in the reference; "v5" and "v7" are the
# packet kernels over the wide tree, "v1" .. "v4" the older ones over the
# binary tree.
DEFAULT_KERNEL = dict(closest_coherent="v6", closest="v6", any="v6")


def _kernel_span(motion: bool):
    """The ``kernel`` span of one launch, with the attribute ``motion=True``
    where the launch takes the kernel's motion instantiation (rays with
    shutter times over a scene packed with deltas)."""
    return (stats.span("kernel", motion=True) if motion
            else stats.span("kernel"))


def _sorted_launch(fn, bvh, key_fn, planes, **kw):
    """Stable sort by the key ``key_fn()`` makes, gather the ray planes (o,
    d, tmin, tmax, then the optional per-lane planes named in `kw`),
    traverse with `fn`, unsort: the spans ``sort``, ``kernel`` (tagged
    ``motion`` where `kw` carries the rays' ``time``) and ``finish``."""
    with stats.span("sort"):
        order = torch.sort(key_fn(), stable=True).indices
        s = [p[order] for p in planes]
        kw = {k: (v[order] if torch.is_tensor(v) else v)
              for k, v in kw.items()}
    with _kernel_span("time" in kw):
        t_s, prim_s = fn(bvh, V3(s[0], s[1], s[2]), V3(s[3], s[4], s[5]),
                         s[6], s[7], **kw)
    with stats.span("finish"):
        t = torch.empty_like(t_s)
        prim_p = torch.empty_like(prim_s)
        t[order] = t_s
        prim_p[order] = prim_s
    return t, prim_p


@torch.no_grad()
def intersect_rays(bvh: PackedBVH, perm, lo, hi, o, d, tmin, tmax, *,
                   any_hit: bool = False, sort: bool = True,
                   kernel: str | None = None, time=None, rows_table=None,
                   counts=None):
    """Full traversal pipeline: coherence sort -> kernel -> unsort -> finish.

    Returns (t, prim, b1, b2) in the ORIGINAL ray order; prim indexes the
    original triangle soup (-1 miss). For any_hit, b1/b2 are zeros, t is the
    (approximate) blocker distance and prim is the PERMUTED id (callers only
    test its sign). With rows_table (the geometry's attrp) the return tuple
    gains the gathered (48, R) rows.

    kernel: "v1" .. "v7"; None takes ``DEFAULT_KERNEL`` by the kind of wave
    (any-hit, sorted closest, unsorted closest). time: (R,) shutter
    times in [0, 1] for a scene packed with deltas; it travels with the sort
    and needs the v6 kernel. counts: a dict the motion launch's work goes
    to (``traverse6``'s)."""
    cfg_key = "any" if any_hit else ("closest" if sort else "closest_coherent")
    which = kernel if kernel else DEFAULT_KERNEL[cfg_key]
    fns = {"v1": traverse, "v2": traverse2, "v3": traverse3,
           "v4": traverse4, "v5": traverse5, "v6": traverse6, "v7": traverse7}
    if which not in fns:
        raise ValueError(f"unknown traversal kernel {which!r}")
    if bvh.soup16d is None:
        time = None
    if time is not None and which != "v6":
        raise ValueError("moving geometry requires the v6 kernel, "
                         f"not {which!r}")
    kw = {"any_hit": any_hit}
    if time is not None:
        kw.update(time=time, counts=counts)
    oc, dc = _components(o, d)
    if sort:
        t, prim_p = _sorted_launch(
            fns[which], bvh, lambda: sort_key_i32(oc, dc, tmin, tmax, lo, hi),
            [*oc, *dc, tmin, tmax], **kw)
    else:
        with _kernel_span(time is not None):
            t, prim_p = fns[which](bvh, o, d, tmin, tmax, **kw)
    with stats.span("finish"):
        if any_hit:
            z = torch.zeros_like(t)
            return t, prim_p, z, z
        if rows_table is not None:
            return finish_hits_rows(bvh, rows_table, o, d, tmin, t, prim_p,
                                    time=time)
        return finish_hits(bvh, perm, o, d, tmin, t, prim_p, time=time)


@torch.no_grad()
def intersect_rays_pair(bvh: PackedBVH, perm, lo, hi,
                        o_e, d_e, tmin_e, tmax_e,
                        o_s, d_s, tmin_s, tmax_s, *,
                        time_e=None, time_s=None, rows_table=None,
                        counts=None):
    """ONE traversal launch over 2R lanes: closest-hit extension rays +
    any-hit shadow rays, told apart by a per-lane flag (the v6 kernel's mixed
    mode). Both sets start at the same hit points, so they share the sort
    and the launch. For a scene packed with deltas the two time planes are
    concatenated and sorted with the rest, and `counts` takes the motion
    launch's work (``traverse6``'s).

    Returns (t, prim, b1, b2) for the extension half (original order,
    original soup ids) and `occluded` bool for the shadow half
    (+ rows when rows_table is given)."""
    with stats.span("sort"):
        oce, dce = _components(o_e, d_e)
        ocs, dcs = _components(o_s, d_s)
        n = oce[0].shape[0]
        oc = [torch.cat([a, b]) for a, b in zip(oce, ocs)]
        dc = [torch.cat([a, b]) for a, b in zip(dce, dcs)]
        tmin = torch.cat([tmin_e, tmin_s])
        tmax = torch.cat([tmax_e, tmax_s])
        af = torch.cat([torch.zeros_like(tmin_e), torch.ones_like(tmin_s)])
        if time_e is None or bvh.soup16d is None:
            time_e = None
        kw = {} if time_e is None else {"time": torch.cat([time_e, time_s]),
                                        "counts": counts}
    t, prim_p = _sorted_launch(
        traverse6, bvh,
        lambda: sort_key_i32(oc, dc, tmin, tmax, lo, hi, anyflag=af),
        [*oc, *dc, tmin, tmax], anyf=af, **kw)
    with stats.span("finish"):
        occluded = prim_p[n:] >= 0
        if rows_table is not None:
            te, prime, b1, b2, rows = finish_hits_rows(
                bvh, rows_table, o_e, d_e, tmin_e, t[:n], prim_p[:n],
                time=time_e)
            return te, prime, b1, b2, occluded, rows
        te, prime, b1, b2 = finish_hits(bvh, perm, o_e, d_e, tmin_e,
                                        t[:n], prim_p[:n], time=time_e)
        return te, prime, b1, b2, occluded
