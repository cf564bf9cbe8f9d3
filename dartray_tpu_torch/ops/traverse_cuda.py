"""Wide-BVH traversal: the CUDA kernel's wrapper, its plain PyTorch version
and the wavefront glue around them (counterpart of the JAX reference's
``ops/traverse_pallas.py``).

The kernel (``csrc/traverse6.cu``, built with ``nvcc`` for ``sm_90a`` at first
use and loaded with ``ctypes``) replaces the reference's Pallas kernel
``_kernel6`` / ``traverse6`` in its closest-hit, any-hit and mixed modes. It
returns ``(t, permuted prim)`` only; exact ``t`` and barycentrics are
recomputed for the winners by one gathered Moeller-Trumbore evaluation
(``finish_hits`` / ``finish_hits_rows``), so results are compared after that
finish step, never on the kernel's raw ``t``.

The reference kernel's ablation and work-around switches (its ``DR_V6_*``
environment knobs, ``bf16=``, ``push_bits``) have no counterpart here: they
probe or work around the other machine's compiler, they are not separate
functions. Its chunked dispatch around a scratch-memory limit is dropped too:
one launch covers the whole wave, and dead lanes (``tmax < tmin``) leave the
kernel at once. The motion-blur mode of the kernel is not ported yet.

``traverse6`` takes the plain version (``traverse6_plain``) only for tensors
that lie on the CPU. For a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from ..core.math import V3

TRI_EPS = 1e-10
BARY_EPS = 1e-6
STACK_DEPTH = 96          # per-ray stack entries (csrc/traverse6.cu)

MODE_CLOSEST, MODE_ANY, MODE_MIXED = 0, 1, 2
MODE_NAMES = ("closest", "any", "mixed")

# launches of the CUDA kernel by mode: incremented where the kernel is
# launched and nowhere else
LAUNCHES = {"closest": 0, "any": 0, "mixed": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass
class PackedBVH:
    """Kernel-ready scene: wide-node tables + cluster-permuted triangle soup.

    wbounds: (W, 48) f32 rows [lox*8 loy*8 loz*8 hix*8 hiy*8 hiz*8], NaN pads
    worder:  (8 W, 8) i32 rows of far-first child entries per octant,
             entry = ref*8 + slot, ref < 0 -> leaf cluster -ref-1.
    soup16: (C*K, 16) f32 rows [v0 e1 e2 orig_id_bits 0...]: the table the
            kernel's leaf test and the finish step read. Triangle j of
            cluster c has permuted prim id c*K + j; pad slots (id < 0) have
            zero edges (never hit) and TRAIL the real triangles of their
            cluster: the kernel's leaf loop stops at the first one.

    The binary-tree tables of the reference's older kernels are not built:
    they come back with the kernels that read them.
    """
    wbounds: object
    worder: object
    soup16: object
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


def pack(node_lo, node_hi, node_child, tv0, te1, te2, tid):
    """Build PackedBVH from ClusterBVH-style arrays ((C,K,3) tris, (C,K) ids).

    Returns (packed, perm) where perm (C*K,) maps permuted prim id -> original
    triangle id (-1 for pad slots). Pad slots get zeroed edges. Host numpy."""
    from ..accel.wide import build_wide
    tid = np.asarray(tid, np.int32)
    check_pads_trail(tid)
    pad = tid < 0
    v0 = np.where(pad[..., None], 0.0, np.asarray(tv0, np.float32))
    e1 = np.where(pad[..., None], 0.0, np.asarray(te1, np.float32))
    e2 = np.where(pad[..., None], 0.0, np.asarray(te2, np.float32))
    c, k = tid.shape
    wbounds, worder, n_w = build_wide(node_lo, node_hi, node_child)
    perm_flat = tid.reshape(-1)
    packed = PackedBVH(
        wbounds=wbounds, worder=worder,
        soup16=soup_pack16(*(np.moveaxis(x, -1, 0) for x in (v0, e1, e2)),
                           perm_flat),
        n_nodes=node_lo.shape[0], n_clusters=c, k=k, n_wnodes=n_w)
    return packed, perm_flat


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


def _components(o, d):
    """V3 or (R, 3) -> component tuples."""
    if isinstance(o, V3):
        return (o.x, o.y, o.z), (d.x, d.y, d.z)
    return ((o[:, 0], o[:, 1], o[:, 2]), (d[:, 0], d[:, 1], d[:, 2]))


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PKG, "csrc", "traverse6.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: products and sums round as the plain version's separate ops
# do, so both take the same walk; -Xptxas -v: the assembler reports the
# kernel's registers and spills into BUILD_LOG
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
BUILD_LOG = ""            # nvcc's output of the build this process made
_lib = None
_lib_lock = threading.Lock()
_overflow = {}            # device -> int32[1] flag the kernel ORs into


def _find_nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the traversal kernel is built from "
                       f"{KERNEL_SOURCE} at first use and needs the CUDA "
                       "toolkit")


def build_command(so_path):
    return [_find_nvcc(), *NVCC_FLAGS, "-o", so_path, KERNEL_SOURCE]


def load_kernel():
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(KERNEL_SOURCE, "rb") as f:
            tag = hashlib.sha1(f.read()).hexdigest()[:12]
        so = os.path.join(BUILD_DIR, f"libtraverse6_{tag}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(build_command(tmp), capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed building traverse6.cu:\n"
                                   + proc.stdout + proc.stderr)
            BUILD_LOG = (proc.stdout + proc.stderr).strip()
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        p = ctypes.c_void_p
        lib.traverse6_launch.restype = ctypes.c_int
        lib.traverse6_launch.argtypes = [p] * 15 + [ctypes.c_int] * 4 + [p]
        lib.traverse6_stack_depth.restype = ctypes.c_int
        lib.traverse6_stack_depth.argtypes = []
        if lib.traverse6_stack_depth() != STACK_DEPTH:
            raise RuntimeError("traverse6.cu STACK_DEPTH differs from the "
                               "wrapper's")
        _lib = lib
        return lib


def overflow_flag(device):
    """int32[1] on `device`: nonzero once any launch since the last
    ``reset_overflow`` ran out of per-ray stack. Reading it synchronises."""
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
        raise ValueError(f"traverse6: {name} must be a ({n},) {dtype} tensor "
                         f"on {device}, got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    return x.contiguous()


def _check_table(x, name, shape, device, dtype):
    if (not torch.is_tensor(x) or x.device != device or x.dtype != dtype
            or tuple(x.shape) != shape or not x.is_contiguous()):
        raise ValueError(f"traverse6: bvh.{name} must be a contiguous "
                         f"{shape} {dtype} tensor on {device}")
    return x


def _traverse6_cuda(bvh, oc, dc, tmin, tmax, mode, anyf):
    dev = oc[0].device
    n = oc[0].shape[0]
    lib = load_kernel()
    planes = [_check_plane(x, nm, n, dev) for x, nm in
              zip((*oc, *dc, tmin, tmax),
                  ("ox", "oy", "oz", "dx", "dy", "dz", "tmin", "tmax"))]
    if mode == MODE_MIXED:
        anyf = _check_plane(anyf, "anyf", n, dev)
    w = bvh.n_wnodes
    wb = _check_table(bvh.wbounds, "wbounds", (w, 48), dev, torch.float32)
    wo = _check_table(bvh.worder, "worder", (8 * w, 8), dev, torch.int32)
    soup = _check_table(bvh.soup16, "soup16", (bvh.n_clusters * bvh.k, 16),
                        dev, torch.float32)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:                # nothing to launch, nothing to count
        return t, prim
    flag = overflow_flag(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.traverse6_launch(
            wb.data_ptr(), wo.data_ptr(), soup.data_ptr(),
            *(x.data_ptr() for x in planes),
            anyf.data_ptr() if mode == MODE_MIXED else None,
            t.data_ptr(), prim.data_ptr(), flag.data_ptr(),
            n, w, bvh.k, mode, stream)
    if rc != 0:
        raise RuntimeError(f"traverse6 kernel launch failed: CUDA error {rc}")
    LAUNCHES[MODE_NAMES[mode]] += 1
    return t, prim


def traverse6(bvh: PackedBVH, o, d, tmin, tmax, *, any_hit: bool = False,
              anyf=None):
    """Walk the wide BVH for every ray: returns ``(t, prim)`` with t f32
    (+inf on a miss; approximate for any-hit lanes) and the permuted prim id
    ``cluster*K + j`` (i32, -1 on a miss).

    anyf: optional (R,) f32 per-lane any-hit flags (mixed waves: lanes with
    anyf > 0 stop at their first hit, the others find the closest).
    Closest lanes return the nearest t in (tmin, tmax]. CUDA tensors go to
    the kernel, CPU tensors to ``traverse6_plain``."""
    oc, dc = _components(o, d)
    mode = MODE_MIXED if anyf is not None else (
        MODE_ANY if any_hit else MODE_CLOSEST)
    with torch.no_grad():
        if oc[0].device.type == "cuda":
            return _traverse6_cuda(bvh, oc, dc, tmin, tmax, mode, anyf)
        return traverse6_plain(bvh, o, d, tmin, tmax, any_hit=any_hit,
                               anyf=anyf)


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


@torch.no_grad()
def traverse6_plain(bvh: PackedBVH, o, d, tmin, tmax, *,
                    any_hit: bool = False, anyf=None, stats=None):
    """``traverse6`` in plain PyTorch: every ray keeps its own stack row of a
    ``(R, STACK_DEPTH)`` tensor and all live rays take one pop per round
    (interior refs slab-test 8 children and push the hit ones far first,
    leaf refs test their cluster). Same tables, same order of operations and
    same per-ray walk as the CUDA kernel.

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
            b = wb[node]                                     # (m, 6, 8)
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
            ok, t = _mt([c[li, None] for c in oc], [c[li, None] for c in dc],
                        tmin[li, None],
                        [tri[:, :, c] for c in range(3)],
                        [tri[:, :, 3 + c] for c in range(3)],
                        [tri[:, :, 6 + c] for c in range(3)])
            tb = t_best[li, None]
            acc = ok & valid & ((t < tb) | ((prim[li] < 0)[:, None]
                                            & (t == tb)))
            got = acc.any(1)
            tm = torch.where(acc, t, inf)
            j_min = torch.argmin(tm, 1)
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


def finish_hits(bvh: PackedBVH, perm, o, d, tmin, t_approx, prim_p):
    """Exact (t, b1, b2) + original prim ids for the kernel's winners: one
    row gather from soup16, one Moeller-Trumbore evaluation per ray."""
    oc, dc = _components(o, d)
    hit = prim_p >= 0
    pp = prim_p.clamp_min(0).long()
    rows = bvh.soup16[pp].t()                   # (16, R)
    t_out, u, v = _exact_mt(oc, dc, rows[0:3], rows[3:6], rows[6:9], hit)
    prim = torch.where(hit, _bits_i32(rows[9]), -1)
    return t_out, prim, u, v


def finish_hits_rows(bvh: PackedBVH, attrp, o, d, tmin, t_approx, prim_p):
    """finish_hits via the COMBINED finish+interaction table: one row gather
    serves both the exact-hit evaluation (cols 0-8 = the packed soup the
    kernel tested, col 36 = original prim id bits) and the shading
    interaction downstream (cols 9-35, scene/types._pack_attr layout).

    Returns (t, prim, b1, b2, rows) with rows (48, R)."""
    oc, dc = _components(o, d)
    hit = prim_p >= 0
    pp = prim_p.clamp_min(0).long()
    rows = attrp[pp].t().contiguous()           # (48, R)
    t_out, u, v = _exact_mt(oc, dc, rows[0:3], rows[3:6], rows[6:9], hit)
    prim = torch.where(hit, _bits_i32(rows[36]), -1)
    return t_out, prim, u, v, rows


def _sorted_launch(bvh, key, planes, any_hit, mixed):
    """Stable sort by key, gather the ray planes, traverse, unsort."""
    order = torch.sort(key, stable=True).indices
    s = [p[order] for p in planes]
    t_s, prim_s = traverse6(bvh, V3(s[0], s[1], s[2]), V3(s[3], s[4], s[5]),
                            s[6], s[7], any_hit=any_hit,
                            anyf=s[8] if mixed else None)
    t = torch.empty_like(t_s)
    prim_p = torch.empty_like(prim_s)
    t[order] = t_s
    prim_p[order] = prim_s
    return t, prim_p


@torch.no_grad()
def intersect_rays(bvh: PackedBVH, perm, lo, hi, o, d, tmin, tmax, *,
                   any_hit: bool = False, sort: bool = True,
                   rows_table=None):
    """Full traversal pipeline: coherence sort -> kernel -> unsort -> finish.

    Returns (t, prim, b1, b2) in the ORIGINAL ray order; prim indexes the
    original triangle soup (-1 miss). For any_hit, b1/b2 are zeros, t is the
    (approximate) blocker distance and prim is the PERMUTED id (callers only
    test its sign). With rows_table (the geometry's attrp) the return tuple
    gains the gathered (48, R) rows."""
    oc, dc = _components(o, d)
    if sort:
        key = sort_key_i32(oc, dc, tmin, tmax, lo, hi)
        t, prim_p = _sorted_launch(bvh, key, [*oc, *dc, tmin, tmax],
                                   any_hit, False)
    else:
        t, prim_p = traverse6(bvh, o, d, tmin, tmax, any_hit=any_hit)
    if any_hit:
        z = torch.zeros_like(t)
        return t, prim_p, z, z
    if rows_table is not None:
        return finish_hits_rows(bvh, rows_table, o, d, tmin, t, prim_p)
    return finish_hits(bvh, perm, o, d, tmin, t, prim_p)


@torch.no_grad()
def intersect_rays_pair(bvh: PackedBVH, perm, lo, hi,
                        o_e, d_e, tmin_e, tmax_e,
                        o_s, d_s, tmin_s, tmax_s, *, rows_table=None):
    """ONE traversal launch over 2R lanes: closest-hit extension rays +
    any-hit shadow rays, told apart by a per-lane flag (the kernel's mixed
    mode). Both sets start at the same hit points, so they share the sort
    and the launch.

    Returns (t, prim, b1, b2) for the extension half (original order,
    original soup ids) and `occluded` bool for the shadow half
    (+ rows when rows_table is given)."""
    oce, dce = _components(o_e, d_e)
    ocs, dcs = _components(o_s, d_s)
    n = oce[0].shape[0]
    oc = [torch.cat([a, b]) for a, b in zip(oce, ocs)]
    dc = [torch.cat([a, b]) for a, b in zip(dce, dcs)]
    tmin = torch.cat([tmin_e, tmin_s])
    tmax = torch.cat([tmax_e, tmax_s])
    af = torch.cat([torch.zeros_like(tmin_e), torch.ones_like(tmin_s)])
    key = sort_key_i32(oc, dc, tmin, tmax, lo, hi, anyflag=af)
    t, prim_p = _sorted_launch(bvh, key, [*oc, *dc, tmin, tmax, af],
                               False, True)
    occluded = prim_p[n:] >= 0
    if rows_table is not None:
        te, prime, b1, b2, rows = finish_hits_rows(
            bvh, rows_table, o_e, d_e, tmin_e, t[:n], prim_p[:n])
        return te, prime, b1, b2, occluded, rows
    te, prime, b1, b2 = finish_hits(bvh, perm, o_e, d_e, tmin_e,
                                    t[:n], prim_p[:n])
    return te, prime, b1, b2, occluded
