"""Cluster BVH: host build and the packet walk (counterpart of the JAX
reference's ``accel/cluster.py``).

Triangles are grouped into fixed-size CLUSTERS (K triangles, SAH-built
leaves) and a binary BVH is built over the clusters, in host numpy.
``accel/wide.py`` collapses that tree to 8-ary and ``ops/traverse_cuda.py``
packs it and walks it with the kernels: that is the renderer's path.

``intersect`` / ``intersect_p`` are the reference's own packet walk over the
binary tree, in plain torch: rays go in packets of ``PACKET`` (128) with ONE
node stack a packet and near-child-first order from the packet's majority
direction sign. An inner loop takes node-only steps (one slab test a packet
a step) and buffers up to ``LEAF_BUF`` leaf clusters a packet; then one
dense (packet, ray, buffered triangle) Moeller-Trumbore flush a round.
Moving geometry (``build_motion``) lerps the buffered triangles to each
ray's time in the flush.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import math as vm
from .traverse import Hits, _slab_test, inv_dir, mt_test_plain

PACKET = 128          # rays per packet
DEFAULT_K = 32        # triangles per cluster
N_BUCKETS = 12


@dataclasses.dataclass
class ClusterBVH:
    node_lo: np.ndarray     # (N, 3)
    node_hi: np.ndarray     # (N, 3)
    node_child: np.ndarray  # (N, 2) int32; leaf: child[0] = -(cluster+1)
    node_axis: np.ndarray   # (N,) int32
    tri_v0: np.ndarray      # (C, K, 3)
    tri_e1: np.ndarray      # (C, K, 3)
    tri_e2: np.ndarray      # (C, K, 3)
    tri_id: np.ndarray      # (C, K) int32 original prim ids (-1 pad)
    # moving geometry (build_motion): shutter-close MINUS shutter-open soups,
    # (C, K, 3) each, in the same cluster order; None for a static scene
    tri_dv0: np.ndarray = None
    tri_de1: np.ndarray = None
    tri_de2: np.ndarray = None
    n_nodes: int = 0
    n_clusters: int = 0
    k: int = 0
    max_depth: int = 0


def build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
          k: int = DEFAULT_K, split_method: str = "sah") -> ClusterBVH:
    """SAH build with K-triangle leaves -> packed cluster arrays.

    Uses the native C++ builder (accel/native) when it can be built; the
    numpy builder below makes the same kind of tree but is orders of
    magnitude slower on large meshes. Which one ran is logged once."""
    from . import native
    if split_method == "sah":
        nat = _native_build(v0, e1, e2, k)
        if nat is not None:
            native.report_builder("native")
            return nat
        native.report_builder("numpy", "native library unavailable")
    else:
        native.report_builder("numpy", f"split_method={split_method!r}")
    f = v0.shape[0]
    v0d = v0.astype(np.float64)
    lo = np.minimum(np.minimum(v0d, v0d + e1), v0d + e2)
    hi = np.maximum(np.maximum(v0d, v0d + e1), v0d + e2)
    cen = 0.5 * (lo + hi)

    max_nodes = 4 * max(f // k, 1) + 64
    nb_lo = np.zeros((max_nodes, 3))
    nb_hi = np.zeros((max_nodes, 3))
    child = np.full((max_nodes, 2), -1, np.int64)
    axis_arr = np.zeros(max_nodes, np.int32)
    clusters = []   # list of index arrays
    order = np.arange(f)
    stack = [(0, 0, f, 0)]
    n_nodes = 1
    max_depth = 0
    while stack:
        node, s, e, d = stack.pop()
        max_depth = max(max_depth, d)
        idx = order[s:e]
        nb_lo[node] = lo[idx].min(axis=0)
        nb_hi[node] = hi[idx].max(axis=0)
        if e - s <= k:
            child[node, 0] = -(len(clusters) + 1)
            clusters.append(idx.copy())
            continue
        c = cen[idx]
        ext = c.max(axis=0) - c.min(axis=0)
        dim = int(np.argmax(ext))
        axis_arr[node] = dim
        if ext[dim] < 1e-12 or split_method == "equal":
            order[s:e] = idx[np.argsort(c[:, dim], kind="stable")]
            mid = (s + e) // 2
        elif split_method == "middle":
            pivot = 0.5 * (c[:, dim].min() + c[:, dim].max())
            mask = c[:, dim] < pivot
            mid = s + int(mask.sum())
            order[s:e] = np.concatenate([idx[mask], idx[~mask]])
            if mid == s or mid == e:
                order[s:e] = idx[np.argsort(c[:, dim], kind="stable")]
                mid = (s + e) // 2
        else:  # binned SAH
            cmin, cmax = c[:, dim].min(), c[:, dim].max()
            b = np.minimum(((c[:, dim] - cmin) / (cmax - cmin) * N_BUCKETS)
                           .astype(np.int64), N_BUCKETS - 1)
            counts = np.bincount(b, minlength=N_BUCKETS)
            blo = np.full((N_BUCKETS, 3), np.inf)
            bhi = np.full((N_BUCKETS, 3), -np.inf)
            np.minimum.at(blo, b, lo[idx])
            np.maximum.at(bhi, b, hi[idx])

            def sa(l, h):
                dd = np.maximum(h - l, 0.0)
                return 2 * (dd[:, 0] * dd[:, 1] + dd[:, 1] * dd[:, 2]
                            + dd[:, 2] * dd[:, 0])
            plo = np.minimum.accumulate(blo, axis=0)
            phi = np.maximum.accumulate(bhi, axis=0)
            slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            cl = np.cumsum(counts)
            cr = counts.sum() - cl
            cost = sa(plo, phi)[:-1] * cl[:-1] + sa(slo, shi)[1:] * cr[:-1]
            valid = (cl[:-1] > 0) & (cr[:-1] > 0)
            if not valid.any():
                order[s:e] = idx[np.argsort(c[:, dim], kind="stable")]
                mid = (s + e) // 2
            else:
                cost = np.where(valid, cost, np.inf)
                split_b = int(np.argmin(cost))
                mask = b <= split_b
                mid = s + int(mask.sum())
                order[s:e] = np.concatenate([idx[mask], idx[~mask]])
        l_id, r_id = n_nodes, n_nodes + 1
        n_nodes += 2
        child[node] = (l_id, r_id)
        stack.append((l_id, s, mid, d + 1))
        stack.append((r_id, mid, e, d + 1))

    c_n = len(clusters)
    tv0 = np.zeros((c_n, k, 3), np.float32)
    te1 = np.zeros((c_n, k, 3), np.float32)
    te2 = np.zeros((c_n, k, 3), np.float32)
    tid = np.full((c_n, k), -1, np.int32)
    for ci, idx in enumerate(clusters):
        m = len(idx)
        tv0[ci, :m] = v0[idx]
        te1[ci, :m] = e1[idx]
        te2[ci, :m] = e2[idx]
        tid[ci, :m] = idx
    # host numpy end to end: the caller moves the finished scene to the
    # device once (scene.types.to_device)
    return ClusterBVH(
        node_lo=np.ascontiguousarray(nb_lo[:n_nodes], np.float32),
        node_hi=np.ascontiguousarray(nb_hi[:n_nodes], np.float32),
        node_child=np.ascontiguousarray(child[:n_nodes], np.int32),
        node_axis=np.ascontiguousarray(axis_arr[:n_nodes], np.int32),
        tri_v0=tv0, tri_e1=te1, tri_e2=te2, tri_id=tid,
        n_nodes=n_nodes, n_clusters=c_n, k=k, max_depth=max_depth)


def build_motion(v0a, e1a, e2a, v0b, e1b, e2b, k: int = DEFAULT_K,
                 split_method: str = "sah") -> ClusterBVH:
    """Continuous-motion build: ONE tree whose per-triangle bounds are the
    UNION of the shutter-open (a) and shutter-close (b) boxes (exact for
    linear vertex motion), with the start soup and the (close - open) deltas
    packed in cluster order so that leaf tests can lerp by ray time.

    ``build`` only consumes per-triangle lo / hi / centroid, so it is
    fed a degenerate PROXY triangle per prim (v0 = union-lo, e1 =
    union-extent, e2 = 0: its box IS the union box), and the true start and
    delta soups are gathered again through the returned cluster order."""
    def aabb(v0, e1, e2):
        v0d = v0.astype(np.float64)
        lo = np.minimum(np.minimum(v0d, v0d + e1), v0d + e2)
        hi = np.maximum(np.maximum(v0d, v0d + e1), v0d + e2)
        return lo, hi

    lo_a, hi_a = aabb(v0a, e1a, e2a)
    lo_b, hi_b = aabb(v0b, e1b, e2b)
    lo_u = np.minimum(lo_a, lo_b).astype(np.float32)
    hi_u = np.maximum(hi_a, hi_b).astype(np.float32)
    cb = build(lo_u, hi_u - lo_u, np.zeros_like(lo_u), k=k,
               split_method=split_method)
    tid = cb.tri_id
    valid = tid >= 0
    ids = np.maximum(tid, 0)

    def gk(a):
        out = np.zeros(tid.shape + (3,), np.float32)
        out[valid] = np.asarray(a, np.float32)[ids[valid]]
        return out

    return dataclasses.replace(
        cb,
        tri_v0=gk(v0a), tri_e1=gk(e1a), tri_e2=gk(e2a),
        tri_dv0=gk(v0b) - gk(v0a), tri_de1=gk(e1b) - gk(e1a),
        tri_de2=gk(e2b) - gk(e2a))


def _native_build(v0, e1, e2, k):
    from . import native
    res = native.cluster_bvh_build(np.asarray(v0, np.float32),
                                   np.asarray(e1, np.float32),
                                   np.asarray(e2, np.float32), k)
    if res is None:
        return None
    (node_lo, node_hi, node_child, node_axis, tri_order, cl_start, cl_cnt,
     n_nodes, n_clusters, max_depth) = res
    tv0 = np.zeros((n_clusters, k, 3), np.float32)
    te1 = np.zeros((n_clusters, k, 3), np.float32)
    te2 = np.zeros((n_clusters, k, 3), np.float32)
    tid = np.full((n_clusters, k), -1, np.int32)
    # vectorized padded gather: rows (cluster, slot) -> tri id or -1
    slot = np.arange(k)[None, :]
    valid = slot < cl_cnt[:, None]
    src = np.minimum(cl_start[:, None] + slot, len(tri_order) - 1)
    ids = tri_order[src]
    tv0[valid] = v0[ids[valid]]
    te1[valid] = e1[ids[valid]]
    te2[valid] = e2[ids[valid]]
    tid[valid] = ids[valid]
    return ClusterBVH(
        node_lo=np.asarray(node_lo, np.float32),
        node_hi=np.asarray(node_hi, np.float32),
        node_child=np.asarray(node_child, np.int32),
        node_axis=np.asarray(node_axis, np.int32),
        tri_v0=tv0, tri_e1=te1, tri_e2=te2, tri_id=tid,
        n_nodes=int(n_nodes), n_clusters=int(n_clusters), k=int(k),
        max_depth=int(max_depth))



def _pad_packets(x, n_pad, fill):
    if n_pad == 0:
        return x
    pad = torch.full((n_pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


LEAF_BUF = 8  # clusters buffered per packet between dense flushes
# packets a flush takes at once: its (packets, PACKET, LEAF_BUF * K, 3)
# float32 temporaries are 0.4 MB a packet each at K = 32
FLUSH_PACKETS = 256
_TABLES = ("node_lo", "node_hi", "node_child", "node_axis", "tri_v0",
           "tri_e1", "tri_e2", "tri_id", "tri_dv0", "tri_de1", "tri_de2")

# walk counters of the packet walk: queries walked, inner (node) steps and
# flushes (one a round of the outer loop)
STEPS = {"queries": 0, "steps": 0, "flushes": 0}


def to_device(bvh: ClusterBVH, device) -> ClusterBVH:
    """The tree's tables as tensors on `device` (what the walk reads);
    sizes and depth unchanged."""
    dev = torch.device(device)
    return dataclasses.replace(bvh, **{
        f: None if getattr(bvh, f) is None
        else torch.as_tensor(getattr(bvh, f), device=dev) for f in _TABLES})


@torch.no_grad()
def _traverse(bvh: ClusterBVH, rays: vm.Rays, any_hit: bool,
              t_cull_quantile=None):
    """Packet traversal; rays are padded to a multiple of PACKET with dead
    lanes (tmax = -1).

    Two nested loops: the inner loop runs node-only steps while any packet
    has stack left and buffer room; then the outer loop runs ONE dense
    Moeller-Trumbore flush of every packet's buffered clusters and empties
    the buffers. Any-hit clears a packet's stack once all its live rays
    have hit. `t_cull_quantile` is accepted and never read, as in the
    reference."""
    o = vm.to_arr(rays.o)
    d = vm.to_arr(rays.d)
    dev = o.device
    bvh = to_device(bvh, dev)
    r = o.shape[0]
    n_pad = (-r) % PACKET
    np_ = (r + n_pad) // PACKET
    o = _pad_packets(o, n_pad, 0.0).reshape(np_, PACKET, 3)
    d = _pad_packets(d, n_pad, 1.0).reshape(np_, PACKET, 3)
    tmin = _pad_packets(rays.tmin, n_pad, 0.0).reshape(np_, PACKET)
    tmax = _pad_packets(rays.tmax, n_pad, -1.0).reshape(np_, PACKET)
    has_motion = bvh.tri_dv0 is not None
    if has_motion:
        time = _pad_packets(rays.time, n_pad, 0.0).reshape(np_, PACKET)
    inv_d = inv_dir(d)
    # packet majority direction sign per axis
    neg_major = (d < 0).sum(1) > (PACKET // 2)              # (np_, 3)

    depth = bvh.max_depth + 2
    stack = torch.zeros((np_, depth), dtype=torch.long, device=dev)
    sp = torch.ones(np_, dtype=torch.long, device=dev)     # root pushed
    t_best = torch.where(tmax >= tmin, tmax, tmin - 1.0)
    prim = torch.full((np_, PACKET), -1, dtype=torch.int32, device=dev)
    b1 = torch.zeros((np_, PACKET), dtype=torch.float32, device=dev)
    b2 = torch.zeros_like(b1)
    alive0 = tmax >= tmin
    done = torch.zeros((np_, PACKET), dtype=torch.bool, device=dev)
    buf = torch.zeros((np_, LEAF_BUF), dtype=torch.long, device=dev)
    nbuf = torch.zeros(np_, dtype=torch.long, device=dev)
    pk = torch.arange(np_, device=dev)
    k = bvh.k
    node_child = bvh.node_child.long()
    node_axis = bvh.node_axis.long()
    STEPS["queries"] += 1

    def inner_step(stack, sp, nbuf):
        can = (sp > 0) & (nbuf < LEAF_BUF)
        spm1 = torch.where(can, sp - 1, sp)
        node = stack.gather(1, spm1.clamp_min(0)[:, None])[:, 0]
        node = torch.where(can, node, 0)
        ray_hit = (_slab_test(o, inv_d, bvh.node_lo[node][:, None, :],
                              bvh.node_hi[node][:, None, :], tmin, t_best)
                   & alive0 & ~done)
        packet_hit = can & ray_hit.any(1)
        ch = node_child[node]
        is_leaf = ch[:, 0] < 0
        # buffer the leaf's cluster
        take_leaf = packet_hit & is_leaf
        slot = nbuf.clamp_max(LEAF_BUF - 1)
        buf[pk, slot] = torch.where(take_leaf, -ch[:, 0] - 1, buf[pk, slot])
        nbuf = torch.where(take_leaf, nbuf + 1, nbuf)
        # push the children, near one last (popped first)
        swap = neg_major.gather(1, node_axis[node][:, None])[:, 0]
        near = torch.where(swap, ch[:, 1], ch[:, 0])
        far = torch.where(swap, ch[:, 0], ch[:, 1])
        do_push = packet_hit & ~is_leaf
        s1 = spm1.clamp_max(depth - 1)
        stack[pk, s1] = torch.where(do_push, far, stack[pk, s1])
        sp2 = torch.where(do_push, spm1 + 1, spm1)
        s2 = sp2.clamp_max(depth - 1)
        stack[pk, s2] = torch.where(do_push, near, stack[pk, s2])
        return torch.where(do_push, sp2 + 1, sp2), nbuf

    def flush(a, b):
        """Dense test of packets [a, b)'s buffered clusters; updates the
        packets' rows of t_best, prim, b1, b2 (and done) in place."""
        n = b - a
        bb = buf[a:b]
        lk = LEAF_BUF * k
        tri = lambda tab: tab[bb].reshape(n, 1, lk, 3)
        cv0, ce1, ce2 = tri(bvh.tri_v0), tri(bvh.tri_e1), tri(bvh.tri_e2)
        if has_motion:
            # continuous motion: lerp vertices to each ray's shutter time
            tt = time[a:b, :, None, None]
            cv0 = cv0 + tt * tri(bvh.tri_dv0)
            ce1 = ce1 + tt * tri(bvh.tri_de1)
            ce2 = ce2 + tt * tri(bvh.tri_de2)
        ctid = bvh.tri_id[bb].reshape(n, lk)
        slot_ok = (torch.arange(LEAF_BUF, device=dev)[None, :]
                   < nbuf[a:b, None]).repeat_interleave(k, 1)
        tb = t_best[a:b]
        ok, t, u, v = mt_test_plain(o[a:b, :, None, :], d[a:b, :, None, :],
                                    cv0, ce1, ce2, tmin[a:b, :, None],
                                    tb[:, :, None])
        ok = (ok & (ctid[:, None, :] >= 0) & slot_ok[:, None, :]
              & (alive0[a:b] & ~done[a:b])[:, :, None])
        t_m = torch.where(ok, t, float("inf"))
        jbest = t_m.argmin(-1, keepdim=True)        # ties: the lower slot
        tbj = t_m.gather(-1, jbest)[..., 0]
        better = tbj < tb
        take = lambda x: x.gather(-1, jbest)[..., 0]
        t_best[a:b] = torch.where(better, tbj, tb)
        prim[a:b] = torch.where(better, ctid.gather(1, jbest[..., 0]),
                                prim[a:b])
        b1[a:b] = torch.where(better, take(u), b1[a:b])
        b2[a:b] = torch.where(better, take(v), b2[a:b])
        if any_hit:
            done[a:b] |= prim[a:b] >= 0

    while bool(((sp > 0) | (nbuf > 0)).any()):
        while bool(((sp > 0) & (nbuf < LEAF_BUF)).any()):
            sp, nbuf = inner_step(stack, sp, nbuf)
            STEPS["steps"] += 1
        for a in range(0, np_, FLUSH_PACKETS):
            flush(a, min(a + FLUSH_PACKETS, np_))
        STEPS["flushes"] += 1
        nbuf = torch.zeros_like(nbuf)
        if any_hit:
            sp = torch.where((done | ~alive0).all(1), 0, sp)
    prim_flat = prim.reshape(-1)[:r]
    t_out = torch.where(prim_flat >= 0, t_best.reshape(-1)[:r],
                        float("inf"))
    return Hits(t=t_out, prim=prim_flat, b1=b1.reshape(-1)[:r],
                b2=b2.reshape(-1)[:r])


def intersect(bvh: ClusterBVH, rays: vm.Rays) -> Hits:
    """Closest hit by the packet walk over `bvh` (host numpy, moved to the
    rays' device at each call, or ``to_device``'s tensors)."""
    return _traverse(bvh, rays, any_hit=False)


def intersect_p(bvh: ClusterBVH, rays: vm.Rays):
    """Any-hit / occlusion by the packet walk: (R,) bool mask."""
    h = _traverse(bvh, rays, any_hit=True)
    return h.prim >= 0
