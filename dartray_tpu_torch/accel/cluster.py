"""Cluster BVH: host build (counterpart of the JAX reference's
``accel/cluster.py``, numpy only).

Triangles are grouped into fixed-size CLUSTERS (K triangles, SAH-built
leaves) and a binary BVH is built over the clusters. ``accel/wide.py``
collapses that tree to 8-ary and ``ops/traverse_cuda.py`` packs and walks it.
Only the build lives here: the reference's own packet traversal over this
tree (its CPU fallback) has no counterpart in the port, whose plain traversal
is ``ops.traverse_cuda.traverse6_plain``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

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

