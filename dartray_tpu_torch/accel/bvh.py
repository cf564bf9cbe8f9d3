"""Per-triangle SAH BVH, threaded for a stackless walk, and the triangle
helpers of the host scene compiler (counterpart of the JAX reference's
``accel/bvh.py``, numpy only).

``build`` makes a binary SAH tree (12 buckets) with ONE triangle a leaf and
threads it: for each of the 8 ray-direction octants every node gets a
``hit_link`` / ``miss_link`` continuation, so a walk's state is one int32
node index a ray and near-child-first order is kept per octant.
``accel/traverse.py::intersect`` walks it. The Moeller-Trumbore data of a
leaf's triangle (v0, e1, e2) sits inside its 16-float row, so every step of
the walk is one row gather and one link gather.

Node row layout (float32[16]):
  interior: [lo.x lo.y lo.z hi.x hi.y hi.z  0 0 0  0 0 0  0 0 0  0.0]
  leaf:     [v0.x v0.y v0.z e1.x e1.y e1.z e2.x e2.y e2.z 0 0 0 0 0 bits 1.0]
where ``bits`` is the int32 prim id's bit pattern stored as a float32 (a
denormal: move it, never compute with it). Links: int32[8, N, 2] = (hit,
miss) per octant; -1 ends the walk.

The default renderer does not use this tree: it walks the cluster BVH
(``accel/cluster.py``) with the v6 kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np

N_BUCKETS = 12  # SAH buckets
ROW = 16


@dataclasses.dataclass
class BVH:
    rows: np.ndarray        # (N, 16) f32 node rows
    links: np.ndarray       # (8, N, 2) i32 hit/miss links per octant
    n_nodes: int
    max_depth: int
    prim_index: np.ndarray  # (N,) i32: triangle id per leaf row (-1 interior)
    world_bound: np.ndarray  # (2, 3)


def build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
          split_method: str = "sah") -> BVH:
    """Build from Moeller-Trumbore triangle soup (F, 3) arrays.

    split_method in {"sah", "middle", "equal"}. Iterative (explicit work
    stack), so no recursion limit applies."""
    f = v0.shape[0]
    v0 = v0.astype(np.float64)
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2).astype(np.float64)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2).astype(np.float64)
    centroids = 0.5 * (lo + hi)

    max_nodes = max(2 * f - 1, 1)
    nb_lo = np.zeros((max_nodes, 3))
    nb_hi = np.zeros((max_nodes, 3))
    left = np.full(max_nodes, -1, np.int32)
    right = np.full(max_nodes, -1, np.int32)
    axis = np.zeros(max_nodes, np.int8)
    leaf_prim = np.full(max_nodes, -1, np.int64)
    depth_arr = np.zeros(max_nodes, np.int32)

    order = np.arange(f)
    # work items: (node_id, start, end, depth) over `order` slices
    stack = [(0, 0, f, 0)]
    n_nodes = 1
    while stack:
        node, s, e, d = stack.pop()
        depth_arr[node] = d
        idx = order[s:e]
        nb_lo[node] = lo[idx].min(axis=0)
        nb_hi[node] = hi[idx].max(axis=0)
        if e - s == 1:
            leaf_prim[node] = idx[0]
            continue
        c = centroids[idx]
        ext = c.max(axis=0) - c.min(axis=0)
        dim = int(np.argmax(ext))
        axis[node] = dim
        if ext[dim] < 1e-12:
            mid = (s + e) // 2
        elif split_method == "middle":
            pivot = 0.5 * (c[:, dim].min() + c[:, dim].max())
            mask = c[:, dim] < pivot
            mid = s + int(mask.sum())
            order[s:e] = np.concatenate([idx[mask], idx[~mask]])
            if mid == s or mid == e:
                mid = (s + e) // 2
                order[s:e] = idx[np.argsort(c[:, dim], kind="stable")]
        elif split_method == "equal" or (e - s) <= 4:
            order[s:e] = idx[np.argsort(c[:, dim], kind="stable")]
            mid = (s + e) // 2
        else:  # binned SAH
            cmin = c[:, dim].min()
            cmax = c[:, dim].max()
            b = np.minimum(((c[:, dim] - cmin) / (cmax - cmin) * N_BUCKETS)
                           .astype(np.int64), N_BUCKETS - 1)
            counts = np.bincount(b, minlength=N_BUCKETS)
            blo = np.full((N_BUCKETS, 3), np.inf)
            bhi = np.full((N_BUCKETS, 3), -np.inf)
            np.minimum.at(blo, b, lo[idx])
            np.maximum.at(bhi, b, hi[idx])

            def sa(l, h):
                dxyz = np.maximum(h - l, 0.0)
                return 2.0 * (dxyz[:, 0] * dxyz[:, 1] + dxyz[:, 1] * dxyz[:, 2]
                              + dxyz[:, 2] * dxyz[:, 0])
            plo = np.minimum.accumulate(blo, axis=0)
            phi = np.maximum.accumulate(bhi, axis=0)
            slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            cl = np.cumsum(counts)
            cr = (counts.sum() - cl)
            cost = (sa(plo, phi)[:-1] * cl[:-1]
                    + sa(slo, shi)[1:] * cr[:-1])
            valid = (cl[:-1] > 0) & (cr[:-1] > 0)
            cost = np.where(valid, cost, np.inf)
            split_b = int(np.argmin(cost))
            mask = b <= split_b
            if not valid.any():
                order[s:e] = idx[np.argsort(c[:, dim], kind="stable")]
                mid = (s + e) // 2
            else:
                mid = s + int(mask.sum())
                order[s:e] = np.concatenate([idx[mask], idx[~mask]])
        l_id = n_nodes
        r_id = n_nodes + 1
        n_nodes += 2
        left[node] = l_id
        right[node] = r_id
        stack.append((l_id, s, mid, d + 1))
        stack.append((r_id, mid, e, d + 1))

    n = n_nodes
    nb_lo, nb_hi = nb_lo[:n], nb_hi[:n]
    left, right, axis = left[:n], right[:n], axis[:n]
    leaf_prim, depth_arr = leaf_prim[:n], depth_arr[:n]
    max_depth = int(depth_arr.max()) if n > 0 else 0

    links = _thread_links(left, right, axis, depth_arr, max_depth)

    rows = np.zeros((n, ROW), np.float32)
    is_leaf = leaf_prim >= 0
    interior = ~is_leaf
    rows[interior, 0:3] = nb_lo[interior]
    rows[interior, 3:6] = nb_hi[interior]
    lp = leaf_prim[is_leaf]
    rows[is_leaf, 0:3] = v0[lp]
    rows[is_leaf, 3:6] = e1[lp]
    rows[is_leaf, 6:9] = e2[lp]
    rows[is_leaf, 14] = np.asarray(lp, np.int32).view(np.float32)
    rows[is_leaf, 15] = 1.0
    return BVH(rows=rows, links=links, n_nodes=n, max_depth=max_depth,
               prim_index=np.where(is_leaf, leaf_prim, -1).astype(np.int32),
               world_bound=np.stack([nb_lo[0], nb_hi[0]]).astype(np.float32))


def _thread_links(left, right, axis, depth, max_depth):
    """Per-level continuation threading, vectorised over the nodes of a
    level.

    For octant o (bit k set = ray.d[k] negative) the near child of a node
    split on `axis` is `right` when the octant's bit for that axis is set.
    Then:
      cont[root] = -1
      cont[near] = far;  cont[far] = cont[parent]
      hit_link  = near (interior) | cont (leaf);  miss_link = cont.
    """
    n = left.shape[0]
    interior = left >= 0
    links = np.empty((8, n, 2), np.int32)
    for o in range(8):
        neg = np.array([(o >> k) & 1 for k in range(3)], bool)
        swap = neg[axis] & interior
        near = np.where(swap, right, left)
        far = np.where(swap, left, right)
        cont = np.full(n, -1, np.int32)
        for d in range(max_depth + 1):
            at = interior & (depth == d)
            if not at.any():
                continue
            cont[near[at]] = far[at]
            cont[far[at]] = cont[at]
        hit = np.where(interior, near, cont).astype(np.int32)
        links[o, :, 0] = hit
        links[o, :, 1] = cont
    return links


def triangles_to_mt(verts: np.ndarray, faces: np.ndarray):
    """(V,3),(F,3) -> Moeller-Trumbore (v0, e1, e2) each (F,3) f32."""
    v = verts.astype(np.float32)
    p0 = v[faces[:, 0]]
    p1 = v[faces[:, 1]]
    p2 = v[faces[:, 2]]
    return p0, (p1 - p0), (p2 - p0)
