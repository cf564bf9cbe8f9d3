"""Wide (8-ary) BVH: host-side collapse of the binary cluster BVH
(counterpart of the JAX reference's ``accel/wide.py``; same tables, bit for
bit).

Why: one pop of a wide node slab-tests 8 children, so a ray takes about a
third of the dependent node fetches a binary walk needs for the same number
of box tests. Traversal order is kept by per-octant precomputed child push
orders (far first, so a LIFO stack pops near first).

Layout (device arrays, built pure-numpy on host):
  wbounds: (W*6, 8) f32 — row (w*6 + c) holds component c of the 8 child
           boxes of wide node w, c in [lox loy loz hix hiy hiz]. Empty
           child slots are NaN: every slab comparison with NaN is false, so
           pads can never hit (no count masking needed in the vector path).
  worder:  (8*W, 8) i32 — row (octant*W + w) holds the 8 child entries of
           node w sorted FAR-FIRST for that ray-direction octant (push
           order for a LIFO stack -> near-first pops). Entry encoding:
           e = ref*8 + slot, where slot indexes the fixed wbounds slot (for
           the hit-mask lookup) and ref = wide child id (interior) or
           -(cluster+1) (leaf); decode ref = e >> 3 (arithmetic), slot =
           e & 7. Pad entries keep ref 0 and their own (NaN-box) slot, so
           the hit mask gates them off.
"""
from __future__ import annotations

import numpy as np

BRANCH = 8


def build_wide(node_lo, node_hi, node_child):
    """Collapse a binary cluster BVH to 8-ary. Returns (wbounds, worder, W).

    node_child: (N, 2) i32, leaf iff child[:,0] < 0 with cluster id
    -(child0+1). Collapse policy: start from a node's two children and
    repeatedly replace the largest-surface-area interior slot by its two
    children until 8 slots or all leaves (greedy SAH-area expansion).
    """
    lo = np.asarray(node_lo, np.float64)
    hi = np.asarray(node_hi, np.float64)
    child = np.asarray(node_child, np.int64)
    d = np.maximum(hi - lo, 0.0)
    area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    is_leaf = child[:, 0] < 0

    def expand(bin_id):
        slots = [int(child[bin_id, 0]), int(child[bin_id, 1])]
        while len(slots) < BRANCH:
            best_j, best_a = -1, -1.0
            for j, sid in enumerate(slots):
                if not is_leaf[sid] and area[sid] > best_a:
                    best_j, best_a = j, area[sid]
            if best_j < 0:
                break
            sid = slots.pop(best_j)
            slots.append(int(child[sid, 0]))
            slots.append(int(child[sid, 1]))
        return slots

    # BFS: wide node i holds binary-node ids in wslots[i]
    wslots = [[0] if is_leaf[0] else expand(0)]
    widx = {}
    i = 0
    while i < len(wslots):
        for sid in wslots[i]:
            if not is_leaf[sid]:
                widx[sid] = len(wslots)
                wslots.append(expand(sid))
        i += 1
    w = len(wslots)

    wbounds = np.full((w, 6, 8), np.nan, np.float32)
    refs = np.zeros((w, 8), np.int32)     # wide id or -(cluster+1)
    cnts = np.zeros(w, np.int32)
    centers = np.zeros((w, 8, 3), np.float64)
    for wi, slots in enumerate(wslots):
        cnts[wi] = len(slots)
        for s, sid in enumerate(slots):
            wbounds[wi, 0:3, s] = lo[sid]
            wbounds[wi, 3:6, s] = hi[sid]
            centers[wi, s] = 0.5 * (lo[sid] + hi[sid])
            refs[wi, s] = child[sid, 0] if is_leaf[sid] else widx[sid]

    # per-octant far-first push orders
    slot_iota = np.arange(8, dtype=np.int32)[None, :]
    pad = slot_iota >= cnts[:, None]                       # (W, 8)
    worder = np.zeros((8, w, 8), np.int32)
    base_entry = refs * 8 + slot_iota                      # (W, 8)
    base_entry = np.where(pad, slot_iota, base_entry)      # pads: ref 0
    for q in range(8):
        sx = -1.0 if q & 1 else 1.0
        sy = -1.0 if q & 2 else 1.0
        sz = -1.0 if q & 4 else 1.0
        key = (sx * centers[:, :, 0] + sy * centers[:, :, 1]
               + sz * centers[:, :, 2])
        key = np.where(pad, -np.inf, key)                  # pads last
        order = np.argsort(-key, axis=1, kind="stable")    # far first
        worder[q] = np.take_along_axis(base_entry, order, axis=1)

    # octant-major worder rows (row q*W + w, column s): one 32-byte row per
    # (octant, node) pair
    return (np.ascontiguousarray(wbounds.reshape(w, 48)),
            np.ascontiguousarray(worder.reshape(8 * w, 8).astype(np.int32)),
            w)
