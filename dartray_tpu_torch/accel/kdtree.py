"""SAH kd-tree accelerator (counterpart of the JAX reference's
``accel/kdtree.py``): SAH build over edge events (intersection cost 80,
traversal cost 1, empty bonus 0.5, one triangle a leaf, depth
8 + 1.3 log2 N, the bad-refine cutoff) and the near/far to-do-stack walk.

``build`` is the reference's host numpy build, node for node. The walk is
plain torch: every lane walks its own stack (``STACK`` entries, the push
clamped to the last), one node a loop iteration, and the lanes at a leaf test
every (lane, triangle) pair of their leaves at once
(``accel.traverse.first_closest``), so the host issues a fixed number of
operations a step whatever a leaf holds. The loop reads one number pair from
the device a step (live lanes, pairs): the reference's ``while_loop``
condition.

It is an alternate: the default accelerator is the cluster BVH and its
kernel. A scene asks for it with ``Accelerator "kdtree"``.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..core import math as vm
from .traverse import Hits, first_closest, inv_dir

ISECT_COST = 80.0
TRAV_COST = 1.0
EMPTY_BONUS = 0.5
MAX_PRIMS = 1
STACK = 64

# walk counters: queries walked and nodes visited (loop iterations)
STEPS = {"queries": 0, "steps": 0}


@dataclasses.dataclass
class KdTree:
    split_pos: np.ndarray    # (N,) f32
    meta: np.ndarray         # (N, 4) i32 [axis | 3 = leaf, above child |
                             #             count, prim start, 0]
    prim_ids: np.ndarray     # flat leaf triangle lists
    lo: np.ndarray           # (3,)
    hi: np.ndarray
    v0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    n_nodes: int
    max_leaf: int


def build(v0, e1, e2) -> KdTree:
    """Host SAH build (the recursive buildTree), node for node the
    reference's."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    f = v0.shape[0]
    plo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2).astype(np.float64)
    phi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2).astype(np.float64)
    lo = plo.min(axis=0) - 1e-4
    hi = phi.max(axis=0) + 1e-4
    max_depth = int(np.round(8 + 1.3 * np.log2(max(f, 2))))

    split_pos: list = []
    meta: list = []
    prim_ids: list = []
    max_leaf = 0

    def make_leaf(idx):
        nonlocal max_leaf
        split_pos.append(0.0)
        meta.append([3, len(idx), len(prim_ids), 0])
        prim_ids.extend(int(i) for i in idx)
        max_leaf = max(max_leaf, len(idx))
        return len(meta) - 1

    def sa(d):
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def build_node(idx, nlo, nhi, depth, bad_refines):
        if len(idx) <= MAX_PRIMS or depth == 0:
            return make_leaf(idx)
        d = nhi - nlo
        inv_total_sa = 1.0 / max(sa(d), 1e-30)
        best_axis, best_off, best_cost = -1, -1, np.inf
        old_cost = ISECT_COST * len(idx)
        axis = int(np.argmax(d))
        edges_cache = {}
        for retry in range(3):
            ax = (axis + retry) % 3
            # edge events: (pos, is_start) sorted; starts before ends at
            # equal pos per the reference's edge comparison
            starts = plo[idx, ax]
            ends = phi[idx, ax]
            pos = np.concatenate([starts, ends])
            kind = np.concatenate([np.zeros(len(idx)), np.ones(len(idx))])
            order = np.lexsort((kind, pos))
            pos_s = pos[order]
            kind_s = kind[order]
            edges_cache[ax] = (pos_s, kind_s)
            n_below = np.cumsum(kind_s == 0)          # after processing i
            n_above = len(idx) - np.cumsum(kind_s == 1)
            inside = (pos_s > nlo[ax]) & (pos_s < nhi[ax])
            o0, o1 = ax, (ax + 1) % 3
            o2 = (ax + 2) % 3
            below_sa = 2 * (d[o1] * d[o2]
                            + (pos_s - nlo[ax]) * (d[o1] + d[o2]))
            above_sa = 2 * (d[o1] * d[o2]
                            + (nhi[ax] - pos_s) * (d[o1] + d[o2]))
            pb = below_sa * inv_total_sa
            pa = above_sa * inv_total_sa
            nb = np.where(kind_s == 0, n_below - 1, n_below)
            na = n_above
            eb = np.where((nb == 0) | (na == 0), EMPTY_BONUS, 0.0)
            cost = (TRAV_COST + ISECT_COST * (1.0 - eb)
                    * (pb * nb + pa * na))
            cost = np.where(inside, cost, np.inf)
            if len(cost):
                off = int(np.argmin(cost))
                if cost[off] < best_cost:
                    best_cost = cost[off]
                    best_axis, best_off = ax, off
            if best_axis != -1:
                break
        if best_axis == -1:
            return make_leaf(idx)
        if best_cost > old_cost:
            bad_refines += 1
        if ((best_cost > 4 * old_cost and len(idx) < 16)
                or bad_refines == 3):
            return make_leaf(idx)
        pos_s, kind_s = edges_cache[best_axis]
        split = float(pos_s[best_off])
        below = idx[(plo[idx, best_axis] < split)
                    | ((plo[idx, best_axis] == split)
                       & (phi[idx, best_axis] <= split))]
        above = idx[phi[idx, best_axis] > split]
        me = len(meta)
        split_pos.append(split)
        meta.append([best_axis, -1, 0, 0])
        lo_b = nlo.copy()
        hi_b = nhi.copy()
        hi_b[best_axis] = split
        build_node(below, lo_b, hi_b, depth - 1, bad_refines)
        lo_a = nlo.copy()
        lo_a[best_axis] = split
        above_child = build_node(above, lo_a, nhi, depth - 1, bad_refines)
        meta[me][1] = above_child
        return me

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(200000)
    try:
        build_node(np.arange(f), lo.copy(), hi.copy(), max_depth, 0)
    finally:
        sys.setrecursionlimit(old_limit)
    return KdTree(
        split_pos=np.asarray(split_pos, np.float32),
        meta=np.asarray(meta, np.int32),
        prim_ids=(np.asarray(prim_ids, np.int32) if prim_ids
                  else np.zeros(1, np.int32)),
        lo=lo.astype(np.float32), hi=hi.astype(np.float32),
        v0=v0, e1=e1, e2=e2, n_nodes=len(meta), max_leaf=max_leaf)


@torch.no_grad()
def _traverse(kd: KdTree, rays: vm.Rays, any_hit: bool) -> Hits:
    """The near/far stack walk over a tree whose arrays are tensors on the
    rays' device. A lane at a leaf tests its triangles, then stops when its
    best hit lies within the node's [t0, t1] (any-hit: when it has one) or
    pops its stack; the loop ends when no lane is live, or after
    n_nodes + 1 steps (each node is entered at most once a ray)."""
    o = vm.to_arr(rays.o)
    d = vm.to_arr(rays.d)
    r, dev = o.shape[0], o.device
    inv_d = inv_dir(d)
    t0s = (kd.lo - o) * inv_d
    t1s = (kd.hi - o) * inv_d
    tn = torch.maximum(torch.minimum(t0s, t1s).amax(-1), rays.tmin)
    tf = torch.minimum(torch.maximum(t0s, t1s).amin(-1), rays.tmax)
    alive0 = (tn <= tf) & (rays.tmax >= rays.tmin)

    sn = torch.zeros((r, STACK), dtype=torch.int32, device=dev)
    st0 = torch.zeros((r, STACK), device=dev)
    st1 = torch.zeros((r, STACK), device=dev)
    ri = torch.arange(r, device=dev)
    node = torch.zeros(r, dtype=torch.int32, device=dev)
    t0, t1 = tn, tf
    sp = torch.zeros(r, dtype=torch.int32, device=dev)
    t_best = torch.where(alive0, rays.tmax, float("-inf"))
    prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    b1 = torch.zeros(r, device=dev)
    b2 = torch.zeros(r, device=dev)
    done = ~alive0
    STEPS["queries"] += 1
    for _ in range(kd.n_nodes + 1):
        active = ~done
        meta = kd.meta[node.long()]
        is_leaf = meta[:, 0] == 3
        at_leaf = active & is_leaf
        cnt = torch.where(at_leaf, meta[:, 1], 0)
        n_live, total = torch.stack([active.sum(), cnt.sum()]).tolist()
        if n_live == 0:
            break
        STEPS["steps"] += 1
        # interior: descend near / far
        ax = meta[:, 0].clamp_max(2).long()[:, None]
        o_ax = torch.gather(o, 1, ax)[:, 0]
        id_ax = torch.gather(inv_d, 1, ax)[:, 0]
        split = kd.split_pos[node.long()]
        tplane = (split - o_ax) * id_ax
        below_first = ((o_ax < split)
                       | ((o_ax == split)
                          & (d[:, 0] * 0 + torch.gather(d, 1, ax)[:, 0]
                             <= 0)))
        first = torch.where(below_first, node + 1, meta[:, 1])
        second = torch.where(below_first, meta[:, 1], node + 1)
        only_first = (tplane > t1) | (tplane <= 0)
        # the reference's if / elif: only_first has priority when both hold
        only_second = (tplane < t0) & ~only_first
        # push the second child when both sides are visited
        push = active & ~is_leaf & ~only_first & ~only_second
        spc = sp.clamp_max(STACK - 1).long()
        sn[ri, spc] = torch.where(push, second, sn[ri, spc])
        st0[ri, spc] = torch.where(push, tplane, st0[ri, spc])
        st1[ri, spc] = torch.where(push, t1, st1[ri, spc])
        sp = sp + push.to(torch.int32)
        node_i = torch.where(only_second, second, first)
        t1_i = torch.where(push, tplane, t1)
        # leaf: test its triangles, then stop or pop
        if total:
            better, t_new, p_new, u_new, v_new = first_closest(
                o, d, rays.tmin, t_best, kd.v0, kd.e1, kd.e2, kd.prim_ids,
                meta[:, 2], cnt, total)
            t_best = torch.where(better, t_new, t_best)
            prim = torch.where(better, p_new, prim)
            b1 = torch.where(better, u_new, b1)
            b2 = torch.where(better, v_new, b2)
        stop = prim >= 0
        if not any_hit:
            stop = stop & (t_best <= t1)
        do_pop = at_leaf & ~stop
        can_pop = sp > 0
        spp = (sp - 1).clamp_min(0).long()
        pop = do_pop & can_pop
        down = active & ~is_leaf
        done = done | (at_leaf & (stop | ~can_pop))
        node = torch.where(down, node_i, torch.where(pop, sn[ri, spp], node))
        t0 = torch.where(pop, st0[ri, spp], t0)
        t1 = torch.where(down, t1_i, torch.where(pop, st1[ri, spp], t1))
        sp = torch.where(pop, spp.to(torch.int32), sp)
    t_out = torch.where(prim >= 0, t_best, float("inf"))
    return Hits(t=t_out, prim=prim, b1=b1, b2=b2)


def intersect(kd: KdTree, rays: vm.Rays) -> Hits:
    return _traverse(kd, rays, any_hit=False)


def intersect_p(kd: KdTree, rays: vm.Rays):
    return _traverse(kd, rays, any_hit=True).prim >= 0
