"""Hit records, the stackless walk of the per-triangle BVH and the
exhaustive intersector (counterpart of the JAX reference's
``accel/traverse.py``).

``intersect`` / ``intersect_p`` walk the threaded tree of ``accel/bvh.py``
in plain torch: a ray's state is one int32 node index, and every step of the
loop is one (R, 16) row gather and one (R, 2) link gather for ALL lanes, then
a slab test and a Moeller-Trumbore test on the same row, both against the
ray's best t so far, the row's leaf flag picking which one counts. The loop
reads "is any lane alive" from the device every ``ALIVE_EVERY`` steps only:
a finished lane stays at -1, so the steps in between change nothing, and the
loop still stops at exactly ``max_steps``. The default renderer does not use
this walk (it walks the cluster BVH with the v6 kernel).

``brute_force_intersect`` tests every ray against every triangle. It shares
no code with the BVH walks and is the independent oracle of their tests.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import math as vm

TRI_EPS = 1e-10
# Inclusive barycentric tolerance: rays passing exactly through shared edges
# must not fall through the crack between the two adjacent triangles when f32
# rounding puts u/v at -epsilon on both. Shared-edge double hits have the
# same t, so closest-hit semantics are unaffected.
BARY_EPS = 1e-6


class Hits(NamedTuple):
    """SoA hit records."""
    t: torch.Tensor        # (R,) hit distance (inf on miss)
    prim: torch.Tensor     # (R,) int32 triangle id, -1 on miss
    b1: torch.Tensor       # (R,) barycentric weight of v1
    b2: torch.Tensor       # (R,) barycentric weight of v2
    # (48, R) per-hit attr rows fetched by the traversal finish (the combined
    # finish+interaction gather, ops/traverse_cuda.finish_hits_rows); layout
    # of scene/types._pack_attr. None when the caller did not ask for them.
    rows: Optional[torch.Tensor] = None

    @property
    def hit(self):
        return self.prim >= 0


def _mt_test(o, d, v0, e1, e2, tmin, tmax):
    """Moeller-Trumbore on (..., 3) tensors; returns (hit, t, u, v)."""
    pvec = torch.linalg.cross(d, e2)
    det = (e1 * pvec).sum(-1)
    inv_det = 1.0 / torch.where(torch.abs(det) < TRI_EPS, 1.0, det)
    tvec = o - v0
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = (d * qvec).sum(-1) * inv_det
    t = (e2 * qvec).sum(-1) * inv_det
    hit = ((torch.abs(det) >= TRI_EPS) & (u >= -BARY_EPS) & (v >= -BARY_EPS)
           & (u + v <= 1.0 + BARY_EPS) & (t > tmin) & (t < tmax))
    return hit, t, u, v


@torch.no_grad()
def brute_force_intersect(v0, e1, e2, rays: vm.Rays,
                          chunk: int = 4096, deltas=None) -> Hits:
    """Exhaustive closest hit over (F, 3) triangle arrays, scanned in chunks
    of `chunk` triangles. The correctness oracle.

    deltas: optional (dv0, de1, de2) (F, 3) shutter-close-minus-open arrays
    of moving geometry: every ray then tests the triangles lerped to its own
    ``rays.time`` (already normalised to [0, 1])."""
    o = vm.to_arr(rays.o)
    d = vm.to_arr(rays.d)
    v0, e1, e2 = vm.to_arr(v0), vm.to_arr(e1), vm.to_arr(e2)
    if deltas is not None:
        deltas = [vm.to_arr(a) for a in deltas]
    f = v0.shape[0]
    r = o.shape[0]
    t_best = rays.tmax.clone()
    prim = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    b1 = torch.zeros(r, dtype=torch.float32, device=o.device)
    b2 = torch.zeros_like(b1)
    for s in range(0, max(f, 1), chunk):
        e = min(s + chunk, f)
        tri = [a[None, s:e] for a in (v0, e1, e2)]
        if deltas is not None:
            tl = rays.time[:, None, None]
            tri = [a + tl * da[None, s:e] for a, da in zip(tri, deltas)]
        hit, t, u, v = _mt_test(o[:, None, :], d[:, None, :], *tri,
                                rays.tmin[:, None], t_best[:, None])
        t_masked = torch.where(hit, t, float("inf"))
        tj, j = t_masked.min(dim=1)
        better = tj < t_best
        take = lambda a: torch.gather(a, 1, j[:, None])[:, 0]
        t_best = torch.where(better, tj, t_best)
        prim = torch.where(better, (j + s).to(torch.int32), prim)
        b1 = torch.where(better, take(u), b1)
        b2 = torch.where(better, take(v), b2)
    t_out = torch.where(prim >= 0, t_best, float("inf"))
    return Hits(t=t_out, prim=prim, b1=b1, b2=b2)


def mt_test_plain(o, d, v0, e1, e2, tmin, tmax):
    """``_mt_test`` on (..., 3) tensors with every product and sum taken
    in the order of the kernels' ``ray_tests.cuh`` and of the finish
    (``ops.traverse_cuda._exact_mt``): left-to-right dot products, none
    fused. Every walk of this package tests with it (``first_closest``,
    the stackless and the packet walk), so a walk finds the t the v6
    kernel's finish gives for the same triangle, bit for bit."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) < TRI_EPS, 1.0, det)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = ((torch.abs(det) >= TRI_EPS) & (u >= -BARY_EPS) & (v >= -BARY_EPS)
           & (u + v <= 1.0 + BARY_EPS) & (t > tmin) & (t < tmax))
    return hit, t, u, v


def ray_octants(d):
    """3 sign bits -> octant id in [0, 8): bit k set where d[k] < 0.
    d: V3 or (R, 3) tensor."""
    neg = (vm.to_arr(d) < 0.0).to(torch.int32)
    return neg[..., 0] + 2 * neg[..., 1] + 4 * neg[..., 2]


def _slab_test(o, inv_d, lo, hi, tmin, tmax):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tnear = torch.maximum(torch.minimum(t0, t1).amax(-1), tmin)
    tfar = torch.minimum(torch.maximum(t0, t1).amin(-1), tmax)
    return tnear <= tfar


# walk counters of the stackless walk: queries walked and loop steps taken
# (a step runs on every lane; steps past the last live lane up to the next
# check of ALIVE_EVERY are counted too)
STEPS = {"queries": 0, "steps": 0}
ALIVE_EVERY = 8


@torch.no_grad()
def _traverse(rows, links, rays: vm.Rays, any_hit: bool, max_steps: int):
    o = vm.to_arr(rays.o)
    d = vm.to_arr(rays.d)
    dev = o.device
    rows = torch.as_tensor(rows, device=dev)
    links = torch.as_tensor(links, device=dev)
    n_nodes = rows.shape[0]
    r = o.shape[0]
    inv_d = inv_dir(d)
    links_flat = links.reshape(-1, 2)
    link_base = ray_octants(d).long() * n_nodes
    tmin = rays.tmin
    cur = torch.zeros(r, dtype=torch.long, device=dev)
    t_best = rays.tmax.clone()
    prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    b1 = torch.zeros(r, dtype=torch.float32, device=dev)
    b2 = torch.zeros_like(b1)
    STEPS["queries"] += 1
    step = 0
    while step < max_steps:
        n = min(ALIVE_EVERY, max_steps - step)
        for _ in range(n):
            active = cur >= 0
            safe = cur.clamp_min(0)
            row = rows[safe]                              # (R, 16) gather
            is_leaf = row[:, 15] > 0.5
            hit_box = _slab_test(o, inv_d, row[:, 0:3], row[:, 3:6], tmin,
                                 t_best)
            tri_hit, t, u, v = mt_test_plain(o, d, row[:, 0:3],
                                             row[:, 3:6], row[:, 6:9], tmin,
                                             t_best)
            take = active & is_leaf & tri_hit
            leaf_prim = row[:, 14].view(torch.int32)      # bits, not a value
            t_best = torch.where(take, t, t_best)
            prim = torch.where(take, leaf_prim, prim)
            b1 = torch.where(take, u, b1)
            b2 = torch.where(take, v, b2)
            lk = links_flat[link_base + safe]             # (R, 2) gather
            descend = hit_box & ~is_leaf
            nxt = torch.where(descend, lk[:, 0], lk[:, 1]).long()
            if any_hit:
                nxt = torch.where(take, -1, nxt)
            cur = torch.where(active, nxt, -1)
        step += n
        STEPS["steps"] += n
        if not bool((cur >= 0).any()):
            break
    t_out = torch.where(prim >= 0, t_best, float("inf"))
    return Hits(t=t_out, prim=prim, b1=b1, b2=b2)


def intersect(rows, links, rays: vm.Rays, max_steps: int = 20000) -> Hits:
    """Closest hit by the stackless walk of an ``accel.bvh.BVH``'s `rows` /
    `links` (tensors on the rays' device, or numpy moved there at each
    call). A lane still walking after `max_steps` steps returns what it has
    found so far."""
    return _traverse(rows, links, rays, any_hit=False, max_steps=max_steps)


def intersect_p(rows, links, rays: vm.Rays, max_steps: int = 20000):
    """Any-hit / occlusion by the stackless walk: a lane stops at its first
    accepted hit. Returns the (R,) bool occlusion mask."""
    h = _traverse(rows, links, rays, any_hit=True, max_steps=max_steps)
    return h.prim >= 0


def inv_dir(d):
    """1 / d with components below 1e-30 in magnitude taken as +-1e-30 (the
    slab tests' reciprocal direction)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-30,
                             torch.where(d < 0, -1e-30, 1e-30), d)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            ) + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def first_closest(o, d, tmin, t_best, v0, e1, e2, ids, start, cnt, total):
    """Lane i tests the triangles ``ids[start[i] : start[i] + cnt[i]]``
    (cnt 0: none) against its ray, all (lane, triangle) pairs at once, and
    keeps what a sequential loop over its list with the strict update
    ``t < t_best`` keeps: the least accepted t, from the FIRST triangle in
    list order that reaches it (ties go to the earlier triangle).

    o, d: (R, 3); tmin, t_best: (R,); v0/e1/e2: (F, 3) soup; ids: flat
    triangle lists; start, cnt: (R,) int; total: the Python int
    ``cnt.sum()``, at least 1, which sizes the pair arrays (the caller reads
    it with its loop condition). The host issues a fixed number of
    operations whatever the lists' lengths. Returns (better (R,) bool, t,
    prim int32, u, v): the new best where `better`, garbage elsewhere."""
    r, dev = o.shape[0], o.device
    cnt = cnt.long()
    lanes = torch.repeat_interleave(torch.arange(r, device=dev), cnt,
                                    output_size=total)
    first = torch.cumsum(cnt, 0) - cnt
    j = torch.arange(total, device=dev)
    slot = start.long()[lanes] + (j - first[lanes])
    idx = ids[slot.clamp_max(ids.shape[0] - 1).long()]
    il = idx.long()
    ok, t, u, v = mt_test_plain(o[lanes], d[lanes], v0[il], e1[il], e2[il],
                                tmin[lanes], t_best[lanes])
    inf = torch.full((r,), float("inf"), device=dev)
    t_min = inf.scatter_reduce(0, lanes, torch.where(ok, t, float("inf")),
                               "amin")
    win = ok & (t == t_min[lanes])
    none = torch.full((r,), total, dtype=torch.int64, device=dev)
    pick = none.scatter_reduce(0, lanes, torch.where(win, j, total), "amin")
    pk = pick.clamp_max(total - 1)
    return pick < total, t_min, idx[pk].to(torch.int32), u[pk], v[pk]
