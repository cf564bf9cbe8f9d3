"""Hit records and the exhaustive intersector (counterpart of the JAX
reference's ``accel/traverse.py``).

``brute_force_intersect`` tests every ray against every triangle. It shares
no code with the BVH traversal and is the independent oracle of the traversal
tests. The reference's stackless binary-BVH walk in the same module is one of
its CPU fall-backs and has no counterpart here.
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


def inv_dir(d):
    """1 / d with components below 1e-30 in magnitude taken as +-1e-30 (the
    slab tests' reciprocal direction)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-30,
                             torch.where(d < 0, -1e-30, 1e-30), d)


def _dot(a, b):
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)


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
    tv0, te1, te2 = v0[il], e1[il], e2[il]
    dl = d[lanes]
    pvec = _cross(dl, te2)
    det = _dot(te1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) < TRI_EPS, 1.0, det)
    tvec = o[lanes] - tv0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, te1)
    v = _dot(dl, qvec) * inv_det
    t = _dot(te2, qvec) * inv_det
    ok = ((torch.abs(det) >= TRI_EPS) & (u >= -BARY_EPS) & (v >= -BARY_EPS)
          & (u + v <= 1.0 + BARY_EPS) & (t > tmin[lanes])
          & (t < t_best[lanes]))
    inf = torch.full((r,), float("inf"), device=dev)
    t_min = inf.scatter_reduce(0, lanes, torch.where(ok, t, float("inf")),
                               "amin")
    win = ok & (t == t_min[lanes])
    none = torch.full((r,), total, dtype=torch.int64, device=dev)
    pick = none.scatter_reduce(0, lanes, torch.where(win, j, total), "amin")
    pk = pick.clamp_max(total - 1)
    return pick < total, t_min, idx[pk].to(torch.int32), u[pk], v[pk]
