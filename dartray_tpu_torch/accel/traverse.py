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
