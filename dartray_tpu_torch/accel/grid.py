"""Uniform-grid accelerator (counterpart of the JAX reference's
``accel/grid.py``): the pbrt resolution rule (3 * cbrt(N) voxels along the
longest axis, at most 64), every triangle binned into each voxel its bounds
overlap, and a 3-D DDA walk with the "hit before the next crossing" exit.

``build`` is the reference's host numpy build, array for array. The walk is
plain torch: every lane steps its own voxel chain, one DDA step a loop
iteration, and a step tests every (lane, triangle) pair of the live lanes'
voxels at once (``accel.traverse.first_closest``), so the host issues a
fixed number of operations a step whatever a voxel holds. The loop reads one
number pair from the device a step (live lanes, pairs): the reference's
``while_loop`` condition.

It is an alternate: the default accelerator is the cluster BVH and its
kernel. A scene asks for it with ``Accelerator "grid"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import math as vm
from .traverse import Hits, first_closest, inv_dir

MAX_STEPS = 3 * 64 + 8      # a DDA crosses at most nx + ny + nz voxels

# walk counters: queries walked and DDA steps taken (loop iterations)
STEPS = {"queries": 0, "steps": 0}


@dataclasses.dataclass
class Grid:
    lo: np.ndarray           # (3,)
    hi: np.ndarray           # (3,)
    width: np.ndarray        # (3,) voxel widths
    inv_width: np.ndarray    # (3,)
    cell_start: np.ndarray   # (nx*ny*nz,) CSR offsets into tri_ids
    cell_count: np.ndarray   # (nx*ny*nz,)
    tri_ids: np.ndarray      # (sum counts,) int32
    v0: np.ndarray           # (F, 3) Moeller-Trumbore triangle soup
    e1: np.ndarray
    e2: np.ndarray
    nv: tuple                # (nx, ny, nz)
    max_cell: int            # most triangles in one voxel


def build(v0, e1, e2) -> Grid:
    """Host (numpy) grid build."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    f = v0.shape[0]
    plo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    phi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    lo = plo.min(axis=0) - 1e-4
    hi = phi.max(axis=0) + 1e-4
    delta = hi - lo
    inv_max_w = 1.0 / max(delta.max(), 1e-9)
    voxels_per_unit = 3.0 * f ** (1.0 / 3.0) * inv_max_w
    nv = np.clip(np.round(delta * voxels_per_unit).astype(np.int64), 1, 64)
    nx, ny, nz = (int(x) for x in nv)
    width = delta / nv
    inv_w = np.where(width > 0, 1.0 / np.maximum(width, 1e-30), 0.0)

    def pos_to_voxel(p, axis, n):
        return np.clip(((p - lo[axis]) * inv_w[axis]).astype(np.int64),
                       0, n - 1)

    vminx = pos_to_voxel(plo[:, 0], 0, nx)
    vmaxx = pos_to_voxel(phi[:, 0], 0, nx)
    vminy = pos_to_voxel(plo[:, 1], 1, ny)
    vmaxy = pos_to_voxel(phi[:, 1], 1, ny)
    vminz = pos_to_voxel(plo[:, 2], 2, nz)
    vmaxz = pos_to_voxel(phi[:, 2], 2, nz)
    cells: list = [[] for _ in range(nx * ny * nz)]
    for i in range(f):
        for z in range(vminz[i], vmaxz[i] + 1):
            for y in range(vminy[i], vmaxy[i] + 1):
                for x in range(vminx[i], vmaxx[i] + 1):
                    cells[(z * ny + y) * nx + x].append(i)
    counts = np.asarray([len(c) for c in cells], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.int32)
    tri_ids = (np.concatenate([np.asarray(c, np.int32) for c in cells])
               if counts.sum() else np.zeros(1, np.int32))
    return Grid(lo=lo.astype(np.float32), hi=hi.astype(np.float32),
                width=width.astype(np.float32),
                inv_width=inv_w.astype(np.float32),
                cell_start=starts, cell_count=counts, tri_ids=tri_ids,
                v0=v0, e1=e1, e2=e2, nv=(nx, ny, nz),
                max_cell=int(counts.max()) if f else 0)


@torch.no_grad()
def _traverse(g: Grid, rays: vm.Rays, any_hit: bool) -> Hits:
    """The 3-D DDA over a grid whose arrays are tensors on the rays'
    device. A lane is done when its best hit lies before the next crossing
    (any-hit: when it has one), when it leaves the grid or passes tmax;
    the loop ends when no lane is live, or after MAX_STEPS steps."""
    o = vm.to_arr(rays.o)
    d = vm.to_arr(rays.d)
    r, dev = o.shape[0], o.device
    nx, ny, nz = g.nv
    inv_d = inv_dir(d)
    # ray/bounds overlap; the walk starts at the entry point
    t0s = (g.lo - o) * inv_d
    t1s = (g.hi - o) * inv_d
    tn = torch.maximum(torch.minimum(t0s, t1s).amax(-1), rays.tmin)
    tf = torch.minimum(torch.maximum(t0s, t1s).amin(-1), rays.tmax)
    inside = tn <= tf
    ray_t = torch.where(rays.tmin > tn, rays.tmin, tn.clamp_min(0.0))
    p_ent = o + d * ray_t[:, None]
    n_hi = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32,
                        device=dev)
    pos = torch.minimum(
        ((p_ent - g.lo) * g.inv_width).to(torch.int32).clamp_min(0), n_hi)
    pos_dir = d >= 0
    step = torch.where(pos_dir, 1, -1).to(torch.int32)
    out = torch.where(pos_dir, n_hi + 1, -1).to(torch.int32)
    nxt = torch.where(
        pos_dir,
        ray_t[:, None] + ((pos + 1) * g.width + g.lo - p_ent) * inv_d,
        ray_t[:, None] + (pos * g.width + g.lo - p_ent) * inv_d)
    delta_t = torch.abs(g.width * inv_d)
    alive0 = inside & (rays.tmax >= rays.tmin)
    axes = torch.arange(3, device=dev)

    t_best = torch.where(alive0, rays.tmax, float("-inf"))
    prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    b1 = torch.zeros(r, device=dev)
    b2 = torch.zeros(r, device=dev)
    done = ~alive0
    STEPS["queries"] += 1
    for _ in range(MAX_STEPS):
        live = ~done
        cid = ((pos[:, 2] * ny + pos[:, 1]) * nx + pos[:, 0]).long()
        cnt = torch.where(live, g.cell_count[cid], 0)
        n_live, total = torch.stack([live.sum(), cnt.sum()]).tolist()
        if n_live == 0:
            break
        STEPS["steps"] += 1
        if total:
            better, t_new, p_new, u_new, v_new = first_closest(
                o, d, rays.tmin, t_best, g.v0, g.e1, g.e2, g.tri_ids,
                g.cell_start[cid], cnt, total)
            t_best = torch.where(better, t_new, t_best)
            prim = torch.where(better, p_new, prim)
            b1 = torch.where(better, u_new, b1)
            b2 = torch.where(better, v_new, b2)
        # step to the next voxel; a hit before the next crossing ends the
        # lane
        step_axis = torch.argmin(nxt, dim=-1)
        crossing = torch.gather(nxt, 1, step_axis[:, None])[:, 0]
        hit_now = prim >= 0
        if not any_hit:
            hit_now = hit_now & (t_best < crossing)
        on_axis = axes == step_axis[:, None]
        new_pos = pos + step * on_axis
        escaped = (new_pos == out).any(-1) | (crossing > rays.tmax)
        done = done | hit_now | escaped
        nxt = nxt + delta_t * on_axis
        pos = torch.where(done[:, None], pos, new_pos)
    t_out = torch.where(prim >= 0, t_best, float("inf"))
    return Hits(t=t_out, prim=prim, b1=b1, b2=b2)


def intersect(g: Grid, rays: vm.Rays) -> Hits:
    return _traverse(g, rays, any_hit=False)


def intersect_p(g: Grid, rays: vm.Rays):
    return _traverse(g, rays, any_hit=True).prim >= 0
