"""The ``surfacepoints`` renderer: points spread over the scene's surfaces
with a minimum spacing (counterpart of the JAX reference's
``renderers/surface_points.py``), the preprocess of the
``dipolesubsurface`` integrator.

Each round casts ``rays_per_round`` rays from random points of the scene's
bounding sphere toward random points of its box (``numpy.random.
default_rng(seed)``; one closest-hit traversal a round on the device), and
keeps each hit, in ray order, that lies at least ``min_sample_dist`` from
every point kept before it (a host hash grid of that cell size). Each point
stands for a disk of radius ``min_sample_dist / 2``.

The host test runs only on the hits that are not plainly too close to a
point of an earlier round: a hit within ``0.9 * min_sample_dist`` of one
is rejected at once, as the test would reject it (the distances taken on
the device to the earlier points of the 27 hashed cells around the hit,
``photonmap.scan_pairs``). The points are those of the sequential test
over every hit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..core import math as vm
from ..integrators import photonmap as pm_mod
from ..scene import types as st


class SurfacePoints(NamedTuple):
    p: np.ndarray        # (P, 3)
    n: np.ndarray        # (P, 3) geometric normals
    area: np.ndarray     # (P,) the area each point stands for
    mat_id: np.ndarray   # (P,) int32
    ray_eps: np.ndarray  # (P,)


@torch.no_grad()
def render(scene, min_sample_dist: float = 0.25, max_points: int = 50_000,
           n_rounds: int = 32, rays_per_round: int = 8192, seed: int = 3,
           device=device_mod.DEFAULT) -> SurfacePoints:
    """The points of `scene` (moved to `device` once)."""
    scene = st.to_device(scene, device)
    geom = scene.geometry
    dev = geom.mat_id.device
    wb = geom.world_bound.cpu().numpy()
    center = 0.5 * (wb[0] + wb[1])
    radius = 0.5 * float(np.linalg.norm(wb[1] - wb[0])) + 1e-3
    rng = np.random.default_rng(seed)

    def cast(o, d):
        r = o.shape[0]
        rays = vm.Rays(o=vm.from_arr(o.to(dev)), d=vm.from_arr(d.to(dev)),
                       tmin=torch.full((r,), 1e-4, device=dev),
                       tmax=torch.full((r,), float("inf"), device=dev),
                       time=torch.zeros((r,), device=dev))
        hits = st.intersect(geom, rays)
        it = st.interaction(geom, rays, hits)
        return hits.hit, vm.to_arr(it["p"]), it, hits.t

    def plainly_close(p, prev):
        """(H,) bool: within 0.9 min_sample_dist of a row of `prev` in the
        27 hashed cells about it (a cell's first 64; a hit missed here goes
        to the exact test)."""
        out = torch.zeros(p.shape[0], dtype=torch.bool, device=dev)
        if prev.shape[0] == 0:
            return out
        pv = vm.from_arr(prev)
        hid = pm_mod.hash_cells(*(pm_mod.cell_coords(c, cell) for c in pv))
        order = torch.argsort(hid, stable=True)
        lim = (0.9 * min_sample_dist) ** 2
        for lane, idx in pm_mod.scan_pairs(hid[order], cell, vm.from_arr(p),
                                           64):
            d2 = ((p[lane] - prev[order[idx]]) ** 2).sum(-1)
            out[lane[d2 < lim]] = True
        return out

    cell = max(min_sample_dist, 1e-6)
    grid = {}
    pts, nrm, mids, eps_l = [], [], [], []

    def cell_of(p):
        return tuple(np.floor(p / cell).astype(np.int64))

    def far_enough(p):
        c = cell_of(p)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for q in grid.get((c[0] + dx, c[1] + dy, c[2] + dz), ()):
                        if np.dot(p - q, p - q) < min_sample_dist ** 2:
                            return False
        return True

    for _ in range(n_rounds):
        if len(pts) >= max_points:
            break
        u = rng.normal(size=(rays_per_round, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        o = center + radius * u
        tgt = center + rng.uniform(-0.5, 0.5, (rays_per_round, 3)) * (
            wb[1] - wb[0])
        d = tgt - o
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        hit, p_d, it, t_d = cast(torch.from_numpy(o.astype(np.float32)),
                                 torch.from_numpy(d.astype(np.float32)))
        prev = torch.from_numpy(np.asarray(pts, np.float32).reshape(-1, 3))
        test = hit.clone()
        test[hit] = ~plainly_close(p_d[hit], prev.to(dev))
        p, n, mid, t, test = (x.cpu().numpy() for x in (
            p_d, vm.to_arr(it["ng"]), it["mat_id"], t_d, test))
        for i in np.nonzero(test)[0]:
            if len(pts) >= max_points:
                break
            pi = p[i]
            if far_enough(pi):
                grid.setdefault(cell_of(pi), []).append(pi)
                pts.append(pi)
                nrm.append(n[i])
                mids.append(mid[i])
                eps_l.append(1e-3 * max(t[i], 1e-4))

    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    area = np.full(pts.shape[0], np.pi * (min_sample_dist * 0.5) ** 2,
                   np.float32)
    return SurfacePoints(p=pts, n=np.asarray(nrm, np.float32).reshape(-1, 3),
                         area=area,
                         mat_id=np.asarray(mids, np.int32).reshape(-1),
                         ray_eps=np.asarray(eps_l, np.float32).reshape(-1))


def save(path: str, sp: SurfacePoints) -> None:
    """Write the points as the reference does (``numpy.savez``; the keys
    p, n, area, mat_id, ray_eps): each package reads the other's file."""
    np.savez(path, p=sp.p, n=sp.n, area=sp.area, mat_id=sp.mat_id,
             ray_eps=sp.ray_eps)


def load(path: str) -> SurfacePoints:
    z = np.load(path)
    return SurfacePoints(p=z["p"], n=z["n"], area=z["area"],
                         mat_id=z["mat_id"], ray_eps=z["ray_eps"])
