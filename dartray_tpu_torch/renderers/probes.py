"""The ``createprobes`` renderer: bake SH radiance probes on a 3D grid
(counterpart of the JAX reference's ``renderers/probes.py``).

Probes sit at the cell centres of an (nx, ny, nz) grid over a box (the
world bound by default), raveled x-major. Each probe sees ``n_samples``
(0,2)-sequence directions over the sphere (one scramble from
``numpy.random.default_rng(seed)``); chunks of ``chunk`` probes go through
the scene's radiance function at once (``chunk * n_samples`` rays), each
chunk with the ``random`` sampler at ``seed``, pixels 0 .. chunk *
n_samples - 1 of row 0 and sample index 0, so every chunk draws the same
randoms. Each chunk is projected onto SH with one einsum. ``save`` /
``load`` keep the reference's ``.npz`` keys, so each package reads the
other's file.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import device as device_mod
from .. import samplers as smp_mod
from ..core import math as vm
from ..core import sampling as smp
from ..core import sh
from ..integrators import prt as prt_mod
from ..scene import types as st

FOUR_PI = float(4.0 * np.pi)


def probe_positions(bbox_lo, bbox_hi, res):
    """(nx * ny * nz, 3) cell-centre positions, x-major (float64, as the
    reference computes them; the rays start at their float32 rounding)."""
    nx, ny, nz = res
    lo = np.asarray(bbox_lo, np.float32)
    hi = np.asarray(bbox_hi, np.float32)
    xs = (np.arange(nx) + 0.5) / nx
    ys = (np.arange(ny) + 0.5) / ny
    zs = (np.arange(nz) + 0.5) / nz
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    g = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    return lo + g * (hi - lo)


@torch.no_grad()
def render(scene, li_fn: Callable, bbox_lo=None, bbox_hi=None,
           res=(4, 4, 4), lmax: int = 4, n_samples: int = 512,
           seed: int = 11, chunk: int = 4,
           device=device_mod.DEFAULT) -> prt_mod.SHProbes:
    """Bake the probes on `device` (the scene is moved there).
    li_fn(scene, rays, diffs, sctx) -> V3 radiance: the job's radiance
    function."""
    scene = st.to_device(scene, device)
    geom = scene.geometry
    dev = geom.mat_id.device
    if bbox_lo is None or bbox_hi is None:
        wb = geom.world_bound.cpu().numpy()
        bbox_lo = wb[0] if bbox_lo is None else bbox_lo
        bbox_hi = wb[1] if bbox_hi is None else bbox_hi
    pos = probe_positions(bbox_lo, bbox_hi, res)
    n_probes = pos.shape[0]
    T = sh.n_terms(lmax)
    scr_np = np.random.default_rng(seed).integers(0, 2 ** 32, 2,
                                                  dtype=np.uint32)
    u = smp.sample02(torch.arange(n_samples, dtype=torch.int64, device=dev),
                     prt_mod.scrambles(scr_np, dev))
    dirs = smp.uniform_sample_sphere(u)
    Y = sh.eval_basis(dirs, lmax)                        # (S, T)
    w = FOUR_PI / n_samples
    sampler = smp_mod.make_sampler("random", spp=1, seed=seed)
    pos_t = torch.from_numpy(pos.astype(np.float32)).to(dev)
    out = torch.zeros((n_probes, T, 3), dtype=torch.float32, device=dev)
    for s in range(0, n_probes, chunk):
        e = min(s + chunk, n_probes)
        c = e - s
        r = c * n_samples
        o = vm.from_arr(pos_t[s:e].repeat_interleave(n_samples, dim=0))
        d = vm.V3(*(a.repeat(c) for a in dirs))
        rays = vm.Rays(o=o, d=d,
                       tmin=torch.full((r,), 1e-4, dtype=torch.float32,
                                       device=dev),
                       tmax=torch.full((r,), float("inf"),
                                       dtype=torch.float32, device=dev),
                       time=torch.zeros((r,), dtype=torch.float32,
                                        device=dev))
        # the integrators draw per-pixel randoms: a pixel id per probe ray
        sctx = {"sampler": sampler,
                "px": torch.arange(r, dtype=torch.int32, device=dev),
                "py": torch.zeros((r,), dtype=torch.int32, device=dev),
                "s_idx": torch.zeros((r,), dtype=torch.int32, device=dev)}
        L = vm.to_arr(li_fn(scene, rays, None, sctx)).reshape(c, n_samples,
                                                              3)
        out[s:e] = torch.einsum("st,csk->ctk", Y, L) * w
    return prt_mod.SHProbes(
        coeffs=out, bbox_lo=torch.as_tensor(np.asarray(bbox_lo, np.float32),
                                            device=dev),
        bbox_hi=torch.as_tensor(np.asarray(bbox_hi, np.float32), device=dev),
        lmax=lmax, res=tuple(res))


def save(path: str, probes: prt_mod.SHProbes) -> None:
    """Write the probes as ``.npz`` (keys coeffs, bbox_lo, bbox_hi, lmax,
    res)."""
    host = lambda a: a.cpu().numpy() if torch.is_tensor(a) \
        else np.asarray(a)  # noqa: E731
    np.savez(path, coeffs=host(probes.coeffs), bbox_lo=host(probes.bbox_lo),
             bbox_hi=host(probes.bbox_hi), lmax=probes.lmax,
             res=np.asarray(probes.res))


def load(path: str, device=device_mod.DEFAULT) -> prt_mod.SHProbes:
    """Probes written by ``save`` (of either package), on `device`."""
    dev = device_mod.resolve(device)
    z = np.load(path)
    def t(k):
        return torch.from_numpy(np.asarray(z[k], np.float32)).to(dev)
    return prt_mod.SHProbes(coeffs=t("coeffs"), bbox_lo=t("bbox_lo"),
                            bbox_hi=t("bbox_hi"), lmax=int(z["lmax"]),
                            res=tuple(int(x) for x in z["res"]))
