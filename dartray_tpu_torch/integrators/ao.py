"""Ambient-occlusion surface integrator (counterpart of the JAX reference's
``integrators/ao.py``).

Per hit point, ``n_samples`` (0,2)-sequence sphere samples flipped into the
normal's hemisphere, occlusion probes limited to [min_dist, max_dist];
returns nClear / nSamples. One closest-hit launch for the camera wave, then
every probe is a full any-hit wave of its own: ``n_samples + 1`` launches a
wave.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import stats
from ..core import math as vm
from ..core import sampling as smp
from ..ops import sampler_cuda as sc
from ..scene import types as st


@dataclasses.dataclass
class AOIntegrator:
    n_samples: int = 2048
    min_dist: float = 1e-4
    max_dist: float = float("inf")


# The probes' draws route by device: CUDA lanes take the hashing kernel
# (``ops/sampler_cuda.py``: one launch for the scramble pair, one a probe),
# CPU lanes the plain versions; each counts as one draw while collecting
# (``samplers.py``).

def scrambles_plain(px, py, s_idx):
    """The scramble pair of each (pixel, camera sample): u32-in-int64."""
    base = smp.hash_u32(smp.as_u32(px) ^ (smp.as_u32(py) << 16)
                        ^ smp.hash_u32(smp.as_u32(s_idx)))
    return smp.hash_u32(base ^ 0x1234567), smp.hash_u32(base ^ 0x89abcdef)


def scrambles(px, py, s_idx):
    """The scramble pair: int32 bit patterns from the kernel on the card,
    ``scrambles_plain`` elsewhere; ``probe`` reads either."""
    if px.device.type == "cuda":
        stats.count("draws/kernel")
        return sc.ao_scrambles(px, py, s_idx)
    stats.count("draws/plain")
    return scrambles_plain(px, py, s_idx)


def probe(scr, i: int, n_bits: int):
    """Probe `i`'s (0,2)-sequence sample under each lane's pair (V2)."""
    if scr[0].device.type == "cuda":
        stats.count("draws/kernel")
        return vm.V2(*sc.ao_probe(scr, i, n_bits))
    stats.count("draws/plain")
    return smp.sample02(torch.full(scr[0].shape, i, dtype=torch.int64,
                                   device=scr[0].device), scr, n_bits)


def li(ig: AOIntegrator, scene: st.CompiledScene, rays, diffs, sctx):
    """(ao, ao, ao) of every camera ray that hits, 0 elsewhere."""
    geom = scene.geometry
    hits = st.intersect(geom, rays)
    it = st.interaction(geom, rays, hits)
    hit = hits.hit
    n = vm.face_forward(it["ns"], it["wo"])
    r = rays.n
    dev = rays.tmin.device
    # one scramble pair per (pixel, camera sample), the same for every probe
    with stats.span("sample"):
        scr = scrambles(sctx["px"], sctx["py"], sctx["s_idx"])
    eps = st.ray_epsilon(it["t"])
    # offset on the probe-hemisphere side of the surface (ng may face away
    # from the shading hemisphere for back-lit or unoriented geometry)
    o = it["p"] + vm.face_forward(it["ng"], n) * eps
    tmin = torch.full((r,), ig.min_dist, dtype=torch.float32, device=dev)
    tmax = torch.full((r,), ig.max_dist, dtype=torch.float32, device=dev)
    n_clear = torch.zeros((r,), dtype=torch.float32, device=dev)
    n_bits = max(int(ig.n_samples - 1).bit_length(), 1)
    for i in range(ig.n_samples):
        with stats.span("sample"):
            u = probe(scr, i, n_bits)
        w = vm.face_forward(smp.uniform_sample_sphere(u), n)
        occ = st.intersect_p(geom, vm.Rays(o=o, d=w, tmin=tmin, tmax=tmax,
                                           time=rays.time))
        n_clear = n_clear + (hit & ~occ).to(torch.float32)
    ao = n_clear / ig.n_samples
    return vm.where3(hit, vm.V3(ao, ao, ao), 0.0)
