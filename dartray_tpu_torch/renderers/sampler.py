"""SamplerRenderer: the main wavefront render loop (counterpart of the JAX
reference's ``renderers/sampler.py``).

One *wave* = every film pixel x one sample index, fully vectorized: generate
camera samples and rays, evaluate the surface integrator's Li over the wave,
scatter-add into the film. ``render`` iterates waves over the sample indices.
Checkpoints, preview callbacks and adaptive sampling are not ported yet.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import cameras as cam_mod
from .. import device as device_mod
from .. import film as film_mod
from .. import samplers as smp_mod
from ..scene import types as st


def pixel_grid(width, height, x0=0, y0=0, morton: bool = True,
               device=device_mod.DEFAULT):
    """Flattened int32 pixel index tensors for a film window.

    morton: order pixels along a Z-curve so that consecutive rays of the
    camera wave cover compact image tiles (coherent warps for the traversal
    kernel, which takes the camera wave unsorted). The film scatter-add does
    not depend on the order."""
    dev = device_mod.resolve(device)
    ys, xs = np.meshgrid(np.arange(height, dtype=np.int32),
                         np.arange(width, dtype=np.int32), indexing="ij")
    xs = xs.reshape(-1)
    ys = ys.reshape(-1)
    if morton and width > 1 and height > 1:
        def spread(v):
            v = (v | (v << 8)) & 0x00FF00FF
            v = (v | (v << 4)) & 0x0F0F0F0F
            v = (v | (v << 2)) & 0x33333333
            v = (v | (v << 1)) & 0x55555555
            return v
        key = spread(xs.astype(np.int64)) | (spread(ys.astype(np.int64)) << 1)
        order = np.argsort(key, kind="stable")
        xs, ys = xs[order], ys[order]
    return (torch.from_numpy(xs + np.int32(x0)).to(dev),
            torch.from_numpy(ys + np.int32(y0)).to(dev))


def render_wave(scene, camera: cam_mod.Camera, sampler: smp_mod.Sampler,
                film: film_mod.Film, px, py, s_idx, *,
                li_fn: Callable, width: int, height: int, spp: int,
                device=device_mod.DEFAULT):
    """One wave: (pixels x one sample index) deposited into `film` (in
    place; the film is returned). The scene, camera, film and pixel tensors
    must already live on `device` (see ``render`` for the set-up)."""
    dev = device_mod.resolve(device)
    for name, where in (("camera", camera.device), ("film",
                        film.pixels.device), ("px", px.device)):
        if where.type != dev.type:
            raise ValueError(f"render_wave: {name} lives on {where}, "
                             f"the wave was asked to run on {dev}")
    cs = smp_mod.camera_samples(sampler, px, py, s_idx)
    diff_scale = 1.0 / np.sqrt(max(spp, 1))
    rays, diffs, weight = cam_mod.generate_rays(camera, cs, width, height,
                                                diff_scale)
    sctx = {"sampler": sampler, "px": px, "py": py, "s_idx": s_idx}
    L = li_fn(scene, rays, diffs, sctx)
    L = L * weight
    return film_mod.add_samples(film, cs.image_xy, L)


def render(scene, camera, sampler, li_fn, width, height,
           filter_name="box", filter_params=None,
           device=device_mod.DEFAULT):
    """Full render: returns (H, W, 3) linear RGB as a numpy array. The scene
    is moved to `device` once; every wave runs there."""
    dev = device_mod.resolve(device)
    scene = st.to_device(scene, dev)
    film = film_mod.make_film(width, height, filter_name=filter_name,
                              filter_params=filter_params, device=dev)
    px, py = pixel_grid(width, height, device=dev)
    spp = sampler.spp
    with torch.no_grad():
        for s in range(spp):
            s_idx = torch.full(px.shape, s, dtype=torch.int32, device=dev)
            film = render_wave(scene, camera, sampler, film, px, py, s_idx,
                               li_fn=li_fn, width=width, height=height,
                               spp=spp, device=dev)
    return film_mod.to_rgb(film).cpu().numpy()
