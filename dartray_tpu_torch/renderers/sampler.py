"""SamplerRenderer: the main wavefront render loop (counterpart of the JAX
reference's ``renderers/sampler.py``).

One *wave* = every film pixel x one sample index, fully vectorized: generate
camera samples and rays, evaluate the surface integrator's Li over the wave,
scatter-add into the film. ``render`` iterates waves over the sample indices,
with the reference's preview callback (``progress``, its cadence set by
``sampling_mode``), statistics, partial result on a failed wave and
checkpoints to resume from. ``render_adaptive`` renders min_spp waves, then
refines the pixels whose samples disagree with max_spp - min_spp more.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional

import numpy as np
import torch

from .. import cameras as cam_mod
from .. import device as device_mod
from .. import film as film_mod
from .. import samplers as smp_mod
from .. import stats as stats_mod
from ..core import spectrum as spec_mod
from ..scene import types as st


@stats_mod.spanned("pixel_grid")
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
    """One wave: (pixels x one sample index) deposited into `film`, and the
    film returned. The scene, camera, film and pixel tensors must already
    live on `device` (see ``render`` for the set-up).

    The deposit is in place (``film.add_samples``) unless autograd records
    it, that is unless the wave's radiance or the film's pixels require
    grad: then it is out of place (``film.add_samples_functional``), `film`
    is left as it was and a new film is returned. Under ``torch.no_grad()``
    nothing requires grad, so ``render`` always takes the in-place form.

    Spans: ``wave`` (a unit of its own outside a fitting step) holding
    ``camera``, ``li`` and ``film``."""
    dev = device_mod.resolve(device)
    for name, where in (("camera", camera.device), ("film",
                        film.pixels.device), ("px", px.device)):
        if where.type != dev.type:
            raise ValueError(f"render_wave: {name} lives on {where}, "
                             f"the wave was asked to run on {dev}")
    with stats_mod.span("wave", unit=True):
        with stats_mod.span("camera"):
            cs = smp_mod.camera_samples(sampler, px, py, s_idx)
            diff_scale = 1.0 / np.sqrt(max(spp, 1))
            rays, diffs, weight = cam_mod.generate_rays(camera, cs, width,
                                                        height, diff_scale)
        sctx = {"sampler": sampler, "px": px, "py": py, "s_idx": s_idx}
        with stats_mod.span("li"):
            L = li_fn(scene, rays, diffs, sctx)
        with stats_mod.span("film"):
            L = L * weight
            add = (film_mod.add_samples_functional
                   if any(c.requires_grad for c in L)
                   or film.pixels.requires_grad else film_mod.add_samples)
            return add(film, cs.image_xy, L)


def render(scene, camera, sampler, li_fn, width, height,
           progress: Optional[Callable] = None, filter_name="box",
           filter_params=None, stats=None, checkpoint_path=None,
           checkpoint_every=8, on_error: str = "raise", log=None,
           sampling_mode: str = "iterative", device=device_mod.DEFAULT):
    """Full render: returns (H, W, 3) linear RGB as a numpy array. The scene
    is moved to `device` once; every wave runs there.

    stats: a ``stats.RenderStats`` to fill with the waves, camera rays and
    the seconds of the first wave and of the rest.
    progress(done, spp, film): the preview callback. sampling_mode sets its
    cadence, as in the reference: "iterative" after every wave, "twopass"
    after the first wave (when `stats` is given) and at the end, "full" at
    the end only; pixel values do not depend on it.
    on_error="partial": an exception in a wave after the first returns the
    film of the waves before it (logged through `log`) instead of raising.
    checkpoint_path: the film and the next sample index are saved there
    every `checkpoint_every` waves, and a checkpoint found there resumes the
    render at its next wave (without `stats`' first-wave split). Samples
    are keyed by (pixel, sample index, dimension), so a resumed render
    equals an uninterrupted one bit for bit."""
    dev = device_mod.resolve(device)
    scene = st.to_device(scene, dev)
    film = film_mod.make_film(width, height, filter_name=filter_name,
                              filter_params=filter_params, device=dev)
    px, py = pixel_grid(width, height, device=dev)
    spp = sampler.spp
    resume_s = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        film, resume_s = film_mod.load_checkpoint(checkpoint_path, film)
    if resume_s > 0:
        stats = None

    def wave(film, s):
        s_idx = torch.full(px.shape, s, dtype=torch.int32, device=dev)
        return render_wave(scene, camera, sampler, film, px, py, s_idx,
                           li_fn=li_fn, width=width, height=height, spp=spp,
                           device=dev)

    def counted():
        if stats is not None:
            stats.add("waves", 1)
            stats.add("rays/camera", px.shape[0])

    start = resume_s
    with torch.no_grad():
        if stats is not None:
            with stats.time("time/compile+first_wave"):
                film = wave(film, 0)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            counted()
            start = 1
            if progress is not None and sampling_mode in ("iterative",
                                                          "twopass"):
                progress(1, spp, film)
        timer = (stats.time("time/render") if stats is not None
                 else contextlib.nullcontext())
        with timer:
            for s in range(start, spp):
                try:
                    film = wave(film, s)
                    if progress is not None and (
                            sampling_mode == "iterative"
                            or (sampling_mode in ("twopass", "full")
                                and s + 1 == spp)):
                        progress(s + 1, spp, film)
                except Exception as e:  # noqa: BLE001
                    if on_error != "partial":
                        raise
                    (log or print)(
                        f"error: render failed at wave {s + 1}/{spp} "
                        f"({type(e).__name__}: {e}); returning the partial "
                        f"image accumulated so far")
                    break
                counted()
                if (checkpoint_path is not None
                        and (s + 1) % checkpoint_every == 0 and s + 1 < spp):
                    film_mod.save_checkpoint(checkpoint_path, film, s + 1)
            out = film_mod.to_rgb(film).cpu().numpy()
    return out


def render_adaptive(scene, camera, sampler, li_fn, width, height,
                    min_spp=4, max_spp=32, contrast_threshold=0.5,
                    progress: Optional[Callable] = None, filter_name="box",
                    filter_params=None, device=device_mod.DEFAULT):
    """Adaptive supersampling: min_spp waves track each pixel's luminance
    min / max; a pixel whose contrast (max - min) / (max + min) exceeds
    `contrast_threshold` gets the max_spp - min_spp waves after them. Those
    waves run over the whole image with every other lane dead (tmax = -1,
    so the traversal skips it) and masked at the deposit; the film divides
    by each pixel's own weight, so uneven sample counts are exact. Ray
    differentials are scaled for max_spp. Returns (H, W, 3) linear RGB as
    numpy and the number of refined pixels, the one value read back to
    the host."""
    dev = device_mod.resolve(device)
    scene = st.to_device(scene, dev)
    film = film_mod.make_film(width, height, filter_name=filter_name,
                              filter_params=filter_params, device=dev)
    px, py = pixel_grid(width, height, device=dev)
    diff_scale = 1.0 / np.sqrt(max(max_spp, 1))

    def wave(s, refine=None):
        s_idx = torch.full(px.shape, s, dtype=torch.int32, device=dev)
        cs = smp_mod.camera_samples(sampler, px, py, s_idx)
        rays, diffs, weight = cam_mod.generate_rays(camera, cs, width,
                                                    height, diff_scale)
        if refine is not None:
            rays = rays._replace(tmax=torch.where(refine, rays.tmax, -1.0))
        sctx = {"sampler": sampler, "px": px, "py": py, "s_idx": s_idx}
        L = li_fn(scene, rays, diffs, sctx) * weight
        film_mod.add_samples(film, cs.image_xy, L, mask=refine)
        return L

    with torch.no_grad():
        lmin = torch.full(px.shape, float("inf"), device=dev)
        lmax = torch.full(px.shape, float("-inf"), device=dev)
        for s in range(min_spp):
            lum = spec_mod.luminance(wave(s))
            lmin = torch.minimum(lmin, lum)
            lmax = torch.maximum(lmax, lum)
            if progress is not None:
                progress(s + 1, max_spp, film)
        contrast = (lmax - lmin) / (lmax + lmin).clamp_min(1e-6)
        refine = (contrast > contrast_threshold) & torch.isfinite(contrast)
        for s in range(min_spp, max_spp):
            wave(s, refine)
            if progress is not None:
                progress(s + 1, max_spp, film)
        n_refined = int(refine.sum())
        out = film_mod.to_rgb(film).cpu().numpy()
    return out, n_refined
