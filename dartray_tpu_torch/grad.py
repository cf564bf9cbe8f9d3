"""Differentiable rendering: gradients of the film w.r.t. scene parameters
(counterpart of the JAX reference's ``grad.py``).

The detached-sampling estimator of the reference:

* Traversal is a gradient boundary. ``scene.types.intersect*`` run under
  ``torch.no_grad()`` and return hits without a graph, so geometry-edge
  (silhouette) derivatives are not captured: interior derivatives only.
  The CUDA traversal kernel is launched under autograd as it is in the
  forward render; no kernel has a backward of its own.
* Sampling decisions (lobe choice, sampled directions, light picks,
  Russian-roulette survival) are differentiated as if fixed: gradients flow
  through the f / pdf / Le evaluations at the sampled points. Unbiased for
  parameters that scale radiance (``materials.kd`` / ``kr`` / ``kt``,
  ``lights.intensity``).
* The samplers are counter-based, deterministic in (pixel, sample index,
  dimension), so central finite differences with common random numbers are
  a sharp oracle for those parameters (``finite_difference``).

Memory: ``render_image`` runs each wave under ``torch.utils.checkpoint``
(non-reentrant) when autograd records, so the backward pass recomputes a
wave instead of keeping spp tapes: O(1) in spp, as the reference's
``jax.checkpoint`` inside ``lax.scan``. With ``PathIntegrator``'s per-bounce
remat it is O(1) in depth too. A recompute launches the wave's traversal
again; it returns the same hits, since a ray's raw result depends neither
on the rays beside it nor on the sort, and it reads nothing back to the
host: the light table's kinds, its one host read, were cached on the
table by the wave's forward pass. Under ``torch.no_grad()`` (as in
``finite_difference``) the waves are the plain, in-place ones of
``renderers.sampler.render``.

Not ported: ``_grad_compiler_options`` (the TPU's scoped-VMEM limit for
gradient executables); nothing of it applies to the card.

Typical use::

    theta, inject = grad.select(scene, ["materials.kd", "lights.intensity"])
    loss = lambda img: ((img - target) ** 2).mean()
    val, grads = grad.render_loss_grad(scene, cam, smp, li_fn, W, H,
                                       theta, inject, loss)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import device as device_mod
from . import film as film_mod
from . import stats
from .renderers import sampler as rend
from .scene import types as st


def _get_path(obj, path: str):
    cur = obj
    for part in path.split("."):
        cur = getattr(cur, part)
    return cur


def _set_path(obj, path: str, value):
    """Functional deep set through nested dataclasses: new objects along
    the path, `obj` unchanged."""
    head, _, rest = path.partition(".")
    if rest:
        value = _set_path(getattr(obj, head), rest, value)
    return dataclasses.replace(obj, **{head: value})


def select(scene, paths: List[str]) -> Tuple[Dict[str, object], Callable]:
    """Extract a {path: array} theta dict + an inject(scene, theta) closure.

    Paths are dotted attribute paths into the CompiledScene, e.g.
    "materials.kd", "lights.intensity", "materials.kt". ``inject`` builds
    new tables and a new scene and leaves its argument as it was."""
    theta = {p: _get_path(scene, p) for p in paths}

    def inject(scene, theta):
        for p, v in theta.items():
            scene = _set_path(scene, p, v)
        return scene

    return theta, inject


def render_image(scene, camera, sampler, li_fn, width, height,
                 spp: int | None = None, device=device_mod.DEFAULT):
    """Differentiable full render -> (H, W, 3) linear RGB tensor on
    `device`. The scene is moved there once (a tensor leaf keeps its graph);
    `camera` must already live there. Each wave is checkpointed when
    autograd records (module docstring)."""
    spp = spp or sampler.spp
    dev = device_mod.resolve(device)
    scene = st.to_device(scene, dev)
    film = film_mod.make_film(width, height, device=dev)
    px, py = rend.pixel_grid(width, height, device=dev)

    def wave(film, s):
        s_idx = torch.full(px.shape, s, dtype=torch.int32, device=dev)
        return rend.render_wave(scene, camera, sampler, film, px, py, s_idx,
                                li_fn=li_fn, width=width, height=height,
                                spp=spp, device=dev)

    record = torch.is_grad_enabled()
    for s in range(spp):
        film = (checkpoint(wave, film, s, use_reentrant=False) if record
                else wave(film, s))
    return film_mod.to_rgb(film)


def render_loss_grad(scene, camera, sampler, li_fn, width, height,
                     theta, inject, loss_fn, spp: int | None = None,
                     device=device_mod.DEFAULT):
    """(loss, {path: d loss / d theta}) with the detached estimator.

    theta / inject from ``select``; loss_fn: (H, W, 3) image -> scalar.
    Both come back as tensors on `device`; a parameter the image does not
    depend on gets a zero gradient.

    Spans: ``grad.step`` (a unit) holding ``grad.forward`` (the waves and
    the loss) and ``grad.backward`` (the autograd pass, whose checkpoint
    recomputes open their spans marked ``recompute``)."""
    dev = device_mod.resolve(device)
    leaves = {p: torch.as_tensor(v, device=dev).detach().clone()
              .requires_grad_(True) for p, v in theta.items()}
    with torch.enable_grad(), stats.span("grad.step", unit=True):
        with stats.span("grad.forward"):
            img = render_image(inject(scene, leaves), camera, sampler, li_fn,
                               width, height, spp=spp, device=dev)
            loss = loss_fn(img)
        with stats.span("grad.backward"):
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
    return loss.detach(), {
        p: torch.zeros_like(x) if g is None else g
        for (p, x), g in zip(leaves.items(), grads)}


def render_pixel_jacobian_sum(scene, camera, sampler, li_fn, width, height,
                              theta, inject, spp: int | None = None,
                              device=device_mod.DEFAULT):
    """Gradient of the film MEAN w.r.t. theta: the 'pixel gradient' probe
    of the finite-difference tests."""
    return render_loss_grad(scene, camera, sampler, li_fn, width, height,
                            theta, inject, lambda img: img.mean(), spp=spp,
                            device=device)


def finite_difference(scene, camera, sampler, li_fn, width, height,
                      theta, inject, loss_fn, eps: float = 1e-3,
                      spp: int | None = None, device=device_mod.DEFAULT):
    """Central finite differences with common random numbers (the samplers
    are deterministic), one render pair per scalar component, each render
    on the ``no_grad`` fast path; the perturbation and the quotient in
    float64 on the host. Test oracle: O(2 * n_params) renders. Returns
    {path: float64 numpy array}."""
    def run(th):
        with torch.no_grad():
            img = render_image(inject(scene, th), camera, sampler, li_fn,
                               width, height, spp=spp, device=device)
            return float(loss_fn(img))

    grads = {}
    for p, v in theta.items():
        v = np.asarray(v.detach().cpu() if torch.is_tensor(v) else v,
                       np.float64)
        g = np.zeros_like(v)
        it = np.nditer(v, flags=["multi_index"])
        while not it.finished:
            idx = it.multi_index
            vp = v.copy()
            vp[idx] += eps
            vm_ = v.copy()
            vm_[idx] -= eps
            tp = dict(theta)
            tp[p] = torch.from_numpy(vp.astype(np.float32))
            tm = dict(theta)
            tm[p] = torch.from_numpy(vm_.astype(np.float32))
            g[idx] = (run(tp) - run(tm)) / (2 * eps)
            it.iternext()
        grads[p] = g
    return grads
