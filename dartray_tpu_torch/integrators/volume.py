"""Volume integrators: emission and single scattering (counterpart of the
JAX reference's ``integrators/volume.py``).

Both march the camera segment [tmin, first surface hit] through the
regions' overlap in ``n_steps`` (32) equal steps, each sampled at a jittered
point, and return (Lv, T): the radiance the medium adds and the segment's
transmittance, which the render manager composes as ``T * Ls + Lv``. The
``stepsize`` of a ``VolumeIntegrator`` statement is kept on the integrator
and not read: the step is the overlap's length over n_steps. Single
scattering samples one light a step and traces its shadow ray from the
sample point (tmin 1e-4): one any-hit traversal a step, so 32 a wave; the
shadow ray's own transmittance is an 8-step march with no traversal.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import lights as lt_mod
from .. import samplers as smp_mod
from .. import volumes as vol_mod
from ..core import math as vm
from ..scene import types as st


@dataclasses.dataclass
class EmissionIntegrator:
    step_size: float = 1.0     # read from the scene, not used
    n_steps: int = 32


@dataclasses.dataclass
class SingleScatteringIntegrator:
    step_size: float = 1.0     # read from the scene, not used
    n_steps: int = 32


def _exp3(v):
    return vm.V3(torch.exp(-v.x), torch.exp(-v.y), torch.exp(-v.z))


def transmittance(vol, rays, u_offset, n_steps=32):
    """exp(-tau) with a jittered tau estimate: V3 (ones without a
    volume)."""
    if vol is None:
        return vm.v3ones(rays.tmin.shape, rays.tmin.device)
    return _exp3(vol_mod.tau(vol, rays, 1.0, u_offset, n_steps=n_steps))


def _sampler(sctx):
    return (lambda d: smp_mod.sample_1d(sctx["sampler"], sctx["px"],
                                        sctx["py"], sctx["s_idx"], d),
            lambda d: smp_mod.sample_2d(sctx["sampler"], sctx["px"],
                                        sctx["py"], sctx["s_idx"], d))


def _march(ig, scene, rays, seg_tmax, u0, scatter=None):
    """The shared march: Lv = sum T(t_k) (Lve(t_k) + scatter(k, p)) dt and
    T over the segment, both masked to the lanes that meet a region."""
    vol = scene.volume
    shape, dev = rays.tmin.shape, rays.tmin.device
    if vol is None:
        return vm.v3zeros(shape, dev), vm.v3ones(shape, dev)
    seg = rays._replace(tmax=seg_tmax)
    t0, t1, hit = vol_mod.intersect_bounds(vol, seg)
    dt = ((t1 - t0) / ig.n_steps).clamp_min(1e-8)
    tau_acc = vm.v3zeros(shape, dev)
    lv = vm.v3zeros(shape, dev)
    for k in range(ig.n_steps):
        t = t0 + (float(k) + u0) * dt
        p = seg.at(t)
        s_t = vol_mod.sigma_t(vol, p)
        tr_ = _exp3(tau_acc)
        lv = lv + tr_ * vol_mod.lve(vol, p) * dt
        if scatter is not None:
            lv = lv + tr_ * scatter(k, seg, p) * dt
        tau_acc = tau_acc + s_t * dt
    return vm.where3(hit, lv, 0.0), vm.where3(hit, _exp3(tau_acc), 1.0)


@torch.no_grad()
def emission_li(ig: EmissionIntegrator, scene, rays, seg_tmax, sctx):
    """Emission and absorption along [tmin, seg_tmax]: (Lv, T)."""
    sd, _ = _sampler(sctx)
    u = sd(200) if scene.volume is not None else None
    return _march(ig, scene, rays, seg_tmax, u)


@torch.no_grad()
def single_scatter_li(ig: SingleScatteringIntegrator, scene, rays, seg_tmax,
                      sctx):
    """Emission, absorption and single scattering with one light sample a
    step (sample dimensions 211 + 7k, 212 + 7k, 215 + 7k): (Lv, T)."""
    vol = scene.volume
    lt = scene.lights
    geom = scene.geometry
    if vol is None:
        return _march(ig, scene, rays, seg_tmax, None)
    sd, sd2 = _sampler(sctx)
    w = -rays.d

    def scatter(k, seg, p):
        r = seg.n
        ss = vol_mod.sigma_s(vol, p)
        light_idx = torch.clamp_max((sd(211 + 7 * k) * lt.n).to(torch.int32),
                                    lt.n - 1)
        ls = lt_mod.sample_li(lt, geom, light_idx, p, sd2(212 + 7 * k))
        sray = vm.Rays(o=p, d=ls.wi,
                       tmin=torch.full((r,), 1e-4, device=p.x.device),
                       tmax=ls.dist * (1 - 1e-3), time=seg.time)
        occ = st.intersect_p(geom, sray)
        tr_l = transmittance(vol, sray, sd(215 + 7 * k), n_steps=8)
        ph = vol_mod.phase(vol, p, w, ls.wi)
        contrib = (ss * tr_l * ls.li
                   * (ph * float(lt.n) / ls.pdf.clamp_min(1e-20)))
        return vm.where3(occ, 0.0, contrib)

    has_lights = lt is not None and lt.n > 0
    return _march(ig, scene, rays, seg_tmax, sd(210),
                  scatter if has_lights else None)
