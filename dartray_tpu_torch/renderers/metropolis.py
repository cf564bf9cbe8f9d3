"""The Metropolis light transport renderer: primary-sample-space MLT over
thousands of parallel Markov chains (counterpart of the JAX reference's
``renderers/metropolis.py``).

A chain's state is a vector u in [0, 1)^D of primary samples that drives the
radiance through ``samplers.vector_sampler``: dims 0 and 1 are the image
position over the whole film, 2 and 3 the lens, 4 the time, the rest the
integrator's (``integrators/bdpt.path_l``, or ``path.li`` without
``bidirectional``). Every random number is drawn with ``core/prng.py``,
bit for bit the reference's ``jax.random`` draws:

* bootstrap: key, kb = PRNGKey(seed) split; u_boot = uniform(kb,
  (n_bootstrap, D)) with dims 0 and 1 replaced by the (0,2)-sequence under
  two scrambles from randint(kb, ...) (the same key again); b = the mean
  luminance; the chains start at u_boot resampled in proportion to their
  luminance (``searchsorted``, left side, of uniform(kr, (n_chains,)));
* ``n_steps = max(spp * W * H // n_chains, 1)`` steps, each with keys
  k1..k5 split from its own: a large step (probability
  ``large_step_prob``) draws u afresh, a small one moves every dimension by
  the exponential kernel wrapped to [0, 1); accept with probability
  a = min(1, I_prop / I_cur) (forced after ``max_consecutive_rejects``);
  both states splat to their nearest pixel with expected-value weights
  a b / I_prop and (1 - a) b / I_cur, non-finite radiance zeroed first.

A step evaluates the radiance once: the current state's image position is
(u0 W, u1 H), the same float32 products the reference reads from a second
radiance call of the current state. The splat sums with ``index_put_``
(accumulate), in no fixed order on the card. The image is the splat buffer
times W H / (n_steps n_chains), plus, with ``do_direct_separately``, a
direct-lighting render (one light, depth 0, ``lowdiscrepancy`` at
``direct_spp``, the box filter) of the direct light the chains leave out.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import cameras as cam_mod
from .. import device as device_mod
from .. import film as film_mod
from .. import samplers as smp_mod
from ..core import math as vm
from ..core import prng
from ..core import sampling as smp
from ..core import spectrum as spec
from ..integrators import bdpt
from ..integrators import direct as di
from ..integrators import path as pi
from ..scene import types as st
from . import sampler as rend

LOG_RATIO = float(-np.log((1.0 / 64.0) / (1.0 / 1024.0)))
_F = lambda v: float(np.float32(v))   # noqa: E731
_EXP_LO, _EXP_HI = _F(-88.3762626647949), _F(88.3762626647950)
_EXP_POLY = [_F(v) for v in (1.9875691500e-4, 1.3981999507e-3,
                             8.3334519073e-3, 4.1665795894e-2,
                             1.6666665459e-1, 5.0000001201e-1)]


def _fma(a, b, c):
    """float32 a * b + c rounded once (the float64 product of two float32
    values is exact)."""
    return (a.double() * (b.double() if torch.is_tensor(b) else b)
            + c).float()


def exp_f32(x):
    """float32 e^x as the reference's CPU backend computes it for x in
    [-87, 88] (the small step's arguments lie in [-2.78, 0]): Cephes'
    polynomial with every multiply-add fused. ``torch.exp`` differs from
    it in the last bit on about one argument in ten."""
    xc = x.clamp(_EXP_LO, _EXP_HI)
    fx = torch.floor(_fma(xc, _F(1.44269504088896341), 0.5))
    r = _fma(fx, -0.693359375, xc)
    r = _fma(fx, -_F(-2.12194440e-4), r)
    y = _fma(r, _EXP_POLY[0], _EXP_POLY[1])
    for p in _EXP_POLY[2:]:
        y = _fma(y, r, p)
    y = _fma(y, r * r, r) + 1.0
    return y * ((fx.to(torch.int32) + 127) << 23).view(torch.float32)


def _mutate_small(u, r1, r2):
    """The exponential small-step kernel, wrapped to [0, 1)."""
    delta = (1.0 / 64.0) * exp_f32(LOG_RATIO * r1)
    new_u = torch.where(r2 < 0.5, u + delta, u - delta)
    return new_u - torch.floor(new_u)


def image_xy(u, width, height):
    """A state's continuous image position (u0 W, u1 H)."""
    return vm.V2(u[:, 0] * width, u[:, 1] * height)


def _radiance_for(scene, camera, width, height, li_fn, u):
    """(radiance V3, image position) of the primary-sample vectors u
    (R, D); non-finite radiance is zeroed."""
    r = u.shape[0]
    xy = image_xy(u, width, height)
    px = xy.x.to(torch.int32).clamp(0, width - 1)
    py = xy.y.to(torch.int32).clamp(0, height - 1)
    cs = smp_mod.CameraSamples(image_xy=xy, lens_uv=vm.V2(u[:, 2], u[:, 3]),
                               time_u=u[:, 4])
    rays, diffs, weight = cam_mod.generate_rays(camera, cs, width, height,
                                                1.0)
    sctx = {"sampler": smp_mod.vector_sampler(u), "px": px, "py": py,
            "s_idx": torch.zeros((r,), dtype=torch.int32, device=u.device)}
    L = li_fn(scene, rays, diffs, sctx)
    L = vm.V3(*(torch.where(torch.isfinite(c), c, 0.0) for c in L)) * weight
    return L, xy


def radiance_fn(max_depth, bidirectional=True, do_direct_separately=True):
    """(li_fn, dims) the chains evaluate."""
    if bidirectional:
        return (partial(bdpt.path_l, max_depth=max_depth, bidirectional=True,
                        skip_direct=do_direct_separately),
                bdpt.dims_for(max_depth, True))
    ig = pi.PathIntegrator(max_depth=max_depth)
    return (partial(pi.li, ig, skip_direct=do_direct_separately),
            16 + 10 * (max_depth + 2))


def _splat(img, xy, v, width, height):
    ix = xy.x.to(torch.int64).clamp(0, width - 1)
    iy = xy.y.to(torch.int64).clamp(0, height - 1)
    img.index_put_((iy, ix), vm.to_arr(v), accumulate=True)


def bootstrap(rad, key, n_bootstrap, n_dims, n_chains, dev):
    """(u0 of the chains, b, the key left) from the bootstrap draws."""
    kb, key = prng.split(key)
    u_boot = prng.uniform(kb, (n_bootstrap, n_dims), dev)
    scr = prng.randint(kb, (2,), 0, 2 ** 31 - 1).astype(np.uint32)
    b2 = smp.sample02(torch.arange(n_bootstrap, dtype=torch.int64,
                                   device=dev),
                      tuple(torch.tensor(int(s), dtype=torch.int64,
                                         device=dev) for s in scr))
    u_boot[:, 0] = b2.x
    u_boot[:, 1] = b2.y
    L_boot, _ = rad(u_boot)
    I_boot = spec.luminance(L_boot)
    b = float(I_boot.mean())
    if b <= 0.0:
        b = 1e-9
    cdf = torch.cumsum(I_boot.clamp_min(0.0), 0)
    cdf = cdf / cdf[-1].clamp_min(1e-30)
    kr, key = prng.split(key)
    picks = torch.searchsorted(cdf, prng.uniform(kr, (n_chains,), dev))
    return u_boot[picks.clamp(0, n_bootstrap - 1)], b, key


def mlt_step(rad, state, k, b, width, height, large_step_prob,
             max_consecutive_rejects, splat_img):
    """One Metropolis step of every chain under key k: splats both states
    into `splat_img` and returns the new state (u, L, I, rejects) and the
    accept mask."""
    u, L_cur, I_cur, rejects = state
    n_chains, n_dims = u.shape
    dev = u.device
    k1, k2, k3, k4, k5 = prng.split(k, 5)
    is_large = prng.uniform(k1, (n_chains,), dev) < large_step_prob
    u_fresh = prng.uniform(k2, (n_chains, n_dims), dev)
    r1 = prng.uniform(k3, (n_chains, n_dims), dev)
    r2 = prng.uniform(k4, (n_chains, n_dims), dev)
    u_prop = torch.where(is_large[:, None], u_fresh, _mutate_small(u, r1, r2))
    L_prop, xy_prop = rad(u_prop)
    I_prop = spec.luminance(L_prop)
    a = (I_prop / I_cur.clamp_min(1e-30)).clamp_max(1.0)
    a = torch.where(I_cur <= 0.0, 1.0, a)
    # expected-value splatting of both states
    w_prop = torch.where(I_prop > 0, a * b / I_prop.clamp_min(1e-30), 0.0)
    w_cur = torch.where(I_cur > 0, (1.0 - a) * b / I_cur.clamp_min(1e-30),
                        0.0)
    _splat(splat_img, xy_prop, spec.to_xyz(L_prop * w_prop), width, height)
    _splat(splat_img, image_xy(u, width, height),
           spec.to_xyz(L_cur * w_cur), width, height)
    accept = prng.uniform(k5, (n_chains,), dev) < a
    accept = accept | (rejects >= max_consecutive_rejects)
    rejects = torch.where(accept, 0, rejects + 1)
    u = torch.where(accept[:, None], u_prop, u)
    L_cur = vm.where3(accept, L_prop, L_cur)
    I_cur = torch.where(accept, I_prop, I_cur)
    return (u, L_cur, I_cur, rejects), accept


@torch.no_grad()
def render(scene, camera, width, height, spp=100, n_chains=8192,
           n_bootstrap=4096, large_step_prob=0.25, max_depth=7,
           max_consecutive_rejects=512, do_direct_separately=True,
           direct_spp=4, seed=0, progress=None, bidirectional=True,
           stats=None, device=device_mod.DEFAULT):
    """The MLT render on `device` -> (H, W, 3) linear RGB as numpy.

    spp: mutations per pixel. bidirectional: the chains evaluate
    ``bdpt.path_l`` (the reference's default); False: ``path.li``.
    stats: a dict filled with b, steps, chains, accepted and the seconds of
    the bootstrap, the chains and the direct pass."""
    import time
    dev = device_mod.resolve(device)
    scene = st.to_device(scene, dev)
    li_fn, n_dims = radiance_fn(max_depth, bidirectional,
                                do_direct_separately)
    rad = partial(_radiance_for, scene, camera, width, height, li_fn)
    t0 = time.time()
    u0, b, key = bootstrap(rad, prng.PRNGKey(seed), n_bootstrap, n_dims,
                           n_chains, dev)
    n_steps = max(int(spp) * width * height // n_chains, 1)
    L0, _ = rad(u0)
    state = (u0, L0, spec.luminance(L0),
             torch.zeros((n_chains,), dtype=torch.int32, device=dev))
    splat_img = torch.zeros((height, width, 3), dtype=torch.float32,
                            device=dev)
    t1 = time.time()
    accepted = 0
    for s, k in enumerate(prng.split(key, n_steps)):
        state, acc = mlt_step(rad, state, k, b, width, height,
                              large_step_prob, max_consecutive_rejects,
                              splat_img)
        accepted = accepted + acc.sum()
        if progress is not None and ((s + 1) % 64 == 0 or s + 1 == n_steps):
            progress(s + 1, n_steps, None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.time()
    film = film_mod.make_film(width, height, device=dev)
    film.splat = splat_img
    splat_scale = float(width * height) / float(n_steps * n_chains)
    img = film_mod.to_rgb(film, splat_scale=splat_scale).cpu().numpy()
    if do_direct_separately:
        igd = di.DirectLightingIntegrator(strategy=di.STRATEGY_ONE,
                                          max_depth=0)
        smp_d = smp_mod.make_sampler("lowdiscrepancy", spp=direct_spp)
        img = rend.render(scene, camera, smp_d,
                          lambda s, r, d, c: di.li(igd, s, r, d, c),
                          width, height, device=dev) + img
    if stats is not None:
        stats.update(b=b, steps=n_steps, chains=n_chains,
                     accepted=int(accepted), bootstrap_s=t1 - t0,
                     chains_s=t2 - t1, direct_s=time.time() - t2)
    return img
