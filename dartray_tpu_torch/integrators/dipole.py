"""Dipole subsurface scattering integrator (counterpart of the JAX
reference's ``integrators/dipole.py``).

The preprocess (``prepare``) takes the points of the ``surfacepoints``
renderer (``renderers/surface_points.py``) and the irradiance at each from
every light: 4 samples a light (``numpy.random.default_rng(9)``), one
any-hit traversal each. ``li`` adds, on hits of a subsurface material,
Ft(eta, wo) / pi times Mo(p) = sum_i Rd(|p - p_i|^2) E_i A_i, the two-pole
diffusion reflectance summed densely over all points, then emission and one
light sampled with MIS. Nothing follows a specular bounce.

As in the reference: ``maxerror`` is read and never used (the sum is dense,
there is no octree); the first medium of the job's subsurface materials
serves all of them; the integrator's eta (1.3) is used, not the material's
``index``; a scene without a subsurface material gets skin1's term on every
surface. Mo runs over the points in blocks of 1024, the last padded with
points at 1e30 whose squared distance overflows to inf: Rd(inf) is
inf * 0 = NaN, so Mo is NaN unless the point count is a multiple of 1024,
and the film zeroes those samples.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import bsdf as bx
from .. import device as device_mod
from .. import lights as lt_mod
from .. import materials as mat_mod
from .. import samplers as smp_mod
from ..core import math as vm
from ..scene import types as st
from . import common

INV_PI = float(1.0 / np.pi)
MO_BUDGET = 1 << 22     # (lane, point) pairs of one Mo block at most

# named scattering media: name -> (sigma_prime_s rgb [1/mm], sigma_a rgb)
MEDIA = {
    "cream": ((7.38, 5.47, 3.15), (0.0002, 0.0028, 0.0163)),
    "ketchup": ((0.18, 0.07, 0.03), (0.061, 0.97, 1.45)),
    "marble": ((2.19, 2.62, 3.00), (0.0021, 0.0041, 0.0071)),
    "potato": ((0.68, 0.70, 0.55), (0.0024, 0.0090, 0.12)),
    "skimmilk": ((0.70, 1.22, 1.90), (0.0014, 0.0025, 0.0142)),
    "skin1": ((0.74, 0.88, 1.01), (0.032, 0.17, 0.48)),
    "skin2": ((1.09, 1.59, 1.79), (0.013, 0.070, 0.145)),
    "spectralon": ((11.6, 20.4, 14.9), (0.00, 0.00, 0.00)),
    "wholemilk": ((2.55, 3.21, 3.77), (0.0011, 0.0024, 0.014)),
}


@dataclasses.dataclass
class DipoleSubsurfaceIntegrator:
    max_depth: int = 5
    max_error: float = 0.05
    min_sample_dist: float = 0.25
    eta: float = 1.3
    scale: float = 1.0


def media_params(name: str):
    """(sigma'_s, sigma_a) of a named medium (skin1 for an unknown name),
    float32 numpy (3,)."""
    s, a = MEDIA.get(name, MEDIA["skin1"])
    return np.asarray(s, np.float32), np.asarray(a, np.float32)


def fdr(eta):
    """Diffuse Fresnel reflectance (the polynomial fit)."""
    return -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta


def dipole_rd(d2, sigma_prime_s, sigma_a, eta: float):
    """Two-pole diffusion reflectance Rd(r^2): d2 (...), the spectra (3,)
    tensors -> (..., 3)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32,  # noqa: E731
                                 device=d2.device)
    sigma_tp = sigma_a + sigma_prime_s
    alpha_p = sigma_prime_s / sigma_tp.clamp_min(1e-9)
    sigma_tr = torch.sqrt(3.0 * sigma_a * sigma_tp)
    A = f32(1.0 + fdr(eta)) / f32(max(1.0 - fdr(eta), 1e-9))
    zr = 1.0 / sigma_tp.clamp_min(1e-9)
    zv = zr * (1.0 + (4.0 / 3.0) * A)
    dr = torch.sqrt(d2[..., None] + zr * zr)
    dv = torch.sqrt(d2[..., None] + zv * zv)
    term_r = zr * (sigma_tr * dr + 1.0) * torch.exp(-sigma_tr * dr) / (
        sigma_tp * (dr * dr * dr))
    term_v = zv * (sigma_tr * dv + 1.0) * torch.exp(-sigma_tr * dv) / (
        sigma_tp * (dv * dv * dv))
    return torch.clamp_min(alpha_p / (4.0 * np.pi) * (term_r + term_v), 0.0)


@torch.no_grad()
def compute_irradiances(scene, sp, n_samples: int = 4, seed: int = 9):
    """E at each surface point from every light, sum over samples of
    Li cos+ V / pdf over n_samples: (P, 3) float32 numpy. The scene is on
    its device already."""
    geom = scene.geometry
    lt = scene.lights
    dev = geom.mat_id.device
    P = sp.p.shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    p = vm.from_arr(t(sp.p))
    n = vm.from_arr(t(sp.n))
    eps = t(sp.ray_eps)
    rng = np.random.default_rng(seed)
    E = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    if lt is None or lt.n == 0:
        return E.cpu().numpy()
    for li_i in range(lt.n):
        idx = torch.full((P,), li_i, dtype=torch.int32, device=dev)
        for _ in range(n_samples):
            u = t(rng.random((P, 2), np.float32))
            uc = t(rng.random((P,), np.float32))
            ls = lt_mod.sample_li(lt, geom, idx, p, u, uc)
            cos_l = vm.dot(ls.wi, n)
            occ = st.intersect_p(geom, common.shadow_ray(
                p, n, n, ls.wi, ls.dist, eps))
            ok = (~occ) & (ls.pdf > 0) & (cos_l > 0)
            contrib = ls.li * (cos_l / ls.pdf.clamp_min(1e-20))
            E = E + vm.to_arr(vm.where3(ok, contrib, 0.0))
    return (E / n_samples).cpu().numpy()


@dataclasses.dataclass
class IrradiancePoints:
    p: torch.Tensor             # (P, 3)
    E_times_area: torch.Tensor  # (P, 3)
    n: int


def prepare(scene, sp, n_samples: int = 4, seed: int = 9,
            device=device_mod.DEFAULT) -> IrradiancePoints:
    """The irradiance points of surface points `sp` on `device`."""
    scene = st.to_device(scene, device)
    dev = scene.geometry.mat_id.device
    E = compute_irradiances(scene, sp, n_samples, seed)
    return IrradiancePoints(
        p=torch.from_numpy(np.ascontiguousarray(sp.p)).to(dev),
        E_times_area=torch.from_numpy(E * sp.area[:, None]).to(dev),
        n=int(sp.p.shape[0]))


def mo(ip: IrradiancePoints, q, sigma_prime_s, sigma_a, eta: float,
       chunk: int = 1024):
    """Mo(q) = sum_i Rd(|q - p_i|^2) E_i A_i for q (R, 3): the points in
    blocks of `chunk` (the last padded at 1e30), the lanes in blocks of
    MO_BUDGET // chunk."""
    P = ip.p.shape[0]
    r, dev = q.shape[0], q.device
    n_chunks = max((P + chunk - 1) // chunk, 1)
    pad = n_chunks * chunk - P
    pp = torch.cat([ip.p, torch.full((pad, 3), 1e30, device=dev)])
    ee = torch.cat([ip.E_times_area, torch.zeros((pad, 3), device=dev)])
    lanes = max(1, MO_BUDGET // chunk)
    out = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    for l0 in range(0, r, lanes):
        ql = q[l0:l0 + lanes]
        acc = torch.zeros((ql.shape[0], 3), dtype=torch.float32, device=dev)
        for s in range(0, n_chunks * chunk, chunk):
            d2 = ((ql[:, None, :] - pp[None, s:s + chunk, :]) ** 2).sum(-1)
            rd = dipole_rd(d2, sigma_prime_s, sigma_a, eta)   # (R, C, 3)
            acc = acc + torch.einsum("rcs,cs->rs", rd, ee[s:s + chunk])
        out[l0:l0 + lanes] = acc
    return out


@torch.no_grad()
def li(ig: DipoleSubsurfaceIntegrator, scene: st.CompiledScene, rays, diffs,
       sctx, ip: IrradiancePoints, sigma_prime_s=None, sigma_a=None,
       sss_mask=None):
    """The dipole term on subsurface materials (`sss_mask`, (M,) bool by
    material id; None: every material), emission and MIS direct light.
    sigma_prime_s / sigma_a: the medium, (3,) tensors (None: skin1)."""
    geom = scene.geometry
    lt = scene.lights
    r, dev = rays.n, rays.tmin.device
    if sigma_prime_s is None:
        sigma_prime_s, sigma_a = (torch.from_numpy(x).to(dev)
                                  for x in media_params("skin1"))
    L = vm.v3zeros((r,), dev)
    hits = st.intersect(geom, rays)
    hit = hits.hit
    if lt is not None and lt.env_light_index >= 0:
        L = L + vm.where3(hit, 0.0, lt_mod.env_le(lt, rays.d))
    it = st.interaction(geom, rays, hits)
    frame = bx.make_frame(it["ns"], it["dpdu"], it["ng"])
    params = mat_mod.eval_params(scene.materials, it["mat_id"],
                                 scene.textures, it)
    wo = it["wo"]
    mo_v = vm.from_arr(mo(ip, vm.to_arr(it["p"]),
                          sigma_prime_s * ig.scale, sigma_a * ig.scale,
                          ig.eta))
    cos_o = vm.absdot(wo, frame.n)
    ft = 1.0 - bx.fr_dielectric(cos_o, torch.full((r,), ig.eta,
                                                  device=dev))
    use_sss = hit
    if sss_mask is not None:
        use_sss = use_sss & sss_mask[it["mat_id"].long()]
    L = L + vm.where3(use_sss, mo_v * (ft * INV_PI), 0.0)
    if lt is not None:
        le = lt_mod.le_emitted(lt, geom, hits.prim, wo, it["ns"])
        L = L + vm.where3(hit, le, 0.0)
    if lt is not None and lt.n > 0:
        sd = lambda d: smp_mod.sample_1d(sctx["sampler"], sctx["px"],  # noqa
                                         sctx["py"], sctx["s_idx"], d)
        sd2 = lambda d: smp_mod.sample_2d(sctx["sampler"], sctx["px"],  # noqa
                                          sctx["py"], sctx["s_idx"], d)
        ld = common.uniform_sample_one_light(
            scene, it, frame, params, wo, sd(5), sd2(6), sd(8), sd2(9),
            sd(11))
        L = L + vm.where3(hit, ld, 0.0)
    return L
