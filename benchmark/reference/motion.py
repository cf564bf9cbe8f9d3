"""The reference's moving scene, its ray-triangle queries at each ray's
shutter time, and ambient occlusion over it, in plain torch.

What it reproduces: the motion blur of pbrt-v2's ``anim-bluespheres.pbrt``
(which DartRay ships under ``web/scenes/``): a shape translated by an
``ActiveTransform StartTime`` / ``EndTime`` pair over a camera shutter,
each camera sample at its own time in the shutter, every ray spawned from
it at the same time. Departures from pbrt-v2, each the program's
documented behaviour:

* pbrt-v2 moves a shape by an ``AnimatedTransform`` (a decomposed
  translation, rotation and scale, interpolated) around its object-space
  intersection; here each shape's vertices are given at shutter open and
  close and a triangle's corners lerp between them per ray (v0 + t dv0,
  e1 + t de1, e2 + t de2, a multiply and then an add). For a translation
  the two are the same motion.
* The hit point is o + t d on the lerped triangle; the shading normals,
  the geometric normal, uv and dp/du stay at shutter open (the program's
  known behaviour c). For a translation the normals are the same at every
  time.
* The camera sample's time is the sampler's dimension 4 (after the image
  sample's 0-1 and the lens's 2-3), mapped to the shutter as open +
  u (close - open), and normalised back to [0, 1] for the lerp; every AO
  probe takes its camera ray's time.

The queries test the lerped triangles directly, as ``geometry.py`` tests
the static ones: runs of ``geometry.CLUSTER`` faces along a Morton curve
of their shutter-open centroids, each under the union of its boxes at
shutter open and close (padded by ``BOX_PAD``), which holds every
lerped position of a translating triangle. A ray tests the faces of every
run whose box it enters inside [tmin, tmax]; the nearest accepted hit
wins, the lowest face id on a tie; the acceptance rule is
``geometry.py``'s.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import geometry as g
from . import integrators as ig
from . import sampling as smp
from . import shading as sh

INF = float("inf")
TIME_DIM = 4             # samplers.camera_samples: image 0-1, lens 2-3, time 4
BOX_PAD = 1e-4           # world units added to each side of a run's box


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products in float32 (not TF32) inside the context;
    the flags are restored after."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class Scene(g.Scene):
    """``geometry.Scene`` at shutter open, with per-face deltas to shutter
    close (``dv0``, ``de1``, ``de2``: close less open of the Moeller-Trumbore
    corner and edges, float32 arithmetic on the configuration's arrays) and
    run boxes that are the union over the shutter. ``verts_end[i]`` is mesh
    i's vertices at shutter close, None for a static mesh."""

    def __init__(self, meshes, verts_end, materials, shutter, device,
                 dtype=torch.float32):
        super().__init__(meshes, materials, device, dtype)
        self.shutter = (float(shutter[0]), float(shutter[1]))
        dv0, de1, de2, q = [], [], [], []
        for m, ve in zip(meshes, verts_end):
            v = np.asarray(m.verts, np.float32)
            ve = v if ve is None else np.asarray(ve, np.float32)
            f = np.asarray(m.faces, np.int64)
            p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
            q0, q1, q2 = ve[f[:, 0]], ve[f[:, 1]], ve[f[:, 2]]
            dv0.append(q0 - p0)
            de1.append((q1 - q0) - (p1 - p0))
            de2.append((q2 - q0) - (p2 - p0))
            q.append(np.stack([q0, q1, q2], 1))
        T = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                      device=self.device).to(dtype)
        self.dv0 = T(np.concatenate(dv0))
        self.de1 = T(np.concatenate(de1))
        self.de2 = T(np.concatenate(de2))
        # each run's box, grown by its faces' corners at shutter close
        ends = np.concatenate(q)                       # (F, 3 corners, 3)
        ids = self.c_ids.cpu().numpy()
        lo = self.c_lo.float().cpu().numpy()
        hi = self.c_hi.float().cpu().numpy()
        for i in range(ids.shape[0]):
            c = ids[i][ids[i] >= 0]
            pts = ends[c].reshape(-1, 3)
            lo[i] = np.minimum(lo[i], pts.min(0))
            hi[i] = np.maximum(hi[i], pts.max(0))
        self.c_lo = T(lo - BOX_PAD)
        self.c_hi = T(hi + BOX_PAD)

    def time01(self, u):
        """The camera sample's shutter time from its uniform number u, and
        that time normalised to [0, 1] for the lerp (clamped)."""
        a, b = self.shutter
        time = a + u * (b - a)
        return ((time - a) / max(b - a, 1e-9)).clamp(0.0, 1.0)


def _lerped(sc: Scene, ff, tt):
    """Corner and edges of faces `ff`, each at its lane's time `tt`."""
    w = tt[:, None]
    return (sc.v0[ff] + w * sc.dv0[ff], sc.e1[ff] + w * sc.de1[ff],
            sc.e2[ff] + w * sc.de2[ff])


def _tests(sc: Scene, oc, dc, t0, t1, tc):
    """The accepted (ray, face, t) of a chunk of rays at their times."""
    r, c = g._candidates(sc, oc, dc, t0, t1)
    if r.numel() == 0:
        return None
    fid = sc.c_ids[c]                                   # (P, C)
    rr = r[:, None].expand_as(fid).reshape(-1)
    ff = fid.reshape(-1)
    keep = ff >= 0
    rr, ff = rr[keep], ff[keep]
    t, _, _, ok = g._mt(oc[rr], dc[rr], *_lerped(sc, ff, tc[rr]))
    ok = ok & (t > t0[rr]) & (t <= t1[rr])
    return rr[ok], ff[ok], t[ok]


@torch.no_grad()
def closest(sc: Scene, o, d, tmin, tmax, time):
    """Nearest accepted hit of each ray at its time: (t, face, b1, b2),
    face -1 and t inf on a miss."""
    n = o.shape[0]
    dev = o.device
    t_out = torch.full((n,), INF, dtype=o.dtype, device=dev)
    f_out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for a in range(0, n, g.RAY_CHUNK):
        b = min(a + g.RAY_CHUNK, n)
        got = _tests(sc, o[a:b], d[a:b], tmin[a:b], tmax[a:b], time[a:b])
        if got is None:
            continue
        rr, ff, t = got
        best = torch.full((b - a,), INF, dtype=o.dtype, device=dev)
        best = best.scatter_reduce(0, rr, t, "amin")
        win = t == best[rr]
        face = torch.full((b - a,), 1 << 62, dtype=torch.int64, device=dev)
        face = face.scatter_reduce(0, rr[win], ff[win], "amin")
        hit = face < (1 << 62)
        t_out[a:b] = torch.where(hit, best, t_out[a:b])
        f_out[a:b] = torch.where(hit, face, -1)
    hit = f_out >= 0
    fc = f_out.clamp_min(0)
    t, u, v, _ = g._mt(o, d, *_lerped(sc, fc, time))
    zero = torch.zeros_like(u)
    return (torch.where(hit, t, INF), f_out, torch.where(hit, u, zero),
            torch.where(hit, v, zero))


@torch.no_grad()
def occluded(sc: Scene, o, d, tmin, tmax, time):
    """True where any face, at the ray's time, is hit at t in (tmin,
    tmax]."""
    n = o.shape[0]
    out = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for a in range(0, n, g.RAY_CHUNK):
        b = min(a + g.RAY_CHUNK, n)
        got = _tests(sc, o[a:b], d[a:b], tmin[a:b], tmax[a:b], time[a:b])
        if got is None:
            continue
        rr = got[0]
        hit = torch.zeros((b - a,), dtype=torch.int64, device=o.device)
        hit = hit.scatter_reduce(0, rr, torch.ones_like(rr), "amax")
        out[a:b] = hit > 0
    return out


def interaction(sc: Scene, o, d, t, face, b1, b2):
    """``shading.interaction`` with the hit point on the ray (o + t d):
    every shading attribute at shutter open."""
    it = sh.interaction(sc, o, d, face, b1, b2)
    it["p"] = o + d * t.clamp_max(1e30)[:, None]
    return it


def ambient_occlusion(sc: Scene, cam: sh.Camera, lanes: ig.Lanes,
                      n_samples=64, min_dist=1e-4, max_dist=INF):
    """``integrators.ambient_occlusion`` over the moving scene: the camera
    ray and its ``n_samples`` hemisphere probes at the camera sample's
    time; the same probe directions, origins and count of clear probes."""
    o, d = ig.camera_rays(cam, lanes)
    n = o.shape[0]
    dt = lanes.dtype
    dev = o.device
    time = sc.time01(lanes.u1(TIME_DIM))
    z = torch.zeros((n,), dtype=dt, device=dev)
    t, f, b1, b2 = closest(sc, o, d, z, torch.full_like(z, INF), time)
    hit = f >= 0
    it = interaction(sc, o, d, t, f, b1, b2)
    nrm = g.face_forward(it["ns"], it["wo"])
    base = smp.hash_u32(smp.u32(lanes.px) ^ (smp.u32(lanes.py) << 16)
                        ^ smp.hash_u32(smp.u32(lanes.s)))
    sx = smp.hash_u32(base ^ 0x1234567)
    sy = smp.hash_u32(base ^ 0x89abcdef)
    eps = sh.ray_epsilon(t)
    org = it["p"] + g.face_forward(it["ng"], nrm) * eps[:, None]
    n_bits = max(int(n_samples - 1).bit_length(), 1)
    clear = torch.zeros((n,), dtype=dt, device=dev)
    tmin = torch.full((n,), min_dist, dtype=dt, device=dev)
    tmax = torch.full((n,), max_dist, dtype=dt, device=dev)
    idx = torch.nonzero(hit).squeeze(1)
    for i in range(n_samples):
        ii = torch.full((n,), i, dtype=torch.int64, device=dev)
        ux, uy = smp.sample02(ii, sx, sy, n_bits)
        ux, uy = ux.to(dt), uy.to(dt)
        zc = 1.0 - 2.0 * ux
        r = torch.sqrt((1.0 - zc * zc).clamp_min(0.0))
        phi = 2.0 * torch.pi * uy
        w = torch.stack([r * torch.cos(phi), r * torch.sin(phi), zc], -1)
        w = g.face_forward(w, nrm)
        occ = torch.zeros((n,), dtype=torch.bool, device=dev)
        if idx.numel():
            occ[idx] = occluded(sc, org[idx], w[idx], tmin[idx], tmax[idx],
                                time[idx])
        clear = clear + (hit & ~occ).to(dt)
    ao = clear / n_samples
    return torch.where(hit[:, None], ao[:, None].expand(n, 3),
                       torch.zeros((n, 3), dtype=dt, device=dev))
