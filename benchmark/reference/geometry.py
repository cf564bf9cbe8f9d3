"""The reference's scene tables and its ray-triangle queries, in plain torch.

``Scene.from_meshes`` takes the explicit triangle meshes a configuration
makes (the very arrays the program is handed) and derives every per-face
quantity itself: Moeller-Trumbore edges, geometric normals, corner normals,
uv corners and dp/du, material and light ids, the area lights' tables.

The queries test the triangles directly. To keep that affordable at full
width the faces of each mesh are grouped into runs of ``CLUSTER`` faces
along a Morton curve of their centroids, each run under its bounding box:
a ray tests the faces of every run whose box it enters inside [tmin, tmax],
and nothing else. No tree, no traversal order: the nearest accepted hit
over all tested faces wins, the lowest face id on a tie. The acceptance
rule is the program's documented one: t in (tmin, tmax], barycentrics
inside [-1e-6, 1 + 1e-6], |det| >= 1e-10; a ray with tmax < tmin is dead.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

CLUSTER = 64
TRI_EPS = 1e-10
BARY_EPS = 1e-6
RAY_CHUNK = 8192


def dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)


def normalize(v):
    return v * torch.rsqrt(dot(v, v).clamp_min(1e-30))[:, None]


def face_forward(n, v):
    return torch.where((dot(n, v) < 0.0)[:, None], -n, n)


@dataclasses.dataclass
class Mesh:
    """One shape as the configuration makes it: float32 world-space verts,
    int32 faces, optional per-vertex normals and uvs, its material's name
    and, for an emitter, its radiance."""
    verts: np.ndarray
    faces: np.ndarray
    material: str
    normals: np.ndarray = None
    uvs: np.ndarray = None
    light_L: tuple = None


def _morton(c):
    lo, hi = c.min(0), c.max(0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249
    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


class Scene:
    """Per-face tables (torch, on `device`, in `dtype`) and the material and
    light tables of a configuration."""

    def __init__(self, meshes, materials, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        names = list(materials)
        v0s, e1s, e2s, vns, uvs, mids, lids, clusters = [], [], [], [], [], \
            [], [], []
        lights = []
        off = 0
        for m in meshes:
            v = np.asarray(m.verts, np.float32)
            f = np.asarray(m.faces, np.int64)
            p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
            e1, e2 = p1 - p0, p2 - p0
            n_f = f.shape[0]
            if m.normals is not None:
                nn = np.asarray(m.normals, np.float32)
                vn = np.stack([nn[f[:, k]] for k in range(3)], 1)
            else:
                g = np.cross(e1.astype(np.float64), e2.astype(np.float64))
                g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True),
                                1e-20)
                vn = np.repeat(g[:, None, :], 3, 1)
            if m.uvs is not None:
                uu = np.asarray(m.uvs, np.float32)
                uv = np.stack([uu[f[:, k]] for k in range(3)], 1)
            else:
                uv = np.broadcast_to(np.asarray([[0, 0], [1, 0], [1, 1]],
                                                np.float32), (n_f, 3, 2))
            lid = -1
            if m.light_L is not None:
                area = 0.5 * np.linalg.norm(np.cross(e1.astype(np.float64),
                                                     e2.astype(np.float64)),
                                            axis=-1)
                lid = len(lights)
                lights.append((off, n_f, area, tuple(m.light_L)))
            v0s.append(p0)
            e1s.append(e1)
            e2s.append(e2)
            vns.append(vn.astype(np.float32))
            uvs.append(uv.astype(np.float32))
            mids.append(np.full(n_f, names.index(m.material), np.int64))
            lids.append(np.full(n_f, lid, np.int64))
            order = np.argsort(_morton(p0 + (e1 + e2) / 3.0), kind="stable")
            for c0 in range(0, n_f, CLUSTER):
                clusters.append(off + order[c0:c0 + CLUSTER])
            off += n_f
        v0 = np.concatenate(v0s)
        e1 = np.concatenate(e1s)
        e2 = np.concatenate(e2s)
        vn = np.concatenate(vns)
        uv = np.concatenate(uvs)
        self.n_faces = off
        dev, dt = self.device, dtype
        T = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        self.v0, self.e1, self.e2 = T(v0).to(dt), T(e1).to(dt), T(e2).to(dt)
        ng = np.cross(e1.astype(np.float64), e2.astype(np.float64))
        ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
        self.ng = T(ng).to(dt)
        self.vn = T(vn).to(dt)                       # (F, 3 corners, 3)
        self.uv = T(uv).to(dt)                       # (F, 3 corners, 2)
        self.dpdu = T(_dpdu(e1.astype(np.float64), e2.astype(np.float64),
                            uv.astype(np.float64), ng)).to(dt)
        self.mat_id = T(np.concatenate(mids))
        self.light_id = T(np.concatenate(lids))
        # the clusters: face ids padded with -1, their boxes
        n_c = len(clusters)
        ids = np.full((n_c, CLUSTER), -1, np.int64)
        lo = np.zeros((n_c, 3), np.float32)
        hi = np.zeros((n_c, 3), np.float32)
        corners = np.stack([v0, v0 + e1, v0 + e2], 1)
        for i, c in enumerate(clusters):
            ids[i, :len(c)] = c
            pts = corners[c].reshape(-1, 3)
            lo[i], hi[i] = pts.min(0), pts.max(0)
        self.c_ids = T(ids)
        self.c_lo, self.c_hi = T(lo).to(dt), T(hi).to(dt)
        # materials
        rows = [materials[n] for n in names]
        self.materials = {
            "kind": [r["type"] for r in rows],
            "kd": T(np.asarray([r.get("kd", (0, 0, 0)) for r in rows],
                               np.float32)).to(dt),
            "kr": T(np.asarray([r.get("kr", (0, 0, 0)) for r in rows],
                               np.float32)).to(dt),
            "kt": T(np.asarray([r.get("kt", (0, 0, 0)) for r in rows],
                               np.float32)).to(dt),
            "eta": T(np.asarray([r.get("index", 1.5) for r in rows],
                                np.float32)).to(dt),
        }
        self.material_names = names
        # area lights: face range, area CDF, radiance
        self.lights = []
        for (o, n, area, L) in lights:
            cdf = np.concatenate([[0.0], np.cumsum(area)])
            total = cdf[-1]
            self.lights.append({
                "first": o, "count": n, "total_area": float(total),
                "cdf": T(cdf / max(total, 1e-20)).to(dt),
                "L": T(np.asarray(L, np.float32)).to(dt)})
        self.light_L = (torch.stack([li["L"] for li in self.lights])
                        if self.lights else None)


def _dpdu(e1, e2, uv, ng):
    """dp/du of each face from its uv corners; where the uv parametrisation
    is degenerate, a tangent perpendicular to the geometric normal."""
    duv1 = uv[:, 1] - uv[:, 0]
    duv2 = uv[:, 2] - uv[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    degen = np.abs(det) < 1e-12
    inv = 1.0 / np.where(degen, 1.0, det)
    dpdu = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv[:, None]
    x, y, z = ng[:, 0], ng[:, 1], ng[:, 2]
    big_x = np.abs(x) > np.abs(y)
    inv_a = 1.0 / np.sqrt(np.maximum(
        np.where(big_x, x * x + z * z, y * y + z * z), 1e-30))
    cu = np.where(big_x[:, None],
                  np.stack([-z * inv_a, np.zeros_like(x), x * inv_a], -1),
                  np.stack([np.zeros_like(x), z * inv_a, -y * inv_a], -1))
    return np.where(degen[:, None], cu, dpdu)


def _safe_inv(d):
    tiny = torch.where(d < 0, -1e-30, 1e-30).to(d.dtype)
    return 1.0 / torch.where(torch.abs(d) < 1e-30, tiny, d)


def _mt(o, d, v0, e1, e2):
    """Moeller-Trumbore over matching rows: (t, u, v, ok-before-t-test)."""
    p = cross(d, e2)
    det = dot(e1, p)
    flat = torch.abs(det) < TRI_EPS
    inv_det = 1.0 / torch.where(flat, torch.ones_like(det), det)
    tv = o - v0
    u = dot(tv, p) * inv_det
    q = cross(tv, e1)
    v = dot(d, q) * inv_det
    t = dot(e2, q) * inv_det
    ok = (~flat) & (u >= -BARY_EPS) & (v >= -BARY_EPS) & (
        (u + v) <= 1.0 + BARY_EPS)
    return t, u, v, ok


def _candidates(sc: Scene, o, d, tmin, tmax):
    """(ray, cluster) pairs whose box the ray enters inside [tmin, tmax]."""
    inv = _safe_inv(d)
    t0 = (sc.c_lo[None] - o[:, None]) * inv[:, None]
    t1 = (sc.c_hi[None] - o[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    tn = torch.maximum(tn, tmin[:, None])
    tf = torch.minimum(tf, tmax[:, None])
    live = (tmax >= tmin)[:, None]
    return torch.nonzero((tn <= tf) & live, as_tuple=True)


@torch.no_grad()
def closest(sc: Scene, o, d, tmin, tmax):
    """Nearest accepted hit of each ray: (t, face, b1, b2), face -1 and t
    inf on a miss."""
    n = o.shape[0]
    dev = o.device
    t_out = torch.full((n,), float("inf"), dtype=o.dtype, device=dev)
    f_out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for a in range(0, n, RAY_CHUNK):
        b = min(a + RAY_CHUNK, n)
        oc, dc, t0, t1 = o[a:b], d[a:b], tmin[a:b], tmax[a:b]
        r, c = _candidates(sc, oc, dc, t0, t1)
        if r.numel() == 0:
            continue
        fid = sc.c_ids[c]                                  # (P, C)
        rr = r[:, None].expand_as(fid).reshape(-1)
        ff = fid.reshape(-1)
        keep = ff >= 0
        rr, ff = rr[keep], ff[keep]
        t, _, _, ok = _mt(oc[rr], dc[rr], sc.v0[ff], sc.e1[ff], sc.e2[ff])
        ok = ok & (t > t0[rr]) & (t <= t1[rr])
        rr, ff, t = rr[ok], ff[ok], t[ok]
        best = torch.full((b - a,), float("inf"), dtype=o.dtype, device=dev)
        best = best.scatter_reduce(0, rr, t, "amin")
        win = t == best[rr]
        face = torch.full((b - a,), 1 << 62, dtype=torch.int64, device=dev)
        face = face.scatter_reduce(0, rr[win], ff[win], "amin")
        hit = face < (1 << 62)
        t_out[a:b] = torch.where(hit, best, t_out[a:b])
        f_out[a:b] = torch.where(hit, face, -1)
    hit = f_out >= 0
    fc = f_out.clamp_min(0)
    t, u, v, _ = _mt(o, d, sc.v0[fc], sc.e1[fc], sc.e2[fc])
    zero = torch.zeros_like(u)
    return (torch.where(hit, t, float("inf")), f_out,
            torch.where(hit, u, zero), torch.where(hit, v, zero))


@torch.no_grad()
def occluded(sc: Scene, o, d, tmin, tmax):
    """True where any face is hit at t in (tmin, tmax]."""
    n = o.shape[0]
    out = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for a in range(0, n, RAY_CHUNK):
        b = min(a + RAY_CHUNK, n)
        oc, dc, t0, t1 = o[a:b], d[a:b], tmin[a:b], tmax[a:b]
        r, c = _candidates(sc, oc, dc, t0, t1)
        if r.numel() == 0:
            continue
        fid = sc.c_ids[c]
        rr = r[:, None].expand_as(fid).reshape(-1)
        ff = fid.reshape(-1)
        keep = ff >= 0
        rr, ff = rr[keep], ff[keep]
        t, _, _, ok = _mt(oc[rr], dc[rr], sc.v0[ff], sc.e1[ff], sc.e2[ff])
        ok = ok & (t > t0[rr]) & (t <= t1[rr])
        hit = torch.zeros((b - a,), dtype=torch.int64, device=o.device)
        hit = hit.scatter_reduce(0, rr, ok.to(torch.int64), "amax")
        out[a:b] = hit > 0
    return out
