"""Host-side shape refinement: every shape becomes triangles at compile time
(counterpart of the JAX reference's ``scene/mesh.py``, numpy only).

All shapes compile to triangle soup so the traversal kernel is one uniform
slab + Moeller-Trumbore test with no per-type branching on the device. Every
shape a scene file can name has its tessellator here (sphere, cylinder,
disk, cone, paraboloid, hyperboloid, heightfield, Loop subdivision, NURBS),
each a copy of the reference's, so that a parsed scene compiles to the same
triangles bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TriangleMesh:
    """Indexed triangle mesh in *world space* (transform applied at build).

    verts: (V,3) f32; faces: (F,3) i32; normals (V,3) or None (shading
    normals, triangle_mesh.dart 'N'); uvs (V,2) or None ('uv'/'st').
    """
    verts: np.ndarray
    faces: np.ndarray
    normals: Optional[np.ndarray] = None
    uvs: Optional[np.ndarray] = None
    # alpha-mask float-texture id (triangle_mesh.dart 'alpha'); -1 = opaque
    alpha_tid: int = -1
    # shutter-end vertex positions for object motion blur
    # (transformed_primitive.dart:26-60 AnimatedTransform); None = static.
    # Vertices lerp linearly over the shutter (exact for translations,
    # chord approximation of the reference's slerp for rotations).
    verts_end: Optional[np.ndarray] = None

    @property
    def n_faces(self):
        return int(self.faces.shape[0])

    def face_areas(self):
        v = self.verts
        f = self.faces
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    def area(self):
        return float(self.face_areas().sum())

    def transformed(self, m4: np.ndarray) -> "TriangleMesh":
        m4 = np.asarray(m4, np.float64)
        v = self.verts @ m4[:3, :3].T + m4[:3, 3]
        n = self.normals
        if n is not None:
            inv_t = np.linalg.inv(m4[:3, :3]).T
            n = n @ inv_t.T
            ln = np.linalg.norm(n, axis=-1, keepdims=True)
            n = (n / np.maximum(ln, 1e-20)).astype(np.float32)
        # flip winding if the transform swaps handedness so geometric normals
        # stay consistent (transform.dart swapsHandedness / shape.dart
        # reverseOrientation handling)
        faces = self.faces
        if np.linalg.det(m4[:3, :3]) < 0:
            faces = faces[:, [0, 2, 1]]
        ve = self.verts_end
        if ve is not None:
            ve = (ve @ m4[:3, :3].T + m4[:3, 3]).astype(np.float32)
        return TriangleMesh(v.astype(np.float32), faces.astype(np.int32),
                            n, self.uvs, self.alpha_tid, ve)


def make_mesh(verts, faces, normals=None, uvs=None) -> TriangleMesh:
    return TriangleMesh(
        np.asarray(verts, np.float32).reshape(-1, 3),
        np.asarray(faces, np.int32).reshape(-1, 3),
        None if normals is None else np.asarray(normals, np.float32).reshape(-1, 3),
        None if uvs is None else np.asarray(uvs, np.float32).reshape(-1, 2))


def _vertex_normals(m: TriangleMesh) -> np.ndarray:
    v, f = m.verts.astype(np.float64), m.faces
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return n.astype(np.float32)


# --- Parametric tessellators (u-v grid -> quads -> 2 triangles) ------------

def _grid_mesh(fn, nu: int, nv: int, wrap_u=False) -> TriangleMesh:
    """Tessellate p(u,v), u,v in [0,1]. fn returns (P, N) arrays (n,3)."""
    us = np.linspace(0.0, 1.0, nu + 1)
    vs = np.linspace(0.0, 1.0, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")  # (nu+1, nv+1)
    p, n = fn(uu.reshape(-1), vv.reshape(-1))
    verts = p.reshape(nu + 1, nv + 1, 3)
    uv = np.stack([uu, vv], axis=-1)
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * (nv + 1) + j
            b = (i + 1) * (nv + 1) + j
            faces.append([a, b, b + 1])
            faces.append([a, b + 1, a + 1])
    return TriangleMesh(verts.reshape(-1, 3).astype(np.float32),
                        np.asarray(faces, np.int32),
                        None if n is None else n.reshape(-1, 3).astype(np.float32),
                        uv.reshape(-1, 2).astype(np.float32))


def sphere(radius=1.0, zmin=None, zmax=None, phi_max_deg=360.0,
           nu=64, nv=32) -> TriangleMesh:
    """Sphere with pbrt clipping params (shapes/sphere.dart:23).

    Parameterization matches the reference: phi in [0, phiMax],
    theta in [thetaMin, thetaMax] from z-clips; u=phi/phiMax,
    v=(theta-thetaMin)/(thetaMax-thetaMin).
    """
    r = float(radius)
    zmin = -r if zmin is None else max(-r, min(float(zmin), r))
    zmax = r if zmax is None else max(-r, min(float(zmax), r))
    if zmin > zmax:
        zmin, zmax = zmax, zmin
    theta_min = float(np.arccos(np.clip(zmin / r, -1, 1)))
    theta_max = float(np.arccos(np.clip(zmax / r, -1, 1)))
    phi_max = float(np.radians(np.clip(phi_max_deg, 0.0, 360.0)))

    def fn(u, v):
        phi = u * phi_max
        theta = theta_min + v * (theta_max - theta_min)
        st = np.sin(theta)
        p = np.stack([r * st * np.cos(phi), r * st * np.sin(phi),
                      r * np.cos(theta)], axis=-1)
        n = p / r
        return p, n

    return _grid_mesh(fn, nu, nv)


def cylinder(radius=1.0, zmin=-1.0, zmax=1.0, phi_max_deg=360.0,
             nu=64, nv=1) -> TriangleMesh:
    """(shapes/cylinder.dart)"""
    r = float(radius)
    phi_max = float(np.radians(np.clip(phi_max_deg, 0.0, 360.0)))

    def fn(u, v):
        phi = u * phi_max
        z = zmin + v * (zmax - zmin)
        p = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)
        n = np.stack([np.cos(phi), np.sin(phi), np.zeros_like(phi)], axis=-1)
        return p, n

    return _grid_mesh(fn, nu, max(nv, 1))


def disk(height=0.0, radius=1.0, inner_radius=0.0, phi_max_deg=360.0,
         nu=64, nv=8) -> TriangleMesh:
    """(shapes/disk.dart)"""
    phi_max = float(np.radians(np.clip(phi_max_deg, 0.0, 360.0)))

    def fn(u, v):
        phi = u * phi_max
        r = radius + v * (inner_radius - radius)  # v=0 outer (disk.dart param)
        p = np.stack([r * np.cos(phi), r * np.sin(phi),
                      np.full_like(phi, height)], axis=-1)
        n = np.broadcast_to(np.array([0.0, 0.0, 1.0]), p.shape).copy()
        return p, n

    return _grid_mesh(fn, nu, nv)


def cone(radius=1.0, height=1.0, phi_max_deg=360.0, nu=64, nv=16) -> TriangleMesh:
    """(shapes/cone.dart): p = ((1-v) r cos, (1-v) r sin, v h)."""
    phi_max = float(np.radians(np.clip(phi_max_deg, 0.0, 360.0)))

    def fn(u, v):
        phi = u * phi_max
        p = np.stack([radius * (1 - v) * np.cos(phi),
                      radius * (1 - v) * np.sin(phi), v * height], axis=-1)
        return p, None

    m = _grid_mesh(fn, nu, nv)
    m.normals = _vertex_normals(m)
    return m


def paraboloid(radius=1.0, zmin=0.0, zmax=1.0, phi_max_deg=360.0,
               nu=64, nv=16) -> TriangleMesh:
    """(shapes/paraboloid.dart): z = zmax * r^2 / radius^2."""
    phi_max = float(np.radians(np.clip(phi_max_deg, 0.0, 360.0)))

    def fn(u, v):
        phi = u * phi_max
        z = zmin + v * (zmax - zmin)
        r = radius * np.sqrt(np.maximum(z / zmax, 0.0))
        p = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)
        return p, None

    m = _grid_mesh(fn, nu, nv)
    m.normals = _vertex_normals(m)
    return m


def hyperboloid(p1=(0.0, 0.0, 0.0), p2=(1.0, 1.0, 1.0), phi_max_deg=360.0,
                nu=64, nv=16) -> TriangleMesh:
    """(shapes/hyperboloid.dart): surface swept by rotating segment p1-p2."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    phi_max = float(np.radians(np.clip(phi_max_deg, 0.0, 360.0)))

    def fn(u, v):
        phi = u * phi_max
        pt = p1[None] * (1 - v[:, None]) + p2[None] * v[:, None]
        x = pt[:, 0] * np.cos(phi) - pt[:, 1] * np.sin(phi)
        y = pt[:, 0] * np.sin(phi) + pt[:, 1] * np.cos(phi)
        p = np.stack([x, y, pt[:, 2]], axis=-1)
        return p, None

    m = _grid_mesh(fn, nu, nv)
    m.normals = _vertex_normals(m)
    return m


def heightfield(nx: int, ny: int, z: np.ndarray) -> TriangleMesh:
    """(shapes/heightfield.dart): (nx*ny) z-values on a [0,1]^2 grid,
    refined to a triangle mesh exactly as the reference does."""
    z = np.asarray(z, np.float64).reshape(ny, nx)
    xs = np.linspace(0.0, 1.0, nx)
    ys = np.linspace(0.0, 1.0, ny)
    xx, yy = np.meshgrid(xs, ys, indexing="xy")
    verts = np.stack([xx, yy, z], axis=-1).reshape(-1, 3)
    uv = np.stack([xx, yy], axis=-1).reshape(-1, 2)
    faces = []
    for j in range(ny - 1):
        for i in range(nx - 1):
            a = j * nx + i
            b = a + 1
            c = a + nx
            d = c + 1
            faces.append([a, b, d])
            faces.append([a, d, c])
    m = TriangleMesh(verts.astype(np.float32), np.asarray(faces, np.int32),
                     None, uv.astype(np.float32))
    m.normals = _vertex_normals(m)
    return m


def loop_subdivide(mesh: TriangleMesh, n_levels: int) -> TriangleMesh:
    """Loop subdivision (shapes/loop_subdivision.dart:379-504), host-side.

    Simplified uniform Loop scheme on a closed/open mesh: edge midpoint rule
    3/8-3/8-1/8-1/8 (interior), vertex rule with beta weights; boundary edges
    use 1/2-1/2 and boundary vertices 3/4,1/8,1/8.
    """
    v = mesh.verts.astype(np.float64)
    f = mesh.faces.astype(np.int64)
    for _ in range(max(0, n_levels)):
        nv = v.shape[0]
        edges = {}
        edge_faces = {}
        for fi, (a, b, c) in enumerate(f):
            for (x, y) in ((a, b), (b, c), (c, a)):
                key = (min(x, y), max(x, y))
                edges.setdefault(key, len(edges))
                edge_faces.setdefault(key, []).append(fi)
        e_keys = list(edges.keys())
        e_pts = np.zeros((len(e_keys), 3))
        # adjacency for vertex rule
        neigh = [set() for _ in range(nv)]
        boundary = [False] * nv
        for (a, b), _idx in edges.items():
            neigh[a].add(b)
            neigh[b].add(a)
        for key, flist in edge_faces.items():
            if len(flist) == 1:
                boundary[key[0]] = True
                boundary[key[1]] = True
        for ei, key in enumerate(e_keys):
            a, b = key
            flist = edge_faces[key]
            if len(flist) == 2:
                opp = []
                for fi in flist:
                    tri = f[fi]
                    opp.append([x for x in tri if x != a and x != b][0])
                e_pts[ei] = 0.375 * (v[a] + v[b]) + 0.125 * (v[opp[0]] + v[opp[1]])
            else:
                e_pts[ei] = 0.5 * (v[a] + v[b])
        new_v = np.zeros_like(v)
        for i in range(nv):
            ns = list(neigh[i])
            k = len(ns)
            if k == 0:
                new_v[i] = v[i]
                continue
            if boundary[i]:
                bn = [j for j in ns if boundary[j]]
                if len(bn) >= 2:
                    new_v[i] = 0.75 * v[i] + 0.125 * (v[bn[0]] + v[bn[1]])
                else:
                    new_v[i] = v[i]
            else:
                beta = (0.1875 if k == 3 else 3.0 / (8.0 * k))
                new_v[i] = (1 - k * beta) * v[i] + beta * v[ns].sum(axis=0)
        new_faces = []
        for (a, b, c) in f:
            eab = edges[(min(a, b), max(a, b))] + nv
            ebc = edges[(min(b, c), max(b, c))] + nv
            eca = edges[(min(c, a), max(c, a))] + nv
            new_faces += [[a, eab, eca], [b, ebc, eab], [c, eca, ebc],
                          [eab, ebc, eca]]
        v = np.concatenate([new_v, e_pts])
        f = np.asarray(new_faces, np.int64)
    m = TriangleMesh(v.astype(np.float32), f.astype(np.int32))
    m.normals = _vertex_normals(m)
    return m


# --- NURBS tessellation (shapes/nurbs.dart) ---------------------------------

def _bspline_basis(t: np.ndarray, knots: np.ndarray, order: int,
                   n_cp: int):
    """Vectorized Cox-de Boor: basis values and first derivatives.

    t: (M,) parameter values; knots: (n_cp + order,). Returns
    (N, dN): each (M, n_cp). Replaces the reference's per-point recursive
    NurbsEvaluate (shapes/nurbs.dart:197-250) with one dynamic-programming
    sweep over degree evaluated for the whole dice grid at once.
    """
    p = order - 1
    knots = np.asarray(knots, np.float64)
    t = np.asarray(t, np.float64)
    m = t.shape[0]
    # clamp params strictly inside the valid span so the half-open interval
    # logic never drops the final sample (KnotOffset analog, nurbs.dart:253)
    t0, t1 = knots[p], knots[n_cp]
    eps = 1e-9 * max(abs(t1 - t0), 1.0)
    tc = np.clip(t, t0, t1 - eps)
    n_b = n_cp + order - 1  # degree-0 interval count
    n0 = ((knots[None, :n_b] <= tc[:, None])
          & (tc[:, None] < knots[None, 1:n_b + 1])).astype(np.float64)
    nd = n0
    nd_prev = None
    for d in range(1, p + 1):
        nd_prev = nd
        ni = nd.shape[1] - 1
        left_den = knots[d:d + ni] - knots[:ni]
        right_den = knots[d + 1:d + 1 + ni] - knots[1:1 + ni]
        with np.errstate(divide="ignore", invalid="ignore"):
            left = np.where(left_den > 0,
                            (tc[:, None] - knots[None, :ni]) / left_den,
                            0.0)
            right = np.where(right_den > 0,
                             (knots[None, d + 1:d + 1 + ni] - tc[:, None])
                             / right_den, 0.0)
        nd = left * nd[:, :ni] + right * nd[:, 1:ni + 1]
    basis = nd[:, :n_cp]
    if p == 0:
        return basis, np.zeros_like(basis)
    # derivative from degree-(p-1) basis
    ni = n_cp
    dl = knots[p:p + ni] - knots[:ni]
    dr = knots[p + 1:p + 1 + ni] - knots[1:1 + ni]
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.where(dl > 0, p / dl, 0.0)
        b = np.where(dr > 0, p / dr, 0.0)
    low = nd_prev[:, :ni]
    high = nd_prev[:, 1:ni + 1]
    dbasis = a[None] * low - b[None] * high
    return basis, dbasis


def nurbs(nu: int, uorder: int, uknots, nv: int, vorder: int, vknots,
          P=None, Pw=None, u0=None, u1=None, v0=None, v1=None,
          diceu: int = 30, dicev: int = 30) -> TriangleMesh:
    """Tessellate a NURBS patch to a TriangleMesh (shapes/nurbs.dart:75-160).

    P: (nu*nv, 3) control points or Pw: (nu*nv, 4) homogeneous. Diced on a
    uniform 30x30 grid like the reference (nurbs.dart:78-79); normals from
    dPdu x dPdv of the rational surface (quotient rule).
    """
    uknots = np.asarray(uknots, np.float64)
    vknots = np.asarray(vknots, np.float64)
    assert uknots.shape[0] == nu + uorder, "uknots must have nu+uorder entries"
    assert vknots.shape[0] == nv + vorder, "vknots must have nv+vorder entries"
    if Pw is None:
        P = np.asarray(P, np.float64).reshape(nv, nu, 3)
        Pw = np.concatenate([P, np.ones((nv, nu, 1))], axis=-1)
    else:
        Pw = np.asarray(Pw, np.float64).reshape(nv, nu, 4)
    u0 = uknots[uorder - 1] if u0 is None else u0
    u1 = uknots[nu] if u1 is None else u1
    v0 = vknots[vorder - 1] if v0 is None else v0
    v1 = vknots[nv] if v1 is None else v1
    us = np.linspace(u0, u1, diceu)
    vs = np.linspace(v0, v1, dicev)
    bu, dbu = _bspline_basis(us, uknots, uorder, nu)    # (U, nu)
    bv, dbv = _bspline_basis(vs, vknots, vorder, nv)    # (V, nv)
    # homogeneous surface A(u,v) = sum_ij bu_i bv_j Pw_ij -> (V, U, 4)
    s = np.einsum("vj,ui,jik->vuk", bv, bu, Pw)
    su = np.einsum("vj,ui,jik->vuk", bv, dbu, Pw)
    sv = np.einsum("vj,ui,jik->vuk", dbv, bu, Pw)
    w = np.maximum(np.abs(s[..., 3:]), 1e-12) * np.sign(
        np.where(s[..., 3:] == 0, 1.0, s[..., 3:]))
    pts = s[..., :3] / w
    dpdu = (su[..., :3] * w - s[..., :3] * su[..., 3:]) / (w * w)
    dpdv = (sv[..., :3] * w - s[..., :3] * sv[..., 3:]) / (w * w)
    nrm = np.cross(dpdu, dpdv)
    nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / np.maximum(nlen, 1e-12)
    uu, vv = np.meshgrid(us, vs, indexing="xy")
    uvs = np.stack([uu, vv], axis=-1).reshape(-1, 2)
    verts = pts.reshape(-1, 3)
    # grid faces with the reference's winding (nurbs.dart:133-144)
    faces = []
    for j in range(dicev - 1):
        for i in range(diceu - 1):
            a = j * diceu + i
            faces.append([a, a + 1, a + diceu + 1])
            faces.append([a, a + diceu + 1, a + diceu])
    m = TriangleMesh(verts.astype(np.float32),
                     np.asarray(faces, np.int32),
                     nrm.reshape(-1, 3).astype(np.float32),
                     uvs.astype(np.float32))
    return m
