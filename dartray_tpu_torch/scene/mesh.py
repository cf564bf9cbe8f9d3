"""Host-side shape refinement: every shape becomes triangles at compile time
(counterpart of the JAX reference's ``scene/mesh.py``, numpy only).

All shapes compile to triangle soup so the traversal kernel is one uniform
slab + Moeller-Trumbore test with no per-type branching on the device. This
slice carries what ``scene/build.py`` and the bench scene use: the mesh type,
``make_mesh``, ``sphere`` and ``transformed``. The other tessellators
(cylinder, disk, cone, paraboloid, hyperboloid, heightfield, subdivision,
nurbs) are not ported yet.
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

