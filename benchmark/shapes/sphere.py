"""A sphere as the latitude-longitude grid of ``nu`` x ``nv`` quads (two
triangles each) with per-vertex normals and uvs, as the port's and pbrt's
sphere tessellation lays it out (frozen copy of
``dartray_tpu_torch/scene/mesh.py::sphere`` / ``_grid_mesh``).

Keys: ``radius``; ``nu`` and ``nv``, or ``n_tris_target`` (nu =
int(sqrt(n)), nv = max(nu // 2, 8)); ``displacement: "bench"`` moves every
vertex along its radius by 0.08 sin(7x) cos(5y) + 0.05 sin(11z + 3x) and
drops the normals (frozen copy of ``bench.py:36-72``, the project's
benchmark mesh).
"""
import numpy as np


def _grid(fn, nu, nv):
    us = np.linspace(0.0, 1.0, nu + 1)
    vs = np.linspace(0.0, 1.0, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    p, n = fn(uu.reshape(-1), vv.reshape(-1))
    i = np.arange(nu)[:, None]
    j = np.arange(nv)[None, :]
    a = i * (nv + 1) + j
    b = (i + 1) * (nv + 1) + j
    faces = np.stack([np.stack([a, b, b + 1], -1),
                      np.stack([a, b + 1, a + 1], -1)], 2).reshape(-1, 3)
    uv = np.stack([uu, vv], -1).reshape(-1, 2)
    return (p.astype(np.float32), faces.astype(np.int32),
            n.astype(np.float32), uv.astype(np.float32))


def sphere(radius, nu, nv):
    r = float(radius)

    def fn(u, v):
        phi = u * np.radians(360.0)
        # theta from pi (z = -r, v = 0) down to 0 (z = +r, v = 1)
        theta = np.arccos(-1.0) + v * (np.arccos(1.0) - np.arccos(-1.0))
        st = np.sin(theta)
        p = np.stack([r * st * np.cos(phi), r * st * np.sin(phi),
                      r * np.cos(theta)], -1)
        return p, p / r
    return _grid(fn, nu, nv)


def bench_displacement(v):
    """bench.py's multi-frequency displacement of a unit sphere's verts."""
    v = v.astype(np.float64)
    disp = (0.08 * np.sin(7 * v[:, 0]) * np.cos(5 * v[:, 1])
            + 0.05 * np.sin(11 * v[:, 2] + 3 * v[:, 0]))
    n = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    return (v + n * disp[:, None]).astype(np.float32)


def make(s):
    if "n_tris_target" in s:
        nu = int(np.sqrt(s["n_tris_target"] / 2 * 2.0))
        nv = max(nu // 2, 8)
    else:
        nu, nv = s["nu"], s["nv"]
    verts, faces, normals, uvs = sphere(s["radius"], nu, nv)
    if s.get("displacement") == "bench":
        verts, normals = bench_displacement(verts), None
    return verts, faces, normals, uvs
