"""SceneBuilder: host-side assembly of meshes, materials and lights into a
CompiledScene (counterpart of the JAX reference's ``scene/build.py``)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import lights as lt_mod
from .. import materials as mat_mod
from ..core import transform as tr
from . import mesh as mesh_mod
from . import types as st


class SceneBuilder:
    def __init__(self):
        self.meshes: List[mesh_mod.TriangleMesh] = []
        self.mat_rows: List[dict] = []
        self.mesh_mat: List[int] = []
        self.mesh_area_light: List[Optional[tuple]] = []  # (L, n_samples)
        self.light_specs: List[lt_mod.LightSpec] = []
        self.volume = None
        self.textures = None
        self.shutter = (0.0, 1.0)

    def add_material(self, row: dict) -> int:
        self.mat_rows.append(row)
        return len(self.mat_rows) - 1

    def add_mesh(self, mesh: mesh_mod.TriangleMesh, mat_id: int,
                 area_light_L=None, n_samples=1):
        self.meshes.append(mesh)
        self.mesh_mat.append(mat_id)
        self.mesh_area_light.append(
            None if area_light_L is None else (tuple(area_light_L),
                                               n_samples))
        return len(self.meshes) - 1

    def add_light(self, spec: lt_mod.LightSpec):
        self.light_specs.append(spec)

    def build(self, split_method="sah",
              accelerator="bvh") -> st.CompiledScene:
        """Compile to a host (numpy-leaved) CompiledScene; move it with
        ``scene.types.to_device`` (``render`` does)."""
        if not self.mat_rows:
            self.mat_rows.append(mat_mod.matte())
        # area lights: assign light ids per emissive mesh, record tri ranges
        specs = list(self.light_specs)
        light_ids = []
        face_off = 0
        for m, al in zip(self.meshes, self.mesh_area_light):
            if al is not None:
                L, ns = al
                areas = m.face_areas()
                specs.append(lt_mod.area_light(face_off, areas, L=L,
                                               n_samples=ns))
                light_ids.append(len(specs) - 1)
            else:
                light_ids.append(-1)
            face_off += m.n_faces
        geom = st.compile_geometry(self.meshes, self.mesh_mat, light_ids,
                                   split_method=split_method,
                                   accelerator=accelerator,
                                   textures=self.textures,
                                   shutter=self.shutter)
        wb = np.asarray(geom.world_bound)
        radius = float(np.linalg.norm(wb[1] - wb[0]) * 0.5) or 10.0
        lt = lt_mod.build_table(specs, scene_radius=radius, attr=geom.attr)
        mats = mat_mod.build_table(self.mat_rows)
        return st.CompiledScene(geometry=geom, materials=mats, lights=lt,
                                volume=self.volume, textures=self.textures)


def cornell_box(light_scale=15.0, sphere_material=None,
                sphere2_material=None):
    """Programmatic Cornell-box fixture (area light in the ceiling, colored
    side walls, a matte and a mirror sphere)."""
    b = SceneBuilder()
    white = b.add_material(mat_mod.matte(kd=(0.73, 0.73, 0.73)))
    red = b.add_material(mat_mod.matte(kd=(0.63, 0.065, 0.05)))
    green = b.add_material(mat_mod.matte(kd=(0.14, 0.45, 0.091)))
    light_m = b.add_material(mat_mod.matte(kd=(0.0, 0.0, 0.0)))

    def quad(p0, p1, p2, p3):
        return mesh_mod.make_mesh([p0, p1, p2, p3], [[0, 1, 2], [0, 2, 3]])

    s = 1.0
    # floor / ceiling / back / left(red) / right(green); normals irrelevant
    # (matte is two-sided via the shading-frame side tests)
    b.add_mesh(quad([-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]), white)
    b.add_mesh(quad([-s, 2, -s], [-s, 2, s], [s, 2, s], [s, 2, -s]), white)
    b.add_mesh(quad([-s, 0, s], [s, 0, s], [s, 2, s], [-s, 2, s]), white)
    b.add_mesh(quad([-s, 0, -s], [-s, 0, s], [-s, 2, s], [-s, 2, -s]), red)
    b.add_mesh(quad([s, 0, -s], [s, 2, -s], [s, 2, s], [s, 0, s]), green)
    # ceiling light quad (slightly below the ceiling), wound so that the
    # geometric normal points DOWN into the box (emission is one-sided)
    ls = 0.4
    b.add_mesh(quad([-ls, 1.995, -ls], [ls, 1.995, -ls], [ls, 1.995, ls],
                    [-ls, 1.995, ls]), light_m,
               area_light_L=(light_scale,) * 3)
    m1 = sphere_material if sphere_material is not None else \
        b.add_material(mat_mod.matte(kd=(0.6, 0.6, 0.6)))
    m2 = sphere2_material if sphere2_material is not None else \
        b.add_material(mat_mod.mirror())
    sph1 = mesh_mod.sphere(radius=0.35, nu=32, nv=16).transformed(
        np.asarray(tr.translate([-0.4, 0.35, 0.2]).m))
    sph2 = mesh_mod.sphere(radius=0.35, nu=32, nv=16).transformed(
        np.asarray(tr.translate([0.45, 0.35, -0.3]).m))
    b.add_mesh(sph1, m1)
    b.add_mesh(sph2, m2)
    return b


def bench_scene(n_tris_target=100_000):
    """The benchmark scene family: a ~n_tris_target-triangle displaced sphere
    (matte), a glass sphere, a matte floor and a diffuse area light
    overhead. Returns the SceneBuilder."""
    b = SceneBuilder()
    gray = b.add_material(mat_mod.matte(kd=(0.6, 0.6, 0.6)))
    floor_m = b.add_material(mat_mod.matte(kd=(0.4, 0.4, 0.45)))
    glass_m = b.add_material(mat_mod.glass())
    dark = b.add_material(mat_mod.matte(kd=(0.0, 0.0, 0.0)))

    nu = int(np.sqrt(n_tris_target / 2 * (2.0)))  # nu = 2*nv grid
    nv = max(nu // 2, 8)
    m = mesh_mod.sphere(radius=1.0, nu=nu, nv=nv)
    v = m.verts.astype(np.float64)
    # multi-frequency displacement (keeps the BVH non-trivial)
    disp = (0.08 * np.sin(7 * v[:, 0]) * np.cos(5 * v[:, 1])
            + 0.05 * np.sin(11 * v[:, 2] + 3 * v[:, 0]))
    n = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    m.verts = (v + n * disp[:, None]).astype(np.float32)
    m.normals = None
    m = m.transformed(np.asarray(tr.translate([-0.4, 1.05, 0.2]).m))
    b.add_mesh(m, gray)

    sph = mesh_mod.sphere(radius=0.5, nu=64, nv=32).transformed(
        np.asarray(tr.translate([1.2, 0.5, -0.6]).m))
    b.add_mesh(sph, glass_m)

    b.add_mesh(mesh_mod.make_mesh(
        [[-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6]],
        [[0, 1, 2], [0, 2, 3]]), floor_m)
    # area light overhead (wound to emit downward)
    b.add_mesh(mesh_mod.make_mesh(
        [[-1, 4, -1], [1, 4, -1], [1, 4, 1], [-1, 4, 1]],
        [[0, 1, 2], [0, 2, 3]]), dark, area_light_L=(12.0,) * 3)
    return b
