"""Compiled scene: every primitive, material and light flattened to arrays
(counterpart of the JAX reference's ``scene/types.py``).

The host compiler (numpy) turns world-space triangle meshes into one
``CompiledScene`` of plain dataclasses; ``to_device`` moves its leaves to the
device once, at render entry. The device side (``intersect``,
``intersect_p``, ``intersect_pair``, ``interaction``) works on whole
wavefronts of rays.

A mesh with ``verts_end`` makes the scene a moving one: ONE shutter-union BVH
plus per-triangle (close - open) deltas, every traversal carries the rays'
normalised shutter time and the kernel lerps the leaf triangles to it.
Finish vertices are lerped too; shading attributes (normals, uv, ``ng``,
``dpdu``) stay at shutter start, as in the reference.

Not ported yet (each raises ``NotImplementedError``): alpha cut-outs, the grid
and kd-tree accelerators.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import device as device_mod
from ..accel import bvh as bvh_mod
from ..accel import cluster as cluster_mod
from ..accel.traverse import Hits
from ..core import math as vm
from ..ops import traverse_cuda as tc


@dataclasses.dataclass
class Geometry:
    """Triangle soup + packed BVH (binary and wide tables) + per-face
    attribute tables.

    vn: 3 corner V3s of (F,) shading normals (the geometric normal repeated
    when the mesh has none); uv: 3 corner V2s (barycentric default when
    absent). mat_id/light_id: (F,) int32 indices into the material/light
    tables (light_id -1 = not emissive). ``cl`` is the host-side cluster BVH
    the tables were packed from; it stays numpy and is never moved."""
    cl: Any
    packed: tc.PackedBVH
    perm: Any                  # (C*K,) permuted prim id -> original
    attr: Any                  # (F, 48) packed attr rows (_pack_attr)
    # (C*K, 48) PACKED-order combined finish+interaction rows: attr rows
    # permuted to kernel prim order with cols 0-8 replaced by the exact
    # packed soup and col 36 = original prim id bits: ONE gather per
    # closest-hit wave serves both finish_hits_rows and interaction
    attrp: Any
    v0: vm.V3
    e1: vm.V3
    e2: vm.V3
    vn: tuple
    uv: tuple
    mat_id: Any
    light_id: Any
    world_bound: Any           # (2, 3)
    n_prims: int = 0
    n_nodes: int = 0
    has_alpha: bool = False
    has_motion: bool = False
    shutter: tuple = (0.0, 1.0)

    _HOST_FIELDS = ("cl",)

    def to(self, device):
        return to_device(self, device)


@dataclasses.dataclass
class CompiledScene:
    geometry: Geometry
    materials: Any      # materials.MaterialTable or None
    lights: Any         # lights.LightTable or None
    volume: Any         # not ported: must be None
    textures: Any       # textures.TextureData or None

    def to(self, device):
        return to_device(self, device)


def compile_geometry(meshes, mat_ids=None, light_ids=None,
                     split_method="sah", textures=None,
                     shutter=(0.0, 1.0), accelerator="bvh") -> Geometry:
    """meshes: list of TriangleMesh (world space). mat_ids/light_ids:
    per-mesh ints. Returns a host (numpy-leaved) Geometry."""
    if not meshes:
        raise ValueError("empty scene")
    if accelerator != "bvh":
        raise NotImplementedError(
            f"accelerator {accelerator!r}: only the cluster BVH is ported "
            "(ROADMAP Queue 1, alternate accelerators)")
    if any(getattr(m, "alpha_tid", -1) >= 0 for m in meshes):
        raise NotImplementedError(
            "alpha cut-outs are not ported (ROADMAP Queue 1, textures)")
    n_meshes = len(meshes)
    mat_ids = mat_ids if mat_ids is not None else [0] * n_meshes
    light_ids = light_ids if light_ids is not None else [-1] * n_meshes

    v0s, e1s, e2s, vns, uvs, mids, lids = [], [], [], [], [], [], []
    for m, mid, lid in zip(meshes, mat_ids, light_ids):
        v0, e1, e2 = bvh_mod.triangles_to_mt(m.verts, m.faces)
        f = m.faces
        if m.normals is not None:
            vn = np.stack([m.normals[f[:, k]] for k in range(3)], axis=1)
        else:
            gn = np.cross(e1, e2)
            gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
            vn = np.repeat(gn[:, None, :], 3, axis=1)
        if m.uvs is not None:
            uv = np.stack([m.uvs[f[:, k]] for k in range(3)], axis=1)
        else:
            uv = np.broadcast_to(
                np.asarray([[0, 0], [1, 0], [1, 1]], np.float32),
                (f.shape[0], 3, 2)).copy()
        v0s.append(v0)
        e1s.append(e1)
        e2s.append(e2)
        vns.append(vn.astype(np.float32))
        uvs.append(uv.astype(np.float32))
        mids.append(np.full(f.shape[0], mid, np.int32))
        lids.append(np.full(f.shape[0], lid, np.int32))

    v0 = np.concatenate(v0s)
    e1 = np.concatenate(e1s)
    e2 = np.concatenate(e2s)
    # moving geometry: ONE shutter-union BVH + per-triangle (close - open)
    # soup deltas; leaf tests lerp by ray time
    has_motion = any(m.verts_end is not None for m in meshes)
    if has_motion:
        ends = [bvh_mod.triangles_to_mt(
            m.verts if m.verts_end is None else m.verts_end, m.faces)
            for m in meshes]
        cb = cluster_mod.build_motion(
            v0, e1, e2, *(np.concatenate([e[c] for e in ends])
                          for c in range(3)), split_method=split_method)
    else:
        cb = cluster_mod.build(v0, e1, e2, split_method=split_method)
    wb = np.stack([np.asarray(cb.node_lo[0]), np.asarray(cb.node_hi[0])])
    packed, perm = tc.pack(cb.node_lo, cb.node_hi, cb.node_child,
                           cb.node_axis, cb.tri_v0, cb.tri_e1, cb.tri_e2, cb.tri_id,
                           deltas=((cb.tri_dv0, cb.tri_de1, cb.tri_de2)
                                   if has_motion else None))
    vn_all = np.concatenate(vns)          # (F, 3 corners, 3)
    uv_all = np.concatenate(uvs)          # (F, 3 corners, 2)
    mat_all = np.concatenate(mids)
    light_all = np.concatenate(lids)
    alpha_tid = np.full(v0.shape[0], -1, np.int32)
    attr = _pack_attr(v0, e1, e2, vn_all, uv_all, mat_all, light_all,
                      alpha_tid)
    # packed-order combined finish+interaction rows: attr rows reordered to
    # kernel prim ids; cols 0-8 = the EXACT packed soup the kernel leaf-tests
    # (pad slots keep zero edges -> det 0 -> never hit); col 36 = original
    # prim id bits
    attrp = attr[np.maximum(perm, 0)].copy()
    attrp[:, 0:9] = packed.soup16[:, 0:9]
    attrp[:, 36] = np.asarray(perm, np.int32).view(np.float32)
    return Geometry(
        cl=cb, packed=packed, perm=perm, attr=attr, attrp=attrp,
        v0=_v3_of(v0), e1=_v3_of(e1), e2=_v3_of(e2),
        vn=tuple(_v3_of(vn_all[:, k]) for k in range(3)),
        uv=tuple(vm.V2(np.ascontiguousarray(uv_all[:, k, 0]),
                       np.ascontiguousarray(uv_all[:, k, 1]))
                 for k in range(3)),
        mat_id=mat_all, light_id=light_all,
        world_bound=wb.astype(np.float32),
        n_prims=int(v0.shape[0]), n_nodes=cb.n_nodes,
        has_motion=has_motion, shutter=tuple(shutter))


def _v3_of(a):
    """(F, 3) host array -> component-SoA V3 of contiguous (F,) arrays."""
    a = np.asarray(a)
    return vm.V3(np.ascontiguousarray(a[:, 0]),
                 np.ascontiguousarray(a[:, 1]),
                 np.ascontiguousarray(a[:, 2]))


# attr-table column layout (see _pack_attr / attr_rows)
_ATTR_W = 48


def _pack_attr(v0, e1, e2, vn, uv, mat_id, light_id, alpha_tid):
    """Per-face attribute rows (F, 48), host numpy: ONE wide row gather per
    interaction instead of ~26 component gathers.

    cols: 0-8 v0|e1|e2, 9-11 ng, 12-17 dpdu|dpdv (precomputed, with the
    degenerate-uv fallback baked in), 18-26 vn corners, 27-32 uv corners,
    33 mat_id bits, 34 light_id bits, 35 alpha_tid bits."""
    f = v0.shape[0]
    A = np.zeros((f, _ATTR_W), np.float32)
    A[:, 0:3] = v0
    A[:, 3:6] = e1
    A[:, 6:9] = e2
    ng = np.cross(e1, e2)
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    A[:, 9:12] = ng
    duv1 = uv[:, 1] - uv[:, 0]
    duv2 = uv[:, 2] - uv[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    inv = 1.0 / np.where(np.abs(det) < 1e-12, 1.0, det)
    dpdu = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv[:, None]
    dpdv = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv[:, None]
    degen = np.abs(det) < 1e-12
    # coordinate_system(ng) fallback (same branch-free construction)
    x, y, z = ng[:, 0], ng[:, 1], ng[:, 2]
    big_x = np.abs(x) > np.abs(y)
    inv_a = 1.0 / np.sqrt(np.maximum(
        np.where(big_x, x * x + z * z, y * y + z * z), 1e-30))
    cu = np.where(big_x[:, None],
                  np.stack([-z * inv_a, np.zeros_like(x), x * inv_a], -1),
                  np.stack([np.zeros_like(x), z * inv_a, -y * inv_a], -1))
    cv = np.cross(ng, cu)
    dpdu = np.where(degen[:, None], cu, dpdu)
    dpdv = np.where(degen[:, None], cv, dpdv)
    A[:, 12:15] = dpdu
    A[:, 15:18] = dpdv
    A[:, 18:27] = vn.reshape(f, 9)
    A[:, 27:33] = uv.reshape(f, 6)
    # columns 33-35 are int32 BIT PATTERNS (f32 denormals for small ids):
    # NEVER apply arithmetic to them, only bit-exact data movement (copy,
    # gather, transpose), and never enable flush-to-zero on them; read them
    # with .view(torch.int32)
    A[:, 33] = np.asarray(mat_id, np.int32).view(np.float32)
    A[:, 34] = np.asarray(light_id, np.int32).view(np.float32)
    A[:, 35] = np.asarray(alpha_tid, np.int32).view(np.float32)
    return A


def to_device(tree, device=device_mod.DEFAULT):
    """One-shot transfer of a (numpy-leaved) scene tree to `device`:
    dataclasses, NamedTuples, tuples, lists and dicts are walked, numpy
    arrays and tensors become tensors there (bit-exact), everything else is
    kept. Idempotent. Call once at render entry."""
    dev = device_mod.resolve(device)

    def walk(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        if torch.is_tensor(x):
            return x.to(dev)
        if isinstance(x, np.generic):
            return x.item()
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            host = getattr(x, "_HOST_FIELDS", ())
            return dataclasses.replace(x, **{
                f.name: walk(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.name not in host})
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    return walk(tree)


def attr_rows(geom, idx):
    """ONE row gather of the per-face attr table -> (48, R) component rows."""
    return geom.attr[idx.long()].t().contiguous()


def attr_v3(rows, c0):
    return vm.V3(rows[c0], rows[c0 + 1], rows[c0 + 2])


def _bits_i32(col):
    """An f32 column that holds int32 bit patterns, reinterpreted."""
    return col.contiguous().view(torch.int32)


def _check_opaque(geom):
    if geom.has_alpha:
        raise NotImplementedError(
            "alpha cut-outs are not ported (ROADMAP Queue 1, textures)")


def _shutter_time01(geom: Geometry, rays):
    """The rays' shutter time normalised to [0, 1] for the motion lerp
    (None for a static scene)."""
    if not geom.has_motion:
        return None
    open_, close = geom.shutter
    return ((rays.time - open_) / max(close - open_, 1e-9)).clamp(0.0, 1.0)


@torch.no_grad()
def intersect(geom: Geometry, rays, sort: bool = True) -> Hits:
    """Closest hit over the scene BVH. No gradient passes the traversal:
    visibility decisions carry no derivative, shading is evaluated at the
    returned hit points."""
    _check_opaque(geom)
    t, prim, b1, b2, rows = tc.intersect_rays(
        geom.packed, geom.perm, geom.world_bound[0], geom.world_bound[1],
        rays.o, rays.d, rays.tmin, rays.tmax, any_hit=False, sort=sort,
        time=_shutter_time01(geom, rays), rows_table=geom.attrp)
    return Hits(t=t, prim=prim, b1=b1, b2=b2, rows=rows)


@torch.no_grad()
def intersect_pair(geom: Geometry, ext_rays, shadow_rays):
    """Closest hit over ext_rays + any-hit over shadow_rays in ONE merged
    traversal launch (the kernel's mixed mode): both sets start at the same
    bounce hit points, so they share the coherence sort and the launch.

    Returns (Hits for ext_rays, occluded bool for shadow_rays)."""
    _check_opaque(geom)
    t, prim, b1, b2, occ, rows = tc.intersect_rays_pair(
        geom.packed, geom.perm, geom.world_bound[0], geom.world_bound[1],
        ext_rays.o, ext_rays.d, ext_rays.tmin, ext_rays.tmax,
        shadow_rays.o, shadow_rays.d, shadow_rays.tmin, shadow_rays.tmax,
        time_e=_shutter_time01(geom, ext_rays),
        time_s=_shutter_time01(geom, shadow_rays), rows_table=geom.attrp)
    return Hits(t=t, prim=prim, b1=b1, b2=b2, rows=rows), occ


@torch.no_grad()
def intersect_p(geom: Geometry, rays, sort: bool = True):
    """Any-hit occlusion: (R,) bool."""
    _check_opaque(geom)
    _, prim, _, _ = tc.intersect_rays(
        geom.packed, geom.perm, geom.world_bound[0], geom.world_bound[1],
        rays.o, rays.d, rays.tmin, rays.tmax, any_hit=True, sort=sort,
        time=_shutter_time01(geom, rays))
    return prim >= 0


def interaction(geom: Geometry, rays, hits, diffs=None):
    """Hits -> dict of SoA shading data for the hit points.

    Returns p/ng/ns/dpdu/dpdv/wo as V3, uv as V2, plus mat_id/light_id/
    prim/t/time (R,): garbage-but-finite values on misses (callers mask by
    hits.hit). With camera ray differentials also tex_duv (4-tuple of (R,))
    and tex_width, the uv-space filter footprint textures use."""
    prim = hits.prim.clamp_min(0)
    # the traversal finish already fetched the rows (Hits.rows); otherwise
    # ONE wide row gather fetches every per-face attribute
    rows = hits.rows if hits.rows is not None else attr_rows(geom, prim)
    v0 = attr_v3(rows, 0)
    e1g = attr_v3(rows, 3)
    e2g = attr_v3(rows, 6)
    ng = attr_v3(rows, 9)
    dpdu = attr_v3(rows, 12)
    dpdv = attr_v3(rows, 15)
    if geom.has_motion:
        # the hit point comes from the ray (exact for the returned t); uv
        # and normals interpolate the shutter-start triangle
        p = rays.o + rays.d * hits.t.clamp_max(1e30)
    else:
        p = v0 + e1g * hits.b1 + e2g * hits.b2
    b0 = 1.0 - hits.b1 - hits.b2
    vn0 = attr_v3(rows, 18)
    vn1 = attr_v3(rows, 21)
    vn2 = attr_v3(rows, 24)
    ns = vm.normalize(vn0 * b0 + vn1 * hits.b1 + vn2 * hits.b2)
    # shading normal in the same hemisphere as the geometric one
    ns = vm.face_forward(ns, ng)
    uv = vm.V2(rows[27] * b0 + rows[29] * hits.b1 + rows[31] * hits.b2,
               rows[28] * b0 + rows[30] * hits.b1 + rows[32] * hits.b2)
    out = dict(
        p=p, ng=ng, ns=ns, uv=uv, dpdu=dpdu, dpdv=dpdv,
        wo=-rays.d, mat_id=_bits_i32(rows[33]), light_id=_bits_i32(rows[34]),
        prim=hits.prim, t=hits.t, time=rays.time)
    if diffs is not None:
        duv = _uv_footprint(p, ng, dpdu, dpdv, diffs)
        out["tex_duv"] = duv          # (dudx, dvdx, dudy, dvdy) of (R,)
        out["tex_width"] = torch.maximum(
            torch.maximum(torch.abs(duv[0]), torch.abs(duv[1])),
            torch.maximum(torch.abs(duv[2]), torch.abs(duv[3])))
    return out


def _uv_footprint(p, ng, dpdu, dpdv, diffs):
    """Per-ray uv-space screen footprint: intersect the +1px x/y rays with
    the tangent plane, solve the 2x2 system for du/dv per axis, return the
    (dudx, dvdx, dudy, dvdy) derivative tuple."""
    def plane_hit(o, d):
        denom = vm.dot(d, ng)
        tt = vm.dot(p - o, ng) / torch.where(torch.abs(denom) < 1e-9, 1.0,
                                             denom)
        return o + d * tt

    dpdx = plane_hit(diffs.rx_o, diffs.rx_d) - p
    dpdy = plane_hit(diffs.ry_o, diffs.ry_d) - p
    # the two dominant axes of the normal's complement, by component selects
    anx, any_, anz = torch.abs(ng.x), torch.abs(ng.y), torch.abs(ng.z)
    x_big = (anx >= any_) & (anx >= anz)
    z_big = (anz > anx) & (anz > any_)
    sel0 = lambda v: torch.where(x_big, v.y, v.x)
    sel1 = lambda v: torch.where(z_big, v.y, v.z)
    a00 = sel0(dpdu)
    a01 = sel0(dpdv)
    a10 = sel1(dpdu)
    a11 = sel1(dpdv)
    det = a00 * a11 - a01 * a10
    inv = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
    ok = torch.abs(det) >= 1e-12

    def solve(b):
        b0, b1 = sel0(b), sel1(b)
        du = (a11 * b0 - a01 * b1) * inv
        dv = (-a10 * b0 + a00 * b1) * inv
        return torch.where(ok, du, 0.0), torch.where(ok, dv, 0.0)

    dudx, dvdx = solve(dpdx)
    dudy, dvdy = solve(dpdy)
    return (dudx, dvdx, dudy, dvdy)


def ray_epsilon(t):
    """Offset scale for secondary rays: 1e-3 * tHit."""
    return 1e-3 * t.clamp_min(1e-4)
