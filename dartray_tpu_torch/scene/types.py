"""Compiled scene: every primitive, material and light flattened to arrays
(counterpart of the JAX reference's ``scene/types.py``).

The host compiler (numpy) turns world-space triangle meshes into one
``CompiledScene`` of plain dataclasses; ``to_device`` moves its leaves to the
device once, at render entry. The device side (``intersect``,
``intersect_p``, ``intersect_pair``, ``interaction``) works on whole
wavefronts of rays.

A mesh with an alpha texture makes the scene an alpha one: every traversal
query runs the closest-hit kernel in a static loop of ``ALPHA_ROUNDS``
launches, each later launch re-tracing only the lanes whose hit landed on a
texel of alpha below 1e-3 (every other lane dead), so occlusion is a
closest-hit query too and no launch is a mixed one.

A mesh with ``verts_end`` makes the scene a moving one: ONE shutter-union BVH
plus per-triangle (close - open) deltas, every traversal carries the rays'
normalised shutter time and the kernel lerps the leaf triangles to it.
Finish vertices are lerped too; shading attributes (normals, uv, ``ng``,
``dpdu``) stay at shutter start, as in the reference.

``Accelerator "grid"`` or ``"kdtree"`` gives the geometry an alternate
accelerator (``alt``, ``alt_kind``): every query then walks it in plain torch
(``accel/grid.py``, ``accel/kdtree.py``) and launches no kernel. Its walks
return ids into the unpermuted soup, so a closest hit's attr rows come from
``attr`` by that id, which the kernel's finish would have fetched by the
same id; an intersect_pair is the split form, a closest-hit and an any-hit
walk. Moving geometry keeps the cluster BVH and warns, as in the reference.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from .. import device as device_mod
from .. import stats
from .. import textures as tex_mod
from ..accel import bvh as bvh_mod
from ..accel import cluster as cluster_mod
from ..accel import grid as grid_mod
from ..accel import kdtree as kd_mod
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
    alpha_tid: Any = None      # (F,) int32 alpha texture id (-1 none)
    alpha_tex: Any = None      # the scene's TextureData when has_alpha
    # the alternate accelerator (Accelerator "grid" / "kdtree"): an
    # accel.grid.Grid or accel.kdtree.KdTree over the unpermuted soup
    alt: Any = None
    alt_kind: str = ""         # "" | "grid" | "kdtree"
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
    volume: Any         # volumes.VolumeData or None
    textures: Any       # textures.TextureData or None

    def to(self, device):
        return to_device(self, device)


def compile_geometry(meshes, mat_ids=None, light_ids=None,
                     split_method="sah", textures=None,
                     shutter=(0.0, 1.0), accelerator="bvh") -> Geometry:
    """meshes: list of TriangleMesh (world space). mat_ids/light_ids:
    per-mesh ints. textures: the scene's TextureData, which the geometry
    references when a mesh carries an alpha texture (without a texture table
    the alpha ids are dropped and the scene is not an alpha one).
    accelerator: "grid" or "kdtree" adds that alternate (not for moving
    geometry, which warns and keeps the cluster BVH); any other name is the
    cluster BVH alone. Returns a host (numpy-leaved) Geometry."""
    if not meshes:
        raise ValueError("empty scene")
    n_meshes = len(meshes)
    mat_ids = mat_ids if mat_ids is not None else [0] * n_meshes
    light_ids = light_ids if light_ids is not None else [-1] * n_meshes

    alpha_ids = []
    v0s, e1s, e2s, vns, uvs, mids, lids = [], [], [], [], [], [], []
    for m, mid, lid in zip(meshes, mat_ids, light_ids):
        alpha_ids.append(np.full(m.faces.shape[0],
                                 getattr(m, "alpha_tid", -1), np.int32))
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
    with stats.span("bvh"):
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
    if has_motion and accelerator in ("grid", "kdtree"):
        warnings.warn(f"Accelerator {accelerator!r} does not support "
                      f"moving geometry; using the cluster BVH")
        accelerator = "bvh"
    alt = build_alt(accelerator, v0, e1, e2)
    with stats.span("pack"):
        packed, perm = tc.pack(cb.node_lo, cb.node_hi, cb.node_child,
                               cb.node_axis, cb.tri_v0, cb.tri_e1, cb.tri_e2,
                               cb.tri_id,
                               deltas=((cb.tri_dv0, cb.tri_de1, cb.tri_de2)
                                       if has_motion else None))
    vn_all = np.concatenate(vns)          # (F, 3 corners, 3)
    uv_all = np.concatenate(uvs)          # (F, 3 corners, 2)
    mat_all = np.concatenate(mids)
    light_all = np.concatenate(lids)
    alpha_tid = np.concatenate(alpha_ids)
    has_alpha = bool((alpha_tid >= 0).any()) and textures is not None
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
        alpha_tid=alpha_tid if has_alpha else None,
        alpha_tex=textures if has_alpha else None,
        alt=alt, alt_kind=accelerator if alt is not None else "",
        n_prims=int(v0.shape[0]), n_nodes=cb.n_nodes, has_alpha=has_alpha,
        has_motion=has_motion, shutter=tuple(shutter))


def build_alt(accelerator, v0, e1, e2):
    """The alternate accelerator `accelerator` names over the (F, 3) soup:
    a Grid for "grid", a KdTree for "kdtree", else None."""
    if accelerator == "grid":
        return grid_mod.build(v0, e1, e2)
    if accelerator == "kdtree":
        return kd_mod.build(v0, e1, e2)
    return None


_ALT_WALKS = {"grid": grid_mod, "kdtree": kd_mod}


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


@stats.spanned("upload")
def to_device(tree, device=device_mod.DEFAULT):
    """One-shot transfer of a (numpy-leaved) scene tree to `device`:
    dataclasses, NamedTuples, tuples, lists and dicts are walked, numpy
    arrays and tensors become tensors there (bit-exact), everything else is
    kept. Idempotent. Call once at render entry."""
    dev = device_mod.resolve(device)

    def walk(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(
                np.ascontiguousarray(x).reshape(x.shape)).to(dev)
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


# traversal queries issued on either device: the rays handed to the
# kernel's launcher, one count per launch of a wave (an alpha query's
# continuation rounds and intersect_p's own count each add the wave again,
# as the reference's QUERY_LOG does). The render manager reads how far it
# moves over a render; on the card it equals the traversal launches times
# their lanes, since a launch takes its whole wave
QUERIES = {"rays": 0}

ALPHA_ROUNDS = 4     # cut layers a query pierces at most: 1 + 3 re-traces


def _query(*rays):
    QUERIES["rays"] += sum(r.n for r in rays)


def _lanes(geom: Geometry, mode, *rays):
    """While statistics are collected: the lanes handed to one traversal
    launch (or alternate walk) of `mode` ("closest", "any", "mixed") and
    the live ones among them (tmax >= tmin), a sum on the rays' device;
    on a moving scene the lanes again as ``lanes_motion/<mode>``, counted
    on the host: the lanes the kernel's motion instantiation takes."""
    if not stats.collecting():
        return
    n = sum(r.n for r in rays)
    stats.count("lanes/" + mode, n)
    if geom.has_motion:
        stats.count("lanes_motion/" + mode, n)
    for r in rays:
        stats.count("lanes_live/" + mode, (r.tmax >= r.tmin).sum())


def _motion_work(geom: Geometry):
    """While statistics are collected on a moving scene: the dict a motion
    launch fills with its node pops and triangle tests (``tc.traverse6``'s
    ``counts``); else None, and the launch counts nothing."""
    return {} if geom.has_motion and stats.collecting() else None


def _count_work(mode, work):
    """Add a motion launch's work, as ``pops_motion/<mode>`` and
    ``tests_motion/<mode>`` (device sums on the card)."""
    if work:
        stats.count("pops_motion/" + mode, work["node_pops"])
        stats.count("tests_motion/" + mode, work["tri_tests"])


def _shutter_time01(geom: Geometry, rays):
    """The rays' shutter time normalised to [0, 1] for the motion lerp
    (None for a static scene)."""
    if not geom.has_motion:
        return None
    open_, close = geom.shutter
    return ((rays.time - open_) / max(close - open_, 1e-9)).clamp(0.0, 1.0)


def _closest(geom: Geometry, rays, sort: bool) -> Hits:
    """One closest-hit launch over the wave, finished with its attr rows;
    with an alternate accelerator, its walk and one gather of the rows."""
    _query(rays)
    _lanes(geom, "closest", rays)
    if geom.alt_kind:
        h = _ALT_WALKS[geom.alt_kind].intersect(geom.alt, rays)
        return h._replace(rows=attr_rows(geom, h.prim.clamp_min(0)))
    work = _motion_work(geom)
    t, prim, b1, b2, rows = tc.intersect_rays(
        geom.packed, geom.perm, geom.world_bound[0], geom.world_bound[1],
        rays.o, rays.d, rays.tmin, rays.tmax, any_hit=False, sort=sort,
        time=_shutter_time01(geom, rays), rows_table=geom.attrp, counts=work)
    _count_work("closest", work)
    return Hits(t=t, prim=prim, b1=b1, b2=b2, rows=rows)


def _alpha_cut(geom: Geometry, hits: Hits):
    """True where a hit lands on a texel of alpha below 1e-3 of an
    alpha-masked face. The alpha texture is evaluated at the hit's uv with
    p = 0, so a 3-D texture is read at the origin, as in the reference. The
    face's uv corners and alpha id come from the hit's attr rows (columns
    27-32 and 35); without rows they are gathered."""
    rows = hits.rows
    if rows is None:
        rows = attr_rows(geom, hits.prim.clamp_min(0))
    tid = _bits_i32(rows[35])
    b0 = 1.0 - hits.b1 - hits.b2
    uv = vm.V2(rows[27] * b0 + rows[29] * hits.b1 + rows[31] * hits.b2,
               rows[28] * b0 + rows[30] * hits.b1 + rows[32] * hits.b2)
    it = {"uv": uv, "p": vm.v3zeros(b0.shape, b0.device)}
    a = tex_mod.eval_or(geom.alpha_tex, tid, it,
                        vm.v3ones(b0.shape, b0.device))
    return (hits.prim >= 0) & (tid >= 0) & (a.x < 1e-3)


@stats.spanned("traverse")
@torch.no_grad()
def intersect(geom: Geometry, rays, sort: bool = True) -> Hits:
    """Closest hit over the scene BVH. No gradient passes the traversal:
    visibility decisions carry no derivative, shading is evaluated at the
    returned hit points.

    On an alpha scene the query is ALPHA_ROUNDS launches whatever the lanes
    hold: after each of the first three, the lanes whose hit is cut re-trace
    from just past it (tmin = t + ray_epsilon(t)) and every other lane is
    dead (tmax = -1); the re-traced hits replace the cut ones. A ray that
    pierces more than three cut layers keeps its fourth hit, cut or not."""
    h = _closest(geom, rays, sort)
    if not geom.has_alpha:
        return h
    cand = torch.ones_like(h.prim, dtype=torch.bool)
    for _ in range(ALPHA_ROUNDS - 1):
        cut = cand & _alpha_cut(geom, h)
        cont = rays._replace(
            tmin=torch.where(cut, h.t + ray_epsilon(h.t), rays.tmin),
            tmax=torch.where(cut, rays.tmax, -1.0))
        h2 = _closest(geom, cont, sort)
        h = Hits(t=torch.where(cut, h2.t, h.t),
                 prim=torch.where(cut, h2.prim, h.prim),
                 b1=torch.where(cut, h2.b1, h.b1),
                 b2=torch.where(cut, h2.b2, h.b2),
                 rows=torch.where(cut[None, :], h2.rows, h.rows))
        cand = cut
    return h


@stats.spanned("traverse")
@torch.no_grad()
def intersect_pair(geom: Geometry, ext_rays, shadow_rays):
    """Closest hit over ext_rays + any-hit over shadow_rays in ONE merged
    traversal launch (the kernel's mixed mode): both sets start at the same
    bounce hit points, so they share the coherence sort and the launch. An
    alpha scene takes ``intersect`` and ``intersect_p`` instead: its
    continuation loops need the split form, and so does a scene with an
    alternate accelerator, whose walks have no mixed mode.

    Returns (Hits for ext_rays, occluded bool for shadow_rays)."""
    if geom.has_alpha or geom.alt_kind:
        return intersect(geom, ext_rays), intersect_p(geom, shadow_rays)
    _query(ext_rays, shadow_rays)
    _lanes(geom, "mixed", ext_rays, shadow_rays)
    work = _motion_work(geom)
    t, prim, b1, b2, occ, rows = tc.intersect_rays_pair(
        geom.packed, geom.perm, geom.world_bound[0], geom.world_bound[1],
        ext_rays.o, ext_rays.d, ext_rays.tmin, ext_rays.tmax,
        shadow_rays.o, shadow_rays.d, shadow_rays.tmin, shadow_rays.tmax,
        time_e=_shutter_time01(geom, ext_rays),
        time_s=_shutter_time01(geom, shadow_rays), rows_table=geom.attrp,
        counts=work)
    _count_work("mixed", work)
    return Hits(t=t, prim=prim, b1=b1, b2=b2, rows=rows), occ


@stats.spanned("traverse")
@torch.no_grad()
def intersect_p(geom: Geometry, rays, sort: bool = True):
    """Any-hit occlusion: (R,) bool. On an alpha scene a blocker may be a
    cut texel, so occlusion is ``intersect`` and a hit test."""
    _query(rays)
    if geom.has_alpha:
        return intersect(geom, rays, sort=sort).prim >= 0
    _lanes(geom, "any", rays)
    if geom.alt_kind:
        return _ALT_WALKS[geom.alt_kind].intersect_p(geom.alt, rays)
    work = _motion_work(geom)
    _, prim, _, _ = tc.intersect_rays(
        geom.packed, geom.perm, geom.world_bound[0], geom.world_bound[1],
        rays.o, rays.d, rays.tmin, rays.tmax, any_hit=True, sort=sort,
        time=_shutter_time01(geom, rays), counts=work)
    _count_work("any", work)
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
