"""Carry a compiled scene of the JAX reference over to the port.

``from_reference`` takes the reference's compiled scene as a tree of plain
Python containers and numpy arrays (the caller flattens the reference's
dataclasses into dicts keyed by field name and its arrays into numpy; no
JAX type ever reaches this package) and returns the port's host
``CompiledScene``. Every leaf is carried bit for bit, including the int32
bit patterns stored in f32 columns. Tests use it so that both packages
traverse the SAME packed BVH; the port's own host compiler is tested
separately to produce the same leaves.
"""
from __future__ import annotations

import numpy as np

from .. import lights as lt_mod
from .. import materials as mat_mod
from .. import textures as tex_mod
from .. import volumes as vol_mod
from ..accel import cluster as cluster_mod
from ..accel import grid as grid_mod
from ..accel import kdtree as kd_mod
from ..core import math as vm
from ..ops import traverse_cuda as tc
from . import types as st


def _arr(x, dtype):
    a = np.asarray(x)
    a = np.ascontiguousarray(a).reshape(a.shape)
    if a.dtype != dtype:
        raise TypeError(f"expected {dtype} leaf, got {a.dtype}")
    return a


def _f32(x):
    return _arr(x, np.float32)


def _i32(x):
    return _arr(x, np.int32)


def _v3(t):
    return vm.V3(*(_f32(c) for c in t))


def _opt(d, key, conv):
    return None if d.get(key) is None else conv(d[key])


def woop_rows(woop, k):
    """The reference's (C, 4, 3K) Woop operand (column ``c*K + j`` holds
    ``[W[c, :], w[c]]`` of triangle j) -> the port's (C*K, 12) row table
    ``[W_0 w_0 | W_1 w_1 | W_2 w_2]``: the same numbers, bit for bit."""
    a = _f32(woop)
    return np.ascontiguousarray(
        a.reshape(a.shape[0], 4, 3, k).transpose(0, 3, 2, 1)).reshape(-1, 12)


def _packed(d) -> tc.PackedBVH:
    """The reference's per-component delta soups (``tdv0`` / ``tde1`` /
    ``tde2``) are not carried: its ``soup16d`` holds the same numbers in the
    row layout the port's kernel reads. A moving scene gains the port's
    ``wbounds_t``, which the reference has no counterpart of."""
    soup16 = _f32(d["soup16"])
    k = int(d["k"])
    tc.check_pads_trail(soup16[:, 9].view(np.int32).reshape(-1, k))
    packed = tc.PackedBVH(
        bounds=_f32(d["bounds"]), meta=_i32(d["meta"]),
        meta2=_i32(d["meta2"]), wbounds=_f32(d["wbounds"]), worder=_i32(d["worder"]), soup16=soup16,
        woop=_opt(d, "woop", lambda a: woop_rows(a, k)),
        n_nodes=int(d["n_nodes"]), n_clusters=int(d["n_clusters"]),
        k=k, n_wnodes=int(d["n_wnodes"]))
    soup16d = _opt(d, "soup16d", _f32)
    return packed if soup16d is None else tc.with_deltas(packed, soup16d)


def _cluster(d) -> cluster_mod.ClusterBVH:
    return cluster_mod.ClusterBVH(
        node_lo=_f32(d["node_lo"]), node_hi=_f32(d["node_hi"]),
        node_child=_i32(d["node_child"]), node_axis=_i32(d["node_axis"]),
        tri_v0=_f32(d["tri_v0"]), tri_e1=_f32(d["tri_e1"]),
        tri_e2=_f32(d["tri_e2"]), tri_id=_i32(d["tri_id"]),
        tri_dv0=_opt(d, "tri_dv0", _f32), tri_de1=_opt(d, "tri_de1", _f32),
        tri_de2=_opt(d, "tri_de2", _f32),
        n_nodes=int(d["n_nodes"]), n_clusters=int(d["n_clusters"]),
        k=int(d["k"]), max_depth=int(d["max_depth"]))


def _alt(kind, d):
    """The reference's Grid / KdTree, array for array."""
    if kind == "grid":
        return grid_mod.Grid(
            **{k: _f32(d[k]) for k in ("lo", "hi", "width", "inv_width",
                                       "v0", "e1", "e2")},
            **{k: _i32(d[k]) for k in ("cell_start", "cell_count",
                                       "tri_ids")},
            nv=tuple(int(n) for n in d["nv"]), max_cell=int(d["max_cell"]))
    return kd_mod.KdTree(
        **{k: _f32(d[k]) for k in ("split_pos", "lo", "hi", "v0", "e1",
                                   "e2")},
        meta=_i32(d["meta"]), prim_ids=_i32(d["prim_ids"]),
        n_nodes=int(d["n_nodes"]), max_leaf=int(d["max_leaf"]))


def _geometry(d) -> st.Geometry:
    kind = d.get("alt_kind") or ""
    has_alpha = bool(d.get("has_alpha", False))
    return st.Geometry(
        cl=_cluster(d["cl"]), packed=_packed(d["packed"]),
        perm=_i32(d["perm"]), attr=_f32(d["attr"]), attrp=_f32(d["attrp"]),
        v0=_v3(d["v0"]), e1=_v3(d["e1"]), e2=_v3(d["e2"]),
        vn=tuple(_v3(c) for c in d["vn"]),
        uv=tuple(vm.V2(_f32(c[0]), _f32(c[1])) for c in d["uv"]),
        mat_id=_i32(d["mat_id"]), light_id=_i32(d["light_id"]),
        world_bound=_f32(d["world_bound"]),
        alpha_tid=_i32(d["alpha_tid"]) if has_alpha else None,
        alpha_tex=_textures(d["alpha_tex"]) if has_alpha else None,
        alt=_alt(kind, d["alt"]) if kind else None, alt_kind=kind,
        n_prims=int(d["n_prims"]), n_nodes=int(d["n_nodes"]),
        has_alpha=has_alpha, has_motion=bool(d.get("has_motion", False)),
        shutter=tuple(d.get("shutter", (0.0, 1.0))))


def _materials(d) -> mat_mod.MaterialTable:
    f3 = ("kd", "kd_t", "ks", "ks_t", "kr", "kt", "eta_c", "k_c", "opacity",
          "sigma", "exponent", "exponent_v", "eta")
    return mat_mod.MaterialTable(
        **{k: _f32(d[k]) for k in f3},
        gloss_fresnel=_i32(d["gloss_fresnel"]),
        spec_fresnel=_i32(d["spec_fresnel"]), tex_ids=_i32(d["tex_ids"]),
        meas_meta=_i32(d["meas_meta"]), meas_pool=_f32(d["meas_pool"]),
        n=int(d["n"]), used_tex_slots=tuple(d["used_tex_slots"]),
        has_measured=bool(d["has_measured"]))


def _textures(d) -> tex_mod.TextureData:
    return tex_mod.TextureData(
        kind=_i32(d["kind"]), value=_f32(d["value"]),
        params=_f32(d["params"]), sub=_i32(d["sub"]),
        img_meta=_i32(d["img_meta"]), mip_off=_i32(d["mip_off"]),
        # a resampled image level is float64 in the reference's host table;
        # its device copy, which the port's table stands for, is float32
        texels=_f32(np.asarray(d["texels"], np.float32)),
        world2tex=_f32(d["world2tex"]),
        n=int(d["n"]), kinds_present=tuple(d["kinds_present"]),
        has_mapping=bool(d["has_mapping"]))


def _lights(d) -> lt_mod.LightTable:
    if d.get("tri_rows") is None:
        raise ValueError("the reference light table was built without the "
                         "geometry attr table (tri_rows is None)")
    env = ("env_map", "env_cond_cdf", "env_cond_func", "env_cond_int",
           "env_marg_cdf", "env_marg_func", "env_marg_int", "proj_map")
    return lt_mod.LightTable(
        kind=_i32(d["kind"]), p=_f32(d["p"]), intensity=_f32(d["intensity"]),
        params=_f32(d["params"]), w2l=_f32(d["w2l"]),
        tri_offset=_i32(d["tri_offset"]), tri_count=_i32(d["tri_count"]),
        tri_area_cdf=_f32(d["tri_area_cdf"]),
        cdf_offset=_i32(d["cdf_offset"]), total_area=_f32(d["total_area"]),
        power_cdf=_f32(d["power_cdf"]), tri_rows=_f32(d["tri_rows"]),
        tri_row_offset=_i32(d["tri_row_offset"]),
        **{k: _f32(d[k]) for k in env},
        scene_radius=float(d["scene_radius"]), n=int(d["n"]),
        env_light_index=int(d["env_light_index"]), env_w=int(d["env_w"]),
        env_h=int(d["env_h"]))


def _volume(d) -> vol_mod.VolumeData:
    return vol_mod.VolumeData(
        kind=_i32(d["kind"]),
        **{k: _f32(d[k]) for k in ("w2v", "bounds", "sigma_a", "sigma_s",
                                   "le", "g", "params", "grid")},
        n=int(d["n"]), grid_shape=tuple(int(n) for n in d["grid_shape"]))


def from_reference(tree) -> st.CompiledScene:
    """tree: {"geometry": {...}, "materials": {...} | None, "lights": {...}
    | None, "volume": {...} | None, "textures": {...} | None}, each inner
    dict keyed by the reference dataclass's field names, with numpy
    leaves."""
    vol = tree.get("volume")
    mats = tree.get("materials")
    lts = tree.get("lights")
    texs = tree.get("textures")
    return st.CompiledScene(
        geometry=_geometry(tree["geometry"]),
        materials=None if mats is None else _materials(mats),
        lights=None if lts is None else _lights(lts),
        volume=None if vol is None else _volume(vol),
        textures=None if texs is None else _textures(texs))
