"""Configurations as explicit triangle meshes, and their hand-over to the
program.

A configuration file (``configs/<name>.json``) lists materials, shapes, the
camera and how the program takes the scene in (``front_door``): "builder"
(the port's ``scene.build.SceneBuilder``) or "pbrt" (a ``.pbrt`` text that
the port's parser reads). Every shape becomes a numpy triangle mesh here,
and the very same arrays go to the program and to the reference.

Each shape's ``kind`` names its maker, ``shapes/<kind>.py`` (``sphere``,
``mesh``); every shape takes ``translate``, ``material`` and, for an
emitter, ``area_light_L``.
"""
from __future__ import annotations

import json
import os

import numpy as np

from . import registry
from .reference.geometry import Mesh

HERE = os.path.dirname(os.path.abspath(__file__))


def make_shape(s, bench=HERE) -> Mesh:
    verts, faces, normals, uvs = registry.load("shapes", s["kind"],
                                               bench).make(s)
    if "translate" in s:
        verts = (verts.astype(np.float64)
                 + np.asarray(s["translate"], np.float64)).astype(np.float32)
    return Mesh(verts=verts, faces=faces, material=s["material"],
                normals=normals, uvs=uvs,
                light_L=tuple(s["area_light_L"]) if "area_light_L" in s
                else None)


def load_config(path, edit=None, bench=HERE):
    """A configuration file with its meshes made; `edit(cfg)` may change
    the parsed file first (the tests shrink a configuration so)."""
    with open(path) as f:
        cfg = json.load(f)
    if edit is not None:
        edit(cfg)
    cfg["meshes"] = [make_shape(s, bench) for s in cfg["shapes"]]
    n = sum(m.faces.shape[0] for m in cfg["meshes"])
    if "n_triangles" in cfg and n != cfg["n_triangles"]:
        raise ValueError(f"{os.path.basename(path)} makes {n} triangles, "
                         f"not the {cfg['n_triangles']} it states")
    return cfg


# --- the hand-over to the program --------------------------------------------

def port_material(mat_mod, row):
    kind = row["type"]
    if kind == "matte":
        return mat_mod.matte(kd=tuple(row["kd"]))
    if kind == "glass":
        return mat_mod.glass(kr=tuple(row["kr"]), kt=tuple(row["kt"]),
                             index=row["index"])
    if kind == "mirror":
        return mat_mod.mirror(kr=tuple(row["kr"]))
    raise ValueError(f"unknown material type {kind!r}")


def builder_scene(cfg):
    """The configuration through the port's SceneBuilder: a host scene."""
    from dartray_tpu_torch import materials as mat_mod
    from dartray_tpu_torch.scene import build as sb
    from dartray_tpu_torch.scene import mesh as mesh_mod
    b = sb.SceneBuilder()
    ids = {name: b.add_material(port_material(mat_mod, row))
           for name, row in cfg["materials"].items()}
    for m in cfg["meshes"]:
        b.add_mesh(mesh_mod.make_mesh(m.verts, m.faces, m.normals, m.uvs),
                   ids[m.material], area_light_L=m.light_L)
    return b.build()


def _nums(a):
    return " ".join("%.9g" % x for x in np.asarray(a, np.float64).reshape(-1))


def _material_line(row):
    kind = row["type"]
    if kind == "matte":
        return f'Material "matte" "rgb Kd" [{_nums(row["kd"])}]'
    if kind == "mirror":
        return f'Material "mirror" "rgb Kr" [{_nums(row["kr"])}]'
    if kind == "glass":
        return (f'Material "glass" "rgb Kr" [{_nums(row["kr"])}] '
                f'"rgb Kt" [{_nums(row["kt"])}] "float index" '
                f'[{row["index"]:.9g}]')
    raise ValueError(f"unknown material type {kind!r}")


def pbrt_text(cfg, traffic):
    """The configuration and a traffic mix's render options as a .pbrt
    scene: every shape a trianglemesh in world space."""
    cam = cfg["camera"]
    integ = traffic["integrator"]
    params = " ".join(
        f'"integer {k}" [{v}]' if isinstance(v, int) else f'"string {k}" '
        f'["{v}"]' for k, v in traffic["integrator_params"].items())
    smp = traffic["sampler"]
    if smp["kind"] == "stratified":
        nx = int(np.round(np.sqrt(traffic["spp"])))
        ny = traffic["spp"] // nx
        sline = (f'Sampler "stratified" "integer xsamples" [{nx}] '
                 f'"integer ysamples" [{ny}] "bool jitter" ["true"]')
    else:
        sline = (f'Sampler "{smp["kind"]}" "integer pixelsamples" '
                 f'[{traffic["spp"]}]')
    out = [f'Film "image" "integer xresolution" [{traffic["width"]}] '
           f'"integer yresolution" [{traffic["height"]}]',
           sline, f'PixelFilter "{traffic["filter"]}"',
           f'SurfaceIntegrator "{integ}" {params}',
           f'LookAt {_nums(cam["eye"])}  {_nums(cam["look"])}  '
           f'{_nums(cam["up"])}',
           f'Camera "perspective" "float fov" [{cam["fov"]:.9g}]',
           "WorldBegin"]
    for m in cfg["meshes"]:
        out.append("AttributeBegin")
        out.append(_material_line(cfg["materials"][m.material]))
        if m.light_L is not None:
            out.append(f'AreaLightSource "diffuse" "rgb L" '
                       f'[{_nums(m.light_L)}]')
        line = (f'Shape "trianglemesh" "integer indices" '
                f'[{" ".join(str(int(i)) for i in m.faces.reshape(-1))}] '
                f'"point P" [{_nums(m.verts)}]')
        if m.normals is not None:
            line += f' "normal N" [{_nums(m.normals)}]'
        if m.uvs is not None:
            line += f' "float uv" [{_nums(m.uvs)}]'
        out.append(line)
        out.append("AttributeEnd")
    out.append("WorldEnd")
    return "\n".join(out) + "\n"
