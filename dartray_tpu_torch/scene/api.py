"""The PBRT API state machine: statement calls -> compiled scene + job config
(counterpart of the JAX reference's ``scene/api.py``).

Options and world states, a 2-slot CTM (shutter open and close) with
active-transform bits, named coordinate systems, graphics-state push / pop,
texture / material / light / shape creation, object instancing, and the
``world_end`` assembly of a ``RenderJob``: a host ``CompiledScene`` built by
the port's own ``SceneBuilder`` plus the camera, sampler, film and
integrator configuration.

Unknown names warn and fall back exactly as in the reference (matte, the
perspective camera, the lowdiscrepancy sampler).

A ``subsurface`` or ``kdsubsurface`` material is a plastic coat (kd 0,
ks 1) whose medium, (sigma'_s * scale, sigma_a * scale, index), travels
beside the material table in ``RenderJob.sss`` by material id, for the
``dipolesubsurface`` integrator.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .. import cameras as cam_mod
from .. import device as device_mod
from .. import lights as lt_mod
from .. import materials as mat_mod
from .. import samplers as smp_mod
from .. import textures as tex_mod
from .. import volumes as vol_mod
from ..core import transform as tr
from ..io import image as io_img
from ..io import merl
from . import build as build_mod
from . import mesh as mesh_mod
from . import paramset as ps

START_TRANSFORM_BITS = 1
END_TRANSFORM_BITS = 2
ALL_TRANSFORMS_BITS = 3

_SAMPLERS = ("lowdiscrepancy", "02sequence", "stratified", "random",
             "halton", "bestcandidate")


def _np4(t: tr.Transform) -> np.ndarray:
    return np.asarray(t.m, np.float64)


@dataclasses.dataclass
class GraphicsState:
    material: dict = None                 # current material row (builder dict)
    named_materials: dict = None
    area_light: Optional[tuple] = None    # (L_rgb, n_samples)
    reverse_orientation: bool = False
    float_textures: dict = None
    spectrum_textures: dict = None

    def copy(self):
        return GraphicsState(
            material=dict(self.material),
            named_materials=self.named_materials,  # shared (pbrt semantics)
            area_light=self.area_light,
            reverse_orientation=self.reverse_orientation,
            float_textures=dict(self.float_textures),
            spectrum_textures=dict(self.spectrum_textures))


@dataclasses.dataclass
class RenderJob:
    scene: object
    camera: object
    sampler: object
    width: int
    height: int
    filter_name: str
    filter_params: dict
    surf_integrator: str
    surf_params: ps.ParamSet
    vol_integrator: str
    vol_params: ps.ParamSet
    renderer: str
    renderer_params: ps.ParamSet
    crop: tuple = (0.0, 1.0, 0.0, 1.0)
    # subsurface media by material id: {mat_id: (sigma_prime_s (3,),
    # sigma_a (3,), eta)}, for the dipolesubsurface integrator
    sss: dict = dataclasses.field(default_factory=dict)
    # the adaptive sampler's (minsamples, maxsamples), or None
    adaptive: tuple = None
    # progressive delivery mode: "full" | "twopass" | "iterative". Every
    # wave is a 1-spp full-image sweep; the mode sets the preview cadence
    sampling_mode: str = "iterative"


class PbrtAPI:
    """The pbrt C-API object. `device` is where the job's camera expects
    its samples (``cameras.perspective``); the scene stays on the host until
    the render moves it."""

    def __init__(self, resolver=None, log=print, device=device_mod.DEFAULT):
        self.resolver = resolver
        self.log = log
        self.device = device_mod.resolve(device)
        self.state = "options"
        ps.SPD_LOADER = self._load_spd
        # 2-slot CTM for motion blur
        self.ctm = [tr.identity(), tr.identity()]
        self.active = ALL_TRANSFORMS_BITS
        self.coord_systems: Dict[str, list] = {}
        self.transform_times = (0.0, 1.0)
        # RenderOptions defaults
        self.opts = {
            "filter": ("box", ps.ParamSet()),
            "film": ("image", ps.ParamSet()),
            "sampler": ("lowdiscrepancy", ps.ParamSet()),
            "accelerator": ("bvh", ps.ParamSet()),
            "renderer": ("sampler", ps.ParamSet()),
            "surf_integrator": ("directlighting", ps.ParamSet()),
            "vol_integrator": ("emission", ps.ParamSet()),
            "camera": ("perspective", ps.ParamSet()),
            "camera_to_world": [tr.identity(), tr.identity()],
        }
        self.gs = GraphicsState(material=mat_mod.matte(),
                                named_materials={}, float_textures={},
                                spectrum_textures={})
        self.tex_builder = tex_mod.TextureBuilder()
        self.tex_ids: Dict[str, int] = {}
        self.gs_stack: List[GraphicsState] = []
        self.transform_stack: List[tuple] = []
        self.builder = build_mod.SceneBuilder()
        self._mat_cache: Dict[str, int] = {}
        self.sss_map: Dict[int, tuple] = {}   # mat_id -> (sps, sa, eta)
        # object instancing
        self.volumes: List[tuple] = []     # (name, ParamSet, object-to-world)
        self.objects: Dict[str, list] = {}
        self.current_object: Optional[str] = None

    # --- transforms -------------------------------------------------------
    def _apply(self, t: tr.Transform):
        for i in range(2):
            if self.active & (1 << i):
                self.ctm[i] = self.ctm[i] * t

    def identity(self):
        for i in range(2):
            if self.active & (1 << i):
                self.ctm[i] = tr.identity()

    def translate(self, x, y, z):
        self._apply(tr.translate([x, y, z]))

    def scale(self, x, y, z):
        self._apply(tr.scale(x, y, z))

    def rotate(self, angle, x, y, z):
        self._apply(tr.rotate(angle, [x, y, z]))

    def look_at(self, ex, ey, ez, lx, ly, lz, ux, uy, uz):
        # LookAt in pbrt scene files gives world->camera; CTM gets its inverse
        c2w = tr.look_at([ex, ey, ez], [lx, ly, lz], [ux, uy, uz])
        self._apply(c2w.inverse())

    def concat_transform(self, m16):
        m = np.asarray(m16, np.float64).reshape(4, 4).T  # column-major input
        self._apply(tr.from_matrix(m))

    def set_transform(self, m16):
        m = np.asarray(m16, np.float64).reshape(4, 4).T
        for i in range(2):
            if self.active & (1 << i):
                self.ctm[i] = tr.from_matrix(m)

    def coordinate_system(self, name):
        self.coord_systems[name] = list(self.ctm)

    def coord_sys_transform(self, name):
        if name in self.coord_systems:
            self.ctm = list(self.coord_systems[name])

    def active_transform_all(self):
        self.active = ALL_TRANSFORMS_BITS

    def active_transform_start(self):
        self.active = START_TRANSFORM_BITS

    def active_transform_end(self):
        self.active = END_TRANSFORM_BITS

    def set_transform_times(self, start, end):
        self.transform_times = (start, end)

    # --- options ----------------------------------------------------------
    def _option(self, key, name, params):
        if self.state != "options":
            self.log(f"warning: {key} outside option block")
        self.opts[key] = (name, params)

    def camera(self, name, params):
        self._option("camera", name, params)
        self.opts["camera_to_world"] = [t.inverse() for t in self.ctm]
        self.coord_systems["camera"] = self.opts["camera_to_world"]

    def film(self, name, params):
        self._option("film", name, params)

    def sampler(self, name, params):
        self._option("sampler", name, params)

    def pixel_filter(self, name, params):
        self._option("filter", name, params)

    def accelerator(self, name, params):
        self._option("accelerator", name, params)

    def renderer(self, name, params):
        self._option("renderer", name, params)

    def surface_integrator(self, name, params):
        self._option("surf_integrator", name, params)

    def volume_integrator(self, name, params):
        self._option("vol_integrator", name, params)

    def pixel_sampler(self, name, params):
        self._option("pixel_sampler", name, params)

    # --- world state ------------------------------------------------------
    def world_begin(self):
        self.state = "world"
        self.ctm = [tr.identity(), tr.identity()]
        self.coord_systems["world"] = list(self.ctm)

    def attribute_begin(self):
        self.gs_stack.append(self.gs.copy())
        self.transform_stack.append((list(self.ctm), self.active))

    def attribute_end(self):
        self.gs = self.gs_stack.pop()
        self.ctm, self.active = self.transform_stack.pop()
        self.ctm = list(self.ctm)

    def transform_begin(self):
        self.transform_stack.append((list(self.ctm), self.active))

    def transform_end(self):
        self.ctm, self.active = self.transform_stack.pop()
        self.ctm = list(self.ctm)

    def reverse_orientation(self):
        self.gs.reverse_orientation = not self.gs.reverse_orientation

    # --- textures / materials --------------------------------------------
    def texture(self, name, tex_class, tex_type, params):
        """Texture "name" "float|color|spectrum" "type": compiled at once
        into the texture table."""
        spec_ = {"type": tex_type, "params": params, "class": tex_class}
        if tex_class == "float":
            self.gs.float_textures[name] = spec_
        else:
            self.gs.spectrum_textures[name] = spec_
        self.tex_ids[name] = self._compile_texture(tex_type, params,
                                                   tex_class)

    def _child_tex(self, params, pname, default):
        """A tex1/tex2-style child: a named texture's id, or a new constant
        row."""
        t = params.find_texture(pname)
        if t is not None and t in self.tex_ids:
            return self.tex_ids[t]
        v = params.find_one_spectrum(pname, default)
        return self.tex_builder.add(tex_mod.CONST, tuple(v))

    def _mapping2d(self, p, w2t):
        """The 2D mapping: (mode, world2tex); planar packs v1 / v2 into the
        matrix rows."""
        name = p.find_one_string("mapping", "uv")
        mode = {"uv": tex_mod.MAP_UV, "spherical": tex_mod.MAP_SPHERICAL,
                "cylindrical": tex_mod.MAP_CYLINDRICAL,
                "planar": tex_mod.MAP_PLANAR}.get(name)
        if mode is None:
            self.log(f"warning: unknown texture mapping {name!r}; uv")
            mode = tex_mod.MAP_UV
        if mode == tex_mod.MAP_PLANAR:
            w2t = np.eye(4, dtype=np.float32)
            w2t[0, :3] = p.find_one_point("v1", (1, 0, 0))
            w2t[1, :3] = p.find_one_point("v2", (0, 1, 0))
        return mode, w2t

    def _compile_texture(self, tex_type, p, tex_class) -> int:
        tb = self.tex_builder
        su = p.find_one_float("uscale", 1.0)
        sv = p.find_one_float("vscale", 1.0)
        du = p.find_one_float("udelta", 0.0)
        dv = p.find_one_float("vdelta", 0.0)
        w2t = np.asarray(self.ctm[0].m_inv, np.float32)
        map2d, map_w2t = self._mapping2d(p, w2t)
        if tex_type == "constant":
            v = (p.find_one_spectrum("value", (1, 1, 1))
                 if tex_class != "float"
                 else np.full(3, p.find_one_float("value", 1.0)))
            return tb.add(tex_mod.CONST, tuple(v))
        if tex_type == "scale":
            return tb.add(tex_mod.SCALE,
                          sub=(self._child_tex(p, "tex1", (1, 1, 1)),
                               self._child_tex(p, "tex2", (1, 1, 1))))
        if tex_type == "mix":
            amt = p.find_one_float("amount", 0.5)
            return tb.add(tex_mod.MIX, params=(su, sv, du, dv, amt),
                          sub=(self._child_tex(p, "tex1", (0, 0, 0)),
                               self._child_tex(p, "tex2", (1, 1, 1))))
        if tex_type == "checkerboard":
            dim = p.find_one_int("dimension", 2)
            kind = tex_mod.CHECKER2D if dim == 2 else tex_mod.CHECKER3D
            return tb.add(kind, params=(su, sv, du, dv),
                          sub=(self._child_tex(p, "tex1", (1, 1, 1)),
                               self._child_tex(p, "tex2", (0, 0, 0))),
                          world2tex=map_w2t if dim == 2 else w2t,
                          mapping=map2d if dim == 2 else 0)
        if tex_type == "dots":
            return tb.add(tex_mod.DOTS, params=(su, sv, du, dv),
                          sub=(self._child_tex(p, "inside", (1, 1, 1)),
                               self._child_tex(p, "outside", (0, 0, 0))),
                          world2tex=map_w2t, mapping=map2d)
        if tex_type == "uv":
            return tb.add(tex_mod.UV, params=(su, sv, du, dv),
                          world2tex=map_w2t, mapping=map2d)
        if tex_type in ("fbm", "wrinkled"):
            oct_ = p.find_one_int("octaves", 8)
            rough = p.find_one_float("roughness", 0.5)
            kind = tex_mod.FBM if tex_type == "fbm" else tex_mod.WRINKLED
            return tb.add(kind, (1, 1, 1),
                          params=(su, sv, du, dv, oct_, rough),
                          world2tex=w2t)
        if tex_type == "marble":
            sc = p.find_one_float("scale", 1.0)
            var = p.find_one_float("variation", 0.2)
            return tb.add(tex_mod.MARBLE, (1, 1, 1),
                          params=(su, sv, du, dv, 8, 0.5, sc, var),
                          world2tex=w2t)
        if tex_type == "windy":
            return tb.add(tex_mod.WINDY, (1, 1, 1),
                          params=(su, sv, du, dv), world2tex=w2t)
        if tex_type == "bilerp":
            v00 = p.find_one_spectrum("v00", (0, 0, 0))
            v01 = p.find_one_spectrum("v01", (1, 1, 1))
            v10 = p.find_one_spectrum("v10", (0, 0, 0))
            v11 = p.find_one_spectrum("v11", (1, 1, 1))
            c11 = tb.add(tex_mod.CONST, tuple(v11))
            return tb.add(tex_mod.BILERP, tuple(v00),
                          params=(su, sv, du, dv, v01[0], v01[1], v01[2],
                                  float(np.mean(v10))),
                          sub=(c11, -1))
        if tex_type == "imagemap":
            fname = p.find_one_string("filename", "")
            sc = p.find_one_float("scale", 1.0)
            img = None
            if fname and self.resolver is not None:
                try:
                    img = io_img.load(self.resolver(fname, binary=True),
                                      fname)
                except Exception as e:  # noqa: BLE001
                    self.log(f"warning: imagemap {fname!r} failed: {e}")
            if img is None:
                img = np.ones((2, 2, 3), np.float32) * 0.5
            return tb.add(tex_mod.IMAGEMAP, (sc, sc, sc),
                          params=(su, sv, du, dv), image=img,
                          world2tex=map_w2t, mapping=map2d)
        self.log(f"warning: unknown texture type {tex_type!r}")
        return tb.add(tex_mod.CONST, (1.0, 1.0, 1.0))

    def material(self, name, params):
        self.gs.material = self._make_material(name, params)

    def make_named_material(self, name, params):
        mat_type = params.find_one_string("type", "matte")
        self.gs.named_materials[name] = self._make_material(mat_type, params)

    def named_material(self, name):
        if name in self.gs.named_materials:
            self.gs.material = self.gs.named_materials[name]
        else:
            self.log(f"warning: unknown named material {name!r}")

    def _resolve_tex(self, tp: ps.TextureParams, name, default,
                     is_float=False):
        """A parameter as a constant (constant and scale graphs folded, the
        others their stand-in), and the name of the texture it came from
        (None for a plain value). The texture itself overrides the constant
        through the material's texture slot."""
        kind, v = (tp.get_float(name, default) if is_float
                   else tp.get_spectrum(name, default))
        if kind == "const":
            return v, None
        texes = tp.float_textures if is_float else tp.spectrum_textures
        spec_ = texes.get(v)
        if spec_ is None:
            self.log(f"warning: unknown texture {v!r}")
            return default, None
        return self._fold_texture(spec_, default), v

    @staticmethod
    def _fold_texture(spec_, default):
        t = spec_["type"]
        p = spec_["params"]
        if t == "constant":
            return (p.find_one_spectrum("value", (1, 1, 1))
                    if spec_["class"] != "float"
                    else p.find_one_float("value", 1.0))
        if t == "scale":
            t1 = p.find_one_spectrum("tex1", (1, 1, 1))
            t2 = p.find_one_spectrum("tex2", (1, 1, 1))
            return np.asarray(t1) * np.asarray(t2)
        if t in ("checkerboard", "dots"):
            t1 = p.find_one_spectrum("tex1", (1, 1, 1))
            t2 = p.find_one_spectrum("tex2", (0, 0, 0))
            return 0.5 * (np.asarray(t1) + np.asarray(t2))
        return default

    def _make_material(self, name, geom_params, mat_params=None) -> dict:
        """Material factory -> a ``materials`` row."""
        tp = ps.TextureParams(geom_params, mat_params or ps.ParamSet(),
                              self.gs.float_textures,
                              self.gs.spectrum_textures)
        tex_ids = {}

        def spec3(n, d, slot=None):
            v, tex = self._resolve_tex(tp, n, np.asarray(d, np.float64))
            if tex is not None and slot is not None and tex in self.tex_ids:
                tex_ids[slot] = self.tex_ids[tex]
            return tuple(np.asarray(v, np.float64))

        def f1(n, d, slot=None):
            v, tex = self._resolve_tex(tp, n, d, is_float=True)
            if tex is not None and slot is not None and tex in self.tex_ids:
                tex_ids[slot] = self.tex_ids[tex]
            return float(np.mean(v))

        T = mat_mod
        # displacement -> shading-normal perturbation: every material honors
        # "texture bumpmap"
        f1("bumpmap", 0.0, T.TEX_BUMP)
        if name == "matte":
            return mat_mod.matte(kd=spec3("Kd", (0.5,) * 3, T.TEX_KD),
                                 sigma=f1("sigma", 0.0, T.TEX_SIGMA),
                                 tex_ids=tex_ids)
        if name == "plastic":
            return mat_mod.plastic(kd=spec3("Kd", (0.25,) * 3, T.TEX_KD),
                                   ks=spec3("Ks", (0.25,) * 3, T.TEX_KS),
                                   roughness=f1("roughness", 0.1,
                                                T.TEX_ROUGH),
                                   tex_ids=tex_ids)
        if name == "mirror":
            return mat_mod.mirror(kr=spec3("Kr", (0.9,) * 3, T.TEX_KR),
                                  tex_ids=tex_ids)
        if name == "glass":
            return mat_mod.glass(kr=spec3("Kr", (1.0,) * 3, T.TEX_KR),
                                 kt=spec3("Kt", (1.0,) * 3, T.TEX_KT),
                                 index=f1("index", 1.5), tex_ids=tex_ids)
        if name == "metal":
            return mat_mod.metal(eta=spec3("eta", mat_mod.COPPER_ETA),
                                 k=spec3("k", mat_mod.COPPER_K),
                                 roughness=f1("roughness", 0.01,
                                              T.TEX_ROUGH),
                                 tex_ids=tex_ids)
        if name == "shinymetal":
            return mat_mod.shinymetal(ks=spec3("Ks", (1.0,) * 3, T.TEX_KS),
                                      kr=spec3("Kr", (1.0,) * 3, T.TEX_KR),
                                      roughness=f1("roughness", 0.1,
                                                   T.TEX_ROUGH),
                                      tex_ids=tex_ids)
        if name == "substrate":
            urough = f1("uroughness", 0.1, T.TEX_ROUGH)
            return mat_mod.substrate(kd=spec3("Kd", (0.5,) * 3, T.TEX_KD),
                                     ks=spec3("Ks", (0.5,) * 3, T.TEX_KS),
                                     roughness=urough,
                                     vroughness=geom_params.find_one_float(
                                         "vroughness", urough),
                                     tex_ids=tex_ids)
        if name == "translucent":
            return mat_mod.translucent(
                kd=spec3("Kd", (0.25,) * 3, T.TEX_KD),
                ks=spec3("Ks", (0.25,) * 3, T.TEX_KS),
                roughness=f1("roughness", 0.1, T.TEX_ROUGH),
                reflect=spec3("reflect", (0.5,) * 3),
                transmit=spec3("transmit", (0.5,) * 3), tex_ids=tex_ids)
        if name == "uber":
            return mat_mod.uber(kd=spec3("Kd", (0.25,) * 3, T.TEX_KD),
                                ks=spec3("Ks", (0.25,) * 3, T.TEX_KS),
                                kr=spec3("Kr", (0.0,) * 3, T.TEX_KR),
                                kt=spec3("Kt", (0.0,) * 3, T.TEX_KT),
                                roughness=f1("roughness", 0.1, T.TEX_ROUGH),
                                index=f1("index", 1.5),
                                opacity=spec3("opacity", (1.0,) * 3),
                                tex_ids=tex_ids)
        if name == "mix":
            m1 = self.gs.named_materials.get(
                geom_params.find_one_string("namedmaterial1", ""))
            m2 = self.gs.named_materials.get(
                geom_params.find_one_string("namedmaterial2", ""))
            amt = spec3("amount", (0.5,) * 3)
            if m1 and m2:
                self.log("warning: 'mix' material blends the two materials' "
                         "PARAMETERS into one fixed-slot BSDF (the reference "
                         "scales and stacks both lobe sets, "
                         "mix_material.dart); highlight shapes can differ")
                return mat_mod.mix_materials(m1, m2, amt)
            self.log("warning: mix material missing named materials")
            return mat_mod.matte()
        if name in ("subsurface", "kdsubsurface"):
            # a glossy dielectric coat; the diffusion term is the
            # dipolesubsurface integrator's, from the row's medium
            from ..integrators import dipole as dp
            eta = f1("index", 1.3)
            scale = geom_params.find_one_float("scale", 1.0)
            if name == "subsurface":
                preset = geom_params.find_one_string("name", "")
                if preset:
                    sps, sa = dp.media_params(preset)
                else:
                    sps = np.asarray(geom_params.find_one_spectrum(
                        "sigma_prime_s", (2.55, 3.21, 3.77)), np.float32)
                    sa = np.asarray(geom_params.find_one_spectrum(
                        "sigma_a", (0.0011, 0.0024, 0.014)), np.float32)
            else:   # from a diffuse colour and a mean free path
                kd = np.asarray(geom_params.find_one_spectrum(
                    "Kd", (0.5, 0.5, 0.64)), np.float32)
                mfp = geom_params.find_one_float("meanfreepath", 1.0)
                sps = np.clip(kd, 1e-3, 0.999) / mfp
                sa = np.clip(1.0 - kd, 1e-3, 1.0) / mfp
            row = mat_mod.plastic(kd=(0.0,) * 3, ks=(1.0,) * 3,
                                  roughness=f1("roughness", 0.05),
                                  tex_ids=tex_ids)
            row["_sss"] = (tuple(float(x) for x in sps * scale),
                           tuple(float(x) for x in sa * scale), float(eta))
            return row
        if name == "measured":
            # an unloadable file is a warning and a matte material (known
            # behaviour k): the scene file's semantics
            fname = geom_params.find_one_string("filename", "")
            if fname and self.resolver is not None:
                try:
                    data = merl.load(self.resolver(fname, binary=True),
                                     fname)
                    return mat_mod.measured(data, key=fname,
                                            tex_ids=tex_ids)
                except Exception as e:  # noqa: BLE001
                    self.log(f"warning: measured {fname!r} failed: {e}")
            self.log("warning: measured material without loadable file; "
                     "using matte")
            return mat_mod.matte(kd=(0.5,) * 3)
        self.log(f"warning: unknown material {name!r}; using matte")
        return mat_mod.matte()

    # --- lights -----------------------------------------------------------
    def light_source(self, name, params):
        l2w = self.ctm[0]
        w2l = np.asarray(l2w.m_inv, np.float64)
        scale_ = params.find_one_spectrum("scale", (1, 1, 1))
        if name == "point":
            i = params.find_one_spectrum("I", (1, 1, 1)) * scale_
            frm = params.find_one_point("from", (0, 0, 0))
            p = l2w.xform_point(np.asarray(frm, np.float32))
            self.builder.add_light(lt_mod.point_light(np.asarray(p), tuple(i)))
        elif name == "spot":
            i = params.find_one_spectrum("I", (1, 1, 1)) * scale_
            frm = params.find_one_point("from", (0, 0, 0))
            to = params.find_one_point("to", (0, 0, 1))
            cone = params.find_one_float("coneangle", 30.0)
            delta = params.find_one_float("conedeltaangle", 5.0)
            # light-to-world from the from / to direction
            p_w = np.asarray(l2w.xform_point(np.asarray(frm, np.float32)))
            to_w = np.asarray(l2w.xform_point(np.asarray(to, np.float32)))
            d = to_w - p_w
            d = d / max(np.linalg.norm(d), 1e-12)
            du, dv = _coord_sys(d)
            l2w_m = np.eye(4)
            l2w_m[:3, 0] = du
            l2w_m[:3, 1] = dv
            l2w_m[:3, 2] = d
            l2w_m[:3, 3] = p_w
            self.builder.add_light(lt_mod.spot_light(
                tuple(p_w), np.linalg.inv(l2w_m), tuple(i), cone, delta))
        elif name == "distant":
            L = params.find_one_spectrum("L", (1, 1, 1)) * scale_
            frm = params.find_one_point("from", (0, 0, 0))
            to = params.find_one_point("to", (0, 0, 1))
            frm_w = np.asarray(l2w.xform_point(np.asarray(frm, np.float32)))
            to_w = np.asarray(l2w.xform_point(np.asarray(to, np.float32)))
            self.builder.add_light(lt_mod.distant_light(frm_w - to_w,
                                                        tuple(L)))
        elif name == "infinite":
            # a map that does not load is a warning and a white map: the
            # scene file's semantics, as in the reference
            L = params.find_one_spectrum("L", (1, 1, 1)) * scale_
            env = self._light_map(params, "envmap {!r} load failed")
            if env is None:
                env = np.ones((16, 32, 3), np.float32)
            self.builder.add_light(lt_mod.infinite_light(
                env, w2l=w2l, L_scale=tuple(L)))
        elif name in ("projection", "goniometric"):
            i = params.find_one_spectrum("I", (1, 1, 1)) * scale_
            p = np.asarray(l2w.xform_point(np.zeros(3, np.float32)))
            img = self._light_map(params, "light map {!r} failed")
            if name == "projection":
                fov = params.find_one_float("fov", 45.0)
                self.builder.add_light(lt_mod.projection_light(
                    tuple(p), w2l, tuple(i), fov, proj_map=img))
            else:
                self.builder.add_light(lt_mod.goniometric_light(
                    tuple(p), w2l, tuple(i), gonio_map=img))
        else:
            self.log(f"warning: unknown light {name!r}")

    def _light_map(self, params, failed):
        """The image a light's "mapname" names, or None (no name, no
        resolver, or a load that failed: logged as `failed`)."""
        mapname = params.find_one_string("mapname", "")
        if not mapname or self.resolver is None:
            return None
        try:
            return io_img.load(self.resolver(mapname, binary=True), mapname)
        except Exception as e:  # noqa: BLE001
            self.log(f"warning: {failed.format(mapname)}: {e}")
            return None

    def area_light_source(self, name, params):
        L = params.find_one_spectrum("L", (1, 1, 1))
        scale_ = params.find_one_spectrum("scale", (1, 1, 1))
        ns = params.find_one_int("nsamples", 1)
        self.gs.area_light = (tuple(np.asarray(L) * np.asarray(scale_)), ns)

    # --- shapes -----------------------------------------------------------
    def shape(self, name, params):
        m = self._make_shape(name, params)
        if m is None:
            return
        o2w = _np4(self.ctm[0])
        o2w1 = _np4(self.ctm[1])
        if self.gs.reverse_orientation:
            m = mesh_mod.TriangleMesh(m.verts, m.faces[:, [0, 2, 1]].copy(),
                                      None if m.normals is None else -m.normals,
                                      m.uvs, m.alpha_tid)
        # object motion blur: differing endpoint CTMs store shutter-end
        # vertex positions beside the start positions
        animated_obj = not np.allclose(o2w, o2w1, atol=1e-7)
        m_t = m.transformed(o2w)
        if animated_obj:
            m_t.verts_end = m.transformed(o2w1).verts
        m = m_t
        if self.current_object is not None:
            self.objects[self.current_object].append(
                (m, dict(self.gs.material), self.gs.area_light))
            return
        mat_id = self._material_id(self.gs.material)
        if self.gs.area_light is not None:
            L, ns = self.gs.area_light
            self.builder.add_mesh(m, mat_id, area_light_L=L, n_samples=ns)
        else:
            self.builder.add_mesh(m, mat_id)

    def _load_spd(self, name: str):
        """Read an .spd file (whitespace floats, # comments) ->
        (lambdas, values)."""
        if self.resolver is None:
            return None
        try:
            import re as _re
            text = self.resolver(name)
            if isinstance(text, bytes):
                text = text.decode("utf-8", "replace")
            toks = [t for t in _re.split(
                r"\s+", _re.sub(r"#[^\n]*", " ", text)) if t]
            arr = np.asarray([float(t) for t in toks],
                             np.float64).reshape(-1, 2)
            return arr[:, 0], arr[:, 1]
        except Exception as e:  # noqa: BLE001
            self.log(f"warning: spd file {name!r} failed: {e}")
            return None

    def _material_id(self, row: dict) -> int:
        key = repr(sorted((k, str(v)) for k, v in row.items()))
        if key not in self._mat_cache:
            row2 = dict(row)
            media = row2.pop("_sss", None)
            mat_id = self.builder.add_material(row2)
            if media is not None:
                self.sss_map[mat_id] = media
            self._mat_cache[key] = mat_id
        return self._mat_cache[key]

    def _make_shape(self, name, p: ps.ParamSet):
        if name == "sphere":
            return mesh_mod.sphere(
                radius=p.find_one_float("radius", 1.0),
                zmin=p.find_one_float("zmin", -p.find_one_float("radius", 1.0)),
                zmax=p.find_one_float("zmax", p.find_one_float("radius", 1.0)),
                phi_max_deg=p.find_one_float("phimax", 360.0))
        if name == "cylinder":
            return mesh_mod.cylinder(
                radius=p.find_one_float("radius", 1.0),
                zmin=p.find_one_float("zmin", -1.0),
                zmax=p.find_one_float("zmax", 1.0),
                phi_max_deg=p.find_one_float("phimax", 360.0))
        if name == "disk":
            return mesh_mod.disk(
                height=p.find_one_float("height", 0.0),
                radius=p.find_one_float("radius", 1.0),
                inner_radius=p.find_one_float("innerradius", 0.0),
                phi_max_deg=p.find_one_float("phimax", 360.0))
        if name == "cone":
            return mesh_mod.cone(radius=p.find_one_float("radius", 1.0),
                                 height=p.find_one_float("height", 1.0),
                                 phi_max_deg=p.find_one_float("phimax", 360.0))
        if name == "paraboloid":
            return mesh_mod.paraboloid(
                radius=p.find_one_float("radius", 1.0),
                zmin=p.find_one_float("zmin", 0.0),
                zmax=p.find_one_float("zmax", 1.0),
                phi_max_deg=p.find_one_float("phimax", 360.0))
        if name == "hyperboloid":
            return mesh_mod.hyperboloid(
                p1=tuple(p.find_one_point("p1", (0, 0, 0))),
                p2=tuple(p.find_one_point("p2", (1, 1, 1))),
                phi_max_deg=p.find_one_float("phimax", 360.0))
        if name == "trianglemesh":
            idx = p.find_ints("indices")
            pts = p.find_points("P")
            if idx is None or pts is None:
                self.log("warning: trianglemesh missing indices/P")
                return None
            normals = p.find_points("N")
            uv = p.find_uvs("uv")
            if uv is None:
                uv = p.find_uvs("st")
            m = mesh_mod.make_mesh(pts, idx.reshape(-1, 3), normals, uv)
            # alpha-mask cut-outs: a float texture at the hit uv
            aname = p.find_texture("alpha")
            if aname is not None:
                tid = self.tex_ids.get(aname)
                if tid is None:
                    self.log(f"warning: alpha texture {aname!r} unknown")
                else:
                    m.alpha_tid = tid
            return m
        if name == "heightfield":
            nu = p.find_one_int("nu", 2)
            nv = p.find_one_int("nv", 2)
            z = p.find_floats("Pz")
            if z is None:
                return None
            return mesh_mod.heightfield(nu, nv, z)
        if name == "loopsubdiv":
            idx = p.find_ints("indices")
            pts = p.find_points("P")
            n = p.find_one_int("nlevels", 3)
            if idx is None or pts is None:
                return None
            base = mesh_mod.make_mesh(pts, idx.reshape(-1, 3))
            return mesh_mod.loop_subdivide(base, n)
        if name == "nurbs":
            nu = p.find_one_int("nu", -1)
            nv = p.find_one_int("nv", -1)
            uorder = p.find_one_int("uorder", -1)
            vorder = p.find_one_int("vorder", -1)
            uknots = p.find_floats("uknots")
            vknots = p.find_floats("vknots")
            pts = p.find_points("P")
            pw = p.find_floats("Pw")
            if (nu < 0 or nv < 0 or uorder < 0 or vorder < 0
                    or uknots is None or vknots is None
                    or (pts is None and pw is None)):
                self.log("warning: nurbs missing nu/nv/uorder/vorder/"
                         "uknots/vknots/P|Pw")
                return None
            inf = float("inf")
            opt = lambda k: (None if (x := p.find_one_float(k, inf)) == inf
                             else x)
            return mesh_mod.nurbs(
                nu, uorder, uknots, nv, vorder, vknots,
                P=pts, Pw=(None if pw is None else pw.reshape(-1, 4)),
                u0=opt("u0"), u1=opt("u1"), v0=opt("v0"), v1=opt("v1"))
        self.log(f"warning: unknown shape {name!r}")
        return None

    # --- object instancing ------------------------------------------------
    def object_begin(self, name):
        self.attribute_begin()
        self.objects[name] = []
        self.current_object = name

    def object_end(self):
        self.current_object = None
        self.attribute_end()

    def object_instance(self, name):
        if name not in self.objects:
            self.log(f"warning: unknown object {name!r}")
            return
        o2w = _np4(self.ctm[0])
        for m, mat_row, area_l in self.objects[name]:
            mi = self._material_id(mat_row)
            mm = m.transformed(o2w)
            if area_l is not None:
                self.builder.add_mesh(mm, mi, area_light_L=area_l[0],
                                      n_samples=area_l[1])
            else:
                self.builder.add_mesh(mm, mi)

    # --- volumes ----------------------------------------------------------
    def volume(self, name, params):
        self.volumes.append((name, params, _np4(self.ctm[0])))

    # --- worldEnd: assemble -----------------------------------------------
    def world_end(self) -> RenderJob:
        film_name, film_p = self.opts["film"]
        width = film_p.find_one_int("xresolution", 640)
        height = film_p.find_one_int("yresolution", 480)
        crop = film_p.find_floats("cropwindow")
        crop = tuple(crop) if crop is not None else (0.0, 1.0, 0.0, 1.0)

        cam_name, cam_p = self.opts["camera"]
        c2w_t = self.opts["camera_to_world"][0]
        shutter_open = cam_p.find_one_float("shutteropen", 0.0)
        shutter_close = cam_p.find_one_float("shutterclose", 1.0)
        # an animated camera transform is stored on the camera and never
        # applied (rays leave through the shutter-open transform c2w_t)
        animated = None
        c2w0, c2w1 = self.opts["camera_to_world"]
        if not np.allclose(np.asarray(c2w0.m), np.asarray(c2w1.m)):
            animated = tr.animated(c2w0, c2w1, shutter_open, shutter_close)
        common = dict(lens_radius=cam_p.find_one_float("lensradius", 0.0),
                      focal_distance=cam_p.find_one_float("focaldistance",
                                                          1e30),
                      shutter_open=shutter_open, shutter_close=shutter_close,
                      animated=animated, device=self.device)
        sw = cam_p.find_floats("screenwindow")
        if sw is not None:
            common["screen_window"] = tuple(sw)
        if cam_name == "perspective":
            camera = cam_mod.perspective(
                c2w_t, cam_p.find_one_float("fov", 60.0), width, height,
                **common)
        elif cam_name == "orthographic":
            camera = cam_mod.orthographic(c2w_t, width, height, **common)
        elif cam_name == "environment":
            camera = cam_mod.environment(
                c2w_t, width, height, shutter_open=shutter_open,
                shutter_close=shutter_close, animated=animated,
                device=self.device)
        else:
            self.log(f"warning: unknown camera {cam_name!r}; perspective")
            camera = cam_mod.perspective(c2w_t, 60.0, width, height, **common)

        smp_name, smp_p = self.opts["sampler"]
        spp = smp_p.find_one_int("pixelsamples", 4)
        if smp_name == "stratified":
            spp = (smp_p.find_one_int("xsamples", 2)
                   * smp_p.find_one_int("ysamples", 2))
        adaptive = None
        if smp_name == "adaptive":
            # the contrast method: (minsamples, maxsamples)
            adaptive = (smp_p.find_one_int("minsamples", 4),
                        smp_p.find_one_int("maxsamples", 32))
            spp = adaptive[1]
        elif smp_name not in _SAMPLERS:
            self.log(f"warning: unknown sampler {smp_name!r}; "
                     f"using lowdiscrepancy")
        sampler = smp_mod.make_sampler(
            smp_name if smp_name in _SAMPLERS else "lowdiscrepancy",
            spp=spp, jitter=smp_p.find_one_bool("jitter", True))

        filt_name, filt_p = self.opts["filter"]
        filt_params = {}
        for k in ("xwidth", "ywidth", "alpha", "B", "C", "tau"):
            if k in filt_p.items:
                filt_params[k] = filt_p.find_one_float(k)

        if self.volumes:
            self.builder.volume = vol_mod.build_volume(self.volumes)

        accel_name, accel_p = self.opts["accelerator"]
        split = accel_p.find_one_string("splitmethod", "sah")
        self.builder.shutter = (shutter_open, shutter_close)
        accel = "bvh"
        if accel_name in ("kdtree", "grid"):
            accel = accel_name
        elif accel_name not in ("bvh", "bruteforce"):
            self.log(f"warning: unknown accelerator {accel_name!r}; "
                     f"using the cluster BVH")
        if self.tex_ids:
            self.builder.textures = self.tex_builder.build()
        scene = self.builder.build(split_method=split, accelerator=accel)
        si_name, si_p = self.opts["surf_integrator"]
        vi_name, vi_p = self.opts["vol_integrator"]
        r_name, r_p = self.opts["renderer"]
        self.state = "options"
        return RenderJob(scene=scene, camera=camera, sampler=sampler,
                         width=width, height=height, filter_name=filt_name,
                         filter_params=filt_params,
                         surf_integrator=si_name, surf_params=si_p,
                         vol_integrator=vi_name, vol_params=vi_p,
                         renderer=r_name, renderer_params=r_p, crop=crop,
                         sss=dict(self.sss_map), adaptive=adaptive)


def _coord_sys(d):
    if abs(d[0]) > abs(d[1]):
        inv = 1.0 / np.sqrt(d[0] ** 2 + d[2] ** 2)
        du = np.array([-d[2] * inv, 0.0, d[0] * inv])
    else:
        inv = 1.0 / np.sqrt(d[1] ** 2 + d[2] ** 2)
        du = np.array([0.0, d[2] * inv, -d[1] * inv])
    dv = np.cross(d, du)
    return du, dv
