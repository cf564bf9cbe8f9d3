"""PyTorch port, the scene front door on the host: lexer, ParamSet,
resolver, the API's CTM stack and shapes, the compiled scene of a parsed
file, image I/O, log, stats and the render overrides, each against the JAX
reference on the same input.

Scene compilation is numpy on both sides, so a parsed scene is held bit for
bit (``torchhelp.same_bits``, leaf by leaf); the spectral conversions to
rtol 1e-6. Nothing here renders.
"""
import bz2
import dataclasses
import collections
import gzip
import io
import os
import sys
import zipfile

import numpy as np
import pytest
import torch

from dartray_tpu import log as ref_log
from dartray_tpu import stats as ref_stats
from dartray_tpu.core import spectrum as ref_spec
from dartray_tpu.io import image as ref_img
from dartray_tpu.renderers import manager as ref_manager
from dartray_tpu.scene import lexer as ref_lx
from dartray_tpu.scene import paramset as ref_ps
from dartray_tpu.scene import parser as ref_parser
from dartray_tpu.scene import resources as ref_res

from dartray_tpu_torch import log as log_mod
from dartray_tpu_torch import stats as stats_mod
from dartray_tpu_torch.core import spectrum as spec
from dartray_tpu_torch.io import image as io_img
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.scene import lexer as lx
from dartray_tpu_torch.scene import paramset as ps
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import resources

import torchhelp as th

torch.set_num_threads(1)

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
QUIET = lambda *a, **k: None   # noqa: E731


def _read(name):
    with open(os.path.join(SCENES, name)) as f:
        return f.read()


def _assert_same_leaves(port_tree, ref_tree):
    """Every leaf of the port's tree equals the reference's of the same
    path: arrays bit for bit, scalars and tuples by value."""
    n = 0
    for path, leaf in th.port_leaves(port_tree).items():
        want = th.ref_leaf(ref_tree, path)
        if isinstance(leaf, np.ndarray):
            assert th.same_bits(leaf, want), path
        elif isinstance(leaf, float):
            assert leaf == float(want), path
        else:
            assert leaf == want, path
        n += 1
    assert n > 60      # the whole tree was walked


def _parse_both(text, resolvers=(None, None)):
    """(port job, reference job) of the same scene text."""
    port = parser.parse(text, resolver=resolvers[0], log=QUIET, device="cpu")
    ref = ref_parser.parse(text, resolver=resolvers[1], log=QUIET)
    return port, ref


def _same_scene(text, resolvers=(None, None)):
    port, ref = _parse_both(text, resolvers)
    _assert_same_leaves(port.scene, th.np_tree(ref.scene))
    return port, ref


HEADER = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 4 4]
  Translate 0 3 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-0.5 0 -0.5  0.5 0 -0.5  0.5 0 0.5  -0.5 0 0.5]
AttributeEnd
"""
QUAD = ('Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" '
        '[-1 0 -1  1 0 -1  1 0 1  -1 0 1]\n')


def _scene(body):
    return HEADER + body + "WorldEnd\n"


# --- lexer ------------------------------------------------------------------

LEX_TEXT = ('# comment "with quotes" [x]\nShape "sphere" "float radius"'
            ' [2.5] Translate -1 +2 .5e1 1.2.3 -x\n"a b" ["s"]#tail\n'
            'Rotate 1e-3 0 1 0 Texture"t""color""constant"\n')


@pytest.mark.parametrize("name", ["synthetic", "cornell.pbrt",
                                  "igi-env.pbrt", "smoke.pbrt"])
def test_token_streams_equal(name):
    text = LEX_TEXT if name == "synthetic" else _read(name)
    got = list(lx.tokenize(text))
    want = list(ref_lx.tokenize(text))
    assert [tuple(t) for t in got] == [tuple(t) for t in want]
    assert all(type(a.value) is type(b.value) for a, b in zip(got, want))
    assert (lx.IDENT, lx.NUMBER, lx.STRING, lx.LBRACK, lx.RBRACK,
            lx.EOF) == (ref_lx.IDENT, ref_lx.NUMBER, ref_lx.STRING,
                        ref_lx.LBRACK, ref_lx.RBRACK, ref_lx.EOF)


# --- ParamSet ---------------------------------------------------------------

PARAMS = [
    ("float", [0.25, 3], "find_one_float"),
    ("integer", [3, 4, 5], "find_ints"),
    ("bool", ["true"], "find_one_bool"),
    ("string", ["x.png", "y"], "find_strings"),
    ("point", [1, 2, 3, 4, 5, 6], "find_points"),
    ("normal", [0, 0, 1], "find_one_point"),
    ("vector", [1.5, -2, 0.125], "find_one_point"),
    ("rgb", [0.5, 0.2, 0.1], "find_one_spectrum"),
    ("color", [0.9, 0.8, 0.7], "find_one_spectrum"),
    ("xyz", [0.3, 0.4, 0.2], "find_one_spectrum"),
    ("spectrum", [400, 0.2, 500, 0.8, 600, 0.5, 700, 0.1],
     "find_one_spectrum"),
    ("blackbody", [5500, 2.0], "find_one_spectrum"),
    ("texture", ["checks"], "find_texture"),
]


@pytest.mark.parametrize("ptype,values,finder", PARAMS,
                         ids=[p[0] for p in PARAMS])
def test_paramset_types_equal(ptype, values, finder):
    """Each parameter type, read back by its finder (and the untyped
    readers), gives the reference's values: exact, except the spectral
    conversions, which go through float32 (rtol 1e-6)."""
    p, r = ps.ParamSet(), ref_ps.ParamSet()
    p.add(f"{ptype} x", values)
    r.add(f"{ptype} x", values)
    got = getattr(p, finder)("x")
    want = getattr(r, finder)("x")
    if ptype in ("spectrum", "blackbody"):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    elif isinstance(got, np.ndarray):
        assert th.same_bits(got, np.asarray(want))
    else:
        assert got == want and type(got) is type(want)
    for f in ("find_one_float", "find_one_int", "find_one_string",
              "find_floats", "find_uvs"):
        try:
            want = getattr(r, f)("x")
        except (TypeError, ValueError):
            with pytest.raises((TypeError, ValueError)):
                getattr(p, f)("x")
            continue
        got = getattr(p, f)("x")
        assert (th.same_bits(got, want) if isinstance(got, np.ndarray)
                else got == want)
    assert p.to_json() == r.to_json()
    assert ps.ParamSet.from_json(p.to_json()).items == \
        ref_ps.ParamSet.from_json(r.to_json()).items
    assert p.report_unused() == r.report_unused()


def test_spectral_conversions_match():
    """spd_to_rgb, blackbody and the observer fit against the reference,
    rtol 1e-6."""
    lam = np.arange(380.0, 781.0, 5.0)
    for temp in (2700.0, 5500.0, 9000.0):
        np.testing.assert_allclose(spec.blackbody(lam, temp),
                                   ref_spec.blackbody(lam, temp), rtol=1e-6)
        sp = ref_spec.blackbody(lam, temp)
        got = spec.spd_to_rgb(lam, sp / sp.max())
        assert got.dtype == np.float32
        np.testing.assert_allclose(
            got, np.asarray(ref_spec.spd_to_rgb(lam, sp / sp.max())),
            rtol=1e-6)
    np.testing.assert_allclose(spec.cie_xyz_fit(lam),
                               ref_spec.cie_xyz_fit(lam), rtol=1e-6)


def test_texture_params_and_constant_textures():
    """Material parameters through named constant textures (float and
    color) and TextureParams' geometry-over-material lookup: the same
    compiled material and texture tables."""
    text = _scene(
        'Texture "k" "color" "constant" "rgb value" [0.2 0.4 0.6]\n'
        'Texture "s" "float" "constant" "float value" [0.3]\n'
        'Material "matte" "texture Kd" "k" "texture sigma" "s"\n' + QUAD +
        'Material "matte" "texture Kd" "nope" "spectrum Kd" '
        '[400 0.1 700 0.9]\n' + QUAD +
        'Material "glass" "xyz Kr" [0.3 0.3 0.3] "float index" [1.33]\n'
        + QUAD + 'Material "mirror" "blackbody Kr" [3000 0.5]\n' + QUAD)
    port, ref = _same_scene(text)
    assert port.scene.textures.n == 2 and port.scene.materials.n >= 4


# --- resolver and Include ---------------------------------------------------

def test_resolver_finds_includes(tmp_path):
    """Include through the search path, a gzip file and a zip archive, and
    an .spd file through the API's loader: the same text, and the same
    scene."""
    inc = 'Material "matte" "rgb Kd" [0.2 0.3 0.4]\n' + QUAD
    (tmp_path / "plain.pbrt").write_text(inc)
    (tmp_path / "packed.pbrt.gz").write_bytes(gzip.compress(
        inc.replace("0.2 0.3", "0.5 0.6").encode()))
    (tmp_path / "b.pbrt.bz2").write_bytes(bz2.compress(inc.encode()))
    (tmp_path / "k.spd").write_text("# measured\n400 0.1\n550 0.7\n"
                                    "700 0.9\n")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("scene/zipped.pbrt", inc.replace("0.4]", "0.9]"))
    res = [resources.Resolver([str(tmp_path)]),
           ref_res.Resolver([str(tmp_path)])]
    for r in res:
        r.add_archive(buf.getvalue())
    for name in ("plain.pbrt", "packed.pbrt", "b.pbrt.bz2", "zipped.pbrt",
                 "scene/zipped.pbrt"):
        assert res[0](name) == res[1](name), name
        assert res[0](name, binary=True) == res[1](name, binary=True)
    with pytest.raises(FileNotFoundError):
        res[0]("missing.pbrt")
    text = _scene('Include "plain.pbrt"\nInclude "packed.pbrt"\n'
                  'Include "zipped.pbrt"\n'
                  'Material "matte" "spectrum Kd" "k.spd"\n' + QUAD)
    port, _ = _same_scene(text, resolvers=tuple(res))
    # the light's default matte, the three included and the .spd one
    assert port.scene.materials.n == 5


# --- the CTM stack and the API's state ---------------------------------------

CTM_CASES = {
    "translate": "Translate 0.3 -0.2 0.5\n" + QUAD,
    "rotate": "Rotate 33 0.2 1 0.4\n" + QUAD,
    "scale": "Scale 1.5 -2 0.75\n" + QUAD,
    "concat": "ConcatTransform 0.9 0.1 0 0  -0.1 0.9 0 0  0 0 1 0  "
              "0.2 0.3 0.4 1\n" + QUAD,
    "transform": "Translate 5 5 5\nTransform 1 0 0 0  0 0.8 0.6 0  "
                 "0 -0.6 0.8 0  0.1 0.2 0.3 1\n" + QUAD,
    "coordsys": "Translate 1 0 0\nCoordinateSystem \"here\"\nIdentity\n"
                "Rotate 45 0 1 0\nCoordSysTransform \"here\"\n" + QUAD
                + "CoordSysTransform \"camera\"\n" + QUAD,
    "transform_block": "TransformBegin\nRotate 20 1 0 0\n" + QUAD
                       + "TransformEnd\nTranslate 0 0.5 0\n" + QUAD,
    "attribute_block": "AttributeBegin\nMaterial \"mirror\"\n"
                       "Scale 2 2 2\n" + QUAD + "AttributeEnd\n" + QUAD,
    "reverse_orientation": "ReverseOrientation\nShape \"trianglemesh\" "
                           "\"integer indices\" [0 1 2] \"point P\" "
                           "[0 0 0 1 0 0 0 1 0] \"normal N\" "
                           "[0 0 1 0 0 1 0 0 1] \"float uv\" [0 0 1 0 0 1]\n",
    "instance": "ObjectBegin \"q\"\nMaterial \"glass\"\nTranslate 0 0.1 0\n"
                + QUAD + "ObjectEnd\nTranslate 1 0 0\nObjectInstance \"q\"\n"
                "Rotate 90 0 1 0\nObjectInstance \"q\"\n",
    "motion": "ActiveTransform StartTime\nTranslate 0 0 0\n"
              "ActiveTransform EndTime\nTranslate 0.4 0 0\n"
              "ActiveTransform All\nTransformTimes 0 1\n"
              "Shape \"sphere\" \"float radius\" [0.3]\n",
    "lights": "LightSource \"point\" \"point from\" [0 2 0] \"rgb I\" "
              "[3 3 3]\nRotate 30 0 0 1\nLightSource \"spot\" \"point from\" "
              "[0 2 -1] \"point to\" [0 0 0] \"float coneangle\" [25]\n"
              "LightSource \"distant\" \"point from\" [0 1 0] \"point to\" "
              "[0 0 0] \"color L\" [0.5 0.5 0.5] \"rgb scale\" [2 1 1]\n"
              + QUAD,
}


@pytest.mark.parametrize("case", sorted(CTM_CASES))
def test_ctm_stack_and_state_compile_equal(case):
    port, _ = _same_scene(_scene(CTM_CASES[case]))
    if case == "motion":
        assert port.scene.geometry.has_motion


@pytest.mark.parametrize("stmt", ["ConcatTransform", "Transform",
                                  "Translate"])
def test_bracketed_numbers_of_a_transform_fail_as_in_the_reference(stmt):
    """The reference's statement reader skips a '[' before its numbers and
    leaves the ']' after them, which then fails as a statement (a known
    behaviour of the reference, which the port keeps)."""
    nums = "1 2 3" if stmt == "Translate" else " ".join(
        "1" if i % 5 == 0 else "0" for i in range(16))
    text = _scene(f"{stmt} [{nums}]\n" + QUAD)
    for parse in (lambda: parser.parse(text, log=QUIET, device="cpu"),
                  lambda: ref_parser.parse(text, log=QUIET)):
        with pytest.raises(SyntaxError, match="unexpected token ']'"):
            parse()


SHAPES = {
    "cylinder": '"float radius" [0.5] "float zmin" [-0.2] "float zmax" [0.7]'
                ' "float phimax" [270]',
    "disk": '"float radius" [0.8] "float innerradius" [0.2] '
            '"float height" [0.1]',
    "cone": '"float radius" [0.6] "float height" [1.2]',
    "paraboloid": '"float radius" [0.7] "float zmin" [0.1] "float zmax" '
                  '[0.9]',
    "hyperboloid": '"point p1" [0.3 0 -0.5] "point p2" [0.1 0.4 0.5]',
    "heightfield": '"integer nu" [4] "integer nv" [3] "float Pz" '
                   '[0 0.1 0.2 0.1 0.3 0.5 0.2 0.1 0 0.4 0.1 0.2]',
    "loopsubdiv": '"integer nlevels" [2] "integer indices" '
                  '[0 1 2 0 2 3 0 3 1 1 3 2] "point P" '
                  '[0 0 0 1 0 0 0 1 0 0 0 1]',
    "nurbs": '"integer nu" [3] "integer nv" [3] "integer uorder" [3] '
             '"integer vorder" [3] "float uknots" [0 0 0 1 1 1] '
             '"float vknots" [0 0 0 1 1 1] "float Pw" '
             '[0 0 0 1  1 0 0.5 0.8  2 0 0 1  0 1 0.3 1  1 1 1 2  2 1 0.2 1'
             '  0 2 0 1  1 2 0.4 0.9  2 2 0 1]',
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tessellator_compiles_equal(shape):
    port, _ = _same_scene(_scene(f'Shape "{shape}" {SHAPES[shape]}\n'))
    assert port.scene.geometry.n_prims > 2


def test_cornell_job_and_scene_are_the_references():
    """scenes/cornell.pbrt: every field of the RenderJob and every leaf of
    the compiled scene."""
    text = _read("cornell.pbrt")
    port, ref = _same_scene(text)
    for f in ("width", "height", "filter_name", "filter_params",
              "surf_integrator", "vol_integrator", "renderer", "crop",
              "sampling_mode"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("surf_params", "vol_params", "renderer_params"):
        assert getattr(port, f).to_json() == getattr(ref, f).to_json(), f
    assert (port.sampler.kind, port.sampler.spp) == (
        int(ref.sampler.kind), int(ref.sampler.spp))
    cam, rcam = port.camera, ref.camera
    for f in ("raster2camera", "dx_camera", "dy_camera"):
        assert th.same_bits(np.asarray(getattr(cam, f), np.float32),
                            np.asarray(getattr(rcam, f))), f
    for f in ("lens_radius", "focal_distance", "shutter_open",
              "shutter_close"):
        assert getattr(cam, f) == float(getattr(rcam, f)), f
    assert th.same_bits(cam.cam2world.m, np.asarray(rcam.cam2world.m))
    assert cam.device == torch.device("cpu")


def test_unknown_names_warn_and_fall_back_as_the_reference():
    """An unknown material, light, shape, texture type, sampler, camera and
    accelerator: the same warnings, the same fallbacks, the same scene."""
    text = ('Sampler "sobol" "integer pixelsamples" [2]\n'
            'Accelerator "octree"\n' + HEADER.replace('"perspective"',
                                                     '"fisheye"')
            + 'Texture "w" "color" "wavy"\nMaterial "velvet"\n' + QUAD
            + 'LightSource "laser"\nShape "teapot"\nWorldEnd\n')
    logs = ([], [])
    port = parser.parse(text, log=logs[0].append, device="cpu")
    ref = ref_parser.parse(text, log=logs[1].append)
    _assert_same_leaves(port.scene, th.np_tree(ref.scene))
    assert logs[0] == logs[1] and len(logs[0]) == 7, logs
    assert port.sampler.spp == int(ref.sampler.spp)


# the precomputed-transfer integrators and the createprobes and metropolis
# renderers, with every option they read set away from its default
PRT_MLT_KINDS = {
    "diffuseprt": 'SurfaceIntegrator "diffuseprt" "integer lmax" [2] '
                  '"integer nsamples" [8]\n',
    "glossyprt": 'SurfaceIntegrator "glossyprt" "integer lmax" [3] '
                 '"integer nsamples" [4]\n',
    "useprobes": 'SurfaceIntegrator "useprobes" "string filename" '
                 '["p.npz"]\n',
    "createprobes": 'Renderer "createprobes" "integer lmax" [1] '
                    '"integer indirectsamples" [2] "string filename" '
                    '["q.npz"]\n',
    "metropolis": 'Renderer "metropolis" "integer samplesperpixel" [3] '
                  '"integer bootstrapsamples" [16] "float '
                  'largestepprobability" [0.5] "integer maxdepth" [2] '
                  '"integer maxconsecutiverejects" [9] "bool '
                  'dodirectseparately" ["false"]\n',
}


@pytest.mark.parametrize("case", sorted(PRT_MLT_KINDS))
def test_prt_and_metropolis_kinds_build_as_the_reference(case, monkeypatch,
                                                          tmp_path):
    """Each precomputed-transfer integrator and the createprobes and
    metropolis renderers parse to the reference's job and build through
    build_surface_li / run with what the reference's build: the same
    integrator (and preprocess point, lmax and sample count, or probe
    grid), the same keyword arguments to probes.render / metropolis.render
    and the same file name."""
    from dartray_tpu.integrators import prt as ref_prt
    from dartray_tpu.renderers import metropolis as ref_mlt
    from dartray_tpu.renderers import probes as ref_probes
    from dartray_tpu_torch.integrators import prt
    from dartray_tpu_torch.renderers import metropolis as mlt
    from dartray_tpu_torch.renderers import probes
    monkeypatch.chdir(tmp_path)
    text = PRT_MLT_KINDS[case] + _scene(QUAD)
    port = parser.parse(text, log=QUIET, device="cpu")
    ref = ref_parser.parse(text, log=QUIET)
    _assert_same_leaves(port.scene, th.np_tree(ref.scene))
    assert (port.surf_integrator, port.renderer) == (ref.surf_integrator,
                                                     ref.renderer)
    if case == "useprobes":
        coeffs = np.random.RandomState(0).rand(12, 9, 3).astype(np.float32)
        probes.save("p.npz", prt.SHProbes(coeffs=coeffs, bbox_lo=np.zeros(3),
                                          bbox_hi=np.ones(3), lmax=2,
                                          res=(2, 3, 2)))
    seen = ({}, {})
    for i, (pm, mm, rm, man) in enumerate(((prt, mlt, probes, manager), (
            ref_prt, ref_mlt, ref_probes, ref_manager))):
        rec = seen[i]

        def project(scene, p, lmax, n_samples, rec=rec, **k):
            rec["project"] = (np.asarray(p).tolist(), lmax, n_samples)
            return None

        def li_spy(name, rec=rec):
            return lambda ig, *a: rec.__setitem__(name, ig)

        monkeypatch.setattr(pm, "project_incident_radiance", project)
        for name in ("diffuse_li", "glossy_li", "probes_li"):
            monkeypatch.setattr(pm, name, li_spy(name))
        monkeypatch.setattr(rm, "render", lambda scene, li, rec=rec, **k: (
            rec.__setitem__("probes", {x: v for x, v in k.items()
                                       if x != "device"}), "baked")[1])
        monkeypatch.setattr(rm, "save", lambda f, pr, rec=rec: (
            rec.__setitem__("file", (f, pr))))
        monkeypatch.setattr(mm, "render", lambda *a, rec=rec, **k: (
            rec.__setitem__("mlt", (a[2:], {x: v for x, v in k.items()
                                            if x not in ("device",
                                                         "progress")})),
            np.zeros((8, 8, 3), np.float32))[1])
    for i, (man, job) in enumerate(((manager, port), (ref_manager, ref))):
        if port.renderer == "sampler":
            kw = {"device": "cpu"} if i == 0 else {}
            man.build_surface_li(job, log=QUIET, **kw)(None, None, None,
                                                       None)
        else:
            kw = {"device": "cpu"} if i == 0 else {}
            img = man.run(job, log=QUIET, **kw)
            assert np.asarray(img).shape == (8, 8, 3) and not np.any(img)
    got, want = seen
    assert set(got) == set(want) and got, (got, want)
    for k in got:
        if k in ("diffuse_li", "glossy_li", "probes_li"):
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k])
        else:
            assert got[k] == want[k], k


# kinds that raised before the material system, the alpha cut-outs, the
# remaining lights, the cameras, the samplers, the alternate accelerators,
# the volumes, the igi integrator and the subsurface materials were ported:
# each file now compiles to the reference's scene, leaf by leaf (the light
# maps resolved from scenes/, a map that does not load falls back as in the
# reference)
PORTED_KINDS = {
    "orthographic": _scene(QUAD).replace('"perspective" "float fov" [40]',
                                         '"orthographic"'),
    "animated_camera": ("ActiveTransform EndTime\nTranslate 0 0 1\n"
                        "ActiveTransform All\n" + _scene(QUAD)),
    "adaptive": 'Sampler "adaptive"\n' + _scene(QUAD),
    "stratified": 'Sampler "stratified"\n' + _scene(QUAD),
    "plastic": 'Material "plastic"\n' + QUAD,
    "imagemap": ('Texture "i" "color" "imagemap" "string filename" "x.png"\n'
                 'Material "matte" "texture Kd" "i"\n' + QUAD),
    "alpha": ('Texture "a" "float" "checkerboard" "float uscale" [4] '
              '"float vscale" [4] "float tex1" [1] "float tex2" [0]\n'
              + QUAD.replace("\n", ' "float uv" [0 0 1 0 1 1 0 1] '
                             '"texture alpha" "a"\n')),
    "infinite": ('Rotate -90 1 0 0\nLightSource "infinite" "string mapname" '
                 '["envmap.pfm"] "color L" [1 0.8 0.6]\n' + QUAD),
    "infinite_no_map": ('LightSource "infinite" "string mapname" '
                        '["missing.pfm"]\n' + QUAD),
    "projection": ('Translate 0 2 -1\nLightSource "projection" "string '
                   'mapname" ["materials.pfm"] "float fov" [50] "rgb I" '
                   '[5 5 5]\n' + QUAD),
    "goniometric": ('Rotate 30 1 0 0\nLightSource "goniometric" "string '
                    'mapname" ["envmap.pfm"] "rgb I" [3 3 3]\n' + QUAD),
    "kdtree_statement": 'Accelerator "kdtree"\n' + _scene(QUAD),
    "grid_statement": 'Accelerator "grid"\n' + _scene(QUAD),
    "igi-env.pbrt": _read("igi-env.pbrt"),
    "smoke.pbrt": _read("smoke.pbrt"),
    "subsurface": _scene(
        'Material "kdsubsurface" "rgb Kd" [0.7 0.5 0.3]\n' + QUAD
        + 'Material "subsurface" "string name" ["ketchup"] "float scale" '
        '[3]\nShape "sphere" "float radius" [0.5]\n'),
    "subsurface_named": _scene(
        'MakeNamedMaterial "s" "string type" "subsurface" "rgb sigma_a" '
        '[0.1 0.2 0.3] "float index" [1.4]\nNamedMaterial "s"\n' + QUAD),
}
PORTED_JOB_HOLDS = {
    "orthographic": lambda j: j.camera.kind == 1 and j.camera.animated is None,
    "animated_camera": lambda j: j.camera.animated is not None
    and j.camera.animated.actually_animated,
    "adaptive": lambda j: j.adaptive == (4, 32) and j.sampler.spp == 32,
    "stratified": lambda j: j.sampler.kind == 1 and j.sampler.spp == 4,
    "kdtree_statement": lambda j: j.scene.geometry.alt_kind == "kdtree"
    and j.scene.geometry.alt.n_nodes > 1,
    "grid_statement": lambda j: j.scene.geometry.alt_kind == "grid"
    and j.scene.geometry.alt.tri_ids.size >= 2,
    "igi-env.pbrt": lambda j: j.surf_integrator == "igi"
    and j.scene.lights.env_light_index == 0 and j.scene.volume is None,
    "smoke.pbrt": lambda j: j.vol_integrator == "single"
    and j.scene.volume.kind.tolist() == [2]
    and j.scene.volume.grid.shape == (4, 4, 4),
    "subsurface": lambda j: sorted(j.sss) == [1, 2]
    and j.scene.materials.ks[1].tolist() == [1.0, 1.0, 1.0]
    and not j.scene.materials.kd[1:].any(),
    "subsurface_named": lambda j: list(j.sss) == [1]
    and j.sss[1][2] == 1.4,
}
PORTED_KIND_HOLDS = {
    "alpha": lambda s: s.geometry.has_alpha,
    "infinite": lambda s: s.lights.env_light_index == 0
    and s.lights.env_map.shape == (32, 64, 3),
    "infinite_no_map": lambda s: s.lights.env_map.shape == (16, 32, 3),
    "projection": lambda s: s.lights.proj_map.shape[:2] == (20, 24),
    "goniometric": lambda s: s.lights.proj_map.shape[:2] == (32, 64),
}


@pytest.mark.parametrize("case", sorted(PORTED_KINDS))
def test_kinds_ported_since_compile_equal(case):
    text = PORTED_KINDS[case]
    port, ref = _same_scene(text if case in PORTED_JOB_HOLDS
                            else _scene(text), resolvers=(
        resources.Resolver([SCENES]), ref_res.Resolver([SCENES])))
    if case in PORTED_JOB_HOLDS:
        assert PORTED_JOB_HOLDS[case](port)
        assert port.sss == ref.sss
        assert port.adaptive == ref.adaptive
        assert (port.sampler.kind, port.sampler.spp) == (
            ref.sampler.kind, ref.sampler.spp)
        assert port.camera.kind == ref.camera.kind
        assert np.array_equal(port.camera.raster2camera,
                              np.asarray(ref.camera.raster2camera))
    else:
        assert PORTED_KIND_HOLDS.get(case, lambda s: s.materials.n >= 2)(
            port.scene)


def test_kdtree_override_and_sampled_spectrum_raise():
    """The kd-tree override, the environment camera override and the
    sampled spectrum, which raised before the alternate accelerators, the
    cameras and the spectrum mode were ported, now build: the kd-tree over
    the parsed triangle soup (the reference's override's tree, array for
    array), the camera over the parsed transform and shutter; an unknown
    mode raises."""
    job = parser.parse(_read("cornell.pbrt"), log=QUIET, device="cpu")
    kd = manager.apply_overrides(job, {"accelerator": "kdtree"}, log=QUIET)
    ref = ref_manager.apply_overrides(
        ref_parser.parse(_read("cornell.pbrt"), log=QUIET),
        {"accelerator": "kdtree"}, log=QUIET)
    assert kd.scene.geometry.alt_kind == "kdtree"
    assert job.scene.geometry.alt is None
    _assert_same_leaves(kd.scene.geometry, th.np_tree(ref.scene.geometry))
    env = manager.apply_overrides(job, {"camera": "environment"}, log=QUIET)
    assert env.camera.kind == 2 and np.array_equal(env.camera.cam2world.m,
                                                   job.camera.cam2world.m)
    with pytest.raises(ValueError, match="spectrum mode"):
        manager.render_pbrt(os.path.join(SCENES, "cornell.pbrt"),
                            overrides={"spectrum": "hero"}, log=QUIET,
                            device="cpu")


# --- render overrides -------------------------------------------------------

OVERRIDES = {
    "quick": {"quick_render": True},
    "scale": {"resolution_scale": 0.5},
    "resolution": {"resolution": (20, 10)},
    "spp": {"spp": 3, "samplingMode": 1},
    "sampler": {"sampler": {"name": "02sequence",
                            "params": {"pixelsamples": 16}}},
    "filter": {"filter": {"name": "gaussian", "params": {"xwidth": 1.0}}},
    "surfaceIntegrator": {"surfaceIntegrator": {
        "name": "directlighting", "params": {"strategy": "one",
                                             "maxdepth": 3}}},
    "renderer": {"renderer": "aggregatetest",
                 "volumeIntegrator": "single", "accelerator": "bvh",
                 "camera": {"name": "perspective", "params": {"fov": 30.0}},
                 "film": {}},
}


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_apply_overrides_gives_the_references_job(case):
    ov = OVERRIDES[case]
    text = _read("cornell.pbrt")
    port, ref = _parse_both(text)
    assert manager.overrides_to_json(ov) == ref_manager.overrides_to_json(ov)
    ov = manager.overrides_from_json(manager.overrides_to_json(ov))
    assert ov == ref_manager.overrides_from_json(
        ref_manager.overrides_to_json(ov))
    got = manager.apply_overrides(port, ov, log=QUIET)
    want = ref_manager.apply_overrides(ref, ov, log=QUIET)
    for f in ("width", "height", "filter_name", "filter_params",
              "surf_integrator", "vol_integrator", "renderer",
              "sampling_mode"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("surf_params", "vol_params", "renderer_params"):
        assert getattr(got, f).to_json() == getattr(want, f).to_json(), f
    assert (got.sampler.kind, got.sampler.spp) == (
        int(want.sampler.kind), int(want.sampler.spp))
    assert th.same_bits(np.asarray(got.camera.raster2camera, np.float32),
                        np.asarray(want.camera.raster2camera))
    assert got is not port and port.width == 48    # the job is not changed


# --- image I/O, log, stats ----------------------------------------------------

def test_image_io_matches_the_reference(tmp_path):
    """PNG bytes equal for the same array, PFM round trip, and the repo's
    envmap and every format's reader equal to the reference's."""
    rng = np.random.RandomState(0)
    img = (rng.rand(7, 5, 3) * 1.2 - 0.1).astype(np.float32)
    for name in ("a.png", "a.pfm"):
        io_img.save(str(tmp_path / ("p" + name)), img)
        ref_img.save(str(tmp_path / ("r" + name)), img)
        got = (tmp_path / ("p" + name)).read_bytes()
        assert got == (tmp_path / ("r" + name)).read_bytes(), name
        assert th.same_bits(io_img.load(got, name),
                            ref_img.load(got, name))
    assert th.same_bits(io_img.load((tmp_path / "pa.pfm").read_bytes()),
                        img)
    with open(os.path.join(SCENES, "envmap.pfm"), "rb") as f:
        data = f.read()
    env = io_img.load(data, "envmap.pfm")
    assert env.ndim == 3 and th.same_bits(env, ref_img.load(data))
    assert th.same_bits(io_img.tonemap(img), ref_img.tonemap(img))


def _drive_log(mod):
    """Lines a Log of `mod` passes to its callback for a fixed script."""
    lines = []
    lg = mod.Log(callback=lambda lvl, m: lines.append((lvl, m)),
                 level=mod.INFO, prefix="[p]")
    cb = lg.as_callback()
    for m in ("hello", "warning: x", "Error: y", "debug"):
        cb(m)
    lg.debug("hidden")
    with pytest.raises(mod.SevereLogError):
        lg.severe("stop")
    return lines


def _drive_stats(mod):
    s = mod.RenderStats()
    s.add("waves", 3)
    s.add("rays/traversal_queries", 1200)
    s.timings["time/render"] = 2.0
    return s.summary(), s.as_dict()


def test_log_and_stats_are_the_references():
    assert _drive_log(log_mod) == _drive_log(ref_log)
    assert _drive_stats(stats_mod) == _drive_stats(ref_stats)


# --- samplers, filters, cameras, the sampled mode and the adaptive renderer
# through the front door, against the reference's renders of
# scenes/sampling.pbrt (tools/sampling_golden.npz, made by
# tools/make_sampling_golden.py): at least 99 % of pixels within rtol 1e-3 /
# atol 1e-4, the means within 1e-3 relative, the adaptive renderer's
# refined pixels equal

sys.path.insert(0, os.path.join(th.ROOT, "tools"))
import make_sampling_golden as sampling_golden  # noqa: E402


@pytest.fixture
def rgb_after():
    yield
    spec.set_mode("rgb")
    ref_spec.set_mode("rgb")


@pytest.mark.parametrize("name", sampling_golden.VARIANTS)
def test_sampling_variants_match_the_references_golden(name, rgb_after,
                                                       monkeypatch):
    """V1 orthographic / stratified / mitchell, V2 environment / halton /
    gaussian, V3 animated perspective / random / sinc, V4 bestcandidate at
    32 spp / triangle in the sampled mode, V5 adaptive / wide box. Every
    wave at depth 3 is 1 closest, 3 mixed and 1 any-hit v6 launch, the
    adaptive renderer's refinement waves too (counted on the wrapper: the
    plain version stands in for the kernel here)."""
    from dartray_tpu_torch.ops import traverse_cuda as tc
    counts = collections.Counter()
    real = tc.traverse6

    def counted(*a, any_hit=False, anyf=None, **k):
        counts["mixed" if anyf is not None else
               "any" if any_hit else "closest"] += 1
        return real(*a, any_hit=any_hit, anyf=anyf, **k)

    monkeypatch.setattr(tc, "traverse6", counted)
    messages = []
    img = manager.render_pbrt(
        sampling_golden.variant_text(name),
        search_paths=[sampling_golden.SCENES],
        overrides=sampling_golden.OVERRIDES.get(name),
        log=lambda m, *a, **k: messages.append(str(m)), device="cpu")
    assert spec.mode() == ("sampled" if name == "v4" else "rgb")
    gold = np.load(sampling_golden.GOLDEN)
    want = gold[name]
    assert img.shape == want.shape and np.isfinite(img).all()
    close = np.isclose(img, want, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert close >= 0.99, close
    assert abs(img.mean() - want.mean()) / want.mean() < 1e-3
    if name == "v5":
        assert sampling_golden.refined_from(messages) == int(
            gold["v5_n_refined"]) > 0
    waves = {"v4": 32, "v5": 8}.get(name, 4)
    assert counts == {"closest": waves, "mixed": 3 * waves, "any": waves}


@pytest.mark.slow
def test_sampling_golden_file_is_the_references_render(rgb_after):
    """The reference, run again, gives the committed golden images."""
    gold = np.load(sampling_golden.GOLDEN)
    out, _ = sampling_golden.make()
    assert sorted(out) == sorted(gold.files)
    for name, value in out.items():
        assert np.array_equal(value, gold[name]), name
