"""PyTorch port, host side: the port's own scene compiler (numpy, no JAX)
against the reference's, leaf by leaf and bit for bit; the adapter that
carries a reference scene over; the branches the port leaves out, which
must raise by name instead of rendering something else, and those that
raised before and are ported since, held against the reference's tables.
"""
import numpy as np
import pytest
import torch

from dartray_tpu import materials as ref_mat
from dartray_tpu.scene import build as ref_sb

from dartray_tpu_torch import film as film_mod
from dartray_tpu_torch import lights as lt_mod
from dartray_tpu_torch import materials as mat_mod
from dartray_tpu_torch import samplers, textures
from dartray_tpu_torch.core import spectrum as spec
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene import build as sb
from dartray_tpu_torch.scene import mesh as mesh_mod
from dartray_tpu_torch.scene import types as st

import torchhelp as th

torch.set_num_threads(1)


def _assert_same_leaves(port_tree, ref_tree, min_leaves=61):
    n = 0
    for path, leaf in th.port_leaves(port_tree).items():
        want = th.ref_leaf(ref_tree, path)
        if isinstance(leaf, np.ndarray):
            assert th.same_bits(leaf, want), path
        elif isinstance(leaf, float):
            assert leaf == float(want), path
        elif isinstance(leaf, tuple):
            assert tuple(leaf) == tuple(want), path
        else:
            assert leaf == want, path
        n += 1
    assert n >= min_leaves    # the whole tree was walked, not an empty one


def _builders(variant):
    if variant == "lights":     # a point, a spot and a distant light added
        from dartray_tpu import lights as ref_lt
        from dartray_tpu.core import transform as ref_tr
        from dartray_tpu_torch.core import transform as tr
        pair = []
        for mod, lt, trm in ((sb, lt_mod, tr), (ref_sb, ref_lt, ref_tr)):
            b = mod.cornell_box()
            b.add_light(lt.point_light((0.3, 1.6, -0.2), (2.0, 1.5, 1.0)))
            b.add_light(lt.spot_light(
                (-0.5, 1.8, -0.5), np.asarray(trm.look_at(
                    [-0.5, 1.8, -0.5], [0.2, 0, 0.3], [0, 1, 0]).m_inv),
                cone_angle=40.0, cone_delta=15.0))
            b.add_light(lt.distant_light((0.2, 1.0, -0.6), (0.5, 0.6, 0.7)))
            pair.append(b)
        return pair[0], None, pair[1], None
    if variant == "glass":
        return (sb.cornell_box(sphere2_material=None), mat_mod.glass(),
                ref_sb.cornell_box(sphere2_material=None), ref_mat.glass())
    return sb.cornell_box(), None, ref_sb.cornell_box(), None


@pytest.mark.parametrize("variant,split", [("mirror", "sah"),
                                           ("glass", "sah"),
                                           ("mirror", "middle"),
                                           ("lights", "sah")])
def test_scene_compiler_matches_reference(variant, split):
    """sah goes through the native C++ builder, middle through the numpy
    builder; both must give the reference's tables exactly."""
    b, m, rb, rm = _builders(variant)
    if m is not None:
        b.mat_rows[-1] = m
        rb.mat_rows[-1] = rm
    _assert_same_leaves(b.build(split_method=split),
                        th.np_tree(rb.build(split_method=split)))


def test_from_reference_round_trip():
    ref = th.np_tree(ref_sb.cornell_box().build())
    scene = adapt.from_reference(ref)
    _assert_same_leaves(scene, ref)
    # the device copy keeps every bit too, the int32 patterns that live in
    # f32 columns (denormals as floats) included
    moved = st.to_device(scene, "cpu")
    _assert_same_leaves(moved, ref)
    attrp = moved.geometry.attrp
    assert attrp.dtype == torch.float32
    ids = attrp[:, 36].contiguous().view(torch.int32).numpy()
    assert th.same_bits(ids, ref["geometry"]["perm"])
    assert (ids >= -1).all() and ids.max() == ref["geometry"]["n_prims"] - 1


def _checker_textures(mod):
    """A texture table of two constants under a 4x4 checkerboard (id 2)."""
    b = mod.TextureBuilder()
    b.add(mod.CONST, (1.0, 1.0, 1.0))
    b.add(mod.CONST, (0.0, 0.0, 0.0))
    b.add(mod.CHECKER2D, params=(4, 4, 0, 0, 8, 0.5, 1, 0), sub=(0, 1))
    return b.build()


def test_from_reference_refuses_what_is_not_ported():
    """Nothing the reference compiles is refused any more: the grid
    accelerator and participating media (ported since the alternate
    accelerators and the volumes), a plastic row (since the material system)
    and an alpha-masked floor (since the alpha cut-outs) are carried leaf by
    leaf."""
    from dartray_tpu import textures as ref_tex
    from dartray_tpu.scene import parser as ref_parser
    ref = th.np_tree(ref_sb.cornell_box(
        sphere_material=None).build(accelerator="grid"))
    scene = adapt.from_reference(ref)
    assert scene.geometry.alt_kind == "grid"
    _assert_same_leaves(scene, ref)
    rb = ref_sb.cornell_box()
    rb.textures = _checker_textures(ref_tex)
    rb.meshes[0].alpha_tid = 2
    ref = th.np_tree(rb.build())
    scene = adapt.from_reference(ref)
    assert scene.geometry.has_alpha and ref["geometry"]["has_alpha"]
    _assert_same_leaves(scene, ref)
    ref = th.np_tree(ref_parser.parse(
        'Camera "perspective"\nWorldBegin\nVolume "exponential" "float b" '
        '[2]\nVolume "volumegrid" "integer nx" [2] "float density" [1 3]\n'
        'Shape "sphere"\nWorldEnd\n', log=lambda *a, **k: None).scene)
    scene = adapt.from_reference(ref)
    assert scene.volume.kind.tolist() == [1, 2]
    _assert_same_leaves(scene, ref)
    rb = ref_sb.cornell_box()
    rb.mat_rows[-1] = ref_mat.plastic()
    ref = th.np_tree(rb.build())
    _assert_same_leaves(adapt.from_reference(ref), ref)


@pytest.mark.parametrize("name", ["sampler_random", "sampler_halton",
                                  "filter_gaussian", "filter_wide_box",
                                  "spectrum_sampled", "accel_grid",
                                  "accel_kdtree"])
def test_branch_ported_since_builds_the_references(name):
    """Branches that raised before the samplers, filters, the spectrum mode
    and the alternate accelerators were ported now build what the
    reference builds."""
    from dartray_tpu import film as ref_film, samplers as ref_smp
    from dartray_tpu.core import spectrum as ref_spec
    from dartray_tpu.scene import mesh as ref_mesh, types as ref_st
    if name.startswith("accel_"):
        kind = name.split("_")[1]
        got = st.compile_geometry([mesh_mod.sphere(nu=8, nv=4)],
                                  accelerator=kind)
        want = ref_st.compile_geometry([ref_mesh.sphere(nu=8, nv=4)],
                                       accelerator=kind)
        assert got.alt_kind == want.alt_kind == kind
        _assert_same_leaves(got.alt, th.np_tree(want.alt), min_leaves=8)
    elif name.startswith("sampler_"):
        kind = name.split("_")[1]
        got, want = samplers.make_sampler(kind, 6), ref_smp.make_sampler(
            kind, 6)
        assert (got.kind, got.spp) == (want.kind, want.spp)
    elif name.startswith("filter_"):
        fname, fp = (("gaussian", None) if name == "filter_gaussian"
                     else ("box", {"xwidth": 1.0}))
        film = film_mod.make_film(4, 4, fname, fp, device="cpu")
        table, xw, yw = ref_film.filter_table(fname, fp)
        assert th.same_bits(film.ftable.numpy(), np.asarray(table))
        assert (film.xwidth, film.ywidth) == (xw, yw)
    else:
        try:
            spec.set_mode("sampled")
            assert spec.mode() == "sampled"
            assert th.same_bits(spec.rgb_to_bands([0.2, 0.5, 0.9]),
                                ref_spec.rgb_to_bands([0.2, 0.5, 0.9]))
        finally:
            spec.set_mode("rgb")


def _image_textures(mod):
    b = mod.TextureBuilder()
    img = np.random.RandomState(4).rand(5, 7, 3).astype(np.float32)
    b.add(mod.CONST, (0.2, 0.3, 0.4))
    b.add(mod.IMAGEMAP, (1.5, 1.5, 1.5), params=(2, 3, 0.1, 0.2),
          image=img, mapping=mod.MAP_PLANAR)
    b.add(mod.CHECKER2D, sub=(0, 1))
    return b.build()


def _light_maps():
    rng = np.random.RandomState(7)
    env = (rng.rand(6, 10, 3).astype(np.float32) ** 2) * 2.0
    env[1, 3] = 30.0
    gonio = rng.rand(5, 8, 3).astype(np.float32)
    w2l = np.asarray([[0.8, 0.0, -0.6, 0.2], [0.0, 1.0, 0.0, -1.0],
                      [0.6, 0.0, 0.8, 0.3], [0, 0, 0, 1]], np.float64)
    return env, gonio, w2l


def _ported_since_lights(name, lt, tex, geo, mesh):
    """The refusals of light kinds, opacity textures and alpha cut-outs,
    before the slice that ported them: each builds the reference's table."""
    env, gonio, w2l = _light_maps()
    attr = np.zeros((1, 48), np.float32)
    if name == "goniometric_light":
        return lt.build_table([lt.goniometric_light(
            (0.1, 2.0, 0.3), w2l, (2.0, 1.5, 1.0), gonio_map=gonio)],
            attr=attr)
    if name == "infinite_light":
        return lt.build_table([lt.infinite_light(
            env, w2l=w2l, L_scale=(1.5, 1.0, 0.5))], scene_radius=7.5,
            attr=attr)
    m = mesh.sphere(nu=8, nv=4)
    m.alpha_tid = 2
    return geo.compile_geometry([m], textures=_checker_textures(tex))


# what the refusals above held before the material system was ported: each
# now builds the reference's table, leaf by leaf
PORTED_BRANCHES = {
    "plastic": lambda m: [m.plastic()],
    "metal": lambda m: [m.metal(roughness=0.05)],
    "substrate": lambda m: [m.substrate(roughness=0.1, vroughness=0.3)],
    "uber": lambda m: [m.uber(opacity=(0.6, 0.6, 0.6))],
    "measured": lambda m: [m.matte(), m.measured(
        np.arange(24, dtype=np.float32).reshape(2, 2, 2, 3), key="a")],
    "glossy_row": lambda m: [m._row(ks=(0.5, 0.5, 0.5))],
    "conductor_row": lambda m: [m._row(kr=(1, 1, 1),
                                       spec_fresnel=m.FR_CONDUCTOR)],
    "bump": lambda m: [m.matte(tex_ids={m.TEX_BUMP: 0})],
    "opacity_texture": lambda m: [m.matte(tex_ids={m.TEX_OPACITY: 0})],
    "subsurface_row": lambda m: [m.matte(), dict(
        m.plastic(kd=(0.0,) * 3, ks=(1.0,) * 3, roughness=0.05),
        _sss=((1.5, 1.6, 1.7), (0.1, 0.2, 0.3), 1.3))],
}
PORTED_SINCE_LIGHTS = ("goniometric_light", "infinite_light", "alpha")


@pytest.mark.parametrize("name", sorted(PORTED_BRANCHES) + ["image_texture"]
                         + list(PORTED_SINCE_LIGHTS))
def test_branch_ported_since_builds_the_references_table(name):
    from dartray_tpu import lights as ref_lt
    from dartray_tpu import textures as ref_tex
    from dartray_tpu.scene import mesh as ref_mesh
    from dartray_tpu.scene import types as ref_st
    if name in PORTED_SINCE_LIGHTS:
        port = _ported_since_lights(name, lt_mod, textures, st, mesh_mod)
        ref = th.np_tree(_ported_since_lights(name, ref_lt, ref_tex, ref_st,
                                              ref_mesh))
        if name == "alpha":
            assert port.has_alpha and (port.alpha_tid == 2).all()
        _assert_same_leaves(port, ref, min_leaves=24)
        return
    if name == "image_texture":
        port = _image_textures(textures)
        ref = th.np_tree(_image_textures(ref_tex))
        # the resampled level is float64 in the reference's host table and
        # float32 in its device copy, which the port's table stands for
        ref["texels"] = ref["texels"].astype(np.float32)
    else:
        port = mat_mod.build_table(PORTED_BRANCHES[name](mat_mod))
        ref = th.np_tree(ref_mat.build_table(PORTED_BRANCHES[name](ref_mat)))
    n = 0
    for path, leaf in th.port_leaves(port).items():
        want = th.ref_leaf(ref, path)
        assert (th.same_bits(leaf, want) if isinstance(leaf, np.ndarray)
                else leaf == want), path
        n += 1
    assert n >= 11      # every array and scalar of the table


def test_builder_choice_is_logged_once(caplog):
    """A tree built by the slow numpy builder must be visible in the log."""
    from dartray_tpu_torch.accel import cluster, native
    native._reported.discard("numpy")
    v0, e1, e2 = th.soup(200, seed=3)
    with caplog.at_level("INFO", logger="dartray_tpu_torch.accel"):
        cluster.build(v0, e1, e2, split_method="equal")
        cluster.build(v0, e1, e2, split_method="equal")
    said = [r for r in caplog.records if "numpy builder" in r.getMessage()]
    assert len(said) == 1 and native.LAST_BUILDER == "numpy"
