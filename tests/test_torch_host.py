"""PyTorch port, host side: the port's own scene compiler (numpy, no JAX)
against the reference's, leaf by leaf and bit for bit; the adapter that
carries a reference scene over; the branches this slice leaves out, which
must raise by name instead of rendering something else.
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


def _assert_same_leaves(port_tree, ref_tree):
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
    assert n > 60      # the whole tree was walked, not an empty one


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


def test_from_reference_refuses_what_is_not_ported():
    ref = th.np_tree(ref_sb.cornell_box(
        sphere_material=None).build())
    ref["geometry"]["alt_kind"] = "grid"
    with pytest.raises(NotImplementedError):
        adapt.from_reference(ref)
    rb = ref_sb.cornell_box()
    rb.mat_rows[-1] = ref_mat.plastic()
    with pytest.raises(NotImplementedError, match="lobes"):
        adapt.from_reference(th.np_tree(rb.build()))


def _cutout_mesh():
    m = mesh_mod.sphere(nu=8, nv=4)
    m.alpha_tid = 0
    return m


@pytest.mark.parametrize("name,call", [
    ("plastic", lambda: mat_mod.plastic()),
    ("metal", lambda: mat_mod.metal()),
    ("substrate", lambda: mat_mod.substrate()),
    ("uber", lambda: mat_mod.uber()),
    ("measured", lambda: mat_mod.measured(np.zeros((2, 2, 2, 3)))),
    ("glossy_row", lambda: mat_mod.build_table(
        [mat_mod._row(ks=(0.5, 0.5, 0.5))])),
    ("conductor_row", lambda: mat_mod.build_table(
        [mat_mod._row(kr=(1, 1, 1), spec_fresnel=mat_mod.FR_CONDUCTOR)])),
    ("bump", lambda: mat_mod.build_table(
        [mat_mod.matte(tex_ids={mat_mod.TEX_BUMP: 0})])),
    ("goniometric_light", lambda: lt_mod.build_table(
        [lt_mod.LightSpec(lt_mod.GONIOMETRIC)],
        attr=np.zeros((1, 48), np.float32))),
    ("sampler_random", lambda: samplers.make_sampler("random")),
    ("sampler_halton", lambda: samplers.make_sampler("halton")),
    ("filter_gaussian", lambda: film_mod.make_film(4, 4, "gaussian",
                                                   device="cpu")),
    ("filter_wide_box", lambda: film_mod.make_film(
        4, 4, "box", {"xwidth": 1.0}, device="cpu")),
    ("spectrum_sampled", lambda: spec.set_mode("sampled")),
    ("accel_grid", lambda: st.compile_geometry(
        [mesh_mod.sphere(nu=8, nv=4)], accelerator="grid")),
    ("alpha", lambda: st.compile_geometry([_cutout_mesh()])),
    ("infinite_light", lambda: lt_mod.build_table(
        [lt_mod.LightSpec(lt_mod.INFINITE)],
        attr=np.zeros((1, 48), np.float32))),
    ("image_texture", lambda: textures.check_supported(
        textures.TextureData(kind=None, value=None, n=1,
                             kinds_present=(0, 1)))),
])
def test_left_out_branch_raises_by_name(name, call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call()


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
