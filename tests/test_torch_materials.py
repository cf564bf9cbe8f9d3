"""PyTorch port, the material system as a whole: the material builders and
table (``materials.py``), the scene API's material and texture statements,
and ``scenes/materials.pbrt`` (every ported material kind and each texture
family) from the file to the image.

Rows, tables and the parsed scene are numpy on both sides and are held bit
for bit. The render is held against ``tools/materials_golden.npz``, the JAX
reference's own ``render_pbrt`` of the file (40x40, 4 spp, path depth 3;
``tools/make_materials_golden.py``), with the tolerance of
``tests/test_torch_manager.py``: >= 99 % of pixels within rtol 1e-3 / atol
1e-4 and the image mean within 1e-3 relative. The reference renders for
minutes on the CPU, so no test here runs it; the slow case recomputes the
golden file.
"""
import os
import sys

import numpy as np
import pytest
import torch

from dartray_tpu import materials as ref_mat
from dartray_tpu.scene import parser as ref_parser
from dartray_tpu.scene import resources as ref_res

from dartray_tpu_torch import bsdf as bx
from dartray_tpu_torch import materials as mat
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import resources
from dartray_tpu_torch.scene import types as st

import torchhelp as th

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_materials_golden as golden  # noqa: E402

torch.set_num_threads(1)

SCENES = os.path.join(ROOT, "scenes")
with open(golden.SCENE) as f:
    SCENE_TEXT = f.read()
QUIET = lambda *a, **k: None   # noqa: E731


def _check_image(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(img - ref).max())
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()


def _same_row(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        if va.dtype.kind in "fi" or va.dtype == bool:
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            assert va.tobytes() == vb.tobytes(), k
        else:
            assert a[k] == b[k], k


def _same_tree(port, ref):
    """Every leaf of a port tree equals the reference's of the same path:
    arrays bit for bit (a host texel pool as the reference's device copy,
    float32), scalars and tuples by value. Returns the leaves seen."""
    n = 0
    for path, leaf in th.port_leaves(port).items():
        want = th.ref_leaf(ref, path)
        if path.endswith("textures.texels"):
            want = np.asarray(want, np.float32)
        if isinstance(leaf, np.ndarray):
            assert th.same_bits(leaf, want), path
        else:
            assert leaf == want, path
        n += 1
    return n


BUILDERS = {
    "matte": lambda m: m.matte(kd=(0.3, 0.4, 0.5), sigma=12.0),
    "plastic": lambda m: m.plastic(kd=(0.5, 0.2, 0.1), roughness=0.03),
    "mirror": lambda m: m.mirror(kr=(0.7, 0.8, 0.9)),
    "glass": lambda m: m.glass(index=1.33),
    "metal": lambda m: m.metal(eta=(0.2, 0.5, 1.4), k=(3.9, 2.4, 1.6),
                               roughness=0.002),
    "shinymetal": lambda m: m.shinymetal(ks=(0.4, 0.3, 0.2)),
    "substrate": lambda m: m.substrate(roughness=0.07, vroughness=0.4),
    "translucent": lambda m: m.translucent(reflect=(0.7, 0.6, 0.5),
                                           transmit=(0.2, 0.3, 0.4)),
    "uber": lambda m: m.uber(kr=(0.1, 0.2, 0.3), kt=(0.2, 0.2, 0.2)),
    "uber_opacity": lambda m: m.uber(kt=(0.3, 0.3, 0.3),
                                     opacity=(0.6, 0.7, 0.8)),
    "uber_opacity_no_kt": lambda m: m.uber(opacity=(0.5, 0.5, 0.5)),
    "mix": lambda m: m.mix_materials(m.plastic(tex_ids={m.TEX_KD: 2}),
                                     m.metal(), (0.7, 0.6, 0.5)),
    "mix_second_fresnel": lambda m: m.mix_materials(
        m.glass(), m.shinymetal(), (0.2, 0.3, 0.4)),
    "measured": lambda m: m.measured(
        np.random.RandomState(1).rand(2, 3, 4, 3), key="k",
        tex_ids={m.TEX_BUMP: 0}),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_row_is_the_references(name):
    _same_row(BUILDERS[name](mat), BUILDERS[name](ref_mat))


def test_table_of_every_kind_is_the_references():
    """Every builder in one table, two measured rows sharing a key and one
    of their own: the measured pool is deduplicated as the reference's."""
    def rows(m):
        out = [BUILDERS[k](m) for k in sorted(BUILDERS)]
        out.append(m.measured(np.ones((2, 2, 2, 3)), key="k"))
        out.append(m.measured(np.full((3, 2, 2, 3), 0.5), key="other"))
        return out
    port, ref = mat.build_table(rows(mat)), ref_mat.build_table(rows(ref_mat))
    assert _same_tree(port, th.np_tree(ref)) >= 20
    assert port.has_measured and port.meas_pool.shape == (2 * 3 * 4 + 12, 3)
    assert port.used_tex_slots == (mat.TEX_KD, mat.TEX_BUMP)


@pytest.fixture(scope="module")
def parsed():
    """(port job, reference job) of scenes/materials.pbrt."""
    logs = ([], [])
    port = parser.parse(SCENE_TEXT, resolver=resources.Resolver([SCENES]),
                        log=logs[0].append, device="cpu")
    ref = ref_parser.parse(SCENE_TEXT, resolver=ref_res.Resolver([SCENES]),
                           log=logs[1].append)
    assert logs[0] == logs[1]
    return port, ref


def test_scene_file_compiles_to_the_references_tables(parsed):
    """Geometry, materials (measured pool included) and textures of the
    parsed file, leaf by leaf; the adapter carries the reference's compiled
    scene over to the same tables."""
    port, ref = parsed
    ref_tree = th.np_tree(ref.scene)
    assert _same_tree(port.scene, ref_tree) > 100
    assert _same_tree(adapt.from_reference(ref_tree), ref_tree) > 100
    mats, texs = port.scene.materials, port.scene.textures
    assert mats.has_measured and set(mats.used_tex_slots) == {
        mat.TEX_KD, mat.TEX_KS, mat.TEX_ROUGH, mat.TEX_BUMP}
    assert set(np.unique(mats.gloss_fresnel)) == {
        bx.FR_DIELECTRIC, bx.FR_CONDUCTOR, bx.FR_BLEND}
    assert (mats.exponent != mats.exponent_v).any()    # the substrate wall
    assert set(texs.kinds_present) >= {0, 1, 2, 3, 5, 7, 8, 9}
    assert texs.has_mapping


def test_render_pbrt_matches_the_references_golden_image():
    """The whole front door on the file, on the CPU: every material and
    texture family through the path integrator."""
    img = manager.render_pbrt(golden.SCENE, log=QUIET, device="cpu")
    _check_image(img, np.load(golden.GOLDEN)["image"])
    assert sum(tc.LAUNCHES.values()) == 0


@pytest.mark.slow
def test_golden_file_is_the_references_render():
    """The reference, run again, gives the committed golden image."""
    ref = np.load(golden.GOLDEN)["image"]
    assert np.array_equal(golden.make()["image"], ref)


def test_scene_data_files_are_the_tools_output():
    """The committed image map and MERL table come from the tool's seeds."""
    for path, data in ((golden.PFM, golden.pfm_bytes()),
                       (golden.MERL, golden.merl_bytes())):
        with open(path, "rb") as f:
            assert f.read() == data, path


@pytest.mark.cuda
def test_render_on_the_card_matches_the_golden_image():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    tc.reset_launches()
    img = manager.render_pbrt(golden.SCENE, log=QUIET, device="cuda")
    _check_image(img, np.load(golden.GOLDEN)["image"])
    assert tc.LAUNCHES["traverse6:mixed"] == 4 * 3


SHINY = ('Film "image" "integer xresolution" [4] "integer yresolution" [4]\n'
         'Camera "perspective"\nWorldBegin\n'
         'Material "shinymetal" "rgb Ks" [0.3 0.2 0.1] "rgb Kr" [0.9 0.8 0.7]\n'
         'Shape "trianglemesh" "integer indices" [0 1 2] "point P" '
         '[0 0 1  1 0 1  0 1 1]\nWorldEnd\n')


def test_shinymetal_takes_the_copper_defaults():
    """Known behaviour j: shinymetal's glossy and specular slots both use
    the conductor Fresnel of the copper eta / k, whatever Ks and Kr say;
    the specular f is kr * Fr_conductor(cos, copper) / |cos| in both
    packages."""
    port, ref = (p.parse(SHINY, log=QUIET, **kw) for p, kw in (
        (parser, {"device": "cpu"}), (ref_parser, {})))
    for m in (port.scene.materials, ref.scene.materials):
        row = np.asarray(m.gloss_fresnel) == bx.FR_CONDUCTOR
        assert (np.asarray(m.spec_fresnel)[row] == bx.FR_CONDUCTOR).all()
        assert np.allclose(np.asarray(m.eta_c)[row], mat.COPPER_ETA)
        assert np.allclose(np.asarray(m.k_c)[row], mat.COPPER_K)
    _same_tree(port.scene.materials, th.np_tree(ref.scene.materials))
    n = 64
    p = mat.eval_params(st.to_device(port.scene.materials, "cpu"),
                        torch.zeros(n, dtype=torch.int32))
    cos = torch.linspace(0.05, 1.0, n)
    z = torch.zeros(n)
    frame = bx.Frame(s=vm3(1, 0, 0, n), t=vm3(0, 1, 0, n), n=vm3(0, 0, 1, n),
                     ng=vm3(0, 0, 1, n))
    wo = th.t3(np.stack([np.sqrt(1 - cos.numpy() ** 2), z.numpy(),
                         cos.numpy()], -1))
    s = bx.sample_f(p, frame, wo, torch.rand(n, 2), torch.full((n,), 0.99))
    assert (s.flags == bx.REFLECTION | bx.SPECULAR).all()
    fc = bx.fr_conductor(cos, th.t3(np.tile(mat.COPPER_ETA, (n, 1))),
                         th.t3(np.tile(mat.COPPER_K, (n, 1))))
    np.testing.assert_allclose(th.n3(s.f), th.n3(p.kr * fc * (1 / cos)),
                               rtol=1e-6)


def vm3(x, y, z, n):
    return th.t3(np.tile(np.asarray([x, y, z], np.float32), (n, 1)))


MEASURED = ('Film "image" "integer xresolution" [4] '
            '"integer yresolution" [4]\nCamera "perspective"\nWorldBegin\n'
            'Material "measured" "string filename" "{}"\n'
            'Shape "trianglemesh" "integer indices" [0 1 2] "point P" '
            '[0 0 1  1 0 1  0 1 1]\nWorldEnd\n')


@pytest.mark.parametrize("case", ["missing", "truncated", "no_name"])
def test_unloadable_measured_file_is_a_warning_and_matte(case, tmp_path):
    """Known behaviour k: a measured material whose file cannot be loaded
    logs the reference's warnings and becomes matte Kd 0.5, the scene
    file's semantics and not a device fallback."""
    name = {"missing": "nowhere.merl", "truncated": "cut.merl",
            "no_name": ""}[case]
    with open(golden.MERL, "rb") as f:
        (tmp_path / "cut.merl").write_bytes(f.read()[:1000])
    text = MEASURED.format(name).replace(
        '"string filename" ""', "")
    logs = ([], [])
    port = parser.parse(text, resolver=resources.Resolver([str(tmp_path)]),
                        log=logs[0].append, device="cpu")
    ref = ref_parser.parse(text, resolver=ref_res.Resolver([str(tmp_path)]),
                           log=logs[1].append)
    assert logs[0] == logs[1]
    assert logs[0][-1] == ("warning: measured material without loadable "
                           "file; using matte")
    m = port.scene.materials
    assert not m.has_measured and (m.meas_meta == -1).all()
    assert np.array_equal(m.kd[-1], np.full(3, 0.5, np.float32))
    _same_tree(port.scene.materials, th.np_tree(ref.scene.materials))
