"""PyTorch port, the sampled-spectrum mode: the band constants, the RGB and
SPD conversions, the mode-aware luminance and film conversion, and a scene
parsed in the sampled mode (a blackbody light, an inline and an .spd-free
spectrum, an RGB image texture, an environment map), against the JAX
reference.

Constants and host conversions are numpy on both sides and equal bit for
bit, and so is every leaf of the compiled scene. The mode is a global of
each package: a fixture puts both back to "rgb" after every test, so it
cannot leak into the next test a worker runs.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu.core import spectrum as ref_spec
from dartray_tpu.scene import parser as ref_parser
from dartray_tpu.scene import resources as ref_res

import dartray_tpu_torch
from dartray_tpu_torch.core import spectrum as spec
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import resources

import torchhelp as th

torch.set_num_threads(1)

SCENES = os.path.join(th.ROOT, "scenes")
QUIET = lambda *a, **k: None   # noqa: E731


@pytest.fixture(autouse=True)
def rgb_after():
    yield
    spec.set_mode("rgb")
    ref_spec.set_mode("rgb")


def test_band_constants_are_the_references():
    assert spec.N_BANDS == ref_spec.N_BANDS == 3
    for name in ("BAND_EDGES", "BANDS_TO_XYZ", "_XYZ_TO_BANDS", "_D65_BANDS",
                 "_XYZ_TO_BANDS_ILLUM"):
        assert th.same_bits(getattr(spec, name), getattr(ref_spec, name)), \
            name
    assert th.same_bits(spec._d65_bands(), ref_spec._d65_bands())


@pytest.mark.parametrize("illuminant", [False, True])
def test_rgb_and_spd_to_bands_are_the_references(illuminant):
    rgb = np.random.RandomState(1).rand(7, 5, 3).astype(np.float32) * 3
    rgb[0, 0] = (1.0, 0.0, 0.0)       # a clamped band
    assert th.same_bits(spec.rgb_to_bands(rgb, illuminant=illuminant),
                        ref_spec.rgb_to_bands(rgb, illuminant=illuminant))
    lam = np.array([380.0, 455.5, 520.0, 610.0, 700.0, 780.0])
    val = np.array([0.1, 0.9, 0.3, 1.2, 0.4, 0.2])
    assert th.same_bits(spec.spd_to_bands(lam[::-1], val[::-1]),
                        np.asarray(ref_spec.spd_to_bands(lam[::-1],
                                                         val[::-1])))
    bb = spec.blackbody(np.arange(380.0, 781.0, 5.0), 5000.0)
    assert th.same_bits(spec.spd_to_bands(np.arange(380.0, 781.0, 5.0), bb),
                        np.asarray(ref_spec.spd_to_bands(
                            np.arange(380.0, 781.0, 5.0), bb)))


@pytest.mark.parametrize("mode", ["rgb", "sampled"])
def test_luminance_and_xyz_follow_the_mode(mode):
    dartray_tpu_torch.set_spectrum_mode(mode)
    ref_spec.set_mode(mode)
    assert spec.mode() == mode
    c = np.random.RandomState(2).rand(512, 3).astype(np.float32)
    np.testing.assert_allclose(spec.luminance(th.t3(c)).numpy(),
                               np.asarray(ref_spec.luminance(th.j3(c))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(th.n3(spec.to_xyz(th.t3(c))),
                               th.n3(ref_spec.to_xyz(th.j3(c))),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="spectrum mode"):
        spec.set_mode("hero")


SAMPLED_SCENE = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "infinite" "string mapname" ["envmap.pfm"] "color L" [0.5 0.6 0.7]
LightSource "projection" "string mapname" ["materials.pfm"] "rgb I" [3 3 3]
AttributeBegin
  AreaLightSource "diffuse" "blackbody L" [4000 8]
  Translate 0 3 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-0.5 0 -0.5  0.5 0 -0.5  0.5 0 0.5  -0.5 0 0.5]
AttributeEnd
LightSource "point" "spectrum I" [400 1  500 3  600 2  700 0.5]
  "point from" [0 2 0]
Texture "img" "color" "imagemap" "string filename" ["materials.pfm"]
Material "matte" "texture Kd" "img"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1] "float uv" [0 0 1 0 1 1 0 1]
Material "plastic" "xyz Kd" [0.3 0.2 0.1] "rgb Ks" [0.4 0.4 0.4]
Shape "sphere" "float radius" [0.4]
WorldEnd
"""


@pytest.mark.parametrize("mode", ["rgb", "sampled"])
def test_scene_tables_in_the_mode_are_the_references(mode):
    """Every leaf of the compiled scene bit for bit: light intensities
    (blackbody, inline spectrum, RGB), the material table (xyz and rgb),
    the texel pool and the light maps in the mode's representation."""
    parse = lambda: parser.parse(SAMPLED_SCENE,
                                 resolver=resources.Resolver([SCENES]),
                                 log=QUIET, device="cpu")
    rgb_texels = parse().scene.textures.texels
    spec.set_mode(mode)
    ref_spec.set_mode(mode)
    port = parse()
    ref = ref_parser.parse(SAMPLED_SCENE,
                           resolver=ref_res.Resolver([SCENES]), log=QUIET)
    want = th.np_tree(ref.scene)
    n = 0
    for path, leaf in th.port_leaves(port.scene).items():
        w = th.ref_leaf(want, path)
        if path == ".textures.texels":
            # the reference keeps a resampled mip level float64 on the host
            # in rgb mode; its device copy, like the port's table, is float32
            w = np.asarray(w, np.float32)
        if isinstance(leaf, np.ndarray):
            assert th.same_bits(leaf, w), path
        else:
            assert leaf == (float(w) if isinstance(leaf, float) else w), path
        n += 1
    assert n > 60
    # in the sampled mode the image's texels went through the bands
    texels = port.scene.textures.texels
    assert th.same_bits(texels, rgb_texels if mode == "rgb" else
                        spec.rgb_to_bands(rgb_texels).astype(np.float32))


def test_film_resolves_bands_through_the_band_matrix():
    """In the sampled mode the film's XYZ is BANDS_TO_XYZ of the bands."""
    from dartray_tpu import film as ref_film
    from dartray_tpu_torch import film as film_mod
    spec.set_mode("sampled")
    ref_spec.set_mode("sampled")
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 6, (512, 2)).astype(np.float32)
    L = rng.rand(512, 3).astype(np.float32)
    port = film_mod.add_samples(
        film_mod.make_film(6, 6, device="cpu"),
        torch.from_numpy(xy), th.t3(L))
    ref = ref_film.add_samples(ref_film.make_film(6, 6), jnp.asarray(xy),
                               th.j3(L))
    np.testing.assert_allclose(port.pixels.numpy(), np.asarray(ref.pixels),
                               rtol=1e-5, atol=1e-6)
