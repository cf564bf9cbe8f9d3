"""PyTorch port, the film: filter tables, the footprint deposit of every
filter, the splat buffer, checkpoints and the resolve, against the JAX
reference on the same seeded samples.

Filter tables are host numpy on both sides and equal bit for bit. Film
pixels after a deposit agree to rtol 1e-5 / atol 1e-6: the reference adds
one scatter per footprint tap, the port one scatter of every tap, so the
sums of a pixel may be taken in another order. The samples straddle the
image edge (raster x in [-2, W + 2)) on a film cropped at (x0, y0) = (3, 2),
and a few carry NaN, negative or infinite radiance.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu import film as ref_film
from dartray_tpu.core import math as ref_vm

from dartray_tpu_torch import film as film_mod
from dartray_tpu_torch.core import math as vm

import torchhelp as th

torch.set_num_threads(1)

N = 512
W, H, X0, Y0 = 12, 9, 3, 2
RTOL, ATOL = 1e-5, 1e-6
FILTERS = {
    "box": None,
    "wide_box": {"xwidth": 1.5},
    "triangle": None,
    "gaussian": {"alpha": 1.5},
    "mitchell": None,
    "sinc": None,
}


def _samples(seed=0):
    rng = np.random.RandomState(seed)
    xy = np.stack([rng.uniform(X0 - 2, X0 + W + 2, N),
                   rng.uniform(Y0 - 2, Y0 + H + 2, N)], -1).astype(
                       np.float32)
    L = (rng.rand(N, 3) * 2.0).astype(np.float32)
    L[3] = np.nan
    L[5, 1] = -1.0
    L[7, 2] = np.inf
    mask = rng.rand(N) > 0.2
    return xy, L, mask


def _films(name, params):
    fname = "box" if name == "wide_box" else name
    return (film_mod.make_film(W, H, fname, params, x0=X0, y0=Y0,
                               device="cpu"),
            ref_film.make_film(W, H, fname, params, x0=X0, y0=Y0))


def _port_in(xy, L):
    return vm.V2(*(torch.from_numpy(xy[:, i].copy()) for i in range(2))), \
        th.t3(L)


def _ref_in(xy, L):
    return ref_vm.V2(jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1])), th.j3(L)


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_table_is_the_references(name):
    fname = "box" if name == "wide_box" else name
    table, xw, yw = film_mod.filter_table(fname, FILTERS[name])
    want, rxw, ryw = ref_film.filter_table(fname, FILTERS[name])
    assert th.same_bits(table, np.asarray(want)) and (xw, yw) == (rxw, ryw)


@pytest.mark.parametrize("functional", [False, True])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_deposit_equals_the_references(name, functional):
    xy, L, mask = _samples()
    port, ref = _films(name, FILTERS[name])
    add = (film_mod.add_samples_functional if functional
           else film_mod.add_samples)
    before = port.pixels.clone()
    out = add(port, *_port_in(xy, L), mask=torch.from_numpy(mask))
    want = ref_film.add_samples(ref, *_ref_in(xy, L), mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.pixels.numpy(), np.asarray(want.pixels),
                               rtol=RTOL, atol=ATOL)
    # in place or not, as the function says
    assert (out is port) != functional
    assert torch.equal(port.pixels, before) == functional
    assert np.asarray(want.pixels)[..., 3].sum() > 0
    np.testing.assert_allclose(film_mod.to_rgb(out).numpy(),
                               np.asarray(ref_film.to_rgb(want)),
                               rtol=1e-4, atol=1e-5)


def test_wide_filter_reaches_neighbours_and_box_does_not():
    """One sample in the middle of a pixel: the box deposits to that pixel
    alone, mitchell (half-width 2) to its whole 5x5 neighbourhood."""
    xy = np.array([[X0 + 5.5, Y0 + 4.5]], np.float32)
    L = np.ones((1, 3), np.float32)
    for name, count in (("box", 1), ("mitchell", 25)):
        port, _ = _films(name, None)
        film_mod.add_samples(port, *_port_in(xy, L))
        assert int((port.pixels[..., 3] != 0).sum()) == count, name


def test_splat_and_resolve_equal_the_references():
    xy, L, mask = _samples(1)
    port, ref = _films("box", None)
    port = film_mod.splat(port, *_port_in(xy, L), mask=torch.from_numpy(mask))
    ref = ref_film.splat(ref, *_ref_in(xy, L), mask=jnp.asarray(mask))
    np.testing.assert_allclose(port.splat.numpy(), np.asarray(ref.splat),
                               rtol=RTOL, atol=ATOL)
    film_mod.add_samples(port, *_port_in(xy, L))
    ref = ref_film.add_samples(ref, *_ref_in(xy, L))
    np.testing.assert_allclose(
        film_mod.to_rgb(port, splat_scale=0.25).numpy(),
        np.asarray(ref_film.to_rgb(ref, splat_scale=0.25)),
        rtol=1e-4, atol=1e-5)


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    """The same .npz keys as the reference's, written through a temporary
    file; either package reads the other's checkpoint."""
    xy, L, mask = _samples(2)
    port, ref = _films("mitchell", None)
    film_mod.add_samples(port, *_port_in(xy, L))
    film_mod.splat(port, *_port_in(xy, L))
    path = str(tmp_path / "film.ckpt.npz")
    film_mod.save_checkpoint(path, port, 5)
    assert not os.path.exists(path + ".tmp.npz")
    with np.load(path) as d:
        assert sorted(d.files) == ["meta", "next_s", "pixels", "splat"]
        assert d["meta"].tolist() == [W, H, X0, Y0]
    back, s = film_mod.load_checkpoint(path, _films("mitchell", None)[0])
    assert s == 5 and torch.equal(back.pixels, port.pixels)
    assert torch.equal(back.splat, port.splat)
    ref_back, ref_s = ref_film.load_checkpoint(path, ref)
    assert ref_s == 5 and th.same_bits(np.asarray(ref_back.pixels),
                                       port.pixels.numpy())
    ref_path = str(tmp_path / "ref.ckpt.npz")
    ref_film.save_checkpoint(ref_path, ref_back, 5)
    back, _ = film_mod.load_checkpoint(ref_path, back)
    assert torch.equal(back.pixels, port.pixels)
    with pytest.raises(ValueError, match="resolution"):
        film_mod.load_checkpoint(path, film_mod.make_film(4, 4,
                                                          device="cpu"))


def test_resumed_render_equals_the_uninterrupted_one(tmp_path):
    """A render killed after wave 2 (of 4) resumes from its checkpoint and
    gives the uninterrupted image bit for bit (V1 of scenes/sampling.pbrt
    at 12x12: orthographic, stratified 2x2, mitchell)."""
    from dartray_tpu_torch.renderers import manager
    from dartray_tpu_torch.renderers import sampler as rend
    from dartray_tpu_torch.scene import parser, resources
    scenes = os.path.join(th.ROOT, "scenes")
    with open(os.path.join(scenes, "sampling.pbrt")) as f:
        text = f.read().replace("[32]", "[12]")
    job = parser.parse(text, resolver=resources.Resolver([scenes]),
                       log=lambda *a, **k: None, device="cpu")
    li = manager.build_surface_li(job)
    args = (job.scene, job.camera, job.sampler, li, 12, 12)
    kw = dict(filter_name=job.filter_name, filter_params=job.filter_params,
              device="cpu")
    whole = rend.render(*args, **kw)
    ck = str(tmp_path / "film.ckpt.npz")

    class Die(Exception):
        pass

    def killer(s, spp, film):
        if s > 2:       # the wave-2 checkpoint is written after progress(2)
            raise Die()

    with pytest.raises(Die):
        rend.render(*args, checkpoint_path=ck, checkpoint_every=2,
                    progress=killer, **kw)
    with np.load(ck) as d:
        assert int(d["next_s"]) == 2
    resumed = rend.render(*args, checkpoint_path=ck, checkpoint_every=2,
                          **kw)
    assert job.sampler.spp == 4 and th.same_bits(resumed, whole)
