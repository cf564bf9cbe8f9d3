"""PyTorch port, ``parallel/mesh.py``: band-sharded rendering over a tiles x
spp mesh, in one process and over spawned gloo ranks.

The host helpers (``band_pixel_grid``, ``compose_bands``, ``_unshift``) are
held against the reference's arrays. The port's sharded image is held
against the port's own ``render`` (bit for bit with the box filter and one
chunk a band; within rtol 2e-3 / atol 2e-4, the reference's
``tests/test_sharding.py`` tolerance, where chunks or wide filters sum in
another order) and against the reference's sharded images in
``tools/mesh_golden.npz`` (``tools/make_mesh_golden.py``; one ``slow`` case
an image renders them again). Ranks rendezvous through a file under the
test's own temporary directory.
"""
import os
import sys

import numpy as np
import pytest
import torch

from dartray_tpu.parallel import mesh as ref_pmesh

from dartray_tpu_torch.parallel import mesh as pm
from dartray_tpu_torch.renderers import sampler as rend

import torchhelp as th

sys.path.insert(0, os.path.join(th.ROOT, "tools"))
import make_mesh_golden as golden  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 2e-4


@pytest.mark.parametrize("width,height,n_tiles", [
    (16, 16, 1), (16, 16, 2), (16, 16, 4), (16, 16, 8), (16, 13, 4),
    (12, 10, 8)])
def test_band_pixel_grid_is_the_references(width, height, n_tiles):
    px, py, hb = pm.band_pixel_grid(width, height, n_tiles, device="cpu")
    rpx, rpy, rhb = ref_pmesh.band_pixel_grid(width, height, n_tiles)
    assert hb == rhb
    assert px.dtype == py.dtype == torch.int32
    assert th.same_bits(px.numpy(), np.asarray(rpx))
    assert th.same_bits(py.numpy(), np.asarray(rpy))


def _bands(n_tiles, hb, margin, width, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(n_tiles, hb + 2 * margin, width, 4).astype(np.float32)


@pytest.mark.parametrize("margin", [0, 1, 2])
@pytest.mark.parametrize("height,n_tiles", [(16, 4), (13, 4), (10, 8)])
def test_compose_and_unshift_are_the_references(margin, height, n_tiles):
    width = 6
    hb = -(-height // n_tiles)
    bands = _bands(n_tiles, hb, margin, width, seed=margin + height)
    assert th.same_bits(
        pm.compose_bands(bands, height, width, hb, margin),
        ref_pmesh.compose_bands(bands, height, width, hb, margin))
    placed = np.random.RandomState(7).randn(
        n_tiles * hb + 2 * margin, width, 7).astype(np.float32)
    assert th.same_bits(
        pm._unshift(placed, height, width, hb, margin),
        ref_pmesh._unshift(placed, height, width, hb, margin))


def test_init_distributed_without_a_coordinator(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert pm.init_distributed() is False
    assert not torch.distributed.is_initialized()
    m = pm.make_device_mesh(4, 2)
    assert m.shape == {"tiles": 4, "spp": 2} and m.device_mesh is None


def _setup(name, spp=None, depth=None):
    """port_setup with the sample count and depth replaced."""
    from dartray_tpu_torch import samplers
    from dartray_tpu_torch.integrators import path as pi
    scene, cam, smp, li, filt = golden.port_setup(name, "cpu")
    if spp is not None:
        smp = samplers.make_sampler("lowdiscrepancy", spp=spp)
    if depth is not None:
        ig = pi.PathIntegrator(max_depth=depth)
        li = lambda s, r, d, c: pi.li(ig, s, r, d, c)  # noqa: E731
    return scene, cam, smp, li, filt


@pytest.mark.parametrize("shape,spp,depth,size,filt,exact", [
    ((8, 1), 4, 3, (16, 16), "box", True),
    ((4, 1), 2, 2, (16, 16), "box", True),
    ((8, 1), 2, 2, (12, 10), "box", True),      # bands past the image
    ((4, 2), 4, 3, (16, 16), "box", False),
    ((2, 2), 4, 3, (16, 16), "box", False),
    ((4, 2), 2, 2, (16, 16), "gaussian", False),
])
def test_one_process_mesh_matches_render(shape, spp, depth, size, filt,
                                         exact):
    """``tests/test_sharding.py``'s scene and cases on the port: the
    one-process mesh against ``render`` of the same samples."""
    w, h = size
    scene, _, smp, li, _ = _setup("gaussian", spp, depth)
    from dartray_tpu_torch import cameras
    from dartray_tpu_torch.core import transform as tr
    eye, look, fov = golden.CONFIGS["gaussian"][1:4]
    cam = cameras.perspective(tr.look_at(eye, look, golden.UP), fov, w, h,
                              device="cpu")
    ref = rend.render(scene, cam, smp, li, w, h, filter_name=filt,
                      device="cpu")
    img = pm.render_sharded(scene, cam, smp, li, w, h,
                            pm.make_device_mesh(*shape), filter_name=filt,
                            device="cpu")
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    if exact:
        np.testing.assert_array_equal(img, ref)
    else:
        np.testing.assert_allclose(img, ref, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def mesh_golden():
    return np.load(golden.GOLDEN)


@pytest.mark.parametrize("name", list(golden.CONFIGS))
def test_one_process_mesh_matches_the_reference_golden(mesh_golden, name):
    """The port's one-process 4 x 2 mesh against the reference's
    ``render_sharded`` of the same configuration."""
    scene, cam, smp, li, filt = golden.port_setup(name, "cpu")
    img = pm.render_sharded(scene, cam, smp, li, golden.W, golden.H,
                            pm.make_device_mesh(*golden.MESH),
                            filter_name=filt, device="cpu")
    np.testing.assert_allclose(img, mesh_golden[f"{name}_img"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(golden.CONFIGS))
def test_mesh_golden_is_the_references(mesh_golden, name):
    """The reference, run again, renders the golden's image."""
    got, _ = golden.make((name,))
    assert np.array_equal(got[f"{name}_img"], mesh_golden[f"{name}_img"])


def _spawn_ranks(shape, filt, tmp_path):
    world = shape[0] * shape[1]
    torch.multiprocessing.spawn(
        th.mesh_rank, args=(world, str(tmp_path / "rendezvous"), shape,
                            "gaussian", filt, str(tmp_path)),
        nprocs=world, join=True)
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


@pytest.mark.parametrize("shape,filt", [((4, 1), "box"),
                                        ((2, 2), "gaussian")])
def test_gloo_ranks_match_render(tmp_path, shape, filt):
    """Spawned CPU ranks over gloo, each rendering its one cell: every
    rank's image equals ``render``'s (bit for bit with the box filter and
    one chunk, within tolerance otherwise). Known behaviour ai: the ranks'
    composed film sums the spp axis twice, so its weights are n_spp times
    the one-process mesh's. Known behaviour aj: a mesh of fewer cells than
    ranks, or of more, is refused."""
    outs = _spawn_ranks(shape, filt, tmp_path)
    scene, cam, smp, li, _ = golden.port_setup("gaussian", "cpu")
    w, h = golden.W, golden.H
    ref = rend.render(scene, cam, smp, li, w, h, filter_name=filt,
                      device="cpu")
    one_pixels, _ = pm.sharded_film(scene, cam, smp, li, w, h,
                                    pm.make_device_mesh(*shape),
                                    filter_name=filt, device="cpu")
    for out in outs:
        if filt == "box" and shape[1] == 1:
            np.testing.assert_array_equal(out["img"], ref)
        else:
            np.testing.assert_allclose(out["img"], ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out["pixels"][..., 3],
                                   shape[1] * one_pixels[..., 3], rtol=1e-6,
                                   atol=0)
        assert out["raised"].tolist() == [[1, 1], [len(outs), 2]]
    assert all(np.array_equal(o["img"], outs[0]["img"]) for o in outs)


@pytest.mark.cuda
def test_one_process_mesh_matches_render_on_the_card():
    """On the card, through the CUDA traversal kernel: the one-process
    4 x 1 mesh equals ``render`` bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    scene, _, smp, li, _ = golden.port_setup("dryrun", dev)
    from dartray_tpu_torch import cameras
    from dartray_tpu_torch.core import transform as tr
    eye, look, fov = golden.CONFIGS["dryrun"][1:4]
    cam = cameras.perspective(tr.look_at(eye, look, golden.UP), fov,
                              golden.W, golden.H, device=dev)
    ref = rend.render(scene, cam, smp, li, golden.W, golden.H, device=dev)
    img = pm.render_sharded(scene, cam, smp, li, golden.W, golden.H,
                            pm.make_device_mesh(4, 1), device=dev)
    np.testing.assert_array_equal(img, ref)
