"""PyTorch port, ``parallel/mesh.py``: band-sharded rendering over a tiles x
spp mesh, in one process and over spawned gloo ranks.

The host helpers (``band_pixel_grid``, ``compose_bands``, ``_unshift``) are
held against the reference's arrays. The port's sharded image is held
against the port's own ``render`` (bit for bit with the box filter and one
chunk a band; within rtol 2e-3 / atol 2e-4, the reference's
``tests/test_sharding.py`` tolerance, where chunks or wide filters sum in
another order) and against the reference's sharded images in
``tools/mesh_golden.npz`` (``tools/make_mesh_golden.py``; one ``slow`` case
an image renders them again). Ranks rendezvous through a file under a
temporary directory of their own; one spawn of four ranks serves every gloo
case.
"""
import functools
import os
import sys
import time

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
# seconds a spawn of ranks may take: about 8 s alone, a few times that on a
# loaded host; a rendezvous that hangs is cut here
SPAWN_DEADLINE_S = 180
# the gloo cases: (tiles x spp mesh, filter), all run by one spawn of ranks
GLOO_RUNS = (((4, 1), "box"), ((2, 2), "gaussian"))


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


def _camera(name, w, h):
    from dartray_tpu_torch import cameras
    from dartray_tpu_torch.core import transform as tr
    eye, look, fov = golden.CONFIGS[name][1:4]
    return cameras.perspective(tr.look_at(eye, look, golden.UP), fov, w, h,
                               device="cpu")


@pytest.fixture(scope="module")
def render_once():
    """``render`` of the gaussian configuration at (spp, depth, (w, h),
    filter), rendered once for this file and read by every case that holds
    a mesh against it."""
    @functools.cache
    def render(spp, depth, size, filt):
        w, h = size
        scene, _, smp, li, _ = _setup("gaussian", spp, depth)
        img = rend.render(scene, _camera("gaussian", w, h), smp, li, w, h,
                          filter_name=filt, device="cpu")
        img.setflags(write=False)
        return img
    return render


@pytest.fixture(scope="module")
def sharded_once():
    """The one-process ``render_sharded`` image of (configuration, spp,
    depth, (w, h), filter, mesh shape), rendered once for this file."""
    @functools.cache
    def sharded(name, spp, depth, size, filt, shape):
        w, h = size
        scene, _, smp, li, _ = _setup(name, spp, depth)
        img = pm.render_sharded(scene, _camera(name, w, h), smp, li, w, h,
                                pm.make_device_mesh(*shape),
                                filter_name=filt, device="cpu")
        img.setflags(write=False)
        return img
    return sharded


@pytest.mark.parametrize("shape,spp,depth,size,filt,exact", [
    ((8, 1), 4, 3, (16, 16), "box", True),
    ((4, 1), 2, 2, (16, 16), "box", True),
    ((8, 1), 2, 2, (12, 10), "box", True),      # bands past the image
    ((4, 2), 4, 3, (16, 16), "box", False),
    ((2, 2), 4, 3, (16, 16), "box", False),
    ((4, 2), 2, 2, (16, 16), "gaussian", False),
])
def test_one_process_mesh_matches_render(render_once, sharded_once, shape,
                                         spp, depth, size, filt, exact):
    """``tests/test_sharding.py``'s scene and cases on the port: the
    one-process mesh against ``render`` of the same samples."""
    w, h = size
    ref = render_once(spp, depth, size, filt)
    img = sharded_once("gaussian", spp, depth, size, filt, shape)
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    if exact:
        np.testing.assert_array_equal(img, ref)
    else:
        np.testing.assert_allclose(img, ref, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def mesh_golden():
    return np.load(golden.GOLDEN)


@pytest.mark.parametrize("name", list(golden.CONFIGS))
def test_one_process_mesh_matches_the_reference_golden(mesh_golden,
                                                       sharded_once, name):
    """The port's one-process 4 x 2 mesh against the reference's
    ``render_sharded`` of the same configuration."""
    spp, depth, filt = golden.CONFIGS[name][4:]
    img = sharded_once(name, spp, depth, (golden.W, golden.H), filt,
                       golden.MESH)
    np.testing.assert_allclose(img, mesh_golden[f"{name}_img"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(golden.CONFIGS))
def test_mesh_golden_is_the_references(mesh_golden, name):
    """The reference, run again, renders the golden's image."""
    got, _ = golden.make((name,))
    assert np.array_equal(got[f"{name}_img"], mesh_golden[f"{name}_img"])


def _spawn_ranks(world, runs, out_dir):
    """Spawn `world` ranks that render each of `runs` in turn and join them
    within SPAWN_DEADLINE_S: a rendezvous that never completes fails the
    cases that read them, the ranks terminated, instead of holding the whole
    run. Returns, for each run, the ranks' outputs in rank order."""
    ctx = torch.multiprocessing.spawn(
        th.mesh_rank, args=(world, str(out_dir / "rendezvous"), runs,
                            "gaussian", str(out_dir)),
        nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                pytest.fail(f"{world} gloo ranks still running after "
                            f"{SPAWN_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    return [[np.load(out_dir / f"rank{r}_{i}.npz") for r in range(world)]
            for i in range(len(runs))]


@pytest.fixture(scope="module")
def gloo_outs(tmp_path_factory):
    """{(shape, filter): the ranks' outputs} of every gloo case, from one
    spawn of four ranks: the cases share its start-up and rendezvous."""
    world, = {shape[0] * shape[1] for shape, _ in GLOO_RUNS}
    outs = _spawn_ranks(world, GLOO_RUNS, tmp_path_factory.mktemp("gloo"))
    return dict(zip(GLOO_RUNS, outs))


@pytest.mark.parametrize("shape,filt", GLOO_RUNS)
def test_gloo_ranks_match_render(gloo_outs, render_once, shape, filt):
    """Spawned CPU ranks over gloo, each rendering its one cell: every
    rank's image equals ``render``'s (bit for bit with the box filter and
    one chunk, within tolerance otherwise). Known behaviour ai: the ranks'
    composed film sums the spp axis twice, so its weights are n_spp times
    the one-process mesh's. Known behaviour aj: a mesh of fewer cells than
    ranks, or of more, is refused."""
    outs = gloo_outs[shape, filt]
    scene, cam, smp, li, _ = golden.port_setup("gaussian", "cpu")
    w, h = golden.W, golden.H
    ref = render_once(*golden.CONFIGS["gaussian"][4:6], (w, h), filt)
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
