"""PyTorch port, the Metropolis renderer: the threefry draws of
``core/prng.py``, the bidirectional radiance of ``integrators/bdpt.py``,
``path.li(skip_direct=True)`` and ``renderers/metropolis.py``, against the
JAX reference.

Bit for bit: ``prng`` against ``jax.random`` on the shapes MLT draws,
``_mutate_small`` and the current state's image position against the
reference's. Against ``tools/prt_golden.npz`` (``tools/make_prt_golden.py``):
``bdpt.path_l`` at depth 4 on 4,096 seeded primary-sample vectors over
scenes/prt.pbrt, >= 0.999 of lanes within rtol 1e-3 / atol 1e-4; the two
Metropolis variants of scenes/prt.pbrt through ``render_pbrt`` (2 steps of
8,192 chains, depth 3), >= 0.99 of pixels within rtol 1e-3 / atol 1e-4 and
the mean within 1e-3 relative: a chain parts from the reference's where an
accept draw lies within float noise of its acceptance probability.
``path.li(skip_direct=True)`` at depth 2 on 16 camera rays (the reference
un-jitted, its traversal its own CPU cluster walk) within rtol 1e-5 /
atol 1e-6.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu import samplers as ref_samplers
from dartray_tpu.core import math as ref_vm
from dartray_tpu.integrators import path as ref_path
from dartray_tpu.renderers import metropolis as ref_mlt
from dartray_tpu.scene import parser as ref_parser
from dartray_tpu.scene import resources as ref_res
from dartray_tpu.scene import types as ref_st

from dartray_tpu_torch import cameras
from dartray_tpu_torch import samplers
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.core import prng
from dartray_tpu_torch.core import sampling as smp
from dartray_tpu_torch.integrators import bdpt
from dartray_tpu_torch.integrators import path as pi
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.renderers import metropolis as mlt
from dartray_tpu_torch.renderers import sampler as rend
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import resources
from dartray_tpu_torch.scene import types as st

import torchhelp as th

sys.path.insert(0, os.path.join(th.ROOT, "tools"))
import make_prt_golden as golden  # noqa: E402

torch.set_num_threads(1)

QUIET = lambda *a, **k: None   # noqa: E731
N = 16


@pytest.fixture(scope="module")
def ref():
    return np.load(golden.GOLDEN)


@pytest.fixture(scope="module", autouse=True)
def eager(request):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    th.eager_reference(mp)
    th.reference_cluster_walk(mp)


def _job(name="mlt", text=None):
    return parser.parse(text or golden.variant_text(name),
                        resolver=resources.Resolver([golden.SCENES]),
                        log=QUIET, device="cpu")


@pytest.fixture(scope="module")
def rjob():
    """The reference's parse of the "mlt" variant, made once for the file."""
    return ref_parser.parse(golden.variant_text("mlt"),
                            resolver=ref_res.Resolver([golden.SCENES]),
                            log=QUIET)


# --- the draws ---------------------------------------------------------------

@pytest.mark.parametrize("fn", ["split", "uniform", "randint"])
def test_draws_equal_jax_random(fn):
    """PRNGKey, split (2, 5 and 37 keys), uniform on the bootstrap's
    (1,024 x 56) and (4,096 x 116), the chains' (8,192,) and
    (8,192 x 56), and randint as the bootstrap's scrambles draw it and
    on a small range: bit for bit."""
    keys = [(jax.random.PRNGKey(s), prng.PRNGKey(s)) for s in (0, 7, 2 ** 31)]
    for jk, pk in keys:
        assert np.array_equal(np.asarray(jk), pk)
        jk, pk = jax.random.split(jk)[1], prng.split(pk)[1]
        if fn == "split":
            for n in (2, 5, 37):
                assert th.same_bits(np.asarray(jax.random.split(jk, n)),
                                    prng.split(pk, n))
        elif fn == "uniform":
            for shape in ((1024, 56), (4096, 116), (8192,), (8192, 56)):
                assert th.same_bits(np.asarray(jax.random.uniform(jk, shape)),
                                    prng.uniform(pk, shape, "cpu").numpy())
        else:
            for shape, lo, hi in (((2,), 0, 2 ** 31 - 1), ((9,), 3, 1000)):
                assert th.same_bits(
                    np.asarray(jax.random.randint(jk, shape, lo, hi,
                                                  dtype=jnp.int32)),
                    prng.randint(pk, shape, lo, hi))


def test_mutate_small_equals_the_reference():
    """The small step on (8,192 x 56) seeded states and draws."""
    rng = np.random.RandomState(1)
    u, r1, r2 = (rng.rand(8192, 56).astype(np.float32) for _ in range(3))
    got = mlt._mutate_small(*(torch.from_numpy(a) for a in (u, r1, r2)))
    want = ref_mlt._mutate_small(*(jnp.asarray(a) for a in (u, r1, r2)))
    assert th.same_bits(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).all() and (got.numpy() < 1).all()


def test_current_state_position_equals_radiance_for(rjob):
    """The step reads the current state's image position from u; the
    reference evaluates the radiance of that state again for it: the same
    float32 values, bit for bit."""
    u = golden.path_l_u(256)
    _, xy = ref_mlt._radiance_for(
        ref_st.to_device(rjob.scene), rjob.camera, rjob.width, rjob.height,
        lambda s, r, d, c: ref_vm.v3zeros((r.o.x.shape[0],)), jnp.asarray(u),
        3)
    got = mlt.image_xy(torch.from_numpy(u), rjob.width, rjob.height)
    assert th.same_bits(got.x.numpy(), np.asarray(xy.x))
    assert th.same_bits(got.y.numpy(), np.asarray(xy.y))


# --- bidirectional radiance --------------------------------------------------

def test_path_l_matches_the_golden(ref, monkeypatch):
    """bdpt.path_l at depth 4 on the golden's 4,096 primary-sample vectors:
    3 D = 12 closest-hit launches (eye and light subpaths, the BSDF ray of
    each direct estimate) and D + D^2 = 20 any-hit launches (each direct
    estimate's shadow ray, the connections)."""
    from functools import partial
    job = _job()
    counts = th.count_launches(monkeypatch)
    li = partial(bdpt.path_l, max_depth=golden.PATH_L_DEPTH)
    L, _ = mlt._radiance_for(st.to_device(job.scene, "cpu"), job.camera,
                             job.width, job.height, li,
                             torch.from_numpy(golden.path_l_u()))
    assert counts == {"closest": 12, "any": 20}
    got, want = th.n3(L), ref["path_l"]
    assert (want > 0).any(1).mean() > 0.3
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(1)
    assert close.mean() >= 0.999, (close.mean(), np.abs(got - want).max())


def test_path_skip_direct_matches_the_reference(rjob):
    """path.li with skip_direct at depth 2 on 16 camera rays of
    scenes/prt.pbrt (the glass sphere gives specular prefixes)."""
    job = _job()
    px = torch.arange(N, dtype=torch.int32) * 7 % job.width
    py = torch.arange(N, dtype=torch.int32) * 3 % job.height + 6
    out = []
    for side in ("port", "ref"):
        if side == "port":
            smp_ = samplers.make_sampler("lowdiscrepancy", spp=4)
            cs = samplers.camera_samples(smp_, px, py, torch.zeros_like(px))
            rays, _, _ = cameras.generate_rays(job.camera, cs, job.width,
                                               job.height)
            L = pi.li(pi.PathIntegrator(max_depth=2),
                      st.to_device(job.scene, "cpu"), rays, None,
                      {"sampler": smp_, "px": px, "py": py,
                       "s_idx": torch.zeros_like(px)}, skip_direct=True)
        else:
            from dartray_tpu import cameras as ref_cameras
            jpx, jpy = jnp.asarray(px.numpy()), jnp.asarray(py.numpy())
            smp_ = ref_samplers.make_sampler("lowdiscrepancy", spp=4)
            cs = ref_samplers.camera_samples(smp_, jpx, jpy,
                                             jnp.zeros_like(jpx))
            rays, _, _ = ref_cameras.generate_rays(rjob.camera, cs,
                                                   rjob.width, rjob.height)
            L = ref_path.li(ref_path.PathIntegrator(max_depth=2),
                            ref_st.to_device(rjob.scene), rays, None,
                            {"sampler": smp_, "px": jpx, "py": jpy,
                             "s_idx": jnp.zeros_like(jpx)}, skip_direct=True)
        out.append(th.n3(L))
    assert (out[1] > 0).any(1).sum() >= 4
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["mlt", "mlt_nodirect"])
def test_mlt_render_pbrt_matches_the_golden(name, ref, monkeypatch):
    """The Metropolis variants through render_pbrt on the CPU: 2 steps of
    8,192 chains, each step one radiance evaluation (12 launches at depth
    3: 9 closest, 12 any), the bootstrap's and the chains' start one each;
    with dodirectseparately the direct pass's 4 waves (2 closest + 1 any
    each)."""
    counts = th.count_launches(monkeypatch)
    img = manager.render_pbrt(golden.variant_text(name),
                              search_paths=[golden.SCENES], log=QUIET,
                              device="cpu")
    direct = {"closest": 8, "any": 4} if name == "mlt" else {}
    assert counts == {"closest": 4 * 9 + direct.get("closest", 0),
                      "any": 4 * 12 + direct.get("any", 0)}, counts
    assert img.shape == ref[name].shape and np.isfinite(img).all()
    close = np.isclose(img, ref[name], rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(img - ref[name]).max())
    assert abs(img.mean() - ref[name].mean()) <= 1e-3 * ref[name].mean()


# --- known behaviours of the reference, kept ---------------------------------

def test_metropolis_from_the_front_door(monkeypatch):
    """Known behaviour ae: Renderer "metropolis" is always bidirectional
    with 8,192 chains and seed 0 (the file cannot set them), n_steps =
    max(spp W H // 8192, 1) (one step for a 16 x 16 film at spp 1), and
    the direct pass is directlighting "one" at depth 0 with lowdiscrepancy
    at 4 spp and the box filter, whatever sampler and filter the scene
    names."""
    text = golden.variant_text("mlt").replace(
        '"integer samplesperpixel" [64]', '"integer samplesperpixel" [1] '
        '"integer nchains" [16] "integer seed" [5] '
        '"bool bidirectional" ["false"]').replace(
        '"integer maxdepth" [3]', '"integer maxdepth" [1]').replace(
        'Sampler "lowdiscrepancy" "integer pixelsamples" [2]',
        'Sampler "random" "integer pixelsamples" [8]').replace(
        'PixelFilter "box"', 'PixelFilter "gaussian"')
    seen = {}
    real, real_rend = mlt.render, rend.render

    def spy(*a, **k):
        seen["kwargs"] = k
        seen["stats"] = k["stats"] = {}
        return real(*a, **k)

    def rend_spy(scene, camera, sampler, li_fn, w, h, **k):
        seen["direct"] = (sampler, k)
        return real_rend(scene, camera, sampler, li_fn, w, h, **k)

    monkeypatch.setattr(mlt, "render", spy)
    monkeypatch.setattr(rend, "render", rend_spy)
    manager.render_pbrt(text, search_paths=[golden.SCENES], log=QUIET,
                        device="cpu")
    k = seen["kwargs"]
    assert not {"n_chains", "seed", "bidirectional"} & set(k)
    assert k["spp"] == 1 and k["max_depth"] == 1
    assert seen["stats"]["chains"] == 8192 and seen["stats"]["steps"] == 1
    sampler, rk = seen["direct"]
    assert sampler.kind == samplers.LOWDISCREPANCY and sampler.spp == 4
    assert rk.get("filter_name", "box") == "box"
    import inspect
    d = inspect.signature(real).parameters
    assert (d["n_chains"].default, d["seed"].default,
            d["bidirectional"].default) == (8192, 0, True)


def test_bootstrap_reuses_one_key():
    """Known behaviour af: the bootstrap draws u_boot and the two
    scrambles of its image dims from one key, kb; randint's multiplier
    (2^16 % span)^2 wraps to 0 in uint32, so a scramble is the low bits'
    draw modulo 2^31 - 1."""
    seen = []

    def rad(u):
        seen.append(u.clone())
        return vm.v3ones((u.shape[0],), u.device), None

    mlt.bootstrap(rad, prng.PRNGKey(0), 64, 10, 32, "cpu")
    u = seen[0]
    jkb = jax.random.split(jax.random.PRNGKey(0))[0]
    kb = prng.split(prng.PRNGKey(0))[0]
    assert th.same_bits(u[:, 2:].numpy(),
                        np.asarray(jax.random.uniform(jkb, (64, 10)))[:, 2:])
    scr = np.asarray(jax.random.randint(jkb, (2,), 0, 2 ** 31 - 1,
                                        dtype=jnp.int32))
    _, k2 = prng.split(kb)
    assert th.same_bits(scr, (prng._bits_np(k2, (2,)) % (2 ** 31 - 1))
                        .astype(np.int32))
    b2 = smp.sample02(torch.arange(64), tuple(torch.tensor(int(s)) for s in
                                              scr))
    assert th.same_bits(u[:, 0].numpy(), b2.x.numpy())
    assert th.same_bits(u[:, 1].numpy(), b2.y.numpy())


def test_splats_are_nearest_pixel_expected_values():
    """Known behaviour ag: both states splat unfiltered to the pixel they
    lie in, weighted a b / I_prop and (1 - a) b / I_cur; non-finite
    radiance is zeroed before its luminance is taken."""
    job = _job()
    bad = torch.tensor([float("nan"), float("inf"), 1.0, -float("inf")])

    def li(s, r, d, c):
        return vm.V3(bad, bad, bad)

    u = torch.full((4, 8), 0.3)
    L, _ = mlt._radiance_for(st.to_device(job.scene, "cpu"), job.camera,
                             job.width, job.height, li, u)
    assert th.n3(L)[[0, 1, 3]].sum() == 0 and (th.n3(L)[2] > 0).all()
    W = H = 4
    u = torch.tensor([[0.1, 0.1], [0.6, 0.3], [0.9, 0.9]])
    L_cur = vm.V3(*(torch.tensor([1.0, 2.0, 0.0]),) * 3)
    I_cur = torch.tensor([1.0, 2.0, 0.0])

    def rad(up):
        return vm.V3(*(torch.tensor([2.0, 1.0, 4.0]),) * 3), mlt.image_xy(
            up, W, H)

    img = torch.zeros((H, W, 3))
    k = prng.PRNGKey(3)
    rejects = torch.zeros(3, dtype=torch.int32)
    mlt.mlt_step(rad, (u, L_cur, I_cur, rejects), k, 0.5, W, H, 1.0, 512,
                 img)
    # every step here is large: the proposal is uniform(k2)
    k2 = prng.split(k, 5)[1]
    up = prng.uniform(k2, (3, 2), "cpu")
    a = torch.tensor([1.0, 0.5, 1.0])
    want = torch.zeros((H, W))
    for i in range(3):
        Ip = [2.0, 1.0, 4.0][i]
        want[int(up[i, 1] * H), int(up[i, 0] * W)] += a[i] * 0.5 / Ip * Ip
        if I_cur[i] > 0:
            want[int(u[i, 1] * H), int(u[i, 0] * W)] += (1 - a[i]) * 0.5
    # luminance of a grey radiance is its value: Y = the splatted weight
    np.testing.assert_allclose(img[..., 1].numpy(), want.numpy(), rtol=1e-6)


def test_bdpt_reads_dims_modulo_d():
    """Known behaviour ah: dims_for(7) is 116, and path_l reads dimension
    d of a vector of D columns at d mod D: 12 columns drive depth 2 as the
    same 12 tiled to dims_for(2) do, bit for bit."""
    assert bdpt.dims_for(7) == 116 and bdpt.dims_for(7, False) == 82
    job = _job()
    scene = st.to_device(job.scene, "cpu")
    u = torch.from_numpy(golden.path_l_u(64)[:, :12])
    d = bdpt.dims_for(2)
    out = [th.n3(mlt._radiance_for(scene, job.camera, job.width, job.height,
                                   lambda s, r, dd, c: bdpt.path_l(
                                       s, r, dd, c, max_depth=2), x)[0])
           for x in (u, u[:, torch.arange(d) % 12])]
    assert th.same_bits(out[0], out[1]) and out[0].any()


def test_metropolis_runs_on_the_card_by_default():
    """No CUDA device here: the renderer asked for with the default device
    raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    job = _job()
    with pytest.raises(RuntimeError, match="cuda"):
        mlt.render(job.scene, job.camera, job.width, job.height)


@pytest.mark.slow
def test_golden_mlt_and_path_l_are_the_references(ref):
    """The reference, run again, gives the committed Metropolis images and
    path_l."""
    got, _ = golden.make(("mlt", "mlt_nodirect"))
    for k, v in got.items():
        assert np.array_equal(v, ref[k]), k
