"""PyTorch port, the instant global illumination integrator: the VPL
shooting of ``preprocess``, the gather of ``li`` and the ``igi`` branch of the
render manager, against the JAX reference on the same seeded inputs.

The reference runs un-jitted, its ``fori_loop``s as Python loops
(``torchhelp.eager_reference``) and its traversal as its own CPU walk over
the cluster BVH (``torchhelp.reference_cluster_walk``). Units: rtol 1e-5 / atol 1e-6 on at least 99.5 % of the
VPLs or lanes. The whole render of scenes/igi-env.pbrt and its VPL set are
held against ``tools/volume_golden.npz`` (``tools/make_volume_golden.py``):
at least 99 % of pixels within rtol 1e-3 / atol 1e-4, the mean within 1e-3
relative, and the traversal launches exact.
"""
import collections
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu import lights as ref_lt
from dartray_tpu import samplers as ref_samplers
from dartray_tpu.core import math as ref_vm
from dartray_tpu.integrators import igi as ref_igi
from dartray_tpu.scene import build as ref_sb
from dartray_tpu.scene import types as ref_st

from dartray_tpu_torch import lights as lt_mod
from dartray_tpu_torch import materials as mat_mod
from dartray_tpu_torch import samplers
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.integrators import igi
from dartray_tpu_torch.ops import traverse_cuda as tc
from dartray_tpu_torch.renderers import manager
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene import build as sb
from dartray_tpu_torch.scene import mesh
from dartray_tpu_torch.scene import parser
from dartray_tpu_torch.scene import resources
from dartray_tpu_torch.scene import types as st

import torchhelp as th

sys.path.insert(0, os.path.join(th.ROOT, "tools"))
import make_volume_golden as golden  # noqa: E402

torch.set_num_threads(1)

N = 256
RTOL, ATOL = 1e-5, 1e-6
QUIET = lambda *a, **k: None   # noqa: E731
SMALL = dict(n_light_paths=4, n_light_sets=2, max_depth=2)


@pytest.fixture(scope="module", autouse=True)
def eager(request):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    th.eager_reference(mp)
    th.reference_cluster_walk(mp)


@pytest.fixture(scope="module")
def box():
    """The Cornell box with a point light beside its area light, in both
    packages (the port's carried from the reference's host scene), and the
    reference's VPL set over it."""
    b = ref_sb.cornell_box()
    b.add_light(ref_lt.point_light((0.3, 1.5, -0.2), (3.0, 2.5, 2.0)))
    host = b.build()
    rscene = ref_st.to_device(host)
    return dict(rscene=rscene,
                scene=st.to_device(adapt.from_reference(th.np_tree(host)),
                                   "cpu"),
                rvpls=ref_igi.preprocess(ref_igi.IGIIntegrator(**SMALL),
                                         rscene))


def _close(got, want, what="", share=0.995):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    ok = np.isclose(got, want, rtol=RTOL, atol=ATOL)
    ok = ok.reshape(ok.shape[0], -1).all(-1) if ok.ndim > 1 else ok
    assert ok.mean() >= share, (what, ok.mean(), np.abs(got - want).max())


def _vpl_arrays(v):
    """A VPLData of either package -> {igi_vpl_*: numpy}, the golden's
    layout."""
    v3 = lambda a: np.stack([np.asarray(c) for c in a], -1)
    return {"igi_vpl_p": v3(v.p), "igi_vpl_n": v3(v.n),
            "igi_vpl_alpha": v3(v.alpha),
            "igi_vpl_valid": np.asarray(v.valid)}


def _same_vpls(got, want):
    assert np.array_equal(got["igi_vpl_valid"], want["igi_vpl_valid"])
    ok = got["igi_vpl_valid"]
    assert ok.any()
    for k in ("igi_vpl_p", "igi_vpl_n", "igi_vpl_alpha"):
        _close(got[k][ok], want[k][ok], k)


def test_preprocess_matches_the_reference(box):
    """An area and a point light, chosen by power."""
    got = igi.preprocess(igi.IGIIntegrator(**SMALL), box["scene"],
                         device="cpu")
    assert got.valid.shape == (2, 8)
    _same_vpls(_vpl_arrays(got), _vpl_arrays(box["rvpls"]))


def test_li_matches_the_reference(box):
    """The gather over the reference's own VPL set, carried to the port, on
    camera rays through the box: emission, one sampled light and 8 VPLs."""
    rv = box["rvpls"]
    a = _vpl_arrays(rv)
    t3 = lambda x: vm.V3(*(torch.from_numpy(np.ascontiguousarray(
        x[..., c])) for c in range(3)))
    pv = igi.VPLData(p=t3(a["igi_vpl_p"]), n=t3(a["igi_vpl_n"]),
                     alpha=t3(a["igi_vpl_alpha"]),
                     valid=torch.from_numpy(a["igi_vpl_valid"].copy()))
    rng = np.random.RandomState(8)
    o = np.tile(np.float32([0.0, 1.0, -3.4]), (N, 1))
    d = np.stack([rng.uniform(-0.35, 0.35, N), rng.uniform(-0.35, 0.35, N),
                  np.ones(N)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    px = (np.arange(N) % 16).astype(np.int32)
    py = (np.arange(N) // 16).astype(np.int32)
    rsctx = {"sampler": ref_samplers.make_sampler("lowdiscrepancy", spp=4),
             "px": jnp.asarray(px), "py": jnp.asarray(py),
             "s_idx": jnp.full((N,), 2, jnp.int32)}
    sctx = {"sampler": samplers.make_sampler("lowdiscrepancy", spp=4),
            "px": torch.from_numpy(px), "py": torch.from_numpy(py),
            "s_idx": torch.full((N,), 2, dtype=torch.int32)}
    want = ref_igi.li(ref_igi.IGIIntegrator(**SMALL), box["rscene"],
                      ref_vm.make_rays(jnp.asarray(o), jnp.asarray(d)),
                      None, rsctx, rv)
    got = igi.li(igi.IGIIntegrator(**SMALL), box["scene"],
                 vm.make_rays(th.t3(o), th.t3(d)), None, sctx, pv)
    _close(th.n3(got), th.n3(want), "L")
    assert th.n3(got).sum() > 0


# --- known behaviours of the reference, kept ---------------------------------

def test_an_infinite_light_shoots_from_the_origin(monkeypatch):
    """Known behaviour r: igi-env.pbrt's only light is infinite, and every
    light path leaves the origin (its LightSpec.p), 1e-3 along a uniform
    sphere direction, as from a point light."""
    job = parser.parse(golden.variant_text("igi_env"),
                       resolver=resources.Resolver([golden.SCENES]),
                       log=QUIET, device="cpu")
    assert job.scene.lights.n == 1 and job.scene.lights.kind[0] == \
        lt_mod.INFINITE and not job.scene.lights.p.any()
    first = []
    real = st.intersect
    monkeypatch.setattr(st, "intersect", lambda g, r, **k: (
        first.append(r) if not first else None, real(g, r, **k))[1])
    igi.preprocess(igi.IGIIntegrator(**SMALL), job.scene, device="cpu")
    r = first[0]
    assert torch.allclose(vm.length(r.o), torch.full((8,), 1e-3))
    assert torch.allclose(r.o.x * 1e3, r.d.x, atol=1e-6)


def test_vpl_throughput_takes_kd_plus_ks():
    """Known behaviour s: in a closed box of plastic walls lit by one point
    light, every first-bounce VPL holds I 4 pi / n_paths (the light's
    alpha) times rho / pi with rho = kd + ks of the fixed-slot BSDF."""
    b = sb.SceneBuilder()
    kd, ks = (0.5, 0.3, 0.2), (0.25, 0.25, 0.25)
    b.add_material(mat_mod.plastic(kd=kd, ks=ks))
    cube = mesh.make_mesh(
        [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
         [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
        [[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
         [3, 2, 6], [3, 6, 7], [0, 3, 7], [0, 7, 4], [1, 5, 6], [1, 6, 2]])
    b.add_mesh(cube, 0)
    inten = np.float32([4.0, 3.0, 2.0])
    b.add_light(lt_mod.point_light((0.1, 0.2, -0.1), tuple(inten)))
    ig = igi.IGIIntegrator(n_light_paths=8, n_light_sets=1, max_depth=1)
    v = igi.preprocess(ig, b.build(), device="cpu")
    assert v.valid.all()
    want = inten * 4.0 * (np.float32(kd) + np.float32(ks)) / 8.0
    got = th.n3(v.alpha)[0]
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape),
                               rtol=1e-6)


# --- the whole render --------------------------------------------------------

def _check_image(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(img - ref).max())
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()


def test_render_pbrt_matches_the_references_golden_image(monkeypatch):
    """scenes/igi-env.pbrt through render_pbrt on the CPU: its VPL set
    (3 closest-hit launches to shoot), then a wave of 1 camera closest, 1
    closest + 1 any-hit for the sampled light and 48 any-hit for the VPLs
    (nlights 16 x maxdepth 3), and the image."""
    counts = collections.Counter()
    real = tc.traverse6

    def counted(bvh, o, d, tmin, tmax, *, any_hit=False, anyf=None,
                time=None):
        counts["mixed" if anyf is not None else
               "any" if any_hit else "closest"] += 1
        return real(bvh, o, d, tmin, tmax, any_hit=any_hit, anyf=anyf,
                    time=time)

    monkeypatch.setattr(tc, "traverse6", counted)
    shot = []
    real_pre = igi.preprocess
    monkeypatch.setattr(igi, "preprocess", lambda *a, **k: (
        shot.append(real_pre(*a, **k)), shot[-1])[1])
    job = parser.parse(golden.variant_text("igi_env"),
                       resolver=resources.Resolver([golden.SCENES]),
                       log=QUIET, device="cpu")
    img = manager.run(job, log=QUIET, device="cpu")
    spp = job.sampler.spp
    assert counts == {"closest": 3 + 2 * spp, "any": 49 * spp}, counts
    ref = np.load(golden.GOLDEN)
    _check_image(img, ref["igi_env"])
    # the VPLs the manager shot are the reference's
    assert len(shot) == 1 and shot[0].valid.shape == (4, 48)
    _same_vpls(_vpl_arrays(shot[0]),
               {k: ref[k] for k in ref.files if k.startswith("igi_vpl")})


def test_igi_runs_on_the_card_by_default():
    """No CUDA device here: the igi integrator's preprocess asked for with
    the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    job = parser.parse(golden.variant_text("igi_env"),
                       resolver=resources.Resolver([golden.SCENES]),
                       log=QUIET, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        manager.build_surface_li(job, log=QUIET)


@pytest.mark.slow
def test_golden_vpls_and_image_are_the_references():
    """The reference, run again, gives the committed igi_env image and VPL
    set."""
    ref = np.load(golden.GOLDEN)
    images, _ = golden.make(["igi_env"])
    for name, img in images.items():
        assert np.array_equal(img, ref[name]), name
