"""PyTorch port, module by module: the same numpy inputs through the JAX
function and its counterpart in the port.

The sample stream (hashes, index permutation, (0,2)-sequence, sampler draws)
is integer arithmetic and must be BIT-EXACT: it is what makes a pixel-level
comparison of whole renders possible. Everything else is float32 arithmetic
in the same order of operations and is held to rtol 1e-5 / atol 1e-6 (the two
libraries differ by an ulp or two in rsqrt, sin/cos and sqrt).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dartray_tpu import bsdf as ref_bx
from dartray_tpu import cameras as ref_cam
from dartray_tpu import film as ref_film
from dartray_tpu import lights as ref_lt
from dartray_tpu import materials as ref_mat
from dartray_tpu import samplers as ref_samplers
from dartray_tpu.accel.traverse import Hits as RefHits
from dartray_tpu.core import math as ref_vm
from dartray_tpu.core import sampling as ref_smp
from dartray_tpu.core import transform as ref_tr
from dartray_tpu.integrators import common as ref_common
from dartray_tpu.scene import build as ref_sb
from dartray_tpu.scene import types as ref_st

from dartray_tpu_torch import bsdf as bx
from dartray_tpu_torch import cameras as cam
from dartray_tpu_torch import film as film_mod
from dartray_tpu_torch import lights as lt
from dartray_tpu_torch import materials as mat
from dartray_tpu_torch import samplers
from dartray_tpu_torch.accel.traverse import Hits
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.core import sampling as smp
from dartray_tpu_torch.core import transform as tr
from dartray_tpu_torch.integrators import common
from dartray_tpu_torch.scene import adapt
from dartray_tpu_torch.scene import types as st

import torchhelp as th

torch.set_num_threads(1)

N = 16384          # >= 1e4 inputs for the bit-exact stream tests
R = 512            # wavefront width of the float tests
TOL = dict(rtol=1e-5, atol=1e-6)


def _u32(n, seed):
    return np.random.RandomState(seed).randint(0, 2 ** 32, n,
                                               dtype=np.uint64)


def _pt(u):        # uint32 values -> the port's u32-in-int64 tensors
    return torch.from_numpy(u.astype(np.int64))


def _jx(u):
    return jnp.asarray(u.astype(np.uint32))


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{**TOL, **kw})


def close3(got, want, **kw):
    close(th.n3(got), th.n3(want), **kw)


# --- the sample stream: bit-exact -------------------------------------------

@pytest.mark.parametrize("fn", ["hash_u32", "van_der_corput", "sobol2",
                                "rng_uniform", "index_permute_64",
                                "index_permute_5"])
def test_sampling_bit_exact(fn):
    a, b = _u32(N, 1), _u32(N, 2)
    if fn == "hash_u32":
        got = smp.hash_u32(_pt(a)).numpy().astype(np.uint32)
        want = np.asarray(ref_smp.hash_u32(_jx(a)))
    elif fn.startswith("index_permute"):
        n = int(fn.split("_")[-1])
        got = smp.index_permute(_pt(a), n, _pt(b)).numpy().astype(np.uint32)
        want = np.asarray(ref_smp.index_permute(_jx(a), n, _jx(b)))
        assert got.max() < n
    else:
        got = getattr(smp, fn)(_pt(a), _pt(b)).numpy()
        want = np.asarray(getattr(ref_smp, fn)(_jx(a), _jx(b)))
    assert th.same_bits(got, want)


def test_sobol2_short_fold_is_the_full_fold():
    """Stopping the generator fold at the index's bit length changes no bit."""
    a, b = _u32(N, 3) % 64, _u32(N, 4)
    assert th.same_bits(smp.sobol2(_pt(a), _pt(b), n_bits=6).numpy(),
                        np.asarray(ref_smp.sobol2(_jx(a), _jx(b))))


@pytest.mark.parametrize("spp,seed", [(64, 0), (4, 7), (1, 0)])
def test_sampler_draws_bit_exact(spp, seed):
    rng = np.random.RandomState(5)
    px = rng.randint(0, 512, N).astype(np.int32)
    py = rng.randint(0, 512, N).astype(np.int32)
    s_idx = rng.randint(0, spp, N).astype(np.int32)
    s_ref = ref_samplers.make_sampler("lowdiscrepancy", spp=spp, seed=seed)
    s_port = samplers.make_sampler("lowdiscrepancy", spp=spp, seed=seed)
    assert s_port.spp == s_ref.spp
    tp_ = [torch.from_numpy(x) for x in (px, py, s_idx)]
    jp = [jnp.asarray(x) for x in (px, py, s_idx)]
    for dim in (0, 5, 16, 57):
        g2 = samplers.sample_2d(s_port, *tp_, dim)
        w2 = ref_samplers.sample_2d(s_ref, *jp, dim)
        assert th.same_bits(g2.x.numpy(), np.asarray(w2.x)), dim
        assert th.same_bits(g2.y.numpy(), np.asarray(w2.y)), dim
        g1 = samplers.sample_1d(s_port, *tp_, dim + 3)
        w1 = ref_samplers.sample_1d(s_ref, *jp, dim + 3)
        assert th.same_bits(g1.numpy(), np.asarray(w1)), dim
    gc = samplers.camera_samples(s_port, *tp_)
    wc = ref_samplers.camera_samples(s_ref, *jp)
    for g, w in ((gc.image_xy.x, wc.image_xy.x), (gc.image_xy.y,
                 wc.image_xy.y), (gc.lens_uv.x, wc.lens_uv.x),
                 (gc.time_u, wc.time_u)):
        assert th.same_bits(g.numpy(), np.asarray(w))


def test_warps():
    u = np.random.RandomState(6).rand(R, 2).astype(np.float32)
    ut = vm.V2(torch.from_numpy(u[:, 0].copy()), torch.from_numpy(u[:, 1].copy()))
    uj = ref_vm.V2(jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]))
    close3(smp.cosine_sample_hemisphere(ut),
           ref_smp.cosine_sample_hemisphere(uj))
    for g, w in zip(smp.uniform_sample_triangle(ut),
                    ref_smp.uniform_sample_triangle(uj)):
        close(g, w)
    for g, w in zip(smp.concentric_sample_disk(ut),
                    ref_smp.concentric_sample_disk(uj)):
        close(g, w)
    close(smp.power_heuristic(1.0, ut.x, 1.0, ut.y),
          ref_smp.power_heuristic(1.0, uj.x, 1.0, uj.y))


# --- camera, film ------------------------------------------------------------

@pytest.mark.parametrize("lens_radius", [0.0, 0.05])
def test_generate_rays(lens_radius):
    w, h = 48, 32
    eye, look, up = [0, 2.2, -5.0], [0, 0.9, 0], [0, 1, 0]
    c_ref = ref_cam.perspective(ref_tr.look_at(eye, look, up), 42.0, w, h,
                                lens_radius=lens_radius, focal_distance=4.0)
    c_port = cam.perspective(tr.look_at(eye, look, up), 42.0, w, h,
                             lens_radius=lens_radius, focal_distance=4.0,
                             device="cpu")
    close(c_port.raster2camera, c_ref.raster2camera, rtol=0, atol=0)
    rng = np.random.RandomState(7)
    xy = (rng.rand(R, 2) * [w, h]).astype(np.float32)
    uv = rng.rand(R, 2).astype(np.float32)
    tu = rng.rand(R).astype(np.float32)
    v2t = lambda a: vm.V2(torch.from_numpy(a[:, 0].copy()),
                          torch.from_numpy(a[:, 1].copy()))
    v2j = lambda a: ref_vm.V2(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]))
    g_rays, g_diffs, g_w = cam.generate_rays(
        c_port, samplers.CameraSamples(v2t(xy), v2t(uv), torch.from_numpy(tu)),
        w, h, 0.5)
    w_rays, w_diffs, w_w = ref_cam.generate_rays(
        c_ref, ref_cam.CameraSamples(v2j(xy), v2j(uv), jnp.asarray(tu)),
        w, h, 0.5)
    close3(g_rays.o, w_rays.o)
    close3(g_rays.d, w_rays.d)
    close(g_rays.time, w_rays.time)
    close(g_rays.tmax, w_rays.tmax)
    for g, ww in zip(g_diffs, w_diffs):
        close3(g, ww)
    close(g_w, w_w)


def test_film_add_samples_and_to_rgb():
    w, h = 16, 12
    rng = np.random.RandomState(8)
    xy = (rng.rand(R, 2) * [w + 2, h + 2] - 1).astype(np.float32)  # some off
    L = rng.rand(R, 3).astype(np.float32) * 3
    L[::17, 1] = np.nan
    L[::23, 0] = np.inf
    L[::29] = -1.0
    f_ref = ref_film.make_film(w, h)
    f_port = film_mod.make_film(w, h, device="cpu")
    for k in range(2):     # the port accumulates in place across waves
        f_ref = ref_film.add_samples(
            f_ref, ref_vm.V2(jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1])),
            th.j3(L))
        f_port = film_mod.add_samples(
            f_port, vm.V2(torch.from_numpy(xy[:, 0].copy()),
                          torch.from_numpy(xy[:, 1].copy())), th.t3(L))
    # sums of a few dozen samples per pixel, in another order
    close(f_port.pixels, f_ref.pixels, rtol=1e-5, atol=1e-5)
    close(film_mod.to_rgb(f_port), ref_film.to_rgb(f_ref), rtol=1e-4,
          atol=1e-5)


# --- shading: one scene, carried over bit for bit ---------------------------

@pytest.fixture(scope="module")
def scenes():
    """Cornell box with a glass and a matte sphere plus the mirror row, so
    the tables hold matte, mirror and glass materials."""
    rb = ref_sb.cornell_box()
    glass_id = rb.add_material(ref_mat.glass())
    on_id = rb.add_material(ref_mat.matte(kd=(0.5, 0.4, 0.3), sigma=20.0))
    ref_host = rb.build()
    port = st.to_device(adapt.from_reference(th.np_tree(ref_host)), "cpu")
    return ref_st.to_device(ref_host), port, (glass_id, on_id)


@pytest.fixture(scope="module")
def wave(scenes):
    """Random hits on random prims (some misses), random incoming rays."""
    ref, port, _ = scenes
    rng = np.random.RandomState(9)
    f = port.geometry.n_prims
    prim = rng.randint(-1, f, R).astype(np.int32)
    b1 = rng.rand(R).astype(np.float32) * 0.5
    b2 = rng.rand(R).astype(np.float32) * 0.5
    t = (rng.rand(R).astype(np.float32) * 3 + 0.1)
    o, d = th.ray_arrays(R, seed=10)
    hits_p = Hits(torch.from_numpy(t), torch.from_numpy(prim),
                  torch.from_numpy(b1), torch.from_numpy(b2))
    hits_r = RefHits(jnp.asarray(t), jnp.asarray(prim), jnp.asarray(b1),
                     jnp.asarray(b2))
    rays_p = vm.make_rays(th.t3(o), th.t3(d))
    rays_r = ref_vm.make_rays(th.j3(o), th.j3(d))
    it_p = st.interaction(port.geometry, rays_p, hits_p)
    it_r = ref_st.interaction(ref.geometry, rays_r, hits_r)
    return dict(rng=rng, hits_p=hits_p, hits_r=hits_r, rays_p=rays_p,
                rays_r=rays_r, it_p=it_p, it_r=it_r)


def test_interaction(scenes, wave):
    it_p, it_r = wave["it_p"], wave["it_r"]
    for k in ("p", "ng", "ns", "dpdu", "dpdv", "wo"):
        close3(it_p[k], it_r[k])
    close(it_p["uv"].x, it_r["uv"].x)
    close(it_p["uv"].y, it_r["uv"].y)
    for k in ("mat_id", "light_id", "prim"):
        assert th.same_bits(it_p[k].numpy(), np.asarray(it_r[k])), k
    close(st.ray_epsilon(it_p["t"]), ref_st.ray_epsilon(it_r["t"]))


def test_interaction_uv_footprint(scenes, wave):
    ref, port, _ = scenes
    o, d = th.ray_arrays(R, seed=11)
    dp = cam.RayDiffs(wave["rays_p"].o, th.t3(d), wave["rays_p"].o, th.t3(o))
    dr = ref_cam.RayDiffs(wave["rays_r"].o, th.j3(d), wave["rays_r"].o,
                          th.j3(o))
    it_p = st.interaction(port.geometry, wave["rays_p"], wave["hits_p"], dp)
    it_r = ref_st.interaction(ref.geometry, wave["rays_r"], wave["hits_r"],
                              dr)
    # quotients of small differences: relative to the footprint's size
    for g, w in zip(it_p["tex_duv"], it_r["tex_duv"]):
        w = np.asarray(w)
        close(g, w, rtol=1e-3, atol=1e-4 * max(np.abs(w).max(), 1.0))


def _params(scenes, wave, which):
    ref, port, (glass_id, on_id) = scenes
    rng = np.random.RandomState(12)
    ids = {"scene": np.array(wave["it_r"]["mat_id"]),
           "glass": np.full(R, glass_id, np.int32),
           "oren_nayar": np.full(R, on_id, np.int32),
           "mixed": rng.randint(0, port.materials.n, R).astype(np.int32)}[which]
    p_p = mat.eval_params(port.materials, torch.from_numpy(ids))
    p_r = ref_mat.eval_params(ref.materials, jnp.asarray(ids))
    return p_p, p_r


def _frames(wave):
    it_p, it_r = wave["it_p"], wave["it_r"]
    return (bx.make_frame(it_p["ns"], it_p["dpdu"], it_p["ng"]),
            ref_bx.make_frame(it_r["ns"], it_r["dpdu"], it_r["ng"]))


@pytest.mark.parametrize("which", ["scene", "glass", "oren_nayar", "mixed"])
def test_eval_params_and_bsdf(scenes, wave, which):
    p_p, p_r = _params(scenes, wave, which)
    for k in ("kd", "kr", "kt"):
        close3(getattr(p_p, k), getattr(p_r, k), rtol=0, atol=0)
    for k in ("sigma", "eta", "spec_fresnel"):
        close(getattr(p_p, k), getattr(p_r, k), rtol=0, atol=0)
    fr_p, fr_r = _frames(wave)
    for k in ("s", "t", "n"):
        close3(getattr(fr_p, k), getattr(fr_r, k))
    _, wi = th.ray_arrays(R, seed=13)
    wo_p, wo_r = wave["it_p"]["wo"], wave["it_r"]["wo"]
    for flags in (bx.ALL, bx.ALL & ~bx.SPECULAR):
        close3(bx.f(p_p, fr_p, wo_p, th.t3(wi), flags),
               ref_bx.f(p_r, fr_r, wo_r, th.j3(wi), flags))
        close(bx.pdf(p_p, fr_p, wo_p, th.t3(wi), flags),
              ref_bx.pdf(p_r, fr_r, wo_r, th.j3(wi), flags))
    rng = np.random.RandomState(14)
    u2 = rng.rand(R, 2).astype(np.float32)
    uc = rng.rand(R).astype(np.float32)
    s_p = bx.sample_f(p_p, fr_p, wo_p,
                      vm.V2(torch.from_numpy(u2[:, 0].copy()),
                            torch.from_numpy(u2[:, 1].copy())),
                      torch.from_numpy(uc))
    s_r = ref_bx.sample_f(p_r, fr_r, wo_r,
                          ref_vm.V2(jnp.asarray(u2[:, 0]),
                                    jnp.asarray(u2[:, 1])), jnp.asarray(uc))
    assert (s_p.valid.numpy() == np.asarray(s_r.valid)).all()
    assert (s_p.flags.numpy() == np.asarray(s_r.flags)).all()
    ok = np.asarray(s_r.valid)
    close(th.n3(s_p.wi)[ok], th.n3(s_r.wi)[ok], atol=1e-5)
    # specular f is kr * F / |cos|: large near grazing, so relative
    close(th.n3(s_p.f)[ok], th.n3(s_r.f)[ok], rtol=1e-4, atol=1e-5)
    close(s_p.pdf.numpy()[ok], np.asarray(s_r.pdf)[ok])


def test_lights(scenes, wave):
    ref, port, _ = scenes
    rng = np.random.RandomState(15)
    u = rng.rand(R, 2).astype(np.float32)
    uc = rng.rand(R).astype(np.float32)
    idx = np.zeros(R, np.int32)
    ls_p = lt.sample_li(port.lights, port.geometry, torch.from_numpy(idx),
                        wave["it_p"]["p"],
                        vm.V2(torch.from_numpy(u[:, 0].copy()),
                              torch.from_numpy(u[:, 1].copy())),
                        torch.from_numpy(uc))
    ls_r = ref_lt.sample_li(ref.lights, ref.geometry, jnp.asarray(idx),
                            wave["it_r"]["p"],
                            ref_vm.V2(jnp.asarray(u[:, 0]),
                                      jnp.asarray(u[:, 1])), jnp.asarray(uc))
    close3(ls_p.wi, ls_r.wi)
    close3(ls_p.li, ls_r.li)
    close(ls_p.pdf, ls_r.pdf, rtol=1e-4)
    close(ls_p.dist, ls_r.dist)
    assert (ls_p.is_delta.numpy() == np.asarray(ls_r.is_delta)).all()
    cosv = rng.rand(R).astype(np.float32)
    close(lt.pdf_li_area(port.lights, torch.from_numpy(idx),
                         wave["it_p"]["p"], ls_p.wi, ls_p.dist,
                         torch.from_numpy(cosv)),
          ref_lt.pdf_li_area(ref.lights, jnp.asarray(idx), wave["it_r"]["p"],
                             ls_r.wi, ls_r.dist, jnp.asarray(cosv)))
    for lid in (None, "it"):
        close3(lt.le_emitted(port.lights, port.geometry, wave["hits_p"].prim,
                             wave["it_p"]["wo"], wave["it_p"]["ns"],
                             lid=None if lid is None
                             else wave["it_p"]["light_id"]),
               ref_lt.le_emitted(ref.lights, ref.geometry,
                                 wave["hits_r"].prim, wave["it_r"]["wo"],
                                 wave["it_r"]["ns"],
                                 lid=None if lid is None
                                 else wave["it_r"]["light_id"]))
    g_i, g_pdf = lt.sample_light_index(port.lights, torch.from_numpy(uc))
    w_i, w_pdf = ref_lt.sample_light_index(ref.lights, jnp.asarray(uc))
    assert (g_i.numpy() == np.asarray(w_i)).all()
    close(g_pdf, w_pdf)


def test_nee_prepare_and_emitter_hit_mis(scenes, wave):
    ref, port, _ = scenes
    p_p, p_r = _params(scenes, wave, "scene")
    fr_p, fr_r = _frames(wave)
    rng = np.random.RandomState(16)
    us = rng.rand(R).astype(np.float32)
    ul = rng.rand(R, 2).astype(np.float32)
    ucl = rng.rand(R).astype(np.float32)
    mask = np.asarray(wave["hits_r"].prim) >= 0
    sr_p, us_p, c_p = common.nee_prepare(
        port, wave["it_p"], fr_p, p_p, wave["it_p"]["wo"],
        torch.from_numpy(us),
        vm.V2(torch.from_numpy(ul[:, 0].copy()),
              torch.from_numpy(ul[:, 1].copy())),
        torch.from_numpy(ucl), mask=torch.from_numpy(mask))
    sr_r, us_r, c_r = ref_common.nee_prepare(
        ref, wave["it_r"], fr_r, p_r, wave["it_r"]["wo"], jnp.asarray(us),
        ref_vm.V2(jnp.asarray(ul[:, 0]), jnp.asarray(ul[:, 1])),
        jnp.asarray(ucl), mask=jnp.asarray(mask))
    assert (us_p.numpy() == np.asarray(us_r)).all()
    ok = np.asarray(us_r)
    close(th.n3(c_p)[ok], th.n3(c_r)[ok], rtol=1e-4)
    close3(sr_p.o, sr_r.o)
    close3(sr_p.d, sr_r.d)
    close(sr_p.tmax, sr_r.tmax)
    prev_pdf = rng.rand(R).astype(np.float32)
    prev_spec = rng.rand(R) < 0.3
    for first in (True, False):
        close3(common.emitter_hit_mis(port, wave["rays_p"], wave["hits_p"],
                                      wave["it_p"],
                                      torch.from_numpy(prev_pdf),
                                      torch.from_numpy(prev_spec), first),
               ref_common.emitter_hit_mis(ref, wave["rays_r"],
                                          wave["hits_r"], wave["it_r"],
                                          jnp.asarray(prev_pdf),
                                          jnp.asarray(prev_spec), first),
               rtol=1e-4)
