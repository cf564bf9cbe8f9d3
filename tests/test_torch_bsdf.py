"""PyTorch port, the BSDF stack (``bsdf.py``) and the measured-BRDF loaders
(``io/merl.py``) against the JAX reference on the same seeded inputs.

One material table holds a row for every lobe slot alone (each Fresnel mode
of the glossy and specular slots, isotropic and anisotropic exponents) and
the row of every material builder; 512 lanes a row, directions on both sides
of the surface, a geometric normal apart from the shading normal. ``f``,
``pdf`` and ``sample_f`` run once a flag mask in each package (the reference
eagerly) and every (row, mask) case is held on its own lanes: f and pdf
within 1e-5 of the largest |value| of the case plus rtol 1e-4, sampled
directions within 1e-5, sampled flags and validity equal. A sampled
non-specular f and pdf are held against the reference's ``f`` and ``pdf``
at the port's sampled direction: in back-scatter from grazing incidence
wo + wi nearly cancels, and the 1e-7 by which the two packages' sampled
directions differ moves the half vector, and the pdf, by 4e-4.
"""
import io
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dartray_tpu import bsdf as ref_bx
from dartray_tpu import materials as ref_mat
from dartray_tpu.core import math as ref_vm
from dartray_tpu.io import merl as ref_merl

from dartray_tpu_torch import bsdf as bx
from dartray_tpu_torch import materials as mat
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.io import merl
from dartray_tpu_torch.scene import types as st

import torchhelp as th

torch.set_num_threads(1)

LANES = 512
ATOL_OF_MAX = 1e-5
RTOL = 1e-4
DIR_ATOL = 1e-5


def merl_table(seed, dims=(4, 4, 8)):
    return np.random.RandomState(seed).rand(*dims, 3).astype(np.float32)


# every slot alone, then every builder's stack: (name, rows(materials mod))
ROWS = [
    ("diff_r_lambert", lambda m: m._row(kd=(0.5, 0.4, 0.3))),
    ("diff_r_oren_nayar", lambda m: m._row(kd=(0.5, 0.4, 0.3), sigma=25.0)),
    ("diff_t", lambda m: m._row(kd_t=(0.3, 0.5, 0.2), sigma=10.0)),
    ("gloss_r_noop", lambda m: m._row(ks=(0.7, 0.6, 0.5), roughness=0.05,
                                      gloss_fresnel=m.FR_NOOP)),
    ("gloss_r_dielectric", lambda m: m._row(ks=(0.7, 0.6, 0.5),
                                            roughness=0.2, eta=1.7)),
    ("gloss_r_conductor", lambda m: m._row(ks=(1, 1, 1), roughness=0.01,
                                           gloss_fresnel=m.FR_CONDUCTOR)),
    ("gloss_r_blend", lambda m: m._row(ks=(0.3, 0.3, 0.3), roughness=0.1,
                                       gloss_fresnel=m.FR_BLEND)),
    ("gloss_r_aniso", lambda m: m._row(ks=(0.7, 0.6, 0.5), roughness=0.02,
                                       vroughness=0.3)),
    ("gloss_t", lambda m: m._row(ks_t=(0.4, 0.5, 0.6), roughness=0.1)),
    ("gloss_t_aniso", lambda m: m._row(ks_t=(0.4, 0.5, 0.6),
                                       roughness=0.3, vroughness=0.05)),
    ("spec_r_noop", lambda m: m._row(kr=(0.9, 0.8, 0.7))),
    ("spec_r_dielectric", lambda m: m._row(kr=(0.9, 0.8, 0.7), eta=1.33,
                                           spec_fresnel=m.FR_DIELECTRIC)),
    ("spec_r_conductor", lambda m: m._row(kr=(1, 1, 1),
                                          spec_fresnel=m.FR_CONDUCTOR)),
    ("spec_t", lambda m: m._row(kt=(0.9, 0.9, 0.9), eta=1.5)),
    ("matte", lambda m: m.matte(kd=(0.6, 0.5, 0.4), sigma=15.0)),
    ("plastic", lambda m: m.plastic()),
    ("mirror", lambda m: m.mirror()),
    ("glass", lambda m: m.glass(index=1.45)),
    ("metal", lambda m: m.metal(roughness=0.02)),
    ("shinymetal", lambda m: m.shinymetal(ks=(0.4, 0.3, 0.2))),
    ("substrate", lambda m: m.substrate()),
    ("substrate_aniso", lambda m: m.substrate(roughness=0.05,
                                              vroughness=0.25)),
    ("translucent", lambda m: m.translucent()),
    ("uber", lambda m: m.uber(kr=(0.2, 0.2, 0.2), kt=(0.3, 0.3, 0.3))),
    ("uber_opacity", lambda m: m.uber(opacity=(0.6, 0.5, 0.4))),
    ("mix", lambda m: m.mix_materials(m.plastic(), m.metal(),
                                      (0.3, 0.3, 0.3))),
    ("measured", lambda m: m.measured(merl_table(3), key="a")),
]
NAMES = [n for n, _ in ROWS]
FLAGS = {"all": bx.ALL, "no_specular": bx.ALL & ~bx.SPECULAR,
         "reflection": bx.ALL_REFLECTION}


def _unit(rng, n):
    v = rng.randn(n, 3)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(seed=0):
    n = LANES * len(ROWS)
    rng = np.random.RandomState(seed)
    ns = _unit(rng, n)
    ng = ns + 0.3 * _unit(rng, n)
    ng = (ng / np.linalg.norm(ng, axis=-1, keepdims=True)).astype(np.float32)
    return dict(ids=np.repeat(np.arange(len(ROWS)), LANES).astype(np.int32),
                ns=ns, ng=ng, dpdu=rng.randn(n, 3).astype(np.float32),
                wo=_unit(rng, n), wi=_unit(rng, n),
                u2=rng.rand(n, 2).astype(np.float32),
                uc=rng.rand(n).astype(np.float32))


def _port_side(table, x):
    table = st.to_device(table, "cpu")
    p = mat.eval_params(table, torch.from_numpy(x["ids"]))
    fr = bx.make_frame(th.t3(x["ns"]), th.t3(x["dpdu"]), th.t3(x["ng"]))
    return p, fr


def _ref_side(table, x):
    table = jax.tree_util.tree_map(jnp.asarray, table)
    p = ref_mat.eval_params(table, jnp.asarray(x["ids"]))
    fr = ref_bx.make_frame(th.j3(x["ns"]), th.j3(x["dpdu"]), th.j3(x["ng"]))
    return p, fr


def _eval(bmod, p, fr, wrap, x, flags):
    wo, wi = wrap(x["wo"]), wrap(x["wi"])
    s = bmod.sample_f(p, fr, wo,
                      (torch.from_numpy if bmod is bx else jnp.asarray)(
                          x["u2"]),
                      (torch.from_numpy if bmod is bx else jnp.asarray)(
                          x["uc"]), flags)
    return {"f": th.n3(bmod.f(p, fr, wo, wi, flags)),
            "pdf": np.asarray(bmod.pdf(p, fr, wo, wi, flags)),
            "s_wi": th.n3(s.wi), "s_f": th.n3(s.f),
            "s_pdf": np.asarray(s.pdf), "s_flags": np.asarray(s.flags),
            "s_valid": np.asarray(s.valid)}


@pytest.fixture(scope="module")
def stack():
    """Both packages' f / pdf / sample_f for every flag mask."""
    x = _inputs()
    p_t, fr_t = _port_side(mat.build_table([r(mat) for _, r in ROWS]), x)
    p_r, fr_r = _ref_side(ref_mat.build_table([r(ref_mat) for _, r in ROWS]),
                          x)
    out = {}
    for fname, flags in FLAGS.items():
        port = _eval(bx, p_t, fr_t, th.t3, x, flags)
        ref = _eval(ref_bx, p_r, fr_r, th.j3, x, flags)
        wo, wi = th.j3(x["wo"]), th.j3(port["s_wi"])
        ref["f_at_s_wi"] = th.n3(ref_bx.f(p_r, fr_r, wo, wi, flags))
        ref["pdf_at_s_wi"] = np.asarray(ref_bx.pdf(p_r, fr_r, wo, wi, flags))
        out[fname] = (port, ref)
    return x, out


def close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    tol = ATOL_OF_MAX * max(np.abs(b).max(), 1e-30) + RTOL * np.abs(b)
    bad = np.abs(a - b) > tol
    assert not bad.any(), (bad.sum(), np.abs(a - b).max())


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("row", NAMES)
def test_f_pdf_and_sample_f_match_the_reference(stack, row, flags):
    x, out = stack
    lanes = x["ids"] == NAMES.index(row)
    port, ref = out[flags]
    close(port["f"][lanes], ref["f"][lanes])
    close(port["pdf"][lanes], ref["pdf"][lanes])
    spec = lanes & ((ref["s_flags"] & bx.SPECULAR) != 0)
    glossy = lanes & ~spec
    for k in ("s_f", "s_pdf"):
        for m, want in ((spec, ref[k]), (glossy, ref[k[2:] + "_at_s_wi"])):
            if m.any():
                close(port[k][m], want[m])
    assert np.array_equal(port["s_flags"][lanes], ref["s_flags"][lanes])
    assert np.array_equal(port["s_valid"][lanes], ref["s_valid"][lanes])
    np.testing.assert_allclose(port["s_wi"][lanes], ref["s_wi"][lanes],
                               rtol=0, atol=DIR_ATOL)
    # the case is not empty: under ALL its lanes sample the stack
    assert flags != "all" or ref["s_valid"][lanes].any()


def test_every_slot_is_chosen_and_both_sides_are_seen(stack):
    """The inputs reach every slot and both sides of the surface."""
    x, out = stack
    port, _ = out["all"]
    assert set(np.unique(port["s_flags"][port["s_valid"]])) == set(
        bx.SLOT_FLAGS)
    cos_o = np.sum(x["wo"] * x["ns"], -1)
    assert (cos_o > 0).any() and (cos_o < 0).any()


def _substrate_case(mod, bmod, wrap, x):
    table = mod.build_table([mod.substrate(kd=(0.5, 0.3, 0.2),
                                           ks=(0.2, 0.2, 0.2))])
    n = x["wo"].shape[0]
    if bmod is bx:
        table = st.to_device(table, "cpu")
        p = mod.eval_params(table, torch.zeros(n, dtype=torch.int32))
        fr = bx.make_frame(th.t3(x["ns"]), th.t3(x["dpdu"]), th.t3(x["ng"]))
    else:
        table = jax.tree_util.tree_map(jnp.asarray, table)
        p = mod.eval_params(table, jnp.zeros(n, jnp.int32))
        fr = ref_bx.make_frame(th.j3(x["ns"]), th.j3(x["dpdu"]),
                               th.j3(x["ng"]))
    wo, wi = wrap(x["wo"]), wrap(x["wi"])
    lo, li = fr.to_local(wo), fr.to_local(wi)
    f = th.n3(bmod.f(p, fr, wo, wi))
    blend = th.n3(bmod._gloss_f(p, p.ks, lo, li))
    lambert = np.stack([np.asarray(c) for c in p.kd], -1) / np.pi
    refl = ((np.sum(x["wi"] * x["ng"], -1) * np.sum(x["wo"] * x["ng"], -1)
             > 0) & (np.asarray(lo.z) * np.asarray(li.z) > 0))
    return f, lambert, blend, refl


def test_substrate_counts_its_diffuse_twice():
    """Known behaviour i: a substrate row activates the DIFF_R slot with
    its kd, and FR_BLEND's glossy lobe adds the Ashikhmin-Shirley diffuse
    term again, in both packages: f = Lambert(kd) + the blend."""
    x = _inputs(seed=5)
    for mod, bmod, wrap in ((mat, bx, th.t3), (ref_mat, ref_bx, th.j3)):
        f, lambert, blend, refl = _substrate_case(mod, bmod, wrap, x)
        assert refl.sum() > 1000
        close(f[refl], (lambert + blend)[refl])
        assert (blend[refl] > 0).all()


def test_slot_counts_and_zero_params():
    x = _inputs(seed=2)
    p_t, _ = _port_side(mat.build_table([r(mat) for _, r in ROWS]), x)
    p_r, _ = _ref_side(ref_mat.build_table([r(ref_mat) for _, r in ROWS]),
                       x)
    for flags in FLAGS.values():
        assert np.array_equal(bx.slot_count(p_t, flags).numpy(),
                              np.asarray(ref_bx.slot_count(p_r, flags)))
    assert np.array_equal(bx.n_specular_components(p_t).numpy(),
                          np.asarray(ref_bx.n_specular_components(p_r)))
    zt, zr = bx.zero_params(7), ref_bx.zero_params(7)
    for a, b in zip(zt, zr):
        if a is None:
            assert b is None
        elif isinstance(a, vm.V3):
            assert np.array_equal(th.n3(a), th.n3(b))
        else:
            assert a.dtype == torch.float32 or a.dtype == torch.int32
            assert np.array_equal(a.numpy(), np.asarray(b))


def test_fresnel_terms_match():
    rng = np.random.RandomState(9)
    c = (rng.rand(LANES).astype(np.float32) * 2 - 1)
    eta = (1.0 + rng.rand(LANES)).astype(np.float32)
    e3, k3 = rng.rand(LANES, 3) * 2, rng.rand(LANES, 3) * 4
    close(bx.fr_dielectric(torch.from_numpy(c), torch.from_numpy(eta)),
          ref_bx.fr_dielectric(jnp.asarray(c), jnp.asarray(eta)))
    close(th.n3(bx.fr_conductor(torch.from_numpy(c), th.t3(e3), th.t3(k3))),
          th.n3(ref_bx.fr_conductor(jnp.asarray(c), th.j3(e3), th.j3(k3))))
    close(th.n3(bx.schlick(torch.from_numpy(c), th.t3(e3 / 2))),
          th.n3(ref_bx.schlick(jnp.asarray(c), th.j3(e3 / 2))))


@pytest.mark.parametrize("ex,ey", [(40.0, 40.0), (5.0, 300.0), (1e4, 20.0)])
def test_aniso_distribution_sample_and_pdf(ex, ey):
    """Ashikhmin-Shirley D, half-vector sampling (u1 up to 1 - 1e-7) and
    pdf; ex == ey is Blinn."""
    rng = np.random.RandomState(int(ex + ey))
    u = rng.rand(LANES, 2).astype(np.float32)
    u[:8, 0] = 1.0 - 1e-7 * np.arange(8)
    wo, wi = _unit(rng, LANES), _unit(rng, LANES)
    a = (torch.full((LANES,), ex), torch.full((LANES,), ey))
    b = (jnp.full((LANES,), ex, jnp.float32), jnp.full((LANES,), ey,
                                                       jnp.float32))
    np.testing.assert_allclose(
        th.n3(bx._aniso_sample_wh(*a, vm.V2(*torch.from_numpy(u).T))),
        th.n3(ref_bx._aniso_sample_wh(*b, ref_vm.V2(*jnp.asarray(u).T))),
        rtol=0, atol=DIR_ATOL)
    close(bx._aniso_pdf(*a, th.t3(wo), th.t3(wi)),
          ref_bx._aniso_pdf(*b, th.j3(wo), th.j3(wi)))
    wh = wo + wi
    wh = wh / np.linalg.norm(wh, axis=-1, keepdims=True)
    close(bx._aniso_d(*a, th.t3(wh)), ref_bx._aniso_d(*b, th.j3(wh)))
    close(bx._ts_g(th.t3(wo), th.t3(wi), th.t3(wh)),
          ref_bx._ts_g(th.j3(wo), th.j3(wi), th.j3(wh)))


# --- measured BRDFs ---------------------------------------------------------

def synth_merl_bytes(seed, dims=(4, 6, 8)):
    """A MERL file with seeded values (the layout of
    tests/test_measured.py:16-25: three int32 dims, then the doubles channel
    by channel)."""
    n = int(np.prod(dims))
    buf = io.BytesIO()
    buf.write(struct.pack("<3i", *dims))
    vals = np.random.RandomState(seed).rand(3, n) - 0.05   # some negative
    for c in range(3):
        buf.write((vals[c] / merl.MERL_SCALES[c]).astype("<f8").tobytes())
    return buf.getvalue()


def brdf_text(seed, n=120):
    rng = np.random.RandomState(seed)
    lines = ["# irregular samples", "4 420 520 620 680"]
    for _ in range(n):
        ti, to = rng.uniform(0, np.pi / 2, 2)
        pi_, po = rng.uniform(0, 2 * np.pi, 2)
        vals = rng.rand(4)
        lines.append(" ".join(f"{v:.6f}" for v in (ti, pi_, to, po, *vals)))
    return "\n".join(lines)


def test_merl_readers_match():
    data = synth_merl_bytes(1)
    a = merl.read_merl(data)
    assert th.same_bits(a, ref_merl.read_merl(data))
    assert a.shape == (4, 6, 8, 3) and a.min() == 0.0
    assert th.same_bits(merl.load(data, "x.merl"),
                        ref_merl.load(data, "x.merl"))
    with pytest.raises(ValueError):
        merl.read_merl(data[:100])
    text = brdf_text(2)
    b = merl.read_brdf_text(text, grid=(6, 4, 8))
    assert th.same_bits(b, ref_merl.read_brdf_text(text, grid=(6, 4, 8)))
    assert th.same_bits(merl.load(text.encode(), "y.brdf"),
                        ref_merl.load(text.encode(), "y.brdf"))
    wo, wi = _unit(np.random.RandomState(3), 64), _unit(
        np.random.RandomState(4), 64)
    assert th.same_bits(merl.brdf_remap(wo, wi), ref_merl.brdf_remap(wo, wi))


def test_measured_f_matches_and_reads_the_pool():
    """Two tables in one pool (a shared key deduplicated), 512 lanes over
    both sides: the gathered values equal the reference's."""
    rows = lambda m: [m.matte(), m.measured(merl_table(5), key="a"),
                      m.measured(merl_table(6, (8, 4, 16)), key="b"),
                      m.measured(merl_table(5), key="a")]
    t_t, t_r = mat.build_table(rows(mat)), ref_mat.build_table(rows(ref_mat))
    assert th.same_bits(t_t.meas_meta, t_r.meas_meta)
    assert th.same_bits(t_t.meas_pool, t_r.meas_pool)
    assert t_t.meas_pool.shape[0] == 4 * 4 * 8 + 8 * 4 * 16
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 4, LANES).astype(np.int32)
    wo, wi = _unit(rng, LANES), _unit(rng, LANES)
    p_t = mat.eval_params(st.to_device(t_t, "cpu"), torch.from_numpy(ids))
    p_r = ref_mat.eval_params(jax.tree_util.tree_map(jnp.asarray, t_r),
                              jnp.asarray(ids))
    a = th.n3(bx.measured_f(p_t.meas, th.t3(wo), th.t3(wi)))
    b = th.n3(ref_bx.measured_f(p_r.meas, th.j3(wo), th.j3(wi)))
    close(a, b)
    assert (a[ids > 0] > 0).mean() > 0.9 and not a[ids == 0].any()
