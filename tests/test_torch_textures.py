"""PyTorch port, the texture system (``textures.py``) and bump mapping
(``materials.bump_shading_normal``) against the JAX reference on the same
seeded inputs.

The mip pyramid is numpy in both packages and is held bit for bit. One
texture table holds every leaf kind, each 2D mapping and the 3D transform,
another every combinator over leaves without noise; ``evaluate`` runs in
each package (the reference eagerly: 30 ms a Perlin call) over at least 512
lanes a texture: the leaves with both footprint axes (``tex_duv``: the
anisotropic lookup), the combinators also without ray differentials and with
the isotropic footprint (``tex_width``: the trilinear lookup). Every
(texture, footprint) case is held on its own lanes within 1e-5 + rtol
1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dartray_tpu import materials as ref_mat
from dartray_tpu import textures as ref_tex
from dartray_tpu.core import math as ref_vm

from dartray_tpu_torch import materials as mat
from dartray_tpu_torch import textures as tex
from dartray_tpu_torch.core import math as vm
from dartray_tpu_torch.scene import types as st

import torchhelp as th

torch.set_num_threads(1)

# every reference call of the file runs at one lane count (eager JAX
# compiles each primitive once per shape): at least 512 lanes a texture
N = 512 * 13
ATOL = 1e-5
RTOL = 1e-4


def _image(seed, h, w):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def _w2t(seed):
    rng = np.random.RandomState(seed)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] += 0.4 * rng.randn(3, 3).astype(np.float32)
    m[:3, 3] = rng.randn(3).astype(np.float32)
    return m


def _planar():
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = (1.5, 0.0, 0.5)
    m[1, :3] = (0.0, 2.0, -0.3)
    return m


# (name, add(builder, mod)): a table, one row per case, in this order.
# The leaves: every leaf kind, each 2D mapping and the 3D transform
LEAVES = [
    ("const", lambda b, m: b.add(m.CONST, (0.2, 0.5, 0.8))),
    ("imagemap_uv", lambda b, m: b.add(
        m.IMAGEMAP, (1.5, 1.5, 1.5), params=(2, 3, 0.1, 0.2),
        image=_image(1, 5, 7))),
    ("imagemap_planar", lambda b, m: b.add(
        m.IMAGEMAP, (1, 1, 1), params=(1, 1, 0.3, -0.1),
        image=_image(2, 16, 8), world2tex=_planar(), mapping=m.MAP_PLANAR)),
    ("imagemap_spherical", lambda b, m: b.add(
        m.IMAGEMAP, (0.8, 0.8, 0.8), image=_image(3, 12, 20),
        world2tex=_w2t(4), mapping=m.MAP_SPHERICAL)),
    ("uv_cylindrical", lambda b, m: b.add(
        m.UV, world2tex=_w2t(5), mapping=m.MAP_CYLINDRICAL)),
    ("fbm", lambda b, m: b.add(m.FBM, (1, 0.5, 0.25), world2tex=_w2t(6))),
    ("wrinkled", lambda b, m: b.add(m.WRINKLED, (1, 1, 1),
                                    world2tex=_w2t(7))),
    ("marble", lambda b, m: b.add(m.MARBLE, (1, 1, 1),
                                  params=(1, 1, 0, 0, 8, 0.5, 3.0, 0.4))),
    ("windy", lambda b, m: b.add(m.WINDY, (1, 1, 1), world2tex=_w2t(8))),
]
# the combinators over leaves without noise (a combinator evaluates every
# leaf family of the table twice more; scale and checkerboard over noise
# are in scenes/materials.pbrt, held by tests/test_torch_materials.py)
COMBINATORS = LEAVES[:5] + [
    ("scale", lambda b, m: b.add(m.SCALE, sub=(1, 0))),
    ("mix", lambda b, m: b.add(m.MIX, params=(1, 1, 0, 0, 0.3),
                               sub=(0, 1))),
    ("checker2d", lambda b, m: b.add(m.CHECKER2D, params=(4, 4, 0.1, 0),
                                     sub=(0, 2))),
    ("checker3d", lambda b, m: b.add(m.CHECKER3D, sub=(0, 3),
                                     world2tex=np.diag([3, 3, 3, 1]))),
    ("dots", lambda b, m: b.add(m.DOTS, params=(5, 5, 0, 0), sub=(0, 2))),
    ("bilerp", lambda b, m: b.add(m.BILERP, (0.1, 0.2, 0.3),
                                  params=(1, 1, 0, 0, 0.9, 0.8, 0.7, 0.5),
                                  sub=(11, -1))),
    ("bilerp_corner", lambda b, m: b.add(m.CONST, (0.9, 0.1, 0.4))),
]
TABLES = {"leaves": LEAVES, "combinators": COMBINATORS}
FOOTPRINTS = ("none", "width", "duv")


def _table(mod, rows):
    b = mod.TextureBuilder()
    for i, (_, add) in enumerate(rows):
        assert add(b, mod) == i
    return b.build()


def _interaction(seed, n, footprint):
    rng = np.random.RandomState(seed)
    x = dict(uv=(rng.rand(n, 2) * 5 - 2).astype(np.float32),
             p=(rng.rand(n, 3) * 4 - 2).astype(np.float32),
             ns=rng.randn(n, 3).astype(np.float32),
             dpdu=rng.randn(n, 3).astype(np.float32),
             dpdv=rng.randn(n, 3).astype(np.float32))
    x["ns"] /= np.linalg.norm(x["ns"], axis=-1, keepdims=True)
    if footprint == "width":
        x["tex_width"] = (rng.rand(n) ** 3 * 0.5).astype(np.float32)
    if footprint == "duv":
        x["tex_duv"] = tuple((rng.randn(n) * 0.05).astype(np.float32)
                             for _ in range(4))
        x["tex_width"] = np.max(np.abs(np.stack(x["tex_duv"])), 0)
    return x


def port_it(x):
    t = torch.from_numpy
    it = {"uv": vm.V2(t(x["uv"][:, 0].copy()), t(x["uv"][:, 1].copy())),
          "p": th.t3(x["p"]), "ns": th.t3(x["ns"]),
          "dpdu": th.t3(x["dpdu"]), "dpdv": th.t3(x["dpdv"])}
    if "tex_width" in x:
        it["tex_width"] = t(x["tex_width"])
    if "tex_duv" in x:
        it["tex_duv"] = tuple(t(a) for a in x["tex_duv"])
    return it


def ref_it(x):
    j = jnp.asarray
    it = {"uv": ref_vm.V2(j(x["uv"][:, 0]), j(x["uv"][:, 1])),
          "p": th.j3(x["p"]), "ns": th.j3(x["ns"]),
          "dpdu": th.j3(x["dpdu"]), "dpdv": th.j3(x["dpdv"])}
    if "tex_width" in x:
        it["tex_width"] = j(x["tex_width"])
    if "tex_duv" in x:
        it["tex_duv"] = tuple(j(a) for a in x["tex_duv"])
    return it


def ref_device(table):
    return jax.tree_util.tree_map(jnp.asarray, table)


def close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def tables():
    """{name: (port host table, port CPU table, reference table)}."""
    out = {}
    for name, rows in TABLES.items():
        port = _table(tex, rows)
        out[name] = (port, st.to_device(port, "cpu"),
                     ref_device(_table(ref_tex, rows)))
    return out


def _ids(rows):
    return (np.arange(N) % len(rows)).astype(np.int32)


@pytest.fixture(scope="module")
def evaluated(tables):
    """{(table, footprint): (port V3 as numpy, reference's)}: the leaves
    with both footprint axes, the combinators with each footprint."""
    out = {}
    for name, fp in [("leaves", "duv")] + [("combinators", f)
                                          for f in FOOTPRINTS]:
        _, port, ref = tables[name]
        ids, x = _ids(TABLES[name]), _interaction(len(out), N, fp)
        out[name, fp] = (
            th.n3(tex.evaluate(port, torch.from_numpy(ids), port_it(x))),
            th.n3(ref_tex.evaluate(ref, jnp.asarray(ids), ref_it(x))))
    return out


@pytest.mark.parametrize("shape", [(5, 7), (8, 8), (1, 6), (20, 24),
                                   (3, 1)])
def test_build_pyramid_is_the_references(shape):
    img = _image(sum(shape), *shape)
    a, b = tex.build_pyramid(img), ref_tex.build_pyramid(img)
    assert len(a) == len(b) > 1
    for la, lb in zip(a, b):
        assert th.same_bits(la, lb)


@pytest.mark.parametrize("table", sorted(TABLES))
def test_table_is_the_references(tables, table):
    """Every leaf of the host table; the texel pool is float32 on both
    sides, as the reference's device copy holds it."""
    port = tables[table][0]
    ref = _table(ref_tex, TABLES[table])
    for f in ("kind", "value", "params", "sub", "img_meta", "mip_off",
              "world2tex"):
        assert th.same_bits(getattr(port, f), getattr(ref, f)), f
    assert th.same_bits(port.texels, np.asarray(ref.texels, np.float32))
    assert (port.n, port.kinds_present, port.has_mapping) == (
        ref.n, ref.kinds_present, ref.has_mapping)


def test_the_tables_hold_every_kind(tables):
    kinds = {k for t in tables.values() for k in t[0].kinds_present}
    assert kinds == set(range(13))


CASES = ([("leaves", n, "duv") for n, _ in LEAVES]
         + [("combinators", n, fp) for fp in FOOTPRINTS
            for n, _ in COMBINATORS])


@pytest.mark.parametrize("table,name,footprint", CASES)
def test_evaluate_matches_the_reference(evaluated, table, name, footprint):
    port, ref = evaluated[table, footprint]
    names = [n for n, _ in TABLES[table]]
    lanes = _ids(TABLES[table]) == names.index(name)
    close(port[lanes], ref[lanes])
    # the case is not constant unless it is a constant
    assert name in ("const", "bilerp_corner") or np.ptp(ref[lanes]) > 0


def test_footprints_reach_coarser_mip_levels(tables):
    """The filtered lookups differ from the finest level's at the same
    points."""
    port = tables["leaves"][1]
    ids = torch.ones(N, dtype=torch.int32)      # imagemap_uv
    it = port_it(_interaction(0, N, "duv"))
    plain = {k: v for k, v in it.items() if not k.startswith("tex_")}
    finest = th.n3(tex.evaluate(port, ids, plain))
    width = th.n3(tex.evaluate(port, ids, {**plain,
                                           "tex_width": it["tex_width"]}))
    aniso = th.n3(tex.evaluate(port, ids, it))
    for img in (width, aniso):
        assert np.abs(img - finest).max() > 1e-2


def test_noise_functions_match():
    rng = np.random.RandomState(3)
    p = (rng.randn(N, 3) * 4).astype(np.float32)
    close(tex.perlin(th.t3(p)), ref_tex.perlin(th.j3(p)))
    close(tex.fbm(th.t3(p), 5, 0.6), ref_tex.fbm(th.j3(p), 5, 0.6))
    close(tex.turbulence(th.t3(p), 3, 0.5),
          ref_tex.turbulence(th.j3(p), 3, 0.5))


def test_eval_or_falls_back_where_the_id_is_negative(tables):
    _, port, ref = tables["combinators"]
    rng = np.random.RandomState(4)
    ids = rng.randint(-1, len(COMBINATORS), N).astype(np.int32)
    x = _interaction(9, N, "width")
    fb = rng.rand(N, 3).astype(np.float32)
    a = tex.eval_or(port, torch.from_numpy(ids), port_it(x), th.t3(fb))
    b = ref_tex.eval_or(ref, jnp.asarray(ids), ref_it(x), th.j3(fb))
    close(th.n3(a), th.n3(b))
    assert np.array_equal(th.n3(a)[ids < 0], fb[ids < 0])
    a = tex.eval_or_scalar(port, torch.from_numpy(ids), port_it(x),
                           torch.from_numpy(fb[:, 0].copy()))
    b = ref_tex.eval_or_scalar(ref, jnp.asarray(ids), ref_it(x),
                               jnp.asarray(fb[:, 0]))
    close(a, b)
    assert tex.eval_or(None, None, None, "x") == "x"


def _bump_table(mod, tmod):
    b = tmod.TextureBuilder()
    grain = b.add(tmod.IMAGEMAP, (1, 1, 1), image=_image(7, 16, 16),
                  world2tex=_planar(), mapping=tmod.MAP_PLANAR)
    depth = b.add(tmod.CONST, (0.05, 0.05, 0.05))
    bumps = b.add(tmod.SCALE, sub=(grain, depth))
    waves = b.add(tmod.IMAGEMAP, (0.2, 0.2, 0.2), image=_image(6, 8, 8))
    rows = [mod.plastic(), mod.matte(tex_ids={mod.TEX_BUMP: bumps}),
            mod.metal(tex_ids={mod.TEX_BUMP: waves})]
    return mod.build_table(rows), b.build()


@pytest.mark.parametrize("footprint", ["none", "width"])
def test_bump_shading_normal_matches(footprint):
    """Bump maps over a combinator of a planar image map, and over an
    image map (the renders hold fbm bumps); lanes without a bump texture
    keep their normal."""
    m_t, t_t = _bump_table(mat, tex)
    m_r, t_r = _bump_table(ref_mat, ref_tex)
    x = _interaction(11, N, footprint)
    ids = np.random.RandomState(12).randint(0, 3, N).astype(np.int32)
    a = th.n3(mat.bump_shading_normal(
        st.to_device(m_t, "cpu"), torch.from_numpy(ids),
        st.to_device(t_t, "cpu"), port_it(x)))
    b = th.n3(ref_mat.bump_shading_normal(
        ref_device(m_r), jnp.asarray(ids), ref_device(t_r), ref_it(x)))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert np.array_equal(a[ids == 0], x["ns"][ids == 0])
    moved = np.abs(a - x["ns"]).max(-1)
    assert (moved[ids > 0] > 1e-3).mean() > 0.5
    # no bump slot in the table: the normal comes back as it is
    plain = mat.build_table([mat.plastic()])
    it = port_it(x)
    assert mat.bump_shading_normal(plain, torch.from_numpy(ids), t_t,
                                   it) is it["ns"]


def test_textured_eval_params_matches():
    """Every texture slot of eval_params, a textured roughness on an
    isotropic and an anisotropic row."""
    def build(mod, tmod):
        b = tmod.TextureBuilder()
        c = b.add(tmod.CHECKER2D, params=(3, 3, 0, 0),
                  sub=(b.add(tmod.CONST, (0.9, 0.2, 0.1)),
                       b.add(tmod.CONST, (0.1, 0.3, 0.8))))
        r = b.add(tmod.UV)
        s = b.add(tmod.IMAGEMAP, (20, 20, 20), image=_image(8, 4, 4))
        slots = {mod.TEX_KD: c, mod.TEX_KS: c, mod.TEX_KR: c, mod.TEX_KT: c,
                 mod.TEX_SIGMA: s, mod.TEX_ROUGH: r}
        rows = [mod.uber(kr=(0.2,) * 3, kt=(0.1,) * 3, tex_ids=slots),
                mod.substrate(roughness=0.1, vroughness=0.3,
                              tex_ids={mod.TEX_ROUGH: r}),
                mod.plastic()]
        return mod.build_table(rows), b.build()
    m_t, t_t = build(mat, tex)
    m_r, t_r = build(ref_mat, ref_tex)
    x = _interaction(13, N, "width")
    ids = np.random.RandomState(14).randint(0, 3, N).astype(np.int32)
    a = mat.eval_params(st.to_device(m_t, "cpu"), torch.from_numpy(ids),
                        st.to_device(t_t, "cpu"), port_it(x))
    b = ref_mat.eval_params(ref_device(m_r), jnp.asarray(ids),
                            ref_device(t_r), ref_it(x))
    for f in ("kd", "ks", "kr", "kt", "sigma", "exponent", "exponent_v"):
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, vm.V3):
            va, vb = th.n3(va), th.n3(vb)
        close(va, vb)
    ev = a.exponent_v.numpy()
    assert (ev[ids == 1] == np.float32(1 / 0.3)).all()       # anisotropic
    assert np.array_equal(ev[ids == 0], a.exponent.numpy()[ids == 0])
