"""PyTorch port, the samplers: every kind's sample values against the JAX
reference's on the same seeded pixels and sample indices, BIT FOR BIT.

Every kind (lowdiscrepancy, stratified with and without jitter, random,
halton, bestcandidate) at spp 1, 5, 16, 33, 64 and 4096 over dims 0-9 of
512 pixels, ``sample_2d`` and ``sample_1d``; the kinds the port's hashing
kernel draws (``csrc/sample_hash.cu``, which tests hold against the port's
plain draws) also on the inputs that kernel sees: seeds 0, 3 and one past
2**31, dims 0-40, negative pixels (a padded band's), sample indices past
spp, stratified 3x5 (its permutation's cycle walk) and camera samples; the
AO integrator's scramble pair and probes; the best-candidate tile for
seeds 0 and 3; the radical inverse over every prime base; the vector
sampler; camera samples. The reference's Halton draws run jitted (one compile for the ten
dimensions of a sampler): its radical inverse is a ``fori_loop`` whose
multiply-add XLA fuses, as it does in a real render.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartray_tpu import samplers as ref_smp
from dartray_tpu.core import sampling as ref_sampling

from dartray_tpu_torch import samplers as smp
from dartray_tpu_torch.core import sampling
from dartray_tpu_torch.integrators import ao

import torchhelp as th

torch.set_num_threads(1)

N = 512
DIMS = range(10)
KINDS = ("lowdiscrepancy", "stratified", "stratified_nojitter", "random",
         "halton", "bestcandidate")


def _pixels(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 700, N).astype(np.int32),
            rng.randint(0, 500, N).astype(np.int32))


def _draws(mod, sampler, px, py, s, dims=DIMS):
    """{dim: (x, y, u)} of `mod`'s sample_2d / sample_1d over `dims`."""
    return [(*mod.sample_2d(sampler, px, py, s, d),
             mod.sample_1d(sampler, px, py, s, d)) for d in dims]


def _wide_lanes(seed, spp):
    """Pixels of a 4000x2200 film and a few past its edges (negative too),
    sample indices up to twice spp."""
    rng = np.random.RandomState(seed)
    return (rng.randint(-3, 4000, N).astype(np.int32),
            rng.randint(-1, 2200, N).astype(np.int32),
            rng.randint(0, 2 * spp + 3, N).astype(np.int32))


@pytest.mark.parametrize("spp", [1, 5, 16, 33, 64, 4096])
@pytest.mark.parametrize("kind", KINDS)
def test_samples_equal_the_references_bit_for_bit(kind, spp):
    name, jitter = kind.split("_")[0], not kind.endswith("nojitter")
    ref = ref_smp.make_sampler(name, spp, seed=3, jitter=jitter)
    port = smp.make_sampler(name, spp, seed=3, jitter=jitter)
    assert (port.kind, port.spp, port.nx, port.ny, port.jitter) == (
        ref.kind, ref.spp, ref.nx, ref.ny, ref.jitter)
    px, py = _pixels(spp)
    s = np.random.RandomState(100 + spp).randint(
        0, port.spp, N).astype(np.int32)
    s[:2] = (0, port.spp - 1)
    draw = lambda a, b, c: _draws(ref_smp, ref, a, b, c)
    if name == "halton":
        draw = jax.jit(draw)
    want = draw(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))
    got = _draws(smp, port, torch.from_numpy(px), torch.from_numpy(py),
                 torch.from_numpy(s))
    for d, (g, w) in enumerate(zip(got, want)):
        for gc, wc in zip(g, w):
            assert th.same_bits(gc.numpy(), np.asarray(wc)), (kind, spp, d)
            assert ((gc >= 0) & (gc < 1)).all()


# the kinds the hashing kernel draws, as (name, make_sampler's kind, spp,
# jitter); "stratified3x5" is built by hand: make_sampler makes 4x4 of 15
KERNEL_KINDS = [("lowdiscrepancy", "lowdiscrepancy", 64, True),
                ("stratified", "stratified", 64, True),
                ("stratified_nojitter", "stratified", 64, False),
                ("stratified3x5", None, 15, True),
                ("bestcandidate", "bestcandidate", 64, True)]


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 12345])
@pytest.mark.parametrize("name,kind,spp,jitter", KERNEL_KINDS,
                         ids=[k[0] for k in KERNEL_KINDS])
def test_kernel_kinds_equal_the_references_on_wide_inputs(name, kind, spp,
                                                          jitter, seed):
    """The inputs of a 4K wave and beyond: dims 0-40, negative pixels,
    sample indices past spp, a seed past 2**31; and the camera samples."""
    if kind is None:
        ref = ref_smp.Sampler(ref_smp.STRATIFIED, spp, jnp.uint32(seed), 3,
                              5, jitter)
        port = smp.Sampler(smp.STRATIFIED, spp, seed, 3, 5, jitter)
    else:
        ref = ref_smp.make_sampler(kind, spp, seed=seed, jitter=jitter)
        port = smp.make_sampler(kind, spp, seed=seed, jitter=jitter)
    px, py, s = _wide_lanes(seed % 1000, spp)
    dims = range(41)
    want = _draws(ref_smp, ref, jnp.asarray(px), jnp.asarray(py),
                  jnp.asarray(s), dims)
    got = _draws(smp, port, torch.from_numpy(px), torch.from_numpy(py),
                 torch.from_numpy(s), dims)
    for d, (g, w) in enumerate(zip(got, want)):
        for gc, wc in zip(g, w):
            assert th.same_bits(gc.numpy(), np.asarray(wc)), (name, seed, d)
    cw = ref_smp.camera_samples(ref, jnp.asarray(px), jnp.asarray(py),
                                jnp.asarray(s))
    cg = smp.camera_samples(port, torch.from_numpy(px), torch.from_numpy(py),
                            torch.from_numpy(s))
    for g, w in ((cg.image_xy.x, cw.image_xy.x), (cg.image_xy.y, cw.image_xy.y),
                 (cg.lens_uv.x, cw.lens_uv.x), (cg.lens_uv.y, cw.lens_uv.y),
                 (cg.time_u, cw.time_u)):
        assert th.same_bits(g.numpy(), np.asarray(w)), (name, seed)


@pytest.mark.parametrize("n_samples", [4, 64, 2048])
def test_ao_draws_equal_the_reference_integrators(n_samples):
    """The AO integrator's scramble pair of a (pixel, camera sample) and its
    probes' (0,2)-sequence samples: the reference's li computes them inline
    (``dartray_tpu/integrators/ao.py``: the pair from its pixel and sample
    index, ``sample02`` of each probe index at 32 bits), computed here with
    its own primitives, against the port's ``scrambles_plain`` and
    ``probe`` (which truncates the probe index to n_bits)."""
    U32 = jnp.uint32
    px, py, s = _wide_lanes(n_samples, 64)
    base = ref_sampling.hash_u32(
        jnp.asarray(px).astype(U32) ^ (jnp.asarray(py).astype(U32) << 16)
        ^ ref_sampling.hash_u32(jnp.asarray(s).astype(U32)))
    scr = (ref_sampling.hash_u32(base ^ U32(0x1234567)),
           ref_sampling.hash_u32(base ^ U32(0x89abcdef)))
    got = ao.scrambles(torch.from_numpy(px), torch.from_numpy(py),
                       torch.from_numpy(s))
    for g, w in zip(got, scr):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    n_bits = max(int(n_samples - 1).bit_length(), 1)
    for i in sorted({0, 1, n_samples // 2 + 1, n_samples - 1}):
        w = ref_sampling.sample02(jnp.full((N,), i, U32), scr)
        g = ao.probe(got, i, n_bits)
        assert th.same_bits(g.x.numpy(), np.asarray(w.x)), (n_samples, i)
        assert th.same_bits(g.y.numpy(), np.asarray(w.y)), (n_samples, i)


@pytest.mark.parametrize("seed", [0, 3])
def test_best_candidate_tile_is_the_references(seed):
    got = smp._bc_tile(seed)
    assert th.same_bits(got, ref_smp._bc_tile(seed))
    assert got.shape == (smp.BC_TILE, smp.BC_TILE, smp.BC_SMAX, 2)
    assert (got >= 0).all() and (got < 1).all()


def test_radical_inverse_is_the_fused_references_over_every_base():
    """Every base the Halton sampler uses (dims 0-39) on indices up to
    2**24 + spp, held against the reference's compiled loop."""
    n = np.random.RandomState(2).randint(0, (1 << 24) + 64, 4096).astype(
        np.uint32)
    n[:3] = (0, 1, (1 << 24) + 63)
    bases = [int(b) for b in sampling._PRIMES[:40]]
    want = jax.jit(lambda x: [ref_sampling.radical_inverse(x, b)
                              for b in bases])(jnp.asarray(n))
    t = torch.from_numpy(n.astype(np.int64))
    for b, w in zip(bases, want):
        assert th.same_bits(sampling.radical_inverse(t, b).numpy(),
                            np.asarray(w)), b


def test_vector_sampler_reads_its_vector():
    u = np.random.RandomState(4).rand(N, 7).astype(np.float32)
    ref = ref_smp.vector_sampler(jnp.asarray(u))
    port = smp.vector_sampler(torch.from_numpy(u))
    px, py = _pixels(1)
    s = np.zeros(N, np.int32)
    want = _draws(ref_smp, ref, jnp.asarray(px), jnp.asarray(py),
                  jnp.asarray(s))
    got = _draws(smp, port, torch.from_numpy(px), torch.from_numpy(py),
                 torch.from_numpy(s))
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            assert th.same_bits(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("kind", ["stratified", "halton", "bestcandidate"])
def test_camera_samples_equal(kind):
    ref = ref_smp.make_sampler(kind, 4, seed=0)
    port = smp.make_sampler(kind, 4, seed=0)
    px, py = _pixels(9)
    s = np.arange(N, dtype=np.int32) % port.spp
    fn = ref_smp.camera_samples
    if kind == "halton":
        fn = jax.jit(fn, static_argnums=())
    want = fn(ref, jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))
    got = smp.camera_samples(port, torch.from_numpy(px), torch.from_numpy(py),
                             torch.from_numpy(s))
    for g, w in ((got.image_xy.x, want.image_xy.x),
                 (got.image_xy.y, want.image_xy.y),
                 (got.lens_uv.x, want.lens_uv.x),
                 (got.lens_uv.y, want.lens_uv.y),
                 (got.time_u, want.time_u)):
        assert th.same_bits(g.numpy(), np.asarray(w))


def test_unknown_sampler_kind_raises():
    with pytest.raises(ValueError, match="unknown sampler"):
        smp.make_sampler("sobol")
