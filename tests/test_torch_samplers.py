"""PyTorch port, the samplers: every kind's sample values against the JAX
reference's on the same seeded pixels and sample indices, BIT FOR BIT.

Every kind (lowdiscrepancy, stratified with and without jitter, random,
halton, bestcandidate) at spp 1, 5, 16 and 33 over dims 0-9 of 512 pixels,
``sample_2d`` and ``sample_1d``; the best-candidate tile for seeds 0 and 3;
the radical inverse over every prime base; the vector sampler; camera
samples. The reference's Halton draws run jitted (one compile for the ten
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


def _draws(mod, sampler, px, py, s):
    """{dim: (x, y, u)} of `mod`'s sample_2d / sample_1d over DIMS."""
    return [(*mod.sample_2d(sampler, px, py, s, d),
             mod.sample_1d(sampler, px, py, s, d)) for d in DIMS]


@pytest.mark.parametrize("spp", [1, 5, 16, 33])
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
