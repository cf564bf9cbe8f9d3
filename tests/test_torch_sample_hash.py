"""PyTorch port, the sampler's hashing kernel (``csrc/sample_hash.cu``,
``ops/sampler_cuda.py``) against the plain versions it replaces on the card
(``samplers.sample_1d_plain`` / ``sample_2d_plain`` / ``camera_samples_plain``,
``integrators/ao.py``'s ``scrambles_plain`` and the probes' ``sample02``).

On the CPU: the route rule (which draws the kernel takes), CPU draws on the
plain route and counted under ``draws/plain``, the wrapper's checks and C
signatures, and the kernel source's arithmetic itself, compiled for the host
with ``g++`` under a shim of the CUDA intrinsics it calls and held against
the plain versions bit for bit. On the card (``-m cuda``): every routed draw
against the plain version of the same lanes on the CPU, bit for bit, and a
bench-scene wave whose film equals the plain route's on the card.

The plain versions are the oracle: tier-1 holds them against the JAX
reference (``tests/test_torch_samplers.py``). This file imports no JAX.
"""
import ctypes
import itertools
import os
import re
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dartray_tpu_torch import samplers as S
from dartray_tpu_torch import stats
from dartray_tpu_torch.core import sampling as smp
from dartray_tpu_torch.integrators import ao
from dartray_tpu_torch.ops import sampler_cuda as sc
from dartray_tpu_torch.ops import traverse_cuda as tc

torch.set_num_threads(1)

CUDA = SimpleNamespace(device=torch.device("cuda"))   # lanes on a card
CPU = SimpleNamespace(device=torch.device("cpu"))
# seconds the host compile of the kernel source may take (0.4 s on a host
# loaded by a whole test run); a compiler that hangs fails the file's host
# cases here
GXX_DEADLINE_S = 120

# every sampler the kernel draws, as (name, sampler); seeds 0 and 3 and one
# past 2**31
SAMPLERS = [(f"lowdiscrepancy{spp}", S.make_sampler("lowdiscrepancy", spp,
                                                      seed=3))
            for spp in (1, 4, 64, 4096)] + [
    ("stratified8x8", S.make_sampler("stratified", 64, seed=0)),
    ("stratified8x8_nojitter", S.make_sampler("stratified", 64, seed=3,
                                              jitter=False)),
    ("stratified3x5", S.Sampler(S.STRATIFIED, 15, 3, 3, 5, True)),
    ("stratified3x5_nojitter", S.Sampler(S.STRATIFIED, 15, 0, 3, 5, False)),
    ("bestcandidate", S.make_sampler("bestcandidate", 64, seed=0)),
    ("lowdiscrepancy_bigseed", S.make_sampler("lowdiscrepancy", 16,
                                              seed=2 ** 31 + 12345)),
]
DIMS = range(41)


def _lanes(n, seed, spp):
    """Pixels (a few negative, as a padded band's py is), and sample
    indices that vary by lane and pass spp."""
    rng = np.random.RandomState(seed)
    px = rng.randint(-3, 4000, n).astype(np.int32)
    py = rng.randint(-1, 2200, n).astype(np.int32)
    s = rng.randint(0, 2 * spp + 3, n).astype(np.int32)
    return tuple(torch.from_numpy(a) for a in (px, py, s))


def _routed(sampler, dim):
    return S._on_kernel(sampler, CUDA, dim)


# --- the CPU -----------------------------------------------------------------

@pytest.mark.parametrize("kind,routed", [
    ("lowdiscrepancy", {0: True, 1: True, 7: True}),
    ("stratified", {0: True, 5: True}),
    ("bestcandidate", {0: False, 1: True, 2: True, 9: True}),
    ("halton", {0: False, 5: False}),
    ("random", {0: False, 5: False}),
])
def test_the_route_rule(kind, routed):
    """CUDA lanes of the lowdiscrepancy and stratified kinds and of the
    best-candidate kind past its image offset take the kernel; the rest,
    and every CPU lane, the plain version."""
    sampler = S.make_sampler(kind, 16)
    for dim, want in routed.items():
        assert S._on_kernel(sampler, CUDA, dim) is want, (kind, dim)
        assert S._on_kernel(sampler, CPU, dim) is False
    vec = S.vector_sampler(torch.zeros(4, 3))
    assert not S._on_kernel(vec, CUDA, 1)


def test_cpu_draws_take_the_plain_route_and_count():
    px, py, s = _lanes(257, 1, 16)
    rs = stats.RenderStats()
    launches = dict(sc.LAUNCHES)
    with stats.collect(rs):
        for kind in ("lowdiscrepancy", "stratified", "halton", "random",
                     "bestcandidate"):
            sampler = S.make_sampler(kind, 16, seed=5)
            got = (S.sample_2d(sampler, px, py, s, 7),
                   S.sample_1d(sampler, px, py, s, 9),
                   S.camera_samples(sampler, px, py, s))
            want = (S.sample_2d_plain(sampler, px, py, s, 7),
                    S.sample_1d_plain(sampler, px, py, s, 9),
                    S.camera_samples_plain(sampler, px, py, s))
            assert torch.equal(got[0].x, want[0].x)
            assert torch.equal(got[0].y, want[0].y)
            assert torch.equal(got[1], want[1])
            for a, b in ((got[2].image_xy, want[2].image_xy),
                         (got[2].lens_uv, want[2].lens_uv)):
                assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
            assert torch.equal(got[2].time_u, want[2].time_u)
        vec = S.vector_sampler(torch.rand(257, 6))
        S.sample_2d(vec, px, py, s, 3)
        scr = ao.scrambles(px, py, s)
        ao.probe(scr, 5, 6)
    # 5 kinds x (2d + 1d + camera's 3) + the vector draw + AO's 2
    assert rs.counters == {"draws/plain": 5 * 5 + 1 + 2}
    assert sc.LAUNCHES == launches
    assert stats.draws_on_kernel_pct(rs.counters) == 0.0
    assert "draws_on_kernel              0.0%" in rs.summary()
    # nothing counts while nothing collects
    S.sample_1d(S.make_sampler("lowdiscrepancy", 4), px, py, s, 1)
    assert rs.counters == {"draws/plain": 28}


def test_draw_share_reads_both_counters():
    assert stats.draws_on_kernel_pct({}) is None
    assert stats.draws_on_kernel_pct({"draws/kernel": 3,
                                      "draws/plain": 1}) == 75.0
    rs = stats.RenderStats()
    rs.add("draws/kernel", 31)
    assert "draws_on_kernel              100.0%" in rs.summary()


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    px, py, s = _lanes(10, 2, 4)
    args = dict(kind=sc.LOWDISCREPANCY, spp=4, seed=0)
    with pytest.raises(ValueError, match="px must be"):
        sc.draw(px, py, s, 5, two_d=True, **args)
    with pytest.raises(ValueError, match="px must be"):
        sc.camera(px.float(), py, s, **args)
    with pytest.raises(ValueError, match="px must be"):
        sc.ao_scrambles(px, py, s)
    with pytest.raises(ValueError, match="scramble pair"):
        sc.ao_probe((px, py), 0, 6)


def test_the_loader_builds_and_binds_the_source():
    assert os.path.isfile(tc.KERNEL_SOURCES["sample_hash"])
    fns = {}

    class Lib:
        def __getattr__(self, name):
            return fns.setdefault(name, SimpleNamespace())

    tc._bind("sample_hash", Lib())
    assert set(fns) == {"sample_hash_draw_launch",
                        "sample_hash_camera_launch",
                        "sample_hash_ao_scrambles_launch",
                        "sample_hash_ao_probe_launch"}
    src = open(tc.KERNEL_SOURCES["sample_hash"]).read()
    for name, fn in fns.items():
        assert fn.restype is ctypes.c_int
        # the C declaration's parameters, in order, against the argtypes:
        # every pointer and the stream pointer-wide, u32 unsigned
        decl = re.search(r'extern "C" int ' + name + r"\((.*?)\)", src,
                         re.S).group(1)
        params = [p.strip() for p in decl.split(",")]
        assert len(params) == len(fn.argtypes), name
        for p, t in zip(params, fn.argtypes):
            want = (ctypes.c_void_p if "*" in p else ctypes.c_uint32
                    if p.startswith("uint32_t") else ctypes.c_int)
            assert t is want, (name, p)


# The kernel source compiled for the host: each intrinsic it calls is the
# IEEE operation it names, `__global__` a function, a launch a loop over
# the grid, so its arithmetic runs here as written.
_SHIM = r"""
#include <cmath>
#include <cstdint>
struct Dim { unsigned x; };
static Dim blockIdx, threadIdx;
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
typedef void* cudaStream_t;
static inline int cudaGetLastError() { return 0; }
struct float2 { float x, y; };
static inline float2 make_float2(float a, float b) { return float2{a, b}; }
static inline uint32_t __brev(uint32_t v) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) if (v >> i & 1u) r |= 1u << (31 - i);
  return r;
}
static inline float __uint2float_rn(uint32_t u) { return (float)u; }
static inline float __int2float_rn(int32_t u) { return (float)u; }
// volatile: each result rounds to float32 on its own, as on the card
static inline float __fmul_rn(float a, float b) { volatile float r = a * b;
                                                  return r; }
static inline float __fadd_rn(float a, float b) { volatile float r = a + b;
                                                  return r; }
static inline float __fdiv_rn(float a, float b) { volatile float r = a / b;
                                                  return r; }
#define LAUNCH(n, k, ...) \
  for (blockIdx.x = 0; blockIdx.x < (unsigned)blocks(n); ++blockIdx.x) \
    for (threadIdx.x = 0; threadIdx.x < (unsigned)BLOCK; ++threadIdx.x) \
      k(__VA_ARGS__)
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    src = open(tc.KERNEL_SOURCES["sample_hash"]).read()
    src = src.replace("#include <cuda_runtime.h>", _SHIM)
    src, n = re.subn(r"(\w+)<<<[^;]*?>>>\(", r"LAUNCH(n, \1, ", src,
                     flags=re.S)
    assert n == 4
    d = tmp_path_factory.mktemp("sample_hash_host")
    cpp, so = d / "sample_hash_host.cpp", d / "libsample_hash_host.so"
    cpp.write_text(src)
    subprocess.run([gxx, "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-o", str(so), str(cpp)], check=True,
                   timeout=GXX_DEADLINE_S)
    lib = ctypes.CDLL(str(so))
    sc.bind(lib)
    return lib


def _p(x):
    return x.data_ptr()


def _host_draw(lib, sampler, px, py, s, dim, two_d):
    a = S._kernel_args(sampler)
    outs = [torch.empty(px.shape[0]) for _ in range(2 if two_d else 1)]
    rc = lib.sample_hash_draw_launch(
        _p(px), _p(py), _p(s), _p(outs[0]), _p(outs[1]) if two_d else None,
        px.shape[0], a["kind"], dim, *sc._sampler_args(
            a["spp"], a["seed"], a["nx"], a["ny"], a["jitter"], a["n_bits"]),
        None)
    assert rc == 0
    return outs


@pytest.mark.parametrize("name,sampler", SAMPLERS,
                         ids=[n for n, _ in SAMPLERS])
def test_kernel_source_on_the_host_equals_the_plain_draws(host_kernel, name,
                                                          sampler):
    px, py, s = _lanes(1001, 7, sampler.spp)
    for dim in DIMS:
        if _routed(sampler, dim):
            x, y = _host_draw(host_kernel, sampler, px, py, s, dim, True)
            want = S.sample_2d_plain(sampler, px, py, s, dim)
            assert torch.equal(x, want.x) and torch.equal(y, want.y), dim
            (u,) = _host_draw(host_kernel, sampler, px, py, s, dim, False)
            assert torch.equal(u, S.sample_1d_plain(sampler, px, py, s,
                                                    dim)), dim
    if _routed(sampler, 0):
        a = S._kernel_args(sampler)
        outs = [torch.empty(1001) for _ in range(5)]
        assert host_kernel.sample_hash_camera_launch(
            _p(px), _p(py), _p(s), *map(_p, outs), 1001, a["kind"],
            *sc._sampler_args(a["spp"], a["seed"], a["nx"], a["ny"],
                              a["jitter"], a["n_bits"]), None) == 0
        c = S.camera_samples_plain(sampler, px, py, s)
        for got, want in zip(outs, (c.image_xy.x, c.image_xy.y, c.lens_uv.x,
                                    c.lens_uv.y, c.time_u)):
            assert torch.equal(got, want)


def test_kernel_source_on_the_host_equals_the_plain_ao_draws(host_kernel):
    px, py, s = _lanes(1001, 8, 64)
    sx, sy = (torch.empty(1001, dtype=torch.int32) for _ in range(2))
    assert host_kernel.sample_hash_ao_scrambles_launch(
        _p(px), _p(py), _p(s), _p(sx), _p(sy), 1001, None) == 0
    wx, wy = ao.scrambles_plain(px, py, s)
    assert torch.equal(sx.to(torch.int64) & smp.M32, wx)
    assert torch.equal(sy.to(torch.int64) & smp.M32, wy)
    for n_samples, i in itertools.product((1, 64, 100), (0, 1, 37, 99)):
        if i >= n_samples:
            continue
        n_bits = max(int(n_samples - 1).bit_length(), 1)
        u, v = torch.empty(1001), torch.empty(1001)
        assert host_kernel.sample_hash_ao_probe_launch(
            _p(sx), _p(sy), _p(u), _p(v), 1001, i, n_bits, None) == 0
        want = ao.probe((wx, wy), i, n_bits)
        assert torch.equal(u, want.x) and torch.equal(v, want.y)


# --- the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


def _on(dev, *xs):
    return [x.to(dev) for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("name,sampler", SAMPLERS,
                         ids=[n for n, _ in SAMPLERS])
def test_draws_on_the_card_equal_the_plain_route(name, sampler):
    """Every routed draw of dims 0-40 over 4,099 lanes, and one at
    1,000,003 lanes (no multiple of the block), kernel against the plain
    version of the same lanes on the CPU."""
    dev = _card()
    for n, dims in ((4099, DIMS), (1_000_003, (0, 5))):
        px, py, s = _lanes(n, 11, sampler.spp)
        cx, cy, cs = _on(dev, px, py, s)
        launches = sc.LAUNCHES["draw"]
        routed = 0
        for dim in dims:
            if not _routed(sampler, dim):
                continue
            routed += 2
            got = S.sample_2d(sampler, cx, cy, cs, dim)
            want = S.sample_2d_plain(sampler, px, py, s, dim)
            assert torch.equal(got.x.cpu(), want.x), (n, dim)
            assert torch.equal(got.y.cpu(), want.y), (n, dim)
            got = S.sample_1d(sampler, cx, cy, cs, dim)
            assert torch.equal(got.cpu(), S.sample_1d_plain(
                sampler, px, py, s, dim)), (n, dim)
        torch.cuda.synchronize()
        assert sc.LAUNCHES["draw"] - launches == routed
    px, py, s = _lanes(1_000_003, 12, sampler.spp)
    got = S.camera_samples(sampler, *_on(dev, px, py, s))
    want = S.camera_samples_plain(sampler, px, py, s)
    for a, b in ((got.image_xy, want.image_xy), (got.lens_uv, want.lens_uv)):
        assert torch.equal(a.x.cpu(), b.x) and torch.equal(a.y.cpu(), b.y)
    assert torch.equal(got.time_u.cpu(), want.time_u)


@pytest.mark.cuda
def test_ao_draws_on_the_card_equal_the_plain_route():
    dev = _card()
    px, py, s = _lanes(1_000_003, 13, 64)
    scr = ao.scrambles(*_on(dev, px, py, s))
    want = ao.scrambles_plain(px, py, s)
    for got, w in zip(scr, want):
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu().to(torch.int64) & smp.M32, w)
    for i in (0, 1, 31, 63):
        got = ao.probe(scr, i, 6)
        w = ao.probe(want, i, 6)
        assert torch.equal(got.x.cpu(), w.x) and torch.equal(got.y.cpu(), w.y)


@pytest.mark.cuda
def test_a_bench_wave_on_the_card_equals_the_plain_routes(monkeypatch):
    """One path wave of the bench scene (256x256, lowdiscrepancy, depth 5):
    the film of the kernel's draws equals the film of the plain route's on
    the card, every draw of it on the kernel."""
    dev = _card()
    from dartray_tpu_torch import cameras
    from dartray_tpu_torch import film as film_mod
    from dartray_tpu_torch.core import transform as tr
    from dartray_tpu_torch.integrators import path as pi
    from dartray_tpu_torch.renderers import sampler as rend
    from dartray_tpu_torch.scene import build as sb
    from dartray_tpu_torch.scene import types as st
    res = 256
    scene = st.to_device(sb.bench_scene().build(), dev)
    cam = cameras.perspective(tr.look_at([0, 2.2, -5.0], [0, 0.9, 0],
                                         [0, 1, 0]), 42.0, res, res,
                              device=dev)
    sampler = S.make_sampler("lowdiscrepancy", 64, seed=7)
    px, py = rend.pixel_grid(res, res, device=dev)
    ig = pi.PathIntegrator(max_depth=5)

    def wave():
        film = film_mod.make_film(res, res, device=dev)
        with torch.no_grad():
            for si in (0, 5):
                film = rend.render_wave(
                    scene, cam, sampler, film, px, py,
                    torch.full(px.shape, si, dtype=torch.int32, device=dev),
                    li_fn=lambda s_, r, d, c: pi.li(ig, s_, r, d, c),
                    width=res, height=res, spp=sampler.spp, device=dev)
        return film.pixels.cpu()

    rs = stats.RenderStats()
    with stats.collect(rs):
        kernel = wave()
    draws = {k: v for k, v in rs.counters.items() if k.startswith("draws/")}
    assert set(draws) == {"draws/kernel"}
    monkeypatch.setattr(S, "_on_kernel", lambda *a: False)
    plain = stats.RenderStats()
    with stats.collect(plain):
        ref = wave()
    assert plain.counters["draws/plain"] == draws["draws/kernel"]
    assert "draws/kernel" not in plain.counters
    assert torch.equal(kernel, ref)
