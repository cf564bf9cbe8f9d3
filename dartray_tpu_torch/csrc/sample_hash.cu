// The sampler's hashing: one launch a draw, in native uint32.
//
// Replaces no TPU kernel. The reference draws its samples with XLA's uint32
// ops (`samplers.py`, `core/sampling.py`, `integrators/ao.py`), which XLA
// fuses. PyTorch has no full set of uint32 ops, so the plain version keeps
// every u32 in an int64 lane and masks after each multiply and shift: one
// draw is 58-200 elementwise passes over the wave's lanes, each reading and
// writing 8 bytes a lane. Here a draw is one pass.
//
// Bound: bytes. A draw reads px, py and the sample index (int32, 12 B a
// lane) and writes one to five float32 planes; its ~150 integer ops a lane
// are far below the card's integer rate. One thread a lane, nothing in
// shared memory, no intermediate in device memory.
//
// Every step is the plain version's (`samplers.sample_1d_plain`,
// `sample_2d_plain`, `camera_samples_plain`, `integrators/ao.py`'s
// `scrambles_plain` and the probes' `core/sampling.sample02`), so the bits
// are the same: a u32 becomes a float32 by rounding to nearest, the unit
// scales are powers of two, the strata divide by IEEE division
// (`__fdiv_rn`), and -fmad=false keeps every sum unfused.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr float ONE_MINUS_EPS = 0.99999994f;         // 1 - 2^-24
constexpr float INV_2_32 = 2.3283064365386963e-10f;   // 2^-32
constexpr float INV_2_24 = 5.9604644775390625e-08f;   // 2^-24

// the kinds the kernel draws (ops/sampler_cuda.py's codes): STRATIFIED, or
// else the lowdiscrepancy (0,2)-sequence (0), which a best-candidate sampler
// also draws at every dimension but its image offset's
constexpr int STRATIFIED = 1;

struct Sampler {
  int kind;
  uint32_t spp;
  uint32_t seed;
  uint32_t nx, ny;     // strata
  int jitter;
  int n_bits;          // Sobol' bits the (0,2)-sequence folds
};

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// samplers._pixel_key
__device__ __forceinline__ uint32_t pixel_key(uint32_t px, uint32_t py,
                                              int dim, uint32_t seed) {
  const uint32_t d = static_cast<uint32_t>(dim + 1) * 0x9e3779b9u;
  return hash_u32(hash_u32(px ^ (py << 16) ^ d) ^ seed);
}

// core/sampling.index_permute's mix (Kensler's hash bijection on [0, w])
__device__ __forceinline__ uint32_t permute_mix(uint32_t x, uint32_t p,
                                                uint32_t w) {
  x ^= p;
  x *= 0xe170893du;
  x ^= p >> 16;
  x ^= (x & w) >> 4;
  x ^= p >> 8;
  x *= 0x0929eb3fu;
  x ^= p >> 23;
  x ^= (x & w) >> 1;
  x *= 1u | (p >> 27);
  x *= 0x6935fa69u;
  x ^= (x & w) >> 11;
  x *= 0x74dcb303u;
  x ^= (x & w) >> 2;
  x *= 0x9e501cc3u;
  x ^= (x & w) >> 2;
  x *= 0xc860a3dfu;
  x &= w;
  x ^= x >> 5;
  return x;
}

// core/sampling.index_permute: a permutation of [0, n), with the cycle walk
// where n is not a power of two
__device__ __forceinline__ uint32_t index_permute(uint32_t i, uint32_t n,
                                                  uint32_t p) {
  if (n <= 1) return 0u;
  uint32_t w = n - 1;
  w |= w >> 1;
  w |= w >> 2;
  w |= w >> 4;
  w |= w >> 8;
  w |= w >> 16;
  i &= w;
  uint32_t x = permute_mix(i, p, w);
  if (n != w + 1) {
    for (int k = 0; k < 7; ++k)
      if (x >= n) x = permute_mix(x, p, w);
    if (x >= n) x = i;
  }
  return (x + p) % n;
}

// u32 * 2^-32 in float32, below 1
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return fminf(__fmul_rn(__uint2float_rn(bits), INV_2_32), ONE_MINUS_EPS);
}

// core/sampling.uniform_from_bits and rng_uniform
__device__ __forceinline__ float rng_uniform(uint32_t key, uint32_t counter) {
  const uint32_t bits = hash_u32(key ^ hash_u32(counter));
  return fminf(__fmul_rn(__uint2float_rn(bits >> 8), INV_2_24),
               ONE_MINUS_EPS);
}

// core/sampling.van_der_corput: the bit reversal, then the scramble
__device__ __forceinline__ float van_der_corput(uint32_t n, uint32_t scr) {
  return unit_float(__brev(n) ^ scr);
}

// core/sampling.sobol2 to n_bits
__device__ __forceinline__ float sobol2(uint32_t n, uint32_t s, int n_bits) {
  uint32_t v = 1u << 31;
  for (int i = 0; i < n_bits; ++i) {
    if ((n >> i) & 1u) s ^= v;
    v ^= v >> 1;
  }
  return unit_float(s);
}

// samplers.sample_2d_plain's lowdiscrepancy / best-candidate and stratified
// branches
__device__ __forceinline__ float2 draw_2d(const Sampler& sm, uint32_t px,
                                          uint32_t py, uint32_t s, int dim) {
  if (sm.kind == STRATIFIED) {
    const uint32_t k = pixel_key(px, py, dim, sm.seed);
    const uint32_t perm = index_permute(s, sm.spp, k);
    const float sx = __uint2float_rn(perm % sm.nx);
    const float sy = __uint2float_rn(perm / sm.nx);
    const float jx = sm.jitter ? rng_uniform(k, s * 2u) : 0.5f;
    const float jy = sm.jitter ? rng_uniform(k, s * 2u + 1u) : 0.5f;
    return make_float2(__fdiv_rn(__fadd_rn(sx, jx), __uint2float_rn(sm.nx)),
                       __fdiv_rn(__fadd_rn(sy, jy), __uint2float_rn(sm.ny)));
  }
  const uint32_t sp = index_permute(s, sm.spp,
                                    pixel_key(px, py, dim + 2000, sm.seed));
  return make_float2(
      van_der_corput(sp, pixel_key(px, py, dim, sm.seed)),
      sobol2(sp, pixel_key(px, py, dim + 1000, sm.seed), sm.n_bits));
}

// samplers.sample_1d_plain's branches of the same kinds
__device__ __forceinline__ float draw_1d(const Sampler& sm, uint32_t px,
                                         uint32_t py, uint32_t s, int dim) {
  if (sm.kind == STRATIFIED) {
    const uint32_t k = pixel_key(px, py, dim, sm.seed);
    const uint32_t perm = index_permute(s, sm.spp, k);
    const float j = sm.jitter ? rng_uniform(k, s) : 0.5f;
    return __fdiv_rn(__fadd_rn(__uint2float_rn(perm), j),
                     __uint2float_rn(sm.spp));
  }
  const uint32_t sp = index_permute(s, sm.spp,
                                    pixel_key(px, py, dim + 2000, sm.seed));
  return van_der_corput(sp, pixel_key(px, py, dim, sm.seed));
}

__global__ void __launch_bounds__(BLOCK)
draw_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
            const int32_t* __restrict__ s, float* __restrict__ out_x,
            float* __restrict__ out_y, int n, Sampler sm, int dim) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = px[i], y = py[i], si = s[i];
  if (out_y != nullptr) {
    const float2 u = draw_2d(sm, x, y, si, dim);
    out_x[i] = u.x;
    out_y[i] = u.y;
  } else {
    out_x[i] = draw_1d(sm, x, y, si, dim);
  }
}

// samplers.camera_samples_plain: image offset (dims 0, 1), lens (2, 3) and
// time (4); the image sample is the pixel plus its offset
__global__ void __launch_bounds__(BLOCK)
camera_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
              const int32_t* __restrict__ s, float* __restrict__ image_x,
              float* __restrict__ image_y, float* __restrict__ lens_u,
              float* __restrict__ lens_v, float* __restrict__ time_u, int n,
              Sampler sm) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int32_t x = px[i], y = py[i];
  const uint32_t si = s[i];
  const float2 img = draw_2d(sm, x, y, si, 0);
  const float2 lens = draw_2d(sm, x, y, si, 2);
  image_x[i] = __fadd_rn(__int2float_rn(x), img.x);
  image_y[i] = __fadd_rn(__int2float_rn(y), img.y);
  lens_u[i] = lens.x;
  lens_v[i] = lens.y;
  time_u[i] = draw_1d(sm, x, y, si, 4);
}

// integrators/ao.py's scramble pair of a (pixel, camera sample), the same
// for every probe; stored as int32 bit patterns
__global__ void __launch_bounds__(BLOCK)
ao_scrambles_kernel(const int32_t* __restrict__ px,
                    const int32_t* __restrict__ py,
                    const int32_t* __restrict__ s, int32_t* __restrict__ scr_x,
                    int32_t* __restrict__ scr_y, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const uint32_t base = hash_u32(static_cast<uint32_t>(px[i]) ^
                                 (static_cast<uint32_t>(py[i]) << 16) ^
                                 hash_u32(static_cast<uint32_t>(s[i])));
  scr_x[i] = static_cast<int32_t>(hash_u32(base ^ 0x1234567u));
  scr_y[i] = static_cast<int32_t>(hash_u32(base ^ 0x89abcdefu));
}

// one AO probe's (0,2)-sequence sample: index `probe` under the lane's pair
__global__ void __launch_bounds__(BLOCK)
ao_probe_kernel(const int32_t* __restrict__ scr_x,
                const int32_t* __restrict__ scr_y, float* __restrict__ u,
                float* __restrict__ v, int n, uint32_t probe, int n_bits) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  u[i] = van_der_corput(probe, static_cast<uint32_t>(scr_x[i]));
  v[i] = sobol2(probe, static_cast<uint32_t>(scr_y[i]), n_bits);
}

inline int blocks(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

// The launchers: each enqueues one kernel on `stream` (no synchronisation,
// no allocation) and returns cudaGetLastError() (0 when it launched).
// `n` > 0; out_y null draws one dimension.
extern "C" int sample_hash_draw_launch(
    const int32_t* px, const int32_t* py, const int32_t* s, float* out_x,
    float* out_y, int n, int kind, int dim, uint32_t spp, uint32_t seed,
    uint32_t nx, uint32_t ny, int jitter, int n_bits, void* stream) {
  draw_kernel<<<blocks(n), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      px, py, s, out_x, out_y, n,
      Sampler{kind, spp, seed, nx, ny, jitter, n_bits}, dim);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sample_hash_camera_launch(
    const int32_t* px, const int32_t* py, const int32_t* s, float* image_x,
    float* image_y, float* lens_u, float* lens_v, float* time_u, int n,
    int kind, uint32_t spp, uint32_t seed, uint32_t nx, uint32_t ny,
    int jitter, int n_bits, void* stream) {
  camera_kernel<<<blocks(n), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      px, py, s, image_x, image_y, lens_u, lens_v, time_u, n,
      Sampler{kind, spp, seed, nx, ny, jitter, n_bits});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sample_hash_ao_scrambles_launch(
    const int32_t* px, const int32_t* py, const int32_t* s, int32_t* scr_x,
    int32_t* scr_y, int n, void* stream) {
  ao_scrambles_kernel<<<blocks(n), BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      px, py, s, scr_x, scr_y, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sample_hash_ao_probe_launch(
    const int32_t* scr_x, const int32_t* scr_y, float* u, float* v, int n,
    uint32_t probe, int n_bits, void* stream) {
  ao_probe_kernel<<<blocks(n), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      scr_x, scr_y, u, v, n, probe, n_bits);
  return static_cast<int>(cudaGetLastError());
}
