// ray_tests.cuh — the arithmetic every traversal kernel of this package
// shares: the ray record, the slab test of one wide node's 8 child boxes and
// the Moeller-Trumbore triangle test.
//
// Every expression is written in the order of the plain PyTorch versions in
// ops/traverse_cuda.py (`_safe_inv`, the slab block of the walks, `_mt`), and
// the sources are built with -fmad=false and without --use_fast_math, so a
// kernel and its plain version round alike and take the same walk. Column 9
// of a soup16 row is an int32 bit pattern: it is only moved and sign-tested.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define STACK_DEPTH 96  // stack entries: per ray (v6), per packet (v5, v7)

namespace dr {

constexpr float kTriEps = 1e-10f;
constexpr float kBaryEps = 1e-6f;

__device__ __forceinline__ float safe_inv(float d) {
  const float tiny = d < 0.0f ? -1e-30f : 1e-30f;
  return 1.0f / (fabsf(d) < 1e-30f ? tiny : d);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx,
                                        float dy, float dz, float tmin) {
  return Ray{ox, oy,           oz,           dx,           dy,
             dz, safe_inv(dx), safe_inv(dy), safe_inv(dz), tmin};
}

// Slab-test the 8 child boxes of one wide node (a 192-byte row [lox*8 loy*8
// loz*8 hix*8 hiy*8 hiz*8]) against `r` clipped to [tmin, t_best]; bit s of
// the result is set where child slot s is hit.
__device__ __forceinline__ unsigned slab8(const float4* __restrict__ row,
                                          const Ray& r, float t_best) {
  float b[48];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float4 v = __ldg(row + j);
    b[4 * j + 0] = v.x;
    b[4 * j + 1] = v.y;
    b[4 * j + 2] = v.z;
    b[4 * j + 3] = v.w;
  }
  unsigned mask = 0u;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float lox = b[s];
    const float t0x = (lox - r.ox) * r.ix, t1x = (b[24 + s] - r.ox) * r.ix;
    const float t0y = (b[8 + s] - r.oy) * r.iy,
                t1y = (b[32 + s] - r.oy) * r.iy;
    const float t0z = (b[16 + s] - r.oz) * r.iz,
                t1z = (b[40 + s] - r.oz) * r.iz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), r.tmin));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fminf(fmaxf(t0z, t1z), t_best));
    // fminf/fmaxf drop a NaN operand, so an empty (NaN) child slot is
    // rejected explicitly: it must never hit
    if (tn <= tf && lox == lox) mask |= 1u << s;
  }
  return mask;
}

// Moeller-Trumbore: true (and *t_out) where `r` hits the triangle (v0, e1,
// e2) at t > tmin inside the inclusive barycentric tolerance.
__device__ __forceinline__ bool mt_test(const Ray& r, float v0x, float v0y,
                                        float v0z, float e1x, float e1y,
                                        float e1z, float e2x, float e2y,
                                        float e2z, float* t_out) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool flat = fabsf(det) < kTriEps;
  const float inv_det = 1.0f / (flat ? 1.0f : det);
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  *t_out = t;
  return !flat && u >= -kBaryEps && v >= -kBaryEps &&
         (u + v) <= 1.0f + kBaryEps && t > r.tmin;
}

// A candidate replaces the current winner when it is nearer; a lane without
// a winner also accepts t == t_best, so tmax itself is inside the interval.
__device__ __forceinline__ bool nearer(float t, float t_best, int prim) {
  return t < t_best || (prim < 0 && t == t_best);
}

}  // namespace dr
