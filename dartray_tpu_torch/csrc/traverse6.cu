// traverse6.cu — wide-BVH ray traversal for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX reference's Pallas kernel `_kernel6` / launcher `traverse6`
// (ops/traverse_pallas.py) in its closest-hit, any-hit and mixed (a per-lane
// any-hit flag) modes, each for a static scene and, as a second instantiation
// of the same template with its own launcher, for moving geometry
// (`motion=True` there): every leaf triangle is lerped to the ray's shutter
// time, v(t) = v + time * dv for its nine components, from a second row
// table of (close - open) deltas, before the same test. The lerp is a
// rounded multiply and then a rounded add, here and in the plain version.
// Same contract: for rays
// (o, d, tmin, tmax) return an approximate-or-exact hit distance `t` (+inf on
// a miss) and the PERMUTED prim id `cluster * K + j` (-1 on a miss). A lane
// with tmax < tmin is dead. The exact (t, b1, b2) and the original prim id are
// recomputed outside the kernel by the finish step (ops/traverse_cuda.py).
//
// Design (simple and right first): one thread per ray, a per-thread stack of
// child refs in local memory, the ray's OWN direction octant selects the
// far-first push-order row, so pops come near first. A popped interior ref
// slab-tests the node's 8 child boxes; a popped leaf ref tests the cluster's
// K triangles inline (Moeller-Trumbore). (t, prim) stay in two registers.
// Tables are read from global memory through L1/L2 with 16-byte loads: a node
// is one 192-byte row, an order row is 32 bytes, a triangle is the first 48
// bytes of its 64-byte soup16 row.
//
// What bounds it: neither the ray planes' bytes (40 B a ray in and out) nor
// f32 arithmetic, but the latency of dependent table fetches along each
// ray's walk and the divergence of the 32 walks of a warp. The caller's
// coherence sort keeps a warp's rays in one region and one octant; nothing
// else is done about it here (warp-cooperative packets, shared-memory stacks
// and persistent blocks are later work).
//
// Arithmetic: compile WITHOUT --use_fast_math (NaN pad boxes and +-inf tmax
// must compare per IEEE; the id column of the soup rows is an int32 bit
// pattern that is only ever moved) and with -fmad=false, so every product and
// sum rounds exactly as the plain PyTorch version's separate elementwise ops
// do and both take the same walk.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libtraverse6.so traverse6.cu
// (ray_tests.cuh, beside this file, holds the slab and triangle tests.)

#include "ray_tests.cuh"

#define BLOCK_THREADS 128

#define MODE_CLOSEST 0
#define MODE_ANY 1
#define MODE_MIXED 2

namespace {

template <bool MOTION>
__global__ void __launch_bounds__(BLOCK_THREADS)
traverse6_kernel(const float4* __restrict__ wbounds,  // (W, 12) float4
                 const int4* __restrict__ worder,     // (8 W, 2) int4
                 const float4* __restrict__ soup,     // (C K, 4) float4
                 const float4* __restrict__ soupd,    // deltas; MOTION only
                 const float* __restrict__ ox_, const float* __restrict__ oy_,
                 const float* __restrict__ oz_, const float* __restrict__ dx_,
                 const float* __restrict__ dy_, const float* __restrict__ dz_,
                 const float* __restrict__ tmin_,
                 const float* __restrict__ tmax_,
                 const float* __restrict__ anyf_,     // null unless mixed
                 const float* __restrict__ time_,     // in [0, 1]; MOTION only
                 float* __restrict__ t_out, int* __restrict__ prim_out,
                 int* __restrict__ overflow, int n, int n_wnodes, int k,
                 int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float inf = __int_as_float(0x7f800000);
  const float tmin = tmin_[i];
  const float tmax = tmax_[i];
  if (!(tmax >= tmin)) {  // dead lane (also NaN bounds)
    t_out[i] = inf;
    prim_out[i] = -1;
    return;
  }
  const dr::Ray r =
      dr::make_ray(ox_[i], oy_[i], oz_[i], dx_[i], dy_[i], dz_[i], tmin);
  const int octant = (r.dx < 0.0f ? 1 : 0) + (r.dy < 0.0f ? 2 : 0) +
                     (r.dz < 0.0f ? 4 : 0);
  const bool any_lane =
      mode == MODE_ANY || (mode == MODE_MIXED && anyf_[i] > 0.0f);
  const float time = MOTION ? time_[i] : 0.0f;
  const int4* order_rows = worder + (size_t)octant * n_wnodes * 2;

  int stack[STACK_DEPTH];
  int sp = 0;
  stack[sp++] = 0;  // root wide node
  float t_best = tmax;
  int prim = -1;

  while (sp > 0) {
    const int ref = stack[--sp];
    if (ref >= 0) {
      // ---- interior: slab-test the 8 child boxes of wide node `ref`
      const unsigned mask = dr::slab8(wbounds + (size_t)ref * 12, r, t_best);
      if (mask != 0u) {
        const int4* orow = order_rows + (size_t)ref * 2;
        const int4 e0 = __ldg(orow), e1 = __ldg(orow + 1);
        const int ent[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // far first, so near pops first
          const int e = ent[j];
          if ((mask >> (e & 7)) & 1u) {
            if (sp < STACK_DEPTH) {
              stack[sp++] = e >> 3;  // arithmetic shift: ref < 0 is a leaf
            } else {
              atomicOr(overflow, 1);
            }
          }
        }
      }
    } else {
      // ---- leaf: test the cluster's triangles (pad slots trail, id < 0)
      const int base = (-ref - 1) * k;
      const float4* tri = soup + (size_t)base * 4;
      const float4* trd = MOTION ? soupd + (size_t)base * 4 : nullptr;
      for (int j = 0; j < k; ++j, tri += 4) {
        float4 a = __ldg(tri);      // v0.xyz e1.x
        float4 c = __ldg(tri + 1);  // e1.yz e2.xy
        float4 g = __ldg(tri + 2);  // e2.z id_bits 0 0
        if (__float_as_int(g.y) < 0) break;
        if (MOTION) {  // lerp to the ray's time; the id column is not touched
          const float4 da = __ldg(trd + 4 * j);
          const float4 dc = __ldg(trd + 4 * j + 1);
          const float4 dg = __ldg(trd + 4 * j + 2);
          a.x = a.x + time * da.x;
          a.y = a.y + time * da.y;
          a.z = a.z + time * da.z;
          a.w = a.w + time * da.w;
          c.x = c.x + time * dc.x;
          c.y = c.y + time * dc.y;
          c.z = c.z + time * dc.z;
          c.w = c.w + time * dc.w;
          g.x = g.x + time * dg.x;
        }
        float t;
        const bool ok =
            dr::mt_test(r, a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w, g.x, &t);
        if (ok && dr::nearer(t, t_best, prim)) {
          t_best = t;
          prim = base + j;
          if (any_lane) {  // first blocker is enough
            sp = 0;
            break;
          }
        }
      }
    }
  }
  t_out[i] = prim >= 0 ? t_best : inf;
  prim_out[i] = prim;
}

template <bool MOTION>
int launch(const void* wbounds, const void* worder, const void* soup,
           const void* soupd, const void* ox, const void* oy, const void* oz,
           const void* dx, const void* dy, const void* dz, const void* tmin,
           const void* tmax, const void* anyf, const void* time, void* t_out,
           void* prim_out, void* overflow, int n, int n_wnodes, int k,
           int mode, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + BLOCK_THREADS - 1) / BLOCK_THREADS;
  traverse6_kernel<MOTION>
      <<<blocks, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
          (const float4*)wbounds, (const int4*)worder, (const float4*)soup,
          (const float4*)soupd, (const float*)ox, (const float*)oy,
          (const float*)oz, (const float*)dx, (const float*)dy,
          (const float*)dz, (const float*)tmin, (const float*)tmax,
          (const float*)anyf, (const float*)time, (float*)t_out,
          (int*)prim_out, (int*)overflow, n, n_wnodes, k, mode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-thread stack entries; the Python wrapper's plain version uses the same.
int traverse6_stack_depth() { return STACK_DEPTH; }

// Launch on `stream`; returns cudaGetLastError() (0 = launched). Pointers are
// device pointers; `anyf` may be null unless mode == MODE_MIXED; `overflow`
// is one int32 the kernel ORs 1 into when a ray's stack was full.
int traverse6_launch(const void* wbounds, const void* worder, const void* soup,
                     const void* ox, const void* oy, const void* oz,
                     const void* dx, const void* dy, const void* dz,
                     const void* tmin, const void* tmax, const void* anyf,
                     void* t_out, void* prim_out, void* overflow, int n,
                     int n_wnodes, int k, int mode, void* stream) {
  return launch<false>(wbounds, worder, soup, nullptr, ox, oy, oz, dx, dy, dz,
                       tmin, tmax, anyf, nullptr, t_out, prim_out, overflow, n,
                       n_wnodes, k, mode, stream);
}

// The moving-geometry instantiation: `soupd` is the (C K, 16) delta table in
// soup16's row layout (id column zero), `time` the rays' shutter times in
// [0, 1].
int traverse6_motion_launch(const void* wbounds, const void* worder,
                            const void* soup, const void* soupd,
                            const void* ox, const void* oy, const void* oz,
                            const void* dx, const void* dy, const void* dz,
                            const void* tmin, const void* tmax,
                            const void* anyf, const void* time, void* t_out,
                            void* prim_out, void* overflow, int n,
                            int n_wnodes, int k, int mode, void* stream) {
  return launch<true>(wbounds, worder, soup, soupd, ox, oy, oz, dx, dy, dz,
                      tmin, tmax, anyf, time, t_out, prim_out, overflow, n,
                      n_wnodes, k, mode, stream);
}

}  // extern "C"
