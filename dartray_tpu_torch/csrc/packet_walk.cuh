// packet_walk.cuh — the PACKET walk over the wide BVH that traverse5.cu and
// traverse7.cu share; they differ only in the leaf test they plug in.
//
// What sets it apart from traverse6.cu (one stack per ray): a packet of rays
// shares ONE stack. On this card the packet is a warp of 32 consecutive
// lanes. The packet's majority octant (`__ballot_sync` + `__popc` per axis,
// counted over all 32 lanes) selects the far-first push-order rows; each live
// lane slab-tests the 8 children of the popped node for its own ray, the
// lanes' hit masks are ORed (`__reduce_or_sync`), and a child is pushed when
// ANY live lane hits its box; a popped leaf cluster is tested by EVERY live
// lane. The stack lives in shared memory (lane 0 writes, `__syncwarp`
// orders the writes against the reads), guarded like the per-ray one: a full
// stack drops the push and ORs a device flag. Any-hit: a lane that has a
// blocker stops testing, and the packet ends once no live lane is without
// one. Lanes past the end of the wave are padded as dead lanes (o = 0,
// d = 1, tmax < tmin) and stay in the warp's collectives.
//
// What bounds it: like the per-ray walk, the chain of dependent table
// fetches; a packet visits the UNION of its lanes' walks, so coherent rays
// (a camera wave) share their fetches across the warp without divergence,
// while incoherent rays make every lane test every leaf any lane reaches.
//
// LeafTest is a struct passed by value with
//   __device__ void test(int cluster, int k, const dr::Ray&, bool any_hit,
//                        float* t_best, int* prim) const;

#pragma once

#include "ray_tests.cuh"

#define PACKET_BLOCK_THREADS 128
#define PACKET_WIDTH 32

namespace dr {

template <class LeafTest>
__global__ void __launch_bounds__(PACKET_BLOCK_THREADS)
packet_kernel(const float4* __restrict__ wbounds,  // (W, 12) float4
              const int4* __restrict__ worder,     // (8 W, 2) int4
              const LeafTest leaf,
              const float* __restrict__ ox_, const float* __restrict__ oy_,
              const float* __restrict__ oz_, const float* __restrict__ dx_,
              const float* __restrict__ dy_, const float* __restrict__ dz_,
              const float* __restrict__ tmin_,
              const float* __restrict__ tmax_, float* __restrict__ t_out,
              int* __restrict__ prim_out,
              int* __restrict__ counters,  // (packets, 2) or null
              int* __restrict__ overflow, int n, int n_wnodes, int k,
              int any_hit) {
  __shared__ int stacks[PACKET_BLOCK_THREADS / PACKET_WIDTH][STACK_DEPTH];
  const unsigned full = 0xffffffffu;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & (PACKET_WIDTH - 1);
  int* stack = stacks[threadIdx.x / PACKET_WIDTH];
  const bool in = i < n;
  const float inf = __int_as_float(0x7f800000);
  const float tmin = in ? tmin_[i] : 0.0f;
  const float tmax = in ? tmax_[i] : -1.0f;
  const Ray r = make_ray(in ? ox_[i] : 0.0f, in ? oy_[i] : 0.0f,
                         in ? oz_[i] : 0.0f, in ? dx_[i] : 1.0f,
                         in ? dy_[i] : 1.0f, in ? dz_[i] : 1.0f, tmin);
  const bool alive = tmax >= tmin;
  const int half = PACKET_WIDTH / 2;
  const int octant =
      (__popc(__ballot_sync(full, r.dx < 0.0f)) > half ? 1 : 0) +
      (__popc(__ballot_sync(full, r.dy < 0.0f)) > half ? 2 : 0) +
      (__popc(__ballot_sync(full, r.dz < 0.0f)) > half ? 4 : 0);
  const int4* order_rows = worder + (size_t)octant * n_wnodes * 2;

  int sp = 0;  // the same value in every lane of the packet
  if (__any_sync(full, alive)) {
    if (lane == 0) stack[0] = 0;  // root wide node
    sp = 1;
  }
  __syncwarp();
  float t_best = tmax;
  int prim = -1;
  int n_steps = 0, n_leaves = 0;

  while (sp > 0) {
    const int ref = stack[--sp];
    __syncwarp();  // every lane has read the top before lane 0 pushes over it
    const bool live = alive && !(any_hit && prim >= 0);
    if (ref >= 0) {
      // ---- interior: each live lane slab-tests the 8 children for its ray
      ++n_steps;
      const unsigned mine =
          live ? slab8(wbounds + (size_t)ref * 12, r, t_best) : 0u;
      const unsigned mask = __reduce_or_sync(full, mine);
      if (mask != 0u) {
        const int4* orow = order_rows + (size_t)ref * 2;
        const int4 e0 = __ldg(orow), e1 = __ldg(orow + 1);
        const int ent[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // far first, so near pops first
          const int e = ent[j];
          if ((mask >> (e & 7)) & 1u) {
            if (sp < STACK_DEPTH) {
              if (lane == 0) stack[sp] = e >> 3;  // ref < 0 is a leaf
              ++sp;
            } else if (lane == 0) {
              atomicOr(overflow, 1);
            }
          }
        }
      }
      __syncwarp();  // lane 0's pushes are visible to the next pop
    } else {
      // ---- leaf: every live lane tests the cluster's triangles
      ++n_leaves;
      if (live) leaf.test(-ref - 1, k, r, any_hit != 0, &t_best, &prim);
      if (any_hit && !__any_sync(full, alive && prim < 0)) sp = 0;
    }
  }
  if (in) {
    t_out[i] = prim >= 0 ? t_best : inf;
    prim_out[i] = prim;
  }
  if (counters != nullptr && lane == 0 && in) {  // lane 0 in: a real packet
    counters[2 * (i / PACKET_WIDTH)] = n_steps;
    counters[2 * (i / PACKET_WIDTH) + 1] = n_leaves;
  }
}

// Launch one thread per lane of ceil(n / 32) packets on `stream`; returns
// cudaGetLastError() (0 = launched).
template <class LeafTest>
int packet_launch(const void* wbounds, const void* worder, LeafTest leaf,
                  const void* ox, const void* oy, const void* oz,
                  const void* dx, const void* dy, const void* dz,
                  const void* tmin, const void* tmax, void* t_out,
                  void* prim_out, void* counters, void* overflow, int n,
                  int n_wnodes, int k, int any_hit, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + PACKET_BLOCK_THREADS - 1) / PACKET_BLOCK_THREADS;
  packet_kernel<LeafTest>
      <<<blocks, PACKET_BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
          (const float4*)wbounds, (const int4*)worder, leaf, (const float*)ox,
          (const float*)oy, (const float*)oz, (const float*)dx,
          (const float*)dy, (const float*)dz, (const float*)tmin,
          (const float*)tmax, (float*)t_out, (int*)prim_out, (int*)counters,
          (int*)overflow, n, n_wnodes, k, any_hit);
  return (int)cudaGetLastError();
}

}  // namespace dr
