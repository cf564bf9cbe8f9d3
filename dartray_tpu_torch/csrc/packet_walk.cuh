// packet_walk.cuh — the PACKET walk over the wide BVH that traverse5.cu (v5)
// and traverse7.cu (v7) share, written for the H100; they differ only in the
// leaf test and the fold they plug in.
//
// The walk. A packet of rays shares ONE stack; on this card the packet is a
// warp of 32 consecutive lanes. The packet's majority octant (`__ballot_sync`
// + `__popc` per axis, counted over all 32 lanes, dead pad lanes included)
// selects the far-first push-order rows. A node step pops one entry: each
// live lane slab-tests the 8 children of a popped node for its own ray, the
// lanes' hit masks are ORed (`__reduce_or_sync`), and a child is pushed when
// ANY live lane hits its box; a popped leaf cluster is tested by EVERY live
// lane, and a lane keeps the nearest accepted t (`nearer`: t < t_best, or
// t == t_best while it has no winner yet; the first slot of equal t). A full
// stack drops the push and ORs a device flag. Any-hit: a lane takes the
// first accepted slot and stops testing, and the packet ends once no live
// lane is without a blocker. Lanes past the end of the wave are padded as
// dead lanes (o = 0, d = 1, tmax < tmin) and stay in the warp's collectives;
// every branch around a collective depends on packet-uniform values only.
// The plain version (`_packet_plain` in ops/traverse_cuda.py) walks the same
// packets, so raw (t, prim) and the counters equal it on every lane.
//
// What bounds it on this card. A packet walks the UNION of its lanes' walks:
// on the bench scene's camera wave the heaviest packets pop 24 interior
// nodes and 38 leaves, on sorted incoherent rays 118 and 71 (medians 2 and
// 1), and a launch takes about as long as its heaviest packets' chains.
// Most of a chain is its leaves: every live lane folds the cluster's K
// triangles, and each test used to wait for its own rows from L2, requested
// by nobody before. So:
//
//  * The popped leaf staged. When the top of the stack is a leaf at the end
//    of a step, the warp's lanes start `cp.async` copies of its K rows (48
//    bytes a triangle) into the packet's slot of dynamic shared memory (1.5
//    KB at K = 32, 6 KB at K = 128); the leaf step waits for them once,
//    behind one `__syncwarp`, and every lane folds from shared memory (a
//    broadcast read). The largest single step.
//  * The lane's fold is the leaf's own (traverse5.cu: four slots a round,
//    around a divide without a branch; traverse7.cu: the next row read
//    before the current test, rows that can never hit skipped).
//  * Leaves by the warp. A leaf that at most PACKET_TMAX live lanes test is
//    served one ray at a time: lane j tests slot j and the warp folds the 32
//    results as the sequential loop would. Any-hit packets lose lanes as
//    they find blockers; otherwise every lane loops for itself.
//  * The order row read with the box row, not after the slab test.
//  * A minimum of one block an SM in `__launch_bounds__` (105-108
//    registers): with the block size alone ptxas held the walk to 64-80
//    registers, which spilled or ran 2-7 % slower.
//
// Measured and left out (tools/compare_traverse6.py, each alone against the
// earlier kernel and in combinations; PERF.md has the numbers): the stack
// in registers across the lanes (level to 5 % slower); a second slot, so
// that the next leaf on the stack copies while a leaf folds (level or
// slower); L1 prefetches of a node's children and of its pushed leaves'
// rows (4-30 % slower); 5 or 6 blocks an SM (slower); PACKET_TMAX 0 or 16
// (8 is best or level).

#pragma once

#include "leaf_fold.cuh"

#define PACKET_BLOCK_THREADS 128
#define PACKET_WIDTH WARP_LANES
#define PACKET_TMAX 8  // a leaf that at most this many live lanes test

namespace dr {

// The whole warp folds ONE ray `q` (the same in every lane) over a staged
// cluster into (best, winner), as the sequential loop would: lane j tests
// slot c0 + j of each round of 32 slots. Closest: every candidate of a
// round is held to `nearer` against the best of the rounds before, the
// least t wins (an integer `__reduce_min_sync` over an order-preserving
// key) and the lowest slot among equal t (a ballot). Any-hit: the lowest
// accepted slot. Pad and degenerate rows never hit.
template <class Leaf>
__device__ __forceinline__ void packet_fold_warp(const float4* rows, int base,
                                                 int k, int lane, const Ray& q,
                                                 bool any_hit, float& best,
                                                 int& winner) {
  for (int c0 = 0; c0 < k; c0 += WARP_LANES) {
    const int j = c0 + lane;
    float t = 0.0f;
    const bool accept =
        j < k && Leaf::hit(q, load_tri<true>(rows + STAGED_ROW * j), &t) &&
        nearer(t, best, winner);
    const unsigned acc = __ballot_sync(FULL_MASK, accept);
    if (acc == 0u) continue;
    int slot;
    if (any_hit) {
      slot = __ffs(acc) - 1;
    } else {
      const unsigned key = accept ? order_key(t) : 0xffffffffu;
      const unsigned least = __reduce_min_sync(FULL_MASK, key);
      slot = __ffs(__ballot_sync(FULL_MASK, accept && key == least)) - 1;
    }
    best = __shfl_sync(FULL_MASK, t, slot);
    winner = base + c0 + slot;
    if (any_hit) break;
  }
}

// The lanes in `testers` fold a staged cluster (`rows`, STAGED_ROW float4 a
// slot; `base`: cluster * k, the prim id of slot 0) into their (t_best,
// prim): one ray at a time by the whole warp when they are at most
// PACKET_TMAX, else each lane for itself. Executed by all 32 lanes.
template <class Leaf>
__device__ __forceinline__ void packet_leaf(unsigned testers, int lane,
                                            const float4* rows, int base,
                                            int k, const Ray& r, bool any_hit,
                                            float& t_best, int& prim) {
  if (__popc(testers) <= PACKET_TMAX) {
    for (unsigned todo = testers; todo != 0u; todo &= todo - 1u) {
      const int src = __ffs(todo) - 1;
      Ray q = r;  // the leaf tests read o, d and tmin only
      q.ox = __shfl_sync(FULL_MASK, r.ox, src);
      q.oy = __shfl_sync(FULL_MASK, r.oy, src);
      q.oz = __shfl_sync(FULL_MASK, r.oz, src);
      q.dx = __shfl_sync(FULL_MASK, r.dx, src);
      q.dy = __shfl_sync(FULL_MASK, r.dy, src);
      q.dz = __shfl_sync(FULL_MASK, r.dz, src);
      q.tmin = __shfl_sync(FULL_MASK, r.tmin, src);
      float best = __shfl_sync(FULL_MASK, t_best, src);
      int winner = __shfl_sync(FULL_MASK, prim, src);
      packet_fold_warp<Leaf>(rows, base, k, lane, q, any_hit, best, winner);
      if (lane == src) {
        t_best = best;
        prim = winner;
      }
    }
    return;
  }
  if ((testers >> lane) & 1u)
    Leaf::fold(rows, base, k, r, any_hit, t_best, prim);
}

// The warp's lanes start `cp.async` copies of the first STAGED_ROW float4
// of each of `cluster`'s k rows (STRIDE float4 a row in `table`) into
// `dst`, and commit them as one group.
template <int STRIDE>
__device__ __forceinline__ void stage_leaf(float4* dst,
                                           const float4* __restrict__ table,
                                           int cluster, int k, int lane) {
  for (int c = lane; c < STAGED_ROW * k; c += WARP_LANES)
    __pipeline_memcpy_async(
        dst + c,
        table + (size_t)(cluster * k + c / STAGED_ROW) * STRIDE +
            c % STAGED_ROW,
        sizeof(float4));
  __pipeline_commit();
}

// LeafTest is a struct passed by value with
//   static constexpr int STRIDE;  // float4 a row of `table`
//   const float4* table;          // (C K, STRIDE) float4
//   __device__ static bool hit(const Ray&, const TriRow&, float* t);
//   __device__ static void fold(const float4* rows, int base, int k,
//                               const Ray&, bool any_hit, float& t_best,
//                               int& prim);  // the lane's sequential fold
// Dynamic shared memory: PACKET_BLOCK_THREADS / PACKET_WIDTH * STAGED_ROW * k
// float4.
template <class LeafTest>
__global__ void __launch_bounds__(PACKET_BLOCK_THREADS, 1)
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
  extern __shared__ __align__(16) float4 staged_all[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % PACKET_WIDTH;
  const int packet = threadIdx.x / PACKET_WIDTH;
  int* stack = stacks[packet];
  float4* staged = staged_all + (size_t)packet * STAGED_ROW * k;
  const bool in = i < n;
  const float inf = __int_as_float(0x7f800000);
  const float tmin = in ? tmin_[i] : 0.0f;
  const float tmax = in ? tmax_[i] : -1.0f;
  const Ray r = make_ray(in ? ox_[i] : 0.0f, in ? oy_[i] : 0.0f,
                         in ? oz_[i] : 0.0f, in ? dx_[i] : 1.0f,
                         in ? dy_[i] : 1.0f, in ? dz_[i] : 1.0f, tmin);
  const bool alive = tmax >= tmin;
  constexpr int HALF = PACKET_WIDTH / 2;
  const int octant =
      (__popc(__ballot_sync(FULL_MASK, r.dx < 0.0f)) > HALF ? 1 : 0) +
      (__popc(__ballot_sync(FULL_MASK, r.dy < 0.0f)) > HALF ? 2 : 0) +
      (__popc(__ballot_sync(FULL_MASK, r.dz < 0.0f)) > HALF ? 4 : 0);
  const int4* order_rows = worder + (size_t)octant * n_wnodes * 2;

  int sp = 0;  // the same value in every lane of the packet
  if (__any_sync(FULL_MASK, alive)) {
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
      const int4* orow = order_rows + (size_t)ref * 2;
      const int4 e0 = __ldg(orow), e1 = __ldg(orow + 1);
      const unsigned mine =
          live ? slab8(wbounds + (size_t)ref * 12, r, t_best) : 0u;
      const unsigned mask = __reduce_or_sync(FULL_MASK, mine);
      if (mask != 0u) {
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
      // ---- leaf: its rows were started at the end of the step before
      ++n_leaves;
      __pipeline_wait_prior(0);
      __syncwarp();  // every lane's copies are in
      packet_leaf<LeafTest>(__ballot_sync(FULL_MASK, live), lane, staged,
                            (-ref - 1) * k, k, r, any_hit != 0, t_best, prim);
      __syncwarp();  // every lane has read the rows before they refill
      if (any_hit && !__any_sync(FULL_MASK, alive && prim < 0)) sp = 0;
    }
    // the next pop, if a leaf: its rows start now
    if (sp > 0 && stack[sp - 1] < 0)
      stage_leaf<LeafTest::STRIDE>(staged, leaf.table, -stack[sp - 1] - 1, k,
                                   lane);
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
// the first CUDA error (0 = launched).
template <class LeafTest>
int packet_launch(const void* wbounds, const void* worder, LeafTest leaf,
                  const void* ox, const void* oy, const void* oz,
                  const void* dx, const void* dy, const void* dz,
                  const void* tmin, const void* tmax, void* t_out,
                  void* prim_out, void* counters, void* overflow, int n,
                  int n_wnodes, int k, int any_hit, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + PACKET_BLOCK_THREADS - 1) / PACKET_BLOCK_THREADS;
  const int staged = PACKET_BLOCK_THREADS / PACKET_WIDTH * STAGED_ROW * k *
                     (int)sizeof(float4);
  if (staged > 48 * 1024) {  // past the default limit (k > 256)
    const int rc = (int)cudaFuncSetAttribute(
        packet_kernel<LeafTest>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        staged);
    if (rc != 0) return rc;
  }
  packet_kernel<LeafTest>
      <<<blocks, PACKET_BLOCK_THREADS, staged, (cudaStream_t)stream>>>(
          (const float4*)wbounds, (const int4*)worder, leaf, (const float*)ox,
          (const float*)oy, (const float*)oz, (const float*)dx,
          (const float*)dy, (const float*)dz, (const float*)tmin,
          (const float*)tmax, (float*)t_out, (int*)prim_out, (int*)counters,
          (int*)overflow, n, n_wnodes, k, any_hit);
  return (int)cudaGetLastError();
}

}  // namespace dr
