// binary_walk.cuh — the WARP-packet walk over the binary cluster tree that
// traverse2.cu (v2) and traverse4.cu (v4) share, written for the H100. They
// replace the JAX reference's Pallas kernels `_kernel2` and `_kernel4`
// (ops/kernels_attic.py) and differ only in what differs as a FUNCTION:
//
//   kernel  lanes sharing a stack     node table     fold     leaves
//   v2       32 (a warp)              meta  (N, 4)   strict   buffer of 8, flushed
//   v4       32 (a warp)              meta2 (N, 2)   packed   buffer of 8, flushed
//
// The walk. A packet starts with the root on its stack. A node step pops one
// node and slab-tests THAT node's box for every live lane (the test is at the
// pop: children are pushed unseen, and a step counts whether or not the box
// was hit). If any live lane hits an interior node, its far child and then
// its near child are pushed; near and far follow the packet's MAJORITY
// direction sign on the node's split axis, counted over every lane of the
// packet, dead pad lanes included. A hit leaf's cluster id goes to the
// packet's leaf buffer; node steps go on until the stack is empty or the
// buffer is full, then a flush tests the buffered clusters in buffer order on
// every live lane. Any-hit: a lane with a blocker stops testing, and the
// packet ends once no live lane is without one; within the leaf that blocks
// it a lane still folds over all K triangles, so its t is the nearest blocker
// of that cluster. The folds (strict, packed) and the leaf pieces this walk
// shares with the block packets v1 / v3 (block_walk.cuh) are in
// leaf_fold.cuh. The plain version (`_binary_plain` in ops/traverse_cuda.py)
// walks the same packets, so raw (t, prim) equal it on every lane.
//
// What bounds it on this card. A packet walks the UNION of 32 rays' walks: on
// the bench scene's incoherent rays a median packet takes a dozen node steps
// and the heaviest several hundred, and a wave's time is set by those
// heaviest packets' chains. The flush is the longer part of that chain:
// every live lane folds up to 8 clusters of K triangles, and each test used
// to wait for its own row from L2, requested by nobody before. So:
//
//  * The buffered clusters staged. As a leaf is buffered, the warp's lanes
//    start `cp.async` copies of their share of its rows into the packet's
//    part of dynamic shared memory (48 of each row's 64 bytes; 12 KB a
//    packet at K = 32); the copies overlap the node steps that follow, and
//    the flush waits for them once, behind one `__syncwarp`, and reads
//    shared memory. The largest single step (1.6-2.1 times alone).
//  * The next triangle row read before the current test.
//  * Leaves by the warp. A flush cluster that at most TMAX live lanes test
//    is served one ray at a time: lane j tests slot j and the warp folds the
//    32 results as the sequential loop would (`fold_by_warp`). Any-hit
//    packets lose lanes as they find blockers; otherwise every lane loops
//    for itself.
//  * The next node's rows fetched early: at the end of a step every lane
//    knows the next pop (the near child just pushed, else the top of the
//    stack) and starts its box and meta rows, so the pop finds them loaded.
//  * The stack and the leaf buffer in registers. Both are packet-uniform:
//    stack entry e lives in lane e % 32 (slot e / 32 of three), buffer entry
//    q in lane q, and a read is one `__shfl_sync` from the lane that holds
//    it, so a node step touches no shared memory and needs no `__syncwarp`.
//  * A minimum of one block an SM in `__launch_bounds__`: with the block
//    size alone ptxas held v2 to 48 registers and spilled.
//
// Measured and left out (tools/compare_traverse6.py, each alone against the
// earlier kernel and in combinations; PERF.md has the numbers): fetching
// both candidates for the next pop (the near child and the top of the
// stack) at the START of a step, before the box test (more registers, level
// or slower); 1 or 2 packets a block in place of 4 (level or up to 5 %
// slower: a warp's staged rows, not the block, set how many are resident);
// TMAX 0 / 4 / 16 (8 is best or level on every row; 0 loses 19-25 % on v4);
// the stack and the buffer in shared memory behind `__syncwarp`s (1-5 %
// slower, with 2 packets a block; with 4 and the staged rows the card
// refused the launch, CUDA error 1).
//
// No lane leaves early: lanes past the end of the wave are padded as dead
// lanes (o = 0, d = 1, tmax < tmin) and stay in, as do lanes that are done;
// every branch around a warp collective depends on packet-uniform values
// only. A full stack drops the push and ORs a device flag.
//
// What has no counterpart here, because it is a shape of the reference's
// machine and not of the function: the (rows, 128) ray tiles, the sentinel
// null node and null cluster that keep its lockstep packets branch-free, the
// spill round-trip that turns the majority count into scalars, and the
// SMEM-or-VMEM placement of meta2. The triangle operand is the soup16 row
// table (48 B a triangle read), not nine (C, K) component planes.

#pragma once

#include "leaf_fold.cuh"

#define WARP_WALK_PACKETS 4  // warp packets a thread block
#define WARP_WALK_THREADS (WARP_LANES * WARP_WALK_PACKETS)

namespace dr {

// A packet-uniform stack of STACK_DEPTH entries held in registers: entry e
// in lane e % 32, slot e / 32. Every lane calls read and write with the same
// arguments.
struct LaneStack {
  static_assert(STACK_DEPTH == 3 * WARP_LANES, "three slots a lane");
  int s0 = 0, s1 = 0, s2 = 0;

  __device__ __forceinline__ int read(int e) const {
    const int slot = e >> 5;  // e / 32 and e % 32 of an e >= 0
    const int v = slot == 0 ? s0 : (slot == 1 ? s1 : s2);
    return __shfl_sync(FULL_MASK, v, e & 31);
  }
  __device__ __forceinline__ void write(int lane, int e, int value) {
    if (lane != (e & 31)) return;
    const int slot = e >> 5;
    if (slot == 0)
      s0 = value;
    else if (slot == 1)
      s1 = value;
    else
      s2 = value;
  }
};

// LBUF: leaf-buffer entries. COMPACT: node table meta2 (N, 2) instead of
// meta (N, 4). PACKED: the index-packed fold. TMAX: see warp_leaf. Dynamic
// shared memory: WARP_WALK_PACKETS * LBUF * STAGED_ROW * k float4.
template <int LBUF, bool COMPACT, bool PACKED, int TMAX>
__global__ void __launch_bounds__(WARP_WALK_THREADS, 1)
warp_kernel(const float4* __restrict__ bounds,  // (N, 2) float4
            const int* __restrict__ meta,       // (N, 4) or (N, 2) i32
            const float4* __restrict__ soup,    // (C K, 4) float4
            const float* __restrict__ ox_, const float* __restrict__ oy_,
            const float* __restrict__ oz_, const float* __restrict__ dx_,
            const float* __restrict__ dy_, const float* __restrict__ dz_,
            const float* __restrict__ tmin_, const float* __restrict__ tmax_,
            float* __restrict__ t_out, int* __restrict__ prim_out,
            int* __restrict__ counters,  // (packets, 2) or null
            int* __restrict__ overflow, int n, int k, int any_hit) {
  static_assert(LBUF <= WARP_LANES, "one buffer entry a lane");
  extern __shared__ __align__(16) float4 staged_all[];
  float4* staged =
      staged_all + (size_t)(threadIdx.x / WARP_LANES) * LBUF * STAGED_ROW * k;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % WARP_LANES;
  const bool in = i < n;
  const float inf = __int_as_float(0x7f800000);
  const float tmin = in ? tmin_[i] : 0.0f;
  const float tmax = in ? tmax_[i] : -1.0f;
  const Ray r = make_ray(in ? ox_[i] : 0.0f, in ? oy_[i] : 0.0f,
                         in ? oz_[i] : 0.0f, in ? dx_[i] : 1.0f,
                         in ? dy_[i] : 1.0f, in ? dz_[i] : 1.0f, tmin);
  const bool alive = tmax >= tmin;
  constexpr int HALF = WARP_LANES / 2;
  const bool negx = __popc(__ballot_sync(FULL_MASK, r.dx < 0.0f)) > HALF;
  const bool negy = __popc(__ballot_sync(FULL_MASK, r.dy < 0.0f)) > HALF;
  const bool negz = __popc(__ballot_sync(FULL_MASK, r.dz < 0.0f)) > HALF;

  float t_best = alive ? tmax : -inf;
  int prim = -1;
  // packet-uniform: the same value in every lane
  LaneStack stack;  // entry 0, the root, is node 0
  int lbuf = 0;     // leaf-buffer entry `lane`
  int sp = 1, nlb = 0, n_steps = 0, n_leaves = 0;
  // an any-hit packet ends once no live lane lacks a blocker
  bool done = any_hit && !__any_sync(FULL_MASK, alive);
  NodeRow next = load_node<COMPACT>(bounds, meta, 0);  // the next pop's rows

  while ((sp > 0 || nlb > 0) && !done) {
    if (sp > 0 && nlb < LBUF) {
      // ---- node step: pop, test the POPPED node's box, push or keep
      ++n_steps;
      --sp;  // its rows are in `next`
      const NodeRow nd = next;
      const bool live = alive && !(any_hit && prim >= 0);
      const bool hit = live && box_hit(nd, r, t_best);
      bool pushed = false;
      int near = 0;
      if (__any_sync(FULL_MASK, hit)) {
        if (nd.c0 >= 0) {
          // interior: far first, so the near child pops first
          const bool neg = nd.axis == 0 ? negx : (nd.axis == 1 ? negy : negz);
          if (sp + 2 <= STACK_DEPTH) {
            near = neg ? nd.c1 : nd.c0;
            stack.write(lane, sp, neg ? nd.c0 : nd.c1);
            stack.write(lane, sp + 1, near);
            sp += 2;
            pushed = true;
          } else if (lane == 0) {
            atomicOr(overflow, 1);
          }
        } else {
          const int cluster = -nd.c0 - 1;
          if (lane == nlb) lbuf = cluster;
          stage_cluster<WARP_LANES>(staged + nlb * STAGED_ROW * k, soup,
                                    cluster, k, lane);
          ++nlb;
        }
      }
      // the next pop: the near child just pushed, else the top of the stack
      if (pushed)
        next = load_node<COMPACT>(bounds, meta, near);
      else if (sp > 0)
        next = load_node<COMPACT>(bounds, meta, stack.read(sp - 1));
    } else {
      // ---- flush: the buffered clusters, in buffer order, on live lanes
      __pipeline_wait_prior(0);
      __syncwarp();  // every lane's staged rows are in
      for (int q = 0; q < nlb; ++q) {
        const int cluster = __shfl_sync(FULL_MASK, lbuf, q);
        const bool live = alive && !(any_hit && prim >= 0);
        warp_leaf<TMAX, PACKED, true>(__ballot_sync(FULL_MASK, live), lane,
                                      staged + q * STAGED_ROW * k, STAGED_ROW,
                                      cluster * k, k, r, t_best, prim);
      }
      n_leaves += nlb;
      nlb = 0;
      __syncwarp();  // every lane has read the staged rows before they refill
      if (any_hit) done = !__any_sync(FULL_MASK, alive && prim < 0);
    }
  }
  if (in) {
    t_out[i] = prim >= 0 ? t_best : inf;
    prim_out[i] = prim;
  }
  if (counters != nullptr && lane == 0 && in) {  // lane 0 in: a real packet
    counters[2 * (i / WARP_LANES)] = n_steps;
    counters[2 * (i / WARP_LANES) + 1] = n_leaves;
  }
}

// Launch one thread per lane of ceil(n / WARP_WALK_THREADS) thread blocks on
// `stream`; returns the first CUDA error (0 = launched).
template <int LBUF, bool COMPACT, bool PACKED, int TMAX>
int warp_launch(const void* bounds, const void* meta, const void* soup,
                const void* ox, const void* oy, const void* oz,
                const void* dx, const void* dy, const void* dz,
                const void* tmin, const void* tmax, void* t_out,
                void* prim_out, void* counters, void* overflow, int n, int k,
                int any_hit, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + WARP_WALK_THREADS - 1) / WARP_WALK_THREADS;
  const int staged =
      WARP_WALK_PACKETS * LBUF * STAGED_ROW * k * (int)sizeof(float4);
  if (staged > 48 * 1024) {  // past the default limit (k > 32)
    const int rc = (int)cudaFuncSetAttribute(
        warp_kernel<LBUF, COMPACT, PACKED, TMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, staged);
    if (rc != 0) return rc;
  }
  warp_kernel<LBUF, COMPACT, PACKED, TMAX>
      <<<blocks, WARP_WALK_THREADS, staged, (cudaStream_t)stream>>>(
          (const float4*)bounds, (const int*)meta, (const float4*)soup,
          (const float*)ox, (const float*)oy, (const float*)oz,
          (const float*)dx, (const float*)dy, (const float*)dz,
          (const float*)tmin, (const float*)tmax, (float*)t_out,
          (int*)prim_out, (int*)counters, (int*)overflow, n, k, any_hit);
  return (int)cudaGetLastError();
}

}  // namespace dr

// The C interface of one instantiation: `NAME_launch` and the three constants
// the Python wrapper checks against its own.
#define BINARY_WALK_ENTRY(NAME, LBUF, COMPACT, PACKED, TMAX)                  \
  extern "C" {                                                                \
  int NAME##_stack_depth() { return STACK_DEPTH; }                            \
  int NAME##_packet_width() { return WARP_LANES; }                            \
  int NAME##_leaf_buffer() { return LBUF; }                                   \
  int NAME##_launch(const void* bounds, const void* meta, const void* soup,   \
                    const void* ox, const void* oy, const void* oz,           \
                    const void* dx, const void* dy, const void* dz,           \
                    const void* tmin, const void* tmax, void* t_out,          \
                    void* prim_out, void* counters, void* overflow, int n,    \
                    int k, int any_hit, void* stream) {                       \
    return dr::warp_launch<LBUF, COMPACT, PACKED, TMAX>(                      \
        bounds, meta, soup, ox, oy, oz, dx, dy, dz, tmin, tmax, t_out,        \
        prim_out, counters, overflow, n, k, any_hit, stream);                 \
  }                                                                           \
  }
