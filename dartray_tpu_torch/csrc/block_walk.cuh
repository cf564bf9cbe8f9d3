// block_walk.cuh — the BLOCK-packet walk over the binary cluster tree that
// traverse1.cu (v1) and traverse3.cu (v3) share, written for the H100. They
// replace the JAX reference's Pallas kernels `_kernel` and `_kernel3`
// (ops/kernels_attic.py) and differ only in what differs as a FUNCTION:
//
//   kernel  lanes sharing a stack     node table     fold     leaves
//   v1      128 (the thread block)    meta  (N, 4)   strict   tested at the pop
//   v3      128 (the thread block)    meta2 (N, 2)   packed   buffer of 16, flushed
//
// The function is binary_walk.cuh's walk (the warp packets v2 and v4) on a
// packet of 128 lanes; the folds and the leaf pieces both walks use are in
// leaf_fold.cuh: pop order; the far child pushed first by the
// packet's majority sign over all 128 lanes, dead pads included; v1's leaf
// tested at the pop by the lanes that hit its box; v3's buffer of 16
// clusters flushed in buffer order on every live lane; a full stack that
// drops the push and ORs a device flag; the any-hit end rule. The plain
// version (`_binary_plain` in ops/traverse_cuda.py) walks the same packets,
// so raw (t, prim) and v3's counters equal it on every lane.
//
// What bounds it on this card. A packet walks the UNION of 128 rays' walks:
// on incoherent rays a median packet takes a dozen node steps and the
// heaviest over a thousand, with hundreds of leaf clusters, and a wave's
// time is set by those heaviest packets' chains. The node steps are cheap
// next to the leaves: v1 tests a leaf with the few lanes of a warp that hit
// its box, each running K dependent triangle tests while the others wait,
// and v3's flush runs every live lane through up to 16 clusters of K tests,
// each behind a row fetch from L2. So the design works on the leaves first:
//
//  * Leaves by the warp. A warp in which at most TMAX lanes test a cluster
//    (16 for v1, 8 for v3: the best threshold measured for each kernel)
//    serves them one ray at a time: lane j tests slot j and the warp folds
//    the 32 results as the sequential loop would (`fold_by_warp`), so a
//    ray's leaf costs one triangle test, not K in a row. Otherwise every
//    lane loops for itself, the row of slot j + 1 fetched before slot j is
//    tested.
//  * v3's buffered clusters staged. As a leaf is buffered, every thread of
//    the block starts `cp.async` copies of its share of the cluster's rows
//    into shared memory (48 of each row's 64 bytes); the flush waits for
//    them behind one barrier and reads shared memory.
//  * The next node's rows fetched early. At the end of a step every lane
//    knows the next pop (the near child just pushed, else the top of the
//    stack, which no lane writes in that step) and starts its box and meta
//    rows before the step's last barrier, so the pop finds them loaded.
//
// Measured and left out (tools/compare_traverse6.py, each alone against the
// earlier kernel and in combinations; PERF.md has the numbers): a copy of
// the stack in every warp with the hits exchanged as ballots through shared
// memory, one barrier a step (level or slower, 63-87 registers); the
// barriers that order nothing once the next rows are fetched early (after
// the pop, at the end of a step, after a flush), each alone and all three
// (level or up to 5 % slower); more blocks resident through launch bounds
// (spills). So a node step keeps three barriers: one after the pop, the
// `__syncthreads_or` of the box hits and one after lane 0's push.
//
// No thread leaves early: lanes past the end of the wave are padded as dead
// lanes (o = 0, d = 1, tmax < tmin) and stay in, as do lanes that are done;
// every branch around a barrier depends on block-uniform values only, and
// every branch around a warp collective on warp-uniform values.

#pragma once

#include "leaf_fold.cuh"

#define BLOCK_THREADS 128  // lanes of a packet: the thread block

namespace dr {

// LBUF: leaf-buffer entries (0: a hit leaf is tested at the pop).
// COMPACT: node table meta2 (N, 2) instead of meta (N, 4). PACKED: the
// index-packed fold. TMAX: see warp_leaf. Dynamic shared memory:
// LBUF * STAGED_ROW * k float4. At least one block an SM: given only the
// block size, ptxas held v1 / v3 to 64 / 72 registers and spilled 24 / 52
// bytes, 4-17 % slower than with the 70 / 89 registers they take.
template <int LBUF, bool COMPACT, bool PACKED, int TMAX>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
block_kernel(const float4* __restrict__ bounds,  // (N, 2) float4
             const int* __restrict__ meta,       // (N, 4) or (N, 2) i32
             const float4* __restrict__ soup,    // (C K, 4) float4
             const float* __restrict__ ox_, const float* __restrict__ oy_,
             const float* __restrict__ oz_, const float* __restrict__ dx_,
             const float* __restrict__ dy_, const float* __restrict__ dz_,
             const float* __restrict__ tmin_, const float* __restrict__ tmax_,
             float* __restrict__ t_out, int* __restrict__ prim_out,
             int* __restrict__ counters,  // (packets, 2) or null
             int* __restrict__ overflow, int n, int k, int any_hit) {
  __shared__ int stack[STACK_DEPTH];
  __shared__ int lbuf[LBUF > 0 ? LBUF : 1];
  extern __shared__ __align__(16) float4 staged[];  // the buffered clusters
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
  constexpr int HALF = BLOCK_THREADS / 2;
  const bool negx = __syncthreads_count(r.dx < 0.0f) > HALF;
  const bool negy = __syncthreads_count(r.dy < 0.0f) > HALF;
  const bool negz = __syncthreads_count(r.dz < 0.0f) > HALF;

  float t_best = alive ? tmax : -inf;
  int prim = -1;
  // block-uniform: the same value in every lane
  int sp = 1, nlb = 0, n_steps = 0, n_leaves = 0;
  if (threadIdx.x == 0) stack[0] = 0;  // the root
  __syncthreads();
  // an any-hit packet ends once no live lane lacks a blocker
  bool done = any_hit && !__syncthreads_or(alive);
  NodeRow next = load_node<COMPACT>(bounds, meta, 0);  // the next pop's rows

  while ((sp > 0 || nlb > 0) && !done) {
    if (sp > 0 && (LBUF == 0 || nlb < LBUF)) {
      // ---- node step: pop, test the POPPED node's box, push or keep
      ++n_steps;
      --sp;  // its rows are in `next`
      __syncthreads();
      const NodeRow nd = next;
      const bool live = alive && !(any_hit && prim >= 0);
      const bool hit = live && box_hit(nd, r, t_best);
      const bool nhit = __syncthreads_or(hit) != 0;
      bool pushed = false;
      int near = 0;
      if (nhit) {
        if (nd.c0 >= 0) {
          // interior: far first, so the near child pops first
          const bool neg = nd.axis == 0 ? negx : (nd.axis == 1 ? negy : negz);
          if (sp + 2 <= STACK_DEPTH) {
            if (threadIdx.x == 0) {
              stack[sp] = neg ? nd.c0 : nd.c1;
              stack[sp + 1] = neg ? nd.c1 : nd.c0;
            }
            sp += 2;
            pushed = true;
            near = neg ? nd.c1 : nd.c0;
          } else if (threadIdx.x == 0) {
            atomicOr(overflow, 1);
          }
        } else if (LBUF == 0) {
          ++n_leaves;
          const int cluster = -nd.c0 - 1;
          warp_leaf<TMAX, PACKED, false>(__ballot_sync(FULL_MASK, hit), lane,
                                         soup + (size_t)cluster * k * 4, 4,
                                         cluster * k, k, r, t_best, prim);
          if (any_hit) done = !__syncthreads_or(alive && prim < 0);
        } else {
          if (threadIdx.x == 0) lbuf[nlb] = -nd.c0 - 1;
          stage_cluster<BLOCK_THREADS>(staged + nlb * STAGED_ROW * k, soup,
                                           -nd.c0 - 1, k, threadIdx.x);
          ++nlb;
        }
      }
      // the next pop: the near child just pushed, else the top of the
      // stack, which no lane writes in this step
      if (pushed)
        next = load_node<COMPACT>(bounds, meta, near);
      else if (sp > 0)
        next = load_node<COMPACT>(bounds, meta, stack[sp - 1]);
      __syncthreads();
    } else {
      // ---- flush: the buffered clusters, in buffer order, on live lanes
      __pipeline_wait_prior(0);
      __syncthreads();  // every thread's staged rows are in
      for (int q = 0; q < nlb; ++q) {
        const bool live = alive && !(any_hit && prim >= 0);
        warp_leaf<TMAX, PACKED, true>(__ballot_sync(FULL_MASK, live), lane,
                                      staged + q * STAGED_ROW * k, STAGED_ROW,
                                      lbuf[q] * k, k, r, t_best, prim);
      }
      n_leaves += nlb;
      nlb = 0;
      __syncthreads();  // every lane has read the buffer before it refills
      if (any_hit) done = !__syncthreads_or(alive && prim < 0);
    }
  }
  if (in) {
    t_out[i] = prim >= 0 ? t_best : inf;
    prim_out[i] = prim;
  }
  if (counters != nullptr && threadIdx.x == 0) {
    counters[2 * blockIdx.x] = n_steps;
    counters[2 * blockIdx.x + 1] = n_leaves;
  }
}

// Launch one thread per lane of ceil(n / 128) thread blocks on `stream`;
// returns the first CUDA error (0 = launched).
template <int LBUF, bool COMPACT, bool PACKED, int TMAX>
int block_launch(const void* bounds, const void* meta, const void* soup,
                 const void* ox, const void* oy, const void* oz,
                 const void* dx, const void* dy, const void* dz,
                 const void* tmin, const void* tmax, void* t_out,
                 void* prim_out, void* counters, void* overflow, int n, int k,
                 int any_hit, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + BLOCK_THREADS - 1) / BLOCK_THREADS;
  const int staged = LBUF * STAGED_ROW * k * (int)sizeof(float4);
  if (staged > 48 * 1024) {  // past the default limit (k > 64)
    const int rc = (int)cudaFuncSetAttribute(
        block_kernel<LBUF, COMPACT, PACKED, TMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, staged);
    if (rc != 0) return rc;
  }
  block_kernel<LBUF, COMPACT, PACKED, TMAX>
      <<<blocks, BLOCK_THREADS, staged, (cudaStream_t)stream>>>(
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
#define BLOCK_WALK_ENTRY(NAME, LBUF, COMPACT, PACKED, TMAX)                   \
  extern "C" {                                                                \
  int NAME##_stack_depth() { return STACK_DEPTH; }                            \
  int NAME##_packet_width() { return BLOCK_THREADS; }                         \
  int NAME##_leaf_buffer() { return LBUF; }                                   \
  int NAME##_launch(const void* bounds, const void* meta, const void* soup,   \
                    const void* ox, const void* oy, const void* oz,           \
                    const void* dx, const void* dy, const void* dz,           \
                    const void* tmin, const void* tmax, void* t_out,          \
                    void* prim_out, void* counters, void* overflow, int n,    \
                    int k, int any_hit, void* stream) {                       \
    return dr::block_launch<LBUF, COMPACT, PACKED, TMAX>(                     \
        bounds, meta, soup, ox, oy, oz, dx, dy, dz, tmin, tmax, t_out,        \
        prim_out, counters, overflow, n, k, any_hit, stream);                 \
  }                                                                           \
  }
