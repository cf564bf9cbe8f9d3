// block_walk.cuh — the BLOCK-packet walk over the binary cluster tree that
// traverse1.cu (v1) and traverse3.cu (v3) share, written for the H100. They
// replace the JAX reference's Pallas kernels `_kernel` and `_kernel3`
// (ops/kernels_attic.py) and differ only in what differs as a FUNCTION:
//
//   kernel  lanes sharing a stack     node table     fold     leaves
//   v1      128 (the thread block)    meta  (N, 4)   strict   tested at the pop
//   v3      128 (the thread block)    meta2 (N, 2)   packed   buffer of 16, flushed
//
// The function is binary_walk.cuh's walk (the warp packets v2 and v4 live
// there, with the constants and the fold conventions this header shares) on
// a packet of 128 lanes: pop order; the far child pushed first by the
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

#include <cuda_pipeline.h>

#include "binary_walk.cuh"

#define STAGED_ROW 3  // float4 of a staged triangle row (a soup16 row has 4)

namespace dr {

// the 48 bytes of a soup16 row a test reads: v0.xyz e1.x | e1.yz e2.xy |
// e2.z id_bits 0 0
struct TriRow {
  float4 a, c, g;
};

// SHARED: the rows are staged in shared memory (else soup16 in global)
template <bool SHARED>
__device__ __forceinline__ TriRow load_tri(const float4* p) {
  if (SHARED) return TriRow{p[0], p[1], p[2]};
  return TriRow{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__device__ __forceinline__ bool is_pad(const TriRow& w) {
  return __float_as_int(w.g.y) < 0;  // the id column: bits, never a number
}

__device__ __forceinline__ bool tri_hit(const Ray& r, const TriRow& w,
                                        float* t) {
  return mt_test(r, w.a.x, w.a.y, w.a.z, w.a.w, w.c.x, w.c.y, w.c.z, w.c.w,
                 w.g.x, t);
}

// One cluster against one lane's ray, folded into (t_best, prim) as
// `leaf_fold` does. `rows`: its first row, `stride` float4 a row; `base`:
// cluster * k, the prim id of slot 0. The row of slot j + 1 is on its way
// while slot j is tested.
template <bool PACKED, bool SHARED>
__device__ __forceinline__ void fold_by_lane(const float4* rows, int stride,
                                             int base, int k, const Ray& r,
                                             float& t_best, int& prim) {
  int kmin = 0x7fffffff;
  TriRow next = load_tri<SHARED>(rows);
  for (int j = 0; j < k; ++j) {
    const TriRow w = next;
    if (is_pad(w)) break;
    if (j + 1 < k) next = load_tri<SHARED>(rows + stride * (j + 1));
    float t;
    if (!tri_hit(r, w, &t)) continue;
    if (PACKED) {
      const int key = (__float_as_int(t) & ~IDX_MASK) | j;
      kmin = key < kmin ? key : kmin;
    } else if (t < t_best) {
      t_best = t;
      prim = base + j;
    }
  }
  if (PACKED) {
    // no accepted triangle leaves a NaN pattern here: never < t_best
    const float t_win = __int_as_float(kmin & ~IDX_MASK);
    if (t_win < t_best) {
      t_best = t_win;
      prim = base + (kmin & IDX_MASK);
    }
  }
}

// Order-preserving integer key of a float that is not NaN; -0 counts as +0.
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned u = __float_as_uint(t + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The whole warp folds ONE ray `q` (the same in every lane) over a cluster
// (`rows`, `stride`, `base` as in fold_by_lane) into (best, winner), as the
// sequential loop would: lane j tests slot c0 + j of each round of 32 slots.
// Strict: every candidate of a round is held against the best of the rounds
// before, the least t wins (an integer `__reduce_min_sync` over an
// order-preserving key) and the lowest slot among equal t (a ballot).
// Packed: the integer minimum of the keys is the sequential loop's, in any
// order. Pad slots trail and never count.
template <bool PACKED, bool SHARED>
__device__ __forceinline__ void fold_by_warp(const float4* rows, int stride,
                                             int base, int k, int lane,
                                             const Ray& q, float& best,
                                             int& winner) {
  int kmin = 0x7fffffff;
  for (int c0 = 0; c0 < k; c0 += WARP_LANES) {
    const int j = c0 + lane;
    bool ok = false;
    float t = 0.0f;
    if (j < k) {
      const TriRow w = load_tri<SHARED>(rows + stride * j);
      ok = !is_pad(w) && tri_hit(q, w, &t);
    }
    if (PACKED) {
      const int key = ok ? ((__float_as_int(t) & ~IDX_MASK) | j) : 0x7fffffff;
      const int least = __reduce_min_sync(FULL_MASK, key);
      kmin = least < kmin ? least : kmin;
    } else {
      const bool accept = ok && t < best;
      if (__ballot_sync(FULL_MASK, accept) == 0u) continue;
      const unsigned key = accept ? order_key(t) : 0xffffffffu;
      const unsigned least = __reduce_min_sync(FULL_MASK, key);
      const int slot =
          __ffs(__ballot_sync(FULL_MASK, accept && key == least)) - 1;
      best = __shfl_sync(FULL_MASK, t, slot);
      winner = base + c0 + slot;
    }
  }
  if (PACKED) {
    const float t_win = __int_as_float(kmin & ~IDX_MASK);
    if (t_win < best) {
      best = t_win;
      winner = base + (kmin & IDX_MASK);
    }
  }
}

// The lanes of this warp in `testers` fold one cluster (`rows`, `stride`,
// `base` as in fold_by_lane) into their (t_best, prim): one ray at a time by
// the whole warp when they are at most TMAX, else each lane for itself.
// Executed by all 32 lanes.
template <int TMAX, bool PACKED, bool SHARED>
__device__ __forceinline__ void warp_leaf(unsigned testers, int lane,
                                          const float4* rows, int stride,
                                          int base, int k, const Ray& r,
                                          float& t_best, int& prim) {
  if (__popc(testers) <= TMAX) {
    for (unsigned todo = testers; todo != 0u; todo &= todo - 1u) {
      const int src = __ffs(todo) - 1;
      Ray q = r;  // mt_test reads o, d and tmin only
      q.ox = __shfl_sync(FULL_MASK, r.ox, src);
      q.oy = __shfl_sync(FULL_MASK, r.oy, src);
      q.oz = __shfl_sync(FULL_MASK, r.oz, src);
      q.dx = __shfl_sync(FULL_MASK, r.dx, src);
      q.dy = __shfl_sync(FULL_MASK, r.dy, src);
      q.dz = __shfl_sync(FULL_MASK, r.dz, src);
      q.tmin = __shfl_sync(FULL_MASK, r.tmin, src);
      float best = __shfl_sync(FULL_MASK, t_best, src);
      int winner = __shfl_sync(FULL_MASK, prim, src);
      fold_by_warp<PACKED, SHARED>(rows, stride, base, k, lane, q, best,
                                   winner);
      if (lane == src) {
        t_best = best;
        prim = winner;
      }
    }
    return;
  }
  if ((testers >> lane) & 1u)
    fold_by_lane<PACKED, SHARED>(rows, stride, base, k, r, t_best, prim);
}

// Every thread of the block starts `cp.async` copies of its share of the
// first STAGED_ROW float4 of each of `cluster`'s k soup16 rows into `dst`.
__device__ __forceinline__ void stage_cluster(float4* dst,
                                              const float4* __restrict__ soup,
                                              int cluster, int k) {
  for (int c = threadIdx.x; c < STAGED_ROW * k; c += BINARY_BLOCK_THREADS)
    __pipeline_memcpy_async(
        dst + c, soup + (size_t)(cluster * k + c / STAGED_ROW) * 4 +
                     c % STAGED_ROW, sizeof(float4));
  __pipeline_commit();
}

// A node's box and meta row, as the walk reads them.
struct NodeRow {
  float4 b0, b1;  // lo.xyz hi.x | hi.yz 0 0
  int c0, c1, axis;  // c0 < 0: a leaf, cluster -c0 - 1
};

template <bool COMPACT>
__device__ __forceinline__ NodeRow load_node(const float4* __restrict__ bounds,
                                             const int* __restrict__ meta,
                                             int node) {
  NodeRow n;
  n.b0 = __ldg(bounds + (size_t)node * 2);
  n.b1 = __ldg(bounds + (size_t)node * 2 + 1);
  if (COMPACT) {
    const int2 m = __ldg((const int2*)meta + node);
    n.c0 = m.x < 0 ? m.x : m.x >> 2;
    n.axis = m.x & 3;
    n.c1 = m.y;
  } else {
    const int4 m = __ldg((const int4*)meta + node);
    n.c0 = m.x;
    n.c1 = m.y;
    n.axis = m.z;
  }
  return n;
}

// The slab test of one box against `r` clipped to [tmin, t_best].
__device__ __forceinline__ bool box_hit(const NodeRow& n, const Ray& r,
                                        float t_best) {
  const float t0x = (n.b0.x - r.ox) * r.ix, t1x = (n.b0.w - r.ox) * r.ix;
  const float t0y = (n.b0.y - r.oy) * r.iy, t1y = (n.b1.x - r.oy) * r.iy;
  const float t0z = (n.b0.z - r.oz) * r.iz, t1z = (n.b1.y - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fmaxf(fminf(t0z, t1z), r.tmin));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fminf(fmaxf(t0z, t1z), t_best));
  return tn <= tf;
}

// LBUF: leaf-buffer entries (0: a hit leaf is tested at the pop).
// COMPACT: node table meta2 (N, 2) instead of meta (N, 4). PACKED: the
// index-packed fold. TMAX: see warp_leaf. Dynamic shared memory:
// LBUF * STAGED_ROW * k float4. At least one block an SM: given only the
// block size, ptxas held v1 / v3 to 64 / 72 registers and spilled 24 / 52
// bytes, 4-17 % slower than with the 70 / 89 registers they take.
template <int LBUF, bool COMPACT, bool PACKED, int TMAX>
__global__ void __launch_bounds__(BINARY_BLOCK_THREADS, 1)
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
  constexpr int HALF = BINARY_BLOCK_THREADS / 2;
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
          stage_cluster(staged + nlb * STAGED_ROW * k, soup, -nd.c0 - 1, k);
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
  const int blocks = (n + BINARY_BLOCK_THREADS - 1) / BINARY_BLOCK_THREADS;
  const int staged = LBUF * STAGED_ROW * k * (int)sizeof(float4);
  if (staged > 48 * 1024) {  // past the default limit (k > 64)
    const int rc = (int)cudaFuncSetAttribute(
        block_kernel<LBUF, COMPACT, PACKED, TMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, staged);
    if (rc != 0) return rc;
  }
  block_kernel<LBUF, COMPACT, PACKED, TMAX>
      <<<blocks, BINARY_BLOCK_THREADS, staged, (cudaStream_t)stream>>>(
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
  int NAME##_packet_width() { return BINARY_BLOCK_THREADS; }                  \
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
