// binary_walk.cuh — the WARP-packet walk over the BINARY cluster tree that
// traverse2.cu and traverse4.cu share, and the per-lane leaf fold. They
// replace the JAX reference's Pallas kernels `_kernel2` and `_kernel4`
// (ops/kernels_attic.py) and differ only in what differs as a FUNCTION:
//
//   kernel  lanes sharing a stack     node table     fold     leaves
//   v2       32 (a warp)              meta  (N, 4)   strict   buffer of 8, flushed
//   v4       32 (a warp)              meta2 (N, 2)   packed   buffer of 8, flushed
//
// The block packets v1 and v3 (128 lanes, the thread block, share a stack)
// are the same walk on another packet; they live in block_walk.cuh, which
// includes this header for the constants and the fold convention. Every
// thread block has 128 threads and holds four independent warp packets.
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
// of that cluster.
//
// The folds. Strict: sequential, `t < t_best`, so the first of equal t wins
// and tmax itself is outside the interval. Packed: the key
// `(bits(t) & ~127) | slot` is minimised as an integer over the cluster, then
// `float(key & ~127)` is compared with `<` against a t_best that itself holds
// such rounded values: t is rounded DOWN by up to 127 ulps and the lowest
// slot wins a tie (K <= 128; t > tmin >= 0 makes the patterns order like the
// floats). Dead lanes carry t_best = -inf and never win.
//
// Shared state. Stack and leaf buffer live in shared memory; lane 0 of the
// warp writes them, and `__syncwarp` orders the writes against the reads.
// No lane leaves early: lanes past the end of the wave are padded as dead
// lanes (o = 0, d = 1, tmax < tmin) and stay in, as do lanes that are done;
// every branch around a collective depends on packet-uniform values only. A
// full stack drops the push and ORs a device flag.
//
// What bounds it: as the other walks, the chain of dependent table fetches,
// here one 32-byte box row per step against eight boxes per step in the wide
// tree.
//
// What has no counterpart here, because it is a shape of the reference's
// machine and not of the function: the (rows, 128) ray tiles, the sentinel
// null node and null cluster that keep its lockstep packets branch-free, the
// spill round-trip that turns the majority count into scalars, and the
// SMEM-or-VMEM placement of meta2. The triangle operand is the soup16 row
// table (48 B a triangle read), not nine (C, K) component planes.

#pragma once

#include "ray_tests.cuh"

#define BINARY_BLOCK_THREADS 128
#define WARP_LANES 32
#define IDX_MASK 127  // the packed fold keeps a triangle's slot in these bits
#define FULL_MASK 0xffffffffu

namespace dr {

// One cluster's triangles against one lane's ray, folded into (t_best, prim).
// The loop ends at the first pad row (pads trail, id < 0, never hit).
template <bool PACKED>
__device__ __forceinline__ void leaf_fold(const float4* __restrict__ soup,
                                          int cluster, int k, const Ray& r,
                                          float* t_best, int* prim) {
  const int base = cluster * k;
  const float4* tri = soup + (size_t)base * 4;
  int kmin = 0x7fffffff;
  for (int j = 0; j < k; ++j, tri += 4) {
    const float4 a = __ldg(tri);      // v0.xyz e1.x
    const float4 c = __ldg(tri + 1);  // e1.yz e2.xy
    const float4 g = __ldg(tri + 2);  // e2.z id_bits 0 0
    if (__float_as_int(g.y) < 0) break;
    float t;
    if (!mt_test(r, a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w, g.x, &t)) continue;
    if (PACKED) {
      const int key = (__float_as_int(t) & ~IDX_MASK) | j;
      kmin = key < kmin ? key : kmin;
    } else if (t < *t_best) {
      *t_best = t;
      *prim = base + j;
    }
  }
  if (PACKED) {
    // no accepted triangle leaves a NaN pattern here: never < t_best
    const float t_win = __int_as_float(kmin & ~IDX_MASK);
    if (t_win < *t_best) {
      *t_best = t_win;
      *prim = base + (kmin & IDX_MASK);
    }
  }
}

// LBUF: leaf-buffer entries. COMPACT: node table meta2 (N, 2) instead of
// meta (N, 4). PACKED: the index-packed fold.
template <int LBUF, bool COMPACT, bool PACKED>
__global__ void __launch_bounds__(BINARY_BLOCK_THREADS)
binary_kernel(const float4* __restrict__ bounds,  // (N, 2) float4
              const int* __restrict__ meta,       // (N, 4) or (N, 2) i32
              const float4* __restrict__ soup,    // (C K, 4) float4
              const float* __restrict__ ox_, const float* __restrict__ oy_,
              const float* __restrict__ oz_, const float* __restrict__ dx_,
              const float* __restrict__ dy_, const float* __restrict__ dz_,
              const float* __restrict__ tmin_,
              const float* __restrict__ tmax_, float* __restrict__ t_out,
              int* __restrict__ prim_out,
              int* __restrict__ counters,  // (packets, 2) or null
              int* __restrict__ overflow, int n, int k, int any_hit) {
  constexpr int LANES = WARP_LANES;
  constexpr int PACKETS = BINARY_BLOCK_THREADS / LANES;
  __shared__ int stacks[PACKETS][STACK_DEPTH];
  __shared__ int lbufs[PACKETS][LBUF];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % LANES;
  int* stack = stacks[threadIdx.x / LANES];
  int* lbuf = lbufs[threadIdx.x / LANES];
  const bool in = i < n;
  const float inf = __int_as_float(0x7f800000);
  const float tmin = in ? tmin_[i] : 0.0f;
  const float tmax = in ? tmax_[i] : -1.0f;
  const Ray r = make_ray(in ? ox_[i] : 0.0f, in ? oy_[i] : 0.0f,
                         in ? oz_[i] : 0.0f, in ? dx_[i] : 1.0f,
                         in ? dy_[i] : 1.0f, in ? dz_[i] : 1.0f, tmin);
  const bool alive = tmax >= tmin;
  const bool negx = __popc(__ballot_sync(FULL_MASK, r.dx < 0.0f)) > LANES / 2;
  const bool negy = __popc(__ballot_sync(FULL_MASK, r.dy < 0.0f)) > LANES / 2;
  const bool negz = __popc(__ballot_sync(FULL_MASK, r.dz < 0.0f)) > LANES / 2;

  float t_best = alive ? tmax : -inf;
  int prim = -1;
  // packet-uniform: the same value in every lane
  int sp = 1, nlb = 0, n_steps = 0, n_leaves = 0;
  if (lane == 0) stack[0] = 0;  // the root
  __syncwarp();
  // an any-hit packet ends once no live lane lacks a blocker
  bool done = any_hit && !__any_sync(FULL_MASK, alive);

  while ((sp > 0 || nlb > 0) && !done) {
    if (sp > 0 && nlb < LBUF) {
      // ---- node step: pop, test the POPPED node's box, push or keep
      ++n_steps;
      const int node = stack[--sp];
      __syncwarp();  // every lane has read the top before lane 0 pushes over it
      const float4 b0 = __ldg(bounds + (size_t)node * 2);      // lo.xyz hi.x
      const float4 b1 = __ldg(bounds + (size_t)node * 2 + 1);  // hi.yz 0 0
      const float t0x = (b0.x - r.ox) * r.ix, t1x = (b0.w - r.ox) * r.ix;
      const float t0y = (b0.y - r.oy) * r.iy, t1y = (b1.x - r.oy) * r.iy;
      const float t0z = (b0.z - r.oz) * r.iz, t1z = (b1.y - r.oz) * r.iz;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), r.tmin));
      const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), t_best));
      const bool live = alive && !(any_hit && prim >= 0);
      const bool hit = live && tn <= tf;
      const bool nhit = __any_sync(FULL_MASK, hit);
      int c0, c1, axis;
      if (COMPACT) {
        const int2 m = __ldg((const int2*)meta + node);
        c0 = m.x < 0 ? m.x : m.x >> 2;
        axis = m.x & 3;
        c1 = m.y;
      } else {
        const int4 m = __ldg((const int4*)meta + node);
        c0 = m.x;
        c1 = m.y;
        axis = m.z;
      }
      if (nhit) {
        if (c0 >= 0) {
          // interior: far first, so the near child pops first
          const bool neg = axis == 0 ? negx : (axis == 1 ? negy : negz);
          if (sp + 2 <= STACK_DEPTH) {
            if (lane == 0) {
              stack[sp] = neg ? c0 : c1;
              stack[sp + 1] = neg ? c1 : c0;
            }
            sp += 2;
          } else if (lane == 0) {
            atomicOr(overflow, 1);
          }
        } else {
          if (lane == 0) lbuf[nlb] = -c0 - 1;
          ++nlb;
        }
      }
      __syncwarp();  // lane 0's writes are visible to the next pop or flush
    } else {
      // ---- flush: the buffered clusters, in buffer order, on live lanes
      for (int q = 0; q < nlb; ++q) {
        const int cluster = lbuf[q];
        if (alive && !(any_hit && prim >= 0))
          leaf_fold<PACKED>(soup, cluster, k, r, &t_best, &prim);
      }
      n_leaves += nlb;
      nlb = 0;
      __syncwarp();  // every lane has read the buffer before lane 0 refills it
      if (any_hit) done = !__any_sync(FULL_MASK, alive && prim < 0);
    }
  }
  if (in) {
    t_out[i] = prim >= 0 ? t_best : inf;
    prim_out[i] = prim;
  }
  if (counters != nullptr && lane == 0 && in) {  // lane 0 in: a real packet
    counters[2 * (i / LANES)] = n_steps;
    counters[2 * (i / LANES) + 1] = n_leaves;
  }
}

// Launch one thread per lane of ceil(n / 128) thread blocks on `stream`;
// returns cudaGetLastError() (0 = launched).
template <int LBUF, bool COMPACT, bool PACKED>
int binary_launch(const void* bounds, const void* meta, const void* soup,
                  const void* ox, const void* oy, const void* oz,
                  const void* dx, const void* dy, const void* dz,
                  const void* tmin, const void* tmax, void* t_out,
                  void* prim_out, void* counters, void* overflow, int n, int k,
                  int any_hit, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + BINARY_BLOCK_THREADS - 1) / BINARY_BLOCK_THREADS;
  binary_kernel<LBUF, COMPACT, PACKED>
      <<<blocks, BINARY_BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
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
#define BINARY_WALK_ENTRY(NAME, LBUF, COMPACT, PACKED)                        \
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
    return dr::binary_launch<LBUF, COMPACT, PACKED>(                          \
        bounds, meta, soup, ox, oy, oz, dx, dy, dz, tmin, tmax, t_out,        \
        prim_out, counters, overflow, n, k, any_hit, stream);                 \
  }                                                                           \
  }
