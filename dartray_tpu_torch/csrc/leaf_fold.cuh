// leaf_fold.cuh — the pieces the walks over the BINARY cluster tree share:
// the block packets of block_walk.cuh (v1, v3) and the warp packets of
// binary_walk.cuh (v2, v4). A node's box and meta row and its slab test; a
// triangle row, its Moeller-Trumbore test and the two folds of a cluster
// into a lane's (t_best, prim), by the lane alone or one ray at a time by
// the whole warp; and the `cp.async` staging of a buffered cluster's rows.
//
// The folds. Strict: sequential, `t < t_best`, so the first of equal t wins
// and tmax itself is outside the interval. Packed: the key
// `(bits(t) & ~127) | slot` is minimised as an integer over the cluster, then
// `float(key & ~127)` is compared with `<` against a t_best that itself holds
// such rounded values: t is rounded DOWN by up to 127 ulps and the lowest
// slot wins a tie (K <= 128; t > tmin >= 0 makes the patterns order like the
// floats). Dead lanes carry t_best = -inf and never win. Every fold here
// gives the sequential loop's (t_best, prim) bit for bit, whichever lanes do
// the arithmetic.

#pragma once

#include <cuda_pipeline.h>

#include "ray_tests.cuh"

#define WARP_LANES 32
#define IDX_MASK 127  // the packed fold keeps a triangle's slot in these bits
#define FULL_MASK 0xffffffffu
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

// One cluster against one lane's ray, folded into (t_best, prim) by the
// sequential loop, which ends at the first pad row (pads trail, id < 0).
// `rows`: its first row, `stride` float4 a row; `base`: cluster * k, the
// prim id of slot 0. The row of slot j + 1 is on its way while slot j is
// tested.
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

// The THREADS threads that share a packet (`tid` 0 .. THREADS - 1) start
// `cp.async` copies of their share of the first STAGED_ROW float4 of each of
// `cluster`'s k soup16 rows into `dst`, and commit them as one group.
template <int THREADS>
__device__ __forceinline__ void stage_cluster(float4* dst,
                                              const float4* __restrict__ soup,
                                              int cluster, int k, int tid) {
  for (int c = tid; c < STAGED_ROW * k; c += THREADS)
    __pipeline_memcpy_async(
        dst + c, soup + (size_t)(cluster * k + c / STAGED_ROW) * 4 +
                     c % STAGED_ROW, sizeof(float4));
  __pipeline_commit();
}

// A node's box and meta row, as the walks read them.
struct NodeRow {
  float4 b0, b1;  // lo.xyz hi.x | hi.yz 0 0
  int c0, c1, axis;  // c0 < 0: a leaf, cluster -c0 - 1
};

// COMPACT: node table meta2 (N, 2) instead of meta (N, 4)
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

}  // namespace dr
