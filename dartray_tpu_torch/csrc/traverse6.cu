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
// What it computes is one walk per ray: a per-thread stack of child refs in
// local memory, the ray's OWN direction octant selects the far-first
// push-order row, so pops come near first; a popped interior ref slab-tests
// the node's 8 child boxes, a popped leaf ref tests the cluster's K triangles
// in slot order (Moeller-Trumbore) up to the first pad slot. The nearest
// accepted t in (tmin, tmax] wins, the first triangle met wins a tie, an
// any-hit lane stops at its first accepted triangle. Tables are read through
// L1/L2 with 16-byte loads: a node is one 192-byte row, an order row 32
// bytes, a triangle the first 48 bytes of its 64-byte soup16 row.
//
// What bounds it on this card: neither the ray planes' bytes (40 B a ray in
// and out) nor f32 arithmetic. A wave's mean work is tiny (1-8 node pops and
// 2-140 triangle tests a ray on the bench scene) and its time is set by its
// heaviest warps: a few rays visit tens of times the mean number of leaves,
// and for each leaf the one-thread-a-ray loop is a chain of about 22
// dependent triangle tests, each behind a row fetch that cannot start before
// the previous test has ended. So the design shortens the chain of a ray;
// each ray still pops its own stack in the same order, and only WHEN a lane
// does a step and WHICH lane does its arithmetic change, so (t, prim) stay
// those of the plain version bit for bit:
//
//  * Postponed leaves. A lane pops and slab-tests interior refs until it pops
//    a leaf, which it HOLDS, or its stack is empty; when every lane of the
//    warp has got there the warp serves the held leaves. Lanes do node work
//    together and leaf work together instead of a slab test and a whole leaf
//    loop in one divergent step.
//  * Few lanes hold a leaf (at most TRANSPOSE_MAX of 32: the long rays of a
//    warp whose other rays have ended, and incoherent waves): the warp serves
//    them one RAY at a time. The ray is broadcast by shuffles, lane j fetches
//    and tests triangle j of its cluster (K = 32 is the warp's width; wider
//    clusters take rounds of 32 slots), and the warp folds the 32 results as
//    the sequential loop would have: the least accepted t by an integer
//    `__reduce_min_sync` over an order-preserving key, the first slot among
//    equal t by a ballot; an any-hit ray takes the first accepted slot. A
//    leaf costs that ray one triangle test, not K in a row. Consecutive rays
//    that hold the same cluster reuse the rows already in registers.
//  * Many lanes hold a leaf (coherent waves): every lane runs the sequential
//    loop for itself, all together, and the rows of slot j + 1 are loaded
//    before slot j is tested, so the fetch is off the chain. L1 broadcasts
//    the rows that neighbouring lanes share.
//  * All 32 lanes of a warp stay in the walk until the warp is done: lanes
//    past the end of the wave, dead lanes and finished lanes idle with an
//    empty stack, because every `*_sync` below names the full warp.
//
// Measured and left out (tools/compare_traverse6.py, each alone against the
// earlier one-thread-a-ray kernel and on top of this design; PERF.md has the
// numbers): warps that fetch batches of 32 rays from a global counter, and
// blocks of 64 threads (slower or level: neighbouring batches land on
// different SMs and share no L1); a cluster that several lanes share staged
// in shared memory (slower: L1 already broadcasts equal addresses, and the
// staging costs registers and a barrier); node rows shared the same way
// (level); the bottom of the stack in shared memory (level); two rows a turn
// in the sequential loop, two rays a round in the transposed one, order rows
// fetched beside the node row, an early exit from a triangle test whose u is
// far outside [0, 1] (all level within the spread).
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
#define FULL_WARP 0xffffffffu
// a leaf phase in which at most this many lanes hold a leaf is served one
// ray at a time by the whole warp; above it every lane loops for itself.
// Measured level from 8 to 24; at 32 the coherent camera waves take a
// quarter to a half longer
#define TRANSPOSE_MAX 16

#define MODE_CLOSEST 0
#define MODE_ANY 1
#define MODE_MIXED 2

namespace {

// the 48 bytes of a soup16 row a test reads: v0.xyz e1.x | e1.yz e2.xy |
// e2.z id_bits 0 0
struct Tri {
  float4 a, c, g;
};

__device__ __forceinline__ bool is_pad(const Tri& t) {
  return __float_as_int(t.g.y) < 0;  // the id column: bits, never a number
}

// row `row` of the soup (and, MOTION, of the delta table) where `on`
template <bool MOTION>
__device__ __forceinline__ void load_row(const float4* __restrict__ soup,
                                         const float4* __restrict__ soupd,
                                         int row, bool on, Tri& t, Tri& d) {
  if (on) {
    const float4* p = soup + (size_t)row * 4;
    t.a = __ldg(p);
    t.c = __ldg(p + 1);
    t.g = __ldg(p + 2);
    if (MOTION) {
      const float4* q = soupd + (size_t)row * 4;
      d.a = __ldg(q);
      d.c = __ldg(q + 1);
      d.g = __ldg(q + 2);
    }
  }
}

// the triangle at the ray's time; the id column is not touched (the delta
// table's is zero and is never added to it)
template <bool MOTION>
__device__ __forceinline__ Tri lerped(Tri t, const Tri& d, float time) {
  if (MOTION) {
    t.a.x = t.a.x + time * d.a.x;
    t.a.y = t.a.y + time * d.a.y;
    t.a.z = t.a.z + time * d.a.z;
    t.a.w = t.a.w + time * d.a.w;
    t.c.x = t.c.x + time * d.c.x;
    t.c.y = t.c.y + time * d.c.y;
    t.c.z = t.c.z + time * d.c.z;
    t.c.w = t.c.w + time * d.c.w;
    t.g.x = t.g.x + time * d.g.x;
  }
  return t;
}

__device__ __forceinline__ bool hits(const dr::Ray& r, const Tri& w,
                                     float* t) {
  return dr::mt_test(r, w.a.x, w.a.y, w.a.z, w.a.w, w.c.x, w.c.y, w.c.z,
                     w.c.w, w.g.x, t);
}

// Slab-test wide node `ref` and push the hit children, far first.
__device__ __forceinline__ void node_step(const float4* __restrict__ wbounds,
                                          const int4* __restrict__ order_rows,
                                          int ref, const dr::Ray& r,
                                          float t_best, int* stack, int& sp,
                                          int* overflow) {
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
}

// One lane tests the triangles of its held leaf `ref` in slot order (pad
// slots trail, id < 0); slot j + 1 is on its way while slot j is tested.
template <bool MOTION>
__device__ __forceinline__ void leaf_by_lane(
    const dr::Ray& r, int ref, int k, const float4* __restrict__ soup,
    const float4* __restrict__ soupd, float time, bool any_lane,
    float& t_best, int& prim, int& sp) {
  const int base = (-ref - 1) * k;
  Tri next{}, dnext{};
  load_row<MOTION>(soup, soupd, base, true, next, dnext);
  for (int j = 0; j < k; ++j) {
    const Tri tri = next, dtri = dnext;
    if (is_pad(tri)) break;
    load_row<MOTION>(soup, soupd, base + j + 1, j + 1 < k, next, dnext);
    float t;
    const bool ok = hits(r, lerped<MOTION>(tri, dtri, time), &t);
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

// Order-preserving integer key of a float that is not NaN; -0 counts as +0.
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned u = __float_as_uint(t + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The whole warp serves the held leaves of the lanes in `holders`, one ray
// at a time: lane j tests slot c0 + j of the ray's cluster. Within a round
// of 32 slots every candidate is held against the (t_best, prim) the ray
// had when the round began, and the least t wins, the lower slot on a tie:
// what the sequential loop over those slots leaves behind. Executed by all
// 32 lanes; only the ray's own lane takes the result.
template <bool MOTION>
__device__ __forceinline__ void leaves_by_warp(
    unsigned holders, int lane, const dr::Ray& r, int held, int k,
    const float4* __restrict__ soup, const float4* __restrict__ soupd,
    float time, bool any_lane, float& t_best, int& prim, int& sp) {
  int in_regs = 0;  // k <= 32: the cluster whose row `lane` is in (tri, dtri)
  Tri tri{}, dtri{};
  for (unsigned todo = holders; todo != 0u; todo &= todo - 1u) {
    const int src = __ffs(todo) - 1;
    const int ref = __shfl_sync(FULL_WARP, held, src);
    dr::Ray q = r;  // mt_test reads o, d and tmin only
    q.ox = __shfl_sync(FULL_WARP, r.ox, src);
    q.oy = __shfl_sync(FULL_WARP, r.oy, src);
    q.oz = __shfl_sync(FULL_WARP, r.oz, src);
    q.dx = __shfl_sync(FULL_WARP, r.dx, src);
    q.dy = __shfl_sync(FULL_WARP, r.dy, src);
    q.dz = __shfl_sync(FULL_WARP, r.dz, src);
    q.tmin = __shfl_sync(FULL_WARP, r.tmin, src);
    float best = __shfl_sync(FULL_WARP, t_best, src);
    int winner = __shfl_sync(FULL_WARP, prim, src);
    const bool any_ray = __shfl_sync(FULL_WARP, (int)any_lane, src) != 0;
    const float when = MOTION ? __shfl_sync(FULL_WARP, time, src) : 0.0f;
    const int base = (-ref - 1) * k;
    bool got = false;
    for (int c0 = 0; c0 < k; c0 += 32) {  // the same for all lanes
      const bool mine = c0 + lane < k;
      if (k > 32 || ref != in_regs)
        load_row<MOTION>(soup, soupd, base + c0 + lane, mine, tri, dtri);
      bool accept = false;
      float t = 0.0f;
      if (mine) {
        const bool ok = hits(q, lerped<MOTION>(tri, dtri, when), &t);
        accept = ok && !is_pad(tri) && dr::nearer(t, best, winner);
      }
      const unsigned accepted = __ballot_sync(FULL_WARP, accept);
      if (accepted == 0u) continue;
      int slot;
      if (any_ray) {
        slot = __ffs(accepted) - 1;
      } else {
        const unsigned key = accept ? order_key(t) : 0xffffffffu;
        const unsigned least = __reduce_min_sync(FULL_WARP, key);
        slot = __ffs(__ballot_sync(FULL_WARP, accept && key == least)) - 1;
      }
      best = __shfl_sync(FULL_WARP, t, slot);
      winner = base + c0 + slot;
      got = true;
      if (any_ray) break;  // first blocker is enough
    }
    in_regs = ref;
    if (lane == src && got) {
      t_best = best;
      prim = winner;
      if (any_ray) sp = 0;
    }
  }
}

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
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  // a lane past the end of the wave stays, as a dead lane: no early return
  const bool in_wave = i < n;
  float tmin = 0.0f, tmax = -1.0f, time = 0.0f;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  bool any_lane = mode == MODE_ANY;
  if (in_wave) {
    tmin = tmin_[i];
    tmax = tmax_[i];
    ox = ox_[i];
    oy = oy_[i];
    oz = oz_[i];
    dx = dx_[i];
    dy = dy_[i];
    dz = dz_[i];
    if (mode == MODE_MIXED) any_lane = anyf_[i] > 0.0f;
    if (MOTION) time = time_[i];
  }
  const dr::Ray r = dr::make_ray(ox, oy, oz, dx, dy, dz, tmin);
  const int octant = (r.dx < 0.0f ? 1 : 0) + (r.dy < 0.0f ? 2 : 0) +
                     (r.dz < 0.0f ? 4 : 0);
  const int4* order_rows = worder + (size_t)octant * n_wnodes * 2;

  int stack[STACK_DEPTH];
  int sp = 0;
  if (tmax >= tmin) stack[sp++] = 0;  // live (not dead, no NaN bound): root
  float t_best = tmax;
  int prim = -1;
  int held = 0;  // the leaf ref (< 0) this lane has popped and not yet tested

  for (;;) {
    // ---- nodes: pop until this lane holds a leaf or its stack is empty
    while (held == 0 && sp > 0) {
      const int ref = stack[--sp];
      if (ref < 0)
        held = ref;
      else
        node_step(wbounds, order_rows, ref, r, t_best, stack, sp, overflow);
    }
    // ---- leaves, once every lane of the warp has got here (the barrier
    // gathers the lanes at once: without it the ballot is reached in ragged
    // groups, measured 4 % slower); a lane that holds none has an empty
    // stack, so no holder ends the warp's walk
    __syncwarp();
    const unsigned holders = __ballot_sync(FULL_WARP, held < 0);
    if (holders == 0u) break;
    if (__popc(holders) <= TRANSPOSE_MAX)
      leaves_by_warp<MOTION>(holders, lane, r, held, k, soup, soupd, time,
                             any_lane, t_best, prim, sp);
    else if (held < 0)
      leaf_by_lane<MOTION>(r, held, k, soup, soupd, time, any_lane, t_best,
                           prim, sp);
    held = 0;  // tested; an any-hit lane that was blocked also has sp == 0
  }
  if (in_wave) {
    t_out[i] = prim >= 0 ? t_best : inf;
    prim_out[i] = prim;
  }
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
