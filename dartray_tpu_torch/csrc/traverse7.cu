// traverse7.cu — packet walk with the Woop unit-triangle leaf test for NVIDIA
// Hopper (sm_90a).
//
// Replaces the JAX reference's Pallas kernel `_kernel7` / launcher `traverse7`
// (ops/kernels_attic.py): closest-hit and any-hit. The walk is traverse5.cu's
// (packet_walk.cuh); only the leaf test differs. The host precomputes for
// every triangle the affine map W = [e1 e2 e1xe2]^-1, w = -W v0 that takes it
// to the unit triangle (`woop_pack` in ops/traverse_cuda.py: three rows
// [W_c0 W_c1 W_c2 w_c], 48 bytes a triangle). Per (ray, triangle) the kernel
// computes o' = W o + w and d' = W d, the product the other machine hands to
// its matrix unit, here in f32 in the kernel's body with ONE summation order
// that the plain version repeats term by term,
//   o'_c = ((W_c0 ox + W_c1 oy) + W_c2 oz) + w_c,
//   d'_c =  (W_c0 dx + W_c1 dy) + W_c2 dz,
// then t = -o'_z / d'_z, u = o'_x + t d'_x, v = o'_y + t d'_y and the same
// acceptance test as the reference (|d'_z| >= 1e-30, u, v >= -eps,
// u + v <= 1 + eps, t > tmin). No tensor cores and no reduced precision: the
// transform's rounding already differs from Moeller-Trumbore's (it misses
// some sliver triangles, as the reference's does), and the finish step
// recomputes exact values for the winners from the soup.
//
// Pad and degenerate triangles have all-zero rows (d'_z = 0: never hit).
// The kernel has no pad flag; its fold skips a row whose W_z is zero, the
// same for every lane of the warp, so the 30 % of the bench scene's slots
// that are pads cost a load and a compare each (and the function is the
// same: such a row never hits). Tie rule as traverse5.cu: nearest t, equal t
// keeps the first triangle in cluster order; an any-hit lane takes the
// first accepted triangle and stops.
//
// What bounds it: the walk's chains (packet_walk.cuh); the leaf test is 20
// multiplies, 18 adds and one divide per pair, about the cost of
// Moeller-Trumbore, so on this card the transform buys nothing by itself.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libtraverse7.so traverse7.cu

#include "packet_walk.cuh"

namespace dr {

struct WoopLeaf {
  static constexpr int STRIDE = 3;  // float4 a woop row
  const float4* table;              // (C K, 3) float4

  // the rows [W_c0 W_c1 W_c2 w_c], c = x, y, z, as w.a, w.c, w.g
  __device__ static __forceinline__ bool hit(const Ray& r, const TriRow& w,
                                             float* t_out) {
    const float4 wx = w.a, wy = w.c, wz = w.g;
    const float opx = ((wx.x * r.ox + wx.y * r.oy) + wx.z * r.oz) + wx.w;
    const float opy = ((wy.x * r.ox + wy.y * r.oy) + wy.z * r.oz) + wy.w;
    const float opz = ((wz.x * r.ox + wz.y * r.oy) + wz.z * r.oz) + wz.w;
    const float dpx = (wx.x * r.dx + wx.y * r.dy) + wx.z * r.dz;
    const float dpy = (wy.x * r.dx + wy.y * r.dy) + wy.z * r.dz;
    const float dpz = (wz.x * r.dx + wz.y * r.dy) + wz.z * r.dz;
    const bool flat = fabsf(dpz) < 1e-30f;
    const float t = -opz / (flat ? 1e-30f : dpz);
    const float u = opx + t * dpx;
    const float v = opy + t * dpy;
    *t_out = t;
    return u >= -kBaryEps && v >= -kBaryEps && (u + v) <= 1.0f + kBaryEps &&
           t > r.tmin && !flat;
  }

  // The lane's sequential fold; the row of slot j + 1 is on its way while
  // slot j is tested.
  __device__ static __forceinline__ void fold(const float4* rows, int base,
                                              int k, const Ray& r,
                                              bool any_hit, float& t_best,
                                              int& prim) {
    TriRow next = load_tri<true>(rows);
    for (int j = 0; j < k; ++j) {
      const TriRow w = next;
      if (j + 1 < k) next = load_tri<true>(rows + STAGED_ROW * (j + 1));
      if (w.g.x == 0.0f && w.g.y == 0.0f && w.g.z == 0.0f) continue;
      float t;
      if (hit(r, w, &t) && nearer(t, t_best, prim)) {
        t_best = t;
        prim = base + j;
        if (any_hit) break;  // first blocker is enough
      }
    }
  }
};

}  // namespace dr

extern "C" {

int traverse7_stack_depth() { return STACK_DEPTH; }
int traverse7_packet_width() { return PACKET_WIDTH; }

// `woop` is the (C K, 12) f32 table of `woop_pack`; `counters` and `overflow`
// as in traverse5_launch.
int traverse7_launch(const void* wbounds, const void* worder, const void* woop,
                     const void* ox, const void* oy, const void* oz,
                     const void* dx, const void* dy, const void* dz,
                     const void* tmin, const void* tmax, void* t_out,
                     void* prim_out, void* counters, void* overflow, int n,
                     int n_wnodes, int k, int any_hit, void* stream) {
  const dr::WoopLeaf leaf{(const float4*)woop};
  return dr::packet_launch(wbounds, worder, leaf, ox, oy, oz, dx, dy, dz, tmin,
                           tmax, t_out, prim_out, counters, overflow, n,
                           n_wnodes, k, any_hit, stream);
}

}  // extern "C"
