// Native binned-SAH cluster-BVH builder (C ABI, loaded via ctypes).
//
// The scene compiler's hot host-side loop: a 12-bucket binned SAH build that
// terminates at K-triangle leaves ("clusters") for the wide-BVH device
// traversal (accel/cluster.py). Same source as the JAX reference's builder,
// so both packages build the same tree.
//
// Build: g++ -O3 -shared -fPIC -o libbvh_builder.so bvh_builder.cpp

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct BBox {
  Vec3 lo{1e30, 1e30, 1e30};
  Vec3 hi{-1e30, -1e30, -1e30};
  void grow(const BBox &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  double area() const {
    double dx = std::max(hi.x - lo.x, 0.0);
    double dy = std::max(hi.y - lo.y, 0.0);
    double dz = std::max(hi.z - lo.z, 0.0);
    return 2.0 * (dx * dy + dy * dz + dz * dx);
  }
};

constexpr int kBuckets = 12;

struct Task {
  int node, s, e, depth;
};

}  // namespace

extern "C" {

// Returns 0 on success, -1 if max_nodes exceeded.
// Outputs:
//   node_lo/node_hi: (max_nodes, 3) f32
//   node_child:      (max_nodes, 2) i32  (leaf: child[0] = -(cluster+1))
//   node_axis:       (max_nodes,)   i32
//   tri_order:       (n,)           i32  permutation of tri ids
//   cl_start/cl_cnt: (max_clusters,) i32 cluster ranges into tri_order
//   out[0..3] = n_nodes, n_clusters, max_depth, 0
int cluster_bvh_build(const float *v0, const float *e1, const float *e2,
                      int n, int k, int max_nodes,
                      float *node_lo, float *node_hi, int32_t *node_child,
                      int32_t *node_axis, int32_t *tri_order,
                      int32_t *cl_start, int32_t *cl_cnt, int32_t *out) {
  std::vector<BBox> boxes(n);
  std::vector<Vec3> cen(n);
  for (int i = 0; i < n; ++i) {
    Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    Vec3 b{a.x + e1[3 * i], a.y + e1[3 * i + 1], a.z + e1[3 * i + 2]};
    Vec3 c{a.x + e2[3 * i], a.y + e2[3 * i + 1], a.z + e2[3 * i + 2]};
    boxes[i].grow(a);
    boxes[i].grow(b);
    boxes[i].grow(c);
    cen[i] = {0.5 * (boxes[i].lo.x + boxes[i].hi.x),
              0.5 * (boxes[i].lo.y + boxes[i].hi.y),
              0.5 * (boxes[i].lo.z + boxes[i].hi.z)};
  }
  for (int i = 0; i < n; ++i) tri_order[i] = i;

  std::vector<Task> stack;
  stack.push_back({0, 0, n, 0});
  int n_nodes = 1, n_clusters = 0, max_depth = 0;

  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    max_depth = std::max(max_depth, t.depth);
    BBox nb;
    BBox cb;  // centroid bounds
    for (int i = t.s; i < t.e; ++i) {
      nb.grow(boxes[tri_order[i]]);
      cb.grow(cen[tri_order[i]]);
    }
    node_lo[3 * t.node] = (float)nb.lo.x;
    node_lo[3 * t.node + 1] = (float)nb.lo.y;
    node_lo[3 * t.node + 2] = (float)nb.lo.z;
    node_hi[3 * t.node] = (float)nb.hi.x;
    node_hi[3 * t.node + 1] = (float)nb.hi.y;
    node_hi[3 * t.node + 2] = (float)nb.hi.z;
    node_axis[t.node] = 0;

    int count = t.e - t.s;
    if (count <= k) {
      node_child[2 * t.node] = -(n_clusters + 1);
      node_child[2 * t.node + 1] = -1;
      cl_start[n_clusters] = t.s;
      cl_cnt[n_clusters] = count;
      ++n_clusters;
      continue;
    }

    double ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int dim = 0;
    if (ext[1] > ext[dim]) dim = 1;
    if (ext[2] > ext[dim]) dim = 2;
    node_axis[t.node] = dim;
    double cmin = dim == 0 ? cb.lo.x : (dim == 1 ? cb.lo.y : cb.lo.z);
    double cext = ext[dim];

    int mid;
    auto cen_of = [&](int id) -> double {
      return dim == 0 ? cen[id].x : (dim == 1 ? cen[id].y : cen[id].z);
    };
    if (cext < 1e-12) {
      mid = t.s + count / 2;  // equal-counts fallback
    } else {
      // binned SAH (bvh_accel.dart:310-421)
      int cnt[kBuckets] = {0};
      BBox bb[kBuckets];
      for (int i = t.s; i < t.e; ++i) {
        int id = tri_order[i];
        int b = std::min((int)((cen_of(id) - cmin) / cext * kBuckets),
                         kBuckets - 1);
        ++cnt[b];
        bb[b].grow(boxes[id]);
      }
      double best_cost = 1e300;
      int best_b = -1;
      BBox pre[kBuckets];
      BBox suf[kBuckets];
      BBox acc;
      for (int b = 0; b < kBuckets; ++b) {
        acc.grow(bb[b]);
        pre[b] = acc;
      }
      acc = BBox();
      for (int b = kBuckets - 1; b >= 0; --b) {
        acc.grow(bb[b]);
        suf[b] = acc;
      }
      int cl = 0;
      for (int b = 0; b < kBuckets - 1; ++b) {
        cl += cnt[b];
        int cr = count - cl;
        if (cl == 0 || cr == 0) continue;
        double cost = pre[b].area() * cl + suf[b + 1].area() * cr;
        if (cost < best_cost) {
          best_cost = cost;
          best_b = b;
        }
      }
      if (best_b < 0) {
        mid = t.s + count / 2;
        std::nth_element(tri_order + t.s, tri_order + mid, tri_order + t.e,
                         [&](int a, int b2) { return cen_of(a) < cen_of(b2); });
      } else {
        auto it = std::partition(tri_order + t.s, tri_order + t.e,
                                 [&](int id) {
                                   int b = std::min(
                                       (int)((cen_of(id) - cmin) / cext *
                                             kBuckets),
                                       kBuckets - 1);
                                   return b <= best_b;
                                 });
        mid = (int)(it - tri_order);
        if (mid == t.s || mid == t.e) mid = t.s + count / 2;
      }
    }
    if (cext < 1e-12 || mid == t.s || mid == t.e) {
      mid = t.s + count / 2;
      std::nth_element(tri_order + t.s, tri_order + mid, tri_order + t.e,
                       [&](int a, int b2) { return cen_of(a) < cen_of(b2); });
    }
    if (n_nodes + 2 > max_nodes) return -1;
    int l_id = n_nodes, r_id = n_nodes + 1;
    n_nodes += 2;
    node_child[2 * t.node] = l_id;
    node_child[2 * t.node + 1] = r_id;
    stack.push_back({l_id, t.s, mid, t.depth + 1});
    stack.push_back({r_id, mid, t.e, t.depth + 1});
  }
  out[0] = n_nodes;
  out[1] = n_clusters;
  out[2] = max_depth;
  out[3] = 0;
  return 0;
}

}  // extern "C"
