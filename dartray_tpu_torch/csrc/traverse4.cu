// traverse4.cu — the v4 walk over the binary cluster tree for NVIDIA Hopper
// (sm_90a).
//
// Replaces the JAX reference's Pallas kernel `_kernel4` / launcher `traverse4`
// (ops/kernels_attic.py), closest-hit and any-hit: rays (o, d, tmin, tmax) in,
// `t` (+inf on a miss) and the PERMUTED prim id `cluster * K + j` (-1 on a
// miss) out; the finish step outside the kernel makes them exact.
//
// What this one is: v2's packet (32 rays, one stack a warp, a leaf buffer of
// 8) over the compact `meta2` (N, 2) node table, with the index-packed fold.
// The walk, the two folds, what bounds it on this card and what the design
// does about it are described in binary_walk.cuh; the design is v2's.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libtraverse4.so traverse4.cu

#include "binary_walk.cuh"

// 8 leaf-buffer entries, the compact meta2 (N, 2) table, the packed fold, a
// flush cluster that at most 8 live lanes test served one ray at a time by
// the warp
BINARY_WALK_ENTRY(traverse4, 8, true, true, 8)
