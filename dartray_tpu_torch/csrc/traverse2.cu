// traverse2.cu — the v2 walk over the binary cluster tree for NVIDIA Hopper
// (sm_90a).
//
// Replaces the JAX reference's Pallas kernel `_kernel2` / launcher `traverse2`
// (ops/kernels_attic.py), closest-hit and any-hit: rays (o, d, tmin, tmax) in,
// `t` (+inf on a miss) and the PERMUTED prim id `cluster * K + j` (-1 on a
// miss) out; the finish step outside the kernel makes them exact.
//
// What this one is: every packet of 32 rays (a warp) walks ALONE, with its own
// stack and its own buffer of 8 hit leaf clusters that is flushed when it is
// full or the stack is empty; the full `meta` (N, 4) node table and the strict
// sequential fold.
// The walk, the two folds, what of the reference has no counterpart on this
// card, what bounds it here and what the design does about it (the buffered
// clusters staged in shared memory by `cp.async` as they are buffered, the
// next triangle row and the next node's rows fetched early, a flush cluster
// that at most 8 live lanes test served one ray at a time by the warp, the
// stack and the buffer in registers) are described in binary_walk.cuh.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libtraverse2.so traverse2.cu

#include "binary_walk.cuh"

// 8 leaf-buffer entries, the meta (N, 4) table (not meta2), the strict fold
// (not the packed one), a flush cluster that at most 8 live lanes test
// served one ray at a time by the warp
BINARY_WALK_ENTRY(traverse2, 8, false, false, 8)
