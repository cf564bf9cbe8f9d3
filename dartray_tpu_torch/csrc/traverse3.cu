// traverse3.cu — the v3 walk over the binary cluster tree for NVIDIA Hopper
// (sm_90a).
//
// Replaces the JAX reference's Pallas kernel `_kernel3` / launcher `traverse3`
// (ops/kernels_attic.py), closest-hit and any-hit: rays (o, d, tmin, tmax) in,
// `t` (+inf on a miss) and the PERMUTED prim id `cluster * K + j` (-1 on a
// miss) out; the finish step outside the kernel makes them exact.
//
// What this one is: v1's packet (128 rays, one stack a thread block) over the
// compact `meta2` (N, 2) node table. The node loop only buffers hit leaf
// clusters (16); a flush then tests them in buffer order on every live lane
// with the index-packed fold. Optional counters: node steps (every pop, missed
// boxes included) and leaf rounds of each packet. The buffer size decides WHEN
// t_best tightens and so how many nodes are popped: it stays 16, the
// reference's, so that the counters can be held against the reference's.
// The walk, the two folds, what bounds it on this card and what the design
// does about it are described in block_walk.cuh: the buffered clusters are
// staged in shared memory by `cp.async` as they are buffered, and the flush
// folds them per lane (or, where at most 8 lanes of a warp are live, one
// ray at a time by the warp).
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libtraverse3.so traverse3.cu

#include "block_walk.cuh"

// (leaf-buffer entries, meta2, packed fold, most testers a warp serves one
// ray at a time)
BLOCK_WALK_ENTRY(traverse3, 16, true, true, 8)
