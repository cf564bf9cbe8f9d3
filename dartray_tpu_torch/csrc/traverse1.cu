// traverse1.cu — the v1 walk over the binary cluster tree for NVIDIA Hopper
// (sm_90a).
//
// Replaces the JAX reference's Pallas kernel `_kernel` / launcher `traverse`
// (ops/kernels_attic.py), closest-hit and any-hit: rays (o, d, tmin, tmax) in,
// `t` (+inf on a miss) and the PERMUTED prim id `cluster * K + j` (-1 on a
// miss) out; the finish step outside the kernel makes them exact.
//
// What this one is: ONE stack for a packet of 128 rays (the thread block), the
// full `meta` (N, 4) node table, the strict sequential fold, and a hit leaf
// tested AT THE POP by the lanes that hit its box.
// The walk, the two folds, what bounds it on this card and what the design
// does about it (a leaf that at most 16 lanes of a warp test served one ray
// at a time by the warp, the next triangle row and the next node's rows
// fetched early) are described in block_walk.cuh.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libtraverse1.so traverse1.cu

#include "block_walk.cuh"

// (leaf-buffer entries, meta2, packed fold, most testers a warp serves one
// ray at a time)
BLOCK_WALK_ENTRY(traverse1, 0, false, false, 16)
