"""Triangle helpers shared by the host scene compiler (counterpart of the
JAX reference's ``accel/bvh.py``; only what the cluster-BVH path needs)."""
from __future__ import annotations

import numpy as np


def triangles_to_mt(verts: np.ndarray, faces: np.ndarray):
    """(V,3),(F,3) -> Moeller-Trumbore (v0, e1, e2) each (F,3) f32."""
    v = verts.astype(np.float32)
    p0 = v[faces[:, 0]]
    p1 = v[faces[:, 1]]
    p2 = v[faces[:, 2]]
    return p0, (p1 - p0), (p2 - p0)
