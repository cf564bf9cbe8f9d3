"""A shape given as explicit ``points`` and ``indices`` (no normals, no
uvs)."""
import numpy as np


def make(s):
    verts = np.asarray(s["points"], np.float32).reshape(-1, 3)
    faces = np.asarray(s["indices"], np.int32).reshape(-1, 3)
    return verts, faces, None, None
