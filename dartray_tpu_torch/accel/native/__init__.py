"""Native (C++) host components, loaded via ctypes.

``bvh_builder.cpp`` is built on first use with g++ (the ``.so`` is cached
next to the source and rebuilt when the source is newer). When no compiler
is available the caller falls back to the pure-numpy builder; which builder
built a tree is logged once (``dartray_tpu_torch.accel`` logger), so a slow
host build is visible instead of silent.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("dartray_tpu_torch.accel")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
_SO = os.path.join(_DIR, "libbvh_builder.so")
_lock = threading.Lock()
_lib = None
_tried = False
_reported = set()
LAST_BUILDER = None      # "native" | "numpy": what built the latest tree


def report_builder(which: str, reason: str = ""):
    """Record which builder produced the tree; log each kind once."""
    global LAST_BUILDER
    LAST_BUILDER = which
    if which not in _reported:
        _reported.add(which)
        if which == "native":
            log.info("cluster BVH built by the native C++ builder")
        else:
            log.warning("cluster BVH built by the numpy builder (slow on "
                        "large meshes)%s", f": {reason}" if reason else "")


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", _SO, _SRC],
                    check=True, capture_output=True, timeout=240)
            lib = ctypes.CDLL(_SO)
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.cluster_bvh_build.restype = ctypes.c_int
            lib.cluster_bvh_build.argtypes = [
                f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f32p, f32p, i32p, i32p, i32p, i32p, i32p, i32p]
            _lib = lib
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native BVH builder unavailable (%s: %s)",
                        type(e).__name__, e)
            _lib = None
        return _lib


def cluster_bvh_build(v0, e1, e2, k):
    """Binned-SAH cluster build. Returns (node_lo, node_hi, node_child,
    node_axis, tri_order, cl_start, cl_cnt, n_nodes, n_clusters, max_depth)
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = int(v0.shape[0])
    max_clusters = max(2 * (n // max(k // 2, 1) + 2), 64)
    max_nodes = 2 * max_clusters + 64
    node_lo = np.empty((max_nodes, 3), np.float32)
    node_hi = np.empty((max_nodes, 3), np.float32)
    node_child = np.empty((max_nodes, 2), np.int32)
    node_axis = np.empty(max_nodes, np.int32)
    tri_order = np.empty(n, np.int32)
    cl_start = np.empty(max_clusters, np.int32)
    cl_cnt = np.empty(max_clusters, np.int32)
    out = np.zeros(4, np.int32)
    rc = lib.cluster_bvh_build(
        np.ascontiguousarray(v0, np.float32),
        np.ascontiguousarray(e1, np.float32),
        np.ascontiguousarray(e2, np.float32),
        n, int(k), max_nodes, node_lo, node_hi, node_child, node_axis,
        tri_order, cl_start, cl_cnt, out)
    if rc != 0:
        return None
    n_nodes, n_clusters, max_depth = int(out[0]), int(out[1]), int(out[2])
    return (node_lo[:n_nodes], node_hi[:n_nodes], node_child[:n_nodes],
            node_axis[:n_nodes], tri_order, cl_start[:n_clusters],
            cl_cnt[:n_clusters], n_nodes, n_clusters, max_depth)
