"""PyTorch port, the native (C++) BVH builder's library: built once and
loaded whole however many processes start on a fresh tree at once.

The library is compiled on first use. Processes that start together (the
workers of a test run on a fresh checkout) used to compile it onto the same
path at once, and one that loaded a half-written file fell back to the
numpy builder, whose trees differ. The port's loader compiles under a file
lock into a file of its own and renames it into place; the reference's
loader does not, so ``torchhelp`` points the reference at a copy built the
same way.
"""
import ctypes
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from dartray_tpu.accel import native as ref_native

from dartray_tpu_torch.accel import native

import torchhelp as th

# seconds the six processes have to start and get ready (past it they are
# let go all the same), and then to build and report: the whole test takes
# about 9 s on a host loaded by a whole test run with an empty compile cache.
# A worker that is never let go gives up after GO_DEADLINE_S.
READY_DEADLINE_S = 60
RUN_DEADLINE_S = 120
GO_DEADLINE_S = READY_DEADLINE_S + RUN_DEADLINE_S

WORKER = r"""
import importlib.util, os, sys, time
root, pkg, tag, wait_s = sys.argv[1:5]
sys.path.insert(0, root)
import numpy as np
spec = importlib.util.spec_from_file_location(
    "dartray_tpu_torch.accel.native", os.path.join(pkg, "__init__.py"))
mod = importlib.util.module_from_spec(spec)
sys.modules[spec.name] = mod
spec.loader.exec_module(mod)
import dartray_tpu_torch.accel as accel
accel.native = mod
from dartray_tpu_torch.accel import cluster
rng = np.random.RandomState(0)
v0 = rng.randn(300, 3).astype(np.float32)
e1 = (rng.randn(300, 3) * 0.3).astype(np.float32)
e2 = (rng.randn(300, 3) * 0.3).astype(np.float32)
open(os.path.join(pkg, "ready." + tag), "w").close()
deadline = time.monotonic() + float(wait_s)
while not os.path.exists(os.path.join(pkg, "go")):
    if time.monotonic() > deadline:
        sys.exit("never let go")
    time.sleep(0.002)
cluster.build(v0, e1, e2)
print(mod.LAST_BUILDER)
"""


def test_six_processes_on_a_fresh_copy_all_get_the_native_builder(
        tmp_path):
    """Six processes load the builder from a fresh copy of accel/native/
    (no library yet) at the same moment: all six build their tree with the
    native builder, and no temporary file is left."""
    pkg = tmp_path / "native"
    pkg.mkdir()
    src = os.path.dirname(native.__file__)
    for name in ("__init__.py", "bvh_builder.cpp"):
        shutil.copy(os.path.join(src, name), pkg / name)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, th.ROOT, str(pkg), str(i),
         str(GO_DEADLINE_S)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(6)]
    try:
        deadline = time.monotonic() + READY_DEADLINE_S
        while (len(list(pkg.glob("ready.*"))) < 6
               and time.monotonic() < deadline
               and all(p.poll() is None for p in procs)):
            time.sleep(0.01)
        (pkg / "go").touch()
        deadline = time.monotonic() + RUN_DEADLINE_S
        outs = [p.communicate(
            timeout=max(deadline - time.monotonic(), 0.0)) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 6, [o[1] for o in outs]
    assert [o[0].split()[-1] for o in outs] == ["native"] * 6, outs
    assert (pkg / "libbvh_builder.so").exists()
    assert not list(pkg.glob("*.tmp"))


def test_the_reference_loads_a_whole_library_built_apart():
    """torchhelp points the reference's builder at a library of its own,
    built atomically under a lock, complete, and making the port's tree."""
    assert ref_native._SO == th.REF_NATIVE_SO
    assert os.path.getsize(th.REF_NATIVE_SO) > 4096
    with open(th.REF_NATIVE_SO, "rb") as f:
        assert f.read(4) == b"\x7fELF"
    assert hasattr(ctypes.CDLL(th.REF_NATIVE_SO), "cluster_bvh_build")
    v0, e1, e2 = th.soup(500, seed=3)
    got = native.cluster_bvh_build(v0, e1, e2, 32)
    want = ref_native.cluster_bvh_build(v0, e1, e2, 32)
    assert got is not None and want is not None
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
