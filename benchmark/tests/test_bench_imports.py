"""No run loads JAX or the JAX package; the reference imports nothing of
either package."""
import ast
import os

import pytest

from benchmark import checks, harness

BENCH = os.path.join(harness.ROOT, "benchmark")


@pytest.mark.parametrize("mods,found", [
    (["dartray_tpu_torch", "dartray_tpu_torch.scene.types"], []),
    (["dartray_tpu", "dartray_tpu_torch"], ["dartray_tpu"]),
    (["dartray_tpu.scene.build"], ["dartray_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "dartray_tpu_tools", "numpy"], []),
])
def test_whole_top_level_names(mods, found):
    assert checks.forbidden_modules(mods) == found


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _py_files(top):
    """The benchmark's sources: hidden directories (the run-time caches
    under ``.cache``) are not part of it."""
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if not x.startswith(".")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_reference_imports_neither_package():
    bad = {"jax", "jaxlib", "flax", "dartray_tpu", "dartray_tpu_torch"}
    for path in _py_files(os.path.join(BENCH, "reference")):
        assert not set(_imports(path)) & bad, path


def test_benchmark_imports_no_jax():
    bad = {"jax", "jaxlib", "flax", "dartray_tpu", "bench_torch",
           "chip_smoke", "tools"}
    for path in _py_files(BENCH):
        assert not set(_imports(path)) & bad, path
