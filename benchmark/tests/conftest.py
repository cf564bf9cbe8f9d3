"""Shared fixtures of the benchmark's tests: a cell shrunk to a size the
CPU renders in seconds (every width kept: only the displaced sphere's
triangle count and the film are cut), and the card for the tests marked
``cuda``, which skip without one and run on the chip with
``python -m pytest benchmark/tests -m cuda``."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def shrink_config(cfg):
    cfg.pop("n_triangles", None)
    for s in cfg["shapes"]:
        if "n_tris_target" in s:
            s["n_tris_target"] = 2000


SMALL = {
    "bench100k.path.2160p": {"width": 24, "height": 16, "check_pixels": 64},
    "cornell.direct.2160p": {"width": 24, "height": 16, "check_pixels": 64},
    "bench100k.grad.512": {"width": 16, "height": 16},
}


def small_overrides(workload):
    return {"config": shrink_config, "traffic": dict(SMALL[workload])}


@pytest.fixture
def cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, decided here and not at import: skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
