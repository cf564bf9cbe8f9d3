"""The check fails where it must: the reference computed in bfloat16 in the
program's place, and the faults the timed path can have, each planted
under a whole run of the harness (on the CPU, at a small size, with the
cells' own limits)."""
import pytest
import torch

from benchmark import harness

from .conftest import SMALL, small_overrides

RENDER = sorted(w for w in SMALL if "grad" not in w)


def _run(workload, **kw):
    return harness.run_cell(workload, 3_100_000_007, 0.3, False,
                            device="cpu", overrides=small_overrides(workload),
                            log=lambda *a: None, **kw)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_bf16_control_is_not_correct(workload, cpu_threads):
    out = _run(workload, control="bf16")
    assert not out["correct"], out["checks"]


FAULTS = ("altered", "half", "unchanged")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", RENDER)
def test_render_faults_are_caught(workload, fault, cpu_threads):
    assert not _run(workload, fault=fault)["correct"]


@pytest.mark.parametrize("fault", FAULTS)
def test_grad_faults_are_caught(fault, cpu_threads):
    assert not _run("bench100k.grad.512", fault=fault)["correct"]


def test_sound_run_is_correct(cpu_threads):
    assert _run("bench100k.path.2160p")["correct"]


@pytest.mark.cuda
def test_cell_on_the_card_at_a_small_film(cuda_device):
    out = harness.run_cell(
        "bench100k.path.2160p", 3_100_000_009, 1.0, False, device="cuda",
        overrides={"traffic": {"width": 64, "height": 48,
                               "check_pixels": 256}},
        log=lambda *a: None)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert torch.cuda.is_available()
