"""The reference against the port's CPU path, cell by cell, at a small size:
the whole harness runs (set-up, window, check), on the CPU."""
import pytest

from benchmark import harness

from .conftest import SMALL, small_overrides


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_port_agrees_with_reference(workload, cpu_threads):
    out = harness.run_cell(workload, 3_000_000_123, 0.3, False,
                           device="cpu", overrides=small_overrides(workload),
                           log=lambda *a: None)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        # far inside the cell's limits: the two sides round apart only
        assert c["value"] < 1e-4, (name, c)
    assert out["attempted"] >= 1


def test_reference_pixel_is_the_mean_of_its_samples(cpu_threads):
    import torch
    from benchmark import registry, scenes
    from benchmark.reference import render, sampling
    man = harness.load_manifest()
    cfg = scenes.load_config(harness.config_path(man, "bench100k"),
                             small_overrides("bench100k.path.2160p")
                             ["config"])
    traffic = dict(harness.load_json("traffic", "path.2160p"), width=24,
                   height=16)
    sc = harness.reference_scene(cfg, "cpu", torch.float32)
    cam = harness.reference_camera(cfg, traffic, "cpu", torch.float32)
    smp = sampling.Sampler("lowdiscrepancy", 64, 7)
    est = registry.load("integrators", "path").reference({"maxdepth": 5})
    px, py = torch.tensor([3, 11]), torch.tensor([5, 9])
    both = render.pixel_values(sc, cam, smp, est, px, py, 4)
    one = torch.stack([render.pixel_values(sc, cam, smp, est, px[i:i + 1],
                                           py[i:i + 1], 4)[0]
                       for i in range(2)])
    assert torch.allclose(both, one)
