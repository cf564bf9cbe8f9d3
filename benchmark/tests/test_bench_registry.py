"""A configuration with a new kind of shape, a traffic mix with a new
integrator, a metric and a cell are added as new files and new entries of
BENCHMARK.json, with no file edited, and the harness finds them by name."""
import json
import os
import shutil

import pytest

from benchmark import harness

from .conftest import shrink_config

NEW_METRIC = '''"""waves_in_window: the units the window ran."""


def read(rec):
    return float(rec.units) if rec.units else None
'''

NEW_SHAPE = '''"""A quad from its four corners, as two triangles."""
import numpy as np


def make(s):
    verts = np.asarray(s["corners"], np.float32).reshape(4, 3)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, faces, None, None
'''

NEW_INTEGRATOR = '''"""Path tracing cut to one bounce of light: the port's path integrator
and the reference's, at depth 1 whatever the mix says."""
from benchmark.reference import integrators as ref


def program(params):
    from dartray_tpu_torch.integrators import path as pi
    ig = pi.PathIntegrator(max_depth=1)
    return lambda s, r, d, c: pi.li(ig, s, r, d, c)


def reference(params):
    return lambda sc, cam, lanes, kd=None: ref.path(sc, cam, lanes,
                                                    max_depth=1, kd_table=kd)
'''


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    return root


def _snapshot(root):
    out = {}
    for d, _, files in os.walk(root / "benchmark"):
        for f in files:
            p = os.path.join(d, f)
            out[p] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("integrator,params", [
    ("onebounce", {}), ("ambientocclusion", {"nsamples": 4})])
def test_new_config_traffic_metric_and_cell(tmp_path, cpu_threads,
                                            integrator, params):
    """A new integrator's file, or one no cell uses yet, runs a new mix."""
    root = _copy(tmp_path)
    bench = root / "benchmark"
    before = _snapshot(root)
    cfg = json.load(open(bench / "configs" / "bench100k.json"))
    cfg["name"] = "tinyball"
    shrink_config(cfg)
    floor = cfg["shapes"][2]
    floor.update(kind="quad", corners=floor.pop("points"))
    del floor["indices"]
    cfg["shapes"] = cfg["shapes"][:1] + cfg["shapes"][2:]
    del cfg["materials"]["glass"]
    (bench / "configs" / "tinyball.json").write_text(json.dumps(cfg))
    (bench / "shapes" / "quad.py").write_text(NEW_SHAPE)
    (bench / "integrators" / "onebounce.py").write_text(NEW_INTEGRATOR)
    mix = json.load(open(bench / "traffic" / "path.2160p.json"))
    mix.update(width=12, height=8, check_pixels=16, integrator=integrator,
               integrator_params=params)
    (bench / "traffic" / "path.tiny.json").write_text(json.dumps(mix))
    (bench / "metrics" / "waves_in_window.py").write_text(NEW_METRIC)
    (bench / "limits" / "tinyball.path.tiny.json").write_text(
        json.dumps({"rel_l1": 1e-3, "rel_err_median": 1e-5}))
    man = json.load(open(root / "BENCHMARK.json"))
    man["configs"].append({"name": "tinyball", "source": "a test",
                           "file": "benchmark/configs/tinyball.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "tinyball.path.tiny",
                             "config": "tinyball", "traffic": "path.tiny",
                             "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if "workloads" in m and m["name"] == "samples_per_s":
            m["workloads"].append("tinyball.path.tiny")
    man["end_to_end"].append({"name": "waves_in_window", "unit": "waves",
                              "better": "higher", "bound": 0.01,
                              "source": "host_clock",
                              "workloads": ["tinyball.path.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    out = harness.run_cell("tinyball.path.tiny", 2_200_000_001, 0.2, False,
                           device="cpu", bench=str(bench), root=str(root),
                           log=lambda *a: None)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"samples_per_s", "setup_s",
                                   "waves_in_window"}
    assert out["metrics"]["waves_in_window"]["value"] == out["attempted"]
    after = _snapshot(root)
    assert all(after[p] == b for p, b in before.items())
