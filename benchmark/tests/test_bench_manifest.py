"""BENCHMARK.json keeps the benchmark's rules of form: its keys, and the
characters of every name and unit."""
import json
import os

import pytest

from benchmark import checks, harness

ROOT = harness.ROOT
MAN = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_and_units_keep_their_characters():
    assert checks.manifest_problems(MAN) == []


@pytest.mark.parametrize("bad", ["has space", "a,b", "x/y", "", "-lead",
                                 "µs", "a" * 65])
def test_bad_names_are_refused(bad):
    man = {"workloads": [{"name": bad, "config": "c", "traffic": "t",
                          "why": "w"}]}
    assert checks.manifest_problems(man)


@pytest.mark.parametrize("unit,ok", [("samples/s", True), ("%", True),
                                     ("kernels/wave", True), ("GiB", True),
                                     ("samples per s", False), ("µs", False),
                                     ("a" * 17, False)])
def test_units(unit, ok):
    man = {"end_to_end": [{"name": "m", "unit": unit, "better": "lower"}]}
    assert (checks.manifest_problems(man) == []) == ok


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(MAN, w["name"],
                                                     "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(MAN, w["name"], "per_layer")


def test_each_layer_metric_moves_a_metric_its_cells_report():
    for m in MAN["per_layer"]:
        for cell in m["workloads"]:
            e2e = {e["name"] for e in harness.metrics_of(MAN, cell,
                                                         "end_to_end")}
            assert m["moves"] in e2e, (m["name"], cell)


def test_every_named_file_exists():
    bench = os.path.join(ROOT, "benchmark")
    for c in MAN["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in MAN["workloads"]:
        for kind, name in (("traffic", w["traffic"]),
                           ("limits", w["name"])):
            assert os.path.isfile(os.path.join(bench, kind, name + ".json"))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert os.path.isfile(os.path.join(bench, "metrics",
                                           m["name"] + ".py"))
