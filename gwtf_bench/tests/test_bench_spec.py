"""BENCHMARK.json against the benchmark's contract, and every file that a
name in it points to."""

import json
import os
import re

import pytest

from gwtf_bench import run

ROOT = run.ROOT
SPEC = run.Spec()
RAW = SPEC.raw
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = RAW["end_to_end"] + RAW["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(RAW) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert RAW["paths"] == ["gwtf_bench"]
    assert 1 <= RAW["run_seconds"] <= 51
    assert len(RAW["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in RAW["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


@pytest.mark.parametrize("entry", RAW["configs"] + RAW["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.fullmatch(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.fullmatch(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names():
    for group in (RAW["configs"], RAW["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_entry_keys():
    for c in RAW["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for w in RAW["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in RAW["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in RAW["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert "setup_s" in {m["name"] for m in RAW["end_to_end"]}


@pytest.mark.parametrize("cell", RAW["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    cfg = SPEC.config(cell)
    traffic = SPEC.traffic(cell)
    limits = SPEC.limits(cell)
    assert os.path.isfile(os.path.join(run.BENCH_DIR, "kinds",
                                       f"{traffic['kind']}.py"))
    assert limits and all(v > 0 for v in limits.values())
    assert cfg["source"]
    for trace in (False, True):
        for m in SPEC.metrics(cell, trace):
            assert callable(run.reader(m["name"]))


@pytest.mark.parametrize("cell", RAW["workloads"], ids=lambda c: c["name"])
def test_each_cell_reports_setup_another_and_a_layer(cell):
    e2e = {m["name"] for m in SPEC.metrics(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = SPEC.metrics(cell, True)
    assert layers
    for m in layers:  # every cell of a metric reports what it moves
        assert m["moves"] in e2e


def test_metric_workloads_exist():
    cells = {w["name"] for w in RAW["workloads"]}
    for m in METRICS:
        assert set(m.get("workloads", [])) <= cells
    for c in RAW["configs"]:
        assert c["name"] in {w["config"] for w in RAW["workloads"]}
    layers = {}
    for m in RAW["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("config", RAW["configs"], ids=lambda c: c["name"])
def test_config_is_the_published_yaml_but_reduced(config):
    """Every key of the published YAML is in the file with its value,
    except the keys listed in `reduced`."""
    from go_with_the_flows_tpu_torch.utils.config import load_config

    with open(os.path.join(ROOT, config["file"])) as f:
        mine = json.load(f)
    yaml = {"airplane": "config_generative_modeling_airplane.yaml",
            "svr": "config_SVR.yaml"}[config["name"]]
    published = load_config(os.path.join(ROOT, "configs", yaml))
    changed = {k for k, v in published.items() if mine.get(k) != v}
    assert changed == set(config["reduced"])
    assert set(mine["reduced"]) == set(config["reduced"])
