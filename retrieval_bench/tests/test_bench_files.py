"""BENCHMARK.json and the files it names: found by name, well formed, and
a cell added as a new file only."""

import json
import os
import re
import shutil

import pytest

from retrieval_bench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["retrieval_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = set(e) - ENTRY_KEYS[section] - ({"workloads"} if section in (
            "end_to_end", "per_layer") else set())
        assert ENTRY_KEYS[section] <= set(e) and not extra, (e["name"], extra)
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
        for k in e.get("reduced", []):
            assert NAME.match(k)


def test_metrics_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry, wl, cfg, traffic = harness.resolve(cell, BENCH)
    assert wl["name"] == cell and wl["why"] == entry["why"]
    assert entry["chips"] == 1
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "drivers", f"{traffic['driver']}.py"))
    assert cfg["name"] == entry["config"]
    assert set(wl["limits"])
    e2e = harness.end_to_end_of(BENCH, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert harness.per_layer_of(BENCH, cell)
    for m in harness.per_layer_of(BENCH, cell):
        assert m["moves"] in {x["name"] for x in e2e}


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = os.path.join(harness.ROOT, cfg["file"])
    assert cfg["file"].startswith("retrieval_bench/configs/")
    with open(path) as f:
        body = json.load(f)
    assert body["name"] == cfg["name"] and body["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_layer_metric_readers(metric):
    reader = harness.load_module("layer_metrics", metric)
    assert callable(reader.read)


def test_a_new_cell_is_a_new_file(tmp_path):
    """A cell added as files only: the harness lists it and resolves its
    configuration, traffic and driver without an edit to any file there."""
    copy = tmp_path / "retrieval_bench"
    shutil.copytree(harness.BENCH_DIR, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    (copy / "traffic" / "search-q8-k50.json").write_text(json.dumps(
        {**json.loads((copy / "traffic" / "search-q20-k100.json").read_text()),
         "batch": 8, "k": 50}))
    (copy / "workloads" / "aachen-1m-pod.search-q8-k50.json").write_text(json.dumps(
        {"name": "aachen-1m-pod.search-q8-k50", "config": "aachen-1m-pod",
         "traffic": "search-q8-k50", "why": "a dummy cell", "limits": {"rank_gap": 1e-4}}))
    assert "aachen-1m-pod.search-q8-k50" in harness.list_workloads(str(copy))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "aachen-1m-pod.search-q8-k50", "config": "aachen-1m-pod",
         "traffic": "search-q8-k50", "chips": 1, "why": "a dummy cell"}])
    _, _, cfg, traffic = harness.resolve("aachen-1m-pod.search-q8-k50", bench,
                                         bench_dir=str(copy))
    assert traffic["batch"] == 8 and cfg["name"] == "aachen-1m-pod"
    assert {p: p.read_bytes() for p in before} == before


def test_every_workload_file_is_a_cell():
    assert harness.list_workloads() == sorted(w["name"] for w in BENCH["workloads"])
