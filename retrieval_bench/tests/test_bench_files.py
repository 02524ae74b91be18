"""BENCHMARK.json and the files it names: found by name, well formed, and
a cell, or a configuration with a driver of its own, added as new files
only."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from retrieval_bench import harness
from retrieval_bench.tests import tiny

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


def test_every_cell_has_a_tiny_file():
    cells = {w["name"] for w in BENCH["workloads"]}
    files = set(tiny.list_tiny())
    assert not cells - files, f"cells with no tests/tiny/<cell>.json: {sorted(cells - files)}"
    assert not files - cells, f"tiny files that name no cell: {sorted(files - cells)}"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_tiny_file_well_formed(cell):
    cut = tiny.tiny(cell)
    assert set(cut) == {"config", "traffic", "faults"}, set(cut)
    assert cut["faults"] and len(set(cut["faults"])) == len(cut["faults"])
    assert set(cut["faults"]) <= set(tiny.FAULT_KINDS), cut["faults"]
    _, _, cfg, _ = harness.resolve(cell, BENCH, cut)
    assert cfg["name"] == harness.cell_entry(BENCH, cell)["config"]


def test_a_missing_tiny_file_names_the_file_to_add():
    with pytest.raises(FileNotFoundError, match=re.escape(
            os.path.join("retrieval_bench", "tests", "tiny", "no-such.cell.json"))):
        tiny.tiny("no-such.cell")


TWIN_DRIVER = '''"""Extraction traffic as ``extract``'s, with a control of its own."""

from retrieval_bench.drivers.extract import Cell as _Extract, reference_descriptors
from retrieval_bench.reference import extract as ref


class Cell(_Extract):
    pass


def control_numbers(cfg, traffic, seed, seconds, device):
    """The reference with its convolutions in TF32 against the reference,
    one pool image of each shape."""
    items = [(tuple(s), 0) for s in sorted(map(tuple, cfg["images"]["shapes"]))]
    n = traffic["pool_per_shape"]
    return ref.compare(reference_descriptors(cfg, seed, device, items, n, control="tf32"),
                       reference_descriptors(cfg, seed, device, items, n))
'''


def test_a_new_configuration_and_driver_are_new_files(tmp_path):
    """In a copy of the benchmark: a configuration (r50's under another
    name), a traffic file naming a driver of its own (a ``Cell`` derived from
    ``extract``'s and a ``control_numbers``), its cell's workload and tiny
    files, and entries in BENCHMARK.json. The benchmark's own tests, run in
    the copy, find the cell: its tiny run is correct, its control and each
    of its faults are not; and no file the copy held before has changed."""
    base, old = "r50-gem-pca-roxford5k", "r50-gem-pca-roxford5k.extract-db"
    cfg_name, traffic_name = "r50-twin", "extract-twin"
    cell = f"{cfg_name}.{traffic_name}"
    copy = tmp_path / "retrieval_bench"
    shutil.copytree(harness.BENCH_DIR, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}

    def load(*parts):
        return json.loads(copy.joinpath(*parts).read_text())

    (copy / "configs" / f"{cfg_name}.json").write_text(
        json.dumps({**load("configs", f"{base}.json"), "name": cfg_name}))
    (copy / "traffic" / f"{traffic_name}.json").write_text(
        json.dumps({**load("traffic", "extract-db.json"), "driver": "extract_twin"}))
    (copy / "drivers" / "extract_twin.py").write_text(TWIN_DRIVER)
    (copy / "workloads" / f"{cell}.json").write_text(json.dumps(
        {**load("workloads", f"{old}.json"), "name": cell, "config": cfg_name,
         "traffic": traffic_name}))
    (copy / "tests" / "tiny" / f"{cell}.json").write_text(
        json.dumps(load("tests", "tiny", f"{old}.json")))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({**next(c for c in bench["configs"] if c["name"] == base),
                             "name": cfg_name, "file": f"retrieval_bench/configs/{cfg_name}.json"})
    bench["workloads"].append({**harness.cell_entry(bench, old), "name": cell,
                               "config": cfg_name, "traffic": traffic_name})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if old in m.get("workloads", []):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    tests = "retrieval_bench/tests/"
    nodes = [f"{tests}test_bench_files.py::{t}" for t in (
        "test_every_workload_file_is_a_cell", "test_every_cell_has_a_tiny_file",
        f"test_cell_files_found_by_name[{cell}]", f"test_config_files[{cfg_name}]",
        f"test_tiny_file_well_formed[{cell}]")]
    nodes += [f"{tests}test_bench_runs.py::{t}[{cell}{k}]" for t, k in (
        ("test_cell_runs_correct", ""), ("test_control_is_not_correct", ""),
        ("test_broken_path_is_not_correct", "-altered"),
        ("test_broken_path_is_not_correct", "-half"))]
    env = {**os.environ, "PYTHONDONTWRITEBYTECODE": "1",
           "PYTHONPATH": os.pathsep.join([str(tmp_path), harness.ROOT] + [
               p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          "-p", "no:randomly", *nodes], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and f"{len(nodes)} passed" in out.stdout, \
        out.stdout[-4000:] + out.stderr[-2000:]
    assert {p: p.read_bytes() for p in before} == before
