"""A whole run of each cell on the CPU at a tiny size (the harness's look
for a chip skipped): correct with the program as it is; not correct with
the timed path broken underneath (each fault its tiny file lists: an
answer altered where it is produced, half of each batch left out), nor with
the control in the program's place (``readings.control_numbers``: the
driver's own, else the program's int8 gallery for search and the reference
at the next precision down for extraction). Each cell's cut is its tiny
file, found by name (``tiny.py``); its fault is planted where its driver
produces answers (``FAULT_SITES``)."""

import json
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from retrieval_bench import harness
from retrieval_bench.tests.tiny import tiny
from retrieval_bench.tools import readings, tiny_numbers

import image_retrieval_for_image_based_localization_tpu_torch.retrieval.index as port_index
from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 12345


def _run(cell, trace=False, seconds=0.6):
    return harness.run(cell, SEED, seconds, trace, time.perf_counter(), device="cpu",
                       overrides=tiny(cell))


def _limits(cell):
    return harness.load_json("workloads", cell)["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert list(r)[-1] == "checks"
    for k, v in r["checks"].items():
        assert v["limit"] == _limits(cell)[k]


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[1]])
def test_traced_run(cell):
    r = _run(cell, trace=True)
    assert r["correct"], r["checks"]
    assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r
    names = {m["name"] for m in harness.per_layer_of(BENCH, cell)}
    assert set(r["metrics"]) <= names


def _search_fault(kind):
    real = port_index.fused_topk_search

    def broken(gallery, queries, k):
        s, i = real(gallery, queries, k)
        s, i = s.clone(), i.clone()
        if kind == "altered":
            i[0, 0] = (i[0, 0] + gallery.shape[0] // 2) % gallery.shape[0]
        else:  # half of the batch left out: its rows get the other half's answers
            h = (queries.shape[0] + 1) // 2
            s[h:], i[h:] = s[: queries.shape[0] - h], i[: queries.shape[0] - h]
        return s, i

    return broken


def _extract_fault(kind):
    real = Extractor.forward_u8

    def broken(self, pixels_u8, sizes):
        d = real(self, pixels_u8, sizes).clone()
        if kind == "altered":  # each answer handed to the wrong image
            return torch.roll(d, 1, dims=0)
        d[d.shape[0] // 2:] = 0  # half of the batch left out
        return d

    return broken


# where each driver's answers are produced: (object, attribute, the broken
# attribute of a fault kind)
FAULT_SITES = {
    "search": (port_index, "fused_topk_search", _search_fault),
    "extract": (Extractor, "forward_u8", _extract_fault),
}


def fault_site(driver: str, bench_dir: str = harness.BENCH_DIR):
    """The driver's line in ``FAULT_SITES``, else the line of the driver
    whose ``Cell`` its ``Cell`` derives from; a driver with neither fails
    the test, named."""
    prefix = "retrieval_bench.drivers."
    for base in harness.load_module("drivers", driver, bench_dir).Cell.__mro__:
        name = base.__module__[len(prefix):] if base.__module__.startswith(prefix) else None
        if name in FAULT_SITES:
            return FAULT_SITES[name]
    pytest.fail(f"driver {driver!r} has no fault site: add its line to FAULT_SITES "
                f"in retrieval_bench/tests/test_bench_runs.py")


def _fault_cases() -> list:
    """(cell, kind) for each fault a cell's tiny file lists; a cell without
    one gives one case, which fails naming the file to add."""
    cases = []
    for c in CELLS:
        try:
            kinds = tiny(c)["faults"]
        except FileNotFoundError:
            kinds = ["altered"]
        cases += [(c, k) for k in kinds]
    return cases


@pytest.mark.parametrize("cell,kind", _fault_cases())
def test_broken_path_is_not_correct(cell, kind, monkeypatch):
    obj, attr, fault = fault_site(harness.resolve(cell, BENCH, tiny(cell))[3]["driver"])
    monkeypatch.setattr(obj, attr, fault(kind))
    r = _run(cell)
    assert not r["correct"], r["checks"]


def _driver_files(tmp_path):
    d = tmp_path / "drivers"
    d.mkdir()
    (d / "extract_sorted.py").write_text(
        "from retrieval_bench.drivers.extract import Cell as _Extract\n\n\n"
        "class Cell(_Extract):\n    pass\n")
    (d / "lonely.py").write_text("class Cell:\n    pass\n")
    return str(tmp_path)


@pytest.mark.parametrize("driver", sorted(FAULT_SITES))
def test_fault_site_by_the_drivers_name(driver):
    assert fault_site(driver) is FAULT_SITES[driver]


def test_fault_site_of_a_derived_driver_is_its_bases(tmp_path):
    assert fault_site("extract_sorted", _driver_files(tmp_path)) is FAULT_SITES["extract"]


def test_a_driver_without_a_fault_site_fails_named(tmp_path):
    with pytest.raises(pytest.fail.Exception, match="driver 'lonely' has no fault site"):
        fault_site("lonely", _driver_files(tmp_path))


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    nums = readings.control_numbers(cell, SEED + 1, 0.4, device="cpu", overrides=tiny(cell))
    lim = _limits(cell)
    assert any(nums[k] > lim[k] for k in nums), (nums, lim)


def test_control_is_the_drivers_own_where_it_has_one(monkeypatch):
    """A driver module that defines ``control_numbers`` is handed the cell's
    configuration and traffic as resolved, the seed, the seconds and the
    device, and its numbers are the control's."""
    seen = []
    own = types.SimpleNamespace(control_numbers=lambda *a: seen.append(a) or {"n": 1.0})
    real = harness.load_module
    monkeypatch.setattr(harness, "load_module",
                        lambda kind, *a: own if kind == "drivers" else real(kind, *a))
    cell = CELLS[0]
    assert readings.control_numbers(cell, 7, 0.25, device="cpu",
                                    overrides=tiny(cell)) == {"n": 1.0}
    _, _, cfg, traffic = harness.resolve(cell, BENCH, tiny(cell))
    assert seen == [(cfg, traffic, 7, 0.25, "cpu")]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_numbers_repeat(cell):
    """``tools/tiny_numbers.py`` reads the same numbers twice, so two trees
    can be compared by them."""
    assert tiny_numbers.numbers(cell) == tiny_numbers.numbers(cell)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "retrieval_bench.run", "--workload", cell,
                          "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r
    assert np.isfinite([m["value"] for m in r["metrics"].values()]).all()
