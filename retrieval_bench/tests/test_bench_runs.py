"""A whole run of each cell on the CPU at a tiny size (the harness's look
for a chip skipped): correct with the program as it is; not correct with
the timed path broken underneath (an answer altered where it is produced,
half of each batch left out), nor with the control in the program's place
(the program's int8 gallery for search, the reference at the next precision
down for extraction)."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from retrieval_bench import harness
from retrieval_bench.tests.tiny import TINY
from retrieval_bench.tools import readings

import image_retrieval_for_image_based_localization_tpu_torch.retrieval.index as port_index
from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
SEED = 2 ** 31 + 12345


def _run(cell, trace=False, seconds=0.6):
    return harness.run(cell, SEED, seconds, trace, time.perf_counter(), device="cpu",
                       overrides=TINY[cell])


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
    names = {m["name"] for m in harness.per_layer_of(harness.load_benchmark(), cell)}
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


FAULTS = [(c, k) for c in CELLS for k in ("altered", "half")
          if not (c.endswith("q1-k100") and k == "half")]


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_broken_path_is_not_correct(cell, kind, monkeypatch):
    if "search" in cell:
        monkeypatch.setattr(port_index, "fused_topk_search", _search_fault(kind))
    else:
        monkeypatch.setattr(Extractor, "forward_u8", _extract_fault(kind))
    r = _run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    nums = readings.control_numbers(cell, SEED + 1, 0.4, device="cpu", overrides=TINY[cell])
    lim = _limits(cell)
    assert any(nums[k] > lim[k] for k in nums), (nums, lim)


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
