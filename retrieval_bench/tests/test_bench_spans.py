"""The readers of the program's spans (``layer_metrics/_spans.py``): each
against a hand-computed value on a window with hand-placed operations and
spans (a span straddling an operation, two calls, a call cut by the
window's start), None with no operations or no span of its name; and a CPU
traced run of one extraction and one search cell, whose window holds the
program's spans."""

import time
import types

import pytest

from retrieval_bench import harness
from retrieval_bench import trace as tr_mod
from retrieval_bench.tests.tiny import tiny

EXTRACT = ["extract_idle_pct.next_batch", "extract_idle_pct.h2d", "extract_idle_pct.forward",
           "extract_first_batch_ms"]
QUERY = ["query_idle_ms.h2d", "query_idle_ms.whiten", "query_idle_ms.topk",
         "query_idle_ms.d2h"]
SEED = 2 ** 31 + 777

# the card busy over [0, 1], [2, 3] and [5, 6] of a 10 s window
KERNELS = [("k", 0.0, 1.0), ("k", 2.0, 3.0), ("k", 5.0, 6.0), ("copy", 5.5, 5.8)]
EXTRACT_HOST = [
    ("Extractor.next_batch", 0.1, 0.4),     # its call began before the window
    ("Extractor.extract", 0.5, 7.5),
    ("Extractor.next_batch", 0.5, 2.5),     # straddles two operations: idle 1.0
    ("Extractor.h2d", 2.5, 2.6),            # busy throughout: 0
    ("Extractor.forward", 2.6, 4.0),        # idle 1.0
    ("Extractor.next_batch", 4.0, 5.5),     # idle 1.0
    ("Extractor.h2d", 6.5, 6.6),            # idle 0.1
    ("Extractor.forward", 6.6, 6.9),        # idle 0.3
    ("Extractor.next_batch", 7.0, 7.5),     # idle 0.5
    ("Extractor.extract", 8.0, 9.5),
    ("Extractor.next_batch", 8.0, 8.3),     # idle 0.3
    ("aten::mm", 6.6, 6.7),
]
QUERY_HOST = [
    ("Index.h2d", 0.2, 0.4),                # its call began before the window
    ("Index.topk", 0.4, 1.4),
    ("Index.query", 1.5, 4.5),
    ("Index.h2d", 1.5, 1.7),                # idle 0.2
    ("Index.whiten", 1.7, 2.2),             # idle 0.3
    ("Index.topk", 2.2, 3.5),               # straddles [2, 3]: idle 0.5
    ("Index.d2h", 3.5, 4.5),                # idle 1.0
    ("Index.query", 6.5, 8.0),
    ("Index.h2d", 6.5, 6.6),                # idle 0.1
    ("Index.whiten", 6.6, 6.9),             # idle 0.3
    ("Index.topk", 6.9, 7.0),               # idle 0.1
    ("Index.d2h", 7.0, 8.0),                # idle 1.0
]
WANT = {
    "extract_idle_pct.next_batch": 100 * (1.0 + 1.0 + 0.5 + 0.3) / 10,
    "extract_idle_pct.h2d": 100 * 0.1 / 10,
    "extract_idle_pct.forward": 100 * (1.0 + 0.3) / 10,
    "extract_first_batch_ms": 1e3 * (2.0 + 0.3) / 2,   # median of the calls' first waits
    "query_idle_ms.h2d": 1e3 * (0.2 + 0.1) / 2,
    "query_idle_ms.whiten": 1e3 * (0.3 + 0.3) / 2,
    "query_idle_ms.topk": 1e3 * (0.5 + 0.1) / 2,
    "query_idle_ms.d2h": 1e3 * (1.0 + 1.0) / 2,
}


def _ctx(kernels, host, wall_s=10.0):
    w = types.SimpleNamespace(kernels=list(kernels), host=list(host), wall_s=wall_s)
    return types.SimpleNamespace(window=w, counters={}, cell="synthetic")


def _read(metric, ctx):
    return harness.load_module("layer_metrics", metric).read(ctx)


@pytest.mark.parametrize("metric", EXTRACT + QUERY)
def test_reader_reads_the_hand_computed_value(metric):
    host = EXTRACT_HOST if metric in EXTRACT else QUERY_HOST
    assert _read(metric, _ctx(KERNELS, host)) == pytest.approx(WANT[metric], abs=1e-9)


@pytest.mark.parametrize("metric", EXTRACT + QUERY)
def test_reader_gives_none_without_operations_or_spans(metric):
    host = EXTRACT_HOST if metric in EXTRACT else QUERY_HOST
    assert _read(metric, _ctx([], host)) is None
    other = [("bench.extract.list", 0.0, 9.0), ("aten::mm", 1.0, 2.0)]
    assert _read(metric, _ctx(KERNELS, other)) is None
    assert _read(metric, types.SimpleNamespace(window=None, counters={}, cell="x")) is None


def test_idle_is_the_uncovered_part_of_the_union():
    from retrieval_bench.layer_metrics import _spans

    assert _spans.union([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    # overlapping spans count once; an operation past both ends covers all
    assert _spans.idle_s([(0, 2), (1, 3)], [(0.5, 1.0), (2.5, 9)]) == pytest.approx(2.0)
    assert _spans.idle_s([(1, 2)], [(0, 3)]) == 0.0
    assert _spans.inside([(1, 2), (2.5, 3.5), (4, 5)], [(0, 3), (3.6, 6)]) == [(1, 2), (4, 5)]


@pytest.mark.parametrize("cell,stages", [
    ("r50-gem-pca-roxford5k.extract-db",
     {"Extractor.extract", "Extractor.next_batch", "Extractor.h2d", "Extractor.forward"}),
    ("aachen-1m-pod.search-q20-k100",
     {"Index.query", "Index.h2d", "Index.whiten", "Index.topk", "Index.d2h"}),
])
def test_traced_run_holds_the_program_spans(cell, stages, monkeypatch):
    """A CPU traced run: the program's spans are in the window's main
    thread, none of them named as the benchmark's own; with the card's
    operations put in by hand (a CPU run has none) each new reader of the
    cell reads a number."""
    windows = []

    class Kept(tr_mod.Window):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            windows.append(self)

    monkeypatch.setattr(tr_mod, "Window", Kept)
    r = harness.run(cell, SEED, 0.6, True, time.perf_counter(), device="cpu",
                    overrides=tiny(cell))
    assert r["correct"], r["checks"]
    w = windows[-1]
    names = {n for n, _, _ in w.host}
    assert stages <= names
    assert not any(n.startswith(tr_mod.SPAN_PREFIX) for n in stages)
    t0 = min(s for _, s, _ in w.host)
    w.kernels = [("k", t0, t0 + 1e-6)]
    ctx = types.SimpleNamespace(window=w, counters={}, cell=cell)
    metrics = [m["name"] for m in harness.per_layer_of(harness.load_benchmark(), cell)
               if m["source"] == "program_span"]
    assert metrics == (EXTRACT if "extract" in cell else QUERY)
    for m in metrics:
        v = _read(m, ctx)
        assert v is not None and v >= 0, m
