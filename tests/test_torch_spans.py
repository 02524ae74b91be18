"""The port's stage spans (``utils.metrics.span``) on its two hot paths.

Under ``profile_trace`` a tiny ``Extractor.extract`` records
``Extractor.extract`` once with ``Extractor.next_batch``, ``Extractor.h2d``
and ``Extractor.forward`` inside it, and a tiny ``Index.query`` records
``Index.query`` with ``Index.h2d``, ``Index.whiten``, ``Index.topk`` and
``Index.d2h`` inside it, in that order. With the profiler off ``span`` is
one shared no-op, and the outputs equal a profiled call's bit for bit.
"""

import contextlib

import numpy as np
import pytest
import torch

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import (
    profile_trace,
    span,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

EXTRACT_STAGES = ("Extractor.next_batch", "Extractor.h2d", "Extractor.forward")
QUERY_STAGES = ("Index.h2d", "Index.whiten", "Index.topk", "Index.d2h")


@pytest.fixture(scope="module")
def extractor():
    cfg = port.ExtractConfig(model=port.ModelConfig(arch="resnet18"), image_size=32,
                             batch_size=2)
    return port.Extractor(cfg, device="cpu")


@pytest.fixture(scope="module")
def images():
    # one bucket shape, so three images make two batches
    return [np.random.RandomState(i).randint(0, 256, (24, 32, 3)).astype(np.uint8)
            for i in range(3)]


@pytest.fixture(scope="module")
def index():
    r = np.random.RandomState(0)
    g = r.randn(200, 16).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    P = np.linalg.qr(r.randn(16, 16))[0].astype(np.float32)
    return Index(gallery=g, m=r.randn(16).astype(np.float32) * 0.1, P=P,
                 device=torch.device("cpu"))


def _spans(prof, prefix):
    """(name, start, end) of the profiled ranges named ``prefix...``, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(prefix)), key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_extract_spans_nest_in_the_call(extractor, images, tmp_path):
    with profile_trace(str(tmp_path)) as prof:
        extractor.extract(images)
    spans = _spans(prof, "Extractor.")
    calls = [s for s in spans if s[0] == "Extractor.extract"]
    assert len(calls) == 1
    names = [s[0] for s in spans if s is not calls[0]]
    # two batches; one more wait than batches (the background thread's end)
    assert names.count("Extractor.forward") == 2 and names.count("Extractor.h2d") == 2
    assert names.count("Extractor.next_batch") == 3
    assert set(names) == set(EXTRACT_STAGES)
    assert all(_inside(s, calls[0]) for s in spans)
    assert names == ["Extractor.next_batch", "Extractor.h2d", "Extractor.forward"] * 2 + [
        "Extractor.next_batch"]


def test_query_spans_in_order(index, tmp_path):
    q = np.random.RandomState(1).randn(3, 16).astype(np.float32)
    with profile_trace(str(tmp_path)) as prof:
        index.query(q, k=5)
    spans = _spans(prof, "Index.")
    assert [s[0] for s in spans] == ["Index.query", *QUERY_STAGES]
    assert all(_inside(s, spans[0]) for s in spans[1:])
    # the stages follow one another without overlapping
    assert all(a[2] <= b[1] for a, b in zip(spans[1:], spans[2:]))


def test_span_off_is_one_noop_and_outputs_match_a_profiled_call(extractor, images, index,
                                                                 tmp_path):
    assert not torch.autograd._profiler_enabled()
    off = span("Index.query")
    assert off is span("Extractor.extract") and isinstance(off, contextlib.nullcontext)
    q = np.random.RandomState(2).randn(4, 16).astype(np.float32)
    d_off, (s_off, i_off) = extractor.extract(images), index.query(q, k=7)
    with profile_trace(str(tmp_path)) as prof:
        assert not isinstance(span("Index.query"), contextlib.nullcontext)
        d_on, (s_on, i_on) = extractor.extract(images), index.query(q, k=7)
    assert {"Extractor.extract", "Index.query"} <= {e.name for e in prof.events()}
    assert d_on.tobytes() == d_off.tobytes()
    assert s_on.tobytes() == s_off.tobytes() and np.array_equal(i_on, i_off)
