"""Port parity: streaming candidate ranks (rank by count) and the harness's
large-gallery branch, against NumPy's full argsort and the JAX package's
``rank_candidates`` (the single-device cases of tests/test_streaming_rank.py).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from irtpu.retrieval.knn import rank_candidates as j_rank_candidates

from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
    make_synthetic_dataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.evaluation.harness import (
    evaluate_dataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (
    candidate_matrix,
    compute_map_and_print,
    compute_map_streaming_and_print,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
    rank_candidates,
    rank_candidates_core,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
    ExtractConfig,
    IndexConfig,
    ModelConfig,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import MetricsLogger
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


def _np_ranks_of(gallery, queries, cand):
    """Oracle: candidate positions in the stable descending argsort."""
    scores = queries @ gallery.T
    order = np.argsort(-scores, axis=1, kind="stable")  # [Nq, Ng]
    pos = np.empty_like(order)
    Nq, Ng = order.shape
    rows = np.arange(Nq)[:, None]
    pos[rows, order] = np.arange(Ng)[None, :]
    return pos[rows, cand]


def _port(g, q, cand, chunk=None):
    out = rank_candidates(torch.from_numpy(g), torch.from_numpy(q), torch.from_numpy(cand),
                          chunk=chunk)
    assert out.dtype == torch.int32 and tuple(out.shape) == cand.shape
    return out.numpy()


def _jax(g, q, cand, chunk=None):
    return np.asarray(j_rank_candidates(jnp.asarray(g), jnp.asarray(q), jnp.asarray(cand),
                                        chunk=chunk))


def test_rank_candidates_matches_argsort_and_jax():
    rng = np.random.RandomState(0)
    g = rng.randn(500, 32).astype(np.float32)
    q = rng.randn(7, 32).astype(np.float32)
    cand = rng.randint(0, 500, size=(7, 13)).astype(np.int32)
    got = _port(g, q, cand)
    np.testing.assert_array_equal(got, _np_ranks_of(g, q, cand))
    np.testing.assert_array_equal(got, _jax(g, q, cand))


@pytest.mark.parametrize("chunk", [None, 128, 100])
def test_rank_candidates_ties_duplicate_gallery(chunk):
    """Adversarial exact ties (25-way duplicate rows): lower index wins, in
    whole chunks, a ragged last chunk, and one chunk."""
    rng = np.random.RandomState(1)
    base = rng.randn(20, 16).astype(np.float32)
    g = np.repeat(base, 25, axis=0)
    q = rng.randn(4, 16).astype(np.float32)
    cand = rng.randint(0, 500, size=(4, 21)).astype(np.int32)
    got = _port(g, q, cand, chunk=chunk)
    np.testing.assert_array_equal(got, _np_ranks_of(g, q, cand))
    np.testing.assert_array_equal(got, _jax(g, q, cand, chunk=chunk))


def test_rank_candidates_chunked_negative_scores():
    rng = np.random.RandomState(2)
    g = -np.abs(rng.randn(300, 24)).astype(np.float32)
    q = np.abs(rng.randn(5, 24)).astype(np.float32)
    cand = rng.randint(0, 300, size=(5, 9)).astype(np.int32)
    got = _port(g, q, cand, chunk=64)
    np.testing.assert_array_equal(got, _np_ranks_of(g, q, cand))
    np.testing.assert_array_equal(got, _jax(g, q, cand, chunk=64))


def test_rank_candidates_bf16_gallery_bit_equal_to_jax():
    """A bf16 gallery (config 5's storage): queries rounded to bf16, exact
    products summed in f32, in both packages; duplicate rows tie."""
    rng = np.random.RandomState(3)
    g = rng.randn(700, 64).astype(np.float32)
    g[400:420] = g[10:30]
    q = rng.randn(6, 64).astype(np.float32)
    cand = rng.randint(0, 700, size=(6, 17)).astype(np.int32)
    cand[:, 0], cand[:, 1] = 15, 405
    gb = g.astype(ml_dtypes.bfloat16)
    got = rank_candidates_core(torch.from_numpy(g).to(torch.bfloat16), torch.from_numpy(q),
                               torch.from_numpy(cand), chunk=256).numpy()
    want = np.asarray(j_rank_candidates(jnp.asarray(gb), jnp.asarray(q), jnp.asarray(cand),
                                        chunk=256))
    np.testing.assert_array_equal(got, want)
    qb = q.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(got, _np_ranks_of(gb.astype(np.float32), qb, cand))
    assert (got[:, 0] < got[:, 1]).all()  # the duplicate's lower row first


def _synthetic_gnd(rng, n_db, nq, revisited):
    gnd = []
    for _ in range(nq):
        perm = rng.permutation(n_db)
        if revisited:
            gnd.append({"easy": perm[:4], "hard": perm[4:9], "junk": perm[9:15],
                        "bbx": [0, 0, 10, 10]})
        else:
            gnd.append({"ok": perm[:6], "junk": perm[6:10]})
    return gnd


@pytest.mark.parametrize("revisited", [True, False])
def test_streaming_map_equals_full_rank_map(revisited):
    rng = np.random.RandomState(4)
    n_db, nq = 400, 9
    g = rng.randn(n_db, 24).astype(np.float32)
    g[50:60] = g[0:10]  # duplicates: junk/positive ties go lower-index first
    q = rng.randn(nq, 24).astype(np.float32)
    gnd = _synthetic_gnd(rng, n_db, nq, revisited)
    ranks_full = np.argsort(-(q @ g.T), axis=1, kind="stable").T  # [Ng, Nq]
    want = compute_map_and_print("synth", ranks_full, gnd)
    cand = candidate_matrix(gnd)
    ranks_all = _port(g, q, cand, chunk=128)
    np.testing.assert_array_equal(ranks_all, _jax(g, q, cand, chunk=128))
    got = compute_map_streaming_and_print("synth", ranks_all, gnd)
    for res_got, res_want in ([(got[p], want[p]) for p in ("easy", "medium", "hard")]
                              if revisited else [(got, want)]):
        assert res_got["map"] == res_want["map"]
        np.testing.assert_allclose(res_got["aps"], res_want["aps"])
        np.testing.assert_allclose(res_got["mprk"], res_want["mprk"])


def test_streaming_map_empty_ok_queries():
    rng = np.random.RandomState(7)
    n_db = 50
    g = rng.randn(n_db, 8).astype(np.float32)
    q = rng.randn(3, 8).astype(np.float32)
    gnd = [{"ok": rng.permutation(n_db)[:4], "junk": []},
           {"ok": np.array([], np.int64), "junk": []},
           {"ok": rng.permutation(n_db)[:3], "junk": rng.permutation(n_db)[10:14]}]
    want = compute_map_and_print("synth", np.argsort(-(q @ g.T), axis=1, kind="stable").T, gnd)
    got = compute_map_streaming_and_print("synth", _port(g, q, candidate_matrix(gnd)), gnd)
    assert got["map"] == want["map"]
    assert np.isnan(got["aps"][1]) and np.isnan(want["aps"][1])


@pytest.fixture(scope="module")
def harness_setup(tmp_path_factory):
    ds = make_synthetic_dataset(str(tmp_path_factory.mktemp("stream")), n_scenes=3,
                                views_per_scene=3, n_distractors=3, image_hw=(64, 80), seed=6)
    cfg = ExtractConfig(model=ModelConfig(arch="resnet18", pooling="gem"), image_size=80,
                        batch_size=4)
    from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor

    ex = Extractor(cfg, seed=0, device="cpu")
    log = str(tmp_path_factory.mktemp("log") / "dense.jsonl")
    dense = evaluate_dataset(ds, cfg, IndexConfig(whitening=None), extractor=ex, device="cpu",
                             recall_ks=(1, 5), logger=MetricsLogger(path=log))
    return ds, cfg, ex, dense, log


def _events(path, event):
    import json

    return [r for r in map(json.loads, open(path)) if r.get("event") == event]


def test_harness_streaming_branch_matches_dense(harness_setup, tmp_path):
    """Over dense_rank_limit (0 here) an exact evaluation streams candidate
    ranks: the same mAP and recall as the dense ranking, and no [Ng, Nq]
    ranking is made."""
    ds, cfg, ex, dense, dense_log = harness_setup
    log = str(tmp_path / "stream.jsonl")
    stream = evaluate_dataset(ds, cfg, IndexConfig(whitening=None), extractor=ex,
                              device="cpu", dense_rank_limit=0, recall_ks=(1, 5),
                              logger=MetricsLogger(path=log))
    for p in ("easy", "medium", "hard"):
        assert stream["results"][p]["map"] == dense["results"][p]["map"]
    assert stream["recall"]["recall"] == dense["recall"]["recall"]
    assert _events(log, "provenance")[0]["ranking_path"] == "streaming"
    assert _events(dense_log, "provenance")[0]["ranking_path"] == "dense"
    prov = _events(log, "provenance")[0]
    assert prov["backend"] == "cpu" and prov["n_devices"] == 1
    assert _events(log, "map")[0]["map_medium"] == dense["results"]["medium"]["map"]


def test_harness_ann_is_honoured_over_the_limit(harness_setup, tmp_path):
    """ann= comes before the streaming branch: over the limit an IVF
    evaluation still measures the IVF shortlist (the JAX harness would
    return the exact mAP there)."""
    ds, cfg, ex, dense, _ = harness_setup
    kw = dict(ann="ivf", ann_kwargs={"n_clusters": 4, "nprobe": 1}, shortlist_k=3)
    log = str(tmp_path / "ann.jsonl")
    over = evaluate_dataset(ds, cfg, IndexConfig(whitening=None), extractor=ex, device="cpu",
                            dense_rank_limit=0, logger=MetricsLogger(path=log), **kw)
    under = evaluate_dataset(ds, cfg, IndexConfig(whitening=None), extractor=ex, device="cpu",
                             **kw)
    assert _events(log, "provenance")[0]["ranking_path"] == "ann-ivf"
    for p in ("easy", "medium", "hard"):
        assert over["results"][p]["map"] == under["results"][p]["map"]
    assert over["results"]["medium"]["map"] <= dense["results"]["medium"]["map"] + 1e-9
