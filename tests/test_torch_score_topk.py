"""Port parity: the score/block-max kernel's plain version against the JAX
package's ``scores_blockmax`` in interpret mode (scores within 1e-5, block
maxima exact), and the exact long-shortlist searches built on it against
``pallas_topk_search``, ``knn_search`` and ``Index.query``: bitwise
indices, ties included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from irtpu.ops.pallas.score_topk import pallas_topk_search as j_search
from irtpu.ops.pallas.score_topk import scores_blockmax as j_scores_blockmax
from irtpu.retrieval.index import Index as JIndex
from irtpu.retrieval.knn import knn_search as j_knn
from irtpu.utils import config as jcfg

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    blockmax_topk_search,
    scores_blockmax,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.score_topk import (
    NEG_INF,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import knn_search
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


def _case(name, seed=0):
    rng = np.random.RandomState(seed)
    if name == "random":
        g = rng.randn(1100, 48).astype(np.float32)
        q = rng.randn(7, 48).astype(np.float32)
    elif name == "heavy_duplicates":
        # 40x duplicated rows spanning block and chunk boundaries
        g = np.repeat(rng.randn(30, 24).astype(np.float32), 40, axis=0)
        q = rng.randn(5, 24).astype(np.float32)
    else:  # all scores negative, and Ng = 1000 is not a multiple of 64
        g = -np.abs(rng.randn(1000, 32)).astype(np.float32) - 0.1
        q = np.abs(rng.randn(4, 32)).astype(np.float32) + 0.1
    return g, q


@pytest.mark.parametrize("case", ["random", "all_negative_with_pad"])
def test_scores_blockmax_matches_pallas(case):
    g, q = _case(case)
    s, bmax = scores_blockmax(torch.from_numpy(g), torch.from_numpy(q))
    s, bmax = s.numpy(), bmax.numpy()
    js, jb = j_scores_blockmax(jnp.asarray(g), jnp.asarray(q), interpret=True)
    js, jb = np.asarray(js), np.asarray(jb)
    Ng, nb = g.shape[0], bmax.shape[1]
    assert s.shape == (q.shape[0], nb * 64) and nb == -(-Ng // 64)
    np.testing.assert_allclose(s[:, :Ng], js[:, :Ng], rtol=0, atol=1e-5)
    assert np.all(s[:, Ng:] == NEG_INF) and np.all(js[:, Ng:] == NEG_INF)
    np.testing.assert_array_equal(bmax, s.reshape(len(q), nb, 64).max(-1))
    np.testing.assert_allclose(bmax, jb[:, :nb], rtol=0, atol=1e-5)
    assert np.all(jb[:, nb:] == NEG_INF)  # the JAX package pads to 512 columns


@pytest.mark.parametrize("k", [37, 200, 1000])
@pytest.mark.parametrize("case", ["random", "heavy_duplicates", "all_negative_with_pad"])
def test_blockmax_topk_search_matches_pallas(case, k):
    g, q = _case(case)
    s, i = blockmax_topk_search(torch.from_numpy(g), torch.from_numpy(q), k)
    js, ji = j_search(jnp.asarray(g), jnp.asarray(q), k=k, interpret=True)
    kk = min(k, g.shape[0])
    assert i.shape == (len(q), kk) and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    want = np.argsort(-(q @ g.T), axis=1, kind="stable")[:, :kk]
    if case == "heavy_duplicates":  # integer-exact ties: check against argsort too
        np.testing.assert_array_equal(i.numpy(), want)


@pytest.mark.parametrize("k", [37, 200, 1000])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_knn_search_matches_jax(storage, k):
    g, q = _case("heavy_duplicates", seed=1)
    tg = torch.from_numpy(g)
    jg = jnp.asarray(g)
    if storage == "bfloat16":
        tg = tg.to(torch.bfloat16)
        jg = jnp.asarray(tg.float().numpy(), jnp.bfloat16)
    s, i = knn_search(tg, torch.from_numpy(q), k=k, chunk=256)
    js, ji = j_knn(jg, jnp.asarray(q), k=k, chunk=256)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)


def test_index_query_k300_matches_jax():
    """k > 128 leaves the fused top-k for knn_search; same indices as JAX."""
    rng = np.random.RandomState(2)
    base = rng.randn(120, 40).astype(np.float32)
    db = np.concatenate([base, base[::3], rng.randn(400, 40).astype(np.float32)])
    qd = rng.randn(6, 40).astype(np.float32)
    cfg = port.IndexConfig(whitening="pca")
    s, i = port.build_index(db, cfg, device="cpu").query(qd, k=300)
    js, ji = JIndex.build(db, jcfg.IndexConfig(whitening="pca")).query(qd, k=300)
    assert i.shape == (6, 300)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=1e-5)


def test_cpu_path_never_counts_a_launch():
    g, q = _case("random")
    before = scores_blockmax.launches
    blockmax_topk_search(torch.from_numpy(g), torch.from_numpy(q), 200)
    knn_search(torch.from_numpy(g), torch.from_numpy(q), 200)
    assert scores_blockmax.launches == before


def test_bad_inputs_raise():
    g = torch.zeros((10, 8))
    with pytest.raises(ValueError, match="k must be"):
        blockmax_topk_search(g, torch.zeros((2, 8)), 0)
    with pytest.raises(ValueError, match="need gallery"):
        scores_blockmax(g, torch.zeros((2, 7)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        scores_blockmax(g.to(torch.int8), torch.zeros((2, 8)))


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("ng", [1, 63, 65, 1000, 100_003, 1_000_000])
@pytest.mark.parametrize("nq", [1, 7, 8, 9, 20, 32, 33, 64, 65, 256])
def test_blockmax_plan_covers_padded_columns_in_whole_tiles(nq, ng, sms):
    """scores_blockmax launches on the fused top-k's plan: in the small-batch
    form each split's 256-row runs hold whole 64-column blocks, the splits
    cover the padded columns [0, 64 * ceil(Ng / 64)) once, and the last run
    holds the pad; the 128-row form's grid covers them in 128-column tiles."""
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.fused_topk import (
        NARROW_MAX_NQ,
        _plan,
        _split_rows,
    )

    plan = _plan(nq, ng, sms)
    ng_pad = 64 * -(-ng // 64)
    assert plan.split_rows % 64 == 0  # no 64-column block spans two splits
    if nq > NARROW_MAX_NQ:
        assert plan.width == 128 and -(-ng_pad // 128) * 128 >= ng_pad
        return
    assert plan.width == min(32, -(-nq // 8) * 8) and plan.q_tiles == -(-nq // plan.width)
    covered = []
    for s in range(plan.n_splits):
        start, end = _split_rows(s, plan.n_splits, ng, plan.split_rows)
        u0, u1 = start // plan.split_rows, -(-end // plan.split_rows)
        covered.append((u0 * plan.split_rows, min(ng_pad, u1 * plan.split_rows)))
    assert covered[0][0] == 0 and covered[-1][1] == ng_pad
    assert all(e0 == s1 for (_, e0), (s1, _) in zip(covered, covered[1:]))
    assert all(s % 64 == 0 and e % 64 == 0 for s, e in covered)
