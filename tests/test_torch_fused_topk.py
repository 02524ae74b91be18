"""Port parity: the fused top-k's plain version against the JAX package's
``fused_topk_search`` in interpret mode (exact f32 scores), bitwise on
indices, and the chunked exact search against ``knn_search``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from irtpu.ops.pallas.fused_topk import fused_topk_search as j_topk
from irtpu.retrieval.knn import knn_search as j_knn

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    fused_topk_search,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.fused_topk import (
    NARROW_MAX_NQ,
    NARROW_WIDTHS,
    _plan,
    _split_rows,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
    knn_search,
    score_matrix,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


def _both(g, q, k, ch=256):
    s, i = fused_topk_search(torch.from_numpy(g), torch.from_numpy(q), k)
    js, ji = j_topk(jnp.asarray(g), jnp.asarray(q), k=k, ch=ch, interpret=True)
    return s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji)


@pytest.mark.parametrize("case", ["random", "heavy_duplicates", "integer_ties_k128"])
def test_matches_pallas(case):
    rng = np.random.RandomState(0)
    if case == "random":
        g = rng.randn(1500, 64).astype(np.float32)
        q = rng.randn(16, 64).astype(np.float32)
        k = 100
    elif case == "heavy_duplicates":
        # 25x duplicated rows spanning chunk boundaries: lower index wins
        g = np.repeat(rng.randn(48, 16).astype(np.float32), 25, axis=0)
        q = rng.randn(9, 16).astype(np.float32)
        k = 64
    else:
        g = rng.randint(0, 3, size=(700, 8)).astype(np.float32)
        q = rng.randint(0, 3, size=(5, 8)).astype(np.float32)
        k = 128
    s, i, js, ji = _both(g, q, k)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-6, atol=1e-6)
    assert i.dtype == np.int32 and s.dtype == np.float32


def test_k_above_gallery_is_clamped():
    rng = np.random.RandomState(1)
    g = rng.randn(37, 16).astype(np.float32)
    q = rng.randn(3, 16).astype(np.float32)
    s, i, js, ji = _both(g, q, 100, ch=128)
    assert i.shape == (3, 37)
    np.testing.assert_array_equal(i, ji)
    assert i.max() < 37


def test_bf16_gallery():
    rng = np.random.RandomState(2)
    g = rng.randn(600, 32).astype(np.float32)
    q = rng.randn(4, 32).astype(np.float32)
    gt = torch.from_numpy(g).to(torch.bfloat16)
    s, i = fused_topk_search(gt, torch.from_numpy(q), 30)
    js, ji = j_topk(jnp.asarray(gt.float().numpy(), jnp.bfloat16), jnp.asarray(q),
                    k=30, ch=256, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)


def test_k129_raises():
    g = torch.zeros((10, 8))
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="k <= 128"):
        fused_topk_search(g, q, 129)


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_chunked_knn_matches_jax(storage):
    """k > 128 and int8 storage take the chunked stable-sort search."""
    rng = np.random.RandomState(3)
    base = rng.randn(40, 24).astype(np.float32)
    g = np.repeat(base, 13, axis=0)  # ties across the 128-row chunks
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = rng.randn(6, 24).astype(np.float32)
    if storage == "int8":
        gq = np.clip(np.round(g * 127.0), -127, 127).astype(np.int8)
        tg, jg = torch.from_numpy(gq), jnp.asarray(gq)
    elif storage == "bfloat16":
        tg = torch.from_numpy(g).to(torch.bfloat16)
        jg = jnp.asarray(tg.float().numpy(), jnp.bfloat16)
    else:
        tg, jg = torch.from_numpy(g), jnp.asarray(g)
    s, i = knn_search(tg, torch.from_numpy(q), k=200, chunk=128)
    js, ji = j_knn(jg, jnp.asarray(q), k=200, chunk=128)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    full = score_matrix(tg, torch.from_numpy(q)).numpy()
    want = np.argsort(-full, axis=1, kind="stable")[:, :200]
    np.testing.assert_array_equal(i.numpy(), want)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("ng", [1, 63, 128, 129, 100_000, 1_000_000])
@pytest.mark.parametrize("nq", [1, 20, 256, 257, 2, 7, 8, 9, 16, 17, 24, 31, 32, 33, 64, 65, 127])
def test_split_plan_covers_gallery_in_whole_tiles(nq, ng, sms):
    """The grid of both exact-search kernels: the query tile is Nq rounded
    up to 8 up to the cutover (small-batch form, splits of 256-row runs) and
    128 above it (128-row tiles); every gallery row in exactly one split,
    splits start on a run and are never empty, are balanced, and the grid
    fills the card where the shape allows."""
    plan = _plan(nq, ng, sms)
    if nq <= NARROW_MAX_NQ:
        assert plan.width == min(NARROW_WIDTHS[-1], -(-nq // 8) * 8)
        assert plan.width in NARROW_WIDTHS and plan.split_rows == 256
        if nq <= NARROW_WIDTHS[-1]:
            assert plan.width - 8 < nq <= plan.width  # the TPU kernel's -(-Nq // 8) * 8
    else:
        assert (plan.width, plan.split_rows) == (128, 128)
    q_tiles, n_splits, rows = plan.q_tiles, plan.n_splits, plan.split_rows
    g_tiles = -(-ng // rows)
    assert q_tiles == -(-nq // plan.width)
    assert 1 <= n_splits <= g_tiles
    bounds = [_split_rows(s, n_splits, ng, rows) for s in range(n_splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == ng
    for (s0, e0), (s1, _) in zip(bounds, bounds[1:]):
        assert e0 == s1  # contiguous: each row in exactly one split
    for start, end in bounds:
        assert start % rows == 0 and end > start
    assert q_tiles * n_splits >= min(sms, q_tiles * g_tiles)
    sizes = [-(-(e - s) // rows) for s, e in bounds]
    assert max(sizes) - min(sizes) <= 1  # balanced: no split waits on another


def test_plan_matches_the_kernel_source():
    """The plan's tiles are the kernels': the 128-row form's BM x BN
    (csrc/sgemm_tile.cuh), the small-batch form's widths up to MAX_NQ, its
    split unit BOX_ROWS (a whole number of them a 1,024-row tile: WARPS x 32
    lanes x ROWS, csrc/narrow_tile.cuh), and the kernels' split formulas are
    _split_rows's."""
    import re

    def consts(name):
        with open(f"{_build.CSRC_DIR}/{name}") as f:
            src = f.read()
        return src, {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}

    _, wide = consts("sgemm_tile.cuh")
    src, nar = consts("narrow_tile.cuh")
    assert (wide["BM"], wide["BN"]) == (128, 128)
    assert _plan(200, 1000, 132)[:3] == (wide["BM"], 2, wide["BN"])
    assert NARROW_WIDTHS == tuple(range(8, nar["MAX_NQ"] + 1, 8))
    assert nar["BOX_ROWS"] == 256 == _plan(1, 1, 1).split_rows
    assert (nar["WARPS"] * 32 * nar["ROWS"]) % nar["BOX_ROWS"] == 0
    assert "r0 = (int)((long long)s * units / n) * BOX_ROWS;" in src
    with open(f"{_build.CSRC_DIR}/fused_topk.cu") as f:
        assert "t0 = (int)((long long)s * g_tiles / n);" in f.read()  # the 128-row form
    # a stage is 1,024 rows x ROW_BYTES plus MAX_NQ queries x the stage's
    # dims in f32, and the ring beside the lists at NQ = 32, k = 128 fits a block
    stage = 1024 * nar["ROW_BYTES"] + nar["MAX_NQ"] * nar["ROW_BYTES"] // 2 * 4
    ring = 1024 + nar["STAGES"] * stage + 2 * nar["STAGES"] * 8
    assert stage % 1024 == 0
    assert ring + 32 * 128 * 8 + 8 + 32 * 12 <= 227 * 1024
