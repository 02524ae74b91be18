"""Port parity: the ADC kernel's plain version against the JAX package's
exact gather ``_adc_block`` (1e-5) and its Pallas ``adc_scores_mxu`` in
interpret mode (the bound of ``tests/test_adc_mxu.py``), and the streaming
``adc_topk_core`` against the JAX one: identical rows, masking and offsets
included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from irtpu.ops.pallas import adc_mxu
from irtpu.retrieval.pq import _adc_block as j_adc_block
from irtpu.retrieval.pq import _build_luts as j_build_luts
from irtpu.retrieval.pq import adc_topk_core as j_adc_topk_core

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    adc_scores,
    adc_scores_plain,
    blockmax_select,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.score_topk import (
    NEG_INF,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import (
    _build_luts,
    adc_topk_core,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


def _setup(n=1100, d=64, m=8, nq=40, seed=0, dup=True):
    rng = np.random.RandomState(seed)
    # unit-scale scores, as for unit-norm descriptors
    books = (rng.randn(m, 256, d // m) / np.sqrt(d)).astype(np.float32)
    codes = rng.randint(0, 256, size=(n, m), dtype=np.uint8)
    if dup:
        codes[n // 2 :: 7] = codes[3]  # planted duplicate rows: exact ties
    q = rng.randn(nq, d).astype(np.float32)
    lut = np.array(j_build_luts(jnp.asarray(books), jnp.asarray(q)))
    return books, codes, q, lut


def test_build_luts_match_jax():
    books, _, q, lut = _setup()
    got = _build_luts(torch.from_numpy(books), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, lut, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,m", [(1100, 8), (300, 80)], ids=["m8", "m80_sliced"])
def test_adc_scores_plain_matches_jax_gather(n, m):
    """m=80 is past the kernel's 64-subquantizer LUT slice."""
    _, codes, _, lut = _setup(n=n, d=2 * m, m=m)
    s, bmax = adc_scores(torch.from_numpy(lut), torch.from_numpy(codes))
    s, bmax = s.numpy(), bmax.numpy()
    want = np.asarray(j_adc_block(jnp.asarray(lut), jnp.asarray(codes)))
    nb = -(-n // 64)
    assert s.shape == (lut.shape[0], nb * 64) and bmax.shape == (lut.shape[0], nb)
    np.testing.assert_allclose(s[:, :n], want, rtol=0, atol=1e-5)
    assert np.all(s[:, n:] == NEG_INF)
    np.testing.assert_array_equal(bmax, s.reshape(len(s), nb, 64).max(-1))
    dup = np.flatnonzero((codes == codes[3]).all(1))
    assert len(dup) > 2 and np.all(s[:, dup] == s[:, dup[:1]])  # bit-equal ties


def test_adc_scores_plain_matches_pallas_mxu_interpret():
    _, codes, _, lut = _setup(n=1024)
    hi, lo = adc_mxu.prepare_lut_tables(jnp.asarray(lut))
    want = np.asarray(adc_mxu.adc_scores_mxu(jnp.asarray(codes), hi, lo, interpret=True))
    s, _ = adc_scores(torch.from_numpy(lut), torch.from_numpy(codes))
    np.testing.assert_allclose(s.numpy(), want[:, : lut.shape[0]].T, rtol=2e-5, atol=2e-3)


def test_n_valid_masks_rows():
    _, codes, _, lut = _setup(n=200)
    s, bmax = adc_scores_plain(torch.from_numpy(lut), torch.from_numpy(codes), n_valid=130)
    full, _ = adc_scores_plain(torch.from_numpy(lut), torch.from_numpy(codes))
    assert torch.all(s[:, 130:] == NEG_INF)
    assert torch.equal(s[:, :130], full[:, :130])
    assert torch.equal(bmax, s.view(s.shape[0], -1, 64).amax(-1))


@pytest.mark.parametrize("k,chunk", [(10, 512), (37, 4096), (300, 256)])
def test_adc_topk_core_matches_jax(k, chunk):
    _, codes, _, lut = _setup()
    s, i = adc_topk_core(torch.from_numpy(lut), torch.from_numpy(codes), k=k, chunk=chunk)
    js, ji = j_adc_topk_core(jnp.asarray(lut), jnp.asarray(codes), k=k, chunk=chunk,
                             backend="gather")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    # (score desc, row asc) with the planted exact ties
    sv, iv = s.numpy(), i.numpy()
    ordered = (sv[:, :-1] > sv[:, 1:]) | ((sv[:, :-1] == sv[:, 1:]) & (iv[:, :-1] < iv[:, 1:]))
    assert ordered.all()


def test_adc_topk_core_masking_and_offset():
    """As tests/test_adc_mxu.py:61: rows past n_valid never return, and row
    ids start at index_offset."""
    _, codes, _, lut = _setup(n=900)
    n_valid, off = 700, 12345
    s, i = adc_topk_core(torch.from_numpy(lut), torch.from_numpy(codes), k=7, chunk=512,
                         n_valid=n_valid, index_offset=off)
    js, ji = j_adc_topk_core(jnp.asarray(lut), jnp.asarray(codes), k=7, chunk=512,
                             n_valid=n_valid, index_offset=off, backend="gather")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i.min() >= off and i.max() < off + n_valid


def test_adc_ties_lower_row_first():
    """Every row equal: the selection returns rows 0..k-1 in order."""
    lut = torch.randn((3, 4, 256), generator=torch.Generator().manual_seed(1))
    codes = torch.full((700, 4), 9, dtype=torch.uint8)
    s, i = adc_topk_core(lut, codes, k=50, chunk=256)
    assert torch.equal(i, torch.arange(50, dtype=torch.int32).expand(3, -1))
    assert torch.all(s == s[:, :1])


def test_blockmax_select_returns_exact_topk():
    _, codes, _, lut = _setup(n=640)
    s, bmax = adc_scores(torch.from_numpy(lut), torch.from_numpy(codes))
    top, cols = blockmax_select(s, bmax, 40)
    want = torch.sort(s, dim=1, descending=True, stable=True)
    assert torch.equal(top, want.values[:, :40])
    assert torch.equal(cols.long(), want.indices[:, :40])


def test_cpu_path_never_counts_a_launch_and_bad_inputs_raise():
    _, codes, _, lut = _setup(n=100)
    before = adc_scores.launches
    adc_topk_core(torch.from_numpy(lut), torch.from_numpy(codes), k=5, chunk=64)
    assert adc_scores.launches == before
    with pytest.raises(TypeError, match="uint8"):
        adc_scores(torch.from_numpy(lut), torch.from_numpy(codes).int())
    with pytest.raises(ValueError, match="need lut"):
        adc_scores(torch.from_numpy(lut)[:, :4], torch.from_numpy(codes))
    with pytest.raises(ValueError, match="n_valid"):
        adc_scores(torch.from_numpy(lut), torch.from_numpy(codes), n_valid=101)
