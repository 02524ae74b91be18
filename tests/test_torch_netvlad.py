"""Port parity: NetVLAD's aggregation and the fused kernels' plain version
(what the kernel wrappers run on CPU tensors) against the JAX package's
``netvlad_aggregate`` and its Pallas kernels in interpret mode, at rtol 1e-4
/ atol 1e-5 (the JAX suite's own bound for these kernels)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from irtpu.ops.netvlad import netvlad_aggregate as j_aggregate
from irtpu.ops.pallas import netvlad_fused as j_fused
from irtpu.ops.pallas import netvlad_fused_rect as j_rect

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    netvlad_fused,
    netvlad_fused_rect,
    netvlad_plain,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.netvlad import netvlad_aggregate

RTOL, ATOL = 1e-4, 1e-5
B, H, W, C, K = 3, 5, 7, 32, 8
SIZES = np.array([[5, 7], [0, 0], [3, 4]], np.int32)  # full extent, batch pad, ragged


def _inputs(seed=0, shape=(B, H, W, C)):
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(*shape)).astype(np.float32)
    c = rng.randn(K, C).astype(np.float32)
    w = (rng.randn(C, K) / np.sqrt(C)).astype(np.float32)
    b = (0.1 * rng.randn(K)).astype(np.float32)
    return x, c, w, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("layout", ["bnc", "bhwc"])
def test_aggregate_matches_jax(masked, layout):
    x, c, w, b = _inputs(1)
    mask = np.random.RandomState(2).rand(B, H, W) > 0.3
    if layout == "bnc":
        x, mask = x.reshape(B, H * W, C), mask.reshape(B, H * W)
    m = mask if masked else None
    got = netvlad_aggregate(*_t(x, c, w, b),
                            mask=None if m is None else torch.from_numpy(m)).numpy()
    want = np.asarray(j_aggregate(*_j(x, c, w, b), mask=None if m is None else jnp.asarray(m)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_fused_matches_pallas(bias):
    x, c, w, b = _inputs(3)
    tb = torch.from_numpy(b) if bias else None
    got = netvlad_fused(*_t(x, c, w), tb).numpy()
    want = np.asarray(j_fused(*_j(x, c, w), jnp.asarray(b) if bias else None,
                              chunk=32, interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_rect_matches_pallas():
    x, c, w, b = _inputs(4)
    got = netvlad_fused_rect(*_t(x, c, w, b), sizes=torch.from_numpy(SIZES)).numpy()
    want = np.asarray(j_rect(*_j(x, c, w, b), sizes=jnp.asarray(SIZES), chunk=32,
                             interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(got[1] == 0.0)  # an empty (0, 0) batch-pad row
    np.testing.assert_allclose(np.linalg.norm(got[[0, 2]], axis=1), 1.0, atol=1e-5)


def test_plain_matches_masked_oracle():
    """The kernels' plain version against the port's own oracle with the
    rectangle as a mask (the oracle's 1e-24 floor differs only on norms
    below 1e-12)."""
    x, c, w, b = _inputs(5)
    mask = np.zeros((B, H, W), bool)
    for r, (h, wv) in enumerate(SIZES):
        mask[r, :h, :wv] = True
    got = netvlad_plain(*_t(x, c, w, b), sizes=torch.from_numpy(SIZES))
    want = netvlad_aggregate(*_t(x, c, w, b), mask=torch.from_numpy(mask))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    full = torch.from_numpy(np.array([[H, W]] * B, np.int32))
    torch.testing.assert_close(netvlad_fused_rect(*_t(x, c, w, b), sizes=full),
                               netvlad_fused(*_t(x, c, w, b)), rtol=0, atol=1e-7)


def test_zero_mass_clusters_give_zero_rows():
    """Features far along one direction put every row in a few clusters;
    the others get exactly zero soft mass, and their rows come out as 0."""
    x, c, w, b = _inputs(6)
    u = np.abs(np.random.RandomState(7).randn(C)).astype(np.float32)
    x[0] = 100.0 * u + 0.1 * x[0]
    got = netvlad_fused_rect(*_t(x, c, w, b), sizes=torch.from_numpy(SIZES)).numpy()
    want = np.asarray(j_rect(*_j(x, c, w, b), sizes=jnp.asarray(SIZES), chunk=32,
                             interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    rows = got[0].reshape(K, C)
    zero = np.all(rows == 0.0, axis=1)
    assert 0 < zero.sum() < K
    np.testing.assert_array_equal(np.all(want[0].reshape(K, C) == 0.0, axis=1), zero)


def test_grad_and_dtype_are_refused():
    x, c, w, b = _t(*_inputs(8))
    with pytest.raises(RuntimeError, match="inference-only"):
        netvlad_fused(x.requires_grad_(), c, w, b)
    with pytest.raises(RuntimeError, match="inference-only"):
        netvlad_fused_rect(x.detach(), torch.nn.Parameter(c), w, b,
                           sizes=torch.from_numpy(SIZES))
    with torch.no_grad():  # parameters that require grad are fine with no graph
        netvlad_fused(x, torch.nn.Parameter(c), w, b)
    with pytest.raises(TypeError, match="float32"):
        netvlad_fused(x.detach().to(torch.bfloat16), c, w, b)


def test_cpu_path_never_counts_a_launch():
    x, c, w, b = _t(*_inputs(9))
    before = (netvlad_fused.launches, netvlad_fused_rect.launches)
    netvlad_fused(x, c, w, b)
    netvlad_fused_rect(x, c, w, b, sizes=torch.from_numpy(SIZES))
    assert (netvlad_fused.launches, netvlad_fused_rect.launches) == before
