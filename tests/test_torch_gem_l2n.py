"""Port parity: the GeM + L2N head's plain version (what the kernel wrapper
runs on CPU tensors) against the JAX package's Pallas kernels in interpret
mode, tolerance 1e-6 on unit-norm outputs (pow and summation order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from irtpu.ops.pallas import gem_l2n_fused as j_fused
from irtpu.ops.pallas import gem_l2n_fused_rect as j_rect

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    gem_l2n_fused,
    gem_l2n_fused_rect,
    gem_l2n_plain,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

TOL = 1e-6


def _feats(shape, dtype, seed=0):
    """Same numbers for both packages: f32 values, rounded to bf16 by torch
    when the case is bf16 (the JAX side receives the identical bf16 values)."""
    x = np.abs(np.random.RandomState(seed).randn(*shape)).astype(np.float32)
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
        j = jnp.asarray(t.float().numpy(), jnp.bfloat16)
    else:
        j = jnp.asarray(x)
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 7, 24), (2, 13, 40)], ids=["4d", "3d_N13"])
def test_fused_matches_pallas(dtype, shape):
    t, j = _feats(shape, dtype)
    got = gem_l2n_fused(t, 2.9).numpy()
    want = np.asarray(j_fused(j, 2.9, chunk=8, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rect_matches_pallas(dtype):
    B, H, W, C = 5, 5, 7, 24   # N = 35, not a multiple of 8
    t, j = _feats((B, H, W, C), dtype, seed=1)
    sizes = np.array([[5, 7], [0, 0], [3, 2], [1, 7], [5, 1]], np.int32)
    got = gem_l2n_fused_rect(t, torch.tensor([3.0]), torch.from_numpy(sizes)).numpy()
    want = np.asarray(j_rect(j, 3.0, jnp.asarray(sizes), chunk=16, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.all(got[1] == 0.0)  # an empty (0, 0) batch-pad row


def test_rect_full_extent_equals_unmasked():
    t, _ = _feats((2, 4, 6, 16), "float32", seed=2)
    full = torch.tensor([[4, 6], [4, 6]], dtype=torch.int32)
    np.testing.assert_allclose(gem_l2n_fused_rect(t, 3.0, full).numpy(),
                               gem_l2n_fused(t, 3.0).numpy(), rtol=0, atol=1e-7)


def test_cpu_path_never_counts_a_launch():
    t, _ = _feats((1, 2, 2, 8), "float32")
    before = (gem_l2n_fused.launches, gem_l2n_fused_rect.launches)
    gem_l2n_fused(t, 3.0)
    gem_l2n_fused_rect(t, 3.0, torch.tensor([[2, 2]], dtype=torch.int32))
    assert (gem_l2n_fused.launches, gem_l2n_fused_rect.launches) == before


def test_plain_reads_p_from_a_parameter():
    t, j = _feats((2, 3, 3, 8), "float32", seed=3)
    p = torch.nn.Parameter(torch.tensor([2.5]))
    got = gem_l2n_plain(t, p).detach().numpy()
    want = np.asarray(j_fused(j, 2.5, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
