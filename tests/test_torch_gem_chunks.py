"""Kernels B1 and B2 past one cluster's width, on the CPU.

``csrc/gem_l2n.cu`` holds one image's channel vector in a cluster of eight
CTAs, 8,192 channels at most; wider maps run in chunks of channels, one
cluster per image and chunk, and a second launch normalizes each row; more
than 65,535 images run as consecutive launches. On the CPU the wrappers run
the plain version, which takes any C and B: held here against the JAX
package's Pallas kernels in interpret mode at C = 8,200 and 16,384 (1e-6),
and the wrappers against the plain version at B = 70,000. The kernel itself
is held on the card (tests/test_torch_cuda.py, phase 3 of chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irtpu.ops.pallas.gem_l2n import gem_l2n_fused as j_fused
from irtpu.ops.pallas.gem_l2n import gem_l2n_fused_rect as j_fused_rect

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    gem_l2n_fused,
    gem_l2n_fused_rect,
    gem_l2n_plain,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

SIZES = np.array([[3, 4], [0, 0], [2, 1]], np.int32)


def _map(C, bf16=False, seed=0):
    """[3, 3, 4, C] of |randn|, rounded to bf16 values (a numpy bf16 array)
    when ``bf16``."""
    x = np.abs(np.random.RandomState(seed).randn(3, 3, 4, C)).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16)) if bf16 else x


@pytest.mark.parametrize("C", [8200, 16384])
@pytest.mark.parametrize("entry", ["rect", "unmasked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gem_matches_the_jax_kernel_past_one_cluster(C, entry, dtype):
    x = _map(C, bf16=dtype == "bfloat16")
    xt = torch.from_numpy(np.asarray(x, np.float32))
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)  # exact: x holds bf16 values
    p = 3.0
    if entry == "rect":
        want = np.asarray(j_fused_rect(jnp.asarray(x), p, jnp.asarray(SIZES), interpret=True))
        got = gem_l2n_fused_rect(xt, p, torch.from_numpy(SIZES))
        np.testing.assert_array_equal(got.numpy(), gem_l2n_plain(xt, p, torch.from_numpy(SIZES)))
        assert np.all(got.numpy()[1] == 0)
    else:
        want = np.asarray(j_fused(jnp.asarray(x), p, interpret=True))
        got = gem_l2n_fused(xt, p)
    assert got.shape == (3, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_wrappers_take_more_images_than_a_grid_row():
    """B = 70,000 at C = 8, ragged extents with (0, 0) rows: the CPU
    wrappers are the plain version; against the JAX kernel on a slice."""
    B = 70_000
    rng = np.random.RandomState(1)
    x = np.abs(rng.randn(B, 2, 3, 8)).astype(np.float32)
    sizes = np.stack([rng.randint(0, 3, B), rng.randint(0, 4, B)], 1).astype(np.int32)
    xt, st = torch.from_numpy(x), torch.from_numpy(sizes)
    got = gem_l2n_fused_rect(xt, 3.0, st)
    assert torch.equal(got, gem_l2n_plain(xt, 3.0, st))
    assert torch.equal(gem_l2n_fused(xt, 3.0), gem_l2n_plain(xt, 3.0))
    sl = slice(65_530, 65_545)  # across the first launch's last image
    want = np.asarray(j_fused_rect(jnp.asarray(x[sl]), 3.0, jnp.asarray(sizes[sl]),
                                   interpret=True))
    np.testing.assert_allclose(got.numpy()[sl], want, rtol=0, atol=1e-6)
