"""Port parity: normalization, masked pooling and whitening against the JAX
package, on the same numpy-seeded inputs (CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from irtpu.ops import normalization as jnorm
from irtpu.ops import pooling as jpool
from irtpu.ops import whitening as jwhiten

from image_retrieval_for_image_based_localization_tpu_torch.ops import (
    normalization as tnorm,
    pooling as tpool,
    whitening as twhiten,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_l2n_with_zero_row():
    x = _x((5, 33))
    x[2] = 0.0  # an exactly-zero row stays 0, never NaN
    got = tnorm.l2n(torch.from_numpy(x)).numpy()
    want = np.asarray(jnorm.l2n(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert np.all(got[2] == 0.0)


def test_l2n_zero_row_gradient_is_finite():
    x = torch.zeros((2, 8), requires_grad=True)
    tnorm.l2n(x).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_powerlaw():
    x = _x((4, 16), 1)
    got = tnorm.powerlaw(torch.from_numpy(x)).numpy()
    want = np.asarray(jnorm.powerlaw(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _mask(B, H, W, seed=2):
    rng = np.random.RandomState(seed)
    m = rng.rand(B, H, W) > 0.4
    m[0] = True           # one fully valid row
    m[1, :, :] = False    # one fully padded row
    m[1, 0, 0] = True
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pool", ["gem", "mac", "spoc"])
def test_masked_pooling(pool, masked):
    x = np.abs(_x((3, 5, 7, 16), 3))
    mask = _mask(3, 5, 7) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    if pool == "gem":
        got = tpool.gem(torch.from_numpy(x), 2.7, mask=tm).numpy()
        want = np.asarray(jpool.gem(jnp.asarray(x), 2.7, mask=jm))
    else:
        got = getattr(tpool, pool)(torch.from_numpy(x), mask=tm).numpy()
        want = np.asarray(getattr(jpool, pool)(jnp.asarray(x), mask=jm))
    # pow/mean in another summation order: a few f32 ulps
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


def test_whiten_apply_full_precision():
    X = _x((40, 24), 4)
    m = _x((24,), 5)
    P = _x((24, 24), 6)
    for dims in (None, 10):
        got = twhiten.whiten_apply(torch.from_numpy(X), torch.from_numpy(m),
                                   torch.from_numpy(P), dims).numpy()
        want = np.asarray(jwhiten.whiten_apply(jnp.asarray(X), jnp.asarray(m),
                                               jnp.asarray(P), dims))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("N,D", [(200, 16), (12, 48)], ids=["primal", "dual"])
def test_pca_whiten_learn(N, D):
    X = _x((N, D), 7)
    m1, P1 = twhiten.pca_whiten_learn(X)
    m2, P2 = jwhiten.pca_whiten_learn(X)
    # the same float64 NumPy code on both sides
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(P1, P2)
    assert P1.shape == ((D, D) if N >= D else (N, D))


@pytest.mark.parametrize("N,D", [(120, 16), (20, 48)], ids=["primal", "dual"])
def test_whiten_learn(N, D):
    X = _x((N, D), 8)
    q = np.arange(0, N, 2)
    p = np.arange(1, N, 2)
    m1, P1 = twhiten.whiten_learn(X, q, p)
    m2, P2 = jwhiten.whiten_learn(X, q, p)
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(P1, P2)
