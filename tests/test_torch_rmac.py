"""Port parity: R-MAC's region grid, R-MAC (exact, masked and bucketed), the
regional pool and GeMmp against the JAX package's ``ops/pooling.py``, and the
vgg16-rmac and gemmp heads against the JAX model."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from irtpu.models.retrieval_net import RetrievalNet as JNet
from irtpu.models.torch_port import port_retrieval_net
from irtpu.ops import pooling as jp

from image_retrieval_for_image_based_localization_tpu_torch.models import (
    RetrievalNet,
    init_random_,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops import pooling as pp

TOL = 1e-6


def _x(shape, seed=0, positive=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(x) if positive else x


def test_rmac_regions_equal_over_48_x_48():
    """Every (H, W) in 1..48 x 1..48, L = 1..3: the same list of regions."""
    for L in (1, 2, 3):
        bad = [(h, w) for h in range(1, 49) for w in range(1, 49)
               if pp.rmac_regions(h, w, L) != jp.rmac_regions(h, w, L)]
        assert not bad, (L, bad[:10])


def test_region_counts_match_the_exact_grid():
    sizes = np.array([(h, w) for h in range(1, 49) for w in range(1, 49)], np.int32)
    got = pp.rmac_region_counts(torch.from_numpy(sizes)).numpy()
    want = [1 + len(jp.rmac_regions(int(h), int(w))) for h, w in sizes]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 9, 13, 8), (1, 16, 16, 4), (2, 7, 3, 5)])
def test_rmac_matches_jax(shape):
    x = _x(shape, 1)
    got = pp.rmac(torch.from_numpy(x)).numpy()
    want = np.asarray(jp.rmac(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_masked_rmac_matches_jax():
    """The padded-grid fallback for masks that are not rectangles."""
    x = _x((2, 12, 14, 6), 2)
    mask = np.random.RandomState(3).rand(2, 12, 14) > 0.3
    mask[1, 6:, :] = False
    got = pp.rmac(torch.from_numpy(x), mask=torch.from_numpy(mask)).numpy()
    want = np.asarray(jp.rmac(jnp.asarray(x), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# knife-edge extents where the overlap argmin is a near tie (the JAX test's)
BUCKET_SHAPES = [(12, 16), (16, 16), (7, 13), (16, 9), (3, 5), (5, 9), (2, 32), (3, 33)]


@pytest.fixture(scope="module")
def bucket():
    rng = np.random.RandomState(0)
    H = W = 33
    C = 24
    batch = np.zeros((len(BUCKET_SHAPES), H, W, C), np.float32)
    sizes = np.zeros((len(BUCKET_SHAPES), 2), np.int32)
    for r, (h, w) in enumerate(BUCKET_SHAPES):
        batch[r, :h, :w] = rng.randn(h, w, C)
        sizes[r] = (h, w)
    return batch, sizes


def test_rmac_bucketed_matches_jax(bucket):
    batch, sizes = bucket
    got = pp.rmac_bucketed(torch.from_numpy(batch), torch.from_numpy(sizes)).numpy()
    want = np.asarray(jp.rmac_bucketed(jnp.asarray(batch), jnp.asarray(sizes)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_rmac_bucketed_equals_exact_rmac_per_image(bucket):
    """Each image of the bucket pools the regions of its exact-shape map."""
    batch, sizes = bucket
    got = pp.rmac_bucketed(torch.from_numpy(batch), torch.from_numpy(sizes)).numpy()
    for r, (h, w) in enumerate(sizes):
        want = pp.rmac(torch.from_numpy(batch[r:r + 1, :h, :w])).numpy()[0]
        np.testing.assert_allclose(got[r], want, rtol=1e-5, atol=1e-5, err_msg=str((h, w)))


def test_rmac_bucketed_ignores_padding():
    x = _x((2, 12, 12, 8), 4)
    b = x.copy()
    b[:, 9:] = 100.0
    b[:, :, 10:] = -50.0
    sizes = torch.tensor([[9, 10], [9, 10]], dtype=torch.int32)
    np.testing.assert_array_equal(pp.rmac_bucketed(torch.from_numpy(x), sizes).numpy(),
                                  pp.rmac_bucketed(torch.from_numpy(b), sizes).numpy())


@pytest.mark.parametrize("base", ["gem", "mac", "spoc"])
@pytest.mark.parametrize("whiten", [False, True], ids=["plain", "whitened"])
@pytest.mark.parametrize("aggregate", [True, False], ids=["sum", "regions"])
def test_rpool_matches_jax(base, whiten, aggregate):
    x = _x((2, 9, 13, 8), 6, positive=True)
    rng = np.random.RandomState(7)
    Wm = rng.randn(8, 4).astype(np.float32) * 0.1
    b = rng.randn(4).astype(np.float32) * 0.1
    j_whiten = (lambda v: v @ jnp.asarray(Wm) + jnp.asarray(b)) if whiten else None
    p_whiten = (lambda v: v @ torch.from_numpy(Wm) + torch.from_numpy(b)) if whiten else None
    got = pp.rpool(torch.from_numpy(x), base=base, p=2.5, whiten_fn=p_whiten,
                   aggregate=aggregate).numpy()
    want = np.asarray(jp.rpool(jnp.asarray(x), base=base, p=2.5, whiten_fn=j_whiten,
                               aggregate=aggregate))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_rpool_rejects_other_bases():
    with pytest.raises(ValueError, match="rpool wraps"):
        pp.rpool(torch.zeros((1, 4, 4, 2)), base="rmac")


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_gemmp_per_channel_p_matches_jax(masked):
    x = _x((2, 5, 7, 4), 8, positive=True)
    p = np.array([2.0, 3.0, 4.0, 5.0], np.float32)
    mask = np.ones((2, 5, 7), bool)
    mask[1, 3:, 4:] = False
    m_t = torch.from_numpy(mask) if masked else None
    m_j = jnp.asarray(mask) if masked else None
    got = pp.gem(torch.from_numpy(x), torch.from_numpy(p), mask=m_t).numpy()
    want = np.asarray(jp.gem(jnp.asarray(x), jnp.asarray(p), mask=m_j))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for c in range(4):  # one exponent per channel
        one = pp.gem(torch.from_numpy(x[..., c:c + 1]), float(p[c]), mask=m_t).numpy()
        np.testing.assert_allclose(got[:, c:c + 1], one, rtol=1e-5, atol=TOL)


def _model_pair(arch, pooling, seed):
    port = RetrievalNet(arch, pooling)
    init_random_(port, torch.Generator().manual_seed(seed))
    if pooling == "gemmp":
        with torch.no_grad():
            port.pool.p.copy_(2.0 + torch.rand(port.pool.p.shape,
                                               generator=torch.Generator().manual_seed(seed)))
    variables = jax.tree.map(jnp.asarray, port_retrieval_net(port.state_dict(), arch))
    return port.eval(), JNet(arch=arch, pooling=pooling), variables


@pytest.fixture(scope="module")
def vgg_rmac():
    return _model_pair("vgg16", "rmac", 9)


@pytest.mark.parametrize("mask_kind", ["none", "rect", "ragged"])
def test_vgg16_rmac_head_matches_jax(vgg_rmac, mask_kind):
    """vgg16-rmac: exact shapes, a bucket (rect masks: rmac_bucketed) and a
    mask that is not a rectangle (the padded-grid fallback)."""
    port, jnet, variables = vgg_rmac
    H, W = 96, 128
    x = _x((2, H, W, 3), 10)
    mask = np.zeros((2, H, W), bool)
    mask[0] = True
    mask[1, :64, :96] = True
    if mask_kind == "ragged":
        mask[1, 64:80, :16] = True
    m = None if mask_kind == "none" else mask
    if m is not None:
        x = x * m[..., None]
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if m is None else torch.from_numpy(m)).numpy()
    want = np.asarray(jnet.apply(variables, jnp.asarray(x),
                                 mask=None if m is None else jnp.asarray(m)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=TOL)


def test_gemmp_head_matches_jax():
    port, jnet, variables = _model_pair("resnet18", "gemmp", 11)
    assert tuple(port.pool.p.shape) == (512,)
    assert np.asarray(variables["params"]["gem_p"]).shape == (512,)
    x = _x((2, 64, 64, 3), 12)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
