"""Port parity for the fused bottleneck and the fused trunk: the kernel's
plain version against the JAX package's ``bottleneck_oracle`` and
``bottleneck_fused`` in interpret mode (1e-5, the shapes of
``tests/test_pallas_kernels.py``), ``fold_bn`` against the JAX fold, the
port's ``trunk_apply_fused`` against the JAX one (resnet50, randomized BN
statistics carried across by ``models/flax_port.py``) and against the
port's own unfused trunk, and ``Extractor(fuse_blocks=True)`` against the
unfused extractor (CPU)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from irtpu.models.fused_trunk import fold_trunk_variables
from irtpu.models.fused_trunk import trunk_apply_fused as j_trunk_apply_fused
from irtpu.models.resnet import ResNetTrunk as JTrunk
from irtpu.ops.pallas.bottleneck_block import bottleneck_fused as j_bottleneck_fused
from irtpu.ops.pallas.bottleneck_block import bottleneck_oracle as j_bottleneck_oracle
from irtpu.ops.pallas.bottleneck_block import fold_bn as j_fold_bn

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.models import ResNetTrunk
from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
    trunk_state_dict,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.fused_trunk import (
    fold_trunk,
    trunk_apply_fused,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    bottleneck_fused,
    bottleneck_plain,
    fold_bn,
)


def _block_args(B, H, W, Cin, Cm, rng):
    x = (rng.randn(B, H, W, Cin) * 0.5).astype(np.float32)
    w1 = (rng.randn(Cin, Cm) * 0.05).astype(np.float32)
    w2 = (rng.randn(3, 3, Cm, Cm) * 0.05).astype(np.float32)
    w3 = (rng.randn(Cm, Cin) * 0.05).astype(np.float32)
    b1 = (rng.randn(Cm) * 0.1).astype(np.float32)
    b2 = (rng.randn(Cm) * 0.1).astype(np.float32)
    b3 = (rng.randn(Cin) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2, w3, b3


@pytest.mark.parametrize("shape", [(1, 16, 16, 128, 32), (2, 32, 16, 128, 32),
                                   (1, 24, 40, 128, 32)])
def test_bottleneck_plain_matches_jax(shape):
    args = _block_args(*shape, np.random.RandomState(20))
    got = bottleneck_fused(*(torch.from_numpy(a) for a in args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(got, np.asarray(j_bottleneck_oracle(*jargs)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(j_bottleneck_fused(*jargs, interpret=True)),
                               rtol=1e-5, atol=1e-5)
    assert bottleneck_plain(*(torch.from_numpy(a) for a in args)).is_contiguous()


def test_relu_b1_halo_is_zeroed():
    """A zero input with positive b1: relu(b1) != 0 must not leak into the
    3x3 conv at the image border (SAME pads y1, not x)."""
    rng = np.random.RandomState(1)
    x, w1, b1, w2, b2, w3, b3 = (torch.from_numpy(a) for a in _block_args(1, 5, 6, 64, 32, rng))
    b1 = b1.abs() + 1.0
    got = bottleneck_fused(torch.zeros_like(x), w1, b1, w2, b2, w3, b3)
    y1 = torch.relu(b1)                              # the same at every pixel
    inner = torch.relu(torch.einsum("hwio,i->o", w2, y1) + b2) @ w3 + b3
    np.testing.assert_allclose(got[0, 2, 2].numpy(), torch.relu(inner).numpy(),
                               rtol=1e-5, atol=1e-6)
    corner = torch.relu(torch.einsum("hwio,i->o", w2[1:, 1:], y1) + b2) @ w3 + b3
    np.testing.assert_allclose(got[0, 0, 0].numpy(), torch.relu(corner).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(2)
    k = rng.randn(3, 3, 8, 16).astype(np.float32)
    s, b, m = (rng.randn(16).astype(np.float32) for _ in range(3))
    v = rng.rand(16).astype(np.float32) + 0.5
    w, bb = fold_bn(*(torch.from_numpy(a) for a in (k, s, b, m, v)))
    jw, jb = j_fold_bn(*(jnp.asarray(a) for a in (k, s, b, m, v)))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def r50_pair():
    """A JAX resnet50 trunk with randomized BN statistics and the port's
    trunk holding the same weights (through ``trunk_state_dict``)."""
    rng = np.random.RandomState(21)
    x = rng.rand(1, 64, 96, 3).astype(np.float32)
    jt = JTrunk("resnet50")
    v = jt.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree.map(lambda a: a + jnp.asarray(np.abs(rng.randn(*a.shape)).astype(np.float32)
                                              * 0.1) if a.ndim == 1 else a, v)
    t = ResNetTrunk("resnet50")
    t.load_state_dict(trunk_state_dict(jax.tree.map(np.asarray, v), "resnet50"))
    return x, v, t.eval()


def test_fused_trunk_matches_jax_fused_trunk(r50_pair):
    x, v, t = r50_pair
    want = np.asarray(j_trunk_apply_fused(fold_trunk_variables(v, "resnet50"),
                                          jnp.asarray(x), interpret=True))
    with torch.no_grad():
        got = trunk_apply_fused(fold_trunk(t), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 2, 3, 2048)
    # tighter than the JAX suite's rtol 2e-3 / atol 2e-4: both fold in f32
    # and sum in f32 (measured 4.7e-6 on features of magnitude 4.5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_fused_trunk_matches_unfused_trunk(r50_pair):
    x, _, t = r50_pair
    with torch.no_grad():
        got = trunk_apply_fused(fold_trunk(t), torch.from_numpy(x))
        want = t(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


def test_fold_trunk_refuses_basic_blocks():
    with pytest.raises(ValueError, match="bottleneck"):
        fold_trunk(ResNetTrunk("resnet18"))


def test_extractor_fuse_blocks_matches_unfused_with_a_bucket_mask():
    cfg = port.ExtractConfig(model=port.ModelConfig(arch="resnet50", use_pallas=True),
                             scales=(1.0, 2 ** -0.5), fuse_blocks=True)
    fused = port.Extractor(cfg, seed=3, device="cpu")
    plain = port.Extractor(dataclasses.replace(cfg, fuse_blocks=None),
                           state_dict=fused.model.state_dict(), device="cpu")
    assert fused._folded is not None and plain._folded is None
    rng = np.random.RandomState(4)
    x = rng.randn(2, 96, 64, 3).astype(np.float32)
    mask = np.zeros((2, 96, 64), bool)
    mask[0] = True
    mask[1, :64, :40] = True
    x = x * mask[..., None]
    got, want = fused(x, mask), plain(x, mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_head_on_fused_features_matches_jax_precomputed_path():
    """``RetrievalNet.head`` on the fused trunk's features against the JAX
    ``RetrievalNet(precomputed_features=True)`` on its fused trunk's, and
    against the port's own full forward (the JAX suite's
    ``test_retrieval_net_precomputed_features_path``, across packages)."""
    from irtpu.models import RetrievalNet as JNet

    from image_retrieval_for_image_based_localization_tpu_torch.models import RetrievalNet
    from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
        variables_to_state_dict,
    )

    jm = JNet(arch="resnet50", pooling="gem")
    x = np.random.RandomState(22).rand(2, 64, 64, 3).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jfeats = j_trunk_apply_fused(fold_trunk_variables(v, "resnet50"), jnp.asarray(x),
                                 interpret=True)
    want = np.asarray(jm.apply(v, jfeats, precomputed_features=True))
    m = RetrievalNet(arch="resnet50", pooling="gem")
    m.load_state_dict(variables_to_state_dict(jax.tree.map(np.asarray, v), "resnet50"))
    m.eval()
    with torch.no_grad():
        got = m.head(trunk_apply_fused(fold_trunk(m.features), torch.from_numpy(x))).numpy()
        full = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-5)


def test_bad_shapes_raise():
    x = torch.zeros((1, 4, 4, 64))
    w1, b1 = torch.zeros((64, 32)), torch.zeros(32)
    with pytest.raises(ValueError, match="w2 must be"):
        bottleneck_fused(x, w1, b1, torch.zeros((3, 3, 32, 16)), b1, torch.zeros((32, 64)),
                         torch.zeros(64))
