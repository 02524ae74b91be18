"""Port parity for the fused bottleneck and the fused trunk: the kernel's
plain version against the JAX package's ``bottleneck_oracle`` and
``bottleneck_fused`` in interpret mode (1e-5, the shapes of
``tests/test_pallas_kernels.py``); the kernel's 3xTF32 rule written out
(``split_tf32`` and three convolutions of hi/lo terms) against both; the
kernel's scratch and grid plan; ``fold_bn`` against the JAX fold, the
port's ``trunk_apply_fused`` against the JAX one (resnet50, randomized BN
statistics carried across by ``models/flax_port.py``) and against the
port's own unfused trunk, and ``Extractor(fuse_blocks=True)`` against the
unfused extractor (CPU). In bf16: the plain version against the JAX kernel
in interpret mode (2^-8 of max|out|), the bf16 kernel's weight packing and
plan, the bf16 fused trunk against the JAX one, and the bf16
``Extractor(fuse_blocks=True)`` against the JAX bf16 fused extractor and
the port's unfused bf16 extractor."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from irtpu.api import Extractor as JExtractor
from irtpu.models.fused_trunk import fold_trunk_variables
from irtpu.models.fused_trunk import trunk_apply_fused as j_trunk_apply_fused
from irtpu.models.torch_port import port_retrieval_net
from irtpu.models.resnet import ResNetTrunk as JTrunk
from irtpu.ops.pallas.bottleneck_block import bottleneck_fused as j_bottleneck_fused
from irtpu.ops.pallas.bottleneck_block import bottleneck_oracle as j_bottleneck_oracle
from irtpu.ops.pallas.bottleneck_block import fold_bn as j_fold_bn
from irtpu.utils import config as jcfg

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.models import ResNetTrunk
from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
    trunk_state_dict,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.fused_trunk import (
    _bf16_weights,
    fold_trunk,
    trunk_apply_fused,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    bottleneck_fused,
    bottleneck_plain,
    fold_bn,
    pack_bf16,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.bottleneck import (
    _bf16_tile,
    _plan,
    split_tf32,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


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


# The kernel's arithmetic, written out on the CPU: each f32 operand split into
# TF32 hi and lo (round to nearest, ties away from zero, at 10 mantissa
# bits), each product taken as lo_a hi_b + hi_a lo_b + hi_a hi_b.

@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 7.5e4, 3e37])
def test_split_tf32_rounds_to_tf32_and_rebuilds(scale):
    t = torch.from_numpy((np.random.RandomState(30).randn(20000) * scale).astype(np.float32))
    hi, lo = split_tf32(t)
    assert hi.dtype == lo.dtype == torch.float32
    for part in (hi, lo):  # TF32 keeps 10 of 23 mantissa bits: the low 13 are zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    t64 = t.double()
    assert torch.all((hi.double() + lo.double() - t64).abs() <= 2.0 ** -22 * t64.abs())
    assert torch.all((hi.double() - t64).abs() <= 2.0 ** -11 * t64.abs())


def test_split_tf32_ties_go_away_from_zero():
    one = 1.0
    half_ulp = 2.0 ** -11  # half of TF32's ulp at 1
    t = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp * 0.99, 0.0, -0.0,
                      one + 3 * half_ulp], dtype=torch.float32)
    hi, lo = split_tf32(t)
    np.testing.assert_array_equal(
        hi.numpy(), np.float32([one + 2 * half_ulp, -(one + 2 * half_ulp), one, 0.0, -0.0,
                                one + 4 * half_ulp]))
    exact = [0, 1, 3, 4, 5]  # there t - hi is itself a TF32 value: lo holds it whole
    np.testing.assert_array_equal((hi.double() + lo.double()).numpy()[exact],
                                  t.double().numpy()[exact])


def _conv_tf32x3(x, w, **kw):
    """conv2d with every product taken as the kernel takes it."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    return F.conv2d(xl, wh, **kw) + F.conv2d(xh, wl, **kw) + F.conv2d(xh, wh, **kw)


def _bottleneck_tf32x3(x, w1, b1, w2, b2, w3, b3):
    xc = x.permute(0, 3, 1, 2)
    y = F.relu(_conv_tf32x3(xc, w1.t()[:, :, None, None]) + b1[:, None, None])
    y = F.relu(_conv_tf32x3(y, w2.permute(3, 2, 0, 1), padding=1) + b2[:, None, None])
    y = _conv_tf32x3(y, w3.t()[:, :, None, None]) + b3[:, None, None]
    return F.relu(y + xc).permute(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(1, 16, 16, 128, 32), (2, 32, 16, 128, 32),
                                   (1, 24, 40, 128, 32), (3, 5, 7, 64, 32)])
def test_tf32x3_rule_matches_plain_and_jax(shape):
    """Three convolutions of hi/lo terms stay within 1e-5 of max|plain| of
    the f32 block (the port's plain version and the JAX oracle), the
    tolerance the kernel is held to on the card."""
    args = _block_args(*shape, np.random.RandomState(31))
    targs = [torch.from_numpy(a) for a in args]
    got = _bottleneck_tf32x3(*targs).numpy()
    plain = bottleneck_plain(*targs).numpy()
    oracle = np.asarray(j_bottleneck_oracle(*(jnp.asarray(a) for a in args)))
    tol = 1e-5 * np.abs(plain).max()
    assert np.abs(got - plain).max() <= tol
    assert np.abs(got - oracle).max() <= tol


def test_tf32x3_rule_is_closer_than_one_tf32_product():
    """The rule is what keeps f32 accuracy: one TF32 product (hi_a hi_b)
    misses 1e-5 of max|plain| where three products hold it."""
    args = [torch.from_numpy(a) for a in _block_args(2, 12, 10, 128, 64,
                                                     np.random.RandomState(32))]
    plain = bottleneck_plain(*args)
    x, w1, b1, w2, b2, w3, b3 = args

    def hi(t):
        return split_tf32(t)[0]

    xc = hi(x).permute(0, 3, 1, 2)
    y = F.relu(F.conv2d(xc, hi(w1).t()[:, :, None, None], b1))
    y = F.relu(F.conv2d(hi(y), hi(w2).permute(3, 2, 0, 1), b2, padding=1))
    y = F.conv2d(hi(y), hi(w3).t()[:, :, None, None], b3)
    one = F.relu(y + x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    scale = plain.abs().max()
    assert (one - plain).abs().max() > 1e-5 * scale
    assert (_bottleneck_tf32x3(*args) - plain).abs().max() <= 1e-5 * scale


# chip_smoke.py's five block shapes (resnet50 at a 16-image 1024 px bucket,
# layers 1-4, and layer1 at 720 x 1024), its image-spanning check shape, and
# ragged ones
PLAN_SHAPES = [(16, 256, 256, 256, 64), (16, 128, 128, 512, 128), (16, 64, 64, 1024, 256),
               (16, 32, 32, 2048, 512), (16, 180, 256, 256, 64), (37, 5, 7, 256, 64),
               (1, 1, 1, 32, 32), (3, 11, 9, 256, 64), (2, 6, 9, 160, 96), (1, 23, 13, 2048, 512)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_output_once(shape):
    B, H, W, cin, cm = shape
    plan = _plan(B, H, W, cin, cm)
    M = B * H * W
    assert plan["scratch"] == (B, H, W, cm)
    assert plan["split_weights"] == 2 * (cin * cm + 9 * cm * cm + cm * cin)
    (n1, k1, g1), (n2, k2, g2), (n3, k3, g3) = plan["phases"]
    assert (n1, k1, n2, k2, n3, k3) == (cm, cin, cm, 9 * cm, cin, cm)
    for n, k, blocks in plan["phases"]:
        assert k % 32 == 0                   # whole 32-deep stages, never across a tap
        m_tiles, n_tiles = -(-M // 128), -(-n // 64)
        assert blocks == m_tiles * n_tiles   # 128 x 64 tiles cover [M, N] once
        assert (m_tiles - 1) * 128 < M <= m_tiles * 128
        assert (n_tiles - 1) * 64 < n <= n_tiles * 64
        assert blocks < 2 ** 31              # a one-dimensional grid


def test_plan_matches_the_kernel_source():
    """The plan's tile is the mainloop's (csrc/tf32x3_gemm.cuh), whose
    shared memory lets two blocks share an SM."""
    import re

    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build

    src = open(f"{_build.CSRC_DIR}/tf32x3_gemm.cuh").read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["BM"], const["BN"], const["BK"]) == (128, 64, 32)
    assert _plan(1, 1, 1, 64, 64)["phases"][0][2] == 1
    assert _plan(1, 130, 1, 64, 64)["phases"][0][2] == 2  # 130 pixels: two 128-row tiles
    a_bytes = const["BM"] * (const["BK"] + 4) * 4
    smem = const["STAGES"] * (a_bytes + 2 * const["BN"] * const["BK"] * 4) + 1024
    # 227 KB a block at most; 228 KB an SM, 1 KB of it reserved for each block
    assert 2 * (smem + 1024) <= 228 * 1024


# bf16: the JAX kernel's rounding points. Bounds: one block within 2^-8 of
# max|out| of the JAX kernel; bf16 feature maps within test_torch_bf16.py's
# map bound (2e-2 of max|want|, vgg16's trunk) and cosine 0.999; unit-norm
# descriptors within its descriptor bounds (1e-2, cosine 0.999). The two
# packages sum in f32 in different orders, so a bf16 rounding can flip and
# carry through the later blocks.
BF16_MAP_TOL = 2e-2
BF16_MAX_DIFF = 1e-2
BF16_MIN_COS = 0.999


def _cos(a, b):
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


def _bf16(a):
    """numpy f32 -> (bf16 JAX array, bf16 torch tensor) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(1, 16, 16, 128, 32), (2, 32, 16, 128, 32),
                                   (1, 24, 40, 128, 32)])
def test_bottleneck_plain_bf16_matches_jax_kernel(shape):
    """The plain version on a bf16 x (what the bf16 kernel is held to on the
    card) against the JAX kernel in interpret mode: measured equal at the
    first two shapes, 5 of 122,880 values apart at the third (3.96e-4 of
    max|out|)."""
    args = _block_args(*shape, np.random.RandomState(20))
    jx, tx = _bf16(args[0])
    want = j_bottleneck_fused(jx, *(jnp.asarray(a) for a in args[1:]), interpret=True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = bottleneck_fused(tx, *(torch.from_numpy(a) for a in args[1:]))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


def test_bottleneck_plain_bf16_rounds_where_jax_rounds():
    """bf16 weights give the same bits as the f32 weights they round from
    (the plain version casts as the JAX kernel does), and the output is
    the JAX oracle's exactly at a shape where both sum alike."""
    args = _block_args(1, 16, 16, 128, 32, np.random.RandomState(23))
    jx, tx = _bf16(args[0])
    w = [torch.from_numpy(a) for a in args[1:]]
    got = bottleneck_plain(tx, *w)
    lowp = [t.to(torch.bfloat16) if i in (0, 2, 4) else t for i, t in enumerate(w)]
    assert torch.equal(bottleneck_plain(tx, *lowp), got)
    want = np.asarray(j_bottleneck_oracle(jx, *(jnp.asarray(a) for a in args[1:]))
                      .astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_pack_bf16_is_the_kernels_nk_layout():
    rng = np.random.RandomState(24)
    cin, cm = 64, 32
    w1, w2, w3 = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                  for s in ((cin, cm), (3, 3, cm, cm), (cm, cin)))
    pk = pack_bf16(w1, w2, w3)
    assert [tuple(t.shape) for t in pk] == [(cm, cin), (cm, 9 * cm), (cin, cm)]
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in pk)
    torch.testing.assert_close(pk.w1t, w1.t().to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(pk.w3t, w3.t().to(torch.bfloat16), rtol=0, atol=0)
    for tap in (0, 4, 8):  # depth k = tap Cm + c of output n is w2[tap // 3, tap % 3, c, n]
        torch.testing.assert_close(pk.w2t[:, tap * cm:(tap + 1) * cm],
                                   w2[tap // 3, tap % 3].t().to(torch.bfloat16), rtol=0, atol=0)


def test_plan_bf16_shares_the_grid_and_needs_no_split():
    """The bf16 form shares the f32 form's scratch grid (y1, y2: [B, H, W,
    Cm], in bf16) and needs no weight split (its weights come packed), but
    tiles its phases its own way: 256 x 64 where N = 64, 128 x 128 where N >
    64, where the f32 form takes 128 x 64 everywhere."""
    f32 = _plan(3, 11, 9, 256, 64)
    bf = _plan(3, 11, 9, 256, 64, torch.bfloat16)
    assert bf["scratch"] == f32["scratch"] and bf["split_weights"] == 0
    assert bf["scratch_dtype"] == torch.bfloat16 and bf["bk"] == 64
    assert [(p["bm"], p["bn"]) for p in bf["phases"]] == [(256, 64), (256, 64), (128, 128)]
    assert [p["tiles"] for p in bf["phases"]] == [2, 2, 6]   # M = 297
    assert [p["blocks"] for p in bf["phases"]] == [2, 2, 6]
    assert [blocks for _, _, blocks in f32["phases"]] == [3, 3, 12]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_bf16_tiles_cover_every_output_once(shape):
    """Each phase's tiles cover [M, N] once, the persistent grid holds one
    block an SM (at most one a tile), a stage never crosses a 3x3 tap, and
    both stage depths' tiles fit a block's shared memory."""
    B, H, W, cin, cm = shape
    M = B * H * W
    for sms in (132, 7):
        plan = _plan(B, H, W, cin, cm, torch.bfloat16, sms=sms)
        bk = plan["bk"]
        assert bk == (64 if cin % 64 == 0 and cm % 64 == 0 else 32)
        assert cin % bk == 0 and cm % bk == 0   # whole stages, never across a tap
        assert plan["scratch"] == (B, H, W, cm) and plan["split_weights"] == 0
        dims = [(cm, cin), (cm, 9 * cm), (cin, cm)]
        for p, (n, k) in zip(plan["phases"], dims):
            assert (p["n"], p["k"]) == (n, k) and k % bk == 0
            assert (p["bm"], p["bn"]) == ((128, 128) if n > 64 else (256, 64))
            m_tiles, n_tiles = -(-M // p["bm"]), -(-n // p["bn"])
            assert p["tiles"] == m_tiles * n_tiles
            assert (m_tiles - 1) * p["bm"] < M <= m_tiles * p["bm"]
            assert (n_tiles - 1) * p["bn"] < n <= n_tiles * p["bn"]
            assert p["blocks"] == min(p["tiles"], sms) and p["tiles"] < 2 ** 31
            assert {k: p[k] for k in ("bm", "bn", "stages", "smem")} == _bf16_tile(n, bk)
        for depth in (64, 32):   # both instantiations of each phase's tile
            for n, _ in dims:
                t = _bf16_tile(n, depth)
                assert t["stages"] >= 3 and t["smem"] <= 227 * 1024


def test_plan_bf16_matches_the_kernel_source():
    """_plan's bf16 tiles are the mainloop's (csrc/bf16_gemm.cuh): its
    constants, each instantiation's shared memory within 227 KB a block with
    one block an SM, the registers setmaxnreg hands out within the SM's, and
    a stage depth that divides Cin and Cm at every block shape of resnet50,
    101 and 152 and of the tests."""
    import re

    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        bottleneck as mod,
    )

    src = open(f"{_build.CSRC_DIR}/bf16_gemm.cuh").read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["WIDE_BM"], const["WIDE_BN"]) == mod._BF16_WIDE == (128, 128)
    assert (const["NARROW_BM"], const["NARROW_BN"]) == mod._BF16_NARROW == (256, 64)
    assert (const["DEEP_BK"], const["SHALLOW_BK"]) == (mod._BF16_DEEP_BK, mod._BF16_SHALLOW_BK)
    assert (const["PIPE_BYTES"], const["MAX_STAGES"], const["EPI_BUFFERS"],
            const["SMEM_SLACK"]) == (mod._BF16_PIPE_BYTES, mod._BF16_MAX_STAGES,
                                     mod._BF16_EPI_BUFFERS, mod._BF16_SLACK)
    ncw = const["NCW"]
    # the consumers' m64 products: BM rows over NCW warpgroups, 64 rows each
    for bm, bn in (mod._BF16_WIDE, mod._BF16_NARROW):
        assert bm % (64 * ncw) == 0 and bn % const["PANEL"] == 0
    # registers: NCW consumer warpgroups and one producer warpgroup, 128 threads each
    assert 128 * (ncw * const["CONSUMER_REGS"] + const["PRODUCER_REGS"]) <= 65536
    for n in (64, 128):
        for bk in (const["DEEP_BK"], const["SHALLOW_BK"]):
            t = _bf16_tile(n, bk)
            stage = (t["bm"] + t["bn"]) * 2 * bk
            assert t["stages"] == min(const["MAX_STAGES"], const["PIPE_BYTES"] // stage)
            assert t["smem"] == (const["SMEM_SLACK"] + t["stages"] * stage
                                 + const["EPI_BUFFERS"] * t["bm"] * t["bn"] * 2
                                 + 8 * 2 * (t["stages"] + const["EPI_BUFFERS"]))
            # 227 KB a block; 228 KB an SM, 1 KB of it reserved for each block
            assert t["smem"] <= 232448 and t["smem"] + 1024 <= 228 * 1024
            assert 2 * (t["smem"] + 1024) > 228 * 1024   # one block an SM, as planned
    # the C entry's routing, which _plan repeats: 64 deep where Cin and Cm
    # allow it, 128-wide tiles where N > 64, one block a tile up to one an SM
    cu = " ".join(open(f"{_build.CSRC_DIR}/bottleneck_bf16.cu").read().split())
    assert "Cin % bf16mm::DEEP_BK == 0 && Cm % bf16mm::DEEP_BK == 0 ? bf16mm::DEEP_BK" in cu
    assert cu.count("N > NARROW_BN ? tile_plan<WIDE_BN, ") == 2
    assert "tiles < sms ? t : sms" in cu
    resnet = [(cin, cin // 4) for cin in (256, 512, 1024, 2048)]
    for cin, cm in resnet + [(s[3], s[4]) for s in PLAN_SHAPES]:
        bk = _plan(1, 2, 2, cin, cm, torch.bfloat16)["bk"]
        assert cm % bk == 0 and cin % bk == 0
        assert bk == 64 or (cin, cm) not in resnet   # every ResNet block runs 64 deep


def test_bottleneck_refuses_other_dtypes():
    x = torch.zeros((1, 4, 4, 64), dtype=torch.float16)
    w = [torch.zeros(s) for s in ((64, 32), (32,), (3, 3, 32, 32), (32,), (32, 64), (64,))]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bottleneck_fused(x, *w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        trunk_apply_fused({"_arch": "resnet50"}, torch.zeros((1, 8, 8, 3), dtype=torch.float16))


def test_bf16_fused_trunk_matches_jax_fused_trunk(r50_pair):
    """Measured: max|diff| 0.0469 on features up to 4.5 (1.04e-2 of it),
    cosine 0.99998; the stem equal and the first block 1 ulp apart at 22 of
    393,216 values, the rest carried from block to block."""
    x, v, t = r50_pair
    jx, tx = _bf16(x)
    want = j_trunk_apply_fused(fold_trunk_variables(v, "resnet50"), jx, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    folded = fold_trunk(t)
    with torch.no_grad():
        got = trunk_apply_fused(folded, tx)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert _bf16_weights(folded) is folded["_bf16"]
    got = got.float().numpy()
    assert got.shape == want.shape == (1, 2, 3, 2048)
    assert np.abs(got - want).max() <= BF16_MAP_TOL * np.abs(want).max()
    assert _cos(got, want).min() >= BF16_MIN_COS


@pytest.fixture(scope="module")
def bf16_fused_run():
    """resnet50 + GeM (kernel head) in bf16 with fuse_blocks: the port's
    extractor, the JAX one on the same weights (through its ``torch_port``)
    and the port's unfused bf16 extractor, on one masked bucket."""
    cfg = port.ExtractConfig(model=port.ModelConfig(arch="resnet50", dtype="bfloat16",
                                                    use_pallas=True), fuse_blocks=True)
    fused = port.Extractor(cfg, seed=3, device="cpu")
    sd = fused.model.state_dict()
    jex = JExtractor(jcfg.ExtractConfig(model=jcfg.ModelConfig(
        arch="resnet50", dtype="bfloat16", use_pallas=True), fuse_blocks=True),
        variables=jax.tree.map(jnp.asarray, port_retrieval_net(sd, "resnet50")))
    unfused = port.Extractor(dataclasses.replace(cfg, fuse_blocks=None), state_dict=sd,
                             device="cpu")
    assert fused._folded is not None and unfused._folded is None
    rng = np.random.RandomState(4)
    x = rng.randn(2, 64, 96, 3).astype(np.float32)
    mask = np.zeros((2, 64, 96), bool)
    mask[0] = True
    mask[1, :40, :64] = True
    x = x * mask[..., None]
    return fused(x, mask), np.asarray(jex(x, mask)), unfused(x, mask)


def _hold_descriptors(a, b):
    assert a.shape == b.shape == (2, 2048) and np.isfinite(a).all()
    assert np.abs(a - b).max() <= BF16_MAX_DIFF
    assert _cos(a, b).min() >= BF16_MIN_COS
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)


def test_bf16_extractor_fuse_blocks_matches_jax(bf16_fused_run):
    """Measured: max|diff| 5.0e-4, cosine 0.99999."""
    got, want, _ = bf16_fused_run
    _hold_descriptors(got, want)


def test_bf16_extractor_fuse_blocks_matches_unfused(bf16_fused_run):
    """Folding BN moves bf16's rounding points: measured max|diff| 9.5e-4,
    cosine 0.99997 (the JAX package's own fused and unfused bf16
    extractors differ by about as much)."""
    got, _, unfused = bf16_fused_run
    _hold_descriptors(got, unfused)
