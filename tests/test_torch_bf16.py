"""Port parity: the bf16 trunk (graded configs 4 and 5) against the JAX
package's bf16 trunk, on the same seeded inputs and weights.

The JAX package computes with ``dtype=bfloat16`` and f32 parameters. The
rounding points are pinned on one conv + BN + ReLU block (equal, or within
1 bf16 ulp). Whole models are held to a stated descriptor bound: every
rounding agrees, but the two packages' f32 convolutions sum in different
orders, so a bf16 rounding can flip and carry through the next layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irtpu.api import Extractor as JExtractor
from irtpu.models import RetrievalNet as JNet
from irtpu.models.resnet import _ConvBN
from irtpu.models.torch_port import port_retrieval_net, port_vgg_trunk
from irtpu.models.vgg import VGGTrunk as JVGGTrunk
from irtpu.retrieval.index import Index as JIndex
from irtpu.utils import config as jcfg

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.models import (
    RetrievalNet,
    VGGTrunk,
    init_random_,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (
    conv_bn,
    lowp_weight,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

# descriptor bound for whole bf16 models (unit-norm descriptors); measured
# on these inputs: max|diff| 1.7e-3 (resnet18), 9.7e-4 (resnet50), 1.1e-3
# (resnet18, two scales), cosine >= 0.99997 throughout
BF16_MAX_DIFF = 1e-2
BF16_MIN_COS = 0.999


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """bf16 <-> f32 copies on this CPU slow down sharply with many
    threads; two are enough for these small shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bits(a):
    """bf16 values (as any float array) -> their 16-bit patterns as int."""
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).int().numpy()


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (1, 2, 0), (7, 2, 3)])
def test_convbn_relu_block_within_one_ulp(k, stride, pad):
    """One _ConvBN + ReLU in bf16: the JAX block and the port's give the
    same bits (1 bf16 ulp allowed)."""
    rs = np.random.RandomState(k)
    cin, cout = 24, 40
    x = rs.randn(2, 17, 19, cin).astype(np.float32)
    w = (rs.randn(k, k, cin, cout) * (2.0 / (k * k * cin)) ** 0.5).astype(np.float32)
    scale = (rs.rand(cout) * 0.5 + 0.5).astype(np.float32)
    bias = (rs.randn(cout) * 0.1).astype(np.float32)
    mean = (rs.randn(cout) * 0.1).astype(np.float32)
    var = (rs.rand(cout) + 0.5).astype(np.float32)
    variables = {"params": {"conv": {"kernel": w}, "bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean, "var": var}}}
    xb = jnp.asarray(x, jnp.bfloat16)
    want = _ConvBN(cout, k, stride, pad, jnp.bfloat16).apply(variables, xb)
    want = np.asarray(jax.nn.relu(want).astype(jnp.float32))

    conv = torch.nn.Conv2d(cin, cout, k, stride, pad, bias=False)
    bn = torch.nn.BatchNorm2d(cout).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean),
                        ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
    tx = (torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
          .contiguous(memory_format=torch.channels_last))
    with torch.no_grad():
        got = torch.relu(conv_bn(conv, bn, tx))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    ulps = np.abs(_bits(got) - _bits(want))
    assert ulps.max() <= 1, (int(ulps.max()), int((ulps > 0).sum()))


def test_bf16_weights_cast_once_and_refreshed_on_write():
    """Inference (no grad mode) casts once and keeps the cast; in grad mode
    (training) the cast sits in the graph, so the f32 weight gets its
    gradient."""
    conv = torch.nn.Conv2d(3, 8, 3, bias=False)
    with torch.no_grad():
        a = lowp_weight(conv, torch.bfloat16)
        assert a.dtype == torch.bfloat16 and lowp_weight(conv, torch.bfloat16) is a
        conv.weight.mul_(2.0)
        b = lowp_weight(conv, torch.bfloat16)
    assert b is not a
    torch.testing.assert_close(b.float(), conv.weight.detach().to(torch.bfloat16).float())
    c = lowp_weight(conv, torch.bfloat16)
    assert c.dtype == torch.bfloat16 and c.requires_grad and c is not b
    torch.testing.assert_close(c.detach().float(), b.float(), rtol=0, atol=0)
    c.float().sum().backward()
    assert conv.weight.grad is not None and conv.weight.grad.dtype == torch.float32
    # parameters and the state_dict stay f32
    assert conv.weight.dtype == torch.float32
    assert all(v.dtype != torch.bfloat16 for v in conv.state_dict().values())


def _clustered_images(n_scenes=3, views=2, seed=0, side=64):
    """Scenes of low-frequency texture; views are jittered crops in two
    aspect ratios, queries fresh square jitters (uint8 HWC)."""
    rng = np.random.RandomState(seed)
    db, queries, labels = [], [], []
    for s in range(n_scenes):
        proto = np.kron(rng.rand(8, 8, 3), np.ones((side // 8, side // 8, 1)))

        def jitter(h, w):
            img = np.roll(proto, rng.randint(-3, 4), axis=rng.randint(0, 2))[:h, :w]
            img = img + rng.randn(h, w, 3) * 0.04
            return (np.clip(img, 0, 1) * 255).astype(np.uint8)

        for v in range(views):
            db.append(jitter(side, side if v % 2 == 0 else side * 3 // 4))
            labels.append(s)
        queries.append(jitter(side, side))
    return db, queries, np.asarray(labels)


def _extractor_pair(arch, scales=(1.0,), use_pallas=True, size=64):
    net = RetrievalNet(arch, "gem")
    init_random_(net, torch.Generator().manual_seed(5))
    with torch.no_grad():
        net.pool.p.fill_(3.0)
    sd = net.state_dict()
    variables = jax.tree.map(jnp.asarray, port_retrieval_net(sd, arch))
    cfg = dict(image_size=size, scales=scales, batch_size=4)
    ex_t = port.Extractor(port.ExtractConfig(model=port.ModelConfig(
        arch=arch, dtype="bfloat16", use_pallas=use_pallas), **cfg), state_dict=sd, device="cpu")
    ex_j = JExtractor(jcfg.ExtractConfig(model=jcfg.ModelConfig(
        arch=arch, dtype="bfloat16", use_pallas=use_pallas), **cfg), variables=variables)
    return ex_t, ex_j


def _hold(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    assert np.abs(a - b).max() <= BF16_MAX_DIFF, np.abs(a - b).max()
    assert cos.min() >= BF16_MIN_COS, cos.min()
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("arch,scales", [("resnet18", (1.0,)), ("resnet50", (1.0,)),
                                         ("resnet18", (1.0, 2 ** -0.5))],
                         ids=["resnet18", "resnet50", "resnet18-2scales"])
def test_bf16_descriptors_and_top1_match_jax(arch, scales):
    """Whole bf16 models through each package's Extractor (uint8 batches,
    normalize into bf16, fused GeM head), weights carried by the converter:
    descriptors within the bound and the same top-1 for every query."""
    db, queries, labels = _clustered_images()
    ex_t, ex_j = _extractor_pair(arch, scales)
    d_t, d_j = ex_t.extract(db), np.asarray(ex_j.extract(db))
    q_t, q_j = ex_t.extract(queries), np.asarray(ex_j.extract(queries))
    _hold(d_t, d_j)
    _hold(q_t, q_j)
    _, i_t = port.build_index(d_t, port.IndexConfig(whitening=None), device="cpu").query(q_t, k=1)
    _, i_j = JIndex.build(d_j, jcfg.IndexConfig(whitening=None)).query(q_j, k=1)
    np.testing.assert_array_equal(i_t, np.asarray(i_j))


def test_bf16_call_on_f32_pixels_casts_at_the_trunk():
    """__call__ on f32 pixels: both packages cast at the trunk's input."""
    ex_t, ex_j = _extractor_pair("resnet18")
    x = np.random.RandomState(3).randn(2, 64, 48, 3).astype(np.float32)
    mask = np.zeros((2, 64, 48), bool)
    mask[0] = True
    mask[1, :40, :32] = True
    _hold(ex_t(x), np.asarray(ex_j(x)))
    _hold(ex_t(x, mask), np.asarray(ex_j(x, mask)))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain-head", "kernel-head"])
def test_gem_head_on_bf16_features(use_kernel):
    """The head on a bf16 feature map, masked and not: the plain GeM head
    pools feats.float(); the fused head reads bf16 and sums in f32. Both
    against the JAX head (use_pallas False / True)."""
    rs = np.random.RandomState(7)
    feats = np.maximum(rs.randn(3, 4, 5, 512), 0).astype(np.float32)
    fb = jnp.asarray(feats, jnp.bfloat16)
    fmask = np.zeros((3, 4, 5), bool)
    fmask[0] = True
    fmask[1, :3, :4] = True
    fmask[2, :1, :2] = True
    net = RetrievalNet("resnet18", "gem", use_kernel=use_kernel, dtype="bfloat16").eval()
    with torch.no_grad():
        net.pool.p.fill_(2.7)
    jnet = JNet(arch="resnet18", pooling="gem", use_pallas=use_kernel, dtype=jnp.bfloat16)
    variables = {"params": {"gem_p": jnp.asarray(2.7, jnp.float32)}}
    tb = torch.from_numpy(np.array(fb.astype(jnp.float32))).to(torch.bfloat16)
    for m in (None, fmask):
        want = np.asarray(jnet.apply(variables, fb, mask=None if m is None else jnp.asarray(m),
                                     precomputed_features=True))
        with torch.no_grad():
            got = net.head(tb, None if m is None else torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_vgg16_trunk_bf16_matches_jax():
    """VGG-16 in bf16: each conv rounds, the bf16 bias is added in bf16."""
    trunk = VGGTrunk()
    init_random_(trunk, torch.Generator().manual_seed(2))
    x = np.random.RandomState(4).randn(1, 32, 48, 3).astype(np.float32)
    tx = (torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
          .contiguous(memory_format=torch.channels_last))
    with torch.no_grad():
        got = trunk.eval()(tx)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    v = port_vgg_trunk(trunk.state_dict(), prefix="")
    want = np.asarray(JVGGTrunk(dtype=jnp.bfloat16).apply(
        v, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-2 * scale, np.abs(got - want).max() / scale


def test_graded_config5_model_is_admitted():
    """Config 5's ExtractConfig passes check_supported (at a toy width)."""
    cfg5 = port.GRADED_CONFIGS[5].extract
    assert cfg5.model.dtype == "bfloat16" and cfg5.model.use_pallas
    ex = port.Extractor(dataclasses.replace(cfg5, model=dataclasses.replace(
        cfg5.model, arch="resnet18")), device="cpu")
    assert ex.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in ex.model.parameters())
