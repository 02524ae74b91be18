"""VGG-16 + NetVLAD as NetVLAD's ``vd16_pitts30k_conv5_3_vlad_preL2_intra_white``
and hloc run it (``netvlad_prel2=True``): the trunk cut before its last ReLU
(``VGGTrunk(last_relu=False)``), each local descriptor L2-normalized before
the aggregation (the kernels' ``pre_l2``) and a 32,768 -> 4,096 FC
whitening, here at a small size on the CPU with seeded weights. ``Extractor.extract`` against the benchmark's plain
reference (``retrieval_bench/reference/vgg_netvlad.py``); the kernels' plain
version with ``pre_l2`` against the oracle on ``F.normalize``d rows; the
Function's gradients; the option's refusals and defaults. One test, marked
``cuda``, holds the kernels against their plain version on the card at the
cell's four map shapes."""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from retrieval_bench.reference import vgg_netvlad as ref

from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor
from image_retrieval_for_image_based_localization_tpu_torch.models.init import init_random_
from image_retrieval_for_image_based_localization_tpu_torch.models import retrieval_net
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    RetrievalNet,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.vgg import VGGTrunk
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    netvlad_fused,
    netvlad_fused_rect,
    netvlad_plain,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.netvlad import EPS
from image_retrieval_for_image_based_localization_tpu_torch.ops.netvlad import netvlad_aggregate
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
    ExtractConfig,
    ModelConfig,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

K, WHITEN = 8, 16
ALPHA = 20.0


def _config(use_pallas=True) -> ExtractConfig:
    return ExtractConfig(
        model=ModelConfig(arch="vgg16", pooling="netvlad", netvlad_clusters=K,
                          whiten_dim=WHITEN, use_pallas=use_pallas, netvlad_prel2=True),
        image_size=64, batch_size=2, bucket_multiple=32)


def _state_dict(seed=3) -> dict:
    """The port's random init, with unit centroids c_k and the assignment
    w_k = 2 alpha c_k, bias 0 (the benchmark's weights, at this size)."""
    model = RetrievalNet("vgg16", "netvlad", whiten_dim=WHITEN, netvlad_clusters=K,
                         netvlad_prel2=True)
    init_random_(model, torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    g = torch.Generator().manual_seed(seed + 1)
    c = torch.randn((K, 512), generator=g)
    c = c / c.norm(dim=1, keepdim=True)
    sd["pool.centroids"] = c
    sd["pool.conv.weight"] = (2 * ALPHA * c).reshape(K, 512, 1, 1)
    sd["pool.conv.bias"] = torch.zeros(K)
    return sd


def _images():
    """uint8 images at max side 64: two that the bucketing pads (48 x 64,
    64 x 43) and one at a bucket's size (64 x 64)."""
    rng = np.random.RandomState(0)
    out = []
    for h, w in ((48, 64), (64, 43), (64, 64)):
        smooth = np.kron(rng.rand(-(-h // 8), -(-w // 8), 3), np.ones((8, 8, 1)))[:h, :w]
        out.append(np.clip(255 * (0.6 * smooth + 0.4 * rng.rand(h, w, 3)), 0, 255)
                   .astype(np.uint8))
    return out


def test_extract_matches_the_plain_reference(monkeypatch):
    """The kernel route (its plain version on the CPU) and the plain route
    against the reference image by image, within 2e-5 in L2: float32 on both
    sides, summed in other orders (a channels-last trunk, the kernel's
    per-row scale against normalized rows, products against hloc's residual
    sums). Every batch of the bucketed images takes ``netvlad_fused_rect``."""
    routes = []
    for name in ("netvlad_fused", "netvlad_fused_rect", "netvlad_aggregate"):
        def call(*a, _fn=getattr(retrieval_net, name), _name=name, **k):
            routes.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(retrieval_net, name, call)
    sd, imgs = _state_dict(), _images()
    want = np.stack([ref.descriptor(im, sd, 64, 32, device="cpu").numpy() for im in imgs])
    got = Extractor(_config(), state_dict=sd, device="cpu").extract(imgs)
    assert routes == ["netvlad_fused_rect"] * 2
    plain = Extractor(_config(use_pallas=False), state_dict=sd, device="cpu").extract(imgs)
    assert routes[2:] == ["netvlad_aggregate"] * 2
    assert got.shape == (3, WHITEN)
    for d in (got, plain):
        assert np.linalg.norm(d - want, axis=1).max() < 2e-5
    # the images are told apart: the comparison sees an image's own descriptor
    assert np.linalg.norm(want[0] - want[1]) > 1e-2


def _inputs(seed, B=3, H=5, W=7, C=32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, H, W, C), generator=g) * 3.0  # signed, as conv5_3 before its ReLU
    c = torch.randn((K, C), generator=g)
    c = c / c.norm(dim=1, keepdim=True)
    return x, c, (2 * ALPHA * c).t().contiguous(), 0.1 * torch.randn(K, generator=g)


SIZES = torch.tensor([[5, 7], [0, 0], [3, 4]], dtype=torch.int32)


def _mask(sizes, H, W):
    return ((torch.arange(H)[:, None] < sizes[:, 0, None, None])
            & (torch.arange(W) < sizes[:, 1, None, None]))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "rect"])
def test_plain_pre_l2_matches_the_oracle_on_normalized_rows(masked):
    """pre_l2 as the kernel computes it (a per-row scale in the logits and
    the aggregation's weights, the mass unscaled) against ``netvlad_aggregate``
    on ``F.normalize``d rows; a zero row (F.normalize's 1e-12 floor) included."""
    x, c, w, b = _inputs(1)
    x[2, 0, 0] = 0.0
    if masked:
        got = netvlad_fused_rect(x, c, w, b, sizes=SIZES, pre_l2=True)
        assert torch.equal(got, netvlad_plain(x, c, w, b, SIZES, pre_l2=True))
        want = netvlad_aggregate(F.normalize(x, dim=-1), c, w, b, mask=_mask(SIZES, 5, 7))
    else:
        got = netvlad_fused(x, c, w, b, pre_l2=True)
        want = netvlad_aggregate(F.normalize(x, dim=-1), c, w, b)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # a per-row scale is what preL2 changes: the rows' norms differ
    assert (got - netvlad_plain(x, c, w, b, SIZES if masked else None)).abs().max() > 1e-2


@pytest.mark.parametrize("entry", ["fused", "rect"])
def test_function_gradients_with_pre_l2_match_autograd_of_the_plain_path(entry):
    """The autograd Function (its backward the oracle's VJP on
    ``F.normalize``d rows) against autograd through the plain version's own
    arithmetic with ``pre_l2``, for x, the centroids, the assignment and its
    bias, within 1e-5 of max|g| (no empty image: the plain version's norm
    has no derivative at a zero row)."""
    x, c, w, b = _inputs(2)
    g = torch.randn((3, K * 32), generator=torch.Generator().manual_seed(5))
    sizes = None
    if entry == "rect":
        sizes = torch.tensor([[5, 7], [2, 3], [3, 4]], dtype=torch.int32)
    grads = []
    for kernel in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, c, w, b)]
        if kernel:
            out = (netvlad_fused(*leaves, pre_l2=True) if sizes is None
                   else netvlad_fused_rect(*leaves, sizes=sizes, pre_l2=True))
            assert type(out.grad_fn).__name__ == "_NetVLADBackward"
        else:
            out = netvlad_plain(*leaves, sizes, pre_l2=True)
        out.backward(g)
        grads.append([t.grad for t in leaves])
    for gk, gp in zip(*grads):
        assert torch.isfinite(gk).all()
        torch.testing.assert_close(gk, gp, rtol=0, atol=1e-5 * float(gp.abs().max()))


def test_last_relu_false_drops_features_29_and_loads_the_same_state_dict():
    cut, full = VGGTrunk(last_relu=False), VGGTrunk()
    assert len(cut) == 29 and len(full) == 30 and isinstance(full[29], nn.ReLU)
    assert not isinstance(cut[28], nn.ReLU) and isinstance(cut[28], nn.Conv2d)
    init_random_(full, torch.Generator().manual_seed(0))
    sd = full.state_dict()
    assert set(cut.state_dict()) == set(sd)
    cut.load_state_dict(sd)
    full.load_state_dict(cut.state_dict())
    x = torch.randn((1, 3, 32, 48), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y_cut, y_full = cut(x), full(x)
    assert (y_cut < 0).any()  # conv5_3's signed output
    assert torch.equal(torch.relu(y_cut), y_full)
    nets = [RetrievalNet("vgg16", "netvlad", netvlad_prel2=p) for p in (False, True)]
    nets[1].load_state_dict(nets[0].state_dict())
    assert len(nets[1].features) == 29 and nets[1].pre_l2 and not nets[0].pre_l2


def test_options_refused_where_they_do_not_apply():
    """``netvlad_prel2`` off vgg16 or off NetVLAD."""
    with pytest.raises(ValueError, match="netvlad_prel2"):
        RetrievalNet("resnet18", "netvlad", netvlad_prel2=True)
    with pytest.raises(ValueError, match="netvlad_prel2"):
        Extractor(ExtractConfig(model=ModelConfig(arch="alexnet", pooling="netvlad",
                                                  netvlad_prel2=True)), device="cpu")
    for pooling in ("gem", "mac", "rmac"):
        with pytest.raises(ValueError, match="netvlad_prel2"):
            RetrievalNet("vgg16", pooling, netvlad_prel2=True)


def _old_netvlad_plain(x, centroids, assign_w, assign_b, sizes):
    """The plain version as it was before ``pre_l2``, written out."""
    W = x.shape[2]
    x = x.reshape(x.shape[0], -1, x.shape[-1]).float()
    B, N, C = x.shape
    logits = torch.matmul(x, assign_w.float()) + assign_b.float()
    a = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    a = a / torch.sum(a, dim=-1, keepdim=True)
    if sizes is not None:
        sizes = sizes.to(torch.int64)
        n = torch.arange(N)
        valid = ((n // W)[None, :] < sizes[:, 0:1]) & ((n % W)[None, :] < sizes[:, 1:2])
        a = torch.where(valid[..., None], a, torch.zeros(()))
    agg = torch.matmul(a.transpose(1, 2), x)
    vlad = agg - a.sum(dim=1)[..., None] * centroids.float()[None]
    vlad = vlad / (torch.sqrt(torch.sum(vlad * vlad, dim=-1, keepdim=True)) + EPS)
    flat = vlad.reshape(B, -1)
    return flat / (torch.sqrt(torch.sum(flat * flat, dim=-1, keepdim=True)) + EPS)


def test_defaults_give_the_same_bits_as_before():
    """``ModelConfig``'s and ``RetrievalNet``'s defaults keep the last ReLU
    and no preL2; the plain version and the head then give the bits of the
    code before these options."""
    mc = ModelConfig()
    assert mc.netvlad_prel2 is False
    x, c, w, b = _inputs(4)
    for sizes in (None, SIZES):
        assert torch.equal(netvlad_plain(x, c, w, b, sizes), _old_netvlad_plain(x, c, w, b, sizes))
    net = RetrievalNet("vgg16", "netvlad", netvlad_clusters=K, use_kernel=True)
    assert isinstance(net.features[29], nn.ReLU) and not net.pre_l2
    init_random_(net, torch.Generator().manual_seed(6))
    feats = torch.relu(torch.randn((3, 5, 7, 512), generator=torch.Generator().manual_seed(7)))
    mask = _mask(SIZES, 5, 7)
    with torch.no_grad():
        got = net.head(feats, mask)
        net.use_kernel = False
        plain = net.head(feats, None)
    pool = net.pool
    assert torch.equal(got, _old_netvlad_plain(feats, pool.centroids, pool.assign_w(),
                                               pool.conv.bias, SIZES))
    assert torch.equal(plain, netvlad_aggregate(feats, pool.centroids, pool.assign_w(),
                                                pool.conv.bias))


# the cell's maps at stride 16 (H, W, valid h, valid w): 768 x 1024, 683 x
# 1024 in the 704 bucket, and both turned
CELL_MAPS = [(48, 64, 48, 64), (44, 64, 43, 64), (64, 48, 64, 48), (64, 44, 64, 43)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,h,w", CELL_MAPS, ids=["48x64", "44x64", "64x48", "64x44"])
def test_pre_l2_kernel_matches_plain_on_the_card(H, W, h, w):
    """At the cell's head width, [16, H x W, 512], K = 64, with ragged
    extents, a zero feature row and a batch-pad row: the pre_l2 kernels
    within 1e-5 of their plain version, the same bits on a second call, and
    the default launch unchanged by the option's code (its result the plain
    default's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device("cuda")
    g = torch.Generator().manual_seed(11)
    B, C, KK = 16, 512, 64
    x = torch.randn((B, H, W, C), generator=g)
    x[0, 0, 0] = 0.0
    c = torch.randn((KK, C), generator=g)
    c = c / c.norm(dim=1, keepdim=True)
    w_, b = (2 * ALPHA * c).t().contiguous(), 0.1 * torch.randn(KK, generator=g)
    sizes = torch.tensor([[h, w]] * 12 + [[h - 5, w], [h, w - 7], [1, 1], [0, 0]],
                         dtype=torch.int32)
    x, c, w_, b, sizes = (t.to(dev) for t in (x, c, w_, b, sizes))
    for bias in (None, b):
        got = netvlad_fused_rect(x, c, w_, bias, sizes=sizes, pre_l2=True)
        torch.testing.assert_close(got, netvlad_plain(x, c, w_, bias, sizes, pre_l2=True),
                                   rtol=0, atol=1e-5)
        assert torch.all(got[B - 1] == 0)
        assert torch.equal(got, netvlad_fused_rect(x, c, w_, bias, sizes=sizes, pre_l2=True))
        got = netvlad_fused(x, c, w_, bias, pre_l2=True)
        torch.testing.assert_close(got, netvlad_plain(x, c, w_, bias, pre_l2=True),
                                   rtol=0, atol=1e-5)
    torch.testing.assert_close(netvlad_fused_rect(x, c, w_, b, sizes=sizes),
                               netvlad_plain(x, c, w_, b, sizes), rtol=0, atol=1e-5)
