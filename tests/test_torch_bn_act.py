"""The bf16 trunk's inference BatchNorm + residual add + ReLU pass
(``ops/kernels/bn_act.py``, ``csrc/bn_act.cu``) and its routing in
``models/resnet.py``.

On the CPU: the plain version is the chain the trunk ran before the kernel,
bit for bit; the kernel's wrapper refuses what the kernel does not take; a
bf16 trunk in eval mode routes every BatchNorm to the plain chain and
launches nothing. Marked ``cuda`` (skipped without a card): the kernel
against the plain version bit for bit at resnet101's BatchNorm shapes at
Aachen's buckets, on ragged rows with special values, the router on maps in
another layout and under grad mode, and a whole trunk through both routes.
On a machine with a card (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_bn_act.py -q
"""

import re

import pytest
import torch

from image_retrieval_for_image_based_localization_tpu_torch.models import resnet
from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.bn_act import (
    bn_act,
    bn_act_plain,
    bn_lowp,
    bn_params,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

CL = torch.channels_last


def _bn(C: int, seed: int, device="cpu") -> torch.nn.BatchNorm2d:
    """An eval-mode BatchNorm with the benchmark's random statistics; channel
    0 has mean 0 and bias -0.0, so a -0 input stays -0 through it."""
    g = torch.Generator().manual_seed(seed)
    bn = torch.nn.BatchNorm2d(C).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=g) * 0.5 + 0.5)
        bn.bias.copy_(torch.randn(C, generator=g) * 0.1)
        bn.running_mean.copy_(torch.randn(C, generator=g) * 0.1)
        bn.running_var.copy_(torch.rand(C, generator=g) + 0.5)
        bn.running_mean[0] = 0.0
        bn.bias[0] = -0.0
    return bn.to(device)


def _map(shape, seed: int, device="cpu", scale=3.0) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device) * scale
    return x.to(torch.bfloat16).contiguous(memory_format=CL)


def _old_chain(y, bn, relu, identity):
    """What ``Bottleneck.forward`` and ``BasicBlock.forward`` ran after each
    convolution before the kernel: ``bn_lowp``, ``+ identity``, ``relu_``."""
    out = bn_lowp(bn, y)
    if identity is not None:
        out = out + identity
    if relu:
        out = torch.nn.ReLU(inplace=True)(out)
    return out


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    """Bit for bit where ``want`` is a number (finite, infinite or a signed
    zero); NaN exactly where ``want`` is NaN."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got.view(torch.int16), want.view(torch.int16)
    diff = (g != w) & ~nan
    assert not diff.any(), (int(diff.sum()), got[diff][:8], want[diff][:8])


@pytest.mark.parametrize("C", [64, 256, 2048])
@pytest.mark.parametrize("with_identity", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_is_the_old_chain_bit_for_bit(relu, with_identity, C):
    """On ragged row counts (N * H * W of 3 * 5 * 7), with signed zeros."""
    bn = _bn(C, C)
    y = _map((3, C, 5, 7), 1)
    y[:, 0, ::2] = -0.0
    identity = _map((3, C, 5, 7), 2) if with_identity else None
    y0 = y.clone()
    want = _old_chain(y, bn, relu, identity)
    got = bn_act_plain(y, bn, relu, identity)
    _same_bits(got, want)
    assert torch.equal(y.view(torch.int16), y0.view(torch.int16))
    # through the router: the CPU stays on the plain chain
    with torch.no_grad():
        _same_bits(resnet.bn_eval_lowp(bn, y, relu, identity, inplace=True), want)


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA device"),
    ("float32", "bfloat16"),
    ("nchw", "channels_last"),
    ("channels", "multiple of 8"),
])
def test_kernel_wrapper_refuses(case, match):
    C = 20 if case == "channels" else 64
    y = _map((2, C, 3, 4), 0)
    if case == "float32":
        y = y.float()
    if case == "nchw":
        y = y.contiguous()
    with pytest.raises(ValueError, match=match):
        bn_act(y, _bn(C, 0), relu=True)


@pytest.mark.parametrize("arch, n_bn", [("resnet18", 20), ("resnet50", 53), ("resnet101", 104)])
def test_cpu_inference_routes_every_bn_plain_and_counts_it(arch, n_bn, monkeypatch):
    """A bf16 eval-mode trunk's BatchNorms (stem, every block's, each
    downsample's) all take the plain chain on the CPU, once each a forward,
    and launch no kernel; an f32 forward takes neither."""
    plain = []

    def counted(*args):
        plain.append(1)
        return bn_act_plain(*args)

    monkeypatch.setattr(resnet, "bn_act_plain", counted)
    torch.manual_seed(0)
    trunk = resnet.ResNetTrunk(arch).eval()
    x = torch.randn(1, 3, 64, 64).to(torch.bfloat16).contiguous(memory_format=CL)
    kernels.reset_launch_counts()
    with torch.no_grad():
        trunk(x)
        assert len(plain) == n_bn
        trunk(x.float())
    assert len(plain) == n_bn
    assert kernels.launch_counts()["bn_act"] == 0


def test_launch_counts_include_bn_act():
    """``bn_act`` is counted and reset with the other kernels."""
    bn_act.launches = 7
    assert kernels.launch_counts()["bn_act"] == 7
    kernels.reset_launch_counts()
    assert bn_act.launches == 0 and kernels.launch_counts()["bn_act"] == 0


def test_bn_params_made_once_with_bn_lowps_bits_and_again_after_a_write():
    bn = _bn(64, 3)
    a = bn_params(bn)
    assert bn_params(bn) is a
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    assert torch.equal(a[1], mul.detach()) and torch.equal(a[0], bn.running_mean)
    assert torch.equal(a[2], bn.bias.detach())
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in a)
    with torch.no_grad():
        bn.running_var.mul_(2.0)
    b = bn_params(bn)
    assert b is not a
    assert torch.equal(b[1], (torch.rsqrt(bn.running_var + bn.eps) * bn.weight).detach())


def test_bn_act_forward_signature():
    """bn_act_forward: the map, the identity, the three per-channel vectors,
    the output, rows, C, the ReLU flag and the stream, as the wrapper passes
    them."""
    with open(f"{_build.CSRC_DIR}/bn_act.cu") as f:
        params = re.search(r"\bint bn_act_forward\(([^)]*)\)", f.read()).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names == ["y", "identity", "mean", "mul", "bias", "out", "rows", "C", "relu",
                     "stream"]
    assert _build.SIGNATURES["bn_act"]["bn_act_forward"] == (_build._P,) * 6 + (
        _build._I,) * 3 + (_build._P,)


# ----------------------------------------------------------------- on the card

AACHEN_BUCKETS = [(768, 1024), (704, 1024), (1024, 768), (1024, 704)]


def _resnet101_bns(H: int, W: int):
    """(C, h, w, reads the identity, ReLU) of each distinct BatchNorm of
    resnet101 at an H x W input: the stem, each block's bn1 (at the block's
    input size), bn2 and bn3 (its output size, bn3 with the identity) and
    each stage's downsample (no ReLU)."""
    def out(n, k, s, p):
        return (n + 2 * p - k) // s + 1

    h, w = out(H, 7, 2, 3), out(W, 7, 2, 3)
    bns = {(64, h, w, False, True)}
    h, w = out(h, 3, 2, 1), out(w, 3, 2, 1)
    for i, (width, depth) in enumerate(zip((64, 128, 256, 512), (3, 4, 23, 3))):
        for j in range(depth):
            s = 2 if i > 0 and j == 0 else 1
            ho, wo = out(h, 3, s, 1), out(w, 3, s, 1)
            bns |= {(width, h, w, False, True), (width, ho, wo, False, True),
                    (4 * width, ho, wo, True, True)}
            if j == 0:
                bns.add((4 * width, ho, wo, False, False))
            h, w = ho, wo
    return sorted(bns)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", AACHEN_BUCKETS, ids=lambda b: f"{b[0]}x{b[1]}")
def test_kernel_matches_plain_at_resnet101_aachen_shapes(dev, bucket):
    """Every (C, h, w) of resnet101's BatchNorms at the bucket, batch 16, in
    the form the trunk calls it, in place and not: the plain chain's bits."""
    for k, (C, h, w, with_id, relu) in enumerate(_resnet101_bns(*bucket)):
        bn = _bn(C, k, dev)
        y = _map((16, C, h, w), 2 * k, dev)
        identity = _map((16, C, h, w), 2 * k + 1, dev) if with_id else None
        want = bn_act_plain(y, bn, relu, identity)
        got = bn_act(y, bn, relu, identity)
        _same_bits(got, want)
        assert got.is_contiguous(memory_format=CL)
        _same_bits(bn_act(y, bn, relu, identity, inplace=True), want)
        del y, identity, want, got
    torch.cuda.empty_cache()


SPECIALS = [0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1e-40, -1e-40, 3e38, -3e38,
            5e-39, 1e-38, -2.5]


def _with_specials(x: torch.Tensor, seed: int) -> torch.Tensor:
    """``x`` with every third element one of SPECIALS (signed zeros, infinities,
    NaN, subnormals, values that overflow once scaled) and channel 0's even
    rows -0.0."""
    g = torch.Generator().manual_seed(seed)
    flat = x.float().permute(0, 2, 3, 1).reshape(-1).clone()
    pos = torch.randperm(flat.numel(), generator=g)[: flat.numel() // 3]
    flat[pos] = torch.tensor(SPECIALS)[torch.arange(pos.numel()) % len(SPECIALS)]
    N, C, H, W = x.shape
    t = flat.reshape(N, H, W, C).permute(0, 3, 1, 2)
    t[:, 0, ::2] = -0.0
    return t.to(torch.bfloat16).contiguous(memory_format=CL)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 64, 264, 2048])
@pytest.mark.parametrize("with_identity", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_kernel_ragged_rows_and_special_values(dev, relu, with_identity, C):
    """Row counts 1 to 2,970 (not multiples of the kernel's unroll), maps
    and identities with ±0, ±inf, NaN and subnormals: numbers bit for bit
    (signed zeros too), NaN where the plain chain gives NaN; ``y`` untouched
    out of place."""
    for N, H, W in [(1, 1, 1), (1, 3, 5), (3, 7, 11), (2, 33, 45)]:
        bn = _bn(C, C + H, dev)
        y = _with_specials(_map((N, C, H, W), H, scale=2.0), H).to(dev)
        identity = None
        if with_identity:
            identity = _with_specials(_map((N, C, H, W), H + 1, scale=2.0), H + 1).to(dev)
        want = bn_act_plain(y, bn, relu, identity)
        y0 = y.clone()
        got = bn_act(y, bn, relu, identity)
        assert torch.equal(y.view(torch.int16), y0.view(torch.int16))
        _same_bits(got, want)
        _same_bits(bn_act(y, bn, relu, identity, inplace=True), want)


def _random_bn_(trunk: torch.nn.Module, seed: int) -> None:
    """The benchmark configuration's BatchNorm statistics, with bn3's scale
    from U(0.1, 0.3) so the residual stream stays in range."""
    g = torch.Generator().manual_seed(seed)
    for name, m in trunk.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            C = m.num_features
            lo, hi = (0.1, 0.3) if name.endswith("bn3") else (0.5, 1.0)
            with torch.no_grad():
                m.weight.copy_(torch.rand(C, generator=g) * (hi - lo) + lo)
                m.bias.copy_(torch.randn(C, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(C, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(C, generator=g) + 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("with_identity", [False, True])
def test_router_takes_other_layouts_on_the_kernel(dev, with_identity):
    """An NCHW map (and identity) on the card: a channels_last copy through
    the kernel, the plain chain's bits, ``y`` untouched, one launch."""
    bn = _bn(64, 5, dev)
    y = _map((2, 64, 9, 13), 5, dev).contiguous()
    identity = _map((2, 64, 9, 13), 6, dev).contiguous() if with_identity else None
    y0 = y.clone()
    want = bn_act_plain(y, bn, True, identity)
    launches = bn_act.launches
    with torch.no_grad():
        got = resnet.bn_eval_lowp(bn, y, True, identity, inplace=True)
    assert bn_act.launches == launches + 1
    assert got.is_contiguous(memory_format=CL)
    _same_bits(got, want)
    assert torch.equal(y.view(torch.int16), y0.view(torch.int16))


@pytest.mark.cuda
def test_router_raises_under_grad_on_the_card(dev):
    """The kernel has no gradient: with grad mode on and the BatchNorm's
    weights needing one, the card's route raises; under no_grad it runs."""
    bn = _bn(64, 7, dev)
    y = _map((1, 64, 4, 4), 7, dev)
    with pytest.raises(RuntimeError, match="no gradient"):
        resnet.bn_eval_lowp(bn, y, relu=True)
    with torch.no_grad():
        _same_bits(resnet.bn_eval_lowp(bn, y, relu=True), bn_act_plain(y, bn, True))


@pytest.mark.cuda
def test_resnet101_trunk_equal_through_both_routes(dev, monkeypatch):
    """A bf16 resnet101 trunk in eval mode: 104 ``bn_act`` launches a
    forward, one a BatchNorm, the output ``torch.equal`` to the same trunk
    with every BatchNorm forced onto the plain chain (no launch)."""
    torch.manual_seed(0)
    trunk = resnet.ResNetTrunk("resnet101").eval()
    _random_bn_(trunk, 1)
    trunk = trunk.to(dev)
    x = _map((4, 3, 224, 288), 2, dev, scale=1.0)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            kernels.reset_launch_counts()
            got = trunk(x)
            assert kernels.launch_counts()["bn_act"] == 104
            with monkeypatch.context() as m:
                m.setattr(resnet, "bn_eval_lowp",
                          lambda bn, y, relu=False, identity=None, inplace=False:
                          bn_act_plain(y, bn, relu, identity))
                want = trunk(x)
            assert kernels.launch_counts()["bn_act"] == 104
    finally:
        torch.backends.cudnn.deterministic = det
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert torch.equal(got, want)
