"""bf16 training and remat against the JAX package: the bf16 train-mode
layers one at a time against ``jax.vjp`` of the flax layers (conv + BN,
DenseNet's BN, the biased conv of VGG/AlexNet/SqueezeNet), then one train
step each on the same weights and tuples as tests/test_torch_train_rest.py
(whose helpers these are): resnet18 + GeM at 64 px, 2 tuples x 3 images.

Tolerances, each with its reason:
  * the bf16 layers: the output within one bf16 ulp of its max|value| and
    at most 1 % of the values not bit-equal (measured over 20 seeds of
    these shapes: <= one ulp, <= 0.11 %: the two packages' f32 sums run in
    different orders, so a rare rounding flips); a conv's or BN's misplaced
    rounding moves a large share. Input and conv weight gradients (bf16
    values) within one ulp of max and 1 % not bit-equal where no BN lies
    below them, else within two ulps of max (measured <= 1.125, on 15-60 %
    of the values: flax's autodiff rounds BN's two input-gradient terms to
    bf16 apart and adds them in bf16, torch's fused backward rounds their
    sum once; a trial that rounded them apart, in a custom backward with
    float64 sums, matched the JAX gradient on the CPU to the bit but for
    <= 1.7 % rare flips, and slowed the bf16 train step on an H100 from
    ~109 ms to 212). BN scale
    and bias gradients 4e-6 and running statistics 1e-6 of each tensor's max
    for BN alone (f32 sums in another order; measured over 20 seeds <= 1.3e-6
    and 1.9e-7), 4e-4 and 4e-5 after a conv, whose rare output flips move a
    channel's statistics (measured over 20 seeds <= 1.4e-4 and 1.3e-5). The
    biased conv's bias gradient is the exact sum rounded once, where XLA's
    CPU backend sums the bf16 cotangent in bf16 (see the test);
  * the bf16 step against the JAX bf16 step (both f32 parameters, the trunk
    in bf16 at flax's rounding points): as far from the float64 truth as
    the JAX bf16 step lies from it, within a factor 1.5 either way (see the
    test);
  * remat against no remat in the port: bit for bit (the same operations on
    the same inputs, re-run on the CPU);
  * the remat step against the JAX remat step in float64:
    tests/test_torch_train_rest.py's bounds.
"""

import contextlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irtpu.models.densenet import _BN
from irtpu.models.resnet import _ConvBN

from image_retrieval_for_image_based_localization_tpu_torch.models import resnet as p_resnet
from image_retrieval_for_image_based_localization_tpu_torch.models.densenet import _bn
from image_retrieval_for_image_based_localization_tpu_torch.models.vgg import biased_conv
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    RetrievalNet,
)
from test_torch_train_rest import (
    LOSS_REL,
    _jax_reference,
    _port_step,
    _stats_close,
    _worst,
)
from torch_threads import parity_threads  # noqa: F401  (a module fixture: torch's threads)


def _bits(a):
    """bf16 values (as any float array) -> their 16-bit patterns as int."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).view(
        torch.int16).int().numpy()


def _bf16(a):
    """Round to bf16 (to nearest even), as float32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _nchw(a):
    """NHWC numpy -> NCHW torch in channels_last memory."""
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _assert_bf16_close(name, got, want, ulps=1, share=1e-2):
    """bf16 values: within ``ulps`` bf16 ulps of the tensor's max|want|, at
    most ``share`` of them not bit-equal."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want)
    assert err.max() <= ulps * ulp and (err > 0).mean() <= share, (
        name, float(err.max() / ulp), int((err > 0).sum()), err.size)


def _assert_rel(name, got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (name, float(err))


# (layer, kernel, stride, pad, global_batch_stats over a group of one)
LAYERS = [("conv_bn", 3, 1, 1, False), ("conv_bn", 1, 2, 0, False), ("conv_bn", 7, 2, 3, False),
          ("conv_bn", 3, 1, 1, True), ("conv_bn", 7, 2, 3, True), ("densenet_bn", 0, 0, 0, False),
          ("densenet_bn", 0, 0, 0, True), ("biased_conv", 3, 1, 1, False)]


@pytest.mark.parametrize("layer,k,stride,pad,grouped", LAYERS,
                         ids=[f"{l}{f'-k{k}s{s}' if k else ''}{'-group' if g else ''}"
                              for l, k, s, p, g in LAYERS])
def test_bf16_train_layer_matches_flax(layer, k, stride, pad, grouped):
    """One bf16 layer in train mode, forward and backward, against
    ``jax.vjp`` of the flax layer with ``dtype=bfloat16`` and f32 parameters
    on the same weights, input and output gradient: ``resnet.conv_bn`` (the
    weight cast in the graph by ``lowp_weight``, BN's batch statistics),
    ``densenet._bn`` and ``vgg.biased_conv``; BN alone and under
    ``global_batch_stats`` over a group of one (the data-parallel path)."""
    rs = np.random.RandomState(k + 10 * grouped)
    cin = 24
    cout = cin if layer == "densenet_bn" else 40
    x = rs.randn(2, 17, 19, cin).astype(np.float32)
    w = (rs.randn(k, k, cin, cout) * (2.0 / (max(k, 1) ** 2 * cin)) ** 0.5).astype(np.float32)
    scale = (rs.rand(cout) * 0.5 + 0.5).astype(np.float32)
    bias = (rs.randn(cout) * 0.1).astype(np.float32)
    mean = (rs.randn(cout) * 0.1).astype(np.float32)
    var = (rs.rand(cout) + 0.5).astype(np.float32)
    bn_p = {"scale": scale, "bias": bias}
    stats = {"bn": {"mean": mean, "var": var}}
    if layer == "conv_bn":
        mod, params = _ConvBN(cout, k, stride, pad, jnp.bfloat16), {"conv": {"kernel": w},
                                                                    "bn": bn_p}
    elif layer == "densenet_bn":
        mod, params = _BN(jnp.bfloat16), {"bn": bn_p}
    else:
        mod = nn.Conv(cout, (k, k), strides=(stride, stride), padding=((pad, pad), (pad, pad)),
                      use_bias=True, dtype=jnp.bfloat16)
        params, stats = {"kernel": w, "bias": bias}, None

    def flax_layer(xb, params):
        if stats is None:
            return mod.apply({"params": params}, xb), {}
        out, new = mod.apply({"params": params, "batch_stats": stats}, xb, train=True,
                             mutable=["batch_stats"])
        return out, new["batch_stats"]

    out, vjp, new_stats = jax.vjp(flax_layer, jnp.asarray(x, jnp.bfloat16), params,
                                  has_aux=True)
    dout = jnp.asarray(rs.randn(*out.shape).astype(np.float32), jnp.bfloat16)
    dx, dp = vjp(dout)
    dout = np.asarray(dout.astype(jnp.float32))

    conv = torch.nn.Conv2d(cin, cout, max(k, 1), stride or 1, pad, bias=layer == "biased_conv")
    bn = torch.nn.BatchNorm2d(cout).train()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1) if k else conv.weight)
        conv.bias is None or conv.bias.copy_(torch.from_numpy(bias))
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean),
                        ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
    tx = _nchw(x).to(torch.bfloat16).requires_grad_(True)
    with p_resnet.global_batch_stats(None) if grouped else contextlib.nullcontext():
        if layer == "conv_bn":
            got = p_resnet.conv_bn(conv, bn, tx)
        elif layer == "densenet_bn":
            got = _bn(bn, tx)
        else:
            got = biased_conv(conv, tx)
    got.backward(_nchw(dout).to(torch.bfloat16))
    assert got.dtype == tx.grad.dtype == torch.bfloat16
    _assert_bf16_close("out", _nhwc(got), out.astype(jnp.float32))
    # below a BN, flax's autodiff rounds the input gradient's two terms (through
    # ``x - mean`` and through the statistics) to bf16 apart and adds them in
    # bf16; torch's fused BN backward rounds their f32 sum once: up to ~60 %
    # of the values differ, each by at most about one ulp of a term
    grad_ulps, grad_share = (1, 1e-2) if layer == "biased_conv" else (2, 1.0)
    _assert_bf16_close("dx", _nhwc(tx.grad), dx.astype(jnp.float32), grad_ulps, grad_share)
    if layer != "densenet_bn":
        dw = dp["kernel"] if layer == "biased_conv" else dp["conv"]["kernel"]
        assert conv.weight.grad.dtype == torch.float32
        _assert_bf16_close("dw", conv.weight.grad.permute(2, 3, 1, 0).numpy(), dw, grad_ulps,
                           grad_share)
    if layer == "biased_conv":
        # XLA's CPU backend sums the bf16 cotangent into a bf16 accumulator, row
        # after row (the JAX gradient is that sequential sum, bit for bit); the
        # port sums in f32 and rounds once, whose error does not grow with the map
        rows = dout.reshape(-1, cout)
        seq = np.zeros(cout, np.float32)
        for r in rows:
            seq = _bf16(seq + r)
        np.testing.assert_array_equal(np.asarray(dp["bias"]), seq)
        np.testing.assert_array_equal(conv.bias.grad.numpy(),
                                      _bf16(rows.astype(np.float64).sum(0)))
        return
    # BN alone sees the same bf16 input on both sides; after a conv, each of
    # its outputs that rounds the other way moves a channel's statistics by an
    # ulp over the channel's count (after the 7x7 conv, 180 values a channel)
    grad_rel, stats_rel = (4e-6, 1e-6) if layer == "densenet_bn" else (4e-4, 4e-5)
    _assert_rel("dscale", bn.weight.grad.numpy(), dp["bn"]["scale"], grad_rel)
    _assert_rel("dbias", bn.bias.grad.numpy(), dp["bn"]["bias"], grad_rel)
    _assert_rel("running_mean", bn.running_mean.numpy(), new_stats["bn"]["mean"], stats_rel)
    _assert_rel("running_var", bn.running_var.numpy(), new_stats["bn"]["var"], stats_rel)
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32


def _rel_l2(got, want, names):
    """Each tensor's ||got - want|| / ||want||, averaged over the tensors."""
    return float(np.mean([np.linalg.norm(got[n] - want[n].numpy())
                          / max(float(np.linalg.norm(want[n].numpy())), 1e-30) for n in names]))


def _stats_rel(got, want):
    return max(float(np.abs(got[k].numpy() - w.numpy()).max() / np.abs(w.numpy()).max())
               for k, w in want.items() if k.endswith(("running_mean", "running_var")))


def test_bf16_step_matches_the_jax_bf16_step():
    """resnet18 + GeM, masked u8, the trunk in bf16 in both packages with
    f32 parameters. Every conv weight gets a gradient, and the parameters,
    their gradients and the optimizer state stay f32. A whole bf16 step is
    chaotic at its rounding noise: on this batch (descriptor cosines
    0.58-0.80) bf16 moves either package's gradients ~25 % (relative L2,
    averaged over the tensors) from the float64 truth, where the f32 steps
    lie ~1e-5 from it, and the two bf16 steps lie as far from each other; on
    batches of per-pixel noise or of smooth images the bf16 steps lie 30-34 %
    from the truth, and flipping the last bit of one pixel moves the port's
    bf16 gradients 24-25 %. So no batch lets a step tell two
    placements of the roundings apart, which test_bf16_train_layer_matches_flax
    pins layer by layer; here the two bf16 steps are two draws of that noise,
    and the port's is held to lie as far from the truth as the JAX bf16
    step's, within a factor 1.5 either way (gradients and running statistics
    alike; a step without bf16 roundings lies ~1e-5 from it and fails), and
    the losses within 1e-2 relative of each other (measured: 0.271 vs 0.255
    for the gradients, 1.09e-2 vs 1.02e-2 for the statistics, 1.3e-3
    between the losses)."""
    j16_loss, j16 = _jax_reference("resnet18", "gem", None, False, True, dtype="bfloat16")
    ref_loss, ref = _jax_reference("resnet18", "gem", None, False, True)
    state, loss = _port_step("resnet18", "gem", masked=True, use_kernel=True, dtype="bfloat16")
    named = dict(state.model.named_parameters())
    grads = {n: p.grad.numpy() for n, p in named.items()}
    port_err, jax_err = _rel_l2(grads, ref, named), _rel_l2({n: j16[n].numpy() for n in named},
                                                            ref, named)
    assert 1e-3 < jax_err and jax_err / 1.5 <= port_err <= 1.5 * jax_err, (port_err, jax_err)
    port_err, jax_err = _stats_rel(state.model.state_dict(), ref), _stats_rel(j16, ref)
    assert jax_err / 1.5 <= port_err <= 1.5 * jax_err, (port_err, jax_err)
    np.testing.assert_allclose(loss, j16_loss, rtol=1e-2)
    for n, p in named.items():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        if p.dim() == 4:
            assert float(p.grad.abs().max()) > 0, n
    for st in state.optimizer.state.values():
        assert all(v.dtype == torch.float32 for v in st.values() if torch.is_tensor(v)
                   and v.dim() > 0)
    assert all(b.dtype != torch.bfloat16 for b in state.model.buffers())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_equals_the_plain_step(dtype):
    """``remat=True`` re-runs each checkpointed segment in the backward: the
    loss, every gradient, the updated parameters and the running statistics
    are bit-equal to the step without it, and the running statistics moved
    once (each BatchNorm once in the forward; the re-runs are counted apart
    and move nothing)."""
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d)
               for m in RetrievalNet(arch="resnet18").modules())
    p_resnet.BN_TRAIN_COUNTS.update(moved=0, recomputed=0)
    plain, lp = _port_step("resnet18", "gem", dtype=dtype)
    assert p_resnet.BN_TRAIN_COUNTS == {"moved": n_bn, "recomputed": 0}
    p_resnet.BN_TRAIN_COUNTS.update(moved=0, recomputed=0)
    remat, lr = _port_step("resnet18", "gem", dtype=dtype, remat=True)
    assert p_resnet.BN_TRAIN_COUNTS["moved"] == n_bn
    assert 0 < p_resnet.BN_TRAIN_COUNTS["recomputed"] <= n_bn
    assert lp == lr
    for (n, a), b in zip(plain.model.named_parameters(), remat.model.parameters()):
        assert torch.equal(a.grad, b.grad) and torch.equal(a, b), n
    for (k, a), b in zip(plain.model.state_dict().items(), remat.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_remat_step_matches_the_jax_remat_step():
    """The port's remat step against the JAX trainer's loss function with
    ``remat=True`` (``jax.checkpoint`` of the forward) in float64."""
    want_loss, want = _jax_reference("resnet18", "gem", None, False, True, remat=True)
    state, loss = _port_step("resnet18", "gem", masked=True, remat=True)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_REL)
    worst, name = _worst(state, want)
    assert worst <= 1.0, (name, worst)
    assert _stats_close(state, want) > 0
