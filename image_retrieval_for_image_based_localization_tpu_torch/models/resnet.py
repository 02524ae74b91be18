"""ResNet trunks (18/34/50/101/152) as ``nn.Module``s, torchvision-named.

The JAX package's ``models/resnet.py`` builds the same graph (conv7x7/2 ->
bn -> relu -> maxpool3x3/2 -> layer1..4, stride 32, no avgpool/fc). Module
names follow torchvision, so a torchvision or cirtorch trunk ``state_dict``
loads with ``load_state_dict`` as it is. Weights are NCHW; activations run
in ``channels_last`` memory, so the [B, C, h, w] output permuted to
[B, h, w, C] is a free view, which is the [B, h*w, C] layout the head
kernel reads.

A bf16 input runs the trunk in bf16 with the parameters kept f32, with
the JAX package's rounding points (flax ``nn.Conv(dtype=bf16)`` and
``nn.BatchNorm(dtype=bf16)``): each convolution takes bf16 input and bf16
weights, sums in f32 and rounds to bf16 (:func:`conv_lowp`); BatchNorm
computes ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32 on that
output and rounds once (``ops.kernels.bn_act.bn_lowp``); ReLU, max-pool and
the residual add run in bf16. On the card an inference BatchNorm, the
residual add and the ReLU after it are one pass of the ``bn_act`` kernel,
which gives the same bits (:func:`bn_eval_lowp`). A float32 input takes the
f32 modules as they are.

In train mode (``module.train()``) BatchNorm has flax's semantics, not
``nn.BatchNorm2d``'s (:func:`bn_train`): it normalizes with the biased batch
variance and moves the running statistics by ``ra <- 0.9 ra + 0.1 batch``
with the biased variance too, where torch's own train mode stores the
unbiased one. Under :func:`global_batch_stats` (a train step whose data
group holds several processes) the statistics are the data group's global
batch's, summed in float64 so that they do not depend on how the batch is
split. A bf16 map trains at flax's rounding points: the statistics in f32,
the output rounded once, the running statistics f32; the bf16 weights are
cast in the graph, so the f32 master weights get the cast's gradient
(:func:`lowp_weight`).

Under :func:`remat` (``TrainConfig(remat=True)``) the trunks checkpoint
each segment (a ResNet block, a DenseNet dense block) with
``torch.utils.checkpoint``; the recompute in the backward takes the same
batch statistics and leaves the running statistics where the forward put
them (:func:`segment`).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.bn_act import (
    add_relu,
    bn_act,
    bn_act_plain,
)

# (block, layers-per-stage, expansion)
RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2), 1),
    "resnet34": ("basic", (3, 4, 6, 3), 1),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 4),
    "resnet101": ("bottleneck", (3, 4, 23, 3), 4),
    "resnet152": ("bottleneck", (3, 8, 36, 3), 4),
}


def lowp_weight(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``conv.weight`` in ``dtype`` (channels_last). In grad mode with a
    weight that requires grad (training) the cast sits in the graph, so the
    f32 weight gets the cast's gradient, as flax's ``promote_dtype`` gives
    it; otherwise (inference) it is cast once and kept on the module: made
    again only when the weight moves to another device or is written
    (``load_state_dict``), never on every forward."""
    w = conv.weight
    if torch.is_grad_enabled() and w.requires_grad:
        return w.to(dtype).contiguous(memory_format=torch.channels_last)
    key = (dtype, w.device, w.data_ptr(), w._version)
    cached = getattr(conv, "_lowp_weight", None)
    if cached is None or cached[0] != key:
        lp = w.detach().to(dtype).contiguous(memory_format=torch.channels_last)
        cached = (key, lp)
        conv._lowp_weight = cached
    return cached[1]


def conv_lowp(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The convolution (no bias) on a bf16 input: bf16 operands, f32 sums,
    rounded to bf16. On the card that is cuDNN's bf16 convolution (f32
    accumulation); on the CPU the f32 convolution of the same bf16 values,
    rounded once."""
    w = lowp_weight(conv, x.dtype)
    if x.is_cuda:
        return F.conv2d(x, w, None, conv.stride, conv.padding)
    return F.conv2d(x.float(), w.float(), None, conv.stride, conv.padding).to(x.dtype)


def bn_eval_lowp(bn: nn.BatchNorm2d, y: torch.Tensor, relu: bool = False,
                 identity: Optional[torch.Tensor] = None, inplace: bool = False) -> torch.Tensor:
    """Inference BatchNorm of a bf16 map (``bn_lowp``), then ``+
    identity`` in bf16 and ReLU where asked. On the CPU the plain chain; on
    the card one ``bn_act`` pass with the same bits, on ``channels_last``
    copies of a map or identity in another layout, written over ``y``
    where ``inplace`` (the caller owns it). The kernel has no gradient: on
    the card it raises where grad mode is on and a tensor needs one, and
    ``bn_act`` raises on any map it does not take."""
    if y.device.type != "cuda":
        return bn_act_plain(y, bn, relu, identity)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (y, identity, bn.weight, bn.bias)):
        raise RuntimeError("the bf16 trunk's inference BatchNorm has no gradient on the card: "
                           "run it under torch.no_grad() or in train mode")
    if not y.is_contiguous(memory_format=torch.channels_last):
        y, inplace = y.contiguous(memory_format=torch.channels_last), True  # a copy of its own
    if identity is not None:
        identity = identity.contiguous(memory_format=torch.channels_last)
    return bn_act(y, bn, relu, identity, inplace)


BN_MOMENTUM = 0.9  # flax's: the running statistics keep 0.9 of themselves
_STATS_GROUP = []  # the data group of the data-parallel step being run, if any
_REMAT = []        # non-empty within remat(): the trunks checkpoint their segments
_RECOMPUTING = []  # non-empty while a checkpointed segment re-runs in the backward
# train-mode BatchNorm calls since the last reset: those that moved the
# running statistics, and those of a checkpointed segment's re-run (which
# move nothing)
BN_TRAIN_COUNTS = {"moved": 0, "recomputed": 0}


@contextlib.contextmanager
def _pushed(stack: list, value=True):
    stack.append(value)
    try:
        yield
    finally:
        stack.pop()


def global_batch_stats(group):
    """Within the block (a train step whose data group holds several
    processes, or its one-process reference), train-mode BatchNorm
    takes its statistics over the global batch of ``group``'s processes
    (``parallel.mesh.Mesh.data_group``; None is the default group), through
    :class:`_BatchNormTrain`: its sums are all-reduced over the group in the
    forward and the backward, a no-op for a group of one process. Every
    process of the group must run the same layers in the same order."""
    return _pushed(_STATS_GROUP, group)


def remat():
    """Within the block (the train step of ``TrainConfig(remat=True)``, the
    JAX step's ``jax.checkpoint``), the trunks keep only each segment's input
    for the backward and run the segment again there (:func:`segment`)."""
    return _pushed(_REMAT)


def _remat_contexts():
    return contextlib.nullcontext(), _pushed(_RECOMPUTING)


def segment(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)``, a trunk segment (a ResNet block, a DenseNet dense block, a
    VGG stage). Under :func:`remat` in grad mode it runs through
    ``torch.utils.checkpoint`` (non-reentrant): the backward re-runs it on
    the same input, so its BatchNorms take the same batch statistics, while
    the re-run leaves the running statistics alone (:func:`_move_running`),
    as flax's functional ``jax.checkpoint`` returns them once. Gradients,
    loss and statistics are those of the step without remat, bit for bit
    wherever the re-run is deterministic."""
    if not (_REMAT and torch.is_grad_enabled()):
        return fn(x)
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, x, use_reentrant=False, context_fn=_remat_contexts,
                      preserve_rng_state=False)


def _channel_rows(t: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] as [N*H*W, C]: a view of a channels_last tensor."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    # here, not at the top: parallel/ imports the models through retrieval/
    from image_retrieval_for_image_based_localization_tpu_torch.parallel.distributed import (
        all_reduce_sum,
    )

    return all_reduce_sum(t, group)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm over a data group's global batch, whose
    statistics do not depend on how the batch is split: the per-channel sums
    of ``y`` and of ``y^2`` (each square rounded to f32 alone) accumulate in
    float64 and are all-reduced over the group, so each process's slice
    gives the mean and variance that one process gets from the whole batch
    on the same path, to the last bit but for a rare double rounding.
    ``F.batch_norm``'s own f32 reduction order cannot be split so, and a
    last-bit change of the statistics flips max-pool and ReLU near-ties: on
    the padded, blocky batches of the parity tests that moves resnet18's
    gradients by up to ~8e-2 of max|g| (from the float64 sums to
    ``F.batch_norm``'s). The float64 sums cost: every sum casts its input.

    Forward: ``mean = sum(y) / n``, ``var = max(sum(y^2) / n - mean^2, 0)``
    (biased; flax's fast variance, in float64), ``out = (y - mean) *
    (rsqrt(var + eps) * scale) + bias``; also returns the mean and the
    variance for the running statistics. A bf16 ``y`` is taken at flax's
    rounding points: its squares, the statistics and the output are computed
    in f32 and the output is rounded to bf16 once; the statistics stay f32.
    Backward: BatchNorm's gradient with
    the global sums of ``dout`` and ``dout * (y - mean)``; ``scale`` and
    ``bias`` get this process's share (the train step sums the shares).
    Autograd through the sums instead would cancel ``2 y dvar`` against
    ``2 mean dvar`` in f32, which on the masked parity batches of
    tests/test_torch_data_parallel.py put resnet18's gradients 8.1e-3 of
    max|g| from the float64 truth (2.9e-5 here)."""

    @staticmethod
    def forward(ctx, y, weight, bias, eps, group):
        C = y.shape[1]
        shape = (1, C, 1, 1)
        rows = _channel_rows(y)
        s = _sum_over(torch.cat([rows.sum(dim=0, dtype=torch.float64),
                                 torch.square(rows.float()).sum(dim=0, dtype=torch.float64),
                                 rows.new_full((1,), rows.shape[0], dtype=torch.float64)]),
                      group)
        n = s[2 * C]
        s = s[:2 * C] / n
        mean64 = s[:C]
        f32 = weight.dtype
        var = torch.addcmul(s[C:], mean64, mean64, value=-1.0).clamp_(min=0.0).to(f32)
        mean = mean64.to(f32)
        invstd = torch.rsqrt(var + eps)
        xmu = y - mean.reshape(shape)  # f32 for a bf16 y too
        ctx.save_for_backward(xmu, weight, invstd)
        ctx.n, ctx.group, ctx.in_dtype = n, group, y.dtype
        ctx.mark_non_differentiable(mean, var)
        # out= keeps y's memory format (channels_last): with the (1, C, 1, 1)
        # bias first, addcmul would return an NCHW tensor
        out = torch.addcmul(bias.reshape(shape), xmu, (invstd * weight).reshape(shape),
                            out=torch.empty_like(xmu))
        return out.to(y.dtype), mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        xmu, weight, invstd = ctx.saved_tensors
        C = xmu.shape[1]
        shape = (1, C, 1, 1)
        dout = dout.to(xmu.dtype)
        local = torch.cat([_channel_rows(dout).sum(dim=0, dtype=torch.float64),
                           _channel_rows(dout * xmu).sum(dim=0, dtype=torch.float64)])
        sums = (_sum_over(local, ctx.group) / ctx.n).to(xmu.dtype)
        k = invstd * weight
        # dx = (dout - mean(dout) - xmu * invstd^2 * mean(dout * xmu)) * invstd * scale
        dx = torch.addcmul((-sums[:C] * k).reshape(shape), dout, k.reshape(shape),
                           out=torch.empty_like(xmu))
        dx.addcmul_(xmu, (-invstd * invstd * sums[C:] * k).reshape(shape))
        dw = (local[C:] * invstd.double()).to(xmu.dtype)
        return dx.to(ctx.in_dtype), dw, local[:C].to(xmu.dtype), None, None


def _move_running(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
    BN_TRAIN_COUNTS["moved"] += 1


def bn_train(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm as flax's ``nn.BatchNorm(momentum=0.9)`` runs it:
    the output is normalized with the batch mean and the biased batch
    variance, and the running statistics move by ``ra <- 0.9 ra + 0.1 batch``
    with flax's fast variance ``mean(y^2) - mean(y)^2`` (biased, floored at
    0), outside the graph. A bf16 ``y`` takes its statistics in f32 and its
    output is rounded to bf16 once (flax's ``force_float32_reductions`` and
    ``_normalize``; torch's batch_norm on a bf16 input with f32 parameters
    computes so); the running statistics stay f32. Under
    :func:`global_batch_stats` (a data-parallel train step) the statistics
    are the data group's global batch's, as flax's are under ``jit`` over a
    batch sharded on ``data`` (:class:`_BatchNormTrain`). In a checkpointed
    segment's re-run (:func:`segment`) the running statistics stay where the
    forward moved them."""
    if _STATS_GROUP:
        out, mean, var = _BatchNormTrain.apply(y, bn.weight, bn.bias, bn.eps, _STATS_GROUP[-1])
    else:
        out = F.batch_norm(y, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
        mean = var = None
    if _RECOMPUTING:
        BN_TRAIN_COUNTS["recomputed"] += 1
        return out
    if mean is None:
        with torch.no_grad():
            t = y.float()
            mean = t.mean(dim=(0, 2, 3))
            var = torch.clamp(torch.square(t).mean(dim=(0, 2, 3)) - torch.square(mean), min=0.0)
    _move_running(bn, mean, var)
    return out


def conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor, relu: bool = False,
            identity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bn(conv(x))`` in the input's dtype (eval-mode statistics in bf16:
    :func:`bn_eval_lowp`), then ``+ identity`` and ReLU where asked; in
    train mode with flax's statistics (:func:`bn_train`), either dtype."""
    if x.dtype == torch.float32:
        y = conv(x)
        return add_relu(bn_train(bn, y) if bn.training else bn(y), relu, identity)
    y = conv_lowp(conv, x)
    if bn.training:
        return add_relu(bn_train(bn, y), relu, identity)
    return bn_eval_lowp(bn, y, relu, identity, inplace=True)


def _downsample(ds: Optional[nn.Sequential], x: torch.Tensor) -> torch.Tensor:
    return x if ds is None else conv_bn(ds[0], ds[1], x)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = _downsample(self.downsample, x)
        out = conv_bn(self.conv1, self.bn1, x, relu=True)
        return conv_bn(self.conv2, self.bn2, out, relu=True, identity=identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        # stride on the 3x3 conv (torchvision's ResNet v1.5)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        identity = _downsample(self.downsample, x)
        out = conv_bn(self.conv1, self.bn1, x, relu=True)
        out = conv_bn(self.conv2, self.bn2, out, relu=True)
        return conv_bn(self.conv3, self.bn3, out, relu=True, identity=identity)


class ResNetTrunk(nn.Module):
    """ResNet feature trunk: [B, 3, H, W] -> [B, C, H/32, W/32] (NCHW logical),
    in the input's dtype (float32 or bfloat16)."""

    def __init__(self, arch: str = "resnet50"):
        super().__init__()
        kind, stages, expansion = RESNET_SPECS[arch]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.arch = arch
        self.out_channels = 512 * expansion
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for i, (width, depth) in enumerate(zip((64, 128, 256, 512), stages)):
            stride = 1 if i == 0 else 2
            downsample = None
            if stride != 1 or inplanes != width * expansion:
                downsample = nn.Sequential(
                    nn.Conv2d(inplanes, width * expansion, 1, stride, bias=False),
                    nn.BatchNorm2d(width * expansion),
                )
            layers = [block(inplanes, width, stride, downsample)]
            inplanes = width * expansion
            layers += [block(inplanes, width) for _ in range(1, depth)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layers))

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool(conv_bn(self.conv1, self.bn1, x, relu=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = segment(self._stem, x)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = segment(block, x)
        return x
