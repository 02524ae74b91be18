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
output and rounds once (:func:`bn_lowp`); ReLU, max-pool and the residual
add run in bf16. A float32 input takes the f32 modules as they are.

In train mode (``module.train()``, f32 only) BatchNorm has flax's
semantics, not ``nn.BatchNorm2d``'s (:func:`bn_train`): it normalizes with
the biased batch variance and moves the running statistics by
``ra <- 0.9 ra + 0.1 batch`` with the biased variance too, where torch's own
train mode stores the unbiased one. bf16 training raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# (block, layers-per-stage, expansion)
RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2), 1),
    "resnet34": ("basic", (3, 4, 6, 3), 1),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 4),
    "resnet101": ("bottleneck", (3, 4, 23, 3), 4),
    "resnet152": ("bottleneck", (3, 8, 36, 3), 4),
}


def lowp_weight(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``conv.weight`` in ``dtype`` (channels_last), cast once and kept on
    the module: made again only when the weight moves to another device or
    is written (``load_state_dict``), never on every forward."""
    w = conv.weight
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


def bn_lowp(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm of a bf16 map as flax computes it: in f32,
    ``(y - mean) * (rsqrt(var + eps) * scale) + bias``, rounded once."""
    shape = (1, -1, 1, 1)
    mul = (torch.rsqrt(bn.running_var + bn.eps) * bn.weight).reshape(shape)
    t = y.float()
    t.sub_(bn.running_mean.reshape(shape)).mul_(mul).add_(bn.bias.reshape(shape))
    return t.to(y.dtype)


BN_MOMENTUM = 0.9  # flax's: the running statistics keep 0.9 of themselves


def bn_train(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm as flax's ``nn.BatchNorm(momentum=0.9)`` runs it:
    the output is normalized with the batch mean and the biased batch
    variance, and the running statistics move by ``ra <- 0.9 ra + 0.1 batch``
    with flax's fast variance ``mean(y^2) - mean(y)^2`` (biased, floored at
    0), outside the graph."""
    out = F.batch_norm(y, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
    with torch.no_grad():
        mean = y.mean(dim=(0, 2, 3))
        var = torch.clamp(torch.square(y).mean(dim=(0, 2, 3)) - torch.square(mean), min=0.0)
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
    return out


def conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """``bn(conv(x))`` in the input's dtype (eval-mode statistics in bf16);
    in train mode with flax's statistics (:func:`bn_train`)."""
    if x.dtype == torch.float32:
        return bn_train(bn, conv(x)) if bn.training else bn(conv(x))
    if bn.training:
        raise NotImplementedError(
            "bf16 training is not supported: train-mode BatchNorm runs in float32 only "
            "(ROADMAP C3, bf16 training)")
    return bn_lowp(bn, conv_lowp(conv, x))


def _downsample(ds: Optional[nn.Sequential], x: torch.Tensor) -> torch.Tensor:
    return x if ds is None else conv_bn(ds[0], ds[1], x)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = _downsample(self.downsample, x)
        out = self.relu(conv_bn(self.conv1, self.bn1, x))
        out = conv_bn(self.conv2, self.bn2, out)
        return self.relu(out + identity)


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
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = _downsample(self.downsample, x)
        out = self.relu(conv_bn(self.conv1, self.bn1, x))
        out = self.relu(conv_bn(self.conv2, self.bn2, out))
        out = conv_bn(self.conv3, self.bn3, out)
        return self.relu(out + identity)


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
        self.relu = nn.ReLU(inplace=True)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(conv_bn(self.conv1, self.bn1, x)))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))
