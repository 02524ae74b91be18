"""DenseNet trunks (121/169/201/161) as ``nn.Module``s, torchvision-named.

The JAX package's ``models/densenet.py``: torchvision's ``densenet*().features``
plus the final ReLU that the cirtorch lineage appends, at stride 32. A dense
layer is BN -> ReLU -> 1x1 -> BN -> ReLU -> 3x3, its output concatenated to
its input along the channels; a transition is BN -> ReLU -> 1x1 (half the
channels) -> 2x2 average pool. Modules sit at torchvision's attribute names
(``denseblock{i}.denselayer{j}.norm1``, ``transition{i}.conv``, ``norm5``),
so a torchvision or cirtorch trunk ``state_dict`` loads as it is (cirtorch's
numeric keys through ``models.flax_port.cirtorch_to_torchvision_keys``).

A bf16 input runs in bf16 with flax's rounding points: each convolution
rounds to bf16 (``resnet.conv_lowp``), each BatchNorm computes in f32 and
rounds once (``ops.kernels.bn_act.bn_lowp``; in inference on the card one
``bn_act`` pass, ``resnet.bn_eval_lowp``), ReLU, max-pool and the concatenations run
in bf16, and a transition's 2x2 average pool sums its four values in bf16
in row-major order, rounding after each add, then divides by 4 in bf16, as
XLA reduces flax's ``avg_pool`` (:func:`avg_pool2x2_lowp`).

In train mode every BatchNorm (``norm0``, each dense layer's ``norm1`` and
``norm2``, each transition's ``norm``, ``norm5``) is flax's, as the JAX
package's ``_BN`` (momentum 0.9, eps 1e-5, the biased fast variance), in
either dtype (``resnet.bn_train``); under ``resnet.remat`` the stem and each
dense block with its transition are checkpointed segments.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (
    bn_eval_lowp,
    bn_train,
    conv_lowp,
    segment,
)

# (growth_rate, block_config, num_init_features)
DENSENET_SPECS = {
    "densenet121": (32, (6, 12, 24, 16), 64),
    "densenet169": (32, (6, 12, 32, 32), 64),
    "densenet201": (32, (6, 12, 48, 32), 64),
    "densenet161": (48, (6, 12, 36, 24), 96),
}
BN_SIZE = 4


def densenet_out_channels(arch: str) -> int:
    growth, blocks, init = DENSENET_SPECS[arch]
    ch = init
    for i, n in enumerate(blocks):
        ch += n * growth
        if i < len(blocks) - 1:
            ch //= 2
    return ch


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    if bn.training:
        return bn_train(bn, x)
    # the map may be a dense block's concatenation, read again later: never in place
    return bn(x) if x.dtype == torch.float32 else bn_eval_lowp(bn, x)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x) if x.dtype == torch.float32 else conv_lowp(conv, x)


def avg_pool2x2_lowp(x: torch.Tensor) -> torch.Tensor:
    """flax's ``avg_pool(x, (2, 2), strides=(2, 2))`` on a bf16 map as XLA
    reduces it: ``((x00 + x01) + x10) + x11`` in bf16 (each add rounded),
    then ``/ 4`` in bf16; an odd last row or column is dropped."""
    h, w = x.shape[2] // 2 * 2, x.shape[3] // 2 * 2
    x = x[:, :, :h, :w]
    s = x[:, :, 0::2, 0::2] + x[:, :, 0::2, 1::2]
    return ((s + x[:, :, 1::2, 0::2]) + x[:, :, 1::2, 1::2]) / 4


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth: int, bn_size: int = BN_SIZE):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(in_ch)
        self.conv1 = nn.Conv2d(in_ch, bn_size * growth, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(bn_size * growth)
        self.conv2 = nn.Conv2d(bn_size * growth, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv(self.conv1, F.relu(_bn(self.norm1, x)))
        h = _conv(self.conv2, F.relu(_bn(self.norm2, h)))
        return torch.cat([x, h], dim=1)


class Transition(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(in_ch)
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv(self.conv, F.relu(_bn(self.norm, x)))
        return F.avg_pool2d(x, 2, 2) if x.dtype == torch.float32 else avg_pool2x2_lowp(x)


class DenseNetTrunk(nn.Module):
    """DenseNet feature trunk: [B, 3, H, W] -> [B, C, H/32, W/32] (NCHW logical),
    in the input's dtype (float32 or bfloat16)."""

    def __init__(self, arch: str = "densenet121"):
        super().__init__()
        growth, blocks, init = DENSENET_SPECS[arch]
        self.arch = arch
        self.out_channels = densenet_out_channels(arch)
        self.conv0 = nn.Conv2d(3, init, 7, 2, 3, bias=False)
        self.norm0 = nn.BatchNorm2d(init)
        ch = init
        for bi, n_layers in enumerate(blocks):
            block = nn.Module()
            for li in range(n_layers):
                block.add_module(f"denselayer{li + 1}", DenseLayer(ch + li * growth, growth))
            self.add_module(f"denseblock{bi + 1}", block)
            ch += n_layers * growth
            if bi < len(blocks) - 1:
                self.add_module(f"transition{bi + 1}", Transition(ch, ch // 2))
                ch //= 2
        self.norm5 = nn.BatchNorm2d(ch)
        self.n_blocks = len(blocks)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(F.relu(_bn(self.norm0, _conv(self.conv0, x))), 3, 2, 1)

    def _stage(self, bi: int, x: torch.Tensor) -> torch.Tensor:
        """Dense block ``bi`` and the transition after it (``norm5`` and the
        final ReLU after the last)."""
        for layer in getattr(self, f"denseblock{bi}").children():
            x = layer(x)
        if bi < self.n_blocks:
            return getattr(self, f"transition{bi}")(x)
        return F.relu(_bn(self.norm5, x))  # cirtorch appends the final ReLU

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = segment(self._stem, x)
        for bi in range(1, self.n_blocks + 1):
            x = segment(functools.partial(self._stage, bi), x)
        return x
