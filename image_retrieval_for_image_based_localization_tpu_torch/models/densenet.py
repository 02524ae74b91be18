"""DenseNet trunks (121/169/201/161) as ``nn.Module``s, torchvision-named.

The JAX package's ``models/densenet.py``: torchvision's ``densenet*().features``
plus the final ReLU that the cirtorch lineage appends, at stride 32. A dense
layer is BN -> ReLU -> 1x1 -> BN -> ReLU -> 3x3, its output concatenated to
its input along the channels; a transition is BN -> ReLU -> 1x1 (half the
channels) -> 2x2 average pool. Modules sit at torchvision's attribute names
(``denseblock{i}.denselayer{j}.norm1``, ``transition{i}.conv``, ``norm5``),
so a torchvision or cirtorch trunk ``state_dict`` loads as it is (cirtorch's
numeric keys through ``models.flax_port.cirtorch_to_torchvision_keys``).

Float32 inference only: bf16 compute and train-mode BatchNorm stay with the
ResNet and VGG trunks (``utils.config.check_supported``,
``training.trainer.check_trainable``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

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


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth: int, bn_size: int = BN_SIZE):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(in_ch)
        self.conv1 = nn.Conv2d(in_ch, bn_size * growth, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(bn_size * growth)
        self.conv2 = nn.Conv2d(bn_size * growth, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        return torch.cat([x, h], dim=1)


class Transition(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(in_ch)
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNetTrunk(nn.Module):
    """DenseNet feature trunk: [B, 3, H, W] -> [B, C, H/32, W/32] (NCHW logical),
    float32."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.norm0(self.conv0(x))), 3, 2, 1)
        for bi in range(1, self.n_blocks + 1):
            for layer in getattr(self, f"denseblock{bi}").children():
                x = layer(x)
            if bi < self.n_blocks:
                x = getattr(self, f"transition{bi}")(x)
        return F.relu(self.norm5(x))  # cirtorch appends the final ReLU
