"""ResNet trunks (18/34/50/101/152) as ``nn.Module``s, torchvision-named.

The JAX package's ``models/resnet.py`` builds the same graph (conv7x7/2 ->
bn -> relu -> maxpool3x3/2 -> layer1..4, stride 32, no avgpool/fc). Module
names follow torchvision, so a torchvision or cirtorch trunk ``state_dict``
loads with ``load_state_dict`` as it is. Weights are NCHW; activations run
in ``channels_last`` memory, so the [B, C, h, w] output permuted to
[B, h, w, C] is a free view, which is the [B, h*w, C] layout the head
kernel reads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

# (block, layers-per-stage, expansion)
RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2), 1),
    "resnet34": ("basic", (3, 4, 6, 3), 1),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 4),
    "resnet101": ("bottleneck", (3, 4, 23, 3), 4),
    "resnet152": ("bottleneck", (3, 8, 36, 3), 4),
}


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
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
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
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNetTrunk(nn.Module):
    """ResNet feature trunk: [B, 3, H, W] -> [B, C, H/32, W/32] (NCHW logical)."""

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
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))
