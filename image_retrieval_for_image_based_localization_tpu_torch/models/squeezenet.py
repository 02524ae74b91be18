"""SqueezeNet 1.1 trunk as an ``nn.Sequential`` with torchvision's indices.

The JAX package's ``models/squeezenet.py``: torchvision's
``squeezenet1_1().features`` (the cirtorch lineage keeps all of it), 512
channels. A fire module is a 1x1 squeeze with ReLU, then a 1x1 and a 3x3
expand, each with ReLU, concatenated along the channels. The three max-pools
are 3x3/2 in ceil mode, as torchvision's (the JAX package pads one row or
column of -inf where ``dim - 3`` is odd, which is the same). The fire modules
sit at torchvision's indices 3, 4, 6, 7, 9-12 with its names
(``squeeze``, ``expand1x1``, ``expand3x3``), so a torchvision or cirtorch
``state_dict`` loads as it is.

A bf16 input runs in bf16 with flax's rounding points: each biased
convolution follows vgg16's rule (``models.vgg.biased_conv``: rounded,
then the bf16 bias added in bf16), ReLU, max-pool and the fire modules'
concatenation (exact) stay in bf16.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from image_retrieval_for_image_based_localization_tpu_torch.models.vgg import (
    biased_conv,
    sequential_forward,
)

# squeezenet1_1 fire parameters: (squeeze, expand1x1, expand3x3)
FIRES = ((16, 64, 64), (16, 64, 64), (32, 128, 128), (32, 128, 128),
         (48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256))
POOL_AFTER = (1, 3)  # a max-pool follows these fire modules (0-indexed)


class Fire(nn.Module):
    def __init__(self, in_ch: int, squeeze: int, expand1: int, expand3: int):
        super().__init__()
        self.squeeze = nn.Conv2d(in_ch, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand1, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(biased_conv(self.squeeze, x))
        return torch.cat([F.relu(biased_conv(self.expand1x1, s)),
                          F.relu(biased_conv(self.expand3x3, s))], dim=1)


class SqueezeNetTrunk(nn.Sequential):
    """SqueezeNet 1.1 feature trunk: [B, 3, H, W] -> [B, 512, h, w] (NCHW logical)."""

    out_channels = 512

    def __init__(self):
        layers = [nn.Conv2d(3, 64, 3, 2), nn.ReLU(inplace=True),
                  nn.MaxPool2d(3, 2, ceil_mode=True)]
        in_ch = 64
        for i, (sq, e1, e3) in enumerate(FIRES):
            layers.append(Fire(in_ch, sq, e1, e3))
            in_ch = e1 + e3
            if i in POOL_AFTER:
                layers.append(nn.MaxPool2d(3, 2, ceil_mode=True))
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sequential_forward(self, x)


def fire_indices():
    """torchvision ``features.N`` index of each fire module, in order (JAX ``fire{i}``)."""
    out, idx = [], 3
    for i in range(len(FIRES)):
        out.append(idx)
        idx += 2 if i in POOL_AFTER else 1
    return out
