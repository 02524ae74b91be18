"""AlexNet trunk as an ``nn.Sequential`` with torchvision's layer indices.

The JAX package's ``models/alexnet.py``: torchvision's ``alexnet().features``
with the final max-pool stripped, as the cirtorch lineage does
(``features.children()[:-1]``): five biased convolutions with ReLU and two
3x3/2 max-pools without padding, 256 channels. The pools carry no padding,
so the map is not the input over a power of two (a 1,024-row input gives a
63-row map, not 64: ``H // h`` is 16). The convolutions sit at torchvision's indices
0, 3, 6, 8 and 10, so a torchvision or cirtorch ``features.N.weight/bias``
``state_dict`` loads as it is.

A bf16 input runs in bf16 with flax's rounding points, vgg16's rule
(``models.vgg.biased_conv``): each convolution rounds to bf16, the bias
cast to bf16 is added in bf16; ReLU and max-pool stay in bf16.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from image_retrieval_for_image_based_localization_tpu_torch.models.vgg import sequential_forward

# (out_ch, kernel, stride, pad) per conv; "M" is a 3x3/2 max-pool
ALEXNET_CFG = ((64, 11, 4, 2), "M", (192, 5, 1, 2), "M", (384, 3, 1, 1), (256, 3, 1, 1),
               (256, 3, 1, 1))


class AlexNetTrunk(nn.Sequential):
    """AlexNet feature trunk: [B, 3, H, W] -> [B, 256, h, w] (NCHW logical)."""

    out_channels = 256

    def __init__(self):
        layers = []
        in_ch = 3
        for v in ALEXNET_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(3, 2))
            else:
                ch, k, s, p = v
                layers += [nn.Conv2d(in_ch, ch, k, s, p), nn.ReLU(inplace=True)]
                in_ch = ch
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sequential_forward(self, x)
