"""VGG-16 trunk as an ``nn.Sequential`` with torchvision's layer indices.

The JAX package's ``models/vgg.py``: torchvision's cfg "D" (13 biased 3x3
convs with ReLU, no BN) with the final max-pool stripped, as the cirtorch
lineage does (``features.children()[:-1]``), so the trunk has stride 16 and
512 channels. The layers sit at torchvision's indices 0-29, so a torchvision
or cirtorch ``features.N.weight/bias`` ``state_dict`` loads as it is.
``last_relu=False`` (``RetrievalNet(netvlad_prel2=True)``) drops the ReLU
after conv5_3 (index 29), so the trunk ends at conv5_3's signed output, as
NetVLAD's ``conv5_3`` models and hloc cut it; every conv keeps its index, so
the same ``state_dict`` loads either way.

A bf16 input runs in bf16 as flax's ``nn.Conv(dtype=bf16)`` does: the
convolution rounds to bf16 (``resnet.conv_lowp``), then the bias, cast to
bf16, is added in bf16; ReLU and max-pool stay in bf16. In grad mode both
casts sit in the graph, so the f32 weights and biases train in either dtype.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn

from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (
    conv_lowp,
    segment,
)

# torchvision vgg16 cfg "D": numbers are conv widths, "M" is 2x2 maxpool
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)


class VGGTrunk(nn.Sequential):
    """VGG-16 feature trunk: [B, 3, H, W] -> [B, 512, H/16, W/16] (NCHW logical);
    ``last_relu=False`` leaves out the final ReLU (``features.29``)."""

    out_channels = 512

    def __init__(self, last_relu: bool = True):
        layers = []
        in_ch = 3
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_ch, v, 3, padding=1), nn.ReLU(inplace=True)]
                in_ch = v
        if not last_relu:
            layers.pop()
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sequential_forward(self, x)


def biased_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` in x's dtype; on a bf16 map as flax's ``nn.Conv(dtype=bf16)``
    runs it: the convolution rounded to bf16 (``resnet.conv_lowp``), then the
    bias, cast to bf16, added in bf16."""
    if x.dtype == torch.float32:
        return conv(x)
    return conv_lowp(conv, x) + conv.bias.to(x.dtype).reshape(1, -1, 1, 1)


def _run(layers, x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        x = biased_conv(layer, x) if isinstance(layer, nn.Conv2d) else layer(x)
    return x


def sequential_forward(layers: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A sequence of biased convolutions, ReLUs and max-pools in x's dtype,
    run as stages that each end at a max-pool (the checkpointed segments of
    ``resnet.remat``)."""
    stage = []
    for layer in layers:
        stage.append(layer)
        if isinstance(layer, nn.MaxPool2d):
            x = segment(functools.partial(_run, stage), x)
            stage = []
    return segment(functools.partial(_run, stage), x) if stage else x


def conv_indices():
    """torchvision ``features.N`` index of each conv, in order (JAX ``conv{i}``)."""
    out, idx = [], 0
    for v in VGG16_CFG:
        if v == "M":
            idx += 1
        else:
            out.append(idx)
            idx += 2
    return out
