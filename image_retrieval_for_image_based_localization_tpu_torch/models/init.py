"""Random weights from an explicit ``torch.Generator``, for runs without a
checkpoint. Every parameter and BN statistic is drawn from the generator
(none keeps PyTorch's global-RNG default init), so two runs with the same
seed build bit-identical models."""

from __future__ import annotations

import torch
import torch.nn as nn

from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import NetVLAD


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill weights from ``generator``: He-normal convs with small random
    biases, random BN affine and running statistics, ``1/sqrt(fan_in)``
    Linear weights, and NetVLAD as the JAX package initializes it
    (centroids ~ N(0, 1), assignment conv ~ N(0, 1/C) like ``lecun_normal``,
    zero bias)."""
    g = generator
    netvlad_convs = set()
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, NetVLAD):
                K, C = m.centroids.shape
                m.centroids.copy_(torch.randn((K, C), generator=g))
                m.conv.weight.copy_(torch.randn(m.conv.weight.shape, generator=g) / C ** 0.5)
                m.conv.bias.zero_()
                netvlad_convs.add(m.conv)
            elif isinstance(m, nn.Conv2d) and m not in netvlad_convs:
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.01)
            elif isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=g) * 0.5 + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
            elif isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / m.in_features ** 0.5)
                m.bias.zero_()
    return module
