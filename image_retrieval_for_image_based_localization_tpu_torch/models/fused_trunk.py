"""Inference-fused ResNet bottleneck trunk (BatchNorm folded), the
counterpart of the JAX package's ``models/fused_trunk.py``.

:func:`fold_trunk` folds every conv + BN pair of the port's own
``ResNetTrunk`` once, in f32 (eps 1e-5). :func:`trunk_apply_fused` runs the
stem, the max-pool and each stage's strided/projecting first block as
BN-folded cuDNN convolutions, and every other (stride-1, identity) block
through the hand-written fused bottleneck kernel (``ops.kernels.bottleneck``),
which takes every such block of resnet50/101/152 at every size. Inference
only; basic-block archs (resnet18/34) are refused.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (
    RESNET_SPECS,
    ResNetTrunk,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.bottleneck import (
    bottleneck_fused,
    fold_bn,
)

BN_EPS = 1e-5


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W_folded [kh, kw, Cin, Cout] HWIO, b_folded [Cout]) of one conv + BN."""
    return fold_bn(conv.weight.detach().permute(2, 3, 1, 0), bn.weight.detach(),
                   bn.bias.detach(), bn.running_mean, bn.running_var, BN_EPS)


def _oihw(fb: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    w, b = fb
    return w.permute(3, 2, 0, 1).contiguous(), b.contiguous()


@torch.no_grad()
def fold_trunk(trunk: ResNetTrunk) -> Dict[str, Any]:
    """Fold the trunk's conv + BN pairs once (f32, on the trunk's device).

    Returns a dict keyed like the JAX package's folded tree: ``stem`` and
    ``layer{s}_{b}`` entries. Convs that cuDNN runs keep OIHW weights
    (``cb1``, ``cb2``, ``cb3``, ``down`` of each first block); the kernel's
    blocks hold ``w1 [Cin, Cm]``, ``w2 [3, 3, Cm, Cm]``, ``w3 [Cm, Cin]``.
    """
    kind, stages, _ = RESNET_SPECS[trunk.arch]
    if kind != "bottleneck":
        raise ValueError(f"fused trunk supports bottleneck resnets only, not {trunk.arch}")
    if trunk.training:
        raise RuntimeError("the fused trunk is inference-only: BN folds its running "
                           "statistics, so training with fuse_blocks is not supported "
                           "(call .eval() first)")
    folded: Dict[str, Any] = {"_arch": trunk.arch, "stem": _oihw(_fold(trunk.conv1, trunk.bn1))}
    for si, depth in enumerate(stages):
        layer = getattr(trunk, f"layer{si + 1}")
        for bi in range(depth):
            blk = layer[bi]
            cbs = [_fold(getattr(blk, f"conv{i}"), getattr(blk, f"bn{i}")) for i in (1, 2, 3)]
            if bi == 0:
                entry = {f"cb{i + 1}": _oihw(cb) for i, cb in enumerate(cbs)}
                entry["down"] = _oihw(_fold(blk.downsample[0], blk.downsample[1]))
            else:
                (w1, b1), (w2, b2), (w3, b3) = cbs
                entry = {"w1": w1[0, 0].contiguous(), "b1": b1, "w2": w2.contiguous(), "b2": b2,
                         "w3": w3[0, 0].contiguous(), "b3": b3}
            folded[f"layer{si + 1}_{bi}"] = entry
    return folded


def _first_block(x: torch.Tensor, entry: Dict, stride: int) -> torch.Tensor:
    """A stage's strided/projecting first bottleneck as folded cuDNN convs."""
    y = F.relu(F.conv2d(x, *entry["cb1"]))
    y = F.relu(F.conv2d(y, *entry["cb2"], stride=stride, padding=1))
    y = F.conv2d(y, *entry["cb3"])
    return F.relu(y + F.conv2d(x, *entry["down"], stride=stride))


def trunk_apply_fused(folded: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Run the folded trunk on NHWC pixels [B, H, W, 3] -> NHWC features
    [B, h, w, C] (contiguous). Every stride-1 identity block goes through
    ``bottleneck_fused``."""
    _, stages, _ = RESNET_SPECS[folded["_arch"]]
    y = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    y = F.relu(F.conv2d(y, *folded["stem"], stride=2, padding=3))
    y = F.max_pool2d(y, 3, 2, 1)  # pads with -inf
    for si, depth in enumerate(stages):
        for bi in range(depth):
            entry = folded[f"layer{si + 1}_{bi}"]
            if bi == 0:
                y = _first_block(y, entry, 2 if si > 0 else 1)
            else:
                nhwc = y.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
                y = bottleneck_fused(nhwc, entry["w1"], entry["b1"], entry["w2"], entry["b2"],
                                     entry["w3"], entry["b3"]).permute(0, 3, 1, 2)
    return y.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
