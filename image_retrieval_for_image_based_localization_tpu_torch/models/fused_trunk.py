"""Inference-fused ResNet bottleneck trunk (BatchNorm folded), the
counterpart of the JAX package's ``models/fused_trunk.py``.

:func:`fold_trunk` folds every conv + BN pair of the port's own
``ResNetTrunk`` once, in f32 (eps 1e-5). :func:`trunk_apply_fused` runs the
stem, the max-pool and each stage's strided/projecting first block as
BN-folded convolutions, and every other (stride-1, identity) block through
the hand-written fused bottleneck kernel (``ops.kernels.bottleneck``), which
takes every such block of resnet50/101/152 at every size. Inference only;
basic-block archs (resnet18/34) are refused.

A bf16 input runs the trunk in bf16 at the JAX fused trunk's rounding
points: every convolution outside the kernel is the f32 convolution of
bf16 values (weights rounded to bf16) with the f32 bias added before one
rounding (the JAX ``_conv``: ``preferred_element_type=float32``, then the
bias), on the card and on the CPU alike (cuDNN's own bf16 convolution would
round before the bias; on the card these take TF32 tensor cores, exact for
bf16 operands); the stem and the first blocks' convolutions then
ReLU and round, and a first block adds its rounded ``cb3`` to its rounded
identity in bf16 before its ReLU. The kernel's blocks add the skip in f32
before their one rounding. The bf16 copies of the weights are made once
and kept in the folded dict.
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
    pack_bf16,
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


@torch.no_grad()
def _bf16_weights(folded: Dict[str, Any]) -> Dict[str, Any]:
    """The folded weights of the bf16 trunk, made at first use and kept in
    ``folded["_bf16"]``: the convolutions' weights rounded to bf16 and held
    in f32 (biases f32), the kernel blocks' packed for the bf16 kernel
    (``pack_bf16``) where they lie on the card (else None)."""
    if "_bf16" not in folded:
        def rounded(wb):
            return wb[0].to(torch.bfloat16).float(), wb[1]

        lp: Dict[str, Any] = {"stem": rounded(folded["stem"])}
        for key, entry in folded.items():
            if not key.startswith("layer"):
                continue
            if "w1" in entry:
                lp[key] = (pack_bf16(entry["w1"], entry["w2"], entry["w3"])
                           if entry["w1"].is_cuda else None)
            else:
                lp[key] = {k: rounded(v) for k, v in entry.items()}
        folded["_bf16"] = lp
    return folded["_bf16"]


def _conv(x: torch.Tensor, wb, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """The JAX fused trunk's ``_conv``: the f32 convolution of x's values and
    the weights (bf16-rounded for a bf16 x), plus the f32 bias; f32.

    On a bf16 x cuDNN may take TF32 tensor cores: bf16 values are exact in
    TF32, so the products are the f32 products and only the order of the f32
    sums differs. An f32 x keeps the package's rule, TF32 off."""
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = x.dtype == torch.bfloat16
    try:
        return F.conv2d(x.float(), wb[0], wb[1], stride=stride, padding=padding)
    finally:
        torch.backends.cudnn.allow_tf32 = allow


def _first_block(x: torch.Tensor, entry: Dict, stride: int) -> torch.Tensor:
    """A stage's strided/projecting first bottleneck as folded cuDNN convs,
    rounded to x's dtype where the JAX fused trunk rounds."""
    dt = x.dtype
    y = F.relu(_conv(x, entry["cb1"])).to(dt)
    y = F.relu(_conv(y, entry["cb2"], stride, 1)).to(dt)
    y = _conv(y, entry["cb3"]).to(dt)
    return F.relu(y + _conv(x, entry["down"], stride).to(dt))  # in bf16, a bf16 add


def trunk_apply_fused(folded: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Run the folded trunk on NHWC pixels [B, H, W, 3] -> NHWC features
    [B, h, w, C] (contiguous), in x's dtype (float32 or bfloat16). Every
    stride-1 identity block goes through ``bottleneck_fused``."""
    _, stages, _ = RESNET_SPECS[folded["_arch"]]
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the fused trunk runs float32 or bfloat16, not {dt}")
    w = folded if dt == torch.float32 else _bf16_weights(folded)
    y = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    y = F.relu(_conv(y, w["stem"], 2, 3)).to(dt)
    y = F.max_pool2d(y, 3, 2, 1)  # pads with -inf
    for si, depth in enumerate(stages):
        for bi in range(depth):
            key = f"layer{si + 1}_{bi}"
            if bi == 0:
                y = _first_block(y, w[key], 2 if si > 0 else 1)
            else:
                entry = folded[key]
                nhwc = y.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
                y = bottleneck_fused(nhwc, entry["w1"], entry["b1"], entry["w2"], entry["b2"],
                                     entry["w3"], entry["b3"],
                                     packed=None if w is folded else w[key]).permute(0, 3, 1, 2)
    return y.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
