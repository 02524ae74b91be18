"""Inference BatchNorm + residual add + ReLU of a bf16 map in one pass: CUDA
kernel and its plain version.

The bf16 trunk rounds each convolution to bf16, then runs its inference
BatchNorm as flax computes it, ``(y - mean) * (rsqrt(var + eps) * scale) +
bias`` in f32 rounded once (:func:`bn_lowp`), then the residual add and the
ReLU in bf16 (:func:`bn_act_plain`, the chain op for op). On the card that
chain is five f32 passes over the map and two or three bf16 ones: the
kernel, ``csrc/bn_act.cu``, computes the same bits from one read of the
conv output (and of the identity) and one write, bound by those bytes. It
replaces no TPU kernel: XLA fuses the same operations there.

The per-channel ``mean``, ``mul = rsqrt(var + eps) * weight`` and ``bias``
are made once by the same torch ops :func:`bn_lowp` runs, so they carry the
same bits, and kept on the BatchNorm module until one of its four tensors is
written or moved (:func:`bn_params`). The kernel takes a bf16 CUDA map in
``channels_last`` memory with C a multiple of 8 and 16-byte aligned;
:func:`bn_act` raises on any other. Inference
only: nothing here is differentiable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build


def bn_lowp(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm of a bf16 map as flax computes it: in f32,
    ``(y - mean) * (rsqrt(var + eps) * scale) + bias``, rounded once."""
    shape = (1, -1, 1, 1)
    mul = (torch.rsqrt(bn.running_var + bn.eps) * bn.weight).reshape(shape)
    t = y.float()
    t.sub_(bn.running_mean.reshape(shape)).mul_(mul).add_(bn.bias.reshape(shape))
    return t.to(y.dtype)


def add_relu(out: torch.Tensor, relu: bool, identity: Optional[torch.Tensor]) -> torch.Tensor:
    """``out + identity`` where there is one, then ReLU in place where asked:
    what a ResNet block runs after its BatchNorm, in ``out``'s dtype."""
    if identity is not None:
        out = out + identity
    return torch.relu_(out) if relu else out


def bn_act_plain(y: torch.Tensor, bn: nn.BatchNorm2d, relu: bool = False,
                 identity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the kernel: :func:`bn_lowp`, then ``+ identity`` in
    bf16 and ``relu_``."""
    return add_relu(bn_lowp(bn, y), relu, identity)


def bn_params(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mean, mul, bias)``, contiguous f32 [C] on the module's device, with
    ``mul = rsqrt(running_var + eps) * weight`` as :func:`bn_lowp` computes
    it. Made once and kept on the module; made again only when one of the
    four tensors moves to another device or is written."""
    ts = (bn.running_mean, bn.running_var, bn.weight, bn.bias)
    key = (bn.eps, ts[0].device) + tuple((t.data_ptr(), t._version) for t in ts)
    cached = getattr(bn, "_bn_act_params", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
            params = tuple(t.detach().to(torch.float32, copy=True).contiguous()
                           for t in (bn.running_mean, mul, bn.bias))
        cached = (key, params)
        bn._bn_act_params = cached
    return cached[1]


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _check(y: torch.Tensor, identity: Optional[torch.Tensor]) -> None:
    """Raise unless the kernel takes this map (and identity): a bf16 [N, C,
    H, W] CUDA map in ``channels_last`` memory, C a multiple of 8, 16-byte
    aligned; an identity of the same shape, dtype, device and memory."""
    if y.dtype != torch.bfloat16:
        raise ValueError(f"bn_act: the map must be bfloat16, got {y.dtype}")
    if y.dim() != 4 or not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bn_act: the map must be a channels_last [N, C, H, W] tensor")
    if y.shape[1] % 8 != 0:
        raise ValueError(f"bn_act: the map's channels must be a multiple of 8, got {y.shape[1]}")
    if y.numel() // max(y.shape[1], 1) >= 2**31:
        raise ValueError("bn_act: the map must have fewer than 2**31 rows (N * H * W)")
    if y.device.type != "cuda":
        raise ValueError(f"bn_act: the kernel runs on a CUDA device, got {y.device}")
    if not _aligned(y):
        raise ValueError("bn_act: the map must be 16-byte aligned")
    if identity is not None and (
            identity.shape != y.shape or identity.dtype != y.dtype
            or identity.device != y.device
            or not identity.is_contiguous(memory_format=torch.channels_last)
            or not _aligned(identity)):
        raise ValueError("bn_act: the identity must be a map like the input, channels_last "
                         "and aligned")


def bn_act(y: torch.Tensor, bn: nn.BatchNorm2d, relu: bool = False,
           identity: Optional[torch.Tensor] = None, inplace: bool = False) -> torch.Tensor:
    """The kernel: :func:`bn_act_plain`'s bits in one pass. ``inplace``: the
    result is written over ``y`` (a map the caller owns and drops), else
    into a new ``channels_last`` map. Raises on a map the kernel does not
    take (:func:`_check`)."""
    _check(y, identity)
    mean, mul, bias = bn_params(bn)
    if mean.device != y.device or mean.numel() != y.shape[1]:
        raise ValueError("bn_act: the BatchNorm's tensors must be on the map's device, one a "
                         "channel")
    out = y if inplace else torch.empty_like(y, memory_format=torch.channels_last)
    N, C, H, W = y.shape
    lib = _build.load("bn_act")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.bn_act_forward(y.data_ptr(), None if identity is None else identity.data_ptr(),
                                 mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), N * H * W, C, int(relu), stream)
    _build.check(err, "bn_act_forward")
    bn_act.launches += 1
    return out


bn_act.launches = 0
