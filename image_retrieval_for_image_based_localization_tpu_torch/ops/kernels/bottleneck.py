"""Fused stride-1 identity ResNet bottleneck (inference): CUDA kernel, its
plain version, and the BatchNorm fold.

Replaces the JAX package's ``ops/pallas/bottleneck_block.py::bottleneck_fused``
(with ``fold_bn`` and ``bottleneck_oracle``). The kernel is
``csrc/bottleneck.cu`` on the mainloop ``csrc/tf32x3_gemm.cuh``: the three
BN-folded convolutions of a block run as implicit GEMMs over the whole
batch on the tensor cores, each f32 product taken as three TF32 products
(:func:`split_tf32` is the operand split written out) with f32 sums, so the
result stays within 1e-5 of max|out| of three f32 convolutions. The
intermediates ``y1`` and ``y2`` and the weights' split planes go through
device memory, in scratch the wrapper allocates (:func:`_plan`). Every
stride-1 identity block of resnet50/101/152 at every size goes through it.

Layouts are the JAX package's: x [B, H, W, Cin] NHWC, w1 [Cin, Cm], w2 [3,
3, Cm, Cm] (HWIO), w3 [Cm, Cin], biases f32. A wrapper given CPU tensors
runs the plain version; given CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build


def fold_bn(kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor,
            eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into the preceding conv (exact, f32).

    ``kernel`` has the output channels last (HWIO, or [Cin, Cout]); returns
    ``(W_folded, b_folded)`` with ``conv(x, W) * a + b' == conv(x, W_folded)
    + b_folded``, ``a = scale / sqrt(var + eps)``.
    """
    a = (scale / torch.sqrt(var + eps)).float()
    return kernel.float() * a, (bias - mean * a).float()


_BM, _BN = 128, 64   # pixels x channels of a block's tile, csrc/tf32x3_gemm.cuh


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's operand split: ``hi = tf32(t)``, ``lo = tf32(t - hi)``.

    ``tf32`` rounds an f32 to 10 mantissa bits, to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does (bit arithmetic on the int32
    view; the low 13 bits come out zero). ``hi + lo`` rebuilds ``t`` to
    2^-22 relative, and the kernel takes ``a * b`` as ``lo_a hi_b + hi_a
    lo_b + hi_a hi_b``.
    """
    def rna(v: torch.Tensor) -> torch.Tensor:
        u = v.contiguous().view(torch.int32)
        return ((u + 0x1000) & -0x2000).view(torch.float32)

    t = t.float()
    hi = rna(t)
    return hi, rna(t - hi)


def _plan(B: int, H: int, W: int, cin: int, cm: int) -> dict:
    """The kernel's scratch and grid, the same formula as ``csrc/bottleneck.cu``.

    Three phases, each a GEMM over ``M = B H W`` pixels: ``(N, K, blocks)``
    for conv1 (N = Cm, K = Cin), the 3x3 conv (N = Cm, K = 9 Cm) and conv1
    with the skip (N = Cin, K = Cm), a block owning 128 pixels by 64
    channels. Scratch: ``split_weights`` floats (each weight's hi and lo
    planes) and ``y1``, ``y2`` of shape ``scratch`` each.
    """
    M = B * H * W
    phases = tuple((n, k, -(-M // _BM) * -(-n // _BN))
                   for n, k in ((cm, cin), (cm, 9 * cm), (cin, cm)))
    return {"phases": phases, "split_weights": 2 * (2 * cin * cm + 9 * cm * cm),
            "scratch": (B, H, W, cm)}


def _check(x, w1, b1, w2, b2, w3, b3) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, Cin], got {tuple(x.shape)}")
    cin = x.shape[3]
    cm = w1.shape[1] if w1.dim() == 2 else -1
    want = {"w1": (cin, cm), "b1": (cm,), "w2": (3, 3, cm, cm), "b2": (cm,), "w3": (cm, cin),
            "b3": (cin,)}
    for name, t in zip(want, (w1, b1, w2, b2, w3, b3)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} for x {tuple(x.shape)}, "
                             f"got {tuple(t.shape)}")


def bottleneck_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: three f32 convolutions (cuDNN on the card, TF32
    off by the package's device rule) in channels_last memory."""
    _check(x, w1, b1, w2, b2, w3, b3)
    xc = x.float().permute(0, 3, 1, 2)                      # NHWC view as NCHW
    y = F.relu(F.conv2d(xc, w1.t()[:, :, None, None].float(), b1.float()))
    y = F.relu(F.conv2d(y, w2.permute(3, 2, 0, 1).float(), b2.float(), padding=1))
    y = F.conv2d(y, w3.t()[:, :, None, None].float(), b3.float())
    out = F.relu(y + xc)
    return out.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def bottleneck_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """``relu(c1x1(relu(c3x3(relu(c1x1(x) + b1)) + b2)) + b3 + x)``, BN folded.

    x: [B, H, W, Cin] f32; returns [B, H, W, Cin] f32 (a new tensor,
    contiguous NHWC). On the card Cin and Cm must be multiples of 32.
    """
    if x.device.type == "cpu":
        return bottleneck_plain(x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w1, b1, w2, b2, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2, w3, b3)):
        raise RuntimeError("the bottleneck kernel is inference-only (no backward)")
    params = (w1, b1, w2, b2, w3, b3)
    if x.dtype != torch.float32 or any(t.dtype != torch.float32 for t in params):
        raise TypeError("the bottleneck kernel takes float32 only")
    if any(t.device != x.device for t in params):
        raise ValueError("x and the weights must be on one device")
    if not (x.is_contiguous() and all(t.is_contiguous() for t in params)):
        raise ValueError("x (NHWC) and the weights must be contiguous")
    B, H, W, cin = x.shape
    cm = w1.shape[1]
    if cin % 32 or cm % 32:
        raise ValueError(f"Cin and Cm must be multiples of 32, got {cin} and {cm}")
    out = torch.empty_like(x)
    if B == 0 or H == 0 or W == 0:
        return out
    plan = _plan(B, H, W, cin, cm)
    wt = torch.empty(plan["split_weights"], dtype=torch.float32, device=x.device)
    y1 = torch.empty(plan["scratch"], dtype=torch.float32, device=x.device)
    y2 = torch.empty(plan["scratch"], dtype=torch.float32, device=x.device)
    lib = _build.load("bottleneck")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bottleneck_forward(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                     b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
                                     wt.data_ptr(), y1.data_ptr(), y2.data_ptr(),
                                     out.data_ptr(), B, H, W, cin, cm, stream)
    _build.check(err, "bottleneck_forward")
    bottleneck_fused.launches += 1
    return out


bottleneck_fused.launches = 0
