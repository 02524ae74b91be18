"""Fused stride-1 identity ResNet bottleneck (inference): CUDA kernels, their
plain version, and the BatchNorm fold.

Replaces the JAX package's ``ops/pallas/bottleneck_block.py::bottleneck_fused``
(with ``fold_bn`` and ``bottleneck_oracle``), in its two forms:

- float32: ``csrc/bottleneck.cu`` on the mainloop ``csrc/tf32x3_gemm.cuh``.
  The three BN-folded convolutions of a block run as implicit GEMMs over the
  whole batch on the tensor cores, each f32 product taken as three TF32
  products (:func:`split_tf32` is the operand split written out) with f32
  sums, so the result stays within 1e-5 of max|out| of three f32
  convolutions.
- bfloat16 (:func:`bottleneck_fused_bf16`, which :func:`bottleneck_fused`
  calls on a bf16 x): ``csrc/bottleneck_bf16.cu`` on ``csrc/bf16_gemm.cuh``, the same
  three GEMMs with bf16 operands and f32 sums, rounded where the JAX kernel
  rounds (``y1``, ``y2`` and the output, round to nearest even; the skip is
  added in f32 before the last rounding), on a warp-specialised ``wgmma``
  mainloop fed by TMA, with its own tiles (:func:`_plan`). Its weights come
  cast to bf16 and transposed to the kernel's [N, K] by :func:`pack_bf16`,
  once per folded trunk.

The intermediates ``y1`` and ``y2`` (in x's dtype) and the f32 form's
split planes go through device memory, in scratch the wrapper allocates
(:func:`_plan`). Every stride-1 identity block of resnet50/101/152 at every
size goes through them.

Layouts are the JAX package's: x [B, H, W, Cin] NHWC, w1 [Cin, Cm], w2 [3,
3, Cm, Cm] (HWIO), w3 [Cm, Cin], biases f32. A wrapper given CPU tensors
runs the plain version; given CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
# the bf16 mainloop's constants, csrc/bf16_gemm.cuh: 128 x 128 tiles where
# N > 64, else 256 x 64; stages 64 deep where Cin and Cm allow, else 32; a
# ring of at most _BF16_MAX_STAGES stages in _BF16_PIPE_BYTES, beside two
# epilogue buffers of a bf16 tile, 1,024 bytes of alignment slack and two
# mbarriers a stage and a buffer
_BF16_WIDE, _BF16_NARROW = (128, 128), (256, 64)   # (BM, BN)
_BF16_DEEP_BK, _BF16_SHALLOW_BK = 64, 32
_BF16_PIPE_BYTES, _BF16_MAX_STAGES, _BF16_EPI_BUFFERS, _BF16_SLACK = 163840, 8, 2, 1024


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


def _bf16_tile(n: int, bk: int) -> dict:
    """The bf16 kernel's tile for a phase with ``n`` output channels at stage
    depth ``bk``: rows, columns, ring stages and dynamic shared bytes."""
    bm, bn = _BF16_WIDE if n > _BF16_NARROW[1] else _BF16_NARROW
    stage_bytes = (bm + bn) * 2 * bk
    stages = min(_BF16_MAX_STAGES, _BF16_PIPE_BYTES // stage_bytes)
    smem = (_BF16_SLACK + stages * stage_bytes + _BF16_EPI_BUFFERS * bm * bn * 2
            + 8 * 2 * (stages + _BF16_EPI_BUFFERS))
    return {"bm": bm, "bn": bn, "stages": stages, "smem": smem}


def _plan(B: int, H: int, W: int, cin: int, cm: int,
          dtype: torch.dtype = torch.float32, sms: int = 132) -> dict:
    """The kernel's scratch and grid, the same formula as ``csrc/bottleneck.cu``
    and ``csrc/bottleneck_bf16.cu``.

    Three phases, each a GEMM over ``M = B H W`` pixels: conv1 (N = Cm, K =
    Cin), the 3x3 conv (N = Cm, K = 9 Cm) and conv1 with the skip (N = Cin,
    K = Cm). Scratch: ``y1``, ``y2`` of shape ``scratch`` each, in ``dtype``.

    float32: ``phases`` holds ``(N, K, blocks)``, a block owning 128 pixels by
    64 channels; ``split_weights`` floats hold each weight's hi and lo planes.

    bfloat16 (``plan_phase`` and ``stage_depth`` in the C source):
    ``bk`` is the stage depth, 64 where Cin and Cm are multiples of 64, else
    32 (a stage never crosses a 3x3 tap); ``phases`` holds, per phase, a dict
    of ``n``, ``k``, the tile (``bm`` x ``bn``: 128 x 128 where N > 64, else
    256 x 64), ring ``stages``, dynamic shared bytes ``smem``, output
    ``tiles`` and the persistent grid's ``blocks`` (one an SM of ``sms``, at
    most one a tile). No weight split: its weights come packed.
    """
    M = B * H * W
    dims = ((cm, cin), (cm, 9 * cm), (cin, cm))
    if dtype == torch.float32:
        return {"phases": tuple((n, k, -(-M // _BM) * -(-n // _BN)) for n, k in dims),
                "split_weights": 2 * (2 * cin * cm + 9 * cm * cm),
                "scratch": (B, H, W, cm), "scratch_dtype": dtype}
    deep = cin % _BF16_DEEP_BK == 0 and cm % _BF16_DEEP_BK == 0
    bk = _BF16_DEEP_BK if deep else _BF16_SHALLOW_BK
    phases = []
    for n, k in dims:
        t = _bf16_tile(n, bk)
        tiles = -(-M // t["bm"]) * -(-n // t["bn"])
        phases.append(dict(n=n, k=k, **t, tiles=tiles, blocks=min(tiles, sms)))
    return {"phases": tuple(phases), "bk": bk, "split_weights": 0,
            "scratch": (B, H, W, cm), "scratch_dtype": dtype}


class PackedBF16(NamedTuple):
    """A block's weights as the bf16 kernel reads them: bf16, [N, K]
    row-major (K contiguous), which is wgmma's K-major B."""

    w1t: torch.Tensor  # [Cm, Cin]
    w2t: torch.Tensor  # [Cm, 9 Cm], K tap-major as w2's HWIO layout
    w3t: torch.Tensor  # [Cin, Cm]


def pack_bf16(w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor) -> PackedBF16:
    """Cast a block's weights to bf16 (round to nearest even, as the JAX
    kernel's ``astype``) and transpose them to [N, K]. Make it once per
    folded trunk (``models.fused_trunk``), not once per call."""
    cm = w1.shape[1]
    bf = torch.bfloat16
    return PackedBF16(w1.to(bf).t().contiguous(),
                      w2.to(bf).reshape(9 * cm, cm).t().contiguous(),
                      w3.to(bf).t().contiguous())


def _check(x, w1, b1, w2, b2, w3, b3) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, Cin], got {tuple(x.shape)}")
    cin = x.shape[3]
    cm = w1.shape[1] if w1.dim() == 2 else -1
    want = ((cin, cm), (cm,), (3, 3, cm, cm), (cm,), (cm, cin), (cin,))
    params = (w1, b1, w2, b2, w3, b3)
    if all(t.shape == s for t, s in zip(params, want)):  # the common case, cheaply
        return
    for name, t, s in zip(("w1", "b1", "w2", "b2", "w3", "b3"), params, want):
        if tuple(t.shape) != s:
            raise ValueError(f"{name} must be {s} for x {tuple(x.shape)}, got {tuple(t.shape)}")


def bottleneck_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: three f32 convolutions (cuDNN on the card, TF32
    off by the package's device rule) in channels_last memory.

    On a bf16 x it takes the JAX ``bottleneck_oracle``'s rounding points:
    each convolution is the f32 convolution of bf16 values (x, and the
    weights cast to bf16), so the products are exact and only the order of
    the f32 sums differs; ``y1 = bf16(relu(conv + b1))``, ``y2 =
    bf16(relu(conv3x3 + b2))``, ``out = bf16(relu(conv + b3 + f32(x)))``,
    each rounding to nearest even. Returns x's dtype."""
    _check(x, w1, b1, w2, b2, w3, b3)
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the bottleneck takes float32 or bfloat16, not {dt}")

    def conv(y, w, b, **kw):  # the f32 sums, then the f32 bias
        return F.conv2d(y, w.to(dt).float(), b.float(), **kw)

    def rnd(y):  # one rounding to x's dtype (none in f32)
        return y.to(dt).float()

    xc = x.float().permute(0, 3, 1, 2)                      # NHWC view as NCHW
    y = rnd(F.relu(conv(xc, w1.t()[:, :, None, None], b1)))
    y = rnd(F.relu(conv(y, w2.permute(3, 2, 0, 1), b2, padding=1)))
    out = F.relu(conv(y, w3.t()[:, :, None, None], b3) + xc)
    return out.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1).to(dt)


def _check_launch(x: torch.Tensor, params) -> Tuple[int, int, int, int, int]:
    """What both kernels refuse before a launch; (B, H, W, Cin, Cm)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, *params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        raise RuntimeError("the bottleneck kernel is inference-only (no backward)")
    if any(t.device != x.device for t in params):
        raise ValueError("x and the weights must be on one device")
    if not (x.is_contiguous() and all(t.is_contiguous() for t in params)):
        raise ValueError("x (NHWC) and the weights must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernels copy 16 bytes "
                         "at a time)")
    B, H, W, cin = x.shape
    cm = params[0].shape[1]
    if cin % 32 or cm % 32:
        raise ValueError(f"Cin and Cm must be multiples of 32, got {cin} and {cm}")
    return B, H, W, cin, cm


def bottleneck_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                     packed: Optional[PackedBF16] = None) -> torch.Tensor:
    """``relu(c1x1(relu(c3x3(relu(c1x1(x) + b1)) + b2)) + b3 + x)``, BN folded.

    x: [B, H, W, Cin] float32 or bfloat16; returns x's dtype (a new tensor,
    contiguous NHWC). A bfloat16 x goes to :func:`bottleneck_fused_bf16`
    (with ``packed``); on the card a float32 x goes to the 3xTF32 kernel,
    its weights and biases f32. Cin and Cm must be multiples of 32.
    ``launches`` counts the 3xTF32 kernel's launches.
    """
    if x.dtype == torch.bfloat16:
        return bottleneck_fused_bf16(x, w1, b1, w2, b2, w3, b3, packed)
    if x.device.type == "cpu":
        return bottleneck_plain(x, w1, b1, w2, b2, w3, b3)
    params = (w1, b1, w2, b2, w3, b3)
    B, H, W, cin, cm = _check_launch(x, params)
    if x.dtype != torch.float32 or any(t.dtype != torch.float32 for t in params):
        raise TypeError(f"the bottleneck kernels take float32 or bfloat16 x (float32 "
                        f"weights with float32 x), not {x.dtype}")
    out = torch.empty_like(x)
    if B == 0 or H == 0 or W == 0:
        return out
    plan = _plan(B, H, W, cin, cm)
    y1 = torch.empty(plan["scratch"], dtype=torch.float32, device=x.device)
    y2 = torch.empty(plan["scratch"], dtype=torch.float32, device=x.device)
    wt = torch.empty(plan["split_weights"], dtype=torch.float32, device=x.device)
    lib = _build.load("bottleneck")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bottleneck_forward(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                     b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), wt.data_ptr(),
                                     y1.data_ptr(), y2.data_ptr(), out.data_ptr(), B, H, W,
                                     cin, cm, stream)
    _build.check(err, "bottleneck_forward")
    bottleneck_fused.launches += 1
    return out


def bottleneck_fused_bf16(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                          b3: torch.Tensor, packed: Optional[PackedBF16] = None) -> torch.Tensor:
    """The bf16 form of :func:`bottleneck_fused`: x bfloat16, weights f32 or
    bf16 (cast to bf16 as the JAX kernel casts them; ``packed``, if given,
    is :func:`pack_bf16` of these weights, made once by the caller), biases
    f32. On the card it launches ``csrc/bottleneck_bf16.cu``; ``launches``
    counts its launches.
    """
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 bottleneck kernel takes a bfloat16 x, not {x.dtype}")
    if x.device.type == "cpu":
        return bottleneck_plain(x, w1, b1, w2, b2, w3, b3)
    params = (w1, b1, w2, b2, w3, b3)
    B, H, W, cin, cm = _check_launch(x, params)
    if any(t.dtype not in (torch.float32, torch.bfloat16) for t in (w1, w2, w3)) or \
            any(t.dtype != torch.float32 for t in (b1, b2, b3)):
        raise TypeError("the bf16 bottleneck kernel takes f32 or bf16 weights and f32 biases")
    out = torch.empty_like(x)
    if B == 0 or H == 0 or W == 0:
        return out
    pk = pack_bf16(w1, w2, w3) if packed is None else packed
    want = {"w1t": (cm, cin), "w2t": (cm, 9 * cm), "w3t": (cin, cm)}
    for name, t in zip(want, pk):
        if (tuple(t.shape) != want[name] or t.dtype != torch.bfloat16
                or t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"packed.{name} must be contiguous bf16 {want[name]} on {x.device}, "
                             f"16-byte aligned (the kernel's TMA reads it)")
    # y1 and y2 (_plan's scratch) in one allocation: the wrapper's host time
    # is part of each call's time
    y = torch.empty((2, B, H, W, cm), dtype=torch.bfloat16, device=x.device)
    y1 = y.data_ptr()
    lib = _build.load("bottleneck_bf16")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bottleneck_forward_bf16(
            x.data_ptr(), pk.w1t.data_ptr(), b1.data_ptr(), pk.w2t.data_ptr(), b2.data_ptr(),
            pk.w3t.data_ptr(), b3.data_ptr(), y1, y1 + B * H * W * cm * 2, out.data_ptr(),
            B, H, W, cin, cm, stream)
    _build.check(err, "bottleneck_forward_bf16")
    bottleneck_fused_bf16.launches += 1
    return out


bottleneck_fused.launches = 0
bottleneck_fused_bf16.launches = 0
