"""Fused NetVLAD aggregation: CUDA kernel and its plain version.

Replaces the JAX package's ``ops/pallas/netvlad_kernel.py::netvlad_fused``
and ``netvlad_fused_rect``. The kernel is ``csrc/netvlad.cu``: both products
(the logits ``x W`` and the aggregation ``a^T x``, 2 N C K flops each) run
as 3xTF32 tensor-core GEMMs on ``csrc/tf32x3_gemm.cuh``, with the soft
assignment between them written to scratch as ``a^T``'s split planes; then
the residual, the per-cluster and the global L2N in two deterministic
passes. Invalid rows of a padded rectangle are skipped, not read. Any K
and any C run: the wrapper pads channels to a multiple of 32
(:func:`prepare_operands`) and allocates the kernel's scratch
(:func:`_plan`) in one piece; the kernel splits W^T itself, so a call with
C % 32 == 0 runs no torch operation besides two allocations.

Both entry points keep the TPU kernel's normalization: ``v / (sqrt(sum v^2)
+ 1e-6)`` per cluster and then globally, with no 1e-24 floor (unlike
``ops.normalization.l2n``; the two agree except on norms below 1e-12). An
image with no valid row and a cluster with zero soft mass come out as zeros.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Both are differentiable: when grad mode is on
and any of ``x``, ``centroids``, ``assign_w``, ``assign_b`` needs a gradient,
the call goes through a ``torch.autograd.Function`` (on either device) whose
forward is that same launch or plain version and whose backward is the VJP of
``ops.netvlad.netvlad_aggregate`` (with the rectangle's mask), recomputed on
the saved inputs: the JAX package's custom VJPs (``_nv_bwd``,
``_nv_rect_bwd``) differentiate that same oracle. Its norms floor the
squared norm at 1e-24, so a cluster with zero soft mass (common after the
k-means init) gets a finite gradient, where the derivative of the plain
version's ``sqrt`` at 0 is infinite. There is no backward kernel; ``sizes``
gets no gradient.

``pre_l2=True`` (NetVLAD's ``preL2`` models) L2-normalizes each local
descriptor first, ``x_n / max(||x_n||, 1e-12)`` as ``F.normalize`` does,
without a normalized copy of x: the kernel takes it as a per-row scale
``r_n``, the logits ``r_n (x_n W) + b`` and the aggregation's weights
``a_nk r_n``, with the cluster mass ``sum_n a_nk`` unscaled (the plain version
computes the same). The Function's backward differentiates the oracle on
``F.normalize``d x.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build
from image_retrieval_for_image_based_localization_tpu_torch.ops.netvlad import netvlad_aggregate
from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import span

EPS = 1e-6
PRE_L2_EPS = 1e-12  # F.normalize's floor on a local descriptor's norm
_BN, _BK = 64, 32  # cluster tile and stage depth, csrc/tf32x3_gemm.cuh
_CHUNK = 512       # valid rows a block of the aggregation takes, csrc/netvlad.cu CHUNK


def netvlad_plain(x: torch.Tensor, centroids: torch.Tensor, assign_w: torch.Tensor,
                  assign_b: Optional[torch.Tensor] = None,
                  sizes: Optional[torch.Tensor] = None, pre_l2: bool = False) -> torch.Tensor:
    """Plain PyTorch version of both kernels. x: [B, N, C] or [B, H, W, C]
    f32; sizes: [B, 2] valid (h, w) of the top-left rectangle (needs x as
    [B, H, W, C]) or None; pre_l2: each row scaled by 1 / max(||x_n||,
    1e-12) in the logits and the aggregation's weights -> [B, K*C] f32."""
    W = x.shape[2] if x.dim() == 4 else None
    x = x.reshape(x.shape[0], -1, x.shape[-1]).float()
    B, N, C = x.shape
    K = centroids.shape[0]
    logits = torch.matmul(x, assign_w.float())
    if pre_l2:
        r = 1.0 / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                              min=PRE_L2_EPS)
        logits = logits * r
    if assign_b is not None:
        logits = logits + assign_b.float()
    a = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    a = a / torch.sum(a, dim=-1, keepdim=True)
    if sizes is not None:
        if W is None:
            raise ValueError("sizes need x as [B, H, W, C]")
        sizes = sizes.to(device=x.device, dtype=torch.int64)
        n = torch.arange(N, device=x.device)
        valid = ((n // W)[None, :] < sizes[:, 0:1]) & ((n % W)[None, :] < sizes[:, 1:2])
        a = torch.where(valid[..., None], a, torch.zeros((), device=x.device))
    weights = a * r if pre_l2 else a
    agg = torch.matmul(weights.transpose(1, 2), x)            # [B, K, C]
    vlad = agg - a.sum(dim=1)[..., None] * centroids.float()[None]
    vlad = vlad / (torch.sqrt(torch.sum(vlad * vlad, dim=-1, keepdim=True)) + EPS)
    flat = vlad.reshape(B, K * C)
    return flat / (torch.sqrt(torch.sum(flat * flat, dim=-1, keepdim=True)) + EPS)


def _check(x, centroids, assign_w, assign_b) -> None:
    params = (x, centroids, assign_w, assign_b)
    for name, t in zip(("x", "centroids", "assign_w", "assign_b"), params):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    K, C = centroids.shape
    if x.shape[-1] != C or tuple(assign_w.shape) != (C, K):
        raise ValueError(f"need x [..., {C}], assign_w [{C}, {K}]; got "
                         f"{tuple(x.shape)}, {tuple(assign_w.shape)}")
    if assign_b is not None and tuple(assign_b.shape) != (K,):
        raise ValueError(f"assign_b must be [{K}], got {tuple(assign_b.shape)}")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def prepare_operands(x3: torch.Tensor, centroids: torch.Tensor, assign_w: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x3 [B, N, C], centroids [K, C] and assign_w [C, K] with their channels
    zero-padded to the next multiple of 32, as ``csrc/netvlad.cu`` takes
    them. Copied only when C % 32 != 0: zero channels change no logit, sum
    or norm, and the kernel's result is sliced back to C."""
    C = x3.shape[-1]
    cp = _round_up(C, _BK)
    if cp != C:
        x3 = F.pad(x3, (0, cp - C))
        centroids = F.pad(centroids.detach(), (0, cp - C))
        assign_w = F.pad(assign_w.detach(), (0, 0, 0, cp - C))
    return x3, centroids.detach().contiguous(), assign_w.detach().contiguous()


def _plan(B: int, N: int, C: int, K: int) -> dict:
    """Scratch shapes of ``csrc/netvlad.cu`` (C already padded to 32), in
    the entry's order: W^T's split planes [KP, C], the logits [B, NP, KP],
    a^T's split planes [B, K, NP], each 32-row tile's cluster mass, each
    512-row chunk's partial aggregation, and each cluster row's sum of
    squares; KP = K rounded up to the 64-cluster tile, NP = N to 32."""
    np_, kp = _round_up(N, _BK), _round_up(K, _BN)
    n_chunks = -(-N // _CHUNK)
    return {"n_chunks": n_chunks,
            "scratch": {"wt_hi": (kp, C), "wt_lo": (kp, C), "logits": (B, np_, kp),
                        "a_hi": (B, K, np_), "a_lo": (B, K, np_), "mass": (B, np_ // _BK, K),
                        "part": (B, n_chunks, K, C), "row_sq": (B, K)}}


def _launch(x3: torch.Tensor, centroids, assign_w, assign_b, sizes, W: int,
            pre_l2: bool = False) -> torch.Tensor:
    dev = x3.device
    for t in (centroids, assign_w, assign_b, sizes):
        if t is not None and t.device != dev:
            raise ValueError("x, centroids, assign_w, assign_b and sizes must be on one device")
    if not x3.is_contiguous():
        raise ValueError("x must be contiguous (channels last)")
    B, N, C = x3.shape
    K = centroids.shape[0]
    if B == 0:
        return torch.empty((0, K * C), dtype=torch.float32, device=dev)
    xp, cen, w = prepare_operands(x3, centroids, assign_w)
    if xp.data_ptr() % 16:  # the kernel copies x in 16-byte chunks
        xp = xp.clone()
    bias = None if assign_b is None else assign_b.detach().contiguous()
    cp = xp.shape[-1]
    plan = _plan(B, N, cp, K)
    # one allocation; each part starts on a 256-byte boundary
    offsets, total = [], 0
    for shape in plan["scratch"].values():
        offsets.append(total)
        total += _round_up(math.prod(shape), 64)
    flat = torch.empty((total,), dtype=torch.float32, device=dev)
    out = torch.empty((B, K * cp), dtype=torch.float32, device=dev)
    lib = _build.load("netvlad")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.netvlad_forward(
            xp.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            cen.data_ptr(), None if sizes is None else sizes.data_ptr(),
            *(flat.data_ptr() + 4 * o for o in offsets),
            out.data_ptr(), B, N, W, cp, K, plan["n_chunks"], stream, int(pre_l2))
    _build.check(err, "netvlad_forward")
    if cp != C:
        out = out.view(B, K, cp)[:, :, :C].reshape(B, K * C)
    return out


def _forward(x: torch.Tensor, centroids, assign_w, assign_b, sizes,
             pre_l2: bool = False) -> torch.Tensor:
    """The plain version for CPU tensors; the kernel for CUDA ones, counted
    on the entry point it serves (``sizes`` None: ``netvlad_fused``)."""
    if x.device.type == "cpu":
        return netvlad_plain(x, centroids, assign_w, assign_b, sizes, pre_l2=pre_l2)
    W = 1 if sizes is None else x.shape[2]
    entry = netvlad_fused if sizes is None else netvlad_fused_rect
    # while a profiler records, a range named after the entry point holds
    # its six kernels
    with span(entry.__name__):
        out = _launch(x.reshape(x.shape[0], -1, x.shape[-1]), centroids, assign_w, assign_b,
                      sizes, W, pre_l2)
    entry.launches += 1
    return out


class _NetVLAD(torch.autograd.Function):
    """Forward: :func:`_forward`. Backward: the VJP of
    ``netvlad_aggregate`` at the saved inputs."""

    @staticmethod
    def forward(ctx, x, centroids, assign_w, assign_b, sizes, pre_l2):
        ctx.save_for_backward(x, centroids, assign_w, assign_b, sizes)
        ctx.pre_l2 = pre_l2
        return _forward(x, centroids, assign_w, assign_b, sizes, pre_l2)

    @staticmethod
    def backward(ctx, g):
        *params, sizes = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        mask = None
        if sizes is not None:
            _, H, W, _ = params[0].shape
            mask = ((torch.arange(H, device=sizes.device)[:, None] < sizes[:, 0, None, None])
                    & (torch.arange(W, device=sizes.device) < sizes[:, 1, None, None]))
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(params, needs)]
            wrt = [t for t, need in zip(leaves, needs) if need]
            x = F.normalize(leaves[0], dim=-1, eps=PRE_L2_EPS) if ctx.pre_l2 else leaves[0]
            out = netvlad_aggregate(x, *leaves[1:], mask=mask)
            grads = list(torch.autograd.grad(out, wrt, g))
        return (*(grads.pop(0) if need else None for need in needs), None, None)


def _apply(x, centroids, assign_w, assign_b, sizes, pre_l2) -> torch.Tensor:
    params = (x, centroids, assign_w, assign_b)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in params):
        return _NetVLAD.apply(x, centroids, assign_w, assign_b, sizes, pre_l2)
    return _forward(x, centroids, assign_w, assign_b, sizes, pre_l2)


def netvlad_fused(x: torch.Tensor, centroids: torch.Tensor, assign_w: torch.Tensor,
                  assign_b: Optional[torch.Tensor] = None, pre_l2: bool = False) -> torch.Tensor:
    """Fused NetVLAD aggregation. x: [B, N, C] or [B, H, W, C] f32;
    centroids [K, C]; assign_w [C, K]; assign_b [K] or None; pre_l2: each
    row of x L2-normalized first -> [B, K*C] f32."""
    if x.dim() not in (3, 4):
        raise ValueError(f"x must be [B, N, C] or [B, H, W, C], got {tuple(x.shape)}")
    _check(x, centroids, assign_w, assign_b)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("x must be contiguous (channels last)")
    return _apply(x, centroids, assign_w, assign_b, None, pre_l2)


def netvlad_fused_rect(x: torch.Tensor, centroids: torch.Tensor, assign_w: torch.Tensor,
                       assign_b: Optional[torch.Tensor] = None,
                       sizes: Optional[torch.Tensor] = None,
                       pre_l2: bool = False) -> torch.Tensor:
    """Masked fused NetVLAD for top-left-rectangle batches.

    x: [B, H, W, C] f32; sizes: [B, 2] int32 valid (h, w) per image; pre_l2
    as in :func:`netvlad_fused` -> [B, K*C] f32.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if sizes is None or tuple(sizes.shape) != (B, 2):
        raise ValueError(f"sizes must be [{B}, 2], got "
                         f"{None if sizes is None else tuple(sizes.shape)}")
    _check(x, centroids, assign_w, assign_b)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda":
        if sizes.dtype != torch.int32 or not sizes.is_contiguous():
            raise TypeError("sizes must be a contiguous int32 tensor")
        if not x.is_contiguous():
            # the channels_last trunk output permuted to [B, H, W, C] is contiguous
            raise ValueError("x must be contiguous [B, H, W, C] (channels last)")
    return _apply(x, centroids, assign_w, assign_b, sizes, pre_l2)


netvlad_fused.launches = 0
netvlad_fused_rect.launches = 0
