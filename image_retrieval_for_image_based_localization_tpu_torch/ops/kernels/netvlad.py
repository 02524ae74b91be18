"""Fused NetVLAD aggregation: CUDA kernel and its plain version.

Replaces the JAX package's ``ops/pallas/netvlad_kernel.py::netvlad_fused``
and ``netvlad_fused_rect``. The kernel is ``csrc/netvlad.cu``: bound by its
f32 FMA work (logits and aggregation, 2 N C K flops each), it keeps the soft
assignment of a block's rows in shared memory (it never reaches device
memory, as on the TPU), writes per-split partial ``a^T x`` and cluster mass,
then finishes the residual, the per-cluster and the global L2N in two
deterministic passes. Invalid rows of a padded rectangle are skipped, not
read.

Both entry points keep the TPU kernel's normalization: ``v / (sqrt(sum v^2)
+ 1e-6)`` per cluster and then globally, with no 1e-24 floor (unlike
``ops.normalization.l2n``; the two agree except on norms below 1e-12). An
image with no valid row and a cluster with zero soft mass come out as zeros.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Inference only on both: the backward comes
with the training part of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build

EPS = 1e-6
KMAX = 128    # largest K the kernel takes
_ROWS = 128   # valid rows per block of pass (a), csrc/netvlad.cu S_ROWS


def netvlad_plain(x: torch.Tensor, centroids: torch.Tensor, assign_w: torch.Tensor,
                  assign_b: Optional[torch.Tensor] = None,
                  sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of both kernels. x: [B, N, C] or [B, H, W, C]
    f32; sizes: [B, 2] valid (h, w) of the top-left rectangle (needs x as
    [B, H, W, C]) or None -> [B, K*C] f32."""
    W = x.shape[2] if x.dim() == 4 else None
    x = x.reshape(x.shape[0], -1, x.shape[-1]).float()
    B, N, C = x.shape
    K = centroids.shape[0]
    logits = torch.matmul(x, assign_w.float())
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
    agg = torch.matmul(a.transpose(1, 2), x)                  # [B, K, C]
    vlad = agg - a.sum(dim=1)[..., None] * centroids.float()[None]
    vlad = vlad / (torch.sqrt(torch.sum(vlad * vlad, dim=-1, keepdim=True)) + EPS)
    flat = vlad.reshape(B, K * C)
    return flat / (torch.sqrt(torch.sum(flat * flat, dim=-1, keepdim=True)) + EPS)


def _check(x, centroids, assign_w, assign_b) -> None:
    params = (x, centroids, assign_w, assign_b)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in params):
        raise RuntimeError("netvlad kernels are inference-only (no backward yet)")
    for name, t in zip(("x", "centroids", "assign_w", "assign_b"), params):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    K, C = centroids.shape
    if x.shape[-1] != C or tuple(assign_w.shape) != (C, K):
        raise ValueError(f"need x [..., {C}], assign_w [{C}, {K}]; got "
                         f"{tuple(x.shape)}, {tuple(assign_w.shape)}")
    if assign_b is not None and tuple(assign_b.shape) != (K,):
        raise ValueError(f"assign_b must be [{K}], got {tuple(assign_b.shape)}")


def _launch(x3: torch.Tensor, centroids, assign_w, assign_b, sizes, W: int) -> torch.Tensor:
    dev = x3.device
    for t in (centroids, assign_w, assign_b, sizes):
        if t is not None and t.device != dev:
            raise ValueError("x, centroids, assign_w, assign_b and sizes must be on one device")
    if not x3.is_contiguous():
        raise ValueError("x must be contiguous (channels last)")
    B, N, C = x3.shape
    K = centroids.shape[0]
    if K > KMAX:
        raise ValueError(f"the netvlad kernel takes K <= {KMAX}, got {K}")
    if B == 0:
        return torch.empty((0, K * C), dtype=torch.float32, device=dev)
    if assign_b is None:
        assign_b = torch.zeros((K,), dtype=torch.float32, device=dev)
    centroids, assign_w, assign_b = (t.detach().contiguous()
                                     for t in (centroids, assign_w, assign_b))
    n_splits = -(-N // _ROWS)
    part_agg = torch.empty((B, n_splits, K, C), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((B, n_splits, K), dtype=torch.float32, device=dev)
    row_sq = torch.empty((B, K), dtype=torch.float32, device=dev)
    out = torch.empty((B, K * C), dtype=torch.float32, device=dev)
    lib = _build.load("netvlad")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.netvlad_forward(
            x3.data_ptr(), assign_w.data_ptr(), assign_b.data_ptr(), centroids.data_ptr(),
            None if sizes is None else sizes.data_ptr(), part_agg.data_ptr(),
            part_cnt.data_ptr(), row_sq.data_ptr(), out.data_ptr(), B, N, W, C, K,
            n_splits, stream)
    _build.check(err, "netvlad_forward")
    return out


def netvlad_fused(x: torch.Tensor, centroids: torch.Tensor, assign_w: torch.Tensor,
                  assign_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused NetVLAD aggregation. x: [B, N, C] or [B, H, W, C] f32;
    centroids [K, C]; assign_w [C, K]; assign_b [K] or None -> [B, K*C] f32."""
    if x.dim() not in (3, 4):
        raise ValueError(f"x must be [B, N, C] or [B, H, W, C], got {tuple(x.shape)}")
    _check(x, centroids, assign_w, assign_b)
    if x.device.type == "cpu":
        return netvlad_plain(x, centroids, assign_w, assign_b)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (channels last)")
    out = _launch(x.reshape(x.shape[0], -1, x.shape[-1]), centroids, assign_w, assign_b,
                  None, 1)
    netvlad_fused.launches += 1
    return out


def netvlad_fused_rect(x: torch.Tensor, centroids: torch.Tensor, assign_w: torch.Tensor,
                       assign_b: Optional[torch.Tensor] = None,
                       sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked fused NetVLAD for top-left-rectangle batches.

    x: [B, H, W, C] f32; sizes: [B, 2] int32 valid (h, w) per image -> [B, K*C] f32.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if sizes is None or tuple(sizes.shape) != (B, 2):
        raise ValueError(f"sizes must be [{B}, 2], got "
                         f"{None if sizes is None else tuple(sizes.shape)}")
    _check(x, centroids, assign_w, assign_b)
    if x.device.type == "cpu":
        return netvlad_plain(x, centroids, assign_w, assign_b, sizes)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if sizes.dtype != torch.int32 or not sizes.is_contiguous():
        raise TypeError("sizes must be a contiguous int32 tensor")
    if not x.is_contiguous():
        # the channels_last trunk output permuted to [B, H, W, C] is contiguous
        raise ValueError("x must be contiguous [B, H, W, C] (channels last)")
    out = _launch(x.reshape(B, H * W, C), centroids, assign_w, assign_b, sizes, W)
    netvlad_fused_rect.launches += 1
    return out


netvlad_fused.launches = 0
netvlad_fused_rect.launches = 0
