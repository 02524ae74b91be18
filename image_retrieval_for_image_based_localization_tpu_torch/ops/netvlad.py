"""NetVLAD soft-assignment aggregation (the JAX package's ``ops/netvlad.py``).

A 1x1 conv scores each local feature against K clusters, a softmax
soft-assigns, residuals against the cluster centroids are accumulated,
intra-(per-cluster)-L2-normalized, flattened, and globally L2-normalized
(Arandjelović et al., CVPR 2016). The spatial map is flattened to
``[B, N, C]`` and the aggregation is two products plus a softmax. A validity
mask zeroes the assignment of padded positions after the softmax.

This is the oracle that the hand-written kernel's plain version
(``ops.kernels.netvlad``) is held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.normalization import l2n


def netvlad_aggregate(
    x: torch.Tensor,
    centroids: torch.Tensor,
    assign_w: torch.Tensor,
    assign_b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Aggregate local features into a VLAD descriptor.

    Args:
      x: ``[B, N, C]`` local features (flattened H*W) or ``[B, H, W, C]``.
      centroids: ``[K, C]`` cluster centers.
      assign_w: ``[C, K]`` 1x1-conv assignment weights.
      assign_b: ``[K]`` optional assignment bias.
      mask: ``[B, N]`` (or ``[B, H, W]``) validity mask for padded positions.

    Returns:
      ``[B, K*C]`` descriptor: intra-normalized per cluster, then global L2N.
    """
    if x.dim() == 4:
        B, H, W, C = x.shape
        x = x.reshape(B, H * W, C)
        if mask is not None:
            mask = mask.reshape(B, H * W)
    B, N, C = x.shape
    K = centroids.shape[0]

    logits = torch.einsum("bnc,ck->bnk", x, assign_w)
    if assign_b is not None:
        logits = logits + assign_b[None, None, :]
    assign = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    assign = assign / torch.sum(assign, dim=-1, keepdim=True)
    if mask is not None:
        assign = assign * mask[..., None].to(assign.dtype)

    # vlad[b,k,c] = sum_n a[b,n,k] * (x[b,n,c] - centroids[k,c])
    #            = (a^T x)[b,k,c] - (sum_n a[b,n,k]) * centroids[k,c]
    agg = torch.einsum("bnk,bnc->bkc", assign, x)
    counts = torch.sum(assign, dim=1)  # [B, K]
    vlad = agg - counts[..., None] * centroids[None, :, :]

    vlad = l2n(vlad, dim=-1)           # intra-normalization per cluster
    vlad = vlad.reshape(B, K * C)
    return l2n(vlad, dim=-1)           # global L2 normalization
