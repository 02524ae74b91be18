"""Training losses on L2-normalized descriptors (the JAX package's
``ops/losses.py``, cirtorch's ``ContrastiveLoss`` and ``TripletLoss``).

Descriptors come as tuples ``[B, T, D]``: slot 0 is the query, 1 the
positive, 2.. the negatives. Each loss is a sum over the tuple and a mean
over the batch.
"""

from __future__ import annotations

import torch


def contrastive_loss(desc: torch.Tensor, labels: torch.Tensor, margin: float = 0.7,
                     eps: float = 1e-6) -> torch.Tensor:
    """``0.5 d^2`` for positives, ``0.5 max(0, margin - d)^2`` for negatives,
    with ``d = sqrt(max(|q - x|^2, eps))``.

    desc: [B, T, D]; labels: [B, T] with +1 positive, -1 negative, 0 ignore
    (the query slot). Returns a scalar.
    """
    d2 = torch.sum(torch.square(desc - desc[:, :1, :]), dim=-1)  # [B, T]
    d = torch.sqrt(torch.clamp(d2, min=eps))
    pos = 0.5 * d2
    neg = 0.5 * torch.square(torch.clamp(margin - d, min=0.0))
    zero = torch.zeros((), dtype=d2.dtype, device=d2.device)
    per = torch.where(labels > 0, pos, torch.where(labels < 0, neg, zero))
    return torch.mean(torch.sum(per, dim=1))


def triplet_loss(desc: torch.Tensor, margin: float = 0.1) -> torch.Tensor:
    """``max(0, margin + |q - p|^2 - |q - n|^2)`` per negative, over tuples
    [B, T, D]. Returns a scalar."""
    q, p, n = desc[:, 0, :], desc[:, 1, :], desc[:, 2:, :]
    dp2 = torch.sum(torch.square(q - p), dim=-1)              # [B]
    dn2 = torch.sum(torch.square(q[:, None, :] - n), dim=-1)  # [B, Nn]
    viol = torch.clamp(margin + dp2[:, None] - dn2, min=0.0)
    return torch.mean(torch.sum(viol, dim=1))
