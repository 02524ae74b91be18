"""k-means, the counterpart of the JAX package's ``training/netvlad_init.py``.

Only :func:`kmeans` is ported so far: the IVF coarse quantizer and the PQ
codebooks are trained with it. The NetVLAD centroid initialization from
trunk features comes with training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def kmeans(x: torch.Tensor, k: int, iters: int = 25,
           generator: Optional[torch.Generator] = None,
           init: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means on ``x``'s device. x: [N, D] f32 -> (centroids [k, D],
    assign [N] int64).

    Init: the rows ``init`` [k, D] when given, else k rows of x sampled
    without replacement by ``generator`` (a ``torch.Generator``; seed 0 when
    None). The assignment is ``argmin(|x|^2 - 2 x.c + |c|^2)``, ties to the
    lowest id; empty clusters keep their previous centroid.
    """
    x = x.float()
    N = x.shape[0]
    if init is not None:
        cent = torch.as_tensor(init, dtype=torch.float32).to(x.device).clone()
        if cent.shape != (k, x.shape[1]):
            raise ValueError(f"init must be [{k}, {x.shape[1]}], got {tuple(cent.shape)}")
    else:
        if k > N:
            raise ValueError(f"k={k} exceeds the {N} rows")
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        cent = x[torch.randperm(N, generator=gen)[:k].to(x.device)]
    x_sq = torch.sum(x * x, dim=1, keepdim=True)

    def assign_of(c: torch.Tensor) -> torch.Tensor:
        d2 = x_sq - 2.0 * (x @ c.T) + torch.sum(c * c, dim=1)[None, :]
        return torch.argmin(d2, dim=1)  # first minimum: lowest id

    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(assign_of(cent), k).to(x.dtype)  # [N, k]
        counts = onehot.sum(dim=0)
        sums = onehot.T @ x
        cent = torch.where(counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0),
                           cent)
    return cent, assign_of(cent)
