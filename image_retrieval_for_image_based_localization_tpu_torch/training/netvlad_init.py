"""k-means and the NetVLAD centroid init, the counterpart of the JAX
package's ``training/netvlad_init.py``.

:func:`kmeans` also trains the IVF coarse quantizer and the PQ codebooks.
:func:`init_netvlad_from_images` sets a NetVLAD head from k-means over the
trunk's local features on a corpus, with the soft-assignment conv as the
NetVLAD paper sets it (``w_k = 2 alpha c_k``, ``b_k = -alpha |c_k|^2``), so the
soft assignment approaches the hard k-means one as alpha grows.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
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


@torch.no_grad()
def collect_local_features(
    model,
    images: Sequence,
    cfg,
    max_features: int = 50_000,
    per_image: int = 256,
    seed: int = 0,
) -> np.ndarray:
    """Sample trunk local features [M, C] f32 over a corpus (for k-means).

    ``model`` is a ``RetrievalNet`` holding its weights, on its device; the
    trunk runs in its compute dtype on the host pipeline's normalized,
    zero-padded pixels (``make_batches``), and up to ``per_image`` valid
    positions of each image are drawn by ``np.random.RandomState(seed)``, as
    the JAX package draws them.
    """
    from image_retrieval_for_image_based_localization_tpu_torch.data.images import make_batches

    dev = next(model.parameters()).device
    rng = np.random.RandomState(seed)
    feats = []
    total = 0
    for batch in make_batches(images, image_size=cfg.image_size, batch_size=cfg.batch_size,
                              bucket_multiple=cfg.bucket_multiple):
        pixels = batch.pixels
        f = model.trunk_nhwc(torch.from_numpy(pixels).to(dev)).float().cpu().numpy()
        B, h, w, C = f.shape
        stride_h = pixels.shape[1] // h
        stride_w = pixels.shape[2] // w
        fmask = batch.mask[:, ::stride_h, ::stride_w][:, :h, :w]
        for row in range(len(batch.indices)):
            valid = f[row][fmask[row]]
            if valid.shape[0] == 0:
                continue
            take = min(per_image, valid.shape[0])
            sel = rng.choice(valid.shape[0], take, replace=False)
            feats.append(valid[sel])
            total += take
        if total >= max_features:
            break
    return np.concatenate(feats, axis=0)[:max_features].astype(np.float32)


def init_netvlad_params(centroids: np.ndarray, alpha: float = 100.0) -> Dict[str, np.ndarray]:
    """NetVLAD-paper soft-assignment init from k-means centroids, in the JAX
    package's layout (``assign_w`` [C, K])."""
    c = np.asarray(centroids, np.float32)
    return {
        "centroids": c,
        "assign_w": (2.0 * alpha * c).T.astype(np.float32),  # [C, K]
        "assign_b": (-alpha * np.sum(c * c, axis=1)).astype(np.float32),
    }


def init_netvlad_from_images(
    model,
    images: Sequence,
    cfg,
    alpha: float = 100.0,
    kmeans_iters: int = 25,
    seed: int = 0,
) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict with its NetVLAD head set from k-means (seeded
    by ``torch.Generator().manual_seed(seed)``) on the trunk's local features
    over ``images``."""
    if model.pooling != "netvlad":
        raise ValueError("model.pooling must be 'netvlad'")
    feats = collect_local_features(model, images, cfg, seed=seed)
    dev = next(model.parameters()).device
    cent, _ = kmeans(torch.from_numpy(feats).to(dev), model.netvlad_clusters,
                     iters=kmeans_iters, generator=torch.Generator().manual_seed(seed))
    head = init_netvlad_params(cent.cpu().numpy(), alpha=alpha)
    K, C = head["centroids"].shape
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sd["pool.centroids"] = torch.from_numpy(head["centroids"])
    sd["pool.conv.weight"] = torch.from_numpy(head["assign_w"].T.copy()).reshape(K, C, 1, 1)
    sd["pool.conv.bias"] = torch.from_numpy(head["assign_b"])
    return sd
