"""Masked global and regional pooling: GeM (and GeMmp), MAC, SPoC, R-MAC and
the cirtorch regional pool (the JAX package's ``ops/pooling.py``).

Layout is the JAX package's NHWC ``[B, H, W, C]``; ``mask [B, H, W]`` marks
valid positions of a padded bucket. With ``mask=None`` every position counts.
The R-MAC region grid (:func:`rmac_regions`) is NumPy on static shapes, in
float32 with the JAX package's order of operations; :func:`rmac_bucketed`
computes the same grid in float32 tensor arithmetic from each image's valid
extents, so both paths pool the same regions of each image.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.normalization import l2n

GEM_EPS = 1e-6
RMAC_STEPS = (2, 3, 4, 5, 6, 7)  # candidate region counts along the long side
RMAC_OVERLAP = 0.4


def _neg(x: torch.Tensor) -> torch.Tensor:
    return torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype, device=x.device)


def mac(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Spatial max. [B,H,W,C] -> [B,C]."""
    if mask is not None:
        x = torch.where(mask[..., None], x, _neg(x))
    return torch.amax(x, dim=(1, 2))


def spoc(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Spatial mean. [B,H,W,C] -> [B,C]."""
    if mask is None:
        return torch.mean(x, dim=(1, 2))
    m = mask[..., None].to(x.dtype)
    denom = torch.clamp(torch.sum(m, dim=(1, 2)), min=1.0)
    return torch.sum(x * m, dim=(1, 2)) / denom


def gem(
    x: torch.Tensor,
    p: Union[torch.Tensor, float] = 3.0,
    eps: float = GEM_EPS,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Generalized mean ``(mean_hw clamp(x, eps)^p)^(1/p)``. [B,H,W,C] -> [B,C].

    ``p`` is a scalar (GeM) or one exponent per channel, shape [C] (cirtorch
    GeMmp)."""
    p = torch.as_tensor(p, dtype=x.dtype, device=x.device)
    p = p.reshape(()) if p.numel() == 1 else p.reshape(-1)
    xp = torch.pow(torch.clamp(x, min=eps), p)
    if mask is None:
        pooled = torch.mean(xp, dim=(1, 2))
    else:
        m = mask[..., None].to(x.dtype)
        denom = torch.clamp(torch.sum(m, dim=(1, 2)), min=1.0)
        pooled = torch.sum(xp * m, dim=(1, 2)) / denom
    return torch.pow(pooled, 1.0 / p)


def rmac_regions(H: int, W: int, L: int = 3) -> List[Tuple[int, int, int, int]]:
    """Static R-MAC region grid ``(y, x, h, w)`` of an HxW feature map
    (Tolias et al., as cirtorch samples it): square regions of side
    ``2 min(H, W) / (l + 1)`` at scale l, placed uniformly with ~40 % overlap.

    Float32 throughout and in the JAX package's order of operations: float32
    and float64 disagree on the argmin and floor decisions of ~2 % of
    extents, and :func:`rmac_bucketed` repeats this arithmetic in float32."""
    ovr = np.float32(RMAC_OVERLAP)
    steps = np.array(RMAC_STEPS, np.float32)
    w_min = np.float32(min(W, H))
    # which spacing best approximates the target overlap along the long side
    b = (np.float32(max(H, W)) - w_min) / (steps - np.float32(1))
    idx = int(np.argmin(np.abs(
        (w_min ** 2 - w_min * b) / np.maximum(w_min ** 2, np.float32(1)) - ovr)))
    # extra regions along the long side
    Wd = idx + 1 if W > H else 0
    Hd = idx + 1 if H > W else 0
    regions: List[Tuple[int, int, int, int]] = []
    for l in range(1, L + 1):
        wl = int(math.floor(np.float32(2) * w_min / np.float32(l + 1)))
        if wl == 0:
            continue
        bx = np.float32(W - wl) / np.float32(l + Wd - 1) if l + Wd - 1 > 0 else np.float32(0)
        cen_w = [int(math.floor(bx * np.float32(i))) for i in range(l + Wd)]
        by = np.float32(H - wl) / np.float32(l + Hd - 1) if l + Hd - 1 > 0 else np.float32(0)
        cen_h = [int(math.floor(by * np.float32(j))) for j in range(l + Hd)]
        for yy in cen_h:
            for xx in cen_w:
                regions.append((yy, xx, wl, wl))
    return regions


def rpool(
    x: torch.Tensor,
    base: str = "gem",
    p: Union[torch.Tensor, float] = 3.0,
    L: int = 3,
    whiten_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    aggregate: bool = True,
) -> torch.Tensor:
    """Regional pooling (cirtorch ``Rpool``): the base pool (GeM, MAC or
    SPoC) of the whole map and of every R-MAC region, each L2-normalized,
    each passed through the shared ``whiten_fn`` and L2-normalized again when
    one is given, then summed; the caller applies the final L2N.
    ``aggregate=False`` returns the region vectors ``[B, R, D]`` instead of
    their sum (cirtorch ``extract_regional_vectors``). Exact shapes only:
    the grid is a function of (H, W)."""
    pools = {"gem": lambda r: gem(r, p), "mac": mac, "spoc": spoc}
    if base not in pools:
        raise ValueError(f"rpool wraps gem/mac/spoc, got {base!r}")
    pool_fn = pools[base]
    _, H, W, _ = x.shape
    vecs = []
    for (yy, xx, hh, ww) in [(0, 0, H, W), *rmac_regions(H, W, L)]:
        v = l2n(pool_fn(x[:, yy:yy + hh, xx:xx + ww, :]))
        if whiten_fn is not None:
            v = l2n(whiten_fn(v))
        vecs.append(v)
    if not aggregate:
        return torch.stack(vecs, dim=1)
    out = vecs[0]
    for v in vecs[1:]:
        out = out + v
    return out


def rmac(x: torch.Tensor, L: int = 3, eps: float = 1e-6,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Regional MAC. [B,H,W,C] -> [B,C]: the L2-normalized MAC of the whole
    map plus the L2-normalized MAC of every region, summed (the model head
    applies the final L2N).

    With ``mask``, invalid positions are left out of every max and a region
    with no valid position adds nothing; the grid still comes from the padded
    shape, so this is the fallback for masks that are not rectangles
    (:func:`rmac_bucketed` takes the bucketing's rectangles exactly)."""
    _, H, W, _ = x.shape
    if mask is not None:
        x = torch.where(mask[..., None], x, _neg(x))

    def region_vec(r, rm):
        v = l2n(torch.amax(r, dim=(1, 2)), eps=eps)
        if rm is None:
            return v
        return v * rm.any(dim=2).any(dim=1)[:, None].to(v.dtype)

    v = region_vec(x, mask)
    for (yy, xx, hh, ww) in rmac_regions(H, W, L):
        rm = None if mask is None else mask[:, yy:yy + hh, xx:xx + ww]
        v = v + region_vec(x[:, yy:yy + hh, xx:xx + ww, :], rm)
    return v


def rmac_slots(sizes: torch.Tensor, L: int = 3):
    """The slot grid of :func:`rmac_bucketed`: for valid extents ``sizes``
    [B, 2] (h, w), yields ``(y0, x0, side, valid)``, each [B], for every
    (scale l, row i, column j) that an extent could need, in the exact grid's
    row-major order. It is :func:`rmac_regions`' arithmetic in float32 over
    the rows of ``sizes``: per image, the valid slots are its regions."""
    h = sizes[:, 0].to(torch.float32)
    w = sizes[:, 1].to(torch.float32)
    w_min = torch.minimum(h, w)
    w_max = torch.maximum(h, w)
    steps = torch.tensor(RMAC_STEPS, dtype=torch.float32, device=sizes.device)
    b = (w_max[:, None] - w_min[:, None]) / (steps[None, :] - 1)
    wm = w_min[:, None]
    idx = torch.argmin(torch.abs((wm ** 2 - wm * b) / torch.clamp(wm ** 2, min=1.0)
                                 - np.float32(RMAC_OVERLAP)), dim=1).to(torch.float32)
    Wd = torch.where(w > h, idx + 1, torch.zeros_like(idx))
    Hd = torch.where(h > w, idx + 1, torch.zeros_like(idx))
    one = torch.ones_like(h)
    for l in range(1, L + 1):
        wl = torch.floor(2.0 * w_min / (l + 1))
        n_w = l + Wd  # centres along x
        n_h = l + Hd
        bx = torch.where(n_w > 1, (w - wl) / torch.maximum(n_w - 1, one), torch.zeros_like(w))
        by = torch.where(n_h > 1, (h - wl) / torch.maximum(n_h - 1, one), torch.zeros_like(h))
        m = l + len(RMAC_STEPS)  # idx <= 5, so at most l + 6 centres on the long side
        for i in range(m):
            for j in range(m):
                if i >= l and j >= l:
                    continue  # one of Hd, Wd is 0: i < l or j < l
                valid = (wl > 0) & (i < n_h) & (j < n_w)
                yield torch.floor(by * i), torch.floor(bx * j), wl, valid


def rmac_region_counts(sizes: torch.Tensor, L: int = 3) -> torch.Tensor:
    """[B] int64: the regions :func:`rmac_bucketed` pools for each extent,
    the whole valid area included (``1 + len(rmac_regions(h, w, L))``)."""
    n = torch.ones(sizes.shape[0], dtype=torch.int64, device=sizes.device)
    for _, _, _, valid in rmac_slots(sizes, L):
        n = n + valid.to(torch.int64)
    return n


def rmac_bucketed(x: torch.Tensor, sizes: torch.Tensor, L: int = 3,
                  eps: float = 1e-6) -> torch.Tensor:
    """R-MAC of a bucketed batch: [B,H,W,C] + valid extents ``sizes`` [B, 2]
    -> [B,C]. Each image pools the regions that :func:`rmac` gives its exact
    (h, w) map, and padded positions never enter a region: every slot of
    :func:`rmac_slots` is a masked spatial max, zero where the slot is not
    one of the image's regions."""
    B, H, W, _ = x.shape
    neg = _neg(x)
    row = torch.arange(H, dtype=torch.float32, device=x.device)[None, :, None]
    col = torch.arange(W, dtype=torch.float32, device=x.device)[None, None, :]

    def region_vec(y0, x0, hh, ww, valid):
        rm = ((row >= y0[:, None, None]) & (row < (y0 + hh)[:, None, None])
              & (col >= x0[:, None, None]) & (col < (x0 + ww)[:, None, None]))
        mx = torch.amax(torch.where(rm[..., None], x, neg), dim=(1, 2))
        return l2n(mx, eps=eps) * valid[:, None].to(x.dtype)

    zeros = torch.zeros(B, dtype=torch.float32, device=x.device)
    v = region_vec(zeros, zeros, sizes[:, 0].to(torch.float32), sizes[:, 1].to(torch.float32),
                   torch.ones(B, dtype=torch.bool, device=x.device))
    for y0, x0, wl, valid in rmac_slots(sizes, L):
        v = v + region_vec(y0, x0, wl, wl, valid)
    return v


POOLING_FNS: Dict[str, Callable] = {"mac": mac, "spoc": spoc, "gem": gem, "rmac": rmac}
