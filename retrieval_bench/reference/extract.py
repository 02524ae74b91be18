"""The descriptor of one database image, by the published pipeline: the
image (already at its max-side size) padded at the bottom and right to the
bucket grid, ImageNet-normalized with the padding zero, at each scale a
bilinear resize (half-pixel centres, no antialiasing) of the padded image
and a nearest resize of its mask, the trunk, GeM over the map's valid cells
(the mask taken at the map's stride), L2N, and over several scales the
power mean with GeM's exponent and L2N again (cirtorch's ``extract_ms``).
All float32, TF32 off, one image at a time."""

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from retrieval_bench.reference.lowp import ROUNDERS
from retrieval_bench.reference.resnet import trunk

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
GEM_EPS = 1e-6
L2N_EPS = 1e-6


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + L2N_EPS)


def _nearest(mask: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize: output row i reads input row floor((i + 0.5) * H / h),
    computed in float32."""
    H, W = mask.shape

    def src(n_in, n_out):
        pos = (torch.arange(n_out, dtype=torch.float32, device=mask.device) + 0.5) * n_in / n_out
        return torch.floor(pos).long()

    return mask[src(H, size[0])][:, src(W, size[1])]


@torch.no_grad()
def descriptor(img_u8: np.ndarray, sd: Dict[str, torch.Tensor], arch: str, image_size: int,
               scales: Sequence[float], p: float, bucket: int = 32,
               control: Optional[str] = None, device="cuda") -> torch.Tensor:
    """[D] float32 descriptor of one HWC uint8 image whose longer side is
    ``image_size``; ``control`` names the lower precision of a control."""
    h, w = img_u8.shape[:2]
    if max(h, w) != image_size:
        raise ValueError(f"the reference takes images at max side {image_size}, got {h}x{w}")
    rnd = ROUNDERS[control] if control else None
    H, W = -(-h // bucket) * bucket, -(-w // bucket) * bucket
    x = torch.zeros((1, 3, H, W), dtype=torch.float32, device=device)
    px = torch.as_tensor(img_u8, device=device).permute(2, 0, 1).float() / 255.0
    mean = torch.tensor(MEAN, device=device)[:, None, None]
    std = torch.tensor(STD, device=device)[:, None, None]
    x[0, :, :h, :w] = (px - mean) / std
    mask = torch.zeros((H, W), dtype=torch.bool, device=device)
    mask[:h, :w] = True
    descs = []
    for s in sorted(scales, reverse=True):
        xs, ms = x, mask
        if s != 1.0:
            size = (max(int(H * s), 32), max(int(W * s), 32))
            xs = F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                               antialias=False)
            ms = _nearest(mask, size)
        f = trunk(xs, sd, arch, rnd=rnd)[0]                         # [C, fh, fw]
        fh, fw = f.shape[1:]
        fm = ms[:: xs.shape[2] // fh, :: xs.shape[3] // fw][:fh, :fw]
        xp = torch.clamp(f, min=GEM_EPS) ** p
        pooled = (xp * fm).sum(dim=(1, 2)) / fm.sum().clamp(min=1)
        descs.append(_l2n(pooled ** (1.0 / p)))
    if len(descs) == 1:
        return descs[0]
    acc = torch.stack([torch.clamp(d, min=0.0) ** p for d in descs]).mean(dim=0)
    return _l2n(acc ** (1.0 / p))


def compare(program: np.ndarray, reference: np.ndarray) -> dict:
    """The extraction cells' numbers: the largest L2 distance between a
    program descriptor and the reference's (unit rows, so 2 is the most),
    infinite where a row is not finite."""
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    dist = np.linalg.norm(program - reference, axis=1)
    dist[~np.isfinite(dist)] = np.inf
    return {"desc_l2_max": float(dist.max()) if dist.size else float("inf")}
