"""The descriptor of one database image under NetVLAD's
``vd16_pitts30k_conv5_3_vlad_preL2_intra_white`` (Arandjelovic et al., CVPR
2016) as hloc runs it (``hloc/extractors/netvlad.py``, Sarlin et al., CVPR
2019), in plain float32 PyTorch with TF32 off, one image at a time. It reads
the weights from a ``state_dict`` in cirtorch's layout: ``features.N`` the
torchvision-indexed VGG-16 convolutions, ``pool.centroids`` [K, C],
``pool.conv.weight`` [K, C, 1, 1] and ``pool.conv.bias`` [K] (the soft
assignment), ``whiten.weight`` [D, K C] and ``whiten.bias`` [D].

  trunk     VGG-16 cfg "D" to conv5_3, without its last ReLU and max-pool:
            stride 16, signed;
  preL2     each 512-d local descriptor x_n of the map's valid cells,
            x_n / max(||x_n||, 1e-12) (``F.normalize``);
  NetVLAD   a_nk = softmax_k(x_n . w_k + b_k); v_k = sum_n a_nk (x_n - c_k),
            the residuals summed as hloc sums them; each v_k L2-normalized
            (intra-normalization), then the K C vector;
  whitening y = W v + b (an FC layer), then L2N.

Departures from hloc, each the port's, kept here so the two compare:
  - bucket padding: the image is padded at the bottom and right to
    multiples of ``bucket`` and the map cells whose first pixel is padding
    are left out (``reference/extract.py``'s mask, taken at the map's
    stride), where hloc runs each image at its own size: a 683-row image
    keeps 43 rows of its 704-row bucket's 44 map rows, where alone it gives
    42;
  - ImageNet's mean and std on [0, 1] pixels, where the MatConvNet model
    subtracts its mean colour on 0-255 and scales nothing;
  - the intra-normalization and both L2Ns as ``v / (||v|| + 1e-6)``, where
    hloc's ``F.normalize`` takes ``v / max(||v||, 1e-12)``;
  - hloc's ``score_bias=False`` is a zero ``pool.conv.bias`` in the weights
    (the port's NetVLAD layer always holds a bias).

It imports nothing of the program, of the repository's tests or of JAX."""

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from retrieval_bench.reference.extract import L2N_EPS, MEAN, STD
from retrieval_bench.reference.lowp import ROUNDERS

# torchvision's vgg16 cfg "D": conv widths, "M" a 2x2 max-pool; the trunk
# ends at conv5_3, before the last max-pool
CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
CHANNELS = 512
PRE_L2_EPS = 1e-12

Rounder = Optional[Callable[[torch.Tensor], torch.Tensor]]


def param_shapes() -> List[Tuple[int, Tuple[int, int, int, int]]]:
    """(torchvision ``features`` index, weight shape) of each convolution, in
    order; a convolution's ReLU is the next index, a max-pool takes one."""
    out, idx, cin = [], 0, 3
    for v in CFG:
        if v == "M":
            idx += 1
        else:
            out.append((idx, (v, cin, 3, 3)))
            idx += 2
            cin = v
    return out


def trunk(x: torch.Tensor, sd: Dict[str, torch.Tensor], rnd: Rounder = None) -> torch.Tensor:
    """NCHW float32 pixels -> the [B, 512, H/16, W/16] map, conv5_3's output
    before its ReLU. ``rnd`` rounds both operands of every convolution (the
    trunk's control)."""
    convs = param_shapes()
    i = 0
    for v in CFG:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        idx = convs[i][0]
        w, b = sd[f"features.{idx}.weight"], sd[f"features.{idx}.bias"]
        if rnd is not None:
            x, w = rnd(x), rnd(w)
        x = F.conv2d(x, w, b, 1, 1)
        i += 1
        if i < len(convs):
            x = F.relu(x)
    return x


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + L2N_EPS)


def head(f: torch.Tensor, fm: torch.Tensor, sd: Dict[str, torch.Tensor],
         rnd: Rounder = None) -> torch.Tensor:
    """[C, h, w] map and its [h, w] bool mask of valid cells -> the [D]
    descriptor: preL2, NetVLAD over the valid cells, FC whitening, L2N.
    ``rnd`` rounds the operands of the soft assignment's product, of each
    residual's weighting and of the whitening's product (the head's
    control)."""
    r = rnd if rnd is not None else (lambda t: t)
    C = f.shape[0]
    x = F.normalize(f.permute(1, 2, 0)[fm], dim=1, eps=PRE_L2_EPS)  # [n, C], row-major cells
    cen = sd["pool.centroids"]
    K = cen.shape[0]
    w = sd["pool.conv.weight"].reshape(K, C)
    a = torch.softmax(r(x) @ r(w).T + sd["pool.conv.bias"], dim=1)  # [n, K]
    ra = r(a)
    v = torch.stack([(ra[:, k:k + 1] * r(x - cen[k])).sum(dim=0) for k in range(K)])  # [K, C]
    v = _l2n(_l2n(v).reshape(K * C))
    y = r(v) @ r(sd["whiten.weight"]).T + sd["whiten.bias"]
    return _l2n(y)


@torch.no_grad()
def descriptor(img_u8: np.ndarray, sd: Dict[str, torch.Tensor], image_size: int,
               bucket: int = 32, control: Optional[str] = None,
               head_control: Optional[str] = None, device="cuda") -> torch.Tensor:
    """[D] float32 descriptor of one HWC uint8 image whose longer side is
    ``image_size``. ``control`` names the lower precision of the trunk's
    convolutions, ``head_control`` that of the head's products."""
    h, w = img_u8.shape[:2]
    if max(h, w) != image_size:
        raise ValueError(f"the reference takes images at max side {image_size}, got {h}x{w}")
    H, W = -(-h // bucket) * bucket, -(-w // bucket) * bucket
    x = torch.zeros((1, 3, H, W), dtype=torch.float32, device=device)
    px = torch.as_tensor(img_u8, device=device).permute(2, 0, 1).float() / 255.0
    mean = torch.tensor(MEAN, device=device)[:, None, None]
    std = torch.tensor(STD, device=device)[:, None, None]
    x[0, :, :h, :w] = (px - mean) / std
    mask = torch.zeros((H, W), dtype=torch.bool, device=device)
    mask[:h, :w] = True
    f = trunk(x, sd, rnd=ROUNDERS[control] if control else None)[0]  # [C, fh, fw]
    fh, fw = f.shape[1:]
    fm = mask[:: H // fh, :: W // fw][:fh, :fw]
    return head(f, fm, sd, rnd=ROUNDERS[head_control] if head_control else None)
