"""Everything a cell runs on, made from ``--seed`` on the card (or the
device a test gives): random weights, the whitening, the gallery, the
query pool and the image pool. Each kind draws from its own generator, so
the reference can make any of them again after the program is freed, to
the same bits."""

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from retrieval_bench.reference.resnet import param_shapes

_TAGS = {"weights": 1, "whitening": 2, "gallery": 3, "queries": 4, "images": 5, "order": 6,
         "check": 7}


def sub_seed(seed: int, kind: str) -> int:
    return (int(seed) * 1_000_003 + _TAGS[kind]) % (2 ** 63)


def generator(seed: int, kind: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, kind))
    return g


def rng(seed: int, kind: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, kind))


@torch.no_grad()
def state_dict(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """cirtorch's layout (``features.`` + torchvision names, ``pool.p``),
    float32 on ``device``: He-normal convolutions from one draw, the
    BatchNorms from two."""
    g = generator(seed, "weights", device)
    convs, bns = param_shapes(cfg["model"]["arch"])
    n_conv = sum(math.prod(s) for _, s in convs)
    flat = torch.randn(n_conv, generator=g, device=device)
    sd, at = {}, 0
    for key, shape in convs:
        n = math.prod(shape)
        fan_in = n // shape[0]
        sd[f"features.{key}.weight"] = flat[at : at + n].view(shape) * (2.0 / fan_in) ** 0.5
        at += n
    n_bn = sum(c for _, c in bns)
    u = torch.rand((2, n_bn), generator=g, device=device)
    z = torch.randn((2, n_bn), generator=g, device=device)
    lo3, hi3 = cfg["weights"]["bn3_gamma"]
    at = 0
    for key, c in bns:
        sl = slice(at, at + c)
        gamma = (lo3 + (hi3 - lo3) * u[0, sl]) if key.endswith("bn3") else 0.5 + 0.5 * u[0, sl]
        p = f"features.{key}."
        sd[p + "weight"] = gamma
        sd[p + "bias"] = 0.1 * z[0, sl]
        sd[p + "running_mean"] = 0.1 * z[1, sl]
        sd[p + "running_var"] = 0.5 + u[1, sl]
        sd[p + "num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
        at += c
    sd["pool.p"] = torch.full((1,), float(cfg["model"]["gem_p"]), device=device)
    return sd


@torch.no_grad()
def whitening(cfg: dict, seed: int, device) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """A PCA whitening ``P = diag(lam^-1/2) V^T`` with ``V`` orthogonal and
    a decaying spectrum, and its mean ``m``: (m, P) as float32 host arrays,
    and ``V diag(lam^1/2)`` on the device, which maps whitened rows back to
    raw descriptors."""
    w, d = cfg["whitening"], cfg["index"]["whiten_in"]
    g = generator(seed, "whitening", device)
    v, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=device, dtype=torch.float64))
    lam = (torch.arange(d, device=device, dtype=torch.float64) + 1.0) ** -w["eigenvalue_decay"]
    lam = torch.clamp(lam, min=w["eigenvalue_floor"])
    m = 0.02 * torch.rand(d, generator=g, device=device, dtype=torch.float64)
    P = torch.diag(lam ** -0.5) @ v.T
    back = v @ torch.diag(lam ** 0.5)
    return (m.float().cpu().numpy(), P.float().cpu().numpy(), back.float())


@torch.no_grad()
def gallery(cfg: dict, seed: int, device, block: int = 65536) -> torch.Tensor:
    """[rows, D] unit rows in the storage dtype: cluster centres plus noise
    of norm ~``spread``, normalized."""
    gc, d = cfg["gallery"], cfg["index"]["whiten_out"]
    rows = cfg["index"]["gallery_rows"]
    dtype = getattr(torch, cfg["index"]["storage"])
    g = generator(seed, "gallery", device)
    centres = torch.randn((gc["clusters"], d), generator=g, device=device)
    centres /= centres.norm(dim=1, keepdim=True)
    out = torch.empty((rows, d), dtype=dtype, device=device)
    for s in range(0, rows, block):
        n = min(block, rows - s)
        a = torch.randint(0, gc["clusters"], (n,), generator=g, device=device)
        x = centres[a] + (gc["spread"] / d ** 0.5) * torch.randn((n, d), generator=g, device=device)
        out[s : s + n] = (x / x.norm(dim=1, keepdim=True)).to(dtype)
    return out


@torch.no_grad()
def queries(cfg: dict, n: int, seed: int, gal: torch.Tensor, back: torch.Tensor,
            m: np.ndarray) -> np.ndarray:
    """[n, D] raw float32 query descriptors on the host: noisy copies of
    random gallery rows, mapped back through the whitening."""
    dev = gal.device
    g = generator(seed, "queries", dev)
    d = gal.shape[1]
    rows = torch.randint(0, gal.shape[0], (n,), generator=g, device=dev)
    y = gal[rows].float()
    y = y + (cfg["queries"]["noise"] / d ** 0.5) * torch.randn((n, d), generator=g, device=dev)
    raw = y @ back.T + torch.as_tensor(m, device=dev)
    return raw.cpu().numpy()


@torch.no_grad()
def images(cfg: dict, per_shape: int, seed: int, device) -> Dict[Tuple[int, int], List[np.ndarray]]:
    """``per_shape`` textured HWC uint8 images of each of the configuration's
    shapes: smooth colour fields plus finer noise at two scales."""
    g = generator(seed, "images", device)
    pool = {}
    for h, w in cfg["images"]["shapes"]:
        x = torch.full((per_shape, 3, h, w), 128.0, device=device)
        for div, amp in ((32, 60.0), (8, 30.0), (1, 15.0)):
            n = torch.randn((per_shape, 3, -(-h // div), -(-w // div)), generator=g, device=device)
            if div > 1:
                n = F.interpolate(n, size=(h, w), mode="bilinear", align_corners=False)
            x += amp * n
        u8 = torch.clamp(x.round(), 0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
        pool[(h, w)] = [np.ascontiguousarray(u8[i]) for i in range(per_shape)]
    return pool


def image_list(cfg: dict, per_shape: int, n: int, seed: int,
               index: int) -> List[Tuple[Tuple[int, int], int]]:
    """List ``index`` of a run: ``n`` (shape, pool position) pairs in the
    configuration's mix of shapes, in a seeded order."""
    shapes = [tuple(s) for s in cfg["images"]["shapes"]]
    mix = cfg["images"]["mix"]
    r = np.random.default_rng([sub_seed(seed, "order"), index])
    out = []
    for shape, share in zip(shapes, mix):
        count = n * share // sum(mix)
        out += [(shape, int(j)) for j in r.integers(0, per_shape, count)]
    r.shuffle(out)
    return out
