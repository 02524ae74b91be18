"""A bottleneck ResNet trunk (torchvision's v1.5, as cirtorch uses it) in
plain functional PyTorch, read from a ``state_dict`` with torchvision's
names under a prefix (cirtorch's ``features.``): conv 7x7/2, BN, ReLU,
max-pool 3x3/2, layer1..layer4, inference BatchNorm (eps 1e-5)."""

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
WIDTHS = (64, 128, 256, 512)
EXPANSION = 4
BN_EPS = 1e-5


def _blocks(arch: str):
    """(key prefix, in channels, width, stride, has downsample) per block."""
    cin = 64
    for i, (width, depth) in enumerate(zip(WIDTHS, STAGES[arch])):
        for j in range(depth):
            yield f"layer{i + 1}.{j}.", cin, width, 2 if i > 0 and j == 0 else 1, j == 0
            cin = width * EXPANSION


def param_shapes(arch: str) -> Tuple[List[Tuple[str, tuple]], List[Tuple[str, int]]]:
    """The trunk's convolutions ``(key, weight shape)`` and BatchNorms
    ``(key, channels)``, in order."""
    convs = [("conv1", (64, 3, 7, 7))]
    bns = [("bn1", 64)]
    for b, cin, width, _, ds in _blocks(arch):
        convs += [(b + "conv1", (width, cin, 1, 1)), (b + "conv2", (width, width, 3, 3)),
                  (b + "conv3", (width * EXPANSION, width, 1, 1))]
        bns += [(b + "bn1", width), (b + "bn2", width), (b + "bn3", width * EXPANSION)]
        if ds:
            convs.append((b + "downsample.0", (width * EXPANSION, cin, 1, 1)))
            bns.append((b + "downsample.1", width * EXPANSION))
    return convs, bns


def trunk(x: torch.Tensor, sd: Dict[str, torch.Tensor], arch: str, prefix: str = "features.",
          rnd: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """NCHW float32 pixels -> the [B, 2048, h, w] map. ``rnd`` rounds both
    operands of every convolution (the controls)."""

    def conv(t, key, stride, pad):
        w = sd[prefix + key + ".weight"]
        if rnd is not None:
            t, w = rnd(t), rnd(w)
        return F.conv2d(t, w, None, stride, pad)

    def bn(t, key):
        p = prefix + key
        return F.batch_norm(t, sd[p + ".running_mean"], sd[p + ".running_var"],
                            sd[p + ".weight"], sd[p + ".bias"], False, 0.0, BN_EPS)

    x = F.max_pool2d(F.relu(bn(conv(x, "conv1", 2, 3), "bn1")), 3, 2, 1)
    for b, _, _, stride, ds in _blocks(arch):
        idn = bn(conv(x, b + "downsample.0", stride, 0), b + "downsample.1") if ds else x
        y = F.relu(bn(conv(x, b + "conv1", 1, 0), b + "bn1"))
        y = F.relu(bn(conv(y, b + "conv2", stride, 1), b + "bn2"))
        y = bn(conv(y, b + "conv3", 1, 0), b + "bn3")
        x = F.relu(y + idn)
    return x
