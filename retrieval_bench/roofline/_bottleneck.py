"""Convolution multiply-adds of a bottleneck ResNet trunk (torchvision's
v1.5: the stride on the 3x3 convolution), as a function of the input's
height and width. No pooling head, no classifier: the retrieval trunk ends
at layer4."""

from typing import Sequence, Tuple

WIDTHS = (64, 128, 256, 512)
EXPANSION = 4


def conv_out(n: int, k: int, s: int, p: int) -> int:
    """Output length of a convolution or pooling window along one axis."""
    return (n + 2 * p - k) // s + 1


def trunk_macs(stages: Sequence[int], h: int, w: int) -> Tuple[int, Tuple[int, int]]:
    """(multiply-adds of every convolution, (rows, cols) of the output map)
    for an RGB input of ``h`` x ``w``."""
    macs = 0
    h, w = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    macs += h * w * 64 * 3 * 7 * 7
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)  # max-pool
    cin = 64
    for i, (width, depth) in enumerate(zip(WIDTHS, stages)):
        for j in range(depth):
            stride = 2 if i > 0 and j == 0 else 1
            ho, wo = conv_out(h, 3, stride, 1), conv_out(w, 3, stride, 1)
            macs += h * w * cin * width               # conv1, 1x1
            macs += ho * wo * width * width * 9       # conv2, 3x3, strided
            macs += ho * wo * width * width * EXPANSION  # conv3, 1x1
            if j == 0:
                macs += ho * wo * cin * width * EXPANSION  # downsample, 1x1 strided
            cin = width * EXPANSION
            h, w = ho, wo
    return macs, (h, w)
