"""The bf16 BatchNorm + ReLU (+ residual) kernel (``bn_act``) over a
bottleneck ResNet trunk: the bytes one image needs, which bound it. Every
BatchNorm reads its convolution's bf16 output once and writes the result
once; the last BatchNorm of each block also reads the block's identity; and
each reads its mean, scale and bias, f32 a channel. The walk is
``_bottleneck.py``'s: the stem, then each block's three BatchNorms (bn1 at
the block's input size, bn2 and bn3 at its output size) and the
downsample's on the first block of a stage."""

from typing import List, Sequence, Tuple

from retrieval_bench.roofline import ELEMENT_BYTES, hbm_bytes_per_s
from retrieval_bench.roofline._bottleneck import EXPANSION, WIDTHS, conv_out

PARAM_BYTES = 3 * 4  # mean, scale, bias: f32 a channel


def trunk_bns(stages: Sequence[int], h: int, w: int) -> List[Tuple[int, int, bool]]:
    """(output elements, channels, reads the identity) of every BatchNorm of
    the trunk at an RGB input of ``h`` x ``w``, for one image."""
    h, w = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    bns = [(h * w * 64, 64, False)]
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)  # max-pool
    for i, (width, depth) in enumerate(zip(WIDTHS, stages)):
        out_c = width * EXPANSION
        for j in range(depth):
            stride = 2 if i > 0 and j == 0 else 1
            ho, wo = conv_out(h, 3, stride, 1), conv_out(w, 3, stride, 1)
            bns += [(h * w * width, width, False), (ho * wo * width, width, False),
                    (ho * wo * out_c, out_c, True)]
            if j == 0:
                bns.append((ho * wo * out_c, out_c, False))  # the downsample's
            h, w = ho, wo
    return bns


def image_bytes(stages: Sequence[int], h: int, w: int, dtype: str = "bfloat16") -> int:
    e = ELEMENT_BYTES[dtype]
    return sum(n * e * (3 if identity else 2) + c * PARAM_BYTES
               for n, c, identity in trunk_bns(stages, h, w))


def seconds(total_bytes: int) -> float:
    return total_bytes / hbm_bytes_per_s()
