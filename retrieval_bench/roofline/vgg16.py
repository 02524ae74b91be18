"""VGG-16's trunk as the retrieval models cut it (torchvision's cfg "D" to
conv5_3, without the last max-pool): FLOPs (2 per multiply-add) of its 13
3x3 convolutions at an input of h x w (biases and ReLUs not counted), and
its output map's shape, stride 16 (each 2x2 max-pool floors an odd side)."""

from typing import Tuple

CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
CHANNELS = 512


def trunk_macs(h: int, w: int) -> Tuple[int, Tuple[int, int]]:
    """(multiply-adds of every convolution, (rows, cols) of the output map)
    for an RGB input of ``h`` x ``w``; a padded 3x3 convolution keeps the
    size."""
    macs, cin = 0, 3
    for v in CFG:
        if v == "M":
            h, w = h // 2, w // 2
        else:
            macs += h * w * cin * v * 9
            cin = v
    return macs, (h, w)


def flops(h: int, w: int) -> int:
    return 2 * trunk_macs(h, w)[0]


def out_shape(h: int, w: int):
    return trunk_macs(h, w)[1]
