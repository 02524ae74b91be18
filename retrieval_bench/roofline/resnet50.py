"""ResNet-50's trunk: FLOPs (2 per multiply-add) of its convolutions at an
input of h x w, and its output map's shape."""

from retrieval_bench.roofline._bottleneck import trunk_macs

STAGES = (3, 4, 6, 3)
CHANNELS = 2048


def flops(h: int, w: int) -> int:
    return 2 * trunk_macs(STAGES, h, w)[0]


def out_shape(h: int, w: int):
    return trunk_macs(STAGES, h, w)[1]
