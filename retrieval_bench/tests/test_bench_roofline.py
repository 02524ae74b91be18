"""The operation and byte counts, against counts worked out by hand."""

import pytest

from retrieval_bench.roofline import fused_topk, gem_l2n, resnet50, resnet101, whiten
from retrieval_bench.roofline._bottleneck import trunk_macs


def _resnet50_224_by_hand() -> int:
    """Every convolution of resnet50 at 224 x 224, written out: (output
    cells, in channels x kernel area, out channels)."""
    stem = 112 * 112 * (3 * 49) * 64
    total = stem
    # stage: (map side in, map side out, width, blocks, in channels of block 0)
    for side_in, side, width, blocks, cin in ((56, 56, 64, 3, 64), (56, 28, 128, 4, 256),
                                              (28, 14, 256, 6, 512), (14, 7, 512, 3, 1024)):
        for j in range(blocks):
            c_in = cin if j == 0 else 4 * width
            s_in = side_in if j == 0 else side
            total += s_in * s_in * c_in * width        # 1x1 reduce
            total += side * side * width * 9 * width    # 3x3
            total += side * side * width * 4 * width    # 1x1 expand
            if j == 0:
                total += side * side * cin * 4 * width  # projection shortcut
    return total


def test_resnet50_at_224():
    macs, shape = trunk_macs(resnet50.STAGES, 224, 224)
    assert macs == _resnet50_224_by_hand() == 4_087_136_256  # ~4.1 GMAC, torchvision's 4.09 with its FC
    assert shape == (7, 7)
    assert resnet50.flops(224, 224) == 2 * macs
    assert 112 * 112 * 147 * 64 == 118_013_952  # the stem


def test_resnet101_at_224_and_odd_sizes():
    assert trunk_macs(resnet101.STAGES, 224, 224)[0] == 7_799_357_440  # torchvision: 7.80 GMAC
    assert resnet101.out_shape(683, 1024) == (22, 32)
    assert resnet101.out_shape(704, 1024) == (22, 32)
    assert resnet50.out_shape(724, 543) == (23, 17)


def test_fused_topk_bytes_and_flops():
    w = fused_topk.work(20, 1_000_000, 2048, 100, "bfloat16")
    assert w["bytes"] == 1_000_000 * 2048 * 2 + 20 * 2048 * 4 + 20 * 100 * 8
    assert w["flops"] == 2 * 20 * 1_000_000 * 2048
    assert w["bound_s"] == pytest.approx(w["bytes"] / 3.35e12)  # bytes bound at 20 queries
    assert fused_topk.work(1, 10, 4, 100, "float32")["bytes"] == 10 * 4 * 4 + 4 * 4 + 10 * 8


def test_whiten_counts():
    w = whiten.work(20, 2048, 2048)
    assert w["flops"] == 2 * 20 * 2048 * 2048
    assert w["bytes"] == 4 * (20 * 2048 + 2048 + 2048 * 2048 + 20 * 2048)


def test_gem_l2n_cells_and_bytes():
    # 683 valid rows in a 704-row bucket, a 22-row map at stride 32: row 21
    # starts at pixel 672 < 683, so every row is valid
    assert gem_l2n.valid_cells(683, 1024, 704, 1024, 22, 32) == 22 * 32
    assert gem_l2n.valid_cells(600, 1024, 704, 1024, 22, 32) == 19 * 32
    assert gem_l2n.image_bytes(22 * 32, 2048, "bfloat16") == 704 * 2048 * 2 + 2048 * 4 + 12
