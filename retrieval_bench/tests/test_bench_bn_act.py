"""``bn_act_roofline``'s pieces: the bytes ``roofline/bn_act.py`` counts for
a bottleneck trunk's BatchNorms, against a count worked out by hand; the
reader on windows with hand-placed kernels, and None where there is nothing
to read."""

import types

import pytest

from retrieval_bench import harness
from retrieval_bench import trace as tr_mod
from retrieval_bench.roofline import bn_act, resnet50, resnet101

CELL = "aachen-1m-pod.extract-db"


def _resnet50_64_by_hand() -> int:
    """Every BatchNorm of resnet50 at 64 x 64, written out: (output cells,
    channels, reads the identity), 2 bytes an element, output read and
    written, the identity read, 12 bytes a channel."""
    bns = [(32 * 32, 64, False)]  # the stem; max-pool to 16 x 16
    # stage: (map side in, map side out, width, blocks)
    for side_in, side, width, blocks in ((16, 16, 64, 3), (16, 8, 128, 4), (8, 4, 256, 6),
                                         (4, 2, 512, 3)):
        for j in range(blocks):
            s_in = side_in if j == 0 else side
            bns += [(s_in * s_in, width, False), (side * side, width, False),
                    (side * side, 4 * width, True)]
            if j == 0:
                bns.append((side * side, 4 * width, False))
    assert len(bns) == 53 and sum(1 for b in bns if b[2]) == 16
    return sum(cells * c * 2 * (3 if ident else 2) + 12 * c for cells, c, ident in bns)


def test_resnet50_bytes_at_64():
    assert bn_act.image_bytes(resnet50.STAGES, 64, 64) == _resnet50_64_by_hand()
    assert len(bn_act.trunk_bns(resnet50.STAGES, 64, 64)) == 53


def test_resnet101_at_aachens_buckets():
    bns = bn_act.trunk_bns(resnet101.STAGES, 1024, 768)
    assert len(bns) == 104 and sum(1 for b in bns if b[2]) == 33
    assert bns[0] == (512 * 384 * 64, 64, False)
    assert bns[-1] == (32 * 24 * 2048, 2048, True)
    # ~1.3 GB an image: ~0.39 ms at 3.35 TB/s
    assert 1.2e9 < bn_act.image_bytes(resnet101.STAGES, 1024, 768) < 1.4e9


def _ctx(kernels, counters):
    w = tr_mod.Window()
    w.kernels, w.wall_s = kernels, 1.0
    return types.SimpleNamespace(window=w, counters=counters, cell=CELL)


COUNTERS = {"images": {(768, 1024): 3, (683, 1024): 2}, "arch": "resnet101",
            "dtype": "bfloat16", "channels": 2048, "scales": [1.0], "bucket": 32}


def test_bn_act_roofline_reader():
    reader = harness.load_module("layer_metrics", "bn_act_roofline")
    kernels = [("void bn_act_kernel<true, true>(uint4 const*)", 0.0, 2e-3),
               ("sm90_xmma_fprop_implicit_gemm_bf16", 2e-3, 5e-3),
               ("void bn_act_kernel<false, false>(uint4 const*)", 5e-3, 6e-3)]
    want = (3 * bn_act.image_bytes(resnet101.STAGES, 768, 1024)
            + 2 * bn_act.image_bytes(resnet101.STAGES, 704, 1024)) / 3.35e12
    assert reader.read(_ctx(kernels, COUNTERS)) == pytest.approx(100 * want / 3e-3)


def test_bn_act_roofline_reader_finds_nothing():
    reader = harness.load_module("layer_metrics", "bn_act_roofline")
    kernels = [("void bn_act_kernel<true, true>(uint4 const*)", 0.0, 2e-3)]
    assert reader.read(_ctx(kernels, {**COUNTERS, "dtype": "float32"})) is None
    assert reader.read(_ctx([("elementwise_kernel_128", 0.0, 1.0)], COUNTERS)) is None
    assert reader.read(_ctx(kernels, {**COUNTERS, "arch": "vgg16"})) is None
    assert reader.read(types.SimpleNamespace(window=None, counters=COUNTERS, cell=CELL)) is None
