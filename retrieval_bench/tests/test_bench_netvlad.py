"""The NetVLAD configuration's pieces that its cell's runs do not check by
themselves: VGG-16's convolution count and map shapes and the NetVLAD
head's work, against counts worked out by hand; ``netvlad_roofline``'s
reader on a window with hand-placed kernels; the plain reference loading
nothing of the program; the cell's window with every batch on the rect
kernel's route."""

import types

import pytest
import torch

from retrieval_bench import harness
from retrieval_bench import trace as tr_mod
from retrieval_bench.roofline import gem_l2n, netvlad, vgg16
from retrieval_bench.tests.test_bench_imports import FORBIDDEN, PORT, _modules_after
from retrieval_bench.tests.tiny import tiny

CELL = "vgg16-netvlad-pitts30k.extract-db-netvlad"


def _vgg16_224_by_hand() -> int:
    """Every convolution of VGG-16 at 224 x 224, written out: (map side,
    in channels, out channels), 9 taps each."""
    layers = [(224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
              (56, 128, 256), (56, 256, 256), (56, 256, 256),
              (28, 256, 512), (28, 512, 512), (28, 512, 512),
              (14, 512, 512), (14, 512, 512), (14, 512, 512)]
    return sum(side * side * cin * cout * 9 for side, cin, cout in layers)


def test_vgg16_at_224():
    macs, shape = vgg16.trunk_macs(224, 224)
    assert macs == _vgg16_224_by_hand() == 15_346_630_656  # torchvision: 15.47 GMAC with its FCs
    assert shape == (14, 14)
    assert vgg16.flops(224, 224) == 2 * macs


def test_vgg16_map_shapes_at_aachens_sizes():
    assert vgg16.out_shape(768, 1024) == (48, 64)
    assert vgg16.out_shape(1024, 768) == (64, 48)
    # 683 -> 341 -> 170 -> 85 -> 42 rows alone; the 704-row bucket gives 44,
    # of which 43 hold a valid first pixel (row 42 starts at pixel 672 < 683)
    assert vgg16.out_shape(683, 1024) == (42, 64)
    assert vgg16.out_shape(704, 1024) == (44, 64)
    assert gem_l2n.valid_cells(683, 1024, 704, 1024, 44, 64) == 43 * 64
    assert vgg16.flops(768, 1024) == 481_069_891_584


def test_netvlad_work_written_out():
    # a 768 x 1024 image: 48 x 64 = 3,072 valid rows of C = 512, K = 64
    w = netvlad.work(3072, 512, 64)
    assert w["flops"] == 2 * (2 * 3072 * 512 * 64) == 402_653_184
    assert w["bytes"] == 3072 * 512 * 4 + 512 * 64 * 4 + 64 * 512 * 4 + 64 * 512 * 4
    assert w["flops_s"] == pytest.approx(402_653_184 / (495e12 / 3))
    assert w["bound_s"] == w["flops_s"]  # bound by the operations: 2.44 us against 2.00
    assert w["bytes_s"] == pytest.approx(6_684_672 / 3.35e12)


def _ctx(kernels, counters):
    w = tr_mod.Window()
    w.kernels, w.wall_s = kernels, 1.0
    return types.SimpleNamespace(window=w, counters=counters, cell=CELL)


COUNTERS = {"images": {(768, 1024): 3, (683, 1024): 2}, "arch": "vgg16", "channels": 512,
            "clusters": 64, "scales": [1.0], "bucket": 32}


def test_netvlad_roofline_reader():
    reader = harness.load_module("layer_metrics", "netvlad_roofline")
    kernels = [("netvlad_logits(Args)", 0.0, 2e-5), ("netvlad_aggregate(Args)", 2e-5, 5e-5),
               ("netvlad_softmax(Args)", 5e-5, 6e-5), ("sgemm_128x64", 6e-5, 1e-3),
               ("netvlad_split_w(Args)", 1e-3, 1.001e-3),
               ("netvlad_residual(Args)", 0.1, 0.1 + 1e-5),
               ("netvlad_scale(Args)", 0.2, 0.2 + 1e-5)]
    t = 2e-5 + 3e-5 + 1e-5 + 1e-6 + 1e-5 + 1e-5
    bound = (3 * netvlad.work(48 * 64, 512, 64)["bound_s"]
             + 2 * netvlad.work(43 * 64, 512, 64)["bound_s"])
    assert reader.read(_ctx(kernels, COUNTERS)) == pytest.approx(100 * bound / t)
    assert reader.read(_ctx([("sgemm_128x64", 0.0, 1.0)], COUNTERS)) is None
    assert reader.read(_ctx(kernels, {**COUNTERS, "clusters": None})) is None  # a GeM cell
    assert reader.read(types.SimpleNamespace(window=None, counters=COUNTERS, cell=CELL)) is None


def test_the_netvlad_reference_loads_nothing_of_the_program():
    loaded = _modules_after("from retrieval_bench.reference import vgg_netvlad\n"
                            "from retrieval_bench.roofline import vgg16, netvlad")
    assert PORT not in loaded and not loaded & FORBIDDEN, loaded


def test_window_puts_every_batch_on_the_rect_kernel(monkeypatch):
    """The cell's tiny window of one list (8 images of four shapes, all in
    the 64 x 64 bucket, batches of 2): its counters name each of the 4
    NetVLAD calls on ``kernel_rect`` (the bucketing's masks are rectangles)
    and none on another route. On the CPU the entries run their plain
    version and count no launch, so here the head's calls to them count
    one, as a launch on the card does."""
    from image_retrieval_for_image_based_localization_tpu_torch.models import retrieval_net

    for name in ("netvlad_fused", "netvlad_fused_rect"):
        def counted(*a, _fn=getattr(retrieval_net, name), **k):
            _fn.launches += 1
            return _fn(*a, **k)
        monkeypatch.setattr(retrieval_net, name, counted)
    _, _, cfg, traffic = harness.resolve(CELL, harness.load_benchmark(), tiny(CELL))
    cell = harness.load_module("drivers", traffic["driver"]).Cell(cfg, traffic, 2 ** 31 + 99,
                                                                  torch.device("cpu"))
    with torch.no_grad():
        cell.setup()
        cell.window(0.0)
    c = cell.counters()
    assert c["netvlad_routes"] == {"kernel_full": 0, "kernel_rect": 4, "plain": 0}
    assert (c["arch"], c["channels"], c["clusters"], c["whiten_dim"]) == ("vgg16", 512, 8, 32)
