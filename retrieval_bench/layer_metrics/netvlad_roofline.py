"""The NetVLAD head kernels' (B5, B6) share of their roofline: the bound of
the extracted images' aggregations (``roofline/netvlad.py``, each image's
valid map rows by ``roofline/gem_l2n.py::valid_cells`` at its architecture's
``out_shape``) over the device time of the six kernels of
``csrc/netvlad.cu``. None where the counters name no clusters (not a NetVLAD
cell) or the window holds none of those kernels."""

import importlib

from retrieval_bench.roofline import gem_l2n, netvlad

KERNELS = ("netvlad_split_w", "netvlad_logits", "netvlad_softmax", "netvlad_aggregate",
           "netvlad_residual", "netvlad_scale")


def read(ctx):
    c, w = ctx.counters, ctx.window
    if w is None or not c.get("images") or not c.get("clusters"):
        return None
    t = w.kernel_s(*KERNELS)
    if t <= 0:
        return None
    arch = importlib.import_module(f"retrieval_bench.roofline.{c['arch']}")
    b = c["bucket"]
    total = 0.0
    for (h, wd), n in c["images"].items():
        H, W = -(-h // b) * b, -(-wd // b) * b
        for s in c["scales"]:
            Hs, Ws = gem_l2n.scaled(H, s), gem_l2n.scaled(W, s)
            fh, fw = arch.out_shape(Hs, Ws)
            cells = gem_l2n.valid_cells(gem_l2n.mask_rows(h, H, Hs), gem_l2n.mask_rows(wd, W, Ws),
                                       Hs, Ws, fh, fw)
            total += n * netvlad.work(cells, c["channels"], c["clusters"])["bound_s"]
    return 100.0 * total / t
