"""The GeM head kernels' (B1, B2) share of their roofline: the bytes the
extracted images' head inputs need (``roofline/gem_l2n.py``) over the HBM
peak, over the device time of the kernels named ``gem_l2n_*``."""

import importlib

from retrieval_bench.roofline import gem_l2n

KERNELS = ("gem_l2n_kernel", "gem_l2n_finish")


def read(ctx):
    c, w = ctx.counters, ctx.window
    if w is None or not c.get("images"):
        return None
    t = w.kernel_s(*KERNELS)
    if t <= 0:
        return None
    arch = importlib.import_module(f"retrieval_bench.roofline.{c['arch']}")
    b = c["bucket"]
    total = 0
    for (h, wd), n in c["images"].items():
        H, W = -(-h // b) * b, -(-wd // b) * b
        for s in c["scales"]:
            Hs, Ws = gem_l2n.scaled(H, s), gem_l2n.scaled(W, s)
            fh, fw = arch.out_shape(Hs, Ws)
            cells = gem_l2n.valid_cells(gem_l2n.mask_rows(h, H, Hs), gem_l2n.mask_rows(wd, W, Ws),
                                       Hs, Ws, fh, fw)
            total += n * gem_l2n.image_bytes(cells, c["channels"], c["dtype"])
    return 100.0 * gem_l2n.seconds(total) / t
