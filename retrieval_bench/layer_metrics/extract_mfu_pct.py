"""The whole extraction's share of the card's peak: the trunk's FLOPs at
each extracted image's own size at each scale (not the padded bucket, so
padding lowers it), over the traced window's wall time, over the peak of
the configuration's compute dtype (float32 runs with TF32 off)."""

import importlib

from retrieval_bench.roofline import flops_peak


def read(ctx):
    c, w = ctx.counters, ctx.window
    if w is None or w.wall_s <= 0 or not c.get("images"):
        return None
    arch = importlib.import_module(f"retrieval_bench.roofline.{c['arch']}")
    flops = 0
    for (h, wd), n in c["images"].items():
        flops += n * sum(arch.flops(max(int(h * s), 1), max(int(wd * s), 1)) for s in c["scales"])
    return 100.0 * flops / w.wall_s / flops_peak(c["dtype"])
