"""The bf16 trunk's BatchNorm + ReLU (+ residual) kernel's share of its
roofline: the bytes every extracted image's BatchNorms need at its padded
bucket shape and each scale (``roofline/bn_act.py``), over the HBM peak,
over the device time of the kernels named ``bn_act*``. Padding images of a
partial batch are work left out of the count, so the share errs low. None
off bfloat16, for a trunk with no bottleneck walk, or where the window
holds no such kernel."""

import importlib

from retrieval_bench.roofline import bn_act, gem_l2n


def read(ctx):
    c, w = ctx.counters, ctx.window
    if w is None or c.get("dtype") != "bfloat16" or not c.get("images"):
        return None
    arch = importlib.import_module(f"retrieval_bench.roofline.{c['arch']}")
    stages = getattr(arch, "STAGES", None)
    t = w.kernel_s("bn_act")
    if stages is None or t <= 0:
        return None
    b = c["bucket"]
    total = 0
    for (h, wd), n in c["images"].items():
        H, W = -(-h // b) * b, -(-wd // b) * b
        for s in c["scales"]:
            total += n * bn_act.image_bytes(stages, gem_l2n.scaled(H, s), gem_l2n.scaled(W, s))
    return 100.0 * bn_act.seconds(total) / t
