"""The exact-search kernel's (B4) share of its roofline: each call's bound
(``roofline/fused_topk.py``: bytes or FLOPs, whichever is larger) times
the calls, over the device time of the kernels named ``topk_split_*`` and
``topk_merge_*`` in the traced window."""

from retrieval_bench.roofline import fused_topk

KERNELS = ("topk_split_kernel", "topk_split_narrow", "topk_merge_kernel")


def read(ctx):
    c, w = ctx.counters, ctx.window
    if w is None or not c.get("calls"):
        return None
    t = w.kernel_s(*KERNELS)
    if t <= 0:
        return None
    bound = fused_topk.work(c["nq"], c["ng"], c["d"], c["k"], c["storage"])["bound_s"]
    return 100.0 * c["calls"] * bound / t
