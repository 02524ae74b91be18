"""The whole search call's share of the card's peak: the least time the
card needs for each call, the whitening's bound (``roofline/whiten.py``)
plus the exact search's (``roofline/fused_topk.py``), times the calls, over
the traced window's wall time."""

from retrieval_bench.roofline import fused_topk, whiten


def read(ctx):
    c, w = ctx.counters, ctx.window
    if w is None or w.wall_s <= 0 or not c.get("calls"):
        return None
    per_call = (whiten.work(c["nq"], c["d_in"], c["d"])["bound_s"]
                + fused_topk.work(c["nq"], c["ng"], c["d"], c["k"], c["storage"])["bound_s"])
    return 100.0 * c["calls"] * per_call / w.wall_s
