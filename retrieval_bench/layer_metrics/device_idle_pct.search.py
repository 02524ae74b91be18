"""The card's idle share of the traced search window (the host's part of
each call): 1 - busy / wall, busy the union of its operations."""

from retrieval_bench.layer_metrics._shared import idle_pct


def read(ctx):
    return idle_pct(ctx)
