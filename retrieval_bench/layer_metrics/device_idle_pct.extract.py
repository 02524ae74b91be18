"""The card's idle share of the traced extraction window (host batching
holds it back): 1 - busy / wall, busy the union of its operations."""

from retrieval_bench.layer_metrics._shared import idle_pct


def read(ctx):
    return idle_pct(ctx)
