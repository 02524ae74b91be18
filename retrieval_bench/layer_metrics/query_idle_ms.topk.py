"""The card's idle time a search call while the main thread was in the
program's ``Index.topk`` span, in ms."""

from retrieval_bench.layer_metrics._spans import query_idle_ms


def read(ctx):
    return query_idle_ms(ctx, "Index.topk")
