"""The card's idle share of the traced extraction window spent while the
main thread was in the program's ``Extractor.next_batch`` spans, in percent."""

from retrieval_bench.layer_metrics._spans import extract_idle_pct


def read(ctx):
    return extract_idle_pct(ctx, "Extractor.next_batch")
