"""The wait for a list's first batch (the host's up-front pass over the
list before ``make_batches`` yields), in ms: the median over the traced
window's ``Extractor.extract`` calls of the first ``Extractor.next_batch``
span in each."""

from retrieval_bench.layer_metrics._spans import first_batch_ms


def read(ctx):
    return first_batch_ms(ctx)
