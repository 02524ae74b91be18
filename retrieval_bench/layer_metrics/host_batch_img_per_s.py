"""Images a second of the host pipeline alone (``make_input_batches`` over
the cell's lists, no device work), from the benchmark's span after the
traced window."""


def read(ctx):
    hb = ctx.counters.get("host_batch")
    if not hb or hb[1] <= 0:
        return None
    return hb[0] / hb[1]
