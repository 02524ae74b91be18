"""Device milliseconds an image: the card's busy time over the traced
window (trunk, head and every other operation) over the images it
extracted."""


def read(ctx):
    w, n = ctx.window, sum(ctx.counters.get("images", {}).values())
    if w is None or not w.kernels or n == 0:
        return None
    return 1e3 * w.busy_s() / n
