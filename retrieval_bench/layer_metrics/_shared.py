"""Arithmetic shared by several readers."""

from typing import Optional


def idle_pct(ctx) -> Optional[float]:
    """The card's idle share of the traced window, in percent."""
    w = ctx.window
    if w is None or not w.kernels or w.wall_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.wall_s)
