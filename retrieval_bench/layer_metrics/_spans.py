"""The card's idle time inside the program's own spans: the main thread's
ranges of one name (``utils.metrics.span`` in the program, recorded in
``ctx.window.host``) less the union of the card's operations
(``ctx.window.kernels``), on the profiler's one clock. A program without
such spans gives nothing to read, and the readers return None."""

import bisect
import statistics
from typing import List, Optional, Tuple

Interval = Tuple[float, float]


def union(intervals) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time as ``intervals``."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_s(spans, busy) -> float:
    """Seconds of the union of ``spans`` that the union of ``busy`` leaves
    uncovered."""
    spans, busy = union(spans), union(busy)
    idle, j = 0.0, 0
    for s, e in spans:
        covered = 0.0
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        idle += (e - s) - covered
    return idle


def spans(window, name: str) -> List[Interval]:
    """The main thread's spans named ``name``, in order of their start."""
    return sorted((s, e) for n, s, e in window.host if n == name)


def inside(inner, outer) -> List[Interval]:
    """The intervals of ``inner`` that lie wholly inside one of ``outer``."""
    outer = union(outer)
    starts = [o0 for o0, _ in outer]
    out = []
    for s, e in inner:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= outer[i][1]:
            out.append((s, e))
    return out


def _kernels(ctx):
    w = ctx.window
    if w is None or not w.kernels or w.wall_s <= 0:
        return None
    return [(s, e) for _, s, e in w.kernels]


def extract_idle_pct(ctx, name: str) -> Optional[float]:
    """The card's idle time inside the spans ``name`` as a share of the
    traced window, in percent: a part of ``device_idle_pct.extract``."""
    busy = _kernels(ctx)
    s = spans(ctx.window, name) if busy is not None else []
    if not s:
        return None
    return 100.0 * idle_s(s, busy) / ctx.window.wall_s


def first_batch_ms(ctx) -> Optional[float]:
    """The median, over the window's ``Extractor.extract`` calls, of the
    first ``Extractor.next_batch`` in each, in ms: the wait for a list's
    first batch."""
    if _kernels(ctx) is None:
        return None
    waits = spans(ctx.window, "Extractor.next_batch")
    firsts = []
    for c in spans(ctx.window, "Extractor.extract"):
        mine = inside(waits, [c])
        if mine:
            firsts.append(mine[0][1] - mine[0][0])
    return 1e3 * statistics.median(firsts) if firsts else None


def query_idle_ms(ctx, name: str) -> Optional[float]:
    """The card's idle time inside the spans ``name`` a search call, in ms,
    over the calls whose ``Index.query`` span lies wholly in the window (a
    stage whose call began before the profiler did is left out)."""
    busy = _kernels(ctx)
    if busy is None:
        return None
    calls = spans(ctx.window, "Index.query")
    s = inside(spans(ctx.window, name), calls)
    if not s:
        return None
    return 1e3 * idle_s(s, busy) / len(calls)
