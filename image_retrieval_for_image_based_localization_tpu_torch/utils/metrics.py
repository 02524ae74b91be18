"""Structured metrics, phase timers and profiler traces.

The JAX package's ``utils/metrics.py``: records stream as JSON lines,
host-side and cheap, and a region can run under ``torch.profiler``
(:func:`profile_trace`, the counterpart of its ``jax.profiler`` trace),
which writes a Chrome/Perfetto trace. The program marks its stages with
:func:`span`, ranges that such a trace shows on the card's clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


class MetricsLogger:
    """Append-only JSONL metrics writer; also mirrors to stdout optionally."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, **record: Any) -> Dict[str, Any]:
        record.setdefault("t", time.time())
        line = json.dumps(record)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, flush=True)
        return record


@contextlib.contextmanager
def phase_timer(name: str, logger: Optional[MetricsLogger] = None, items: int = 0):
    """Wall-clock a phase; the caller waits for the card inside (the
    port's entry points return host arrays, which does)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    rec = {"phase": name, "seconds": dt}
    if items:
        rec["items_per_sec"] = items / dt
    if logger:
        logger.log(**rec)


@contextlib.contextmanager
def profile_trace(logdir: str = os.path.join(tempfile.gettempdir(), "irtpu_trace"),
                  enabled: bool = True):
    """``torch.profiler`` around a region: CPU activity and, where a card is
    present, CUDA activity (the card's kernels with their device times).
    Yields the profiler, whose ``events()`` the caller reads after the
    block; on exit a Chrome/Perfetto trace (``export_chrome_trace``) is
    written under ``logdir`` as ``<pid>-<time ns>.pt.trace.json``, its path
    kept as the profiler's ``trace_path``. ``enabled=False`` yields None and
    writes nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        os.makedirs(logdir, exist_ok=True)
        prof.trace_path = os.path.join(logdir, f"{os.getpid()}-{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(prof.trace_path)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the program's own: while ``torch.profiler`` records
    on the calling thread, a ``record_function`` range, which the trace
    (``profile_trace``'s, or any profiler's window) stamps on the clock of
    the card's kernels; otherwise one shared no-op context, so an untraced
    call pays one check and nothing more. Ranges opened in a thread the
    profiler did not see start are not recorded, so the program opens its
    spans on the calling thread."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def percentile_summary(lat_seconds, unit: str = "ms") -> dict:
    """p50/p95/p99/mean summary of latencies given in seconds, emitted in
    ``unit`` ('ms' or 's')."""
    lat = np.asarray(lat_seconds, np.float64)
    scale = 1e3 if unit == "ms" else 1.0
    return {
        f"p50_{unit}": round(float(np.percentile(lat, 50)) * scale, 2),
        f"p95_{unit}": round(float(np.percentile(lat, 95)) * scale, 2),
        f"p99_{unit}": round(float(np.percentile(lat, 99)) * scale, 2),
        f"mean_{unit}": round(float(lat.mean()) * scale, 2),
    }
