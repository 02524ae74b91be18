"""Structured metrics: JSONL records and phase timers.

The JAX package's ``utils/metrics.py`` without ``profile_trace`` (a
``jax.profiler`` trace; its ``torch.profiler`` counterpart comes with the
tooling, ROADMAP A9). Records stream as JSON lines, host-side and cheap.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


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
