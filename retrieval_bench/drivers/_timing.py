"""Per-call latency for the drivers. On the card: a CUDA event recorded
just before the call and one just after it returns; the card is idle
around a call that returns host arrays, so it stamps each event as it is
enqueued, and their gap is the call's latency on the card's clock (about
half a microsecond apart, where the host's clock is not to be trusted below
a quarter second). On the CPU (the tests): the host clock."""

import time
from typing import List

import numpy as np
import torch


class CallTimer:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._pairs: List = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, started) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._pairs.append((started, ev))
        else:
            self._pairs.append((started, time.perf_counter()))

    def ms(self) -> np.ndarray:
        if self.cuda:
            torch.cuda.synchronize()
            return np.array([a.elapsed_time(b) for a, b in self._pairs], np.float64)
        return np.array([(b - a) * 1e3 for a, b in self._pairs], np.float64)


def percentile(values, q: float) -> float:
    """``numpy.percentile``'s linear interpolation, as
    ``utils/metrics.py::percentile_summary`` of the program takes it."""
    return float(np.percentile(np.asarray(values, np.float64), q))
