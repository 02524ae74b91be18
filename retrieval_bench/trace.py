"""The traced window: ``torch.profiler`` over it, and the arithmetic that
turns its events into the card's busy time, the device time of kernels by
name and the idle gaps by what the host was doing. The busy-time union is
``chip_smoke.py::device_summary``'s."""

import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

# spans the benchmark's own files record around their calls into the program
SPAN_PREFIX = "bench."


class Window:
    """A profiled window. ``kernels``: (name, start s, end s) of every
    operation on the card; ``host``: (name, start s, end s) of the main
    thread's CPU events, spans included; ``wall_s``: the window's length by
    the host clock, the card synchronized at both ends."""

    def __init__(self, trace_path: Optional[str] = None):
        self.trace_path = trace_path
        self.kernels: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        self.wall_s = 0.0
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read(self._prof.events())
            if self.trace_path:
                os.makedirs(os.path.dirname(self.trace_path), exist_ok=True)
                self._prof.export_chrome_trace(self.trace_path)
        return False

    def _read(self, events) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        main = None
        for e in events:
            if e.device_type == cuda:
                if not getattr(e, "is_user_annotation", False):
                    self.kernels.append((e.name, e.time_range.start / 1e6,
                                         e.time_range.end / 1e6))
            elif e.name.startswith(SPAN_PREFIX) and main is None:
                main = e.thread
        for e in events:
            if e.device_type != cuda and (main is None or e.thread == main):
                self.host.append((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6))

    def busy_s(self) -> float:
        """The union of the card's operation intervals."""
        busy, cur = 0.0, None
        for _, start, end in sorted(self.kernels, key=lambda k: k[1]):
            if cur is None or start > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                cur = [start, end]
            else:
                cur[1] = max(cur[1], end)
        if cur is not None:
            busy += cur[1] - cur[0]
        return busy

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the operations whose name holds any of ``names``."""
        return sum(e - s for n, s, e in self.kernels if any(k in n for k in names))

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, s, e in self.kernels:
            by[n[:160]] = by.get(n[:160], 0.0) + (e - s)
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The card's idle gaps inside the window, summed by what the main
        thread was doing at each gap's middle: its outermost span and its
        innermost event there."""
        ks = sorted(self.kernels, key=lambda k: k[1])
        gaps, end = [], None
        for _, s, e in ks:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        host = sorted(self.host, key=lambda h: h[1])
        by: Dict[str, float] = {}
        active: List[Tuple[str, float, float]] = []
        i = 0
        for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (g0 + g1)
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] >= mid]
            if active:
                outer = next((h[0] for h in active if h[0].startswith(SPAN_PREFIX)), active[0][0])
                inner = max(active, key=lambda h: h[1])[0]
                label = outer if inner == outer else f"{outer} > {inner}"
            else:
                label = "host outside the traced calls"
            by[label[:160]] = by.get(label[:160], 0.0) + (g1 - g0)
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def trace_path(workload: str) -> str:
    """Where a traced run's Chrome trace goes: a fixed path under TMPDIR."""
    return os.path.join(tempfile.gettempdir(), "retrieval_bench", f"{workload}.trace.json")


def span(name: str):
    """A span of the benchmark's own, around one call into the program."""
    return torch.profiler.record_function(SPAN_PREFIX + name)
