"""Opt-in correctness guards, the JAX package's ``utils/debug.py``.

:func:`debug_checks` stops at the first operator that makes a NaN or an
Inf, in the forward pass and in the backward (the counterpart of
``jax_debug_nans`` / ``jax_debug_infs``); :func:`assert_deterministic`
runs a function twice and compares its outputs bit for bit. Both are slow
and meant for debugging.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


# operators whose output is memory not written yet: its bits are no result
_UNWRITTEN = frozenset(getattr(torch.ops.aten, n) for n in (
    "empty", "empty_like", "empty_strided", "empty_permuted", "new_empty", "new_empty_strided",
    "resize_"))


class _FiniteOutputs(TorchDispatchMode):
    """Checks every floating output of every ATen operator but views and
    allocations (their bits are checked where an operator writes them). The
    CUDA kernels of ``ops/kernels`` launch outside the dispatcher, so a NaN
    one of them writes shows at the first operator its output reaches."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans = nans
        self.infs = infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket in _UNWRITTEN:
            return out
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or not (t.is_floating_point() or t.is_complex()):
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"invalid value (nan) encountered in {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"invalid value (inf) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_checks(nans: bool = True, infs: bool = True):
    """Raise ``FloatingPointError`` at the first operator, forward or
    backward, whose floating output holds a NaN (``nans``) or an Inf
    (``infs``), within the scope. Autograd's anomaly mode is on too, so a
    backward error names the forward operator that recorded it. Each check
    reads its tensor on the host: slow, opt-in."""
    with torch.autograd.set_detect_anomaly(True), _FiniteOutputs(nans, infs):
        yield


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def assert_deterministic(fn: Callable, *args, runs: int = 2, **kw) -> None:
    """Run ``fn`` ``runs`` times and assert that the first and the last
    outputs are bitwise identical, leaf for leaf (tensors and arrays; NaN
    equals NaN): catches aliasing bugs and nondeterministic reductions."""
    outs = [tree_leaves(fn(*args, **kw)) for _ in range(runs)]
    for a, b in zip(outs[0], outs[-1]):
        a, b = _as_numpy(a), _as_numpy(b)
        if a.shape != b.shape:
            raise AssertionError(f"nondeterministic output (shape {a.shape} vs {b.shape})")
        if not np.array_equal(a, b, equal_nan=True):
            diff = np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)))
            raise AssertionError(f"nondeterministic output (max |diff|={diff})")
