"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/torch_kernels/<name>-<hash>.so``
at the root of the checkout, and loaded with ``ctypes``. The hash is the
SHA-256 of the source and of every shared header ``csrc/*.cuh`` it may
include, so an edited source or header is rebuilt on its next use and a
stale library is never loaded. ``nvcc``'s output, with ``-Xptxas -v``'s
registers, shared memory and spills per kernel, is kept beside each
library as ``<name>-<hash>.log``. Nothing is built at import time: a library is
built at its first use, or all of them at once (one ``nvcc`` per source,
started together) by :func:`build_all`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: (argtypes); all return an int error code
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "gem_l2n": {
        # x, p, sizes, out, B, N, W, C, is_bf16, stream
        "gem_l2n_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # C, is_bf16, out (int[6])
        "gem_l2n_plan": (_I, _I, _P),
    },
    "fused_topk": {
        # queries, gallery, part_v, part_i, out_v, out_i, Nq, Ng, D, k,
        # width, n_splits, is_bf16, stream
        "fused_topk_forward": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "netvlad": {
        # x, w, bias, centroids, sizes, wt_hi, wt_lo, logits, a_hi, a_lo,
        # mass, part, row_sq, out, B, N, W, C, K, n_chunks, stream, pre_l2
        "netvlad_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _P, _I),
    },
    "score_topk": {
        # queries, gallery, scores, bmax, Nq, Ng, D, ng_pad, is_bf16, width,
        # n_splits, stream
        "scores_blockmax_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "adc": {
        # lut, codes, scores, bmax, nq, n, n_valid, M, n_pad, stream
        "adc_scores_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # out (int[3])
        "adc_plan": (_P,),
    },
    "bottleneck": {
        # x, w1, b1, w2, b2, w3, b3, wt, y1, y2, out, B, H, W, Cin, Cm, stream
        "bottleneck_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _P),
    },
    "bottleneck_bf16": {
        # x, w1t, b1, w2t, b2, w3t, b3, y1, y2, out, B, H, W, Cin, Cm, stream
        "bottleneck_forward_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _P),
    },
    "bn_act": {
        # y, identity, mean, mul, bias, out, rows, C, relu, stream
        "bn_act_forward": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (shutil.which("nvcc"),
                 CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source and every
    ``csrc/*.cuh`` (an edited header rebuilds every library)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library is current; returns
    ``(process, tmp_path, final_path)`` or ``None``."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    with open(out[: -len(".so")] + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)  # atomic: a concurrent reader never sees a partial file


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> None:
    """Compile every kernel library that is missing, all nvcc runs at once."""
    with _lock:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            _finish_build(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
