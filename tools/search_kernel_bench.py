#!/usr/bin/env python3
"""Where the time of the two exact-search kernels goes, on one CUDA card.

    python3 tools/search_kernel_bench.py [--root DIR]

Imports the port from ``--root`` (default: this checkout), so that another
checkout unpacked beside it (the parent commit, say) can be timed on the
same card in the same call: run it as parent, change, change, parent.

At the search shape (256 queries x 100,000 x 2048, unit-norm rows from a
seed, f32 and bf16 galleries) it times, with CUDA events (median of 20
calls through the public wrappers, host work included):
- scores_blockmax beside cuBLAS's f32 ``q @ g.T`` (TF32 off), and the exact
  search on top of it (``blockmax_topk_search``, k = 1000);
- fused_topk_search at k = 1, 32, 100, 128 beside ``torch.topk(q @ g.T)``,
  with the device time of each kernel it launches (torch.profiler);
- fused_topk_search at k = 100 at 1, 32 and 256 queries.
Prints one JSON line per measurement, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

NQ, NG, D = 256, 100_000, 2048


def time_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, reps=5):
    """Device ms per call of each kernel ``fn`` launches, by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("<")[0].split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here, help="checkout whose port is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        _build,
        blockmax_topk_search,
        fused_topk_search,
        scores_blockmax,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = resolve_device("cuda")
    _build.build_all(["score_topk", "fused_topk"])

    def emit(**kw):
        print(json.dumps(dict(root=root, **kw)), flush=True)

    gen = torch.Generator().manual_seed(0)
    g32 = torch.nn.functional.normalize(torch.randn((NG, D), generator=gen), dim=1).to(dev)
    q = torch.nn.functional.normalize(torch.randn((NQ, D), generator=gen), dim=1).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        g = g32.to(dtype)
        gf = g.float()
        qr = q.to(dtype).float()
        name = str(dtype).split(".")[-1]
        emit(kernel="scores_blockmax", dtype=name, ms=time_ms(lambda: scores_blockmax(g, q)),
             cublas_ms=time_ms(lambda: qr @ gf.T),
             search_k1000_ms=time_ms(lambda: blockmax_topk_search(g, q, 1000)))
        for k in (1, 32, 100, 128):
            emit(kernel="fused_topk_search", dtype=name, k=k,
                 ms=time_ms(lambda: fused_topk_search(g, q, k)),
                 topk_ms=time_ms(lambda: torch.topk(qr @ gf.T, k, dim=1)),
                 kernels_ms=kernel_ms(lambda: fused_topk_search(g, q, k)))
        del g, gf
    for nq in (1, 32, 256):
        qs = q[:nq].contiguous()
        emit(kernel="fused_topk_search", dtype="float32", k=100, nq=nq,
             ms=time_ms(lambda: fused_topk_search(g32, qs, 100)),
             topk_ms=time_ms(lambda: torch.topk(qs @ g32.T, 100, dim=1)),
             kernels_ms=kernel_ms(lambda: fused_topk_search(g32, qs, 100)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
