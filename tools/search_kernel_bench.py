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
With ``--small-batch`` it times instead the small-batch form
(csrc/narrow_tile.cuh) against the 128-row form on the same inputs, at
config 5's gallery (1,000,000 x 2048 bf16) and path E's (100,000 x 2048
f32): both kernels at Nq = 1, 8, 20, 32, 33, 64 and 96 (fused_topk_search at
k = 1, 20, 100 and 128 where Nq is 1 or 20), each kernel's device time
(torch.profiler) beside the wrapper's, and the one-call library yardsticks;
the forms are chosen through ``ops.kernels.fused_topk.NARROW_MAX_NQ`` (0:
the 128-row form; 128: the small-batch form up to 128 queries), which a
checkout before the small-batch form lacks (it is timed as it is).
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


def small_batch(dev, emit, fused_topk, scores_blockmax, fused_topk_search):
    """The small-batch cells (see the module docstring)."""
    import torch

    def forms():
        if not hasattr(fused_topk, "NARROW_MAX_NQ"):
            return {"as_is": None}
        return {"small_batch": 128, "128_row": 0}

    def timed(form, fn):
        saved = getattr(fused_topk, "NARROW_MAX_NQ", None)
        if form is not None:
            fused_topk.NARROW_MAX_NQ = form
        try:
            return {"ms": time_ms(fn, reps=10), "kernels_ms": kernel_ms(fn, reps=3)}
        finally:
            if saved is not None:
                fused_topk.NARROW_MAX_NQ = saved

    gen = torch.Generator(device=dev).manual_seed(1)
    for dtype, ng in ((torch.bfloat16, 1_000_000), (torch.float32, 100_000)):
        g = torch.nn.functional.normalize(torch.randn((ng, D), generator=gen, device=dev),
                                          dim=1).to(dtype)
        qall = torch.nn.functional.normalize(torch.randn((96, D), generator=gen, device=dev),
                                             dim=1)
        name = str(dtype).split(".")[-1]
        for nq in (1, 8, 20, 32, 33, 64, 96):
            q = qall[:nq].contiguous()
            qr = q.to(dtype).float()
            ql = q.to(dtype)
            cells = {form: timed(v, lambda: scores_blockmax(g, qr)) for form, v in forms().items()}
            emit(kernel="scores_blockmax", dtype=name, ng=ng, nq=nq, forms=cells,
                 library_ms=time_ms(lambda: ql @ g.T, reps=10))
            for k in ((1, 20, 100, 128) if nq in (1, 20) else (100,)):
                cells = {form: timed(v, lambda: fused_topk_search(g, q, k))
                         for form, v in forms().items()}
                emit(kernel="fused_topk_search", dtype=name, ng=ng, nq=nq, k=k, forms=cells,
                     library_ms=time_ms(lambda: torch.topk(ql @ g.T, k, dim=1), reps=10))
        del g, qall
        torch.cuda.empty_cache()


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here, help="checkout whose port is timed")
    ap.add_argument("--small-batch", action="store_true",
                    help="time the small-batch form against the 128-row form")
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

    if args.small_batch:
        from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
            fused_topk,
        )

        small_batch(dev, emit, fused_topk, scores_blockmax, fused_topk_search)
        return 0
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
