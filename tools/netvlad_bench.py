#!/usr/bin/env python3
"""Time the NetVLAD kernel of a checkout on one CUDA card.

    python3 tools/netvlad_bench.py [--root DIR]

Imports the port from ``--root`` (default: this checkout), so that another
checkout unpacked beside it (the parent commit, say) can be timed on the
same card in the same call: run it as parent, change, change, parent.

Inputs are ``chip_smoke.py``'s NetVLAD check inputs (this checkout's copy of
the script, same seed): config 3's head on a [16, 64 x 64, 512] f32 map with
ragged extents, one (0, 0) row and one image whose clusters mostly get zero
mass, at K = 64 (the graded config) and K = 256. For each K it runs
``netvlad_fused_rect`` (the extents) and ``netvlad_fused`` (every row), and
for each it prints the max abs error against ``netvlad_plain``, whether a
second call gives the same bits, the time through the public wrapper (CUDA
events, median of 20, host work included), the device time of every kernel
that ``netvlad_forward`` launches summed (torch.profiler, mean of 5; kernels
named ``netvlad_*``), the device time of the wrapper's other kernels (its
operand preparation), and the host's time per call issued back to back. A
checkout whose kernel refuses the shape (the parent's K <= 128) prints the
error instead. Prints one JSON line per measurement, the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

from adc_gem_bench import host_ms
from search_kernel_bench import kernel_ms, time_ms

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = (64, 256)


def smoke_inputs(dev, K):
    """chip_smoke.py's _netvlad_inputs at K clusters, from this checkout."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke._netvlad_inputs(dev, K=K)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose port is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        _build,
        netvlad_fused,
        netvlad_fused_rect,
        netvlad_plain,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = resolve_device("cuda")  # TF32 off for the plain version's matmuls
    _build.build_all(["netvlad"])

    for K in KS:
        nv = smoke_inputs(dev, K)
        x, c, w, b, sizes = nv["x"], nv["c"], nv["w"], nv["b"], nv["sizes"]
        for name, fn, plain in (
                ("netvlad_fused_rect", lambda: netvlad_fused_rect(x, c, w, b, sizes=sizes),
                 lambda: netvlad_plain(x, c, w, b, sizes)),
                ("netvlad_fused", lambda: netvlad_fused(x, c, w, b),
                 lambda: netvlad_plain(x, c, w, b))):
            rec = dict(root=root, kernel=name, shape=list(x.shape), K=K,
                       valid_positions=nv["valid_positions"] if "rect" in name else x.shape[0]
                       * x.shape[1] * x.shape[2])
            try:
                got = fn()
            except (RuntimeError, ValueError) as e:
                print(json.dumps(dict(rec, refused=str(e))), flush=True)
                continue
            per_kernel = kernel_ms(fn)
            own = {k: v for k, v in per_kernel.items() if k.startswith("netvlad")}
            rec.update(max_abs_err=(got - plain()).abs().max().item(),
                       deterministic=bool(torch.equal(got, fn())), ms=time_ms(fn),
                       device_ms=sum(own.values()), kernels_ms=own,
                       prep_device_ms=sum(v for k, v in per_kernel.items() if k not in own),
                       host_ms=host_ms(fn))
            print(json.dumps(rec), flush=True)
        del nv, x, c, w, b, sizes
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
