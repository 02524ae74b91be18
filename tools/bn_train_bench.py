#!/usr/bin/env python3
"""Time the port's train-mode BatchNorm (``models.resnet.bn_train``) on one
CUDA card, forward and backward, on its two paths: without a mesh
(``F.batch_norm``) and under ``global_batch_stats`` (a train step over a
mesh: float64 sums, so a data slice yields the global batch's statistics;
here a group of one process, so no collective).

    python3 tools/bn_train_bench.py [--root DIR]

Imports the port from ``--root`` (default: this checkout). The shapes are
resnet101's BatchNorm inputs in path D's train step (35 images, 5 tuples
of 7, in a 288 x 384 bucket), channels_last f32: the stem, then each
stage's block-internal and block-output widths. For each shape and each
version: forward plus backward (``out.backward(dout)``), CUDA events,
median of 20 after 3 warm-ups, and the card's kernel time a call under
torch.profiler (with the kernel count and the costliest kernels); then the
two outputs' and input gradients' max|diff| relative to their max. Prints the card's name and power limit,
then one JSON line per shape and one with resnet101's sum (each stage's
shapes weighted by how many BatchNorms run at it a step).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# (name, [N, C, H, W], BatchNorms of resnet101 at this shape a step)
SHAPES = [("stem", (35, 64, 144, 192), 1),
          ("layer1 internal", (35, 64, 72, 96), 6), ("layer1 out", (35, 256, 72, 96), 4),
          ("layer2 internal", (35, 128, 36, 48), 8), ("layer2 out", (35, 512, 36, 48), 5),
          ("layer3 internal", (35, 256, 18, 24), 46), ("layer3 out", (35, 1024, 18, 24), 24),
          ("layer4 internal", (35, 512, 9, 12), 6), ("layer4 out", (35, 2048, 9, 12), 4)]


def time_ms(fn, reps=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=5) -> tuple:
    """(device ms a call, kernels a call, the five costliest kernels): the
    card's kernel time under torch.profiler, summed, over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (sum(by_name.values()), len(kernels) / reps,
            [(n[:60], round(ms, 4)) for n, ms in top])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (
        bn_train,
        global_batch_stats,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    total = {"no_mesh_ms": 0.0, "mesh_ms": 0.0, "no_mesh_device_ms": 0.0, "mesh_device_ms": 0.0}
    for name, shape, count in SHAPES:
        gen = torch.Generator().manual_seed(0)
        y = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dev).contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        dout = torch.randn(shape, generator=gen).to(dev).contiguous(
            memory_format=torch.channels_last)
        bn = torch.nn.BatchNorm2d(shape[1]).to(dev).train()

        def no_mesh_bn():
            bn_train(bn, y).backward(dout)

        def mesh_bn():
            with global_batch_stats(None):
                bn_train(bn, y).backward(dout)

        outs = []
        for fn in (no_mesh_bn, mesh_bn):
            y.grad = None
            fn()
            outs.append(y.grad.clone())
        want = F.batch_norm(y, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
        with global_batch_stats(None):
            got = bn_train(bn, y)
        t_dev, t_n, _ = device_ms(no_mesh_bn)
        p_dev, p_n, p_top = device_ms(mesh_bn)
        row = {"shape": name, "nchw": list(shape), "per_step": count,
               "no_mesh_ms": time_ms(no_mesh_bn), "mesh_ms": time_ms(mesh_bn),
               "no_mesh_device_ms": t_dev, "mesh_device_ms": p_dev,
               "no_mesh_kernels": t_n, "mesh_kernels": p_n, "mesh_top": p_top,
               "out_rel_diff": ((got - want).abs().max() / want.abs().max()).item(),
               "dy_rel_diff": ((outs[1] - outs[0]).abs().max() / outs[0].abs().max()).item()}
        for k in total:
            total[k] += count * row[k]
        print(json.dumps(row), flush=True)
    print(json.dumps({"resnet101_step_sum": total, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
