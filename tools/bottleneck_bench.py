#!/usr/bin/env python3
"""Time the fused-bottleneck kernel of a checkout on one CUDA card.

    python3 tools/bottleneck_bench.py [--root DIR]

Imports the port from ``--root`` (default: this checkout), so that another
checkout unpacked beside it (the parent commit, say) can be timed on the
same card in the same call: run it as parent, change, change, parent.

At the five block shapes of ``chip_smoke.py`` (resnet50's stride-1 blocks
on a 16-image 1024 px bucket, layers 1-4, and layer1 of a 720 x 1024
bucket; inputs from a seed) it times ``bottleneck_fused`` through the public
wrapper with CUDA events (median of 20 calls, host work included) beside
its plain version (three cuDNN convolutions, TF32 off), checks the kernel
against the plain version first, and gives the device time of each kernel
the wrapper launches (torch.profiler). It ends with the sums over
resnet50's 12-block mix at the 1024 px bucket (layers 1-4 hold 2, 3, 5 and
2 of the blocks). Prints one JSON line per shape, the card's name and power
limit first.

    python3 tools/bottleneck_bench.py --bf16 [--root DIR]

The bf16 form (``csrc/bottleneck_bf16.cu``): first the registers and spills
of each kernel instantiation and the warnings of nvcc's log, then the
kernel against its plain version, gated as ``chip_smoke.py`` gates it (one
bf16 ulp at max|plain|, at most 5 % of the values not bit-equal, a second
call bit for bit), at ``chip_smoke.py``'s six check shapes and at shapes
that reach each of the kernel's tiles and stage depths (each with the
wrapper's launch plan), then its time at the five block shapes beside its
bound and cuDNN's three bf16 convolutions (``chip_smoke.py`` phase 5 times
the plain version), and the sums over resnet101's 29 stride-1 blocks at
the 1024 px bucket (2, 3, 22 and 2 at layers 1-4).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from search_kernel_bench import kernel_ms, time_ms

SHAPES = (((16, 256, 256, 256), 64), ((16, 128, 128, 512), 128),
          ((16, 64, 64, 1024), 256), ((16, 32, 32, 2048), 512),
          ((16, 180, 256, 256), 64))
MIX = (2, 3, 5, 2, 0)  # blocks of each shape in resnet50 at the 1024 px bucket


def inputs(dev, shape, cm, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    cin = shape[3]
    x = torch.relu(torch.randn(shape, generator=gen))
    w1 = torch.randn((cin, cm), generator=gen) * (2 / cin) ** 0.5
    w2 = torch.randn((3, 3, cm, cm), generator=gen) * (2 / (9 * cm)) ** 0.5
    w3 = torch.randn((cm, cin), generator=gen) * (2 / cm) ** 0.5
    b1, b2, b3 = (0.1 * torch.randn(c, generator=gen) for c in (cm, cm, cin))
    return [t.to(dev).contiguous() for t in (x, w1, b1, w2, b2, w3, b3)]


# shapes (B, H, W, Cin, Cm) that reach each route of the bf16 kernel: N =
# Cm = 64 (256 x 64 tiles), Cm = 128 at Cin = 512 (128 x 128), Cm = 96 (the
# 32-deep stages), Cin = 160 (a ragged 128-wide column tile, 32 deep), M
# below one tile, tiles that span 35-pixel images
BF16_ROUTE_SHAPES = ((2, 12, 10, 256, 64), (2, 33, 40, 512, 128), (2, 6, 9, 160, 96),
                     (2, 9, 7, 160, 64), (1, 5, 7, 256, 64), (3, 5, 7, 256, 64),
                     (2, 16, 16, 128, 32))


def bf16_main(root) -> int:
    import torch

    import importlib.util

    # this checkout's chip_smoke.py (its gate and shapes), whichever port --root names
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        _build,
        bottleneck_fused,
        bottleneck_plain,
        pack_bf16,
    )

    def plan(shape, cm):  # a checkout from before the bf16 form had its own tiles has none
        p = cs.bf16_plan(shape, cm)
        return cs.plan_summary(p) if "bk" in p else None
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device("cuda")
    _build.build_all(["bottleneck_bf16"])
    info, warnings = cs.bottleneck_bf16_build_info()
    print(json.dumps({"root": root, "build": {"/".join(map(str, k)): v for k, v in info.items()},
                      "warnings": warnings}), flush=True)
    checks = [(s, cm) for s, cm in cs.BOTTLENECK_SHAPES + (cs.BOTTLENECK_SPANNING,)]
    checks += [(s[:4], s[4]) for s in BF16_ROUTE_SHAPES]
    for i, (shape, cm) in enumerate(checks):
        a = cs._bottleneck_inputs(dev, shape, cm, seed=10 + i)
        a[0] = a[0].to(torch.bfloat16)
        pk = pack_bf16(a[1], a[3], a[5])
        got = bottleneck_fused(*a, packed=pk)
        again = bottleneck_fused(*a, packed=pk)
        want = bottleneck_plain(*a)
        e, r, share = cs._compare_bottleneck_bf16(f"bf16 {list(shape)} Cm={cm}", got, again,
                                                  want)
        print(json.dumps({"root": root, "check": list(shape), "cm": cm, "max_abs_err": e,
                          "rel_err": r, "not_bit_equal": share,
                          "plan": plan(shape, cm)}), flush=True)
        del a, got, again, want, pk
    torch.cuda.empty_cache()
    total = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for i, ((shape, cm), n_blocks) in enumerate(zip(cs.BOTTLENECK_SHAPES, cs.R101_MIX)):
        a = cs._bottleneck_inputs(dev, shape, cm, seed=10 + i)
        a[0] = a[0].to(torch.bfloat16)
        x, w1, b1, w2, b2, w3, b3 = a
        pk = pack_bf16(w1, w2, w3)
        B, H, W, cin = shape
        flops = 2 * B * H * W * (2 * cin * cm + 9 * cm * cm)
        byts = 2 * B * H * W * cin * 2 + (2 * cin * cm + 9 * cm * cm) * 2 + (2 * cm + cin) * 4
        bound = max(flops / cs.BF16_FLOP_PER_S, byts / cs.HBM_BYTES_PER_S) * 1e3
        library = cs.cudnn_bf16_bottleneck(x, w1, b1, w2, b2, w3, b3)
        ms = time_ms(lambda: bottleneck_fused(*a, packed=pk))
        lib_ms = time_ms(library)
        row = {"root": root, "shape": list(shape), "cm": cm, "ms": ms, "library_ms": lib_ms,
               "bound_ms": bound, "tflops": flops / ms / 1e9,
               "share_of_bound": bound / ms,
               "plan": plan(shape, cm),
               "phases_ms": phase_ms(lambda: bottleneck_fused(*a, packed=pk)),
               "host_ms": host_ms(lambda: bottleneck_fused(*a, packed=pk)),
               "host_python_ms": python_ms(_build, lambda: bottleneck_fused(*a, packed=pk))}
        print(json.dumps(row), flush=True)
        for k in total:
            total[k] += n_blocks * row[k]
        del a, x, pk, library
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "r101_29_blocks": total}), flush=True)
    return 0


def phase_ms(fn, reps=5):
    """Device ms per call of each kernel ``fn`` launches, by kernel name with
    its template arguments (the bf16 form's phase, tile columns and depth)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def python_ms(build, fn, calls=50):
    """The wrapper's Python work alone: host ms per call of ``fn`` with the
    bf16 library's entry replaced by a call that launches nothing."""

    class NoLaunch:
        @staticmethod
        def bottleneck_forward_bf16(*args):
            return 0

    lib = build.load("bottleneck_bf16")
    build._loaded["bottleneck_bf16"] = NoLaunch
    try:
        return host_ms(fn, calls)
    finally:
        build._loaded["bottleneck_bf16"] = lib


def host_ms(fn, calls=50):
    """Host ms per call of ``fn`` issued back to back before the card is
    waited for: the wrapper's own work (checks, allocation, launches)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return t


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here, help="checkout whose port is timed")
    ap.add_argument("--bf16", action="store_true", help="the bf16 form instead of the f32 one")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.bf16:
        return bf16_main(root)
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        _build,
        bottleneck_fused,
        bottleneck_plain,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device("cuda")  # TF32 off for the plain version's convs
    _build.build_all(["bottleneck"])
    total = {"ms": 0.0, "plain_ms": 0.0}
    for i, ((shape, cm), n_blocks) in enumerate(zip(SHAPES, MIX)):
        a = inputs(dev, shape, cm, seed=10 + i)
        want = bottleneck_plain(*a)
        rel = ((bottleneck_fused(*a) - want).abs().max() / want.abs().max()).item()
        del want
        ms = time_ms(lambda: bottleneck_fused(*a))
        plain_ms = time_ms(lambda: bottleneck_plain(*a))
        print(json.dumps({"root": root, "shape": list(shape), "cm": cm, "ms": ms,
                          "plain_ms": plain_ms, "rel_err": rel,
                          "kernels_ms": kernel_ms(lambda: bottleneck_fused(*a))}), flush=True)
        total["ms"] += n_blocks * ms
        total["plain_ms"] += n_blocks * plain_ms
        del a
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "mix_12_blocks": total}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
