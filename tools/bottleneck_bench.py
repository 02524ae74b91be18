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
        bottleneck_fused,
        bottleneck_plain,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
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
