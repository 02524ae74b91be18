#!/usr/bin/env python3
"""Time the ADC and GeM+L2N kernels of a checkout on one CUDA card.

    python3 tools/adc_gem_bench.py [--root DIR]

Imports the port from ``--root`` (default: this checkout), so that another
checkout unpacked beside it (the parent commit, say) can be timed on the
same card in the same call: run it as parent, change, change, parent.

Inputs are those of ``chip_smoke.py``'s checks, made from the same seeds:
- ``adc_scores`` at path A's shapes, 256 queries x 100,000 codes at M = 64
  (D = 2048) and at M = 16 (D = 512), duplicate code rows planted;
- ``gem_l2n_fused_rect`` and ``gem_l2n_fused`` on the GeM head's [16, 32 x
  32, 2048] map, f32 and bf16, with ragged extents (4,862 of 16,384
  positions valid).
Each is first checked against its plain version (ADC bit for bit, GeM within
1e-5), then timed with CUDA events through the public wrapper (median of 20
calls, host work included) and by the device time of each kernel the call
launches (torch.profiler, mean of 5), and the host's time per call over 50
calls issued back to back (the wrapper's own work: checks, allocation,
launch). Prints one JSON line per measurement, the card's name and power
limit first, and the launch plans that the checkout's kernels report, where
they report one (for GeM, with the number of clusters the card holds at
once).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from search_kernel_bench import kernel_ms, time_ms

ADC_SHAPES = ((256, 100_000, 64), (256, 100_000, 16))
GEM_SHAPE = (16, 32, 32, 2048)


def adc_inputs(dev, nq, n, M, seed=8):
    """chip_smoke.py's _adc_inputs: unit-scale scores, each 7th row of the
    second half a copy of row 3."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    lut = (torch.randn((nq, M, 256), generator=gen) / M ** 0.5).to(dev)
    codes = torch.randint(0, 256, (n, M), generator=gen, dtype=torch.uint8)
    codes[n // 2 :: 7] = codes[3]
    return lut, codes.to(dev)


def gem_inputs(dev):
    """chip_smoke.py's check_gem inputs: relu(randn), ragged (h, w) with a
    full extent, a (0, 0) row, h < H and w < W."""
    import torch

    B, H, W, C = GEM_SHAPE
    gen = torch.Generator().manual_seed(1)
    x = torch.relu(torch.randn((B, H, W, C), generator=gen)).to(dev)
    hs = torch.randint(1, H + 1, (B,), generator=gen)
    ws = torch.randint(1, W + 1, (B,), generator=gen)
    hs[0], ws[0] = H, W
    hs[1], ws[1] = 0, 0
    hs[2], ws[2] = H - 9, W
    hs[3], ws[3] = H, W - 5
    sizes = torch.stack([hs, ws], 1).to(torch.int32).to(dev)
    return x, torch.tensor([3.0], device=dev), sizes


def host_ms(fn, calls=50):
    """Host time per call of ``fn`` issued back to back, before the card is
    waited for: the wrapper's own work, not the kernel's."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return t


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
        adc as adc_mod,
        gem_l2n as gem_mod,
        gem_l2n_fused,
        gem_l2n_fused_rect,
        gem_l2n_plain,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = resolve_device("cuda")
    _build.build_all(["adc", "gem_l2n"])

    def emit(**kw):
        print(json.dumps(dict(root=root, **kw)), flush=True)

    for nq, n, M in ADC_SHAPES:
        lut, codes = adc_inputs(dev, nq, n, M)
        ps, pb = adc_mod.adc_scores_plain(lut, codes)
        s, bmax = adc_mod.adc_scores(lut, codes)
        emit(kernel="adc_scores", nq=nq, n=n, M=M,
             plan=adc_mod.launch_plan() if hasattr(adc_mod, "launch_plan") else None,
             bit_equal=bool(torch.equal(s, ps) and torch.equal(bmax, pb)),
             ms=time_ms(lambda: adc_mod.adc_scores(lut, codes)),
             kernels_ms=kernel_ms(lambda: adc_mod.adc_scores(lut, codes)),
             host_ms=host_ms(lambda: adc_mod.adc_scores(lut, codes)))
        del lut, codes, ps, pb, s, bmax
        torch.cuda.empty_cache()

    x32, p, sizes = gem_inputs(dev)
    if hasattr(gem_mod, "launch_plan"):
        emit(kernel="gem_l2n", plan={
            dt: gem_mod.launch_plan(GEM_SHAPE[3], dt == "bfloat16")
            for dt in ("float32", "bfloat16")})
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype).contiguous()
        for name, fn, plain in (
                ("gem_l2n_fused_rect", lambda: gem_l2n_fused_rect(x, p, sizes),
                 lambda: gem_l2n_plain(x, p, sizes)),
                ("gem_l2n_fused", lambda: gem_l2n_fused(x, p), lambda: gem_l2n_plain(x, p))):
            got = fn()
            err = (got - plain()).abs().max().item()
            emit(kernel=name, dtype=str(dtype).split(".")[-1], shape=list(GEM_SHAPE),
                 valid_positions=int(sizes.prod(1).sum()), max_abs_err=err,
                 deterministic=bool(torch.equal(got, fn())), ms=time_ms(fn),
                 kernels_ms=kernel_ms(fn), host_ms=host_ms(fn))
    return 0


if __name__ == "__main__":
    sys.exit(main())
