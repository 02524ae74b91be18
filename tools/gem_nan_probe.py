#!/usr/bin/env python3
"""Probe: a NaN or an Inf in a feature map through the GeM kernels (B1, B2)
against their plain PyTorch version, on the card.

    python3 tools/gem_nan_probe.py

One element of image 0 of a [2, 4, 4, 2048] map is set to NaN, then to Inf;
each line says whether image 0's descriptor is finite or NaN from the kernel
and from the plain version, and how far image 1 (untouched) lies between
them. ROADMAP C15 quotes its output.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (  # noqa: E402
    gem_l2n_fused,
    gem_l2n_fused_rect,
    gem_l2n_plain,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (  # noqa: E402
    resolve_device,
)


def main() -> int:
    dev = resolve_device("cuda")
    x = torch.rand((2, 4, 4, 2048), generator=torch.Generator().manual_seed(0)).to(dev)
    sizes = torch.tensor([[4, 4], [2, 3]], dtype=torch.int32, device=dev)
    for name, val in (("nan", float("nan")), ("inf", float("inf"))):
        y = x.clone()
        y[0, 1, 2, 5] = val
        for entry, fn, args in (("B2 gem_l2n_fused", gem_l2n_fused, ()),
                                ("B1 gem_l2n_fused_rect", gem_l2n_fused_rect, (sizes,))):
            k = fn(y, 3.0, *args)
            p = gem_l2n_plain(y, 3.0, *args)
            print(f"[probe] one {name} in image 0, {entry}: kernel image 0 finite "
                  f"{bool(torch.isfinite(k[0]).all())}, nan {int(torch.isnan(k[0]).sum())}; "
                  f"plain finite {bool(torch.isfinite(p[0]).all())}, nan "
                  f"{int(torch.isnan(p[0]).sum())}; image 1 max|k - p| "
                  f"{float((k[1] - p[1]).abs().max()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
