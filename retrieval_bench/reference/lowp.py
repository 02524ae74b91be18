"""Rounding of operands to a lower precision, for the controls that show
each comparison fails: TF32 (10 mantissa bits, round to nearest even) in
place of float32 and fp8 e4m3 (scaled per tensor to its 448 maximum) in
place of bfloat16. The products and sums stay float32."""

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    i = t.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDERS = {"tf32": round_tf32, "fp8": round_fp8}
