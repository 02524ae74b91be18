"""Operation and byte counts of the benchmark's kernels and models, and the
table of the card's peaks (``peaks.json``). Pure arithmetic on shapes: no
module here imports torch or the program."""

import json
import os

_DIR = os.path.dirname(os.path.abspath(__file__))


def peaks() -> dict:
    """The card's data-sheet peaks (``peaks.json``)."""
    with open(os.path.join(_DIR, "peaks.json")) as f:
        return json.load(f)


def flops_peak(dtype: str) -> float:
    """Dense peak FLOP/s of the card for operands of ``dtype``."""
    return float(peaks()["flops_per_s"][dtype])


def hbm_bytes_per_s() -> float:
    return float(peaks()["hbm_bytes_per_s"])


ELEMENT_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}
