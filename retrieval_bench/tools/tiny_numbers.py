"""The numbers that a change to the benchmark's own code, which moves no
cell, leaves as they are: for each cell, at one seed, on the CPU at its tiny
cut (``tests/tiny/<cell>.json``), the compared numbers of a run and of the
control (``readings.control_numbers``). The window makes one pass (one
extraction list, one search call), so every run does the same work.

    python3 -m retrieval_bench.tools.tiny_numbers [--seed N] [--workload <cell> ...]

prints one JSON object, cell by cell. Run it on two trees and compare the
outputs: they are equal, byte for byte, where the change moved nothing."""

import argparse
import io
import json
import sys
import time

import torch

from retrieval_bench import harness
from retrieval_bench.tests.tiny import tiny
from retrieval_bench.tools import readings

SEED = 2 ** 31 + 12345


def numbers(cell: str, seed: int = SEED) -> dict:
    """``checks``: the run's compared numbers at ``seed``; ``control``: the
    control's at ``seed + 1``."""
    cut = tiny(cell)
    r = harness.run(cell, seed, 0.0, False, time.perf_counter(), device="cpu",
                    overrides=cut, err=io.StringIO())
    return {"checks": {k: v["value"] for k, v in r["checks"].items()},
            "control": readings.control_numbers(cell, seed + 1, 0.0, device="cpu",
                                                overrides=cut)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--workload", action="append", default=None)
    a = ap.parse_args(argv)
    torch.set_num_threads(4)
    cells = a.workload or [w["name"] for w in harness.load_benchmark()["workloads"]]
    print(json.dumps({c: numbers(c, a.seed) for c in cells}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
