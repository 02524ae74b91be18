"""The readings a cell's limits are set from, in one process: the program's
compared numbers over many seeds (each a short window at the cell's own
load and sizes, sampled as a full run samples), and the control's over a
few. The control is the driver's own where its module defines
``control_numbers(cfg, traffic, seed, seconds, device)``; else the program's
own int8 gallery for the search driver, the reference at the next precision
down (``--control fp8`` for bf16, ``tf32`` for float32) for the extraction
driver.

    python3 -m retrieval_bench.tools.readings --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3 [--out readings.jsonl]
"""

import argparse
import json
import sys
import time

import torch

from retrieval_bench import harness, synth


def control_numbers(name: str, seed: int, seconds: float, device="cuda",
                    overrides=None) -> dict:
    """The cell's compared numbers with the control in the program's place."""
    bench = harness.load_benchmark()
    entry, wl, cfg, traffic = harness.resolve(name, bench, overrides)
    drv = harness.load_module("drivers", traffic["driver"])
    torch.set_grad_enabled(False)
    if hasattr(drv, "control_numbers"):
        return drv.control_numbers(cfg, traffic, seed, seconds, device)
    if traffic["driver"] == "search":
        cell = drv.Cell(cfg, traffic, seed, torch.device(device))
        cell.program_storage = "int8"
        cell.setup()
        cell.window(seconds)
        cell.release()
        return cell.check()
    control = {"float32": "tf32", "bfloat16": "fp8"}[cfg["model"]["dtype"]]
    per = max(1, traffic["check_images"] // len(cfg["images"]["shapes"]))
    r = synth.rng(seed, "check")
    items = [(tuple(s), int(j)) for s in sorted(map(tuple, cfg["images"]["shapes"]))
             for j in r.choice(traffic["pool_per_shape"], per)]
    prog = drv.reference_descriptors(cfg, seed, device, items, traffic["pool_per_shape"],
                                     control=control)
    refd = drv.reference_descriptors(cfg, seed, device, items, traffic["pool_per_shape"])
    return drv.ref.compare(prog, refd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    lines = []
    for kind, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for s in [int(x) for x in seeds.split(",") if x]:
            t0 = time.perf_counter()
            if kind == "program":
                nums = {k: v["value"] for k, v in
                        harness.run(a.workload, s, a.seconds, False, t0,
                                    err=sys.stderr)["checks"].items()}
            else:
                nums = control_numbers(a.workload, s, a.seconds)
            line = {"workload": a.workload, "kind": kind, "seed": s, "numbers": nums,
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if a.out:
        with open(a.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
