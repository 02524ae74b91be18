"""Each cell's cut to a size a CPU test run holds, one file a cell, found by
the cell's name: ``tests/tiny/<cell>.json``. It holds ``config`` and
``traffic``, merged into the cell's own files as overrides (resnet at 64 px,
a 1,000-row gallery of 256 dimensions; the code paths are the cell's own),
and ``faults``, the kinds of fault in the timed path that the cell can have
(``altered``: an answer altered where it is produced; ``half``: half of each
batch left out)."""

import glob
import json
import os

TINY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
FAULT_KINDS = ("altered", "half")


def tiny(cell: str) -> dict:
    """The cell's tiny file: ``config`` and ``traffic`` (the overrides
    ``harness.run`` takes) and ``faults``."""
    path = os.path.join(TINY_DIR, f"{cell}.json")
    if not os.path.exists(path):
        checkout = os.path.dirname(os.path.dirname(os.path.dirname(TINY_DIR)))
        raise FileNotFoundError(
            f"cell {cell!r} has no CPU cut: add {os.path.relpath(path, checkout)} with its "
            f"'config' and 'traffic' overrides and its 'faults' (of {list(FAULT_KINDS)})")
    with open(path) as f:
        return json.load(f)


def list_tiny() -> list:
    """Every cell that has a tiny file."""
    return sorted(os.path.basename(p)[: -len(".json")]
                  for p in glob.glob(os.path.join(TINY_DIR, "*.json")))
