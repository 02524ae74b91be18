"""What the benchmark runs imports: never JAX, the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
``chip_smoke.py``, ``bench.py`` or the repository's tests; and the
reference imports nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from retrieval_bench import harness

FORBIDDEN = set(harness.FORBIDDEN) | {"chip_smoke", "bench", "tests"}
PORT = "image_retrieval_for_image_based_localization_tpu_torch"


def _modules_after(code: str) -> set:
    """Top-level module names a fresh interpreter holds after ``code``,
    beyond those it holds at start."""
    probe = ("import sys, json\nbase = {m.split('.')[0] for m in sys.modules}\n" + code +
             "\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules} - base)))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": harness.ROOT})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _bench_files():
    return sorted(p for p in glob.glob(os.path.join(harness.BENCH_DIR, "**", "*.py"),
                                       recursive=True) if os.sep + "tests" + os.sep not in p)


def test_a_whole_cell_loads_no_forbidden_module():
    code = "\n".join([
        "from retrieval_bench import harness, run, synth, trace",
        "from retrieval_bench.tools import readings",
        "b = harness.load_benchmark()",
        "for w in b['workloads']:",
        "    e, wl, c, t = harness.resolve(w['name'], b)",
        "    harness.load_module('drivers', t['driver'])",
        "for m in b['per_layer']:",
        "    harness.load_module('layer_metrics', m['name'])",
    ])
    loaded = _modules_after(code)
    assert PORT in loaded  # the system under test is loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("from retrieval_bench.reference import extract, search, resnet, lowp\n"
            "from retrieval_bench import roofline\n"
            "from retrieval_bench.roofline import resnet50, resnet101, fused_topk, gem_l2n, whiten")
    loaded = _modules_after(code)
    assert PORT not in loaded and not loaded & FORBIDDEN, loaded


@pytest.mark.parametrize("path", _bench_files(), ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_source_names_a_forbidden_module(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN, names & FORBIDDEN
    if os.sep + "reference" + os.sep in path or os.sep + "roofline" + os.sep in path:
        assert PORT not in names
