"""One run of one cell, driven by data. ``BENCHMARK.json`` (at the
checkout's root) names the cell's configuration and traffic and the metrics
it reports; each is a file of its own under this folder, found by name:
``workloads/<cell>.json`` (the cell and the limits of its comparison),
``configs/<config>.json``, ``traffic/<traffic>.json`` (which names its
driver, ``drivers/<driver>.py``) and ``layer_metrics/<metric>.py``."""

import copy
import gc
import glob
import importlib.util
import json
import os
import sys
import time
import types
from typing import Optional

import torch

from retrieval_bench import trace as tr_mod

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "image_retrieval_for_image_based_localization_tpu")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR) -> types.ModuleType:
    """``<kind>/<name>.py`` (a name may hold dots and dashes)."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"retrieval_bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def list_workloads(bench_dir: str = BENCH_DIR) -> list:
    """Every cell that has a workload file."""
    return sorted(os.path.basename(p)[: -len(".json")]
                  for p in glob.glob(os.path.join(bench_dir, "workloads", "*.json")))


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def end_to_end_of(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_of(bench: dict, cell: str) -> list:
    e2e = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def resolve(name: str, bench: dict, overrides: Optional[dict] = None,
            bench_dir: str = BENCH_DIR):
    """(BENCHMARK.json's entry, workload file, configuration, traffic) of a
    cell; ``overrides`` (tests) merges into the configuration and the
    traffic."""
    entry = cell_entry(bench, name)
    wl = load_json("workloads", name, bench_dir)
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names {wl['config']} x {wl['traffic']}, "
                         f"BENCHMARK.json {entry['config']} x {entry['traffic']}")
    overrides = overrides or {}
    cfg = _merge(load_json("configs", entry["config"], bench_dir), overrides.get("config"))
    traffic = _merge(load_json("traffic", entry["traffic"], bench_dir), overrides.get("traffic"))
    return entry, wl, cfg, traffic


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", overrides: Optional[dict] = None, bench: Optional[dict] = None,
        err=sys.stderr) -> dict:
    """Set up, measure, check: the result line's object. ``t_start`` is when
    the process started (set-up counts from there)."""
    bench = bench or load_benchmark()
    entry, wl, cfg, traffic = resolve(name, bench, overrides)
    device = torch.device(device)
    drv = load_module("drivers", traffic["driver"])
    torch.set_grad_enabled(False)
    cell = drv.Cell(cfg, traffic, seed, device)
    cell.setup()
    if trace and device.type == "cuda":
        with tr_mod.Window():  # the profiler's own first start, outside the window
            torch.ones(1, device=device).add_(1)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    window = None
    if trace:
        window = tr_mod.Window(tr_mod.trace_path(name))
        with window:
            cell.window(min(seconds, traffic["trace_seconds"]))
    else:
        cell.window(seconds)
    _sync(device)
    cell.after_window(bool(trace))
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if trace:
        ctx = types.SimpleNamespace(window=window, counters=cell.counters(), cell=name)
        for m in per_layer_of(bench, name):
            v = load_module("layer_metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        e2e = cell.end_to_end()
        for m in end_to_end_of(bench, name):
            v = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": entry["chips"],
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    result = {"correct": False, "attempted": cell.attempted(), "failed": 0,
              "metrics": metrics, "device": dev}
    if window is not None:
        dev["busy_s"] = window.busy_s()
        dev["window_s"] = window.wall_s
        result["breakdown"] = {"device_ops": window.device_ops(),
                               "idle_gaps": window.idle_gaps()}

    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.check()
    limits = wl["limits"]
    checks, ok = {}, set(numbers) == set(limits)
    for k in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(k, float("inf")), limits.get(k, float("nan"))
        good = v <= lim  # False for inf or nan on either side
        ok &= good
        checks[k] = {"value": v, "limit": lim}
        print(f"check {k} {v!r} limit {lim!r} {'ok' if good else 'FAILED'}", file=err)
    result["correct"] = bool(ok)
    result["checks"] = checks
    return result
