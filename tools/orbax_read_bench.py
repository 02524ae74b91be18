#!/usr/bin/env python3
"""Time the port's Orbax reader (``utils/orbax.py`` on ``csrc/zstd_decode.cpp``).

    python3 tools/orbax_read_bench.py [--resnet50]

Prints one JSON line per measurement, the host's CPU model first:
- ``zstd``: the decoder alone on the zstd frames of the committed fixture
  (``tests/fixtures/jax_orbax_squeezenet1_1``: squeezenet1_1's float32
  weights at zstd level 1, as Orbax writes them), output MB/s, best of 7;
- ``fixture``: ``read_orbax`` of that checkpoint, whole, median of 7 (the
  OCDBT walk, the zarr chunks and the tree), checkpoint MB/s;
- with ``--resnet50`` (needs the JAX package and orbax): a full-width
  resnet50 ``RetrievalNet``'s variables written by the JAX package's
  ``save_checkpoint`` into a temporary directory, read by ``read_orbax``
  and by orbax's restore (the JAX ``load_checkpoint``), median of 3 each.
The first line also gives the decoder's build time where this call built it.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "jax_orbax_squeezenet1_1", "best")


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def timed(fn, reps: int, pick=statistics.median) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return pick(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--resnet50", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np

    from image_retrieval_for_image_based_localization_tpu_torch.utils import orbax

    fresh = not os.path.exists(orbax.library_path())
    t0 = time.perf_counter()
    orbax._lib()
    print(json.dumps({"cpu": cpu_model(), "cores": os.cpu_count(),
                      "decoder_build_s": time.perf_counter() - t0 if fresh else None}))

    store = orbax.OcdbtStore(FIXTURE)
    frames = [bytes(v) for k, v in store.values.items()
              if not k.endswith(b"/.zarray") and bytes(v[:4]) == b"\x28\xb5\x2f\xfd"]
    store.close()
    sizes = [orbax.zstd_decompress(f).size for f in frames]
    s = timed(lambda: [orbax.zstd_decompress(f, n) for f, n in zip(frames, sizes)], 7, min)
    print(json.dumps({"zstd": "fixture frames", "frames": len(frames),
                      "in_bytes": sum(map(len, frames)), "out_bytes": sum(sizes),
                      "s": s, "out_mb_s": sum(sizes) / s / 1e6}))

    n = dir_bytes(FIXTURE)
    s = timed(lambda: orbax.read_orbax(FIXTURE), 7)
    print(json.dumps({"read_orbax": "fixture", "bytes": n, "s": s, "mb_s": n / s / 1e6}))

    if args.resnet50:
        import jax
        import jax.numpy as jnp

        from image_retrieval_for_image_based_localization_tpu.models.retrieval_net import (
            RetrievalNet,
        )
        from image_retrieval_for_image_based_localization_tpu.utils.checkpoint import (
            load_checkpoint,
            save_checkpoint,
        )

        net = RetrievalNet(arch="resnet50", pooling="gem")
        v = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, jax.tree.map(np.asarray, dict(v)), name="best")
            path = os.path.join(d, "best")
            n = dir_bytes(path)
            s_port = timed(lambda: orbax.read_orbax(path), 3)
            s_orbax = timed(lambda: load_checkpoint(d, name="best"), 3)
        print(json.dumps({"read_orbax": "resnet50", "bytes": n, "s": s_port,
                          "mb_s": n / s_port / 1e6, "orbax_restore_s": s_orbax}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
