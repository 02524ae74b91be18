#!/usr/bin/env python3
"""Write the JAX package's Orbax checkpoint that the port's reader is held to.

    JAX_PLATFORMS=cpu python3 tools/make_jax_orbax_fixture.py [--out DIR]

A tool: it runs the JAX package (on the CPU) and needs orbax. It writes,
under ``tests/fixtures/jax_orbax_squeezenet1_1/`` by default:

- ``best/`` and ``best.meta.json``: the JAX package's own
  ``utils.checkpoint.save_checkpoint(DIR, tree, meta, name="best")`` of the
  variables of ``RetrievalNet(arch="squeezenet1_1", pooling="gem")``
  initialised from ``PRNGKey(0)`` at full width (~0.72 M parameters), as
  ``{"params": ..., "batch_stats": {}}`` (squeezenet has no BatchNorm; the
  empty dict is stored as an empty node);
- ``tree.npz``: the same tree's arrays, each under its keys joined by ``/``;
- ``jax_descriptors.npz``: the JAX CLI's ``evaluate --checkpoint DIR --arch
  squeezenet1_1`` (f32, the plain head) on ``chip_smoke.py``'s path M corpus
  (``make_synthetic_dataset`` with ``chip_smoke.PATH_M_CORPUS``: PNG images,
  so every host decodes the same pixels): the database and query
  descriptors and the three mAPs.

``chip_smoke.py``'s path M reads ``best/`` on the card with the port, holds
every leaf bit for bit against ``tree.npz``, and runs the port's ``cli
evaluate`` on the same corpus against ``jax_descriptors.npz``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "fixtures", "jax_orbax_squeezenet1_1")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    import chip_smoke
    import image_retrieval_for_image_based_localization_tpu.evaluation.harness as jharness
    from image_retrieval_for_image_based_localization_tpu.cli import main as jmain
    from image_retrieval_for_image_based_localization_tpu.models.retrieval_net import (
        RetrievalNet,
    )
    from image_retrieval_for_image_based_localization_tpu.utils.checkpoint import (
        save_checkpoint,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
        make_synthetic_dataset,
    )

    model = RetrievalNet(arch="squeezenet1_1", pooling="gem")
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    tree = {"params": jax.tree.map(np.asarray, variables["params"]), "batch_stats": {}}
    shutil.rmtree(args.out, ignore_errors=True)
    os.makedirs(args.out)
    save_checkpoint(args.out, tree, meta={"arch": "squeezenet1_1", "pooling": "gem",
                                          "seed": 0}, name="best")
    flat = chip_smoke.flat_tree(tree)
    np.savez(os.path.join(args.out, "tree.npz"), **flat)

    seen = {}
    orig = jharness.evaluate_dataset

    def spy(*a, **k):
        r = orig(*a, **k)
        seen.update(r)
        return r

    with tempfile.TemporaryDirectory() as data:
        make_synthetic_dataset(data, **chip_smoke.PATH_M_CORPUS)
        jharness.evaluate_dataset = spy
        try:
            rc = jmain(["evaluate", "--dataset", chip_smoke.PATH_M_CORPUS["name"],
                        "--data-root", data, "--checkpoint", args.out, *chip_smoke.PATH_M_ARGS])
        finally:
            jharness.evaluate_dataset = orig
    if rc not in (0, None):
        raise SystemExit(f"the JAX CLI's evaluate returned {rc}")
    res = seen["results"]
    np.savez(os.path.join(args.out, "jax_descriptors.npz"),
             db=np.asarray(seen["db"], np.float32), queries=np.asarray(seen["queries"], np.float32),
             **{f"map_{p}": np.float64(res[p]["map"]) for p in ("easy", "medium", "hard")})
    n = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(args.out) for f in fs)
    print(json.dumps({"out": os.path.relpath(args.out, ROOT), "bytes": n,
                      "leaves": len(flat), "parameters": int(sum(v.size for v in flat.values())),
                      "db": list(np.shape(seen["db"])), "queries": list(np.shape(seen["queries"])),
                      "maps": {p: float(res[p]["map"]) for p in ("easy", "medium", "hard")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
