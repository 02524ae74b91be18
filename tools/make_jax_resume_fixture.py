#!/usr/bin/env python3
"""Write the JAX package's training run that path N of ``chip_smoke.py``
resumes in the port.

    JAX_PLATFORMS=cpu python3 tools/make_jax_resume_fixture.py [--out DIR]

A tool: it runs the JAX package (on the CPU) and needs orbax. The JAX
trainer's ``_loss_fn`` asks flax for ``mutable=[]`` on a trunk without
BatchNorm and cannot unpack the pair flax returns, so the JAX package cannot
train squeezenet1_1 (ROADMAP C9); this process replaces that one function
by the same forward and loss written out for such a trunk (as
``tests/test_torch_train_rest.py`` does), and runs everything else, the CLI,
the loop, the optimizer, the train step and the checkpoint writer, as the
JAX package has it. It writes,
under ``tests/fixtures/jax_orbax_resume_squeezenet1_1/`` by default:

- ``latest/`` and ``latest.meta.json``: the JAX CLI's ``train`` (its
  ``run_training`` and ``save_checkpoint``, the real writer) for one epoch of
  ``chip_smoke.RESUME_RUN``: squeezenet1_1 + GeM at full width (~0.72 M
  parameters), Adam, ``--update-every 2``, lr 5e-4, on the synthetic pool of
  6 scenes x 4 views at 256 px, ``--qsize 10`` at 2 tuples a batch: 5
  micro-batches, so the epoch ends after 2 applied updates with one pending
  micro-batch (``mini_step`` 1, its gradient in ``acc_grads``). The run's
  ``best/``, ``whitening.npz`` and ``metrics.jsonl`` are deleted;
- ``jax_steps.npz``: the JAX train step (``make_train_step(from_u8=True)``,
  the plain head) from that state, restored by the JAX package's
  ``load_checkpoint(target=state)`` as its ``train --resume`` does, over
  ``chip_smoke.resume_tuples(0..2)`` (seeded u8 tuples,
  ``np.random.RandomState`` seeds 20-22), run in float64 under
  ``jax.enable_x64`` (the model's dtype, the parameters and the optimizer
  state; the normalized input stays the f32 the step makes), as the port's
  training tests hold it against the JAX loss in float64: ``losses`` [3]
  and ``params/<keys joined by />``, the parameters after them rounded to
  f32 (two applied updates, the first completing the pending one).

It prints one JSON line: the fixture's bytes, the state's step, mini_step
and update count, the losses, and the smallest ratio over tensors of how far
the JAX step's updates moved a tensor to path N's fixed bound (1e-6 of its
max|p|), which it requires to be at least 100. ``chip_smoke.py``'s path N
loads ``latest/`` on the card, repeats the three micro-steps against
``jax_steps.npz`` and resumes the run with the port's ``cli train``;
``tests/test_torch_resume.py`` runs N1 against it on the CPU.
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
DEFAULT_OUT = os.path.join(ROOT, "tests", "fixtures", "jax_orbax_resume_squeezenet1_1")
MIN_MOVE = 100.0  # the JAX updates against path N's fixed bound, per tensor


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from image_retrieval_for_image_based_localization_tpu.cli import main as jmain
    from image_retrieval_for_image_based_localization_tpu.models.retrieval_net import (
        RetrievalNet,
    )
    from image_retrieval_for_image_based_localization_tpu.ops import losses as jlosses
    from image_retrieval_for_image_based_localization_tpu.training import trainer
    from image_retrieval_for_image_based_localization_tpu.utils.checkpoint import (
        load_checkpoint,
    )

    bn_loss_fn = trainer._loss_fn

    def loss_fn(model, cfg, params, batch_stats, pixels, labels, mask=None):
        """``trainer._loss_fn``; for a trunk without BatchNorm the same
        forward and loss, without its ``mutable=[]`` (ROADMAP C9)."""
        if batch_stats or cfg.remat:
            return bn_loss_fn(model, cfg, params, batch_stats, pixels, labels, mask)
        B, T, H, W, C = pixels.shape
        fmask = None if mask is None else mask.reshape(B * T, H, W)
        desc = model.apply({"params": params}, pixels.reshape(B * T, H, W, C), mask=fmask,
                           train=True).reshape(B, T, -1)
        if cfg.loss == "contrastive":
            return jlosses.contrastive_loss(desc, labels, margin=cfg.margin), batch_stats
        return jlosses.triplet_loss(desc, margin=cfg.margin), batch_stats

    trainer._loss_fn = loss_fn
    shutil.rmtree(args.out, ignore_errors=True)
    with tempfile.TemporaryDirectory() as data:
        rc = jmain(["train", *chip_smoke.resume_cli_args(), "--epochs", "1",
                    "--data-root", data, "--out-dir", args.out])
    if rc not in (0, None):
        raise SystemExit(f"the JAX CLI's train returned {rc}")
    for name in ("best", "best.meta.json", "whitening.npz", "metrics.jsonl"):
        path = os.path.join(args.out, name)
        shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)

    r = chip_smoke.RESUME_RUN
    cfg = trainer.TrainConfig(**chip_smoke.resume_train_cfg())
    model = RetrievalNet(arch=r["arch"], pooling=r["pooling"])
    state, tx = trainer.create_train_state(model, jax.random.PRNGKey(0), cfg=cfg)
    tree, meta = load_checkpoint(args.out, name="latest", target=state)
    ms = tree["opt_state"]
    mini, count = int(ms.mini_step), int(ms.inner_opt_state[2].count)
    if mini != 1 or meta["epoch"] != 0:
        raise SystemExit(f"the run ended with mini_step {mini} at epoch {meta['epoch']}; "
                         f"path N needs one pending micro-batch after epoch 0")
    with jax.enable_x64(True):
        # the same step in float64: the JAX package's own f32 CPU gradients
        # lie ~1e-3 of max|g| from it (ROADMAP C9), the port's far closer
        def f64(a):
            a = np.asarray(a)
            return jnp.asarray(a, jnp.float64) if a.dtype.kind == "f" else jnp.asarray(a)

        model = RetrievalNet(arch=r["arch"], pooling=r["pooling"], dtype=jnp.float64)
        state = state.replace(params=jax.tree.map(f64, tree["params"]),
                              batch_stats=tree["batch_stats"],
                              opt_state=jax.tree.map(f64, tree["opt_state"]),
                              step=jnp.asarray(tree["step"]))
        start = chip_smoke.flat_tree(jax.tree.map(np.asarray, tree["params"]))
        step = trainer.make_train_step(model, tx, cfg, from_u8=True)
        losses = []
        for i in range(chip_smoke.RESUME_STEPS):
            px, sizes, labels = chip_smoke.resume_tuples(i)
            state, loss = step(state, jnp.asarray(px), jnp.asarray(sizes), jnp.asarray(labels))
            losses.append(float(loss))
        flat = chip_smoke.flat_tree(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                 state.params))
    moved = min(float(np.abs(v - start[k]).max()) /
                (chip_smoke.RESUME_PARAM_REL * float(np.abs(v).max())) for k, v in flat.items())
    if moved < MIN_MOVE:
        raise SystemExit(f"the JAX updates moved a tensor only {moved:.1f} x path N's bound")
    np.savez(os.path.join(args.out, "jax_steps.npz"), losses=np.asarray(losses, np.float64),
             **{f"params/{k}": v for k, v in flat.items()})
    n = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(args.out) for f in fs)
    print(json.dumps({"out": os.path.relpath(args.out, ROOT), "bytes": n,
                      "step": int(np.asarray(tree["step"])), "mini_step": mini,
                      "count": count, "losses": losses, "leaves": len(flat),
                      "parameters": int(sum(v.size for v in flat.values())),
                      "moved_over_bound_min": moved}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
