"""``train --resume`` of a run directory: the port's own, and the JAX
package's carried into the port (``training.trainer.load_jax_train_state``),
on the CPU.

- the port resumed from its own ``latest`` with a pending gradient
  accumulation (``--update-every 2``, an odd number of micro-batches an
  epoch) against the same run unbroken: bit for bit;
- optax's Adam and SGD state, the schedule's count and a pending
  ``MultiSteps`` accumulation, saved by the JAX package after it took
  updates and loaded into ``torch.optim``: the same further gradients
  through optax and through the port, parameters within 1e-6 of
  max(max|p|, 1) per tensor, the counts and the lr equal;
- ``cli train --resume`` of a JAX run against the JAX package's own resume
  of the same directory (f32 and bf16);
- a state that does not match the run's optimizer or ``update_every``
  raising, and the layout map of a params-shaped tree raising on a leaf or
  a parameter it cannot place;
- the committed fixture path N of ``chip_smoke.py`` reads on the card, its
  N1 check run here.
"""

import argparse
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from irtpu.cli import main as jmain
from irtpu.models import RetrievalNet as JNet
from irtpu.training import trainer as jtrainer
from irtpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from irtpu.utils.checkpoint import save_checkpoint as j_save_checkpoint

from image_retrieval_for_image_based_localization_tpu_torch.cli import main
from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
    params_to_state_dict,
    variables_to_state_dict,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    RetrievalNet,
)
from image_retrieval_for_image_based_localization_tpu_torch.training import loop
from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
    TrainConfig,
    apply_micro_step,
    create_train_state,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.checkpoint import (
    load_checkpoint,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (path N's N1 check, run here on the CPU)

PARAM_REL = 1e-6  # of max(max|p|, 1) per tensor, optax against torch.optim


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---- the port's own resume keeps a pending accumulation -----------------------


def _port_args(tmp_path, out, epochs, resume=None):
    """resnet18 at 64 px on 4 scenes x 3 views: qsize 6 at 2 tuples a batch
    is 3 micro-batches an epoch, so with --update-every 2 each epoch ends
    with one pending."""
    return argparse.Namespace(
        arch="resnet18", pooling="gem", whiten_dim=None, loss="contrastive", margin=0.7,
        lr=1e-3, epochs=epochs, n_neg=1, batch_tuples=2, image_size=64, update_every=2,
        out_dir=str(tmp_path / out), data_root=str(tmp_path / "data"), resume=resume,
        synth_scenes=4, synth_views=3, synth_hw=(48, 64), qsize=6, pallas=True)


def test_port_resume_keeps_a_pending_accumulation(tmp_path):
    loop.run_training(_port_args(tmp_path, "unbroken", 2), device="cpu")
    loop.run_training(_port_args(tmp_path, "broken", 1), device="cpu")
    mid, _ = load_checkpoint(str(tmp_path / "broken"))
    loop.run_training(_port_args(tmp_path, "broken", 2, resume=str(tmp_path / "broken")),
                      device="cpu")
    want, _ = load_checkpoint(str(tmp_path / "unbroken"))
    got, _ = load_checkpoint(str(tmp_path / "broken"))
    losses = {tag: [r["train_loss"] for r in _records(tmp_path / tag) if "train_loss" in r]
              for tag in ("unbroken", "broken")}
    # the resumed run as the unbroken one: its epoch losses, the updates its
    # schedule counted, and the worst state entry off, over its tensor's max
    worst = max(float((got["model"][k].double() - v.double()).abs().max()
                      / max(float(v.double().abs().max()), 1e-30))
                for k, v in want["model"].items() if v.is_floating_point())
    assert (losses["broken"], got["scheduler"]["last_epoch"], worst) == \
        (losses["unbroken"], want["scheduler"]["last_epoch"], 0.0)
    for i, s in want["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)
    assert mid["step"] == 3 and mid["micro"] == 1 and mid["pending"]
    assert got["step"] == want["step"] == 6 and got["micro"] == want["micro"] == 0


def test_a_checkpoint_written_before_micro_was_kept_loads_with_none_pending(tmp_path):
    """A port checkpoint without ``micro`` and ``pending`` (as the port wrote
    them before it kept a pending accumulation) loads with none pending."""
    cfg = TrainConfig(n_neg=1, lr=1e-3, update_every=2)
    state = create_train_state(RetrievalNet(arch="resnet18"), cfg, seed=1, device="cpu")
    px = np.random.RandomState(2).rand(2, 3, 32, 32, 3).astype(np.float32)
    labels = np.tile(np.array([[0, 1, -1]], np.int32), (2, 1))
    from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
        make_train_step,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.checkpoint import (
        STATE_FILE,
        save_checkpoint,
    )

    state, _ = make_train_step(state.model, cfg)(state, px, labels)
    assert state.micro == 1
    save_checkpoint(str(tmp_path), state, meta={"epoch": 0})
    path = tmp_path / "latest" / STATE_FILE
    tree = torch.load(path, weights_only=True)
    assert tree["micro"] == 1 and set(tree["pending"]) == {n for n, _ in
                                                            state.model.named_parameters()}
    del tree["micro"], tree["pending"]
    torch.save(tree, path)
    got, _ = load_checkpoint(str(tmp_path), target=create_train_state(
        RetrievalNet(arch="resnet18"), cfg, seed=5, device="cpu"), cfg=cfg)
    assert got.step == 1 and got.micro == 0
    assert all(p.grad is None for p in got.model.parameters())


# ---- optax's state carried into torch.optim ------------------------------------

# conv kernels (HWIO), biases, GeM's p and the whitening's transposed
# kernel at full width (~0.74 M parameters); BatchNorm's and NetVLAD's
# leaves are held by the layout test below
OPT_ARCH = dict(arch="squeezenet1_1", pooling="gem", whiten_dim=32)
OPT_CASES = [("adam", 1), ("adam", 2), ("sgd", 1), ("sgd", 2)]


def _opt_cfg(optimizer, k):
    return TrainConfig(optimizer=optimizer, lr=0.01, lr_decay=0.5, steps_per_epoch=2,
                       weight_decay=0.01, momentum=0.9, update_every=k)


def _random_grads(tree, rng):
    return jax.tree.map(lambda p: jnp.asarray(
        np.asarray(rng.randn(*p.shape), np.float32) * np.float32(10.0 ** rng.randint(-3, 1))),
        tree)


@pytest.fixture(scope="module")
def jax_states(tmp_path_factory):
    """For each (optimizer, update_every): a JAX run directory whose
    ``latest`` has taken 3 applied updates of random gradients (and, with
    update_every 2, holds one pending micro-batch), the JAX state itself
    and its tx."""
    base = tmp_path_factory.mktemp("jax_states")
    jm = JNet(**OPT_ARCH)
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 32, 32, 3))))
    out = {}
    for optimizer, k in OPT_CASES:
        cfg = _opt_cfg(optimizer, k)
        state, tx = jtrainer.create_train_state(jm, jax.random.PRNGKey(0), (32, 32, 3),
                                                cfg=cfg, variables=v)
        rng = np.random.RandomState(11)
        params, opt_state = state.params, state.opt_state
        update = jax.jit(tx.update)
        for _ in range(3 * k + (k > 1)):
            upd, opt_state = update(_random_grads(params, rng), opt_state, params)
            params = optax.apply_updates(params, upd)
        state = state.replace(params=params, opt_state=opt_state, step=3 * k + (k > 1))
        d = str(base / f"{optimizer}-{k}")
        j_save_checkpoint(d, state, meta={"epoch": 0, **OPT_ARCH})
        out[(optimizer, k)] = (d, state, tx)
    return out


def _port_state(cfg):
    return create_train_state(RetrievalNet(**OPT_ARCH), cfg, device="cpu")


@pytest.mark.parametrize("optimizer,k", OPT_CASES, ids=[f"{o}-{k}" for o, k in OPT_CASES])
def test_jax_optimizer_state_carries_into_torch(jax_states, optimizer, k):
    d, jstate, tx = jax_states[(optimizer, k)]
    cfg = _opt_cfg(optimizer, k)
    state, meta = load_checkpoint(d, target=_port_state(cfg), cfg=cfg)
    assert meta["epoch"] == 0 and state.step == int(jstate.step) and state.micro == (k > 1)
    opt, sched = state.optimizer, state.scheduler
    inner = jstate.opt_state.inner_opt_state if k > 1 else jstate.opt_state
    count = int(inner[2].count)
    assert count == 3 and sched.last_epoch == count
    names = [n for n, _ in state.model.named_parameters()]
    if optimizer == "adam":
        assert {float(s["step"]) for s in opt.state.values()} == {float(count)}
        mu = params_to_state_dict(jax.tree.map(np.asarray, inner[1].mu), OPT_ARCH["arch"], names)
        for n, p in state.model.named_parameters():
            assert torch.equal(opt.state[p]["exp_avg"], mu[n]), n
    want_lr = np.float32(cfg.lr) * np.float32(cfg.lr_decay) ** np.floor(
        np.float32(count) / np.float32(cfg.steps_per_epoch))
    assert np.float32(opt.param_groups[0]["lr"]) == np.float32(want_lr)
    if k > 1:  # the pending micro-batch: its gradient as .grad
        acc = params_to_state_dict(jax.tree.map(np.asarray, jstate.opt_state.acc_grads),
                                   OPT_ARCH["arch"], names)
        for n, p in state.model.named_parameters():
            assert torch.equal(p.grad, acc[n]), n

    params, opt_state = jstate.params, jstate.opt_state
    update = jax.jit(tx.update)
    for i in range(3 * k - (k > 1)):  # completes the pending update, then two more
        g = _random_grads(params, np.random.RandomState(100 + i))
        upd, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
        gt = params_to_state_dict(jax.tree.map(np.asarray, g), OPT_ARCH["arch"], names)
        if state.micro == 0:
            opt.zero_grad(set_to_none=True)
        for n, p in state.model.named_parameters():
            p.grad = gt[n].clone() if p.grad is None else p.grad + gt[n]
        apply_micro_step(state, k)
        want = params_to_state_dict(jax.tree.map(np.asarray, params), OPT_ARCH["arch"], names)
        for n, p in state.model.named_parameters():
            err = float((p.detach() - want[n]).abs().max())
            bound = PARAM_REL * max(float(want[n].abs().max()), 1.0)
            assert err <= bound, (i, n, err, bound)
    assert state.micro == 0 and sched.last_epoch == count + 3
    moved = params_to_state_dict(jax.tree.map(np.asarray, jstate.params), OPT_ARCH["arch"], names)
    assert max(float((p.detach() - moved[n]).abs().max())
               for n, p in state.model.named_parameters()) > 1e-3  # the parameters moved


# ---- cli train --resume of a JAX run, against the JAX package's own resume ----

CLI_RUN = ["--arch", "resnet18", "--image-size", "64", "--synthetic", "--synth-scenes", "4",
           "--synth-views", "3", "--qsize", "6", "--n-neg", "1", "--batch-tuples", "2",
           "--update-every", "2", "--lr", "1e-4"]
# f32: the epoch-1 loss as test_torch_train_loop.py's slice holds the two
# packages' steps (1e-5 relative); the parameters as a whole within 1e-2 of
# the JAX resume's update (measured 7.0e-4; the pending micro-batch dropped:
# 0.66), each BN statistic within 1e-4 of its tensor's max (measured 1.8e-5)
CLI_LOSS_REL, CLI_UPDATE_REL, CLI_STATS_REL = 1e-5, 1e-2, 1e-4
# bf16: a bf16 run is chaotic at this scale (the two packages' bf16 resumes
# lie 0.18 of the update apart), so the port's bf16 resume must lie as far
# from the JAX f32 resume as the JAX bf16 resume does, within 1.5x either way
# (test_torch_train_bf16.py's rule for a bf16 step), its epoch-1 loss within
# 1e-2 and its statistics within 2^-5 of each tensor's max of the JAX bf16 one
BF16_SPREAD, BF16_LOSS_REL, BF16_STATS_REL = 1.5, 1e-2, 2.0 ** -5


def _jax_sd(run_dir):
    tree, _ = j_load_checkpoint(run_dir, name="latest")
    return variables_to_state_dict({"params": tree["params"],
                                    "batch_stats": tree["batch_stats"]}, "resnet18"), tree


def _epoch_losses(run_dir):
    return [r["train_loss"] for r in _records(run_dir) if "train_loss" in r]


@pytest.fixture(scope="module")
def jax_cli_runs(tmp_path_factory):
    """The JAX CLI's epoch 0 (f32, Adam, --update-every 2 over 3 micro-batches:
    its latest holds one pending) and the JAX CLI's own --resume of a copy of
    it to 2 epochs, in f32 and in bf16."""
    base = tmp_path_factory.mktemp("jax_cli")
    data = ["--data-root", str(base / "data")]
    runs = {"epoch0": str(base / "epoch0")}
    assert (jmain(["train", *CLI_RUN, *data, "--epochs", "1", "--out-dir", runs["epoch0"]])
            or 0) == 0
    for dtype in ("float32", "bfloat16"):
        d = runs[dtype] = str(base / dtype)
        shutil.copytree(runs["epoch0"], d)
        assert (jmain(["train", *CLI_RUN, *data, "--dtype", dtype, "--epochs", "2",
                       "--out-dir", d, "--resume", d]) or 0) == 0
    return runs, data


def _update_distance(got, want, start):
    """||p - p_want|| / ||p_want - p_start|| over the parameters."""
    keys = [k for k, v in want.items() if v.is_floating_point() and "running" not in k]
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in keys)
    den = sum(float(((want[k].double() - start[k].double()) ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def _stats_worst(got, want):
    return max(float((got[k] - want[k]).abs().max()) / float(want[k].abs().max())
               for k in want if "running" in k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_cli_train_resume_of_a_jax_run_matches_the_jax_resume(jax_cli_runs, dtype, tmp_path):
    runs, data = jax_cli_runs
    port = str(tmp_path / "port")
    shutil.copytree(runs["epoch0"], port)
    assert main(["train", *CLI_RUN, *data, "--dtype", dtype, "--epochs", "2", "--out-dir", port,
                 "--resume", port, "--device", "cpu"]) == 0
    assert [r["start_epoch"] for r in _records(port) if r.get("event") == "resumed"] == [1]
    got, meta = load_checkpoint(port)  # this package's checkpoint now, not Orbax's
    assert meta["epoch"] == 1 and set(got) >= {"model", "optimizer", "micro"}
    want, jtree = _jax_sd(runs[dtype])
    start, stree = _jax_sd(runs["epoch0"])
    assert int(stree["step"]) == 3 and int(stree["opt_state"]["mini_step"]) == 1
    assert got["step"] == int(jtree["step"]) == 6 and got["micro"] == 0
    loss, jloss = _epoch_losses(port)[-1], _epoch_losses(runs[dtype])[-1]
    dist = _update_distance(got["model"], want, start)
    stats = _stats_worst(got["model"], want)
    if dtype == "float32":
        assert loss == pytest.approx(jloss, rel=CLI_LOSS_REL)
        assert dist <= CLI_UPDATE_REL, dist
        assert stats <= CLI_STATS_REL, stats
    else:
        f32, _ = _jax_sd(runs["float32"])
        ours, theirs = (_update_distance(got["model"], f32, start),
                        _update_distance(want, f32, start))
        assert theirs / BF16_SPREAD <= ours <= theirs * BF16_SPREAD, (ours, theirs)
        assert loss == pytest.approx(jloss, rel=BF16_LOSS_REL)
        assert stats <= BF16_STATS_REL, stats


def test_resume_refuses_a_mismatched_optimizer(jax_states):
    d, _, _ = jax_states[("adam", 1)]
    with pytest.raises(ValueError, match="--optimizer sgd"):
        load_checkpoint(d, target=_port_state(_opt_cfg("sgd", 1)), cfg=_opt_cfg("sgd", 1))
    with pytest.raises(ValueError, match="update_every 2"):
        load_checkpoint(d, target=_port_state(_opt_cfg("adam", 2)), cfg=_opt_cfg("adam", 2))
    d2, _, _ = jax_states[("sgd", 2)]
    with pytest.raises(ValueError, match="MultiSteps.*update_every 1"):
        load_checkpoint(d2, target=_port_state(_opt_cfg("sgd", 1)), cfg=_opt_cfg("sgd", 1))
    with pytest.raises(ValueError, match="cfg="):
        load_checkpoint(d, target=_port_state(_opt_cfg("adam", 1)))


def test_params_to_state_dict_maps_like_the_weights_and_names_what_it_cannot_place():
    """A params-shaped tree lands where the weights do (NetVLAD's assign_w
    transposed, the HWIO kernels, BN's scale and bias); a leaf or a
    parameter it cannot place raises with its name."""
    jm = JNet(arch="resnet18", pooling="netvlad", netvlad_clusters=4)
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(3),
                                                  jnp.zeros((1, 32, 32, 3))))
    m = RetrievalNet(arch="resnet18", pooling="netvlad", netvlad_clusters=4)
    names = [n for n, _ in m.named_parameters()]
    got = params_to_state_dict(v["params"], "resnet18", names)
    want = variables_to_state_dict(v, "resnet18")
    assert list(got) == names
    for n in names:
        assert torch.equal(got[n], want[n]), n
    extra = dict(v["params"], stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="stray/kernel"):
        params_to_state_dict(extra, "resnet18", names)
    short = dict(v["params"])
    del short["assign_b"]
    with pytest.raises(ValueError, match="assign_b"):
        params_to_state_dict(short, "resnet18", names)
    with pytest.raises(ValueError, match="pool.p"):
        params_to_state_dict(v["params"], "resnet18", names + ["pool.p"])


def test_committed_resume_fixture_loads():
    """Path N's N1 on the CPU: the committed JAX run directory's latest,
    loaded into a port TrainState, bit for bit against the tree read from
    it; the fixture within its 16 MB."""
    state, _, tree, out = chip_smoke.resume_n1("cpu")
    assert all(out["checks"].values()), out
    assert (out["count"], out["mini_step"], out["step"]) == (2, 1, 5)
    assert state.micro == 1 and state.scheduler.last_epoch == 2
    fixture = os.path.join(ROOT, chip_smoke.RESUME_FIXTURE)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(fixture) for f in fs)
    assert size <= 16 * 2 ** 20, size
