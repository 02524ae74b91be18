"""The training slice as a whole and its checkpoints: the port's
``training/loop.py`` and ``utils/checkpoint.py`` on a tiny synthetic pool
(resnet18, 64 px), and the port against the JAX package on the same pool
and weights: the same mined tuples, the same tuple batches, and two u8
train steps with the same losses (within 1e-5 relative: f32 forward and
backward in another order, one update apart)."""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from irtpu.api import Extractor as JExtractor
from irtpu.models import RetrievalNet as JNet
from irtpu.training import loop as jloop
from irtpu.training import mining as jmining
from irtpu.training import trainer as jtrainer
from irtpu.utils.config import ExtractConfig as JExtractConfig
from irtpu.utils.config import ModelConfig as JModelConfig

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
    variables_to_state_dict,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    RetrievalNet,
)
from image_retrieval_for_image_based_localization_tpu_torch.training import loop, mining
from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

SIZE = 64


def test_training_slice_matches_jax(tmp_path):
    jpool = jloop._synthetic_pool(str(tmp_path / "j"), n_scenes=4, views=3, hw=(48, 64))
    pool = loop._synthetic_pool(str(tmp_path / "t"), n_scenes=4, views=3, hw=(48, 64))
    paths, clusters, qidxs, pidxs, _ = pool
    for a, b in zip(pool[1:4], jpool[1:4]):
        np.testing.assert_array_equal(a, b)

    jm = JNet(arch="resnet18", pooling="gem", use_pallas=True)
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, SIZE, SIZE, 3))))
    sd = variables_to_state_dict(v, "resnet18")
    jex = JExtractor(JExtractConfig(model=JModelConfig(arch="resnet18"), image_size=SIZE,
                                    batch_size=8), variables=v)
    # the port takes the kernel head into mining too (its loop does); the JAX
    # loop mines with the XLA head
    cfg_ex = port.ExtractConfig(model=port.ModelConfig(arch="resnet18", use_pallas=True),
                                image_size=SIZE, batch_size=8)
    ex = port.Extractor(cfg_ex, state_dict=sd, device="cpu")
    kw = dict(clusters=clusters, n_neg=1, seed=0, qsize=6, poolsize=10)
    tuples = mining.mine_epoch_tuples(ex.extract, paths, qidxs, pidxs, device="cpu", **kw)
    jtuples = jmining.mine_epoch_tuples(jex.extract, jpool[0], qidxs, pidxs, **kw)
    for f in ("qidxs", "pidxs", "nidxs"):
        np.testing.assert_array_equal(getattr(tuples, f), getattr(jtuples, f))

    hw = loop.probe_bucket_shape(paths, SIZE)
    assert hw == jloop.probe_bucket_shape(jpool[0], SIZE)
    order = np.random.RandomState(0).permutation(len(tuples.qidxs))
    batches = list(loop.iter_tuple_batches(loop._ResizedImageCache(paths, SIZE), tuples, 2, hw,
                                           order=order))
    jbatches = list(jloop.iter_tuple_batches(jloop._ResizedImageCache(jpool[0], SIZE), jtuples,
                                             2, hw, order=order))
    assert len(batches) == len(jbatches) == 3
    for got, want in zip(batches, jbatches):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert any((s < np.asarray(hw)).any() for _, s, _ in batches)  # padding to mask

    cfg = TrainConfig(n_neg=1, batch_tuples=2, lr=1e-3, optimizer="sgd", momentum=0.9)
    # the variables above, which jm.init(PRNGKey(0)) at this shape would make again
    jstate, tx = jtrainer.create_train_state(jm, jax.random.PRNGKey(0), (SIZE, SIZE, 3),
                                             cfg=cfg, variables=v)
    jstep = jtrainer.make_train_step(jm, tx, cfg, from_u8=True)
    m = RetrievalNet(arch="resnet18", pooling="gem", use_kernel=True)
    state = create_train_state(m, cfg, state_dict=sd, device="cpu")
    step = make_train_step(m, cfg, from_u8=True)
    for px, sizes, labels in batches[:2]:
        jstate, jloss = jstep(jstate, jnp.asarray(px), jnp.asarray(sizes), jnp.asarray(labels))
        state, loss = step(state, px, sizes, labels)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == int(jstate.step) == 2


def _state(seed=0):
    cfg = TrainConfig(n_neg=1, lr=1e-3)
    return create_train_state(RetrievalNet(arch="resnet18"), cfg, seed=seed, device="cpu")


def test_checkpoint_round_trip_best_and_checkpoint_dir(tmp_path):
    state = _state()
    rng = np.random.RandomState(1)
    px = rng.rand(2, 3, 32, 32, 3).astype(np.float32)
    labels = np.tile(np.array([[0, 1, -1]], np.int32), (2, 1))
    state, _ = make_train_step(state.model, TrainConfig(n_neg=1, lr=1e-3))(state, px, labels)
    meta = {"arch": "resnet18", "epoch": 3}
    path = save_checkpoint(str(tmp_path), state, meta=meta, is_best=True)
    assert path == str(tmp_path / "latest")
    assert sorted(os.listdir(tmp_path)) == ["best", "best.meta.json", "latest",
                                            "latest.meta.json"]
    fresh = _state(seed=5)
    for where, name in ((str(tmp_path), "latest"), (str(tmp_path), "best"),
                        (str(tmp_path / "latest"), "latest")):
        got, got_meta = load_checkpoint(where, name=name, target=_state(seed=5))
        assert got_meta == meta and got.step == 1
        for (k, a), b in zip(state.model.state_dict().items(), got.model.state_dict().values()):
            assert torch.equal(a, b), k
        assert got.optimizer.state_dict()["state"].keys() == \
            state.optimizer.state_dict()["state"].keys()
        assert got.scheduler.last_epoch == state.scheduler.last_epoch == 1
    tree, _ = load_checkpoint(str(tmp_path))
    assert set(tree) == {"model", "optimizer", "scheduler", "step", "micro", "pending"}
    assert tree["micro"] == 0 and tree["pending"] == {}  # no accumulation pending
    assert not torch.equal(fresh.model.features.conv1.weight,
                           tree["model"]["features.conv1.weight"])


def _args(tmp_path, pooling="gem", epochs=1, resume=None, out="run", **kw):
    return argparse.Namespace(
        arch="resnet18", pooling=pooling, whiten_dim=None, loss="contrastive", margin=0.7,
        lr=1e-4, epochs=epochs, n_neg=1, batch_tuples=2, image_size=SIZE,
        out_dir=str(tmp_path / out), data_root=str(tmp_path / "data"), resume=resume,
        synth_scenes=4, synth_views=3, synth_hw=(48, 64), qsize=4, netvlad_clusters=4,
        pallas=True, **kw)


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_training_writes_checkpoints_whitening_and_metrics(tmp_path):
    r = loop.run_training(_args(tmp_path), device="cpu")
    run = tmp_path / "run"
    assert np.isfinite(r["best_loss"]) and r["epochs"] == 1
    assert {"latest", "best", "latest.meta.json", "best.meta.json", "whitening.npz",
            "metrics.jsonl"} <= set(os.listdir(run))
    w = np.load(run / "whitening.npz")
    assert w["m"].shape == (512,) and w["P"].shape[1] == 512
    recs = _records(run)
    mined = [x for x in recs if x.get("event") == "mined"]
    assert mined and mined[0]["tuples"] == 4 and mined[0]["seconds_extract"] > 0
    assert [x["epoch"] for x in recs if "train_loss" in x] == [0]
    assert any("val_map_medium" in x for x in recs)
    with open(run / "latest.meta.json") as f:
        assert json.load(f)["epoch"] == 0
    jpgs = sorted((tmp_path / "data").rglob("*.jpg"))  # the pool at synth_hw
    assert jpgs and Image.open(jpgs[0]).size == (64, 48)


def test_run_training_resumes_from_the_checkpoint_epoch(tmp_path):
    loop.run_training(_args(tmp_path), device="cpu")
    r = loop.run_training(_args(tmp_path, epochs=2, resume=str(tmp_path / "run")), device="cpu")
    assert r["epochs"] == 2
    recs = _records(tmp_path / "run")
    resumed = [x for x in recs if x.get("event") == "resumed"]
    assert resumed and resumed[0]["start_epoch"] == 1
    assert [x["epoch"] for x in recs if "train_loss" in x] == [0, 1]


def test_resume_without_an_epoch_keeps_the_netvlad_centroids(tmp_path, monkeypatch):
    """A checkpoint whose meta has no ``epoch`` resumes at epoch 0; the JAX
    loop then re-runs the k-means init over the trained centroids, the port
    never initializes on resume."""
    loop.run_training(_args(tmp_path, pooling="netvlad"), device="cpu")
    meta_path = tmp_path / "run" / "latest.meta.json"
    meta = json.loads(meta_path.read_text())
    del meta["epoch"]
    meta_path.write_text(json.dumps(meta))
    saved, _ = load_checkpoint(str(tmp_path / "run"))

    def refuse(*a, **k):
        raise AssertionError("NetVLAD re-initialized on resume")

    monkeypatch.setattr(loop, "init_netvlad_from_images", refuse)
    seen = {}
    real = loop.make_train_step

    def spy(model, cfg, **kw):  # the centroids the resumed run starts from
        seen["centroids"] = model.pool.centroids.detach().clone()
        return real(model, cfg, **kw)

    monkeypatch.setattr(loop, "make_train_step", spy)
    loop.run_training(_args(tmp_path, pooling="netvlad", resume=str(tmp_path / "run"),
                            out="run2"), device="cpu")
    assert torch.equal(seen["centroids"], saved["model"]["pool.centroids"])
    recs = _records(tmp_path / "run2")
    assert [x["start_epoch"] for x in recs if x.get("event") == "resumed"] == [0]
    assert not any(x.get("event") == "netvlad_kmeans_init" for x in recs)


def test_training_entry_points_need_cuda_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(RetrievalNet(arch="resnet18"), TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        mining.mine_hard_negatives(np.eye(4, dtype=np.float32), [0], [1], n_neg=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.run_training(_args(tmp_path))
