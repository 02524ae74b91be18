"""Port: data parallelism over the mesh's ``data`` axis (two gloo processes).

One pair of worker processes (this file run as a script, importing the port
only) runs every multi-process check and writes what it measured to a JSON
file; the tests below read it. The main process makes the inputs and the
JAX package's references, while the workers run:

  (a) the data-parallel train step (``make_train_step(mesh=...)``, a
      [2, 1] mesh, B = 4 tuples, two a process) against the port's
      one-process step on the same global batch with its BatchNorm on the
      same path over a group of one (``global_batch_stats``): the loss
      within 1e-5 (relative), every gradient within 1e-4 of its tensor's
      max|g| (or 1e-6), the BN running statistics within 1e-6 of each
      tensor's max and the parameters after the update within 1e-6 of max;
      masked u8 tuples with the kernel head, unmasked f32 with the plain
      head, and ``update_every=2``; and the loss of the step without a mesh
      (``F.batch_norm``) within 1e-5. With ``update_every=2`` each pending
      micro-batch is saved and loaded back as a resumed run does
      (``pending_gradients`` over the mesh's data group, ``set_pending_gradients``
      in every process): the group's values within the gradient bound of
      the one-process pending sum, and the update it completes held as
      above. Each update starts from the
      one-process weights (and statistics), each side keeping its own
      optimizer state: after one update the two sides' weights differ in
      their last bits (the gradients are summed in another order), and at
      this size ReLU and max-pool near-ties turn that into up to ~2.5e-2 of
      max|g| on the next gradient (measured; ROADMAP C10 records the same
      for vgg16 on the card). Independently of the port's own code, the
      first update's data-parallel gradients of the u8 and f32 cases are
      held against ``jax.grad`` of the JAX trainer's loss function in
      float64 (1e-4 of max|g|), and the data-parallel BatchNorm on each
      process's half of an untied batch against ``F.batch_norm``'s
      autograd on the whole batch (output and the input, weight and bias
      gradients within 1e-5 of max, running statistics within 1e-6);
      The same for a bf16 trunk (its gradient bound is BF16_GRAD_REL's) and
      for densenet121, each through the float64-summed BatchNorm;
  (b) the data-parallel loss against the JAX package's
      ``make_train_step(mesh=create_mesh([2, 1]))`` loss, in float64 as
      tests/test_torch_training.py holds one device (ROADMAP C9): 1e-5;
  (c) data-parallel extraction on a [2, 1] mesh (one shard a process) and
      a [4, 1] mesh (two local shards a process, run in turn) against one
      process's extraction (1e-6) and against the JAX ``Extractor(mesh=
      create_mesh([2, 1]))`` (2e-5);
  (d) ``ShardedIndex``, ``rank_candidates``, ``ShardedIVF`` and
      ``ShardedPQ`` on a 2 x 2 mesh (two processes x two local shards: each
      process holds one data row of the two gallery shards) bit for bit
      against one device's search on a gallery of planted ties, and
      ``evaluate_dataset(mesh=...)`` and ``cli evaluate --mesh 2x2
      --sharded`` against one process's mAP.

The tolerances: over a data group of several processes, train-mode
BatchNorm's sums accumulate in float64 (``models.resnet._BatchNormTrain``),
so a process's half of the batch yields the global batch's statistics and
the two steps' forward passes agree to the last bit but for rare double
roundings; the gradients then differ only by sums taken in another order.
``F.batch_norm``'s f32 statistics differ in the last bits (on the CPU with
two threads by ~1e-5, its one-pass sums), and on these batches the
near-ties above move resnet18's gradients by up to ~8e-2 of max|g| (and
3.6e-2 of it from the float64 truth): only the loss is held there.
Extraction in eval mode has no cross-row term and differs only by the
convolutions' batch size.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H, W = 4, 3, 64, 96
LOSS_REL, GRAD_REL, GRAD_ATOL, STATS_REL, PARAM_REL = 1e-5, 1e-4, 1e-6, 1e-6, 1e-6
EXTRACT_ONE_TOL, EXTRACT_JAX_TOL = 1e-6, 2e-5
# (name, arch, dtype, use_kernel, masked u8 input, update_every): each
# micro-batch is its own global batch of B tuples
TRAIN_CASES = [("u8-kernel", "resnet18", "float32", True, True, 1),
               ("f32-plain", "resnet18", "float32", False, False, 1),
               ("u8-kernel-update-every-2", "resnet18", "float32", True, True, 2),
               ("u8-kernel-bf16", "resnet18", "bfloat16", True, True, 1),
               ("u8-kernel-densenet121", "densenet121", "float32", True, True, 1)]
# a bf16 trunk: the conv weights' gradients are rounded to bf16 where the
# cast to bf16 sits in the graph, in each process on its half of the batch
# and in one process on the whole batch, so the two sides' gradients lie up
# to two bf16 roundings of max|g| apart (2^-7); everything else is as in f32,
# and an SGD update (momentum 0.9, each side its own buffer) moves a
# parameter by at most lr x 1.9 x that
BF16_GRAD_REL = 2.0 ** -7
# the step without a mesh takes F.batch_norm's statistics, whose last f32 bits
# differ (see below): in bf16 that flips roundings of the normalized maps by
# one bf16 ulp and the flips carry through the trunk, so the loss is held
# within one bf16 rounding (2^-8) there (measured: 3.5e-4)
BF16_LOSS_NO_MESH_REL = 2.0 ** -8
EXTRACT_SCALES = (1.0, 2 ** -0.5)
PROTOCOLS = ("easy", "medium", "hard")


def _batch(seed):
    """Seeded blocky u8 tuples [B, T, H, W, 3] with ragged valid extents and
    zeroed padding, their sizes and labels."""
    rng = np.random.RandomState(seed)
    px = (np.kron(rng.rand(B, T, H // 8, W // 8, 3), np.ones((1, 1, 8, 8, 1))) * 255
          ).astype(np.uint8)
    sizes = np.tile(np.array([[H, W], [H // 2, W], [H, W // 2 - 4]], np.int32), (B, 1, 1))
    for b in range(B):
        for t in range(T):
            h, w = sizes[b, t]
            px[b, t, h:, :] = 0
            px[b, t, :, w:] = 0
    labels = np.tile(np.array([[0, 1, -1]], np.int32), (B, 1))
    return px, sizes, labels


def _normalized(px):
    """The f32 step's pixels: ``(u8 / 255 - mean) / std``, every pixel valid."""
    return ((px.astype(np.float32) / 255.0 - np.asarray([0.485, 0.456, 0.406], np.float32))
            / np.asarray([0.229, 0.224, 0.225], np.float32)).astype(np.float32)


def _extract_images():
    rng = np.random.RandomState(3)
    return [(np.kron(rng.rand(*(s // 8 for s in shape), 3), np.ones((8, 8, 1))) * 255
             ).astype(np.uint8) for shape in [(64, 96), (96, 64), (64, 96), (96, 64), (64, 96),
                                              (64, 96), (96, 64)]]


def _train_cfg(update_every):
    from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
        TrainConfig,
    )

    return TrainConfig(loss="contrastive", margin=0.7, lr=1e-3, lr_decay=1.0,
                       weight_decay=1e-4, optimizer="sgd", momentum=0.9, n_neg=1,
                       batch_tuples=B, update_every=update_every)


# ---- the worker ------------------------------------------------------------------


def _worst(got, want, rel, atol=0.0):
    """max over tensors of max|got - want| / max(rel * max|want|, atol)."""
    worst = 0.0
    for k, w in want.items():
        bound = max(rel * float(w.abs().max()), atol)
        err = float((got[k] - w).abs().max())
        worst = max(worst, err / bound if bound > 0 else (0.0 if err == 0 else float("inf")))
    return worst


def _train_case(name, arch, dtype, use_kernel, u8, update_every, sd, mesh, alone, data_dir):
    import torch
    import torch.distributed as dist

    from image_retrieval_for_image_based_localization_tpu_torch.models import (
        RetrievalNet,
        init_random_,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (
        global_batch_stats,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
        create_train_state,
        make_train_step,
        pending_gradients,
        set_pending_gradients,
    )

    cfg = _train_cfg(update_every)
    if arch != "resnet18":
        sd = init_random_(RetrievalNet(arch, "gem"), torch.Generator().manual_seed(0)
                          ).state_dict()
    grad_rel = BF16_GRAD_REL if dtype == "bfloat16" else GRAD_REL
    states, steps = [], []
    for m in (None, mesh, None):
        model = RetrievalNet(arch, "gem", use_kernel=use_kernel, dtype=dtype)
        states.append(create_train_state(model, cfg, state_dict=sd, device="cpu", mesh=m))
        steps.append(make_train_step(model, cfg, mesh=m, from_u8=u8))
    one, dp, plain = states
    rec = {"loss_one": [], "loss_dp": [], "loss_no_mesh": [], "grad": [], "stats": [],
           "params": [], "pending": [], "applied": 0}
    for i in range(2 * update_every):
        if dp.micro == 0:  # each update starts from the one-process weights
            dp.model.load_state_dict(one.model.state_dict())
            plain.model.load_state_dict(one.model.state_dict())
        px, sizes, labels = _batch(10 + i)
        args = (px, sizes, labels) if u8 else (_normalized(px), labels)
        # one process on the global batch, its BatchNorm on the data-parallel
        # path over a group of one (float64 sums; no collective)
        with global_batch_stats(alone):
            rec["loss_one"].append(float(steps[0](one, *args)[1]))
        rec["loss_dp"].append(float(steps[1](dp, *args)[1]))
        _, loss = steps[2](plain, *args)
        rec["loss_no_mesh"].append(float(loss))
        if dp.micro:  # a pending update, saved and loaded back as a resumed run does
            pending = pending_gradients(dp, mesh)
            rec["pending"].append(_worst(pending, pending_gradients(one), grad_rel, GRAD_ATOL))
            set_pending_gradients(dp, pending, dp.micro)
        if dp.micro == 0:  # an applied update: its gradients, statistics, weights
            rec["applied"] += 1
            gw = {n: p.grad for n, p in one.model.named_parameters() if p.grad is not None}
            gg = {n: p.grad for n, p in dp.model.named_parameters() if p.grad is not None}
            assert gw.keys() == gg.keys() and gw
            rec["grad"].append(_worst(gg, gw, grad_rel, GRAD_ATOL))
            if i == 0 and update_every == 1:  # the first update, from sd: for JAX
                torch.save({n: g.clone() for n, g in gg.items()},
                           os.path.join(data_dir, f"grads-{name}-{dist.get_rank()}.pt"))
            sw, sg = one.model.state_dict(), dp.model.state_dict()
            stats = [k for k in sw if k.endswith(("running_mean", "running_var"))]
            rec["stats"].append(_worst({k: sg[k] for k in stats}, {k: sw[k] for k in stats},
                                       STATS_REL))
            pw = {n: p.detach() for n, p in one.model.named_parameters()}
            pg = {n: p.detach() for n, p in dp.model.named_parameters()}
            if dtype == "bfloat16":  # PARAM_REL of max|p| plus the update's share
                rec["params"].append(max(
                    float((pg[n] - w).abs().max()) / (PARAM_REL * float(w.abs().max())
                                                      + cfg.lr * 1.9 * grad_rel
                                                      * float(gw[n].abs().max()))
                    for n, w in pw.items()))
            else:
                rec["params"].append(_worst(pg, pw, PARAM_REL))
    rec["steps"] = (one.step, dp.step)
    assert torch.is_tensor(loss) and loss.dim() == 0
    # every conv weight trained (a bf16 trunk through the cast in the graph)
    rec["conv_grads"] = all(float(p.grad.abs().max()) > 0
                            for p in dp.model.parameters() if p.dim() == 4)
    return rec


def _batch_norm_check(rank):
    """The data-parallel BatchNorm (``global_batch_stats``) on this process's
    half of an untied batch against ``F.batch_norm``'s autograd on the whole
    batch in one process: the output and the input's gradient on this half,
    the weight's and bias's gradients summed over the processes, and the
    running statistics (flax's momentum, biased variance, from float64)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (
        bn_train,
        global_batch_stats,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.parallel.distributed import (
        all_reduce_sum,
    )

    g = torch.Generator().manual_seed(5)
    y = (torch.randn(8, 16, 6, 10, generator=g) * 2.0 + 1.5).to(
        memory_format=torch.channels_last)  # the same in both processes
    dout = torch.randn(8, 16, 6, 10, generator=g)
    bn = nn.BatchNorm2d(16)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(generator=g)
        bn.running_mean.normal_(generator=g)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
    ra = (bn.running_mean.clone(), bn.running_var.clone())
    w, b = bn.weight.detach().clone().requires_grad_(), bn.bias.detach().clone().requires_grad_()
    yw = y.clone().requires_grad_()
    want = F.batch_norm(yw, None, None, w, b, training=True, eps=bn.eps)
    want.backward(dout)
    rows = slice(4 * rank, 4 * rank + 4)
    yl = y[rows].clone().requires_grad_()
    with global_batch_stats(None):
        got = bn_train(bn, yl)
    got.backward(dout[rows])
    y64 = y.double()
    mean, var = y64.mean(dim=(0, 2, 3)), y64.var(dim=(0, 2, 3), unbiased=False)

    def rel(a, e):
        return float((a - e).abs().max() / e.abs().max())

    return {"out": rel(got.detach(), want.detach()[rows]),
            "dx": rel(yl.grad, yw.grad[rows]),
            "dw": rel(all_reduce_sum(bn.weight.grad), w.grad),
            "db": rel(all_reduce_sum(bn.bias.grad), b.grad),
            "running_mean": rel(bn.running_mean.double(), 0.9 * ra[0].double() + 0.1 * mean),
            "running_var": rel(bn.running_var.double(), 0.9 * ra[1].double() + 0.1 * var),
            "channels_last": got.is_contiguous(memory_format=torch.channels_last)}


def _sharded_checks(mesh):
    import torch

    from image_retrieval_for_image_based_localization_tpu_torch.parallel import (
        ShardedIndex,
        ShardedIVF,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.parallel.sharded_pq import (
        ShardedPQ,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import IVFIndex
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
        knn_search,
        rank_candidates,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import PQIndex

    rng = np.random.RandomState(0)  # the same gallery in both processes
    g = np.repeat(rng.randn(100, 32).astype(np.float32), 7, axis=0)[:699]  # ties, a pad row
    q = rng.randn(5, 32).astype(np.float32)
    si = ShardedIndex(g, mesh=mesh)
    s, i = si.query(q, k=20)
    s1, i1 = knn_search(torch.from_numpy(g), torch.from_numpy(q), 20)
    out = {"local_rows": si.local_rows, "shards": len(si.shards),
           "knn": bool((i == i1.numpy()).all() and (s == s1.numpy()).all())}
    cand = np.concatenate([i1.numpy()[:, :6], rng.randint(0, 699, (5, 4))], 1)
    r = si.rank_candidates(q, cand)
    r1 = rank_candidates(torch.from_numpy(g), torch.from_numpy(q), torch.from_numpy(cand))
    out["rank_candidates"] = bool((r == r1.numpy()).all())
    out["gallery_host"] = bool(torch.equal(si.gallery_host(), torch.from_numpy(g)))
    gu = g / np.linalg.norm(g, axis=1, keepdims=True)
    ivf = IVFIndex.build(gu, n_clusters=6, device="cpu")
    out["ivf"] = all(bool((ShardedIVF(ivf, mesh=mesh).search(q, k=15, nprobe=n)[1]
                           == ivf.search(q, k=15, nprobe=n)[1]).all()) for n in (2, 6))
    pq = PQIndex.build(gu, m=4, device="cpu")
    sp, ip = ShardedPQ(pq, mesh=mesh).search(q, k=15)
    sp1, ip1 = pq.search(q, k=15)
    out["pq"] = bool((ip == ip1).all() and (sp == sp1).all())
    return out


def _map_record(path):
    with open(path) as f:
        return next(r for r in map(json.loads, f) if r.get("event") == "map")


def _worker(port: int, rank: int, data_dir: str) -> None:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    import image_retrieval_for_image_based_localization_tpu_torch.api as port_api
    from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor
    from image_retrieval_for_image_based_localization_tpu_torch.cli import main as cli_main
    from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
        configdataset,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.evaluation import (
        evaluate_dataset,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.parallel import create_mesh
    from image_retrieval_for_image_based_localization_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
        ExtractConfig,
        IndexConfig,
        ModelConfig,
    )

    torch.set_num_threads(2)
    port_api.native_available = lambda: False  # PIL decode, no shared native build
    assert initialize_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
                                  device="cpu")
    assert initialize_distributed(device="cpu")  # joined already: stays in the group
    sd = torch.load(os.path.join(data_dir, "r18.pt"))
    out = {"world": dist.get_world_size(), "backend": dist.get_backend()}

    mesh = create_mesh([2, 1], devices=["cpu"])
    out["mesh21"] = [mesh.data_index(0), mesh.gallery_index(0), mesh.data_rows,
                     mesh.gallery_shards]
    out["batch_norm"] = _batch_norm_check(rank)
    # a group of this process alone (every rank makes each rank's group, in
    # one order)
    alone = [dist.new_group([r]) for r in (0, 1)][rank]
    out["train"] = {c[0]: _train_case(*c, sd=sd, mesh=mesh, alone=alone, data_dir=data_dir)
                    for c in TRAIN_CASES}

    cfg = ExtractConfig(model=ModelConfig(arch="resnet18", use_pallas=True), image_size=96,
                        scales=EXTRACT_SCALES, batch_size=3)
    images = _extract_images()
    one = Extractor(cfg, state_dict=sd, device="cpu").extract(images)
    ex = Extractor(cfg, state_dict=sd, device="cpu", mesh=mesh)
    d21 = ex.extract(images)
    mesh41 = create_mesh([4, 1], devices=["cpu", "cpu"])
    ex41 = Extractor(cfg, state_dict=sd, device="cpu", mesh=mesh41)
    d41 = ex41.extract(images)
    res = ex41.extract_resumable(images, os.path.join(data_dir, f"resume{rank}"), shard_size=4)
    np.save(os.path.join(data_dir, f"desc{rank}.npy"), d21)
    out["extract"] = {"batch_size": [ex.cfg.batch_size, ex41.cfg.batch_size],
                      "rows41": mesh41.data_rows,
                      "one_vs_21": float(np.abs(d21 - one).max()),
                      "one_vs_41": float(np.abs(d41 - one).max()),
                      "resumable": bool(np.array_equal(res, d41))}

    mesh22 = create_mesh([2, 2], devices=["cpu", "cpu"])
    out["mesh22"] = [[mesh22.data_index(j), mesh22.gallery_index(j)] for j in range(2)] + [
        mesh22.data_rows, mesh22.gallery_shards]
    out["sharded"] = _sharded_checks(mesh22)

    ds = configdataset("dptest", data_dir)
    ecfg = ExtractConfig(model=ModelConfig(arch="resnet18"), image_size=64, batch_size=2)
    base = evaluate_dataset(ds, ecfg, IndexConfig(whitening=None), state_dict=sd,
                            device="cpu")
    dp = evaluate_dataset(ds, ecfg, IndexConfig(whitening=None), state_dict=sd, device="cpu",
                          mesh=mesh22, use_sharded_index=True)
    out["evaluate"] = {"db": float(np.abs(dp["db"] - base["db"]).max()),
                       "queries": float(np.abs(dp["queries"] - base["queries"]).max()),
                       "map_one": {p: float(base["results"][p]["map"]) for p in PROTOCOLS},
                       "map_dp": {p: float(dp["results"][p]["map"]) for p in PROTOCOLS}}
    argv = ["evaluate", "--dataset", "dptest", "--data-root", data_dir, "--arch", "resnet18",
            "--image-size", "64", "--batch-size", "2", "--checkpoint",
            os.path.join(data_dir, "r18.pt"), "--device", "cpu"]
    tag = os.path.join(data_dir, f"cli{rank}")
    assert cli_main(argv + ["--metrics-out", tag + "-one.jsonl"]) == 0
    assert cli_main(argv + ["--mesh", "2x2", "--sharded", "--metrics-out",
                            tag + "-dp.jsonl"]) == 0
    out["cli"] = {k: {p: _map_record(f"{tag}-{k}.jsonl")[f"map_{p}"]
                      for p in PROTOCOLS} for k in ("one", "dp")}
    with open(os.path.join(data_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    print(f"DP_WORKER_OK rank={rank}", flush=True)


# ---- the tests ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the two workers, compute the JAX references meanwhile, and
    return (each rank's record, the references)."""
    import torch

    from image_retrieval_for_image_based_localization_tpu_torch.cli import main as cli_main
    from image_retrieval_for_image_based_localization_tpu_torch.models import (
        RetrievalNet,
        init_random_,
    )

    data_dir = str(tmp_path_factory.mktemp("dp"))
    net = RetrievalNet("resnet18", "gem")
    init_random_(net, torch.Generator().manual_seed(0))
    sd = net.state_dict()
    torch.save(sd, os.path.join(data_dir, "r18.pt"))
    assert cli_main(["synth", "--root", data_dir, "--name", "dptest", "--scenes", "2",
                     "--views", "2", "--distractors", "2"]) == 0
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(rank),
                               data_dir], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    try:
        refs = _jax_references(sd)
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"DP_WORKER_OK rank={rank}" in out, (rank, out[-3000:])
    recs = []
    for rank in (0, 1):
        with open(os.path.join(data_dir, f"rank{rank}.json")) as f:
            rec = json.load(f)
        rec["desc"] = np.load(os.path.join(data_dir, f"desc{rank}.npy"))
        rec["grads"] = {c: torch.load(os.path.join(data_dir, f"grads-{c}-{rank}.pt"))
                        for c in ("u8-kernel", "f32-plain")}
        recs.append(rec)
    return recs, refs


def _jax_references(sd):
    """The JAX package on the same weights: the [2, 1]-mesh train step's
    loss in float64 on the f32 case's first global batch; the gradients of
    the JAX trainer's loss function (``trainer._loss_fn``) in float64 on the
    first global batch of the u8 and f32 cases (as
    tests/test_torch_training.py's reference, the head in its XLA form); and
    the [2, 1]-mesh Extractor's descriptors."""
    import functools

    import jax
    import jax.numpy as jnp

    from irtpu.api import Extractor as JExtractor
    from irtpu.models import RetrievalNet as JNet
    from irtpu.models.torch_port import port_retrieval_net
    from irtpu.parallel import create_mesh as j_create_mesh
    from irtpu.training import trainer as jtrainer
    from irtpu.utils import config as jcfg

    from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
        variables_to_state_dict,
    )

    v = port_retrieval_net(sd, "resnet18")
    mesh = j_create_mesh([2, 1], devices=jax.devices()[:2])
    c = _train_cfg(1)
    cfg = jtrainer.TrainConfig(loss=c.loss, margin=c.margin, lr=c.lr, lr_decay=c.lr_decay,
                               weight_decay=c.weight_decay, optimizer=c.optimizer,
                               momentum=c.momentum, n_neg=c.n_neg, batch_tuples=c.batch_tuples)
    px, sizes, labels = _batch(10)
    grads = {}
    with jax.enable_x64(True):
        jm = JNet(arch="resnet18", pooling="gem", dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        grad_fn = jax.jit(jax.grad(functools.partial(jtrainer._loss_fn, jm, cfg), has_aux=True))
        x, mask = _masked(px, sizes)
        for case, xs, m in (("u8-kernel", x, jnp.asarray(mask)), ("f32-plain", _normalized(px),
                                                                   None)):
            g, _ = grad_fn(v64["params"], v64["batch_stats"], jnp.asarray(xs, jnp.float64),
                           jnp.asarray(labels), mask=m)
            sd_g = variables_to_state_dict(
                {"params": jax.tree.map(lambda a: np.asarray(a, np.float32), g),
                 "batch_stats": v["batch_stats"]}, "resnet18")
            grads[case] = {k: t for k, t in sd_g.items()
                           if not k.endswith(("running_mean", "running_var", "tracked"))}
        # the step donates its state's buffers: after the gradients
        state, tx = jtrainer.create_train_state(jm, None, cfg=cfg, variables=v64)
        step = jtrainer.make_train_step(jm, tx, cfg, mesh=mesh)
        _, loss = step(state, jnp.asarray(_normalized(px), jnp.float64), jnp.asarray(labels))
        loss64 = float(loss)
    ecfg = jcfg.ExtractConfig(model=jcfg.ModelConfig(arch="resnet18", use_pallas=True),
                              image_size=96, scales=EXTRACT_SCALES, batch_size=3)
    ex = JExtractor(ecfg, variables=jax.tree.map(jnp.asarray, v), mesh=mesh)
    return {"loss64": loss64, "grads": grads, "desc": np.asarray(ex.extract(_extract_images())),
            "batch_size": ex.cfg.batch_size}


def _masked(px, sizes):
    """The JAX u8 step's input: ``(u8 / 255 - mean) / std`` with the padding
    zeroed, and the pixel mask."""
    row = np.arange(H)[None, None, :, None]
    col = np.arange(W)[None, None, None, :]
    mask = (row < sizes[..., 0, None, None]) & (col < sizes[..., 1, None, None])
    return (_normalized(px) * mask[..., None]).astype(np.float32), mask


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_data_parallel_train_step_matches_one_process(runs, case):
    recs, _ = runs
    for rec in recs:
        r = rec["train"][case]
        assert r["applied"] == 2 and r["steps"][0] == r["steps"][1]
        assert len(r["pending"]) == (2 if "update-every-2" in case else 0)
        assert max(r["pending"], default=0.0) <= 1.0, r
        np.testing.assert_allclose(r["loss_dp"], r["loss_one"], rtol=LOSS_REL)
        # the step without a mesh (F.batch_norm's statistics) gives the loss too
        np.testing.assert_allclose(r["loss_no_mesh"], r["loss_one"],
                                   rtol=BF16_LOSS_NO_MESH_REL if "bf16" in case else LOSS_REL)
        assert max(r["grad"]) <= 1.0, r
        assert max(r["stats"]) <= 1.0, r
        assert max(r["params"]) <= 1.0, r
        assert r["conv_grads"], r
    # both processes hold the same global loss
    assert recs[0]["train"][case]["loss_dp"] == recs[1]["train"][case]["loss_dp"]


@pytest.mark.parametrize("case", ["u8-kernel", "f32-plain"])
def test_data_parallel_gradients_match_the_jax_loss_fn_in_float64(runs, case):
    """The first update's data-parallel gradients (each process's, after the
    all-reduce) against ``jax.grad`` of the JAX trainer's loss function in
    float64 on the same global batch: 1e-4 of each tensor's max|g|."""
    import torch

    recs, refs = runs
    want = refs["grads"][case]
    for rec in recs:
        got = rec["grads"][case]
        assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
        worst = max((float((got[k] - want[k]).abs().max())
                     / max(GRAD_REL * float(want[k].abs().max()), GRAD_ATOL), k) for k in got)
        assert worst[0] <= 1.0, (case, worst)
        assert float(got["pool.p"].abs().max()) > 0
    assert all(torch.equal(recs[0]["grads"][case][k], recs[1]["grads"][case][k])
               for k in recs[0]["grads"][case])


def test_data_parallel_batch_norm_matches_f_batch_norm(runs):
    """BatchNorm over two processes' halves of an untied batch against
    ``F.batch_norm``'s autograd on the whole batch: output, input, weight and
    bias gradients within 1e-5 of max, running statistics within 1e-6."""
    recs, _ = runs
    for rec in recs:
        r = rec["batch_norm"]
        assert r.pop("channels_last"), r
        assert max(r[k] for k in ("out", "dx", "dw", "db")) <= 1e-5, r
        assert max(r["running_mean"], r["running_var"]) <= 1e-6, r


def test_data_parallel_loss_matches_the_jax_mesh_step_in_float64(runs):
    recs, refs = runs
    np.testing.assert_allclose(recs[0]["train"]["f32-plain"]["loss_dp"][0], refs["loss64"],
                               rtol=LOSS_REL)


def test_data_parallel_extraction_matches_one_process_and_jax(runs):
    recs, refs = runs
    for rec in recs:
        e = rec["extract"]
        assert e["batch_size"] == [4, 4] and e["rows41"] == [0, 1] and e["resumable"]
        assert e["one_vs_21"] <= EXTRACT_ONE_TOL and e["one_vs_41"] <= EXTRACT_ONE_TOL, e
    assert refs["batch_size"] == 4  # the JAX Extractor rounds the batch up alike
    np.testing.assert_array_equal(recs[0]["desc"], recs[1]["desc"])
    np.testing.assert_allclose(recs[0]["desc"], refs["desc"], rtol=0, atol=EXTRACT_JAX_TOL)


def test_mesh_coordinates_and_groups_in_two_processes(runs):
    recs, _ = runs
    for rank, rec in enumerate(recs):
        assert rec["world"] == 2 and rec["backend"] == "gloo"
        assert rec["mesh21"] == [rank, 0, [0], [0]]
        # a 2 x 2 mesh: shard s = 2 * rank + j sits at (s // 2, s % 2)
        assert rec["mesh22"] == [[rank, 0], [rank, 1], [0], [0, 1]]


def test_sharded_search_on_a_2x2_mesh_is_one_devices(runs):
    recs, _ = runs
    for rec in recs:
        s = rec["sharded"]
        assert s == {"local_rows": 350, "shards": 2, "knn": True, "rank_candidates": True,
                     "gallery_host": True, "ivf": True, "pq": True}, s


def test_evaluate_dataset_and_cli_on_a_2x2_mesh(runs):
    recs, _ = runs
    for rec in recs:
        e = rec["evaluate"]
        assert e["db"] <= EXTRACT_ONE_TOL and e["queries"] <= EXTRACT_ONE_TOL, e
        assert e["map_dp"] == e["map_one"]
        assert rec["cli"]["dp"] == rec["cli"]["one"]


def test_extractor_on_a_mesh_in_one_process():
    """A [2, 1] mesh on two CPU shards of one process: each batch's two
    halves run in turn and come back in order; a batch of 3 rounds to 4."""
    import torch

    import image_retrieval_for_image_based_localization_tpu_torch as port
    from image_retrieval_for_image_based_localization_tpu_torch.models import (
        RetrievalNet,
        init_random_,
    )

    net = RetrievalNet("resnet18", "gem")
    init_random_(net, torch.Generator().manual_seed(1))
    cfg = port.ExtractConfig(model=port.ModelConfig(arch="resnet18"), image_size=96,
                             scales=EXTRACT_SCALES, batch_size=3)
    one = port.Extractor(cfg, state_dict=net.state_dict(), device="cpu")
    mesh = port.create_mesh([2, 1], devices=["cpu", "cpu"])
    ex = port.Extractor(cfg, state_dict=net.state_dict(), device="cpu", mesh=mesh)
    assert ex.cfg.batch_size == 4 and mesh.data_rows == [0, 1]
    images = _extract_images()
    np.testing.assert_allclose(ex.extract(images), one.extract(images), rtol=0,
                               atol=EXTRACT_ONE_TOL)
    x = _normalized(_batch(4)[0][:, 0])  # 4 rows
    np.testing.assert_allclose(ex(x[:3]), one(x[:3]), rtol=0, atol=EXTRACT_ONE_TOL)
    np.testing.assert_allclose(
        port.extract_features(images, cfg, state_dict=net.state_dict(), device="cpu",
                              mesh=mesh), one.extract(images), rtol=0, atol=EXTRACT_ONE_TOL)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
