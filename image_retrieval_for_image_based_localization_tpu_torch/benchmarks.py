"""Runners for the graded benchmark configs, the JAX package's
``benchmarks.py::run_graded_config`` for configs 1 to 5, and its
train-step throughput bench (:func:`run_training_bench`).

Each config runs on its dataset when it is on disk, else on the synthetic
corpus; gallery scale is reached with random, L2-normalized distractor
descriptors made on the device. The machinery (models, dtypes, scales,
whitening, kernels, streaming search, artifacts) is the config's own; only
pixel content is synthetic.

Configs 4 and 5 share their body after extraction,
:func:`run_gallery_scale`, callable on descriptors extracted elsewhere:
config 4 shards its 100k-row f32 gallery over a mesh
(``parallel.ShardedIndex``), config 5 searches its 1M-row bf16 gallery on
one device.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor
from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
    configdataset,
    make_synthetic_dataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.evaluation.harness import (
    evaluate_dataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.localization import (
    localization_recall,
    write_pairs_file,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.normalization import l2n
from image_retrieval_for_image_based_localization_tpu_torch.ops.whitening import (
    pca_whiten_learn,
    whiten_apply,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel.sharded_index import (
    ShardedIndex,
    sharded_knn,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import knn_search
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
    GRADED_CONFIGS,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import (
    MetricsLogger,
)

# config-4/5 gallery sizes; module-level so tests can run the whole path
# (bf16 gallery, artifact, pairs, recall) at toy scale
GALLERY_SCALE = {4: 100_000, 5: 1_000_000}
# rows whitened (and distractors made) per device block
WHITEN_BLOCK = 131_072
# distractor rows that join the core in the PCA learning set
PCA_DISTRACTORS = 50_000


def _timed_queries(fn, reps: int = 7):
    """Run a query fn ``reps`` times; return (last indices as numpy,
    latencies in seconds). Copying the indices to the host waits for the
    device."""
    lat = []
    idx = None
    for _ in range(reps):
        t0 = time.perf_counter()
        _, idx = fn()
        idx = idx.cpu().numpy()
        lat.append(time.perf_counter() - t0)
    return idx, np.asarray(lat)


def _latency_percentiles(lat: np.ndarray) -> Dict[str, float]:
    """Serving-style latency summary (seconds): p50/p95/p99 and mean over
    the timed repetitions of the query batch."""
    return {
        "lat_p50_s": float(np.percentile(lat, 50)),
        "lat_p95_s": float(np.percentile(lat, 95)),
        "lat_p99_s": float(np.percentile(lat, 99)),
        "lat_mean_s": float(np.mean(lat)),
    }


def _dataset(cfg, data_root: str, synth_root: str):
    try:
        return configdataset(cfg.dataset, data_root)
    except FileNotFoundError:
        name = f"synth-{cfg.dataset.replace('+', '-')}"
        return make_synthetic_dataset(
            synth_root, name=name, n_scenes=6, views_per_scene=4,
            n_distractors=8, image_hw=(120, 160), seed=13,
        )


def run_graded_config(
    n: int,
    data_root: Optional[str] = None,
    synth_root: Optional[str] = None,
    logger: Optional[MetricsLogger] = None,
    out_dir: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> Dict:
    """Run graded config ``n`` (1 to 5); returns a results dict.

    Configs 1-3 go through ``evaluate_dataset`` (config 3 first sets its
    NetVLAD head by k-means on the corpus). Configs 4 and 5 extract the core
    and the queries and hand them to :func:`run_gallery_scale` (config 4 on
    ``default_mesh``); ``out_dir`` is where config 5 writes the pairs file
    and the index artifact. The roots default to directories under the
    temporary directory.
    """
    cfg = GRADED_CONFIGS[n]
    tmp = tempfile.gettempdir()
    data_root = data_root or os.path.join(tmp, "irtpu_data")
    synth_root = synth_root or os.path.join(tmp, "irtpu_synth")
    logger = logger or MetricsLogger(echo=True)
    logger.log(config=n, name=cfg.name, note=cfg.note)
    dev = resolve_device(device)
    ds = _dataset(cfg, data_root, synth_root)

    if n in (1, 2, 3):
        extractor = None
        if cfg.extract.model.pooling == "netvlad":
            from image_retrieval_for_image_based_localization_tpu_torch.training.netvlad_init import (  # noqa: E501
                init_netvlad_from_images,
            )

            extractor = Extractor(cfg.extract, device=dev)
            sd = init_netvlad_from_images(extractor.model, ds.image_paths, cfg.extract)
            extractor = Extractor(cfg.extract, state_dict=sd, device=dev)
            logger.log(config=n, event="netvlad_kmeans_init",
                       clusters=cfg.extract.model.netvlad_clusters)
        out = evaluate_dataset(ds, cfg.extract, cfg.index, extractor=extractor, device=dev,
                               logger=logger)
        return {"config": cfg.name, "map": out["results"]}

    ex = Extractor(cfg.extract, device=dev)
    core = ex.extract(ds.image_paths)
    qd = ex.extract(ds.query_paths, bbxs=ds.query_bbxs)
    res = run_gallery_scale(
        n, core, qd, ds.gnd, logger=logger, out_dir=out_dir, device=dev,
        query_names=[os.path.basename(p) for p in ds.query_paths],
        db_names=[os.path.basename(p) for p in ds.image_paths])
    return {"config": res["config"], "top1_in_core": res["top1_in_core"]}


def run_gallery_scale(
    n: int,
    core: np.ndarray,
    qd: np.ndarray,
    gnd: Sequence[dict],
    logger: Optional[MetricsLogger] = None,
    out_dir: Optional[str] = None,
    device: DeviceLike = "cuda",
    query_names: Optional[Sequence[str]] = None,
    db_names: Optional[Sequence[str]] = None,
    mesh=None,
) -> Dict:
    """Configs 4 and 5 after extraction: the gallery at scale and its timed
    exact top-100; for config 4 sharded, with the exactness probe, for
    config 5 on one device, with localization recall and the artifacts.

    ``core`` [n_core, D] and ``qd`` [Nq, D] are the extracted database and
    query descriptors, ``gnd`` the queries' ground truth over the core rows.
    Distractors fill the gallery to ``GALLERY_SCALE[n]`` rows: random
    normals from ``torch.Generator(device).manual_seed(0)``, L2-normalized
    on the device. PCA whitening is learned on the core plus the first
    50,000 distractors, applied on the device in 131,072-row blocks and
    stored as f32 (config 4) or bf16 (config 5), queries alike.

    Config 4: the gallery is padded to whole shards of ``mesh`` (default
    ``default_mesh(device)``) and ``sharded_knn(k=100)`` is timed over 7
    repetitions (p50/p95/p99); then the exactness probe: the sharded
    indices must equal single-device ``knn_search`` bit for bit, or
    ``AssertionError``. Config 5: ``knn_search(gallery, q, k=100)`` is timed
    the same way and recall@(1, 5, 10, 20) of the shortlist is logged;
    with ``out_dir``, the pairs file, then ``Index.save(
    external_gallery=True)``, a reload and a top-1 probe on 4 queries.

    Returns ``config``, ``top1_in_core`` and, for a caller that checks the
    run, ``gallery`` (on the device), ``queries`` (whitened, stored dtype),
    ``indices`` [Nq, 100], ``latency_s``, ``recall`` (config 5),
    ``whitening`` (m, P), ``artifact`` (config 5: the reloaded ``Index``,
    or None without ``out_dir``) and, for config 4, ``sharded`` (the
    ``ShardedIndex``) and ``exact_match``.
    """
    if n not in GALLERY_SCALE:
        raise ValueError(f"graded config {n} has no gallery-scale run")
    cfg = GRADED_CONFIGS[n]
    logger = logger or MetricsLogger(echo=True)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    logger.log(config=n, event="provenance", backend=dev.type,
               device_kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
               n_devices=torch.cuda.device_count() if cuda else 1)
    core = np.asarray(core, np.float32)
    qd = np.asarray(qd, np.float32)
    n_total = GALLERY_SCALE[n]
    n_core, D = core.shape
    store = torch.float32 if n == 4 else torch.bfloat16

    gen = torch.Generator(device=dev).manual_seed(0)
    distract = l2n(torch.randn((n_total - n_core, D), generator=gen, device=dev))
    m = P = None
    if cfg.index.whitening == "pca":
        sample = distract[:PCA_DISTRACTORS].cpu().numpy()
        m, P = pca_whiten_learn(np.concatenate([core, sample], axis=0))
        mt, Pt = torch.from_numpy(m).to(dev), torch.from_numpy(P).to(dev)

        def store_fn(x):
            return whiten_apply(x, mt, Pt, cfg.index.whiten_dims).to(store)
    elif cfg.index.whitening is None:
        def store_fn(x):
            return x.to(store)
    else:
        raise ValueError(f"gallery scale runs PCA or no whitening, not "
                         f"{cfg.index.whitening!r}")
    first = store_fn(torch.from_numpy(core).to(dev))
    gallery = torch.empty((n_total, first.shape[1]), dtype=store, device=dev)
    gallery[:n_core] = first
    for i in range(0, distract.shape[0], WHITEN_BLOCK):
        block = distract[i : i + WHITEN_BLOCK]
        gallery[n_core + i : n_core + i + block.shape[0]] = store_fn(block)
    del distract, first
    q = store_fn(torch.from_numpy(qd).to(dev))

    if n == 4:
        return _sharded_gallery_run(n, cfg, gallery, q, n_core, logger, dev, mesh, (m, P))
    knn_search(gallery, q, k=100)  # warm-up, untimed
    idx, lat = _timed_queries(lambda: knn_search(gallery, q, k=100))
    logger.log(config=n, gallery=n_total, queries=len(qd), seconds=float(np.sum(lat)),
               queries_per_sec=len(qd) / float(np.median(lat)), storage="bfloat16",
               **_latency_percentiles(lat))

    # the positives are core rows (gallery[:n_core]), so gnd applies as it is
    rec = localization_recall(idx[:, :20], gnd, ks=(1, 5, 10, 20))
    logger.log(config=n, event="localization_recall",
               **{f"recall_at_{k}": v for k, v in rec["recall"].items()})

    reloaded = None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        qnames = list(query_names or [f"query{i}" for i in range(len(qd))])
        dbnames = list(db_names or [f"db{i}" for i in range(n_core)]) + [
            f"distractor{i}" for i in range(n_total - n_core)]
        ppath = write_pairs_file(os.path.join(out_dir, f"config{n}_pairs.txt"), qnames,
                                 dbnames, idx[:, :20])
        logger.log(config=n, event="pairs_written", path=ppath, n_pairs=int(idx.shape[0]) * 20)

        ipath = os.path.join(out_dir, f"config{n}_index.npz")
        t0 = time.perf_counter()
        Index(gallery=gallery, m=m, P=P, storage="bfloat16", device=dev).save(
            ipath, external_gallery=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reloaded = Index.load(ipath, device=dev)
        reloaded.device_gallery()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        reload_s = time.perf_counter() - t0
        if tuple(reloaded.gallery.shape) != tuple(gallery.shape):
            raise AssertionError("the reloaded artifact's gallery has another shape")
        # the reload whitens raw descriptors itself, in f32; only the top-1
        # (the high-margin core match) is held to the timed search
        _, ridx = reloaded.query(qd[:4], k=5)
        if not (np.asarray(ridx)[:, 0] == idx[:4, 0]).all():
            raise AssertionError("the memory-mapped, reloaded index disagrees with the "
                                 "in-memory top-1")
        gbytes = os.path.getsize(ipath.removesuffix(".npz") + ".gallery.npy")
        logger.log(config=n, event="index_artifact", path=ipath,
                   gallery_sidecar_bytes=int(gbytes), reload_query_probe="exact",
                   save_s=save_s, reload_s=reload_s)

    hit_core = float(np.mean(idx[:, 0] < n_core))
    logger.log(config=n, top1_in_core_fraction=hit_core)
    return {"config": cfg.name, "top1_in_core": hit_core, "gallery": gallery, "queries": q,
            "indices": idx, "latency_s": lat, "recall": rec, "whitening": (m, P),
            "artifact": reloaded}


def _sharded_gallery_run(n, cfg, gallery, q, n_core, logger, dev, mesh, whitening) -> Dict:
    """Config 4 after its gallery is built: the sharded top-100, timed, and
    the exactness probe against single-device ``knn_search``."""
    n_total = gallery.shape[0]
    sindex = ShardedIndex(gallery, mesh=mesh, device=dev)
    mesh = sindex.mesh

    def search():
        return sharded_knn(sindex.shards, q, k=100, mesh=mesh, n_valid=n_total)

    search()  # warm-up, untimed
    idx, lat = _timed_queries(search)
    logger.log(config=n, gallery=n_total, queries=len(q), seconds=float(np.sum(lat)),
               queries_per_sec=len(q) / float(np.median(lat)), storage="float32",
               mesh=mesh.shape, local_shards=mesh.local_shards, world_size=mesh.world_size,
               **_latency_percentiles(lat))
    # the distributed top-k must equal one device's answer bit for bit on
    # this very gallery, as the JAX package's probe holds its own
    _, i_ex = knn_search(gallery, q, k=100)
    exact_match = bool(np.array_equal(i_ex.cpu().numpy(), idx))
    logger.log(config=n, event="exactness_probe", sharded_equals_single_device=exact_match,
               k=100, n_valid=n_total)
    if not exact_match:
        raise AssertionError("config-4 sharded top-k disagrees with single-device exact "
                             "search at the graded scale")
    hit_core = float(np.mean(idx[:, 0] < n_core))
    logger.log(config=n, top1_in_core_fraction=hit_core)
    return {"config": cfg.name, "top1_in_core": hit_core, "gallery": gallery, "queries": q,
            "indices": idx, "latency_s": lat, "recall": None, "whitening": whitening,
            "artifact": None, "sharded": sindex, "exact_match": exact_match}


def run_training_bench(
    arch: str = "resnet50",
    pooling: str = "gem",
    image_size: int = 362,
    batch_tuples: int = 5,
    n_neg: int = 5,
    loss: str = "contrastive",
    remat: bool = False,
    dtype: str = "float32",
    reps: int = 10,
    warmup: int = 2,
    seed: int = 0,
    pallas: bool = False,
    device: DeviceLike = "cuda",
    profile: Optional[Callable[[Callable[[], None]], dict]] = None,
) -> Dict[str, float]:
    """Train-step throughput, the JAX package's ``run_training_bench``:
    tuples/s and images/s through ``training.loop.run_training``'s step
    (``from_u8=True``: normalize and mask on the device, mask-aware pooling,
    the tuple loss, backward, Adam) on a random uint8 tuple batch at
    cirtorch's training geometry (362 px, 5 negatives, tuples of 2 +
    n_neg images). ``pallas`` selects the kernel head.

    The batch sits on the device before the timed loop; ``warmup`` steps
    come first, and each timed step ends in ``torch.cuda.synchronize()``
    before the clock is read. ``profile``, when given, is called with a
    function that runs ``reps`` more steps (a profiler window, say), after
    the timed ones; what it returns goes under ``"profile"``.
    """
    from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
        RetrievalNet,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
        TrainConfig,
        create_train_state,
        make_train_step,
    )

    dev = resolve_device(device)
    model = RetrievalNet(arch=arch, pooling=pooling, dtype=dtype, use_kernel=pallas)
    cfg = TrainConfig(loss=loss, n_neg=n_neg, batch_tuples=batch_tuples, remat=remat)
    state = create_train_state(model, cfg, seed=seed, device=dev)
    step = make_train_step(model, cfg, from_u8=True)

    T = 2 + n_neg
    H = W = int(image_size)
    rng = np.random.RandomState(seed)
    px = torch.from_numpy(rng.randint(0, 256, (batch_tuples, T, H, W, 3)).astype(np.uint8)
                          ).to(dev)
    # full-frame extents: every pixel valid (training buckets are tight)
    sizes = torch.tensor([H, W], dtype=torch.int32).expand(batch_tuples, T, 2).contiguous().to(dev)
    labels = np.zeros((batch_tuples, T), np.int32)
    labels[:, 1] = 1
    labels[:, 2:] = -1
    labels = torch.from_numpy(labels).to(dev)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(max(warmup, 1)):
        state, lv = step(state, px, sizes, labels)
    sync()
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, lv = step(state, px, sizes, labels)
        sync()
        lat.append(time.perf_counter() - t0)
    loss_val = float(lv)
    lat = np.asarray(lat)
    med = float(np.median(lat))
    out = {
        "tuples_per_sec": round(batch_tuples / med, 2),
        "images_per_sec": round(batch_tuples * T / med, 2),
        "step_ms_median": round(med * 1e3, 2),
        "loss": round(loss_val, 6),
        "arch": arch,
        "pooling": pooling,
        "image_size": image_size,
        "batch_tuples": batch_tuples,
        "n_neg": n_neg,
        "remat": bool(remat),
        "dtype": dtype,
        "reps": reps,
    }
    pct = _latency_percentiles(lat)
    out.update({k.replace("_s", "_ms"): round(v * 1e3, 2) for k, v in pct.items()})
    if profile is not None:
        def more_steps() -> None:
            nonlocal state
            for _ in range(reps):
                state, _ = step(state, px, sizes, labels)
            sync()

        out["profile"] = profile(more_steps)
    return out
