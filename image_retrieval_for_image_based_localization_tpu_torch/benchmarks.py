"""Runners for the graded benchmark configs, the JAX package's
``benchmarks.py::run_graded_config`` for configs 1 to 5, and its
benches: the bucketed-vs-exact extraction delta
(:func:`measure_bucketing_delta`), disk-to-descriptor throughput split into
decode, device and end to end (:func:`run_full_system_bench`), train-step
throughput (:func:`run_training_bench`), the recall-vs-q/s sweep of the
search family (:func:`run_ann_bench`) and the closed-loop load test of the
HTTP server (:func:`run_serving_bench`).

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
    device (the IVF and PQ searches return host arrays already)."""
    lat = []
    idx = None
    for _ in range(reps):
        t0 = time.perf_counter()
        _, idx = fn()
        idx = idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
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


def measure_bucketing_delta(
    arch: str = "resnet50",
    image_size: int = 1024,
    synth_root: str = os.path.join(tempfile.gettempdir(), "irtpu_synth"),
    batch_size: int = 8,
    state_dict: Optional[Dict] = None,
    logger: Optional[MetricsLogger] = None,
    device: DeviceLike = "cuda",
) -> Dict:
    """The bucketed-padding vs exact-shape extraction delta, the JAX
    package's ``measure_bucketing_delta``.

    Bucketed batches pad images inside their (stride-rounded) bucket; conv
    features near the boundary see zeros though pooling is masked, so
    descriptors differ slightly from the reference's one-image exact-shape
    run. Two measures, one model's weights (``state_dict``, else the
    extractor's seeded random init) in both extractors:

      1. medium-protocol mAP on the synthetic corpus (6 scenes x 4 views, 8
         distractors, 120 x 160, seed 13), bucketed against
         ``ExtractConfig(exact=True)``, and their difference ``map_delta``;
      2. per-image cosine between the two on an aspect-varied stress set of
         five shapes from ``RandomState(0)`` (worst-case bucket padding):
         ``stress_cos_mean`` and ``stress_cos_min``.

    On the card both extractors take the kernel head (``use_pallas``), on
    the CPU its plain version.
    """
    import dataclasses

    from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (
        compute_map_revisited,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import full_ranks
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
        ExtractConfig,
        ModelConfig,
    )

    dev = resolve_device(device)
    logger = logger or MetricsLogger(echo=True)
    ds = make_synthetic_dataset(synth_root, name="synth-delta", n_scenes=6, views_per_scene=4,
                                n_distractors=8, image_hw=(120, 160), seed=13)
    cfg_b = ExtractConfig(model=ModelConfig(arch=arch, use_pallas=dev.type == "cuda"),
                          image_size=image_size, batch_size=batch_size)
    cfg_e = dataclasses.replace(cfg_b, exact=True)
    ex_b = Extractor(cfg_b, state_dict=state_dict, device=dev)
    ex_e = Extractor(cfg_e, state_dict=ex_b.model.state_dict(), device=dev)

    results = {}
    for name, ex in (("bucketed", ex_b), ("exact", ex_e)):
        db = ex.extract(ds.image_paths)
        qd = ex.extract(ds.query_paths, bbxs=ds.query_bbxs)
        ranks = full_ranks(torch.from_numpy(db).to(dev), torch.from_numpy(qd).to(dev))
        results[name] = float(compute_map_revisited(ranks, ds.gnd)["medium"]["map"])
        logger.log(event="bucketing_delta", mode=name, map_medium=results[name])
    results["map_delta"] = results["bucketed"] - results["exact"]

    # aspect-varied stress set: worst-case padding inside 32-multiples
    rng = np.random.RandomState(0)
    stress = [rng.rand(h, w, 3).astype(np.float32)
              for h, w in [(97, 257), (161, 99), (33, 129), (127, 65), (255, 161)]]
    cos = np.sum(ex_b.extract(stress) * ex_e.extract(stress), axis=1)
    results["stress_cos_mean"] = float(cos.mean())
    results["stress_cos_min"] = float(cos.min())
    logger.log(event="bucketing_delta", map_delta=results["map_delta"],
               stress_cos_mean=results["stress_cos_mean"],
               stress_cos_min=results["stress_cos_min"])
    return results


def run_full_system_bench(
    n_images: int = 64,
    image_size: int = 1024,
    src_hw=(1200, 1600),
    arch: str = "resnet50",
    batch_size: int = 16,
    nthreads_list=(1, 2, 4, 0),
    reps: int = 3,
    root: str = os.path.join(tempfile.gettempdir(), "irtpu_fullsys"),
    use_pallas: Optional[bool] = None,
    logger: Optional[MetricsLogger] = None,
    device: DeviceLike = "cuda",
) -> Dict:
    """Full-system throughput, the JAX package's ``run_full_system_bench``:
    JPEG on disk -> native decode and resize -> device -> descriptor, with
    the decode-alone rate recorded per thread count.

    The Extractor's prefetch thread overlaps host decode with the card, so
    ``e2e_img_per_sec`` should approach ``min(decode_img_per_sec,
    device_img_per_sec)``; ``overlap_efficiency`` is the end-to-end rate
    over that bound, and the three rates say which resource binds.

    The corpus is ``n_images`` textured JPEGs of ``src_hw`` (quality 90,
    from ``RandomState(0)``), written under ``root`` once. On the card the
    model computes in bf16 with the kernel head (``use_pallas`` None: on
    where the device is CUDA), on the CPU in f32 with the plain head. The
    device-only rate runs ``[batch_size, image_size, image_size, 3]``
    pixels made on the device from a seeded ``torch.Generator``: the timed
    loop moves no pixel bytes over the bus and ends in a synchronize.

    Returns ``decode_img_per_sec`` per thread count (empty where the native
    library does not build), ``device_img_per_sec``, ``e2e_img_per_sec``,
    ``overlap_efficiency`` and the corpus's size.
    """
    from PIL import Image

    from image_retrieval_for_image_based_localization_tpu_torch.data.native import (
        native_available,
        preprocess_batch_native,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
        ExtractConfig,
        ModelConfig,
    )

    dev = resolve_device(device)
    logger = logger or MetricsLogger(echo=True)
    on_card = dev.type == "cuda"
    if use_pallas is None:
        use_pallas = on_card

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    # corpus: textured JPEGs at camera resolution
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    paths = []
    H, W = src_hw
    for i in range(n_images):
        p = os.path.join(root, f"img_{H}x{W}_{i:04d}.jpg")
        paths.append(p)
        if not os.path.exists(p):
            base = rng.rand(H // 16, W // 16, 3)
            img = np.kron(base, np.ones((16, 16, 1)))
            img = np.clip(img + rng.randn(H, W, 3) * 0.03, 0, 1)
            Image.fromarray((img * 255).astype(np.uint8)).save(p, quality=90)
    jpeg_bytes = sum(os.path.getsize(p) for p in paths)

    results: Dict = {
        "n_images": n_images,
        "image_size": image_size,
        "jpeg_mb": round(jpeg_bytes / 1e6, 1),
        "native": native_available(),
        "decode_img_per_sec": {},
    }

    # decode-alone rate at each thread count (native C++ path)
    if native_available():
        seen_nt = set()
        for nt in nthreads_list:
            label = nt if nt > 0 else (os.cpu_count() or 4)
            if label in seen_nt:  # nt=0 resolved to an explicit entry's count
                continue
            seen_nt.add(label)
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                preprocess_batch_native(paths, image_size, image_size, image_size, nthreads=nt,
                                        upscale=False, resize_filter="lanczos")
                ts.append(time.perf_counter() - t0)
            rate = n_images / float(np.median(ts))
            results["decode_img_per_sec"][str(label)] = round(rate, 2)
            logger.log(event="fullsys_decode", nthreads=label, img_per_sec=rate)

    cfg = ExtractConfig(
        model=ModelConfig(arch=arch, dtype="bfloat16" if on_card else "float32",
                          use_pallas=use_pallas),
        image_size=image_size,
        batch_size=batch_size,
    )
    ex = Extractor(cfg, device=dev)

    # device-only rate: pixels made on the device, no host pipeline
    px = torch.rand((batch_size, image_size, image_size, 3),
                    generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    ex.forward(px)  # warm-up: cuDNN's algorithm choice, the bf16 weight copy
    sync()
    dev_iters = 4
    t0 = time.perf_counter()
    for _ in range(dev_iters):
        ex.forward(px)
    sync()
    results["device_img_per_sec"] = round(batch_size * dev_iters / (time.perf_counter() - t0),
                                          2)

    # end to end: disk -> decode -> upload -> descriptors (prefetch overlaps)
    ex.extract(paths[:batch_size])  # warm-up for the bucketed shape
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ex.extract(paths)
        ts.append(time.perf_counter() - t0)
    results["e2e_img_per_sec"] = round(n_images / float(np.median(ts)), 2)

    decodes = list(results["decode_img_per_sec"].values())
    bound = min(max(decodes) if decodes else float("inf"), results["device_img_per_sec"])
    results["overlap_efficiency"] = round(results["e2e_img_per_sec"] / bound, 3)
    logger.log(event="fullsys", **{k: v for k, v in results.items() if not isinstance(v, dict)})
    return results


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


def run_ann_bench(
    n: int = 20_000,
    d: int = 256,
    nq: int = 256,
    k: int = 10,
    n_clusters: Optional[int] = None,
    m: Optional[int] = None,
    reps: int = 5,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> Dict[str, Dict[str, float]]:
    """Recall-vs-q/s sweep over the search family on one corpus, the JAX
    package's ``run_ann_bench``: exact top-k (the recall-1 anchor), IVF at
    nprobe {1, C/8, C/4, C/2, C}, flat PQ and OPQ (pure ADC and refined),
    IVF-PQ (probe and refine). The corpus is the JAX bench's, from
    ``numpy.random.RandomState(seed)``: gaussian cells around random unit
    centres, queries noisy members; recall@k is against the exact top-k.
    The ``approx_r*`` rows stand for the JAX package's hardware-approximate
    selection, which the port runs as exact search (``Index.query``'s
    ``method="approx"``), so they read recall 1.

    Returns ``{method: {recall_at_k, qps, **knobs}}``, also logged as JSON
    lines."""
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import IVFIndex
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import (
        IVFPQIndex,
        PQIndex,
    )

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    n_clusters = n_clusters or max(8, int(np.sqrt(n)))
    m = m or max(4, d // 32)
    n_cells = max(32, n // 256)

    def unit(a: np.ndarray) -> np.ndarray:
        return l2n(torch.from_numpy(a)).numpy()

    centers = unit(rng.randn(n_cells, d).astype(np.float32))
    assign = rng.randint(0, n_cells, size=n)
    g = unit(centers[assign] + 0.35 * rng.randn(n, d).astype(np.float32))
    q = unit(g[rng.choice(n, nq, replace=False)] + 0.15 * rng.randn(nq, d).astype(np.float32))

    gt, qt = torch.from_numpy(g).to(dev), torch.from_numpy(q).to(dev)
    exact_i, _ = _timed_queries(lambda: knn_search(gt, qt, k), reps=reps)
    exact_sets = [set(row) for row in exact_i]

    def measure(fn, **knobs):
        idx, lat = _timed_queries(fn, reps=reps)
        rec = float(np.mean([len(exact_sets[r] & set(idx[r])) / k for r in range(nq)]))
        return {"recall_at_k": round(rec, 4), "qps": round(nq / float(np.median(lat)), 1),
                **knobs}

    out: Dict[str, Dict[str, float]] = {"exact": measure(lambda: knn_search(gt, qt, k))}
    for rt in (0.9, 0.95, 0.99):
        out[f"approx_r{int(rt * 100)}"] = measure(lambda: knn_search(gt, qt, k),
                                                  recall_target=rt)

    ivf = IVFIndex.build(g, n_clusters=n_clusters, device=dev)
    C = ivf.centroids.shape[0]
    for nprobe in sorted({1, max(1, C // 8), max(1, C // 4), max(1, C // 2), C}):
        out[f"ivf_nprobe{nprobe}"] = measure(lambda p=nprobe: ivf.search(q, k=k, nprobe=p),
                                             nprobe=nprobe, clusters=C)

    refine = max(4 * k, 100)
    for label, opq_iters in (("pq", 0), ("opq", 8)):
        pq = PQIndex.build(g, m=m, opq_iters=opq_iters, device=dev)
        out[f"{label}_adc"] = measure(lambda pq=pq: pq.search(q, k=k), m=m,
                                      compression=round(g.shape[1] * 4 / m, 1))
        out[f"{label}_refine{refine}"] = measure(
            lambda pq=pq: pq.search(q, k=k, refine=refine, gallery=gt), m=m, refine=refine)

    ivfpq = IVFPQIndex.from_ivf(ivf, m=m, device=dev)
    p_mid = max(1, C // 4)
    out[f"ivfpq_nprobe{p_mid}_refine{refine}"] = measure(
        lambda: ivfpq.search(q, k=k, nprobe=p_mid, refine=refine, gallery=gt),
        nprobe=p_mid, m=m, refine=refine)

    logger = MetricsLogger(echo=False)
    for name, row in out.items():
        logger.log(event="ann_bench", method=name, n=n, d=d, **row)
    return out


def run_serving_bench(
    n: int = 10_000,
    d: int = 256,
    concurrency: int = 16,
    requests: int = 200,
    k: int = 10,
    batch_window_ms: float = 5.0,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> Dict[str, Dict[str, float]]:
    """Closed-loop load test of the HTTP server, the JAX package's
    ``run_serving_bench``: one in-process server per mode, unbatched and
    micro-batched, over a random unit gallery [n, d] (``numpy.random.
    RandomState(seed)``, no whitening). ``concurrency`` client threads send
    single-query ``POST /query`` requests until ``requests`` complete; a
    warm pass at the same concurrency comes first. Returns q/s and the
    client-side p50/p95/p99 latency per mode, and the q/s ratio.
    """
    import concurrent.futures
    import json
    import urllib.request

    from image_retrieval_for_image_based_localization_tpu_torch.serving import serve
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import IndexConfig
    from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import (
        percentile_summary,
    )

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    g = l2n(torch.from_numpy(rng.randn(n, d).astype(np.float32))).numpy()
    index = Index.build(g, IndexConfig(whitening=None), device=dev)
    qpool = g[rng.choice(n, 256, replace=False)] + 0.02 * rng.randn(256, d).astype(np.float32)
    bodies = [json.dumps({"descriptors": qpool[[i]].tolist(), "k": k}).encode()
              for i in range(256)]

    out: Dict[str, Dict[str, float]] = {}
    for mode, window in (("unbatched", 0.0), ("batched", batch_window_ms)):
        srv = serve(index, block=False, port=0, batch_window_ms=window, device=dev)
        host, port = srv.server_address
        url = f"http://{host}:{port}/query"
        lat = []

        def one(i, record=True):
            t0 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(url, data=bodies[i % 256])) as r:
                r.read()
            if record:
                lat.append(time.perf_counter() - t0)

        try:
            with concurrent.futures.ThreadPoolExecutor(concurrency) as exe:
                list(exe.map(lambda i: one(i, record=False), range(requests)))
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(concurrency) as exe:
                list(exe.map(one, range(requests)))
            wall = time.perf_counter() - t0
        finally:
            srv.shutdown()
            srv.server_close()
        pct = percentile_summary(lat, unit="ms")
        out[mode] = {"qps": round(requests / wall, 1), "lat_p50_ms": pct["p50_ms"],
                     "lat_p95_ms": pct["p95_ms"], "lat_p99_ms": pct["p99_ms"],
                     "concurrency": concurrency, "batch_window_ms": window}
    out["speedup"] = {"qps_ratio": round(out["batched"]["qps"] / out["unbatched"]["qps"], 2)}
    logger = MetricsLogger(echo=False)
    for mode, row in out.items():
        logger.log(event="serving_bench", mode=mode, n=n, d=d, **row)
    return out
