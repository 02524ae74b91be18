"""The training loop, the JAX package's ``training/loop.py``: per-epoch
hard-negative re-mining, tuple training, retrieval validation, best/latest
checkpoints and post-training Lw whitening (cirtorch's ``train.py``).

  * pool descriptors for mining, validation and Lw come from
    ``Extractor.extract(paths)`` on a copy of the current weights (raw
    pixels through the uint8 device pipeline);
  * tuple batches are built per step from paths: each image decoded,
    max-side-resized to ``image_size`` and placed into ONE bucket shape
    (the header-probed global max, rounded to the trunk stride) as uint8
    with its valid (h, w); the train step normalizes, masks and pools with
    the mask on the device;
  * an LRU keeps recently used resized images and a thread prefetches
    batches;
  * the lr decays per epoch (``TrainConfig.steps_per_epoch``).

Without retrieval-SfM-120k on disk it trains on the synthetic scene corpus
(``data.test_datasets.make_synthetic_dataset``). ``resume`` takes this
package's run directory or the JAX package's; either way the checkpoints
written after it are this package's. ``dtype`` (bf16 training),
``remat``, ``regional`` and ``whiten_dim`` reach the train step and the
checkpoints' meta. Three deliberate differences from the JAX loop (ROADMAP
C): a resumed run never re-initializes NetVLAD's centroids, and ``pallas``
and the model's ``dtype`` and ``regional`` reach the mining extractor too
(the JAX loop extracts in f32 with the global head). The u8 tuple step
always carries a mask, so a regional model raises there, as the JAX step
does.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor, _prefetched
from image_retrieval_for_image_based_localization_tpu_torch.data.images import (
    bucket_shape,
    load_image,
    max_side_resize,
    probe_size,
)
from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
    make_synthetic_dataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.data.train_dataset import (
    TuplesDataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (
    compute_map_revisited,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    RetrievalNet,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.whitening import whiten_learn
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import full_ranks
from image_retrieval_for_image_based_localization_tpu_torch.training.mining import (
    TupleSet,
    mine_epoch_tuples,
)
from image_retrieval_for_image_based_localization_tpu_torch.training.netvlad_init import (
    init_netvlad_from_images,
)
from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
    ExtractConfig,
    ModelConfig,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import MetricsLogger


def _synthetic_pool(root: str, n_scenes=12, views=4, hw=(96, 128), seed=0):
    """A training pool: image paths, cluster ids, (q, p) pair indices and the
    dataset (with its queries and gnd, for validation)."""
    ds = make_synthetic_dataset(
        root, name="synthtrain", n_scenes=n_scenes, views_per_scene=views,
        n_distractors=0, image_hw=hw, seed=seed,
    )
    paths = ds.image_paths
    clusters = np.zeros(len(paths), np.int64)
    for i, stem in enumerate(ds.imlist):
        clusters[i] = int(stem.split("_s")[1].split("_")[0])
    qidxs, pidxs = [], []
    for s in range(n_scenes):
        members = np.where(clusters == s)[0]
        for a, b in zip(members[:-1], members[1:]):
            qidxs.append(a)
            pidxs.append(b)
    return paths, clusters, np.asarray(qidxs), np.asarray(pidxs), ds


def _real_or_synthetic_pool(data_root: str, n_scenes: int = 12, views: int = 4,
                            hw: Tuple[int, int] = (96, 128)):
    """retrieval-SfM-120k's pickle under ``data_root`` where it is on disk,
    else the synthetic corpus (images of ``hw`` pixels)."""
    pkl = os.path.join(data_root, "train", "retrieval-SfM-120k", "retrieval-SfM-120k.pkl")
    if os.path.exists(pkl):
        ds = TuplesDataset.from_pickle(pkl, split="train")
        return ds.paths, ds.clusters, ds.qidxs, ds.pidxs, "retrieval-SfM-120k", None
    paths, clusters, qidxs, pidxs, ds = _synthetic_pool(data_root, n_scenes=n_scenes,
                                                        views=views, hw=hw)
    return paths, clusters, qidxs, pidxs, "synthetic", ds


class _ResizedImageCache:
    """LRU of max-side-resized uint8 images (tuples reuse pool images)."""

    def __init__(self, paths: Sequence[str], image_size: int, capacity: int = 256):
        self.paths = paths
        self.image_size = image_size
        self._lru: "collections.OrderedDict[int, np.ndarray]" = collections.OrderedDict()
        self.capacity = capacity

    def get(self, idx: int) -> np.ndarray:
        """uint8 HWC, max side == image_size (shrink or grow, as
        :func:`probe_bucket_shape` sizes the bucket)."""
        hit = self._lru.get(idx)
        if hit is not None:
            self._lru.move_to_end(idx)
            return hit
        img = max_side_resize(load_image(self.paths[idx]), self.image_size,
                              resize_filter="lanczos")
        u8 = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        self._lru[idx] = u8
        if len(self._lru) > self.capacity:
            self._lru.popitem(last=False)
        return u8


def probe_bucket_shape(paths: Sequence[str], image_size: int, multiple: int = 32
                       ) -> Tuple[int, int]:
    """The one tuple-batch shape: the header-probed global max (h, w) after
    max-side resize, rounded up to the trunk stride."""
    mh = mw = 1
    for p in paths:
        h, w = probe_size(p)
        m = max(h, w)
        if m != image_size:
            s = image_size / m
            h, w = max(1, round(h * s)), max(1, round(w * s))
        mh, mw = max(mh, h), max(mw, w)
    return bucket_shape(mh, mw, multiple)


def iter_tuple_batches(
    cache: _ResizedImageCache,
    tuples: TupleSet,
    batch_tuples: int,
    hw: Tuple[int, int],
    order: Optional[np.ndarray] = None,
) -> Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (pixels_u8 [B,T,H,W,3], sizes [B,T,2], labels [B,T]) batches,
    decoding lazily through the cache; a short tail is dropped, as the
    reference drops partial batches."""
    H, W = hw
    T = 2 + tuples.nidxs.shape[1]
    nq = len(tuples.qidxs)
    if order is None:
        order = np.arange(nq)
    for s in range(0, nq, batch_tuples):
        sel = order[s : s + batch_tuples]
        if len(sel) < batch_tuples:
            break
        px = np.zeros((len(sel), T, H, W, 3), np.uint8)
        sizes = np.zeros((len(sel), T, 2), np.int32)
        labels = np.zeros((len(sel), T), np.int32)
        labels[:, 1] = 1
        labels[:, 2:] = -1
        for r, ti in enumerate(sel):
            members = [tuples.qidxs[ti], tuples.pidxs[ti], *tuples.nidxs[ti]]
            for t, gi in enumerate(members):
                img = cache.get(int(gi))
                h, w = img.shape[:2]
                px[r, t, :h, :w] = img
                sizes[r, t] = (h, w)
        yield px, sizes, labels


def _state_copy(model: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run_training(args, device: DeviceLike = "cuda") -> dict:
    """Train from CLI-style ``args`` (the JAX package's ``cli train`` fields);
    returns ``{best_loss, epochs, out_dir}``. Records go to
    ``out_dir/metrics.jsonl`` and stdout."""
    dev = resolve_device(device)
    logger = MetricsLogger(os.path.join(args.out_dir, "metrics.jsonl"), echo=True)
    dtype = getattr(args, "dtype", "float32")
    pallas = getattr(args, "pallas", False)
    clusters_k = getattr(args, "netvlad_clusters", 64)
    regional = getattr(args, "regional", False)
    model = RetrievalNet(arch=args.arch, pooling=args.pooling, whiten_dim=args.whiten_dim,
                         dtype=dtype, netvlad_clusters=clusters_k, use_kernel=pallas,
                         regional=regional)

    paths, clusters, qidxs, pidxs, source, val_ds = _real_or_synthetic_pool(
        args.data_root,
        n_scenes=getattr(args, "synth_scenes", 12),
        views=getattr(args, "synth_views", 4),
        hw=tuple(getattr(args, "synth_hw", (96, 128))),
    )
    logger.log(event="pool", source=source, images=len(paths), pairs=len(qidxs))

    qsize = getattr(args, "qsize", None)
    poolsize = getattr(args, "poolsize", None)
    epoch_pairs = min(qsize, len(qidxs)) if qsize else len(qidxs)
    update_every = max(getattr(args, "update_every", 1), 1)
    # the lr decays per applied optimizer step
    steps_per_epoch = max(epoch_pairs // (args.batch_tuples * update_every), 1)
    cfg = TrainConfig(
        loss=args.loss, margin=args.margin, lr=args.lr, n_neg=args.n_neg,
        batch_tuples=args.batch_tuples, steps_per_epoch=steps_per_epoch,
        optimizer=getattr(args, "optimizer", "adam"),
        momentum=getattr(args, "momentum", 0.9),
        update_every=update_every,
        remat=getattr(args, "remat", False),
    )
    state = create_train_state(model, cfg, device=dev)
    start_epoch = 0
    resumed = bool(getattr(args, "resume", None))
    if resumed:
        # this package's run directory or the JAX package's (its Orbax
        # latest, optax's state carried into torch.optim)
        state, meta = load_checkpoint(args.resume, name="latest", target=state, cfg=cfg)
        start_epoch = int(meta.get("epoch", -1)) + 1 if meta else 0
        logger.log(event="resumed", from_dir=args.resume, start_epoch=start_epoch)
    train_step = make_train_step(model, cfg, from_u8=True)

    tuple_hw = probe_bucket_shape(paths, args.image_size)
    cache = _ResizedImageCache(paths, args.image_size)
    logger.log(event="tuple_bucket", h=tuple_hw[0], w=tuple_hw[1],
               steps_per_epoch=steps_per_epoch)

    ex_cfg = ExtractConfig(
        model=ModelConfig(arch=args.arch, pooling=args.pooling, whiten_dim=args.whiten_dim,
                          netvlad_clusters=clusters_k, use_pallas=pallas, dtype=dtype,
                          regional=regional),
        image_size=args.image_size,
        batch_size=getattr(args, "batch_size", 8),
    )

    def extractor() -> Extractor:
        # a copy of the current weights: Extractor puts its model in eval
        # mode, and the training model stays in train mode
        return Extractor(ex_cfg, state_dict=_state_copy(model), device=dev)

    # NetVLAD centroids from k-means on trunk local features (eval-mode
    # trunk); never on resume, where the checkpoint holds trained centroids
    if args.pooling == "netvlad" and not resumed:
        sample = list(paths[: min(len(paths), 200)])
        model.load_state_dict(init_netvlad_from_images(extractor().model, sample, ex_cfg))
        logger.log(event="netvlad_kmeans_init", images=len(sample), clusters=int(clusters_k))

    best_loss = float("inf")
    for epoch in range(start_epoch, args.epochs):
        meta = {"arch": args.arch, "pooling": args.pooling, "whiten_dim": args.whiten_dim,
                "regional": regional, "loss": args.loss, "dtype": dtype, "remat": cfg.remat,
                "epoch": epoch}
        # 1. re-mine hard negatives with the current model; only the
        # sampled union is extracted
        ex = extractor()
        t_extract = 0.0

        def timed_extract(images):
            nonlocal t_extract
            t0 = time.perf_counter()
            out = ex.extract(images)
            t_extract += time.perf_counter() - t0
            return out

        t0 = time.perf_counter()
        tuples = mine_epoch_tuples(
            timed_extract, paths, qidxs, pidxs, clusters=clusters,
            n_neg=cfg.n_neg, seed=epoch, qsize=qsize, poolsize=poolsize, device=dev,
        )
        t_mine = time.perf_counter() - t0
        del ex
        logger.log(event="mined", epoch=epoch, tuples=len(tuples.qidxs), seconds=t_mine,
                   seconds_extract=t_extract, seconds_search=t_mine - t_extract)

        # 2. tuple training: one bucket shape, prefetched batches
        order = np.random.RandomState(epoch).permutation(len(tuples.qidxs))
        losses = []
        batches = iter_tuple_batches(cache, tuples, cfg.batch_tuples, tuple_hw, order=order)
        t0 = time.perf_counter()
        for px, sizes, labels in _prefetched(batches, 2):
            state, loss = train_step(state, px, sizes, labels)
            losses.append(float(loss))
        mean_loss = float(np.mean(losses)) if losses else 0.0
        logger.log(epoch=epoch, train_loss=mean_loss, steps=len(losses),
                   seconds=time.perf_counter() - t0)

        # per-epoch retrieval validation: mAP of the corpus queries
        if val_ds is not None and val_ds.gnd:
            ex = extractor()
            db = ex.extract(val_ds.image_paths)
            qd = ex.extract(val_ds.query_paths, bbxs=val_ds.query_bbxs)
            ranks = full_ranks(torch.from_numpy(db).to(dev), torch.from_numpy(qd).to(dev))
            res = compute_map_revisited(ranks, val_ds.gnd)
            logger.log(epoch=epoch, val_map_medium=float(res["medium"]["map"]))

        is_best = mean_loss < best_loss
        best_loss = min(best_loss, mean_loss)
        save_checkpoint(args.out_dir, state, meta=meta, name="latest", is_best=is_best)

    # post-training supervised (Lw) whitening from the matching pairs
    pool_vecs = extractor().extract(paths)
    m, P = whiten_learn(pool_vecs, qidxs, pidxs)
    np.savez(os.path.join(args.out_dir, "whitening.npz"), m=m.astype(np.float32),
             P=P.astype(np.float32))
    logger.log(event="lw_whitening_saved", dims=int(P.shape[0]))

    return {"best_loss": best_loss, "epochs": args.epochs, "out_dir": args.out_dir}
