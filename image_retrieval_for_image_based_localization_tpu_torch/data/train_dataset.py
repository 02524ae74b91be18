"""Training-tuple dataset: retrieval-SfM-120k, the JAX package's
``data/train_dataset.py`` (cirtorch's on-disk contract).

A pickle ``retrieval-SfM-120k.pkl`` holds per-split dicts

    {'train': {'cids': [...], 'qidxs': [...], 'pidxs': [...], 'cluster': [...]},
     'val':   {...}}

where ``cids`` name image files (under ``ims/``, sharded by the cid's last
characters), ``qidxs``/``pidxs`` are matching query/positive indices and
``cluster`` is the 3D-model id that excludes same-landmark negatives.
Per-epoch tuples come from ``training.mining``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import List, Optional

import numpy as np

from image_retrieval_for_image_based_localization_tpu_torch.training.mining import (
    TupleSet,
    mine_epoch_tuples,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import DeviceLike


def cid_to_filename(cid: str, prefix: str) -> str:
    """cirtorch image layout: ims/<c[-2:]>/<c[-4:-2]>/<c[-6:-4]>/<cid>"""
    return os.path.join(prefix, cid[-2:], cid[-4:-2], cid[-6:-4], cid)


@dataclasses.dataclass
class TuplesDataset:
    """A training split: image paths + supervision for tuple mining."""

    paths: List[str]
    qidxs: np.ndarray      # candidate query indices
    pidxs: np.ndarray      # matching positive indices
    clusters: np.ndarray   # cluster (3D model) id per image
    name: str = "train"

    @classmethod
    def from_pickle(
        cls, pkl_path: str, ims_root: Optional[str] = None, split: str = "train"
    ) -> "TuplesDataset":
        with open(pkl_path, "rb") as f:
            db = pickle.load(f)
        d = db[split]
        if ims_root is None:
            ims_root = os.path.join(os.path.dirname(pkl_path), "ims")
        cids = d["cids"]
        paths = [cid_to_filename(c, ims_root) for c in cids]
        return cls(
            paths=paths,
            qidxs=np.asarray(d["qidxs"], np.int64),
            pidxs=np.asarray(d["pidxs"], np.int64),
            clusters=np.asarray(d["cluster"], np.int64),
            name=split,
        )

    @classmethod
    def from_arrays(cls, paths, qidxs, pidxs, clusters, name="train"):
        return cls(
            paths=list(paths),
            qidxs=np.asarray(qidxs, np.int64),
            pidxs=np.asarray(pidxs, np.int64),
            clusters=np.asarray(clusters, np.int64),
            name=name,
        )

    def __len__(self) -> int:
        return len(self.qidxs)

    def epoch_tuples(
        self,
        extractor,
        n_neg: int = 5,
        qsize: Optional[int] = 2000,
        poolsize: Optional[int] = 20000,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ) -> TupleSet:
        """Re-mine hard negatives with the current model (reference
        ``create_epoch_tuples``): a front to ``training.mining.mine_epoch_tuples``
        with ``extractor.extract``; indices are global image-list indices.
        Seed with the epoch number to re-sample per epoch."""
        return mine_epoch_tuples(
            extractor.extract,
            self.paths,
            self.qidxs,
            self.pidxs,
            clusters=self.clusters,
            n_neg=n_neg,
            seed=seed,
            qsize=qsize,
            poolsize=poolsize,
            device=device,
        )
