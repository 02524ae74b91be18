"""Evaluation dataset configuration: ROxford5k / RParis6k / Oxford5k etc.

Copied from the JAX package's ``data/test_datasets.py`` (NumPy + PIL).

Mirrors the reference's `datasets/testdataset.py` ``configdataset``
(SURVEY.md §2; reconstructed — empty reference mount): a ``gnd_<name>.pkl``
pickle holds ``imlist``, ``qimlist`` and per-query ground truth (revisited
sets: ``easy``/``hard``/``junk`` + query ``bbx``; classic sets: ``ok``/
``junk`` + ``bbx``).

This environment has no network (SURVEY.md §0), so alongside the loader
there is a deterministic synthetic dataset generator with the same on-disk
contract — it exercises every code path (bbx crops, junk handling, E/M/H
protocols) end-to-end and doubles as the benchmark corpus.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

DATASETS = ("oxford5k", "paris6k", "roxford5k", "rparis6k")


class TestDataset:
    """An eval dataset: image paths, query paths + bbxs, ground truth."""

    def __init__(self, name: str, cfg: Dict, images_dir: str, ext: str = ".jpg"):
        self.name = name
        self.cfg = cfg
        self.imlist: List[str] = cfg["imlist"]
        self.qimlist: List[str] = cfg["qimlist"]
        self.gnd = cfg.get("gnd")
        self.images_dir = images_dir
        self.ext = ext

    @property
    def n(self) -> int:
        return len(self.imlist)

    @property
    def nq(self) -> int:
        return len(self.qimlist)

    def im_path(self, i: int) -> str:
        return os.path.join(self.images_dir, self.imlist[i] + self.ext)

    def qim_path(self, i: int) -> str:
        return os.path.join(self.images_dir, self.qimlist[i] + self.ext)

    @property
    def image_paths(self) -> List[str]:
        return [self.im_path(i) for i in range(self.n)]

    @property
    def query_paths(self) -> List[str]:
        return [self.qim_path(i) for i in range(self.nq)]

    @property
    def query_bbxs(self) -> Optional[List]:
        if self.gnd is None:
            return None
        bbxs = [g.get("bbx") for g in self.gnd]
        return bbxs if any(b is not None for b in bbxs) else None


def configdataset(dataset: str, dir_main: str) -> TestDataset:
    """Load a gnd pickle, reference-compatible layout:

    ``<dir_main>/<dataset>/gnd_<dataset>.pkl`` and images under
    ``<dir_main>/<dataset>/jpg/``.
    """
    dataset = dataset.lower()
    gnd_path = os.path.join(dir_main, dataset, f"gnd_{dataset}.pkl")
    if not os.path.exists(gnd_path):
        raise FileNotFoundError(
            f"{gnd_path} not found. This environment has no network access; "
            f"place the ground-truth pickle and images there, or use "
            f"make_synthetic_dataset() for a self-contained corpus."
        )
    with open(gnd_path, "rb") as f:
        cfg = pickle.load(f)
    cfg["dataset"] = dataset
    return TestDataset(dataset, cfg, os.path.join(dir_main, dataset, "jpg"))


def make_synthetic_dataset(
    root: str,
    name: str = "synthcity",
    n_scenes: int = 8,
    views_per_scene: int = 5,
    n_queries_per_scene: int = 1,
    n_distractors: int = 10,
    image_hw=(120, 160),
    revisited: bool = True,
    seed: int = 0,
    jitter_strengths=(0.5, 1.5),
    image_format: str = "jpeg",
) -> TestDataset:
    """Create an on-disk synthetic retrieval dataset with the gnd contract.

    Scenes are random textured prototypes; database "views" are photometric
    + geometric jitters of a scene; queries are fresh jitters with a bbx.
    Half of each scene's views are labeled 'easy', half 'hard' (stronger
    jitter); one extra near-duplicate per scene is labeled 'junk'.

    ``image_format="png"`` stores each image losslessly (under the layout's
    ``.jpg`` names; decoders read the format from the data), so every host
    decodes the same pixels from the same seed, whatever its JPEG codec.
    """
    if image_format not in ("jpeg", "png"):
        raise ValueError(f"image_format must be 'jpeg' or 'png', got {image_format!r}")
    from PIL import Image

    rng = np.random.RandomState(seed)
    H, W = image_hw
    ddir = os.path.join(root, name)
    jpg = os.path.join(ddir, "jpg")
    os.makedirs(jpg, exist_ok=True)

    def save(img: np.ndarray, stem: str):
        im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        if image_format == "png":
            im.save(os.path.join(jpg, stem + ".jpg"), format="PNG")
        else:
            im.save(os.path.join(jpg, stem + ".jpg"), quality=95)

    def jitter(proto, strength):
        img = proto + rng.randn(*proto.shape) * 0.05 * strength
        shift = int(3 * strength)
        if shift:
            img = np.roll(img, rng.randint(-shift, shift + 1), axis=rng.randint(0, 2))
        img = img * (1 + 0.1 * strength * rng.randn())
        return np.clip(img, 0, 1)

    # low-frequency textured prototypes (so downscaling keeps identity)
    def make_proto():
        base = rng.rand(H // 8, W // 8, 3)
        img = np.kron(base, np.ones((8, 8, 1)))
        return np.clip(img + rng.randn(H, W, 3) * 0.02, 0, 1)

    imlist, qimlist, gnd = [], [], []
    scene_views: List[List[int]] = []
    protos = []
    for s in range(n_scenes):
        proto = make_proto()
        protos.append(proto)
        ids = []
        for v in range(views_per_scene):
            stem = f"db_s{s}_v{v}"
            strength = (
                jitter_strengths[0]
                if v < (views_per_scene + 1) // 2
                else jitter_strengths[1]
            )
            save(jitter(proto, strength), stem)
            ids.append(len(imlist))
            imlist.append(stem)
        # one junk near-duplicate
        stem = f"db_s{s}_junk"
        save(jitter(proto, 0.2), stem)
        junk_id = len(imlist)
        imlist.append(stem)
        scene_views.append(ids + [junk_id])
    for d in range(n_distractors):
        stem = f"db_distractor{d}"
        save(make_proto(), stem)
        imlist.append(stem)

    for s in range(n_scenes):
        for q in range(n_queries_per_scene):
            stem = f"q_s{s}_{q}"
            save(jitter(protos[s], 0.5), stem)
            qimlist.append(stem)
            ids = scene_views[s]
            n_easy = (views_per_scene + 1) // 2
            entry = {
                "bbx": [5.0, 5.0, float(W - 5), float(H - 5)],
                "junk": [ids[-1]],
            }
            if revisited:
                entry["easy"] = ids[:n_easy]
                entry["hard"] = ids[n_easy:-1]
            else:
                entry["ok"] = ids[:-1]
            gnd.append(entry)

    cfg = {"imlist": imlist, "qimlist": qimlist, "gnd": gnd, "dataset": name}
    with open(os.path.join(ddir, f"gnd_{name}.pkl"), "wb") as f:
        pickle.dump(cfg, f)
    return TestDataset(name, cfg, jpg)
