"""Extraction traffic: ``Extractor.extract`` back to back on lists of
``list_images`` decoded uint8 images, in the configuration's mix of shapes,
each list drawn in a seeded order from a pool of ``pool_per_shape`` seeded
images a shape. The rate is every image over the whole window.
``correct`` compares a seeded sample of the window's descriptors
(``check_images``, the same number from each shape) with the reference's."""

import time
from collections import Counter

import numpy as np
import torch

from retrieval_bench import synth
from retrieval_bench.reference import extract as ref
from retrieval_bench.trace import span

from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
    ExtractConfig,
    ModelConfig,
)


def extract_config(cfg: dict) -> ExtractConfig:
    mc, ec = cfg["model"], cfg["extract"]
    return ExtractConfig(
        model=ModelConfig(arch=mc["arch"], pooling=mc["pooling"], gem_p=mc["gem_p"],
                          dtype=mc["dtype"], use_pallas=mc["use_pallas"]),
        image_size=ec["image_size"], scales=tuple(ec["scales"]),
        batch_size=ec["batch_size"], bucket_multiple=ec["bucket_multiple"])


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.outputs = []       # (list index, [n, D] descriptors) of every list in the window
        self.shapes = Counter()  # images extracted in the window, by shape
        self.wall_s = 0.0
        self.host_batch = None  # (images, seconds) of the host pipeline alone

    def setup(self) -> None:
        sd = synth.state_dict(self.cfg, self.seed, self.device)
        self.ex = Extractor(extract_config(self.cfg), state_dict=sd, device=self.device)
        del sd
        self.pool = synth.images(self.cfg, self.tr["pool_per_shape"], self.seed, self.device)
        warm = []
        n = self.tr["warm_batches_per_shape"] * self.cfg["extract"]["batch_size"]
        for imgs in self.pool.values():
            warm += [imgs[j % len(imgs)] for j in range(n)]
        self.ex.extract(warm)

    def _list(self, index: int):
        return synth.image_list(self.cfg, self.tr["pool_per_shape"], self.tr["list_images"],
                                self.seed, index)

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            lst = self._list(i)
            with span("extract.list"):
                out = self.ex.extract([self.pool[s][j] for s, j in lst])
            self.outputs.append((i, out))
            self.shapes.update(s for s, _ in lst)
            i += 1
            if time.perf_counter() >= deadline:
                break
        self.wall_s = time.perf_counter() - t0

    def after_window(self, traced: bool) -> None:
        """In a traced run: the host pipeline alone (``make_input_batches``
        over the cell's lists, no device work) for ``host_batch_seconds``."""
        if not traced:
            return
        t0 = time.perf_counter()
        n, i = 0, 0
        while time.perf_counter() - t0 < self.tr["host_batch_seconds"]:
            lst = self._list(10_000 + i)
            with span("host_batch"):
                for _ in self.ex.make_input_batches([self.pool[s][j] for s, j in lst]):
                    pass
            n += len(lst)
            i += 1
        self.host_batch = (n, time.perf_counter() - t0)

    def attempted(self) -> int:
        return sum(self.shapes.values())

    def end_to_end(self) -> dict:
        return {"extract_img_per_s": self.attempted() / self.wall_s}

    def counters(self) -> dict:
        mc, ec = self.cfg["model"], self.cfg["extract"]
        return {"images": dict(self.shapes), "arch": mc["arch"], "dtype": mc["dtype"],
                "channels": mc["out_dim"], "scales": list(ec["scales"]),
                "bucket": ec["bucket_multiple"], "host_batch": self.host_batch}

    def release(self) -> None:
        self.ex = None
        self.pool = None

    def sample(self) -> list:
        """(shape, list, position in the list, pool position) of the
        descriptors the check compares: the same number of each shape, drawn
        from the seed."""
        by_shape = {}
        for li, _ in self.outputs:
            for pos, (shape, j) in enumerate(self._list(li)):
                by_shape.setdefault(shape, []).append((li, pos, j))
        r = synth.rng(self.seed, "check")
        per = max(1, self.tr["check_images"] // len(by_shape))
        picks = []
        for shape in sorted(by_shape):
            cands = by_shape[shape]
            for c in r.choice(len(cands), min(per, len(cands)), replace=False):
                picks.append((shape,) + cands[c])
        return picks

    def check(self) -> dict:
        outs = dict(self.outputs)
        picks = self.sample()
        prog = np.stack([outs[li][pos] for _, li, pos, _ in picks])
        refd = reference_descriptors(self.cfg, self.seed, self.device,
                                     [(shape, j) for shape, _, _, j in picks],
                                     self.tr["pool_per_shape"])
        return ref.compare(prog, refd)


def reference_descriptors(cfg, seed, device, items, per_shape, control=None) -> np.ndarray:
    """The reference's descriptors of pool images ``(shape, position)``,
    the weights and the pool made again from the seed."""
    ref.tf32_off()
    sd = synth.state_dict(cfg, seed, device)
    pool = synth.images(cfg, per_shape, seed, device)
    mc, ec = cfg["model"], cfg["extract"]
    return np.stack([
        ref.descriptor(pool[shape][j], sd, mc["arch"], ec["image_size"], ec["scales"],
                       mc["gem_p"], ec["bucket_multiple"], control=control,
                       device=device).cpu().numpy()
        for shape, j in items])
