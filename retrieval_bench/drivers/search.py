"""Search traffic: a closed loop with one caller. ``Index.query(q, k)`` on
batches of ``batch`` raw (unwhitened) query descriptors, drawn in turn from
a seeded pool, over the configuration's gallery held on the device in its
storage dtype. ``correct`` compares a seeded sample of the window's calls
(``check_queries`` queries) with the reference's exact top-k."""

import time

import numpy as np
import torch

from retrieval_bench import synth
from retrieval_bench.drivers._timing import CallTimer, percentile
from retrieval_bench.reference import search as ref
from retrieval_bench.trace import span

from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index


def make_index(cfg: dict, seed: int, device, storage: str = None):
    """The gallery, the whitening and the Index over them, as the benchmark
    hands them to the program (``storage`` overrides the configuration's:
    the control's int8)."""
    gal = synth.gallery(cfg, seed, device)
    m, P, back = synth.whitening(cfg, seed, device)
    index = Index(gallery=gal, m=m, P=P, dims=None, ids=None,
                  storage=storage or cfg["index"]["storage"], device=torch.device(device))
    return index, gal, m, back


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.batch, self.k = traffic["batch"], traffic["k"]
        self.results = []   # (pool batch, scores, ids) of every call in the window
        self.timer = CallTimer(self.device)
        self.wall_s = 0.0
        self.program_storage = None  # the control sets "int8", the program's own lower path

    def setup(self) -> None:
        self.index, gal, m, back = make_index(self.cfg, self.seed, self.device,
                                              self.program_storage)
        self.ng = gal.shape[0]
        self.pool = synth.queries(self.cfg, self.tr["query_pool"], self.seed, gal, back, m)
        self.n_batches = self.pool.shape[0] // self.batch
        for i in range(self.tr["warm_calls"]):
            self.index.query(self._batch(i), k=self.k)

    def _batch(self, i: int) -> np.ndarray:
        j = i % self.n_batches
        return self.pool[j * self.batch : (j + 1) * self.batch]

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            q = self._batch(i)
            started = self.timer.start()
            with span("search.query"):
                scores, ids = self.index.query(q, k=self.k)
            self.timer.stop(started)
            self.results.append((i % self.n_batches, scores, ids))
            i += 1
            if time.perf_counter() >= deadline:
                break
        self.wall_s = time.perf_counter() - t0

    def after_window(self, traced: bool) -> None:
        pass

    def attempted(self) -> int:
        return len(self.results) * self.batch

    def end_to_end(self) -> dict:
        return {"search_q_per_s": self.attempted() / self.wall_s,
                "search_p95_ms": percentile(self.timer.ms(), 95)}

    def counters(self) -> dict:
        ix = self.cfg["index"]
        return {"calls": len(self.results), "nq": self.batch, "ng": self.ng,
                "d_in": ix["whiten_in"], "d": ix["whiten_out"], "k": self.k,
                "storage": ix["storage"]}

    def release(self) -> None:
        self.index = None

    def sample(self) -> list:
        """Indices of the window's calls that the check compares, drawn from
        the seed."""
        n = max(1, min(len(self.results), self.tr["check_queries"] // self.batch))
        r = synth.rng(self.seed, "check")
        return sorted(r.choice(len(self.results), n, replace=False).tolist())

    def check(self) -> dict:
        picks = self.sample()
        q = np.concatenate([self._batch(self.results[c][0]) for c in picks])
        scores = np.concatenate([self.results[c][1] for c in picks])
        ids = np.concatenate([self.results[c][2] for c in picks])
        return reference_numbers(self.cfg, self.seed, self.device, q, scores, ids, self.k)


def reference_numbers(cfg, seed, device, q, scores, ids, k) -> dict:
    """The reference, made again from the seed after the program is freed,
    against the program's answers to the raw queries ``q``."""
    gal = synth.gallery(cfg, seed, device)
    m, P, _ = synth.whitening(cfg, seed, device)
    qw = ref.whiten(q, m, P, gal.dtype, device)
    top, _ = ref.top_k(qw, gal, k)
    prog_ref = ref.scores_of(qw, gal, ids)
    return ref.compare(scores, ids, top, prog_ref, gal.shape[0])
