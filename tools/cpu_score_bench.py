#!/usr/bin/env python3
"""What the CPU's shape-stable scoring costs exact search, on the host.

    python3 tools/cpu_score_bench.py [--threads N]

On the CPU, ``knn_search`` and ``rank_candidates`` score fixed, zero-padded
tiles (``retrieval/knn.py::_tiled_scores``) so that a (query, row) pair
gets the same bits at any gallery and batch size. This times, at a few
shapes (unit-norm rows from a seed, f32), the CPU ``knn_search`` and
``rank_candidates`` three ways on the same inputs (best of 3 calls):
- ``tiles``: the scoring as it stands (64 x 4096 tiles);
- ``tiles_16x256``: the same loop at 16 x 256 tiles;
- ``one_product``: one ``score_matrix`` per chunk, which rounds a pair
  differently at another shape (not shape-stable).
It also checks that the tiled scores of a sub-block equal the whole
matrix's. Prints one JSON line per shape.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = [(20, 20_000, 2048), (1024, 20_000, 512), (8192, 8192, 256)]  # Nq, Ng, D
K, C = 100, 5


def best_of(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=0, help="torch threads (0: default)")
    args = ap.parse_args()
    import numpy as np
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval import knn

    if args.threads:
        torch.set_num_threads(args.threads)
    tiles, tile_shape = knn._tiled_scores, (knn._TILE_Q, knn._TILE_G)
    ways = {
        "tiles": (tiles, tile_shape),
        "tiles_16x256": (tiles, (16, 256)),
        "one_product": (knn.score_matrix, tile_shape),
    }
    rng = np.random.default_rng(0)
    for nq, ng, d in SHAPES:
        g = rng.standard_normal((ng, d), dtype=np.float32)
        g /= np.linalg.norm(g, axis=1, keepdims=True)
        g = torch.from_numpy(g)
        q = g[rng.choice(ng, nq, replace=nq > ng)] + 0.01
        cand = torch.from_numpy(rng.integers(0, ng, (nq, C)))
        row = {"nq": nq, "ng": ng, "d": d, "k": K, "threads": torch.get_num_threads()}
        for name, (scorer, (tq, tg)) in ways.items():
            knn._tiled_scores, knn._TILE_Q, knn._TILE_G = scorer, tq, tg
            try:
                row[f"{name}_knn_ms"] = best_of(lambda: knn.knn_search(g, q, K))
                row[f"{name}_rank_ms"] = best_of(lambda: knn.rank_candidates(g, q, cand))
            finally:
                knn._tiled_scores, (knn._TILE_Q, knn._TILE_G) = tiles, tile_shape
        whole = tiles(g, q)
        row["tiles_shape_stable"] = bool(torch.equal(tiles(g[777:ng - 5], q[3:11]),
                                                     whole[3:11, 777:ng - 5]))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
