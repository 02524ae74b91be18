#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: name and power limit;
  2. build every CUDA kernel of the port with nvcc (one process per source,
     started together) into build/torch_kernels/; one line says whether the
     port's native preproc library (native/preproc.cpp, host decode of path
     inputs) built too, for information only;
  3. each kernel against its plain PyTorch version on the card:
     - gem_l2n at the GeM head's widths (B=16, 32x32 map, C=2048, and the
       other trunks' 256, 1024, 1664 and 2208; f32 and bf16, ragged
       extents), and a second call bit for bit;
     - netvlad at config 3's head width (B=16, 64x64 map, C=512, K=64, f32,
       ragged extents with a (0, 0) row, one image with zero-mass clusters),
       and on the same map at K=256; a second call bit for bit;
     - fused_topk and scores_blockmax at the search shape (256 queries x
       100,000 x 2048, f32 and bf16), and the exact long-shortlist search
       (blockmax_topk_search, knn_search) at k=200 and 1000, with planted
       duplicate rows; the two kernels' scores bit for bit against each
       other (they share one mainloop), and both at ragged shapes (Nq 1,
       20, 257 x Ng 1, 63, 65, 100,003 x D 2048, 4096, 100, 37, f32 and
       bf16, plus galleries that are not 16-byte aligned);
     - adc_scores bit for bit at 256 queries x 100,000 codes x M=64, 64 x
       10,000 x M=256 (many LUT slices) and 33 x 5,003 x M=16 (queries and
       rows ragged against the kernel's groups), planted duplicate code
       rows, and adc_topk_core's tie order;
     - bottleneck_fused at resnet50's four stride-1 block shapes of a
       16-image 1024 px bucket, at layer1 of a 720 x 1024 bucket, and at a
       batch of 37 small images (5 x 7) whose 128-pixel tiles span images,
       with random biases; in f32 (1e-5 of max|plain|) and in bf16 at the
       same shapes (the bf16 kernel against the plain version at the JAX
       kernel's rounding points, within one bf16 ulp at max|plain|, at most
       5 % of the values not equal bit for bit, a second call bit for bit;
       the launch plan the built library reports held against the
       wrapper's);
  4. fourteen paths at full width, each with the launch counts set to 0 just
     before it and read just after it; the extraction paths run on an
     in-memory clustered corpus of 100 images in three aspect ratios and 20
     queries, random weights from a seeded torch.Generator:
     - graded config 2 (resnet50 + GeM, fused head, 1024 px, scales 1,
       1/sqrt(2), 1/2, f32): extract_features -> build_index(pca) ->
       Index.query(k=10) through the fused top-k kernel -> Index.ranks -> mAP;
     - graded config 3 (vgg16 + NetVLAD K=64, fused head, 1024 px, one
       scale, f32): the same through build_index(pca, whiten_dims=4096);
     - exact search with a long shortlist: Index.query(k=1000) over a
       100,000 x 2048 gallery, through the score/block-max kernel;
     - compressed-gallery search (path A) on the JAX package's ANN-bench
       corpus (100,000 x 2048 clustered, 256 queries): IVFIndex (C = 316)
       at nprobe C/8 and C, PQIndex(m=64) with and without refine=400, OPQ
       (opq_iters cut to 2 for time), IVFPQIndex.from_ivf(m=64) at nprobe
       C/4 with refine=400, recall@10/100 against exact Index.query(k=100);
       each search is timed on its second call (the first uploads the
       index); then a second point where the corpus keeps its cells (D=512,
       noise scaled to the row, M=16, no OPQ), and at both points the card's
       PQ, OPQ and IVF-PQ results for 32 queries held against the same
       indexes searched on the CPU;
     - graded config 2 again with fuse_blocks=True (path B): the fused
       bottleneck trunk, descriptors held against the unfused run;
     - graded config 5 (path C, aachen-1m-pod: resnet101 in bf16, fused
       GeM head, 1024 px, batch 16): the corpus extracted, then
       benchmarks.run_gallery_scale at 1,000,000 rows (distractors made on
       the card, PCA learned and applied there, a bf16 gallery, exact
       knn_search k=100 timed p50/p99, localization recall@1/5/10/20, the
       pairs file, Index.save(external_gallery=True) into a temporary
       directory, reload and a probe through fused top-k) and
       localize_shortlist(k=20) on the reloaded artifact; after the
       window, rank_candidates for the corpus's candidates on that gallery
       against a dense ranking made on the card by cuBLAS (equal ranks
       except where scores lie within 1e-6; equal mAP), timed beside the
       B3 route that sharded ranks take, the bf16 descriptors against an
       f32 run of the same weights on 16 images, and the four bf16 kernels
       of the path against their plain versions at its own shapes;
     - graded config 5 with fuse_blocks=True (path I, after path C): the
       same corpus, queries and weights through extract_features ->
       build_index(pca) -> Index.query(k=10) -> mAP, resnet101's 29
       stride-1 blocks of every batch through the bf16 bottleneck kernel
       (launches gated at 29 x the GeM head's); descriptors against path
       C's unfused bf16 ones (1e-2, cosine 0.999), self top-1, mAP beside
       path C's on the same 100-row index with any moved positive and its
       score gap named, img/s cold and warm beside path C's, the idle share
       and the device time by group;
     - graded config 4 (path E, r101-gem-100k-sharded: config 5's trunk,
       so path C's core and query descriptors): an NCCL process group of
       world size 1 and a mesh of 4 row shards on the card;
       benchmarks.run_gallery_scale(4) (a 100,000 x 2,048 f32 gallery, PCA
       on the core plus 50,000 distractors, the sharded top-100 timed
       p50/p95/p99 over 7 repetitions, the bitwise exactness probe against
       one device's knn_search), ShardedIVF (nprobe C/8 and C) and
       ShardedPQ (m=64, with and without refine=400) on path A's D=2048
       corpus against IVFIndex.search and PQIndex.search; after the window,
       candidate ranks against dense rankings on the card: one device's
       (cuBLAS) by path C's gate, the sharded ones (B3 per shard) bit for
       bit against B3's dense ranking and against cuBLAS's except within
       twice the measured B3-vs-cuBLAS score difference, and
       scores_blockmax and adc_scores at a shard's shape against their
       plain versions;
     - re-ranking (path F) on path E's gallery at the JAX package's
       defaults with qe_nqe = dba_nqe = 10: Index.query(k=100, qe_nqe=10)
       timed, build_index(dba_nqe=10), build_graph(k=50) twice (bit for
       bit) and Index.diffusion_ranks twice (bit for bit); after the
       window, the card against the CPU on 10,000 rows (expanded queries,
       the QE top-100, the diffusion graph's weights, offsets and degrees,
       the diffusion relevance) and scores_blockmax at the
       graph's block shape against its plain version;
     - the other trunks and regional extraction (path H, after the serving
       path G and before path D): densenet121 + GeM with the fused head at config 2's shape
       (1024 px, three scales, f32) through extract_features ->
       build_index(pca) -> Index.query(k=10) -> mAP, held against the plain
       head, img/s cold and warm, idle share; alexnet-gem and
       squeezenet1_1-gem on one padded bucket through the masked GeM kernel
       against the plain head; alexnet-gem, squeezenet1_1-gem and
       densenet121-gem in bf16 on the same bucket through the masked GeM
       kernel, against the plain head (1e-5) and against the f32 run of
       the same weights (1e-2, cosine 0.999); vgg16-rmac on bucketed batches, rmac_bucketed
       per image against rmac on its own corner of the map (region counts
       equal); resnet101 + GeM regional with whiten_dim 2048:
       extract_regional and extract_local on the 20 queries; densenet121's
       extract_resumable in shards of 32, the later two deleted and resumed
       bit for bit; every MODEL_ZOO preset built and one .pth loaded back
       through load_model bit for bit;
     - path D, training (cirtorch's retrievalSfM120k-resnet101-gem recipe:
       contrastive margin 0.85, Adam lr 5e-7, 5 negatives, 5 tuples a step,
       362 px, f32, the kernel head): run_training for one epoch on a
       synthetic pool on disk (100 scenes x 8 views of 272 x 368 px, qsize
       100, the whole pool as poolsize: mining through the score/block-max
       kernel, ~20 steps, validation mAP, best/latest checkpoints, Lw
       whitening), then
       run_training_bench at 362 px (2 warm-up and 10 timed steps, p50/p95,
       tuples/s, images/s, peak memory, idle share over 10 profiled steps),
       kernel-head steps held against plain-head steps on one batch of real
       tuples (masked u8, unmasked through train_epoch, and a frozen trunk
       with p trainable: losses 1e-5, gradients 1e-4 of max|g|, BN running
       statistics equal; deterministic cuDNN), and vgg16 + NetVLAD K=64
       for two steps through netvlad_fused_rect against the plain head;
       after the window, mining's search at its own shape (100 x 900 x
       2048, k=200) under the trained weights: scores_blockmax and
       knn_search against their plain versions, and the epoch's tuples
       mined on the card against those mined on the CPU;
     - path J, data parallelism over the mesh's data axis (after path D):
       config 2 through Extractor(mesh=create_mesh([2, 1], devices=[cuda:0,
       cuda:0])) against config 2's one-device descriptors, top-10 and mAP,
       and config 2's Index sharded on a 2 x 2 mesh bit for bit; then path
       D's recipe for 3 steps on 4 masked u8 tuples (2 a process) run first
       here by one process with its BatchNorm on the data-parallel path
       (float64 sums, a group of one) and again with the tuples reversed
       (the step's own f32 spread), and this script started twice
       more as --dp-worker processes (NCCL, one card each, on two or more
       cards; gloo, both on cuda:0, on one), each extracting config 2 over
       the data axis and running the 3 steps data-parallel, held step by
       step against the one-process run (loss, gradients, BN statistics,
       parameters, and each strongly driven weight's update against the
       reference's), with kernel B1 launched in each; a worker that fails or
       outlives 300 s fails the run; ``--path-j`` runs the build and this
       path alone;
     - path K, the tooling (after path J): benchmarks.run_full_system_bench
       at config 2's model (resnet50 + GeM, 1024 px, batch 16, bf16, kernel
       B1) on 64 JPEGs of 1200 x 1600 inside utils.metrics.profile_trace
       (decode img/s per thread count, device and end-to-end img/s,
       overlap_efficiency; the GeM launches the trace names against the
       wrappers' counts), on one batch's worth of the JPEGs the extractor's
       host pipeline alone and one end-to-end extraction under profile_trace
       and under profile_window, B1 on that batch against the plain head;
       measure_bucketing_delta (resnet50, 1024 px, f32, kernel head) beside
       its CPU run, stress cos_min >= 0.99; the CLI on the card (fullsystem,
       parity, download and extract --network from a localhost HTTP server);
       debug_checks and assert_deterministic on the card;
  5. timings (CUDA events, median of 20, through the wrapper; for gem_l2n,
     netvlad and adc_scores also the kernel's device time from torch.profiler
     (netvlad: the kernels its entry launches, summed), and
     on a log line the launch plan the built kernel reports) beside each
     kernel's bound (gem_l2n also at densenet169's C = 1,664, and at 1,666,
     whose C % 4 != 0 takes the kernel's scalar path), and
     fused_topk's q/s at 1, 32 and 256 queries beside torch.topk(q @ g.T);
     the bottleneck at each block shape and summed over resnet50's 12
     stride-1 blocks at the 1024 px bucket, beside three cuDNN convs; its
     bf16 form at the same shapes and summed over resnet101's 29 stride-1
     blocks, beside its bound, its plain version, cuDNN's three bf16
     convolutions and PR 14's times (quoted), with the launch plan each shape took
     (stage depth, tile, stages, shared memory, tiles and blocks a phase),
     the registers and spills nvcc gave those instantiations and phase 3's
     share of values not bit-equal there;
each config's extraction also runs once more under torch.profiler, which
gives the card's busy and idle share of the wall time and the device time
of the head kernels, the convolutions and cuDNN's layout transforms;
then one JSON line listing the kernels, the nvidia-smi line, and the result
line {"ok": true, "device": {...}}.

It imports the port only (never JAX) and needs the repository next to it.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

# H100 SXM data-sheet peaks: HBM bytes/s and f32 (non-tensor-core) flop/s;
# shared-memory lookups: 132 SMs x 32 a clock x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# dense TF32 on the tensor cores (NVIDIA H100 SXM data sheet); a 3xTF32
# product costs three of these flop
TF32_FLOP_PER_S = 495e12
SMEM_LOOKUPS_PER_S = 132 * 32 * 1.98e9
# dense bf16 on the tensor cores (NVIDIA H100 SXM data sheet)
BF16_FLOP_PER_S = 989e12
BOTTLENECK_TOL = 1e-5  # max|err| / max|plain| per block: f32 sums in another order
GEM_TOL = 1e-5
TOPK_TOL = 1e-5
NETVLAD_TOL = 1e-5   # unit-norm 32,768-d output: expf and summation order
HEAD_TOL = 1e-4      # descriptors, fused head vs plain head
REPS = 20
PALLAS = "image_retrieval_for_image_based_localization_tpu/ops/pallas/"
CSRC = "image_retrieval_for_image_based_localization_tpu_torch/csrc/"


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, prefix: str):
    """Device ms per call of the kernels launched by ``fn`` whose names start
    with ``prefix``, summed, from tools/search_kernel_bench.py's
    ``kernel_ms`` (torch.profiler), or None if the profiler recorded none.
    Taken in phase 3: on an H100 with torch 2.11, profiler sessions after
    phase 4's profiled extractions recorded no kernel."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    from search_kernel_bench import kernel_ms

    own = [v for k, v in kernel_ms(fn).items() if k.startswith(prefix)]
    return sum(own) if own else None


def profile_window(fn):
    """Run ``fn`` under torch.profiler; returns the wall ms, the union of the
    card's kernel intervals in ms, the idle share and device ms by group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_summary(prof.events(), wall_ms)


def device_summary(events, wall_ms):
    """The card's busy ms (the union of its kernel intervals), idle share of
    ``wall_ms`` and device ms by group, from a profiler's events (a named
    range's mirror on the card's timeline is no kernel)."""
    import torch

    spans, groups = [], {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end  # us
        spans.append((start, end))
        n = e.name.lower()
        g = ("head kernel" if "gem_" in n or "netvlad" in n else
             "bottleneck kernel" if "bottleneck" in n else
             "layout transform" if "nhwctonchw" in n or "nchwtonhwc" in n else
             "convolution / gemm" if any(k in n for k in ("conv", "implicit", "xmma", "cudnn",
                                                          "winograd", "fft", "gemm", "cutlass",
                                                          "sm90", "sm80"))
             else "other")
        groups[g] = groups.get(g, 0.0) + (end - start) / 1e3
    busy, cur = 0.0, None
    for start, end in sorted(spans):
        if cur is None or start > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    if cur is not None:
        busy += cur[1] - cur[0]
    busy_ms = busy / 1e3
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if spans else None,
            "device_ms_by_group": groups}


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def build_phase():
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SIGNATURES:
        _build.load(name)
    log(f"[build] {sorted(_build.SIGNATURES)} built/loaded in {time.perf_counter() - t0:.1f} s")
    # informational: path inputs decode with native/preproc.cpp where it builds
    # (the corpus here is in memory, so no phase depends on it)
    from image_retrieval_for_image_based_localization_tpu_torch.data import native

    log(f"[native] port's native preproc library (native/preproc.cpp) built and loaded: "
        f"{native.native_available()}")


# B1 and B2 run at these widths on the main paths: resnet50/101 (2,048, the
# timing row's), alexnet (256), densenet121 (1,024), densenet169 (1,664),
# densenet161 (2,208)
GEM_WIDTHS = (2048, 256, 1024, 1664, 2208)
GEM_TIMED_WIDTH = 1664  # densenet169's: a second timing point for rows 1-2


def _gem_inputs(C, B=16, H=32, W=32, seed=1):
    import torch

    gen = torch.Generator().manual_seed(seed)
    x32 = torch.relu(torch.randn((B, H, W, C), generator=gen))
    hs = torch.randint(1, H + 1, (B,), generator=gen)
    ws = torch.randint(1, W + 1, (B,), generator=gen)
    hs[0], ws[0] = H, W      # full extent
    hs[1], ws[1] = 0, 0      # batch-pad row
    hs[2], ws[2] = H - 9, W  # h < H
    hs[3], ws[3] = H, W - 5  # w < W
    return x32, hs, ws


def check_gem(dev):
    """Both GeM+L2N kernels against the plain version at every width of
    GEM_WIDTHS, f32 and bf16, ragged extents, a second call bit for bit;
    returns the inputs at C = 2,048 and C = 1,664 and the stats."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        gem_l2n_fused,
        gem_l2n_fused_rect,
        gem_l2n_plain,
    )

    p = torch.tensor([3.0], device=dev)
    err = {"gem_l2n_fused_rect": 0.0, "gem_l2n_fused": 0.0}
    kept = {}
    for C in GEM_WIDTHS:
        x32, hs, ws = _gem_inputs(C)
        B, H, W, _ = x32.shape
        x32 = x32.to(dev)
        sizes = torch.stack([hs, ws], 1).to(torch.int32).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype).contiguous()
            got = gem_l2n_fused_rect(x, p, sizes)
            want = gem_l2n_plain(x, p, sizes)
            e_rect = (got - want).abs().max().item()
            got_u = gem_l2n_fused(x, p)
            e_un = (got_u - gem_l2n_plain(x, p)).abs().max().item()
            same = (torch.equal(got, gem_l2n_fused_rect(x, p, sizes))
                    and torch.equal(got_u, gem_l2n_fused(x, p)))
            torch.cuda.synchronize()
            log(f"[check] gem_l2n C={C} {dtype}: rect max|err| {e_rect:.3e}, unmasked "
                f"{e_un:.3e}, second call bit-equal {same}")
            if not (e_rect <= GEM_TOL and e_un <= GEM_TOL):
                raise AssertionError(f"gem_l2n C={C} {dtype} disagrees with its plain version")
            if not same:
                raise AssertionError(f"gem_l2n C={C} {dtype} is not deterministic")
            if got[1].abs().max().item() != 0.0:
                raise AssertionError("a (0, 0) row must give a zero descriptor")
            err["gem_l2n_fused_rect"] = max(err["gem_l2n_fused_rect"], e_rect)
            err["gem_l2n_fused"] = max(err["gem_l2n_fused"], e_un)
        if C in (GEM_WIDTHS[0], GEM_TIMED_WIDTH):
            valid = int((hs * ws).sum())
            dev_ms = {"gem_l2n_fused_rect": device_ms(
                          lambda: gem_l2n_fused_rect(x32, p, sizes), "gem_l2n_kernel"),
                      "gem_l2n_fused": device_ms(lambda: gem_l2n_fused(x32, p),
                                                 "gem_l2n_kernel")}
            if C == GEM_TIMED_WIDTH:
                # a width that is not a multiple of 4 takes the kernel's
                # scalar path (no trunk of the repo has one): the same map
                # at C + 2
                xs = torch.nn.functional.pad(x32, (0, 2)).contiguous()
                dev_ms["scalar_rect"] = device_ms(lambda: gem_l2n_fused_rect(xs, p, sizes),
                                                  "gem_l2n_kernel")
                del xs
            kept[C] = {"x": x32, "p": p, "sizes": sizes, "valid_positions": valid,
                       "device_ms": dev_ms}
        else:
            del x32
    log(f"[check] gem_l2n extents: {kept[GEM_WIDTHS[0]]['valid_positions']} of "
        f"{B * H * W} positions valid")
    return dict(kept[GEM_WIDTHS[0]], err=err, at_timed_width=kept[GEM_TIMED_WIDTH])


_TOPK_CACHE = {}


def _topk_inputs(dev, dtype, Nq=256, Ng=100_000, D=2048, n_dup=2):
    """Unit-norm gallery with each query's source row planted again at
    ``n_dup`` random other positions; queries are noisy copies of sources.
    Made once on the host and kept on the card."""
    if dtype not in _TOPK_CACHE:
        _TOPK_CACHE[dtype] = _make_topk_inputs(dev, dtype, Nq, Ng, D, n_dup)
    return _TOPK_CACHE[dtype]


def _make_topk_inputs(dev, dtype, Nq, Ng, D, n_dup):
    import torch

    gen = torch.Generator().manual_seed(2)
    g = torch.nn.functional.normalize(torch.randn((Ng, D), generator=gen), dim=1)
    src = torch.randperm(Ng, generator=gen)[:Nq]
    dst = torch.randperm(Ng, generator=gen)
    dst = dst[~torch.isin(dst, src)][: Nq * n_dup].reshape(Nq, n_dup)
    g[dst.reshape(-1)] = g[src.repeat_interleave(n_dup)]
    q = torch.nn.functional.normalize(g[src] + 0.6 * torch.randn((Nq, D), generator=gen)
                                      / D ** 0.5, dim=1)
    groups = torch.cat([src[:, None], dst], 1)  # [Nq, 1 + n_dup] identical rows
    return g.to(dev).to(dtype).contiguous(), q.to(dev), groups


def check_topk_result(s, i, ps, pi, groups):
    """Scores within tolerance, indices equal where the plain scores are
    separated, strict (score desc, index asc) order, duplicates lower-index
    first. Returns max |score error|."""
    import torch

    err = (s - ps).abs().max().item()
    if err > TOPK_TOL:
        raise AssertionError(f"scores differ from the plain version by {err}")
    big = torch.full_like(ps[:, :1], float("inf"))
    gap_next = torch.cat([ps[:, :-1] - ps[:, 1:], big], 1)
    gap_prev = torch.cat([big, ps[:, :-1] - ps[:, 1:]], 1)
    clear = (gap_next > TOPK_TOL) & (gap_prev > TOPK_TOL)
    if not torch.equal(i[clear], pi[clear]):
        raise AssertionError("indices differ where the plain scores are separated")
    sv, iv = s.cpu(), i.cpu()
    ordered = (sv[:, :-1] > sv[:, 1:]) | ((sv[:, :-1] == sv[:, 1:]) & (iv[:, :-1] < iv[:, 1:]))
    if not bool(ordered.all()):
        raise AssertionError("kernel output is not in (score desc, index asc) order")
    n_checked = 0
    for row in range(iv.shape[0]):
        members = sorted(groups[row].tolist())
        hit = [m for m in members if m in set(iv[row].tolist())]
        if hit:
            n_checked += 1
            if hit != members[: len(hit)]:
                raise AssertionError(f"duplicates not lower-index first: {members} -> {hit}")
            pos = [iv[row].tolist().index(m) for m in hit]
            if len({float(sv[row, j]) for j in pos}) != 1:
                raise AssertionError("duplicate rows scored differently")
    if n_checked < iv.shape[0] // 2:
        raise AssertionError(f"only {n_checked} queries retrieved their planted duplicates")
    return err


def check_topk(dev):
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        fused_topk_plain,
        fused_topk_search,
    )

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        g, q, groups = _topk_inputs(dev, dtype)
        for k in (100, 128):
            s, i = fused_topk_search(g, q, k)
            ps, pi = fused_topk_plain(g, q, k)
            torch.cuda.synchronize()
            e = check_topk_result(s, i, ps, pi, groups)
            log(f"[check] fused_topk {dtype} k={k}: max|score err| {e:.3e}, "
                f"indices and duplicate order ok")
            err = max(err, e)
    return err


def _netvlad_inputs(dev, B=16, H=64, W=64, C=512, K=64):
    """Config 3's head input: a 64x64 map (1024 px at stride 16) of C=512
    ReLU features, K=64 clusters, ragged extents. Image 2 lies along one
    direction, so most of its clusters get exactly zero soft mass."""
    import torch

    gen = torch.Generator().manual_seed(3)
    x = torch.relu(torch.randn((B, H, W, C), generator=gen))
    x[2] = 100.0 * torch.randn(C, generator=gen).abs() + 0.1 * x[2]
    c = torch.randn((K, C), generator=gen)
    w = torch.randn((C, K), generator=gen) / C ** 0.5
    b = 0.1 * torch.randn(K, generator=gen)
    hs = torch.randint(1, H + 1, (B,), generator=gen)
    ws = torch.randint(1, W + 1, (B,), generator=gen)
    hs[0], ws[0] = H, W      # full extent
    hs[1], ws[1] = 0, 0      # batch-pad row
    hs[2], ws[2] = H, W      # the zero-mass image, full extent
    hs[3], ws[3] = H - H // 4, W  # h < H
    hs[4], ws[4] = H, W - W // 3  # w < W
    sizes = torch.stack([hs, ws], 1).to(torch.int32)
    x, c, w, b, sizes = (t.to(dev).contiguous() for t in (x, c, w, b, sizes))
    return {"x": x, "c": c, "w": w, "b": b, "sizes": sizes,
            "valid_positions": int((hs * ws).sum())}


def check_netvlad(dev):
    """Both NetVLAD kernels against the plain version at config 3's K = 64
    and at K = 256 on the same map; each twice, bit for bit. Returns the
    K = 64 inputs, the errors at both K and the kernels' device ms."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        netvlad_fused,
        netvlad_fused_rect,
        netvlad_plain,
    )

    errs = {"netvlad_fused_rect": 0.0, "netvlad_fused": 0.0}
    for K in (64, 256):
        nv = _netvlad_inputs(dev, K=K)
        x, c, w, b, sizes = nv["x"], nv["c"], nv["w"], nv["b"], nv["sizes"]
        C = c.shape[1]
        got = netvlad_fused_rect(x, c, w, b, sizes=sizes)
        want = netvlad_plain(x, c, w, b, sizes)
        e_rect = (got - want).abs().max().item()
        got_u = netvlad_fused(x, c, w, b)
        e_un = (got_u - netvlad_plain(x, c, w, b)).abs().max().item()
        same = (torch.equal(got, netvlad_fused_rect(x, c, w, b, sizes=sizes))
                and torch.equal(got_u, netvlad_fused(x, c, w, b)))
        torch.cuda.synchronize()
        zero = torch.all(got[2].reshape(K, C) == 0, dim=1)
        B, H, W, _ = x.shape
        log(f"[check] netvlad f32 [{B}, {H}x{W}, {C}] K={K}: rect max|err| {e_rect:.3e}, "
            f"unmasked {e_un:.3e}; zero-mass clusters in image 2: {int(zero.sum())} of {K}; "
            f"{nv['valid_positions']} of {B * H * W} positions valid; second calls "
            f"bit-equal {same}")
        if not (e_rect <= NETVLAD_TOL and e_un <= NETVLAD_TOL):
            raise AssertionError("netvlad disagrees with its plain version")
        if not same:
            raise AssertionError("netvlad gave other bits on a second call")
        if got[1].abs().max().item() != 0.0:
            raise AssertionError("a (0, 0) row must give a zero descriptor")
        if not (0 < int(zero.sum()) < K
                and torch.equal(zero, torch.all(want[2].reshape(K, C) == 0, dim=1))):
            raise AssertionError("zero-mass clusters must give zero rows, as in the plain "
                                 "version")
        norms = got.norm(dim=1)
        if (norms[[0] + list(range(2, len(norms)))] - 1).abs().max().item() > 1e-5:
            raise AssertionError("netvlad descriptors are not unit-norm")
        errs = {"netvlad_fused_rect": max(errs["netvlad_fused_rect"], e_rect),
                "netvlad_fused": max(errs["netvlad_fused"], e_un)}
        if K == 64:
            nv64 = nv
            # every kernel netvlad_forward launches, summed; phase 3 as for gem
            nv64["device_ms"] = {
                "netvlad_fused_rect": device_ms(
                    lambda: netvlad_fused_rect(x, c, w, b, sizes=sizes), "netvlad_"),
                "netvlad_fused": device_ms(lambda: netvlad_fused(x, c, w, b), "netvlad_")}
        del nv, x, c, w, b, sizes, got, want, got_u
    nv64["err"] = errs
    return nv64


def check_scores_blockmax(dev):
    """The score/block-max kernel against its plain version, f32 and bf16."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        scores_blockmax,
        scores_blockmax_plain,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.score_topk import (
        NEG_INF,
    )

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        g, q, _ = _topk_inputs(dev, dtype)
        Ng, nb = g.shape[0], -(-g.shape[0] // 64)
        s, bmax = scores_blockmax(g, q)
        ps, pb = scores_blockmax_plain(g, q)
        torch.cuda.synchronize()
        e = (s[:, :Ng] - ps[:, :Ng]).abs().max().item()
        log(f"[check] scores_blockmax {dtype} {tuple(q.shape)} x {tuple(g.shape)}: "
            f"max|score err| {e:.3e}, bmax max|err| to plain {(bmax - pb).abs().max().item():.3e}")
        if e > TOPK_TOL:
            raise AssertionError(f"scores_blockmax {dtype} disagrees with its plain version")
        if not torch.equal(bmax, s.view(s.shape[0], nb, 64).amax(-1)):
            raise AssertionError("bmax is not the max of the kernel's own scores")
        if s.shape[1] != nb * 64 or not bool(torch.all(s[:, Ng:] == NEG_INF)):
            raise AssertionError("pad columns must score NEG_INF")
        err = max(err, e)
        del s, ps
    return err


def _plain_topk(g, q, k):
    """Reference: dense scores (queries rounded to the gallery dtype) and a
    stable descending sort."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
        score_matrix,
    )

    top, idx = torch.sort(score_matrix(g, q), dim=1, descending=True, stable=True)
    return top[:, :k], idx[:, :k].to(torch.int32)


def check_long_topk(dev):
    """Exact search with k > 128 against the plain stable sort."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        blockmax_topk_search,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
        knn_search,
    )

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        g, q, groups = _topk_inputs(dev, dtype)
        for k in (200, 1000):
            ps, pi = _plain_topk(g, q, k)
            runs = {"blockmax_topk_search": blockmax_topk_search(g, q.to(dtype).float(), k),
                    "knn_search": knn_search(g, q, k)}
            if k == 1000:
                runs["knn_search chunk=32768"] = knn_search(g, q, k, chunk=32768)
            for name, (s, i) in runs.items():
                torch.cuda.synchronize()
                e = check_topk_result(s, i, ps, pi, groups)
                err = max(err, e)
                log(f"[check] {name} {dtype} k={k}: max|score err| {e:.3e}, "
                    f"indices and duplicate order ok")
    return err


def check_search_bitwise(dev):
    """Both exact-search kernels run one mainloop (csrc/sgemm_tile.cuh): at
    the search shape every score fused_topk_search returns must equal
    scores_blockmax's at the same (query, row) bit for bit."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        fused_topk_search,
        scores_blockmax,
    )

    for dtype in (torch.float32, torch.bfloat16):
        g, q, _ = _topk_inputs(dev, dtype)
        s, i = fused_topk_search(g, q, 100)
        full, _ = scores_blockmax(g, q.to(dtype).float())
        same = torch.equal(s, torch.gather(full, 1, i.long()))
        log(f"[check] fused_topk vs scores_blockmax {dtype} {tuple(q.shape)} x {tuple(g.shape)} "
            f"k=100: scores bit-equal {same}")
        if not same:
            raise AssertionError(f"fused_topk and scores_blockmax disagree in bits ({dtype})")
        del full


# ragged search shapes; every combination runs in f32 and bf16
RAGGED_NQ = (1, 20, 257)
RAGGED_NG = (1, 63, 65, 100_003)
RAGGED_D = (2048, 4096, 100, 37)


def _ragged_search_case(dev, dtype, nq, ng, d, layout, seed):
    """Unit-norm rows made on the card. ``slice``: rows 1.. of a larger
    gallery; ``offset``: the gallery starts one element into a flat buffer;
    neither is 16-byte aligned, so the kernels take their scalar-load path."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.nn.functional.normalize(torch.randn((ng + 1, d), generator=gen, device=dev), dim=1)
    q = torch.nn.functional.normalize(torch.randn((nq, d), generator=gen, device=dev), dim=1)
    g = g.to(dtype)
    if layout == "slice":
        return g[1:], q
    if layout == "offset":
        flat = torch.empty(ng * d + 1, dtype=dtype, device=dev)
        gallery = flat[1:].view(ng, d)
        gallery.copy_(g[1:])
        return gallery, q
    return g[1:].clone(), q


def _check_search_case(s, i, ps, pi, next_score=None):
    """Scores within TOPK_TOL, indices equal where the plain scores are
    separated, strict (score desc, index asc) order. ``next_score`` [Nq] is
    the plain score of each row's first place past the shortlist: a last
    place tied with it (within TOPK_TOL) may name either row."""
    import torch

    err = (s - ps).abs().max().item()
    big = torch.full_like(ps[:, :1], float("inf"))
    last = big if next_score is None else ps[:, -1:] - next_score[:, None]
    gap_next = torch.cat([ps[:, :-1] - ps[:, 1:], last], 1)
    gap_prev = torch.cat([big, ps[:, :-1] - ps[:, 1:]], 1)
    clear = (gap_next > TOPK_TOL) & (gap_prev > TOPK_TOL)
    ordered = (s[:, :-1] > s[:, 1:]) | ((s[:, :-1] == s[:, 1:]) & (i[:, :-1] < i[:, 1:]))
    moved = clear & (i != pi)
    ok = err <= TOPK_TOL and not bool(moved.any()) and bool(ordered.all())
    if not ok:
        def cols(m):
            return sorted(set(torch.nonzero(m)[:, 1].tolist()))

        log(f"[search check] {tuple(s.shape)} fails: score max|err| {err:.3e} (tol {TOPK_TOL}); "
            f"another index at a clear place in columns {cols(moved)}; out of order after "
            f"columns {cols(~ordered)}")
    return ok, err


def _check_blockmax_case(g, q):
    """scores_blockmax against its plain version on (g, q): scores within
    TOPK_TOL, the padding columns NEG_INF, the block maxima those of the
    scores. Returns (ok, max|err|)."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        scores_blockmax,
        scores_blockmax_plain,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.score_topk import (
        NEG_INF,
    )

    (nq, ng), nb = (q.shape[0], g.shape[0]), -(-g.shape[0] // 64)
    s, bmax = scores_blockmax(g, q)
    ps, _ = scores_blockmax_plain(g, q)
    err = (s[:, :ng] - ps[:, :ng]).abs().max().item()
    ok = (err <= TOPK_TOL and s.shape == (nq, nb * 64) and bool(torch.all(s[:, ng:] == NEG_INF))
          and torch.equal(bmax, s.view(nq, nb, 64).amax(-1)))
    return ok, err


def check_search_shapes(dev):
    """Both exact-search kernels against their plain versions at ragged Nq,
    Ng and D in f32 and bf16, and on galleries that are not 16-byte
    aligned. Returns the max errors {kernel: err}."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        fused_topk_plain,
        fused_topk_search,
    )

    cases = [(nq, ng, d, "rows") for nq in RAGGED_NQ for ng in RAGGED_NG for d in RAGGED_D]
    cases += [(20, 100_003, 37, "slice"), (257, 100_003, 100, "slice"),
              (257, 100_003, 2048, "offset")]
    errs = {"fused_topk_search": 0.0, "scores_blockmax": 0.0}
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for n, (nq, ng, d, layout) in enumerate(cases):
            g, q = _ragged_search_case(dev, dtype, nq, ng, d, layout, seed=20 + n)
            ng, d = g.shape
            aligned = g.data_ptr() % 16 == 0
            ok_sb, e_sb = _check_blockmax_case(g, q)
            k = min(100, ng)
            fs, fi = fused_topk_search(g, q, k)
            ok_ft, e_ft = _check_search_case(fs, fi, *fused_topk_plain(g, q, k))
            if not (ok_sb and ok_ft):
                raise AssertionError(f"{dtype} Nq={nq} Ng={ng} D={d} {layout} (aligned "
                                     f"{aligned}): scores_blockmax ok {ok_sb} err {e_sb:.3e}, "
                                     f"fused_topk ok {ok_ft} err {e_ft:.3e}")
            errs["scores_blockmax"] = max(errs["scores_blockmax"], e_sb)
            errs["fused_topk_search"] = max(errs["fused_topk_search"], e_ft)
            if layout != "rows":
                log(f"[check] search {dtype} Nq={nq} Ng={ng} D={d} {layout}, 16-byte aligned "
                    f"{aligned}: scores_blockmax {e_sb:.3e}, fused_topk k={k} {e_ft:.3e}")
            del g, q, fs, fi
    torch.cuda.empty_cache()
    log(f"[check] search kernels at {len(cases)} shapes x 2 dtypes (Nq {RAGGED_NQ}, Ng "
        f"{RAGGED_NG}, D {RAGGED_D}, plus unaligned): max|err| {json.dumps(errs)}, "
        f"{time.perf_counter() - t0:.1f} s")
    return errs


def _adc_inputs(dev, nq, n, M, seed):
    """Random LUTs (unit-scale scores) and codes with each 7th row of the
    second half a copy of row 3."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    lut = (torch.randn((nq, M, 256), generator=gen) / M ** 0.5).to(dev)
    codes = torch.randint(0, 256, (n, M), generator=gen, dtype=torch.uint8)
    codes[n // 2 :: 7] = codes[3]
    return lut, codes.to(dev)


def check_adc(dev):
    """The ADC kernel against its plain version at the path-A shape (M=64)
    and the sliced-LUT shape (M=256); returns the path-A inputs and errors."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        adc_scores,
        adc_scores_plain,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.score_topk import (
        NEG_INF,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import (
        adc_topk_core,
    )

    err, main = 0.0, None
    # path A's shape, the sliced LUT at M = 256, and nq, n ragged against the
    # kernel's query groups and row tiles at path A's second point (M = 16)
    for nq, n, M in ((256, 100_000, 64), (64, 10_000, 256), (33, 5_003, 16)):
        lut, codes = _adc_inputs(dev, nq, n, M, seed=8)
        s, bmax = adc_scores(lut, codes)
        ps, pb = adc_scores_plain(lut, codes)
        torch.cuda.synchronize()
        nb = -(-n // 64)
        e = (s - ps).abs().max().item()
        dup = torch.nonzero((codes == codes[3]).all(1)).flatten()
        log(f"[check] adc_scores {nq} x {n} x M={M}: max|score err| {e:.3e}, "
            f"{len(dup)} duplicate rows")
        if not (torch.equal(s, ps) and torch.equal(bmax, pb)):
            raise AssertionError("adc_scores is not bit-equal to its plain version")
        if not torch.equal(bmax, s.view(nq, nb, 64).amax(-1)):
            raise AssertionError("adc bmax is not the max of the kernel's own scores")
        if s.shape[1] != nb * 64 or not bool(torch.all(s[:, n:] == NEG_INF)):
            raise AssertionError("adc pad columns must score NEG_INF")
        if len(dup) < 2 or not bool(torch.all(s[:, dup] == s[:, dup[:1]])):
            raise AssertionError("duplicate code rows must score bit-equal")
        top, idx = adc_topk_core(lut, codes, k=100, chunk=65536)
        tv, iv = top.cpu(), idx.cpu()
        ordered = (tv[:, :-1] > tv[:, 1:]) | ((tv[:, :-1] == tv[:, 1:]) & (iv[:, :-1] < iv[:, 1:]))
        if not bool(ordered.all()):
            raise AssertionError("adc_topk_core is not in (score desc, row asc) order")
        err = max(err, e)
        if main is None:
            main = (lut, codes)
    same = torch.full((3000, 64), 17, dtype=torch.uint8, device=dev)
    _, i = adc_topk_core(main[0][:4].contiguous(), same, k=200, chunk=1024)
    if not torch.equal(i, torch.arange(200, device=dev, dtype=torch.int32).expand(4, -1)):
        raise AssertionError("adc_topk_core does not put the lower row first on ties")
    log("[check] adc_topk_core: (score desc, row asc), equal rows lower-row first")
    return {"lut": main[0], "codes": main[1], "err": err,
            "device_ms": device_ms(lambda: adc_scores(*main), "adc_scores_kernel")}


# resnet50's stride-1 identity blocks on a 16-image 1024 px bucket (scale 1),
# [B, H, W, Cin] and Cm, and layer1 of a 720 x 1024 bucket; layers 1-4 hold
# 2, 3, 5 and 2 of the 12 blocks
BOTTLENECK_SHAPES = (((16, 256, 256, 256), 64), ((16, 128, 128, 512), 128),
                     ((16, 64, 64, 1024), 256), ((16, 32, 32, 2048), 512),
                     ((16, 180, 256, 256), 64))
BOTTLENECK_MIX = (2, 3, 5, 2, 0)
R101_MIX = (2, 3, 22, 2, 0)  # resnet101's 29 stride-1 blocks over the same shapes
# the bf16 kernel's times before its redesign (PR 14's first kernel, this
# script on an NVIDIA H100 80GB HBM3 at 700 W): layers 1-4, and the 29
# blocks; quoted in phase 5's log beside this run's, never in the kernels line
PR14_BF16_MS = (1.597, 1.157, 0.932, 0.836)
PR14_BF16_29_BLOCKS_MS = 28.84
# checked too: 128-pixel tiles that span small images, where a 3x3 tap that
# leaked across an image border would show
BOTTLENECK_SPANNING = ((37, 5, 7, 256), 64)


def _bottleneck_inputs(dev, shape, cm, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    cin = shape[3]
    x = torch.relu(torch.randn(shape, generator=gen))
    w1 = torch.randn((cin, cm), generator=gen) * (2 / cin) ** 0.5
    w2 = torch.randn((3, 3, cm, cm), generator=gen) * (2 / (9 * cm)) ** 0.5
    w3 = torch.randn((cm, cin), generator=gen) * (2 / cm) ** 0.5
    b1, b2, b3 = (0.1 * torch.randn(c, generator=gen) for c in (cm, cm, cin))
    return [t.to(dev).contiguous() for t in (x, w1, b1, w2, b2, w3, b3)]


def check_bottleneck(dev):
    """The fused bottleneck against its plain version (three cuDNN convs)
    at every stride-1 block shape of resnet50 and at tiles spanning images;
    returns the max errors."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        bottleneck_fused,
        bottleneck_plain,
    )

    err = rel = 0.0
    for i, (shape, cm) in enumerate(BOTTLENECK_SHAPES + (BOTTLENECK_SPANNING,)):
        args = _bottleneck_inputs(dev, shape, cm, seed=10 + i)
        got = bottleneck_fused(*args)
        want = bottleneck_plain(*args)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        r = e / want.abs().max().item()
        log(f"[check] bottleneck_fused {list(shape)} Cm={cm}: max|err| {e:.3e}, "
            f"relative to max|plain| {r:.3e}")
        if not r <= BOTTLENECK_TOL:
            raise AssertionError(f"bottleneck_fused {shape} disagrees with its plain version")
        err, rel = max(err, e), max(rel, r)
        del args, got, want
    torch.cuda.empty_cache()
    return err, rel


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at a positive normal magnitude v: 2^(floor(log2 v) - 7)."""
    import math

    return 2.0 ** (math.floor(math.log2(v)) - 7)


BF16_NOT_EQUAL_SHARE = 0.05  # of a bf16 block's values; sound runs read 0.04-0.95 %


def _compare_bottleneck_bf16(tag, got, again, want):
    """Gate one bf16 bottleneck result against its plain version: bf16, a
    second call bit for bit, max|err| within one bf16 ulp of max|plain|, and
    at most BF16_NOT_EQUAL_SHARE of the values not bit-equal. The kernel and
    the plain version sum in f32 in different orders, so a few roundings
    flip by one ulp; a flip at a value in max|plain|'s binade is one ulp
    there, between 2^-8 and 2^-7 of max|plain|. One ulp alone cannot tell a
    rounding toward zero from one to nearest even; the share can, since a
    wrong rounding mode flips tens of percent. Returns (max|err|, max|err| /
    max|plain|, share not bit-equal)."""
    import torch

    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16 or not torch.equal(got, again):
        raise AssertionError(f"{tag}: not bf16, or a second call gave other bits")
    n_neq = int((got != want).sum())
    share = n_neq / got.numel()
    g, w = got.float(), want.float()
    e, top = (g - w).abs().max().item(), w.abs().max().item()
    log(f"[check] {tag}: max|err| {e:.3e}, relative to max|plain| {e / top:.3e}, "
        f"{e / bf16_ulp(top):.3g} of the gate: one bf16 ulp at max|plain| {top:.4g}, "
        f"{bf16_ulp(top):.3e} ({bf16_ulp(top) / top:.3e} of it); {n_neq} of {got.numel()} "
        f"values not equal bit for bit ({share:.3e}, gate {BF16_NOT_EQUAL_SHARE}); second "
        f"call bit-equal")
    if not (e <= bf16_ulp(top) and share <= BF16_NOT_EQUAL_SHARE):
        raise AssertionError(f"{tag} disagrees with its plain version")
    return e, e / top, share


PHASE_NAMES = ("conv1", "conv3x3", "conv1_skip")


def bottleneck_bf16_build_info():
    """Registers and spills of each instantiation of the bf16 bottleneck
    kernel, from nvcc's -Xptxas -v log beside the built library: {(phase,
    BN, BK): {"registers", "spill_stores", "spill_loads"}}, and the log's
    lines that warn (setmaxnreg ignored, wgmma serialised, ...)."""
    import re

    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build

    with open(_build.library_path("bottleneck_bf16")[: -len(".so")] + ".log") as f:
        log_text = f.read()
    info, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"entry function '(\w*bottleneck_bf16_phase\w*)'", line)
        if m:
            t = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)E", m.group(1))
            cur = (PHASE_NAMES[int(t.group(1))], int(t.group(2)), int(t.group(3)))
            info[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            info[cur]["spill_stores"], info[cur]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[cur]["registers"] = int(m.group(1))
            cur = None
    warnings = [ln.strip() for ln in log_text.splitlines()
                if re.search(r"warning|serializ|ignored", ln, re.I)]
    return info, warnings


def bf16_plan(shape, cm):
    """The bf16 kernel's launch plan at a block shape on this card's SM
    count, as the wrapper's _plan gives it (the C source's formula; the CPU
    tests hold _plan against the source's constants)."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.bottleneck import (
        _plan,
    )

    return _plan(*shape, cm, torch.bfloat16,
                 sms=torch.cuda.get_device_properties(0).multi_processor_count)


def plan_summary(plan) -> str:
    """'BK=64; conv1 128x128 5 stages 230,512 B, 1,024 tiles on 132 blocks; ...'"""
    return f"BK={plan['bk']}; " + "; ".join(
        f"{name} {p['bm']}x{p['bn']} {p['stages']} stages {p['smem']:,} B, {p['tiles']:,} tiles "
        f"on {p['blocks']} blocks" for name, p in zip(PHASE_NAMES, plan["phases"]))


def check_bottleneck_bf16(dev):
    """The bf16 form of the fused bottleneck against its plain version (f32
    cuDNN convolutions of the bf16 values, rounded where the JAX kernel
    rounds) at the same shapes as the f32 check, the weights packed once as
    the fused trunk packs them; gated by _compare_bottleneck_bf16. Returns
    the max error, the max error relative to max|plain|, the largest share
    of values not equal bit for bit and the share at each shape. Each
    shape's launch plan is logged."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        bottleneck_fused,
        bottleneck_plain,
        pack_bf16,
    )

    err = rel = neq_share = 0.0
    shares = {}
    for i, (shape, cm) in enumerate(BOTTLENECK_SHAPES + (BOTTLENECK_SPANNING,)):
        plan = bf16_plan(shape, cm)
        args = _bottleneck_inputs(dev, shape, cm, seed=10 + i)
        args[0] = args[0].to(torch.bfloat16)
        pk = pack_bf16(args[1], args[3], args[5])
        got = bottleneck_fused(*args, packed=pk)
        again = bottleneck_fused(*args, packed=pk)
        want = bottleneck_plain(*args)
        e, r, share = _compare_bottleneck_bf16(
            f"bottleneck_fused bf16 {list(shape)} Cm={cm} ({plan_summary(plan)})", got, again,
            want)
        err, rel, neq_share = max(err, e), max(rel, r), max(neq_share, share)
        shares[(shape, cm)] = share
        del args, got, again, want
    torch.cuda.empty_cache()
    return err, rel, neq_share, shares


def make_corpus(n_scenes=20, views=5, seed=0):
    """Clustered in-memory corpus, max side 1024 (so no resize, no PIL):
    each scene is a low-frequency textured prototype; its views are crops
    in three aspect ratios with shift, gain and noise; queries are fresh
    square jitters."""
    import numpy as np

    rng = np.random.RandomState(seed)
    shapes = [(1024, 1024), (720, 1024), (1024, 700)]
    images, labels, queries = [], [], []
    for s in range(n_scenes):
        proto = np.kron(rng.rand(16, 16, 3).astype(np.float32), np.ones((64, 64, 1), np.float32))

        def jitter(h, w, strength):
            img = np.roll(proto, rng.randint(-24, 25), axis=rng.randint(0, 2))[:h, :w]
            img = img * (1 + 0.1 * strength * rng.randn())
            img = img + rng.randn(h, w, 3).astype(np.float32) * 0.05 * strength
            return (np.clip(img, 0, 1) * 255).astype(np.uint8)

        for v in range(views):
            h, w = shapes[v % len(shapes)]
            images.append(jitter(h, w, 1.0))
            labels.append(s)
        queries.append(jitter(1024, 1024, 0.5))
    return images, np.asarray(labels), np.stack(queries)


def main_path_phase(dev, graded_id, expect, fuse_blocks=None):
    """One graded config end to end; ``expect`` names the kernels its run
    must launch. Counts are set to 0 just before the run and read after.
    Returns the launch counts, the measurements and the db and query
    descriptors."""
    import dataclasses

    import numpy as np
    import torch
    import image_retrieval_for_image_based_localization_tpu_torch as port
    from image_retrieval_for_image_based_localization_tpu_torch.data.images import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (
        compute_map,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
        GRADED_CONFIGS,
    )

    images, labels, q_u8 = make_corpus()
    graded = GRADED_CONFIGS[graded_id]
    mc = dataclasses.replace(graded.extract.model, use_pallas=True)
    cfg = dataclasses.replace(graded.extract, model=mc, batch_size=16, fuse_blocks=fuse_blocks)
    tag = f"config {graded_id}" + (" fused trunk" if fuse_blocks else "")
    q_pixels = ((q_u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
    log(f"[{tag}] {graded.name}: {mc.arch} {mc.pooling} fused head, fuse_blocks "
        f"{cfg.fuse_blocks}, {cfg.image_size} px, "
        f"scales {tuple(round(s, 4) for s in cfg.scales)}, index {graded.index}, "
        f"{len(images)} db images, {len(q_u8)} queries")

    ex = port.Extractor(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    db = ex.extract(images)                       # bucketed: masked head kernel
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    qd = ex(q_pixels)                             # whole images: unmasked head kernel
    index = port.build_index(db, graded.index, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    scores, idx = index.query(qd, k=10)           # fused top-k kernel
    t_query = time.perf_counter() - t1
    _, self_idx = index.query(db, k=10)
    ranks = index.ranks(qd)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"[{tag}] launches {launches}")

    gnd = [{"ok": np.flatnonzero(labels == s)} for s in range(len(q_u8))]
    mAP = compute_map(ranks, gnd)[0]
    norms = np.linalg.norm(db, axis=1)
    self_top1 = float(np.mean(self_idx[:, 0] == np.arange(len(db))))
    log(f"[{tag}] extraction {len(images) / t_extract:.2f} img/s ({t_extract:.2f} s), "
        f"query {len(qd) / t_query:.1f} q/s, descriptors {db.shape}, "
        f"index {index.gallery.shape}, self top-1 {self_top1:.3f}, mAP {mAP:.4f}")

    if db.shape != (len(images), ex.out_dim) or not np.isfinite(db).all():
        raise AssertionError(f"descriptors are not finite [N, {ex.out_dim}]")
    if np.abs(norms - 1).max() > 1e-4 or np.abs(np.linalg.norm(qd, axis=1) - 1).max() > 1e-4:
        raise AssertionError("descriptors are not unit-norm")
    if self_top1 != 1.0:
        raise AssertionError(f"self-retrieval top-1 is {self_top1}, want 1.0")
    if not (np.isfinite(scores).all() and 0.0 <= mAP <= 1.0):
        raise AssertionError("non-finite scores or mAP out of range")
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {tag} path")

    # the same extraction again, warm (the first run pays cuDNN and
    # allocator warm-up)
    t0 = time.perf_counter()
    db_warm = ex.extract(images)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    log(f"[{tag}] warm extraction {len(images) / t_warm:.2f} img/s ({t_warm:.2f} s), "
        f"max|diff| to the first run {np.abs(db_warm - db).max():.3e}")
    prof = profile_window(lambda: ex.extract(images))
    log(f"[{tag}] profiled extraction: {json.dumps(prof)}")

    # reference check on a small input: the plain head on the same batch
    plain = port.Extractor(dataclasses.replace(cfg, model=dataclasses.replace(
        mc, use_pallas=False)), state_dict=ex.model.state_dict(), device=dev)
    sub = images[:16]
    d_err = float(np.abs(plain.extract(sub) - ex.extract(sub)).max())
    log(f"[{tag}] fused vs plain head, 16 images x {len(cfg.scales)} scale(s): "
        f"max|descriptor err| {d_err:.3e}")
    if d_err > HEAD_TOL:
        raise AssertionError(f"{tag} descriptors disagree with the plain head")
    # the search kernel at the main path's own shapes
    g = index.device_gallery()
    qt = index.transform_queries(qd)
    s_k, i_k = kernels.fused_topk_search(g, qt, 10)
    s_p, i_p = kernels.fused_topk_plain(g, qt, 10)
    e_main = (s_k - s_p).abs().max().item()
    if e_main > TOPK_TOL or not torch.equal(i_k, i_p):
        raise AssertionError(f"fused top-k disagrees with its plain version on the {tag} path")
    del ex, plain
    torch.cuda.empty_cache()
    return launches, {"extract_img_per_s": len(images) / t_extract,
                      "extract_warm_img_per_s": len(images) / t_warm,
                      "query_q_per_s": len(qd) / t_query, "map": mAP, "d_err": d_err,
                      "topk_main_err": e_main, "descriptor_dim": int(db.shape[1]),
                      "index_dim": int(index.gallery.shape[1]), "profile": prof}, (db, qd)


def long_search_phase(dev):
    """Exact search with a long shortlist through the normal entry point:
    Index.query(k=1000) over the 100,000 x 2048 gallery (no whitening)."""
    import torch
    import image_retrieval_for_image_based_localization_tpu_torch as port
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels

    g, q, groups = _topk_inputs(dev, torch.float32)
    k = 1000
    index = port.build_index(g.cpu().numpy(), port.IndexConfig(whitening=None), device=dev)
    index.device_gallery()  # upload once, outside the timed query
    q_np = q.cpu().numpy()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s, i = index.query(q_np, k=k)
    t_query = time.perf_counter() - t0
    launches = kernels.launch_counts()
    log(f"[long] launches {launches}")
    if launches["scores_blockmax"] <= 0:
        raise AssertionError("scores_blockmax was not launched by Index.query(k=1000)")
    ps, pi = _plain_topk(g, q, k)
    e = check_topk_result(torch.from_numpy(s).to(dev), torch.from_numpy(i).to(dev),
                          ps, pi, groups)
    log(f"[long] Index.query k={k} over {tuple(g.shape)} f32, {len(q_np)} queries: "
        f"{len(q_np) / t_query:.1f} q/s ({t_query * 1e3:.1f} ms incl. host copies), "
        f"max|score err| {e:.3e}, indices and duplicate order ok")
    return launches, {"long_query_q_per_s": len(q_np) / t_query, "long_query_err": e}


def ann_corpus(n=100_000, d=2048, nq=256, seed=0, noise_per_row=False):
    """The JAX package's ANN-bench corpus (benchmarks.py run_ann_bench):
    gaussian cells of 0.35 around max(32, n / 256) random unit centers;
    queries are noisy (0.15) members. The bench's noise is per component,
    so at D=2048 a cell's spread (norm ~16) swamps its unit center.
    ``noise_per_row`` scales it by 1/sqrt(d): the noise's norm is then 0.35
    (0.15) of the center's, and exact neighbours share a cell."""
    import numpy as np
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.normalization import l2n

    def unit(a):
        return l2n(torch.from_numpy(a)).numpy()

    rng = np.random.RandomState(seed)
    scale = d ** -0.5 if noise_per_row else 1.0
    n_cells = max(32, n // 256)
    centers = unit(rng.randn(n_cells, d).astype(np.float32))
    assign = rng.randint(0, n_cells, size=n)
    g = unit(centers[assign] + 0.35 * scale * rng.randn(n, d).astype(np.float32))
    q = unit(g[rng.choice(n, nq, replace=False)]
             + 0.15 * scale * rng.randn(nq, d).astype(np.float32))
    return g, q


def _agree_where_separated(s, i, ref_s, ref_i, tol=TOPK_TOL, score_tol=None):
    """Two top-k lists agree: scores within ``score_tol`` (default ``tol``)
    everywhere, and indices equal at every place whose reference score is
    more than ``tol`` from both neighbours (the last place has an unseen
    neighbour, so only its score is held)."""
    import numpy as np

    gap = ref_s[:, :-1] - ref_s[:, 1:]
    gap_n = np.concatenate([gap, np.zeros_like(ref_s[:, :1])], 1)
    gap_p = np.concatenate([np.full_like(ref_s[:, :1], np.inf), gap], 1)
    clear = (gap_n > tol) & (gap_p > tol)
    return bool(np.array_equal(i[clear], ref_i[clear])
                and np.abs(s - ref_s).max() <= (tol if score_tol is None else score_tol))


def ann_phase(dev):
    """Path A: compressed-gallery search at full width. Each index is built
    and searched through the public entry points; the counts are set to 0
    before the phase and read after it, and each PQIndex.search's own
    launches are read around it. Two points: the ANN bench's corpus at its
    operating point (D=2048, M=64) and one that keeps its cells (D=512,
    M=16, noise scaled to the row), where recall can tell a sound index
    from a weak one."""
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    rows, keep = {}, {}
    C = _ann_point(dev, rows, d=2048, m=64, suffix="", noise_per_row=False, with_opq=True,
                   keep=keep)
    c2 = _ann_point(dev, rows, d=512, m=16, suffix="_d512", noise_per_row=True, with_opq=False)
    launches = kernels.launch_counts()  # this phase's counting window
    log(f"[ann] launches {launches}")
    # where exact neighbours share a cell, a sound index finds most of them
    for name, least in ((f"ivf_nprobe{c2 // 8}_d512", 0.9), ("pq_m16_refine400_d512", 0.9),
                        (f"ivfpq_m16_nprobe{c2 // 4}_refine400_d512", 0.9)):
        if rows[name]["recall_at_100"] < least:
            raise AssertionError(f"{name} recall@100 {rows[name]['recall_at_100']:.4f} is "
                                 f"below {least}")
    return launches, {"ann_rows": rows, "clusters": C}, keep


def _ann_point(dev, rows, d, m, suffix, noise_per_row, with_opq, keep=None):
    """Build and search every index of path A on one corpus; ``rows`` gains
    a row per search (names end in ``suffix``). Returns the IVF's C; with a
    ``keep`` dict, leaves the corpus, its queries, the IVF and the PQ (m)
    index there for path E."""
    import numpy as np
    import torch
    import image_retrieval_for_image_based_localization_tpu_torch as port
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    g, q = ann_corpus(d=d, noise_per_row=noise_per_row)
    log(f"[ann{suffix}] corpus {g.shape} + {q.shape[0]} queries, noise per "
        f"{'row' if noise_per_row else 'component'}, made in {time.perf_counter() - t0:.1f} s")
    gd = torch.from_numpy(g).to(dev)  # the f32 gallery refine reads, uploaded once
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    exact = port.build_index(g, port.IndexConfig(whitening=None), device=dev)
    exact.device_gallery()
    exact_s = time.perf_counter() - t1
    es, ei = exact.query(q, k=100)                  # the recall anchor
    results = {}

    def measure(name, build_s, fn, expect=None):
        name += suffix
        before = kernels.launch_counts()
        fn()  # warm: the first search uploads the index and meets its shapes once
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s, i = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        rec = {kk: float(np.mean([len(set(a[:kk]) & set(b[:kk])) / kk for a, b in zip(i, ei)]))
               for kk in (10, 100)}
        r = {"build_s": build_s, "q_per_s": len(q) / dt, "recall_at_10": rec[10],
             "recall_at_100": rec[100]}
        if expect:  # this search's own window, inside the phase's
            win = {kk: v - before[kk] for kk, v in kernels.launch_counts().items()}
            r["launches"] = win
            if win[expect] <= 0:
                raise AssertionError(f"{expect} was not launched by {name}")
        log(f"[ann] {name}: {json.dumps(r)}")
        rows[name] = r
        results[name] = (s, i)
        return s, i

    measure("exact_k100", exact_s, lambda: exact.query(q, k=100))
    t1 = time.perf_counter()
    ivf = port.IVFIndex.build(g, device=dev)
    ivf_s = time.perf_counter() - t1
    C = ivf.centroids.shape[0]
    log(f"[ann{suffix}] IVFIndex: C={C}, L={ivf.partitions.shape[1]}, "
        f"pad ratio {ivf.pad_ratio:.3f}")
    for nprobe in (C // 8, C):
        measure(f"ivf_nprobe{nprobe}", ivf_s, lambda p=nprobe: ivf.search(q, k=100, nprobe=p))
    # full probe is exact search wherever the exact scores are separated
    if not _agree_where_separated(*results[f"ivf_nprobe{C}{suffix}"], es, ei):
        raise AssertionError("IVF at nprobe = C is not exact search")

    # (name, card index, its copy on the CPU, search arguments)
    cross = []
    t1 = time.perf_counter()
    pq = port.PQIndex.build(g, m=m, device=dev)
    pq_s = time.perf_counter() - t1
    measure(f"pq_m{m}_adc", pq_s, lambda: pq.search(q, k=100), expect="adc_scores")
    measure(f"pq_m{m}_refine400", pq_s, lambda: pq.search(q, k=100, refine=400, gallery=gd),
            expect="adc_scores")
    cross += [(f"pq_m{m}_adc", pq, {}), (f"pq_m{m}_refine400", pq, {"refine": 400})]
    opq = None
    if with_opq:
        t1 = time.perf_counter()
        opq = port.PQIndex.build(g, m=m, opq_iters=2, device=dev)  # opq_iters cut to 2 for time
        opq_s = time.perf_counter() - t1
        measure(f"opq2_m{m}_adc", opq_s, lambda: opq.search(q, k=100), expect="adc_scores")
        measure(f"opq2_m{m}_refine400", opq_s,
                lambda: opq.search(q, k=100, refine=400, gallery=gd), expect="adc_scores")
        cross += [(f"opq2_m{m}_adc", opq, {})]
    t1 = time.perf_counter()
    ivfpq = port.IVFPQIndex.from_ivf(ivf, m=m, device=dev)
    ivfpq_s = ivf_s + time.perf_counter() - t1
    name = f"ivfpq_m{m}_nprobe{C // 4}_refine400"
    measure(name, ivfpq_s, lambda: ivfpq.search(q, k=100, nprobe=C // 4, refine=400, gallery=gd))
    cross += [(name, ivfpq, {"nprobe": C // 4, "refine": 400, "chunk": 8})]
    if rows[f"pq_m{m}_refine400{suffix}"]["recall_at_10"] < rows[f"pq_m{m}_adc{suffix}"][
            "recall_at_10"]:
        raise AssertionError("refine lowered PQ recall")

    # the card's results against the same indexes searched on the CPU (the
    # plain versions: no launch), first 32 queries
    nc = 32
    for name, index, kw in cross:
        if isinstance(index, port.PQIndex):
            cpu = port.PQIndex(index.codebooks, index.codes, index.n, rotation=index.rotation,
                               device="cpu")
        else:
            cpu = port.IVFPQIndex(index.centroids, index.codes, index.lengths, index.row_ids,
                                  index.codebooks, index.n, rotation=index.rotation, device="cpu")
        if "refine" in kw:
            kw = dict(kw, gallery=g)
        t1 = time.perf_counter()
        cs, ci = cpu.search(q[:nc], k=100, **kw)
        s, i = results[name + suffix]
        ok = _agree_where_separated(s[:nc], i[:nc], cs, ci)
        log(f"[ann{suffix}] {name} card vs CPU, {nc} queries: max|score diff| "
            f"{np.abs(s[:nc] - cs).max():.3e}, indices equal {np.array_equal(i[:nc], ci)} "
            f"({time.perf_counter() - t1:.1f} s on the CPU)")
        if not ok:
            raise AssertionError(f"{name}{suffix} on the card disagrees with the CPU search")
    if keep is not None:
        keep.update(g=g, q=q, ivf=ivf, pq=pq)
    del ivf, pq, opq, ivfpq, exact, gd, cross
    torch.cuda.empty_cache()
    return C


def fused_trunk_phase(dev, db_unfused, unfused):
    """Path B: graded config 2 with fuse_blocks=True, descriptors, self top-1
    (checked 1.0 on both paths) and mAP held against the unfused config-2
    run on the same weights (``unfused`` is its measurements)."""
    import numpy as np

    launches, main, (db, _) = main_path_phase(
        dev, 2, ("bottleneck_fused", "gem_l2n_fused_rect", "gem_l2n_fused", "fused_topk_search"),
        fuse_blocks=True)
    # 12 stride-1 blocks in resnet50, once per batch and scale; the gem head
    # runs once per batch and scale too
    want = 12 * (launches["gem_l2n_fused_rect"] + launches["gem_l2n_fused"])
    if launches["bottleneck_fused"] != want:
        raise AssertionError(f"bottleneck_fused launched {launches['bottleneck_fused']} "
                             f"times, want {want}")
    d_err = float(np.abs(db - db_unfused).max())
    log(f"[config 2 fused trunk] vs unfused config 2, same weights: max|descriptor err| "
        f"{d_err:.3e}")
    if d_err > HEAD_TOL:
        raise AssertionError("fused-trunk descriptors disagree with the unfused run")
    if main["map"] != unfused["map"]:
        raise AssertionError(f"fused-trunk mAP {main['map']} != unfused {unfused['map']}")
    pf, pu = main["profile"], unfused["profile"]
    log(f"[config 2 fused trunk] vs unfused: warm {main['extract_warm_img_per_s']:.2f} / "
        f"{unfused['extract_warm_img_per_s']:.2f} img/s, cold {main['extract_img_per_s']:.2f} / "
        f"{unfused['extract_img_per_s']:.2f}, busy {pf['busy_ms']:.1f} / {pu['busy_ms']:.1f} ms, "
        f"idle share {pf['idle_share']:.4f} / {pu['idle_share']:.4f}, mAP {main['map']:.4f} "
        f"(equal), self top-1 1.000 (both)")
    main["vs_unfused_err"] = d_err
    return launches, main


BF16_BYTES = 2
RANK_TIE_TOL = 1e-6  # scores this close may order differently in two GEMM shapes


def _bf16_row(name, ms, plain_ms, byts, flops, library_ms, err, shape):
    """A bf16 timing at path C's own shape: bound from the bf16 bytes (HBM)
    and the flop at the f32 FMA rate, as the f32 rows count them."""
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    r = {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms,
         "max_abs_err": err}
    log(json.dumps({"kernel_timing_bf16": dict(r, name=name)}))
    return r


def _check_kernels_bf16(dev, ex, images, q_pixels, gallery, q_store):
    """The four bf16 kernels of path C against their plain versions at the
    path's own shapes (outside its counting window), and timed there."""
    import numpy as np
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
        feature_mask,
        rect_sizes,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        fused_topk_plain,
        fused_topk_search,
        gem_l2n_fused,
        gem_l2n_fused_rect,
        gem_l2n_plain,
        scores_blockmax,
        scores_blockmax_plain,
    )

    out = {}
    p = ex.model.pool.p
    batch = next(iter(ex.make_input_batches(images)))
    px = torch.from_numpy(batch.pixels_u8).to(dev)
    sz = torch.from_numpy(batch.sizes).to(dev)
    with torch.no_grad():
        B, H, W, _ = px.shape
        row = torch.arange(H, device=dev)[None, :, None]
        col = torch.arange(W, device=dev)[None, None, :]
        mask = (row < sz[:, 0, None, None]) & (col < sz[:, 1, None, None])
        x = (px.to(ex._nrm_a.dtype) * ex._nrm_a + ex._nrm_b) * mask[..., None]
        feats = ex.model.trunk_nhwc(x)
        sizes = rect_sizes(feature_mask(mask, x.shape[1:3], feats.shape[1:3]))
        qfeats = ex.model.trunk_nhwc(torch.from_numpy(q_pixels).to(dev))
    if feats.dtype != torch.bfloat16 or qfeats.dtype != torch.bfloat16:
        raise AssertionError("config 5's trunk did not give a bf16 feature map")
    del x, px
    Bf, Hf, Wf, C = feats.shape
    valid = int((sizes[:, 0] * sizes[:, 1]).sum())
    e = (gem_l2n_fused_rect(feats, p, sizes) - gem_l2n_plain(feats, p, sizes)).abs().max().item()
    out["gem_l2n_fused_rect"] = _bf16_row(
        "gem_l2n_fused_rect", time_ms(lambda: gem_l2n_fused_rect(feats, p, sizes)),
        time_ms(lambda: gem_l2n_plain(feats, p, sizes)),
        valid * C * BF16_BYTES + Bf * C * 4 + Bf * 8 + 4, 4 * valid * C, None, e,
        f"[{Bf}, {Hf}x{Wf}, {C}] bf16, {valid} of {Bf * Hf * Wf} valid")
    Bq, Hq, Wq, _ = qfeats.shape
    e = (gem_l2n_fused(qfeats, p) - gem_l2n_plain(qfeats, p)).abs().max().item()
    out["gem_l2n_fused"] = _bf16_row(
        "gem_l2n_fused", time_ms(lambda: gem_l2n_fused(qfeats, p)),
        time_ms(lambda: gem_l2n_plain(qfeats, p)),
        qfeats.numel() * BF16_BYTES + Bq * C * 4 + 4, 4 * qfeats.numel(), None, e,
        f"[{Bq}, {Hq}x{Wq}, {C}] bf16")
    for name, e in (("gem_l2n_fused_rect", out["gem_l2n_fused_rect"]["max_abs_err"]),
                    ("gem_l2n_fused", out["gem_l2n_fused"]["max_abs_err"])):
        if not e <= GEM_TOL:
            raise AssertionError(f"{name} bf16 disagrees with its plain version on path C")
    del feats, qfeats

    Ng, D = gallery.shape
    q = q_store.float()
    Nq = q.shape[0]
    s, bmax = scores_blockmax(gallery, q)
    ps, _ = scores_blockmax_plain(gallery, q)
    e_sb = (s[:, :Ng] - ps[:, :Ng]).abs().max().item()
    if e_sb > TOPK_TOL or not torch.equal(bmax, s.view(Nq, -1, 64).amax(-1)):
        raise AssertionError("scores_blockmax bf16 disagrees with its plain version on path C")
    del s, ps, bmax
    ng_pad = -(-Ng // 64) * 64
    out["scores_blockmax"] = _bf16_row(
        "scores_blockmax", time_ms(lambda: scores_blockmax(gallery, q), reps=10),
        time_ms(lambda: scores_blockmax_plain(gallery, q), reps=5),
        Ng * D * BF16_BYTES + Nq * D * 4 + Nq * ng_pad * 4 + Nq * (ng_pad // 64) * 4,
        2 * Nq * Ng * D, time_ms(lambda: q_store @ gallery.T, reps=10), e_sb,
        f"{Nq} x {Ng} x {D} bf16 (library: q @ g.T in bf16, bf16 out)")
    torch.cuda.empty_cache()
    errs = []
    for k in (20, 100):
        fs, fi = fused_topk_search(gallery, q, k)
        ps, pi = fused_topk_plain(gallery, q, k)
        ok, e = _check_search_case(fs, fi, ps, pi)
        if not ok:
            raise AssertionError(f"fused_topk bf16 k={k} disagrees with its plain version on "
                                 f"path C")
        errs.append(e)
        del fs, fi, ps, pi
        torch.cuda.empty_cache()
    out["fused_topk_search"] = _bf16_row(
        "fused_topk_search", time_ms(lambda: fused_topk_search(gallery, q, 20), reps=10),
        time_ms(lambda: fused_topk_plain(gallery, q, 20), reps=3),
        Ng * D * BF16_BYTES + Nq * D * 4 + Nq * 20 * 8, 2 * Nq * Ng * D,
        time_ms(lambda: torch.topk(q_store @ gallery.T, 20, dim=1), reps=10), max(errs),
        f"{Nq} x {Ng} x {D} bf16, k=20 (checked at k=20 and 100; library: "
        f"torch.topk(q @ g.T) in bf16)")
    torch.cuda.empty_cache()
    return out


def _timed_twice(fn):
    """``fn()``'s result and the wall time of two calls in seconds (the first
    also pays the allocator's first use), the card synchronized around each."""
    import torch

    t = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    return r, t


def _dense_candidate_ranks(scores, cand, tol=RANK_TIE_TOL):
    """Each candidate's position in a dense stable descending sort of all
    [Nq, Ng] ``scores``, and how many other rows score within ``tol`` of it."""
    import torch

    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    pos = torch.empty_like(order)
    pos.scatter_(1, order, torch.arange(order.shape[1], device=order.device)
                 .expand_as(order).contiguous())
    dense = torch.gather(pos, 1, cand)
    s_c = torch.gather(scores, 1, cand)
    near = torch.stack([((scores - s_c[:, j : j + 1]).abs() <= tol).sum(1) - 1
                        for j in range(cand.shape[1])], 1)
    return dense, near


def config5_phase(dev):
    """Path C: graded config 5 (aachen-1m-pod) through its entry points at
    full width: config 5's Extractor on the corpus, run_gallery_scale at
    1,000,000 rows with its artifacts in a temporary directory, and
    localize_shortlist(k=20) on the reloaded artifact, in one counting
    window; then the checks that need more launches."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    import image_retrieval_for_image_based_localization_tpu_torch as port
    from image_retrieval_for_image_based_localization_tpu_torch.benchmarks import (
        GALLERY_SCALE,
        run_gallery_scale,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.data.images import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (
        candidate_matrix,
        compute_map_streaming_and_print,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.localization import (
        localize_shortlist,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
        rank_candidates,
        rank_candidates_core,
        score_matrix,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
        GRADED_CONFIGS,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import (
        MetricsLogger,
    )

    images, labels, q_u8 = make_corpus()
    graded = GRADED_CONFIGS[5]
    cfg = dataclasses.replace(graded.extract, batch_size=16)
    mc = cfg.model
    q_pixels = ((q_u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(
        np.float32)
    gnd = [{"ok": np.flatnonzero(labels == s)} for s in range(len(q_u8))]
    qnames = [f"query{i}.jpg" for i in range(len(q_u8))]
    dbnames = [f"db{i}.jpg" for i in range(len(images))]
    n_rows = GALLERY_SCALE[5]
    log(f"[config 5] {graded.name}: {mc.arch} {mc.pooling} {mc.dtype}, fused head "
        f"{mc.use_pallas}, {cfg.image_size} px, batch {cfg.batch_size}, index {graded.index}, "
        f"{len(images)} db images + {n_rows - len(images):,} distractors = {n_rows:,} rows, "
        f"{len(q_u8)} queries, k=100")
    out = {}
    with tempfile.TemporaryDirectory(prefix="config5_") as tmp:
        need = n_rows * 2048 * 2
        free = shutil.disk_usage(tmp).free
        log(f"[config 5] artifact directory {tmp}: {free / 1e9:.1f} GB free, the sidecar "
            f"needs {need / 1e9:.2f} GB")
        if free < need * 1.1:
            raise RuntimeError("not enough disk for config 5's index artifact")
        ex = port.Extractor(cfg, seed=0, device=dev)
        logger = MetricsLogger(path=os.path.join(tmp, "config5.jsonl"), echo=True)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        db = ex.extract(images)                   # bucketed: masked head kernel
        torch.cuda.synchronize()
        t_extract = time.perf_counter() - t0
        qd = ex(q_pixels)                         # whole images: unmasked head kernel
        t0 = time.perf_counter()
        res = run_gallery_scale(5, db, qd, gnd, logger=logger, out_dir=tmp, device=dev,
                                query_names=qnames, db_names=dbnames)
        torch.cuda.synchronize()
        t_gallery = time.perf_counter() - t0
        pairs, _ = localize_shortlist(res["artifact"], qd, qnames,
                                      dbnames + [f"distractor{i}"
                                                 for i in range(n_rows - len(images))], k=20)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        log(f"[config 5] launches {launches}")
        for name in ("gem_l2n_fused_rect", "gem_l2n_fused", "scores_blockmax",
                     "fused_topk_search"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the config 5 path")
        recs = [json.loads(line) for line in open(os.path.join(tmp, "config5.jsonl"))]
        timed = next(r for r in recs if "queries_per_sec" in r)
        art = next(r for r in recs if r.get("event") == "index_artifact")

        idx = res["indices"]
        if db.shape != (len(images), ex.out_dim) or not np.isfinite(db).all():
            raise AssertionError("config 5 descriptors are not finite [N, 2048]")
        if max(np.abs(np.linalg.norm(d, axis=1) - 1).max() for d in (db, qd)) > 1e-4:
            raise AssertionError("config 5 descriptors are not unit-norm")
        if idx.shape != (len(q_u8), 100) or res["gallery"].shape[0] != n_rows:
            raise AssertionError("config 5's search has the wrong shape")
        if not res["top1_in_core"] > 0.8:
            raise AssertionError(f"top1_in_core {res['top1_in_core']}: core matches must "
                                 f"beat random distractors")
        top1_pairs = [pairs[i * 20][1] for i in range(len(q_u8))]
        same_top1 = sum(top1_pairs[i] == (dbnames[idx[i, 0]] if idx[i, 0] < len(images)
                                          else f"distractor{idx[i, 0] - len(images)}")
                        for i in range(len(q_u8)))
        if same_top1 != len(q_u8):
            raise AssertionError("localize_shortlist on the reloaded artifact disagrees with "
                                 "the timed search's top-1")
        log(f"[config 5] extraction {len(images) / t_extract:.2f} img/s ({t_extract:.2f} s), "
            f"gallery run {t_gallery:.1f} s; knn_search k=100 over {n_rows:,} x "
            f"{res['gallery'].shape[1]} bf16, {len(qd)} queries: "
            f"{timed['queries_per_sec']:.1f} q/s, p50 {timed['lat_p50_s'] * 1e3:.3f} ms, "
            f"p99 {timed['lat_p99_s'] * 1e3:.3f} ms; recall {res['recall']['recall']}; "
            f"top1_in_core {res['top1_in_core']:.3f}; artifact {art['gallery_sidecar_bytes']:,} "
            f"bytes, save {art['save_s']:.2f} s, reload + upload {art['reload_s']:.2f} s; "
            f"localize_shortlist top-1 equal to the timed search on {same_top1} of "
            f"{len(q_u8)}")
        out.update(extract_img_per_s=len(images) / t_extract, gallery_rows=n_rows,
                   knn_q_per_s=timed["queries_per_sec"], knn_p50_ms=timed["lat_p50_s"] * 1e3,
                   knn_p95_ms=timed["lat_p95_s"] * 1e3, knn_p99_ms=timed["lat_p99_s"] * 1e3,
                   recall={str(k): v for k, v in res["recall"]["recall"].items()},
                   top1_in_core=res["top1_in_core"], sidecar_bytes=art["gallery_sidecar_bytes"],
                   save_s=art["save_s"], reload_s=art["reload_s"],
                   gallery_run_s=t_gallery)
        del res["artifact"], pairs

    gallery, q_store = res["gallery"], res["queries"]
    # streaming candidate ranks against a dense ranking on the card (cuBLAS
    # in one product); beside them the time of the route sharded ranks take
    # (kernel B3 per chunk, stable=True) on the same inputs
    cand = torch.from_numpy(candidate_matrix(gnd)).to(dev, torch.int64)

    streamed, t_rank = _timed_twice(lambda: rank_candidates(gallery, q_store.float(), cand))
    streamed_b3, t_rank_b3 = _timed_twice(
        lambda: rank_candidates_core(gallery, q_store.float(), cand, stable=True))
    dense, near = _dense_candidate_ranks(score_matrix(gallery, q_store.float()), cand)
    diff = (streamed.long() - dense).abs()
    n_near = int((near > 0).sum())
    n_moved = int((diff > 0).sum())
    if bool((diff > near).any()):
        raise AssertionError("rank_candidates differs from the dense ranking beyond near ties")
    map_s = compute_map_streaming_and_print("config5 streamed", streamed.cpu().numpy(), gnd)
    map_d = compute_map_streaming_and_print("config5 dense", dense.cpu().numpy(), gnd)
    log(f"[config 5] rank_candidates {tuple(cand.shape)} candidates over {n_rows:,} rows: "
        f"{t_rank[0] * 1e3:.1f} ms first call, {t_rank[1] * 1e3:.1f} ms second (the B3 route "
        f"of sharded ranks: {t_rank_b3[0] * 1e3:.1f} / {t_rank_b3[1] * 1e3:.1f} ms, ranks "
        f"differing from cuBLAS's {int((streamed_b3 != streamed).sum())}); against the dense "
        f"ranking on the card: {n_moved} ranks differ, {n_near} candidates have another "
        f"score within {RANK_TIE_TOL}; mAP {map_s['map']:.6f} streamed, {map_d['map']:.6f} dense")
    if map_s["map"] != map_d["map"]:
        raise AssertionError("streamed mAP differs from the dense ranking's")
    out.update(rank_candidates_ms=t_rank[0] * 1e3, rank_candidates_warm_ms=t_rank[1] * 1e3,
               rank_candidates_b3_ms=t_rank_b3[0] * 1e3,
               rank_candidates_b3_warm_ms=t_rank_b3[1] * 1e3,
               rank_differ=n_moved, rank_near_ties=n_near,
               map=map_s["map"])
    del streamed, streamed_b3, dense, near, cand
    torch.cuda.empty_cache()

    # the four bf16 kernels at this path's shapes
    out["bf16_kernels"] = _check_kernels_bf16(dev, ex, images, q_pixels, gallery, q_store)
    del gallery, q_store, res
    torch.cuda.empty_cache()

    # warm extraction, its profile, and bf16 against f32 on the same weights
    t0 = time.perf_counter()
    db_warm = ex.extract(images)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    prof = profile_window(lambda: ex.extract(images))
    log(f"[config 5] warm extraction {len(images) / t_warm:.2f} img/s ({t_warm:.2f} s), "
        f"max|diff| to the first run {np.abs(db_warm - db).max():.3e}; profiled: "
        f"{json.dumps(prof)}")
    ex32 = port.Extractor(dataclasses.replace(cfg, model=dataclasses.replace(
        mc, dtype="float32")), state_dict=ex.model.state_dict(), device=dev)
    sub = images[:16]
    d16, d32 = ex.extract(sub), ex32.extract(sub)
    cos = (d16 * d32).sum(1) / np.linalg.norm(d16, axis=1) / np.linalg.norm(d32, axis=1)
    log(f"[config 5] bf16 vs f32 descriptors, same weights, 16 images: max|diff| "
        f"{np.abs(d16 - d32).max():.3e}, min cosine {cos.min():.6f}")
    if not (np.isfinite(d16).all() and cos.min() > 0.9):
        raise AssertionError("bf16 descriptors stray from the f32 run of the same weights")
    out.update(extract_warm_img_per_s=len(images) / t_warm, profile=prof,
               bf16_vs_f32_max_abs_diff=float(np.abs(d16 - d32).max()),
               bf16_vs_f32_min_cos=float(cos.min()))
    del ex, ex32
    torch.cuda.empty_cache()
    log(json.dumps({"config5": out}))
    return launches, out, (db, qd, gnd), q_u8


# resnet101's stride-1 identity blocks: layers 1-4 hold 2, 3, 22 and 2
R101_STRIDE1_BLOCKS = 29
BF16_DESC_MAX_DIFF = 1e-2   # bf16 descriptors against another rounding of the same model
BF16_DESC_MIN_COS = 0.999


def _desc_gap(a, b):
    """max|a - b| and the least row cosine of two descriptor sets."""
    import numpy as np

    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    return float(np.abs(a - b).max()), float(cos.min())


def _moved_ranks(ranks_a, ranks_b, scores_b, gnd):
    """Where two rankings [N, Nq] put a query's positives at other places:
    for each such positive, its place in each and, in ranking b, the score
    gap to the row that holds its place from ranking a."""
    import numpy as np

    moved = []
    for q, g in enumerate(gnd):
        pos_a = {int(r): int(np.flatnonzero(ranks_a[:, q] == r)[0]) for r in g["ok"]}
        pos_b = {int(r): int(np.flatnonzero(ranks_b[:, q] == r)[0]) for r in g["ok"]}
        for r in g["ok"]:
            r = int(r)
            if pos_a[r] != pos_b[r]:
                other = int(ranks_b[pos_a[r], q])
                moved.append({"query": q, "row": r, "place_a": pos_a[r], "place_b": pos_b[r],
                              "holder_b": other,
                              "score_gap_b": float(scores_b[q, r] - scores_b[q, other])})
    return moved


def config5_fused_phase(dev, c5_desc, c5_main):
    """Path I: graded config 5 (resnet101 bf16, GeM kernel head, 1024 px)
    with fuse_blocks=True on path C's corpus, queries and weights (seed 0):
    extract_features -> build_index(pca) -> Index.query(k=10) -> mAP, in one
    counting window. The 29 stride-1 blocks of every batch go through the
    bf16 bottleneck kernel. Descriptors are held against path C's unfused
    bf16 ones; mAP is set beside path C's on the same 100-row index."""
    import dataclasses

    import numpy as np
    import torch
    import image_retrieval_for_image_based_localization_tpu_torch as port
    from image_retrieval_for_image_based_localization_tpu_torch.data.images import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (
        compute_map,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
        GRADED_CONFIGS,
    )

    db_c, qd_c, gnd = c5_desc
    images, _, q_u8 = make_corpus()
    q_pixels = ((q_u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(
        np.float32)
    graded = GRADED_CONFIGS[5]
    cfg = dataclasses.replace(graded.extract, batch_size=16, fuse_blocks=True)
    mc = cfg.model
    log(f"[config 5 fused trunk] {graded.name}: {mc.arch} {mc.pooling} {mc.dtype}, fused head "
        f"{mc.use_pallas}, fuse_blocks {cfg.fuse_blocks}, {cfg.image_size} px, batch "
        f"{cfg.batch_size}, index {graded.index}, {len(images)} db images, {len(q_u8)} queries")
    ex = port.Extractor(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    db = ex.extract(images)                       # bucketed: masked head kernel
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    qd = ex(q_pixels)                             # whole images: unmasked head kernel
    index = port.build_index(db, graded.index, device=dev)
    _, idx = index.query(qd, k=10)                # fused top-k kernel
    _, self_idx = index.query(db, k=10)
    ranks = index.ranks(qd)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"[config 5 fused trunk] launches {launches}")

    heads = launches["gem_l2n_fused_rect"] + launches["gem_l2n_fused"]
    want = R101_STRIDE1_BLOCKS * heads
    if heads <= 0 or launches["fused_topk_search"] <= 0:
        raise AssertionError("path I did not launch the GeM head or the top-k kernel")
    if launches["bottleneck_fused_bf16"] != want or launches["bottleneck_fused"] != 0:
        raise AssertionError(f"bottleneck_fused_bf16 launched "
                             f"{launches['bottleneck_fused_bf16']} times (the f32 form "
                             f"{launches['bottleneck_fused']}), want {want} bf16 and no f32: "
                             f"{R101_STRIDE1_BLOCKS} blocks x {heads} head launches")
    if db.shape != db_c.shape or not np.isfinite(db).all() or not np.isfinite(qd).all():
        raise AssertionError("path I descriptors are not finite or not path C's shape")
    self_top1 = float(np.mean(self_idx[:, 0] == np.arange(len(db))))
    if self_top1 != 1.0:
        raise AssertionError(f"path I self-retrieval top-1 is {self_top1}, want 1.0")
    d_db, cos_db = _desc_gap(db, db_c)
    d_q, cos_q = _desc_gap(qd, qd_c)
    log(f"[config 5 fused trunk] vs path C's unfused bf16 descriptors, same weights: db "
        f"max|diff| {d_db:.3e} min cosine {cos_db:.6f}; queries {d_q:.3e} / {cos_q:.6f} "
        f"(gates {BF16_DESC_MAX_DIFF}, {BF16_DESC_MIN_COS})")
    if max(d_db, d_q) > BF16_DESC_MAX_DIFF or min(cos_db, cos_q) < BF16_DESC_MIN_COS:
        raise AssertionError("path I descriptors stray from path C's")

    gnd_map = compute_map(ranks, gnd)[0]
    index_c = port.build_index(db_c, graded.index, device=dev)
    ranks_c = index_c.ranks(qd_c)
    map_c = compute_map(ranks_c, gnd)[0]
    scores = (index.transform_queries(qd) @ index.device_gallery().float().T).cpu().numpy()
    moved = _moved_ranks(ranks_c, ranks, scores, gnd)
    log(f"[config 5 fused trunk] mAP {gnd_map:.4f} against path C's {map_c:.4f} on the same "
        f"100-row PCA index; self top-1 {self_top1:.3f}; {len(moved)} positives at another "
        f"place: {json.dumps(moved[:20])}")
    # the kernel's share of that move, apart from each path learning its own
    # PCA on its 100 rows (ROADMAP C10): path I's descriptors on path C's
    # learned PCA, and both paths before whitening (a log line, not a gate)
    on_c = port.build_index(db, graded.index, whitening_mP=(index_c.m, index_c.P), device=dev)
    map_on_c = compute_map(on_c.ranks(qd), gnd)[0]
    raw = dataclasses.replace(graded.index, whitening=None)
    map_raw = compute_map(port.build_index(db, raw, device=dev).ranks(qd), gnd)[0]
    map_raw_c = compute_map(port.build_index(db_c, raw, device=dev).ranks(qd_c), gnd)[0]
    log(f"[config 5 fused trunk] mAP on path C's learned PCA {map_on_c:.4f} (path C "
        f"{map_c:.4f}); before whitening {map_raw:.4f} (path C {map_raw_c:.4f})")
    del on_c

    t0 = time.perf_counter()
    db_warm = ex.extract(images)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    prof = profile_window(lambda: ex.extract(images))
    blocks = _check_path_blocks([lambda: ex.extract(images), lambda: ex(q_pixels)])
    groups = prof["device_ms_by_group"]
    busy = prof["busy_ms"]
    split = {k: (v, v / busy) for k, v in sorted(groups.items())}
    log(f"[config 5 fused trunk] extraction cold {len(images) / t_extract:.2f} img/s "
        f"({t_extract:.2f} s), warm {len(images) / t_warm:.2f} img/s (max|diff| to cold "
        f"{np.abs(db_warm - db).max():.3e}); path C in this run: cold "
        f"{c5_main['extract_img_per_s']:.2f}, warm {c5_main['extract_warm_img_per_s']:.2f} "
        f"img/s; idle share {prof['idle_share']:.4f} (path C "
        f"{c5_main['profile']['idle_share']:.4f}), busy {busy:.1f} ms (path C "
        f"{c5_main['profile']['busy_ms']:.1f}); device ms and share of busy by group: "
        f"{json.dumps(split)}; path C's: {json.dumps(c5_main['profile']['device_ms_by_group'])}")
    del ex, index, index_c
    torch.cuda.empty_cache()
    out = {"extract_img_per_s": len(images) / t_extract,
           "extract_warm_img_per_s": len(images) / t_warm, "map": gnd_map,
           "map_path_c": map_c, "map_on_path_c_pca": map_on_c, "map_unwhitened": map_raw,
           "map_unwhitened_path_c": map_raw_c, "moved_positives": len(moved),
           "self_top1": self_top1,
           "vs_path_c_max_abs_diff": max(d_db, d_q), "vs_path_c_min_cos": min(cos_db, cos_q),
           "block_shapes_checked": len(blocks),
           "block_max_abs_err": max(e for e, _, _ in blocks.values()),
           "block_max_rel_err": max(r for _, r, _ in blocks.values()),
           "block_max_not_bit_equal_share": max(n for _, _, n in blocks.values()),
           "profile": prof}
    log(json.dumps({"config5_fused_trunk": out}))
    return launches, out


def _check_path_blocks(runs):
    """Hold the bf16 bottleneck kernel against its plain version at every
    block shape (B, H, W, Cin, Cm) that ``runs`` give it: each bucket, the
    whole-image queries and a short last batch. The fused trunk's kernel
    call is wrapped for the runs; the first call at each shape also runs
    the kernel a second time and the plain version, on the trunk's own
    inputs and packed weights, and is gated by _compare_bottleneck_bf16.
    These launches compare and are not counted by any path. Returns
    {shape: (max|err|, relative, share not bit-equal)}."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.models import fused_trunk
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        bottleneck_plain,
    )

    launch = fused_trunk.bottleneck_fused
    seen = {}

    def recording(x, w1, b1, w2, b2, w3, b3, packed=None):
        got = launch(x, w1, b1, w2, b2, w3, b3, packed=packed)
        key = (*x.shape, w1.shape[1])
        if key not in seen:
            if packed is None:
                raise AssertionError("the bf16 fused trunk gave the kernel no packed weights")
            again = launch(x, w1, b1, w2, b2, w3, b3, packed=packed)
            want = bottleneck_plain(x, w1, b1, w2, b2, w3, b3)
            plan = plan_summary(bf16_plan(key[:4], key[4]))
            seen[key] = _compare_bottleneck_bf16(
                f"path I block {list(key[:4])} Cm={key[4]} ({plan})", got, again, want)
        return got

    fused_trunk.bottleneck_fused = recording
    try:
        for run in runs:
            run()
    finally:
        fused_trunk.bottleneck_fused = launch
    torch.cuda.synchronize()
    log(f"[config 5 fused trunk] bf16 bottleneck against its plain version at the "
        f"{len(seen)} block shapes path I runs: {json.dumps([list(k) for k in seen])}")
    return seen


SHARDS = 4  # path E's row shards, all on the one card


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def config4_phase(dev, db, qd, gnd, ann):
    """Path E: graded config 4 (r101-gem-100k-sharded) through its entry
    points at full width, on path C's core and query descriptors (config
    4's trunk is config 5's: resnet101 bf16, GeM, 1024 px). An NCCL group
    of world size 1 and a mesh of 4 row shards on the card, so the merge and
    the collectives run there: run_gallery_scale(4) (the 100,000 x 2,048 f32
    gallery, the sharded top-100 timed p50/p95/p99 over 7 repetitions, the
    bitwise exactness probe), then ShardedIVF and ShardedPQ on path A's
    D=2048 corpus against IVFIndex.search and PQIndex.search, in one
    counting window; then candidate ranks against dense rankings: one
    device's (cuBLAS) against cuBLAS's dense ranking (equal except where
    another score lies within 1e-6; equal mAP), the sharded ones (kernel B3
    per shard) bit for bit against B3's dense ranking (equal mAP) and
    against cuBLAS's except where another score lies within twice the
    measured B3-vs-cuBLAS difference; and scores_blockmax and adc_scores at
    the path's shapes against their plain versions."""
    import datetime
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from image_retrieval_for_image_based_localization_tpu_torch.benchmarks import (
        GALLERY_SCALE,
        run_gallery_scale,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (
        candidate_matrix,
        compute_map_streaming_and_print,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        adc_scores,
        adc_scores_plain,
        scores_blockmax,
        scores_blockmax_plain,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.parallel import (
        ShardedIVF,
        create_mesh,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.parallel.sharded_pq import (
        ShardedPQ,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
        rank_candidates,
        rank_candidates_core,
        score_matrix,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import _build_luts
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
        GRADED_CONFIGS,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import (
        MetricsLogger,
    )

    graded = GRADED_CONFIGS[4]
    n_rows = GALLERY_SCALE[4]
    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = create_mesh(devices=[dev] * SHARDS)
        log(f"[config 4] {graded.name}: path C's {len(db)} core and {len(qd)} query "
            f"descriptors (resnet101 bf16, GeM, 1024 px) + {n_rows - len(db):,} distractors = "
            f"{n_rows:,} rows f32, index {graded.index}; {mesh}, backend "
            f"{dist.get_backend()}, k=100")
        with tempfile.TemporaryDirectory(prefix="config4_") as tmp:
            logger = MetricsLogger(path=os.path.join(tmp, "config4.jsonl"), echo=True)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = run_gallery_scale(4, db, qd, gnd, logger=logger, device=dev, mesh=mesh)
            torch.cuda.synchronize()
            t_gallery = time.perf_counter() - t0
            recs = [json.loads(line) for line in open(os.path.join(tmp, "config4.jsonl"))]
        timed = next(r for r in recs if "queries_per_sec" in r)
        probe = next(r for r in recs if r.get("event") == "exactness_probe")
        si, gallery, q = res["sharded"], res["gallery"], res["queries"]

        # ShardedIVF and ShardedPQ on path A's D=2048 corpus, 4 shards
        g_a, q_a, ivf, pq = ann["g"], ann["q"], ann["ivf"], ann["pq"]
        C = ivf.centroids.shape[0]
        sivf, spq = ShardedIVF(ivf, mesh=mesh), ShardedPQ(pq, mesh=mesh)
        ann_rows = {}

        def timed_pair(name, sharded, single, exact_scores):
            sharded()  # warm
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            s, i = sharded()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            s0, i0 = single()
            same = bool(np.array_equal(i, i0))
            if exact_scores:  # ADC: the kernel's bits on every shard
                same = same and bool(np.array_equal(s, s0))
            # IVF scores its probed rows with cuBLAS at another batch shape:
            # indices equal except where two scores tie within 1e-6
            ok = same or (not exact_scores and _agree_where_separated(
                s, i, s0, i0, tol=RANK_TIE_TOL, score_tol=TOPK_TOL))
            ann_rows[name] = {"q_per_s": len(q_a) / dt, "equal_to_single_device": same,
                              "places_differing": int((i != i0).sum())}
            log(f"[config 4] {name} over {SHARDS} shards: {json.dumps(ann_rows[name])}")
            if not ok:
                raise AssertionError(f"sharded {name} disagrees with the single-device index")

        for nprobe in (C // 8, C):
            timed_pair(f"ivf_nprobe{nprobe}", lambda p=nprobe: sivf.search(q_a, k=100, nprobe=p),
                       lambda p=nprobe: ivf.search(q_a, k=100, nprobe=p), False)
        timed_pair("pq_m64_adc", lambda: spq.search(q_a, k=100), lambda: pq.search(q_a, k=100),
                   True)
        timed_pair("pq_m64_refine400", lambda: spq.search(q_a, k=100, refine=400, gallery=g_a),
                   lambda: pq.search(q_a, k=100, refine=400, gallery=g_a), False)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        log(f"[config 4] launches {launches}")
        for name in ("scores_blockmax", "adc_scores"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the config 4 path")

        idx = res["indices"]
        if idx.shape != (len(qd), 100) or gallery.shape[0] != n_rows:
            raise AssertionError("config 4's search has the wrong shape")
        if not (probe["sharded_equals_single_device"] and res["exact_match"]):
            raise AssertionError("config 4's exactness probe failed")
        if not res["top1_in_core"] > 0.8:
            raise AssertionError(f"top1_in_core {res['top1_in_core']}: core matches must "
                                 f"beat random distractors")
        log(f"[config 4] gallery run {t_gallery:.1f} s; sharded knn k=100 over {n_rows:,} x "
            f"2048 f32 in {SHARDS} shards, {len(qd)} queries: "
            f"{timed['queries_per_sec']:.1f} q/s, p50 {timed['lat_p50_s'] * 1e3:.3f} ms, "
            f"p95 {timed['lat_p95_s'] * 1e3:.3f} ms, p99 {timed['lat_p99_s'] * 1e3:.3f} ms; "
            f"exactness probe bitwise {probe['sharded_equals_single_device']}; top1_in_core "
            f"{res['top1_in_core']:.3f}")
        out.update(gallery_rows=n_rows, shards=SHARDS, gallery_run_s=t_gallery,
                   knn_q_per_s=timed["queries_per_sec"], knn_p50_ms=timed["lat_p50_s"] * 1e3,
                   knn_p95_ms=timed["lat_p95_s"] * 1e3, knn_p99_ms=timed["lat_p99_s"] * 1e3,
                   exactness_probe=probe["sharded_equals_single_device"],
                   top1_in_core=res["top1_in_core"], sharded_ann=ann_rows)

        # sharded candidate ranks against one device's and a dense ranking
        q_np = q.cpu().numpy()
        cand_np = candidate_matrix(gnd)
        cand = torch.from_numpy(cand_np).to(dev, torch.int64)
        sharded, t_rank = _timed_twice(lambda: torch.from_numpy(
            si.rank_candidates(q_np, cand_np, pre_transformed=True)).to(dev))
        # one device's ranks, by its route (cuBLAS) and by the sharded one's (B3)
        single, t_single = _timed_twice(lambda: rank_candidates(gallery, q, cand))
        single_b3, t_single_b3 = _timed_twice(
            lambda: rank_candidates_core(gallery, q, cand, stable=True))
        # the references: dense stable sorts of all [20, 100k] scores, made
        # by cuBLAS in one product (the scorer of one device's ranks, at
        # another shape) and by kernel B3 in one launch (the scorer of
        # sharded ranks, whose bits hold at any shape). B3 and cuBLAS sum
        # in other orders, so across the two scorers ranks agree except
        # where another score lies within twice their measured difference
        s_cublas = score_matrix(gallery, q)
        s_b3 = scores_blockmax(gallery, q)[0][:, : gallery.shape[0]]
        noise = (s_b3 - s_cublas).abs().max().item()
        band = max(RANK_TIE_TOL, 2 * noise)
        dense, near = _dense_candidate_ranks(s_cublas, cand)
        dense_b3, _ = _dense_candidate_ranks(s_b3, cand)
        _, near_band = _dense_candidate_ranks(s_cublas, cand, tol=band)
        del s_cublas, s_b3
        n_moved = {}
        for name, r, ref, tie in (("single_vs_cublas", single, dense, near),
                                  ("sharded_vs_single_b3", sharded, single_b3.long(), None),
                                  ("sharded_vs_b3", sharded, dense_b3, None),
                                  ("sharded_vs_cublas", sharded, dense, near_band)):
            diff = (r.long() - ref).abs()
            n_moved[name] = int((diff > 0).sum())
            if (n_moved[name] > 0) if tie is None else bool((diff > tie).any()):
                raise AssertionError(f"rank_candidates {name}: ranks differ"
                                     f"{'' if tie is None else ' beyond near ties'}")
        maps = {name: compute_map_streaming_and_print(f"config4 {name}", r.cpu().numpy(), gnd)
                ["map"] for name, r in (("sharded", sharded), ("single", single),
                                        ("dense_cublas", dense), ("dense_b3", dense_b3))}
        log(f"[config 4] sharded rank_candidates {tuple(cand.shape)} over {n_rows:,} rows in "
            f"{SHARDS} shards: {t_rank[0] * 1e3:.1f} / {t_rank[1] * 1e3:.1f} ms (one device: "
            f"cuBLAS {t_single[0] * 1e3:.1f} / {t_single[1] * 1e3:.1f} ms, B3 "
            f"{t_single_b3[0] * 1e3:.1f} / {t_single_b3[1] * 1e3:.1f} ms); ranks differing "
            f"{n_moved}; "
            f"{int((near > 0).sum())} candidates have another score within {RANK_TIE_TOL}, "
            f"{int((near_band > 0).sum())} within {band:.3e} (B3 vs cuBLAS max|diff| "
            f"{noise:.3e}); mAP {maps}")
        if maps["single"] != maps["dense_cublas"] or maps["sharded"] != maps["dense_b3"]:
            raise AssertionError("candidate-rank mAP differs from its dense ranking's")
        out.update(rank_candidates_ms=t_rank[0] * 1e3, rank_candidates_warm_ms=t_rank[1] * 1e3,
                   single_rank_candidates_warm_ms=t_single[1] * 1e3,
                   single_rank_candidates_b3_warm_ms=t_single_b3[1] * 1e3, rank_differ=n_moved,
                   rank_score_diff_b3_cublas=noise, rank_tie_band=band, map=maps)
    finally:
        dist.destroy_process_group()

    # the kernels at this path's shapes: a shard of the gallery, a shard of the codes
    shard = si.shards[0]
    s, _ = scores_blockmax(shard, q)
    ps, _ = scores_blockmax_plain(shard, q)
    e_sb = (s[:, : shard.shape[0]] - ps[:, : shard.shape[0]]).abs().max().item()
    lut = _build_luts(spq.codebooks[0], torch.from_numpy(q_a).to(dev))
    a, ab = adc_scores(lut, spq.codes[0])
    pa, pab = adc_scores_plain(lut, spq.codes[0])
    log(f"[config 4] scores_blockmax {tuple(q.shape)} x {tuple(shard.shape)} f32: max|err| "
        f"{e_sb:.3e}; adc_scores {tuple(lut.shape)} x {tuple(spq.codes[0].shape)}: bit-equal "
        f"{bool(torch.equal(a, pa) and torch.equal(ab, pab))}")
    if e_sb > TOPK_TOL or not (torch.equal(a, pa) and torch.equal(ab, pab)):
        raise AssertionError("a kernel disagrees with its plain version at path E's shapes")
    out.update(scores_blockmax_err=e_sb)
    keep = {"gallery": gallery, "queries": q_np, "whitening": res["whitening"],
            "n_core": len(db)}
    del res, si, sivf, spq, s, ps, a, pa, dense, dense_b3, near, near_band, single_b3
    torch.cuda.empty_cache()
    log(json.dumps({"config4": out}))
    return launches, out, keep


RERANK = dict(qe_nqe=10, qe_alpha=3.0, dba_nqe=10, k_graph=50, k_seed=10, gamma=3.0,
              alpha=0.9, iters=30)
RERANK_SLICE = 10_000  # rows of path F's card-vs-CPU check
GRAPH_TOL = 1e-6  # diffusion graph weights, card against CPU (as the CPU tests hold them)


def _graph_entry_diff(a, b):
    """Largest |S_a - S_b| over the entries (src, dst) whose two rows have
    the same edges in both graphs, so that the degrees normalizing them sum
    the same edges (a near tie can give a row another neighbour, or take
    the row itself out of its own list, and so change its degree by a whole
    edge); with the count of such entries and of all of a's entries."""
    import numpy as np

    def rows_and_entries(g):
        src, dst, off = g.src.numpy(), g.dst.numpy(), g.offsets.numpy()
        srt = src[np.lexsort((src, dst))]  # each row's sources, sorted
        rows = [srt[off[r] : off[r + 1]] for r in range(g.n)]
        uniq, inv = np.unique(src * g.n + dst, return_inverse=True)
        return rows, uniq, np.bincount(inv, weights=g.w.double().numpy())

    ra, ua, va = rows_and_entries(a)
    rb, ub, vb = rows_and_entries(b)
    same_row = np.array([np.array_equal(x, y) for x, y in zip(ra, rb)])
    _, ia, ib = np.intersect1d(ua, ub, assume_unique=True, return_indices=True)
    keys = ua[ia]
    held = same_row[keys // a.n] & same_row[keys % a.n]
    diff = np.abs(va[ia][held] - vb[ib][held]).max(initial=0.0)
    return float(diff), int(held.sum()), int(len(ua))


def rerank_phase(dev, e):
    """Path F: the re-ranking family on path E's 100,000 x 2,048 whitened f32
    gallery and its 20 queries, at the JAX package's defaults (alpha 3,
    k_graph 50, k_seed 10, diffusion alpha 0.9, 30 CG iterations) with
    qe_nqe = dba_nqe = 10 (this smoke run's own choice; the JAX CLI defaults
    both to 0, off). In one counting window: Index.query(k=100,
    qe_nqe=10) timed over 7 repetitions, build_index with dba_nqe=10, the
    diffusion graph (build_graph, timed alone, twice: bit for bit) and
    Index.diffusion_ranks twice (bit for bit). Then on the gallery's first
    10,000 rows the card against the CPU: the top-100, the graph's kNN
    lists and the top-100 of the card's expanded queries equal except where
    scores tie within twice their measured card-vs-CPU difference (1e-6 at
    least), scores within 1e-5; expanded queries within 1e-5 of the host's
    expansion of the card's neighbours; the card's graph against the CPU's
    graph_from_knn on the card's kNN lists (edges and offsets equal, weights
    within 1e-6) and against the CPU's build_graph (S's entries within 1e-6
    between rows that have the same edges on both); f within 1e-5 of max|f| on one
    graph and one seeding; and scores_blockmax
    at the graph's block shape against its plain version."""
    import numpy as np
    import torch
    import image_retrieval_for_image_based_localization_tpu_torch as port
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        scores_blockmax,
        scores_blockmax_plain,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.diffusion import (
        GRAPH_BLOCK,
        DiffusionGraph,
        build_graph,
        diffuse,
        diffusion_scores,
        graph_from_knn,
        seed_matrix,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
        auto_chunk,
        knn_search,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.query_expansion import (
        expand_queries,
        expand_queries_host,
    )

    gallery, q_np = e["gallery"], e["queries"]
    n = gallery.shape[0]
    cfg = RERANK
    log(f"[rerank] on path E's {n:,} x {gallery.shape[1]} f32 gallery, {len(q_np)} queries: "
        f"{json.dumps(cfg)}")
    index = Index(gallery=gallery, storage="float32", device=dev)

    def sync():
        torch.cuda.synchronize(dev)

    out = {}
    sync()
    kernels.reset_launch_counts()
    index.query(q_np, k=100, qe_nqe=cfg["qe_nqe"], qe_alpha=cfg["qe_alpha"])  # warm
    lat = []
    for _ in range(7):
        t0 = time.perf_counter()
        s_qe, i_qe = index.query(q_np, k=100, qe_nqe=cfg["qe_nqe"], qe_alpha=cfg["qe_alpha"])
        lat.append(time.perf_counter() - t0)
    g_host = gallery.cpu().numpy()
    sync()
    t0 = time.perf_counter()
    dba = port.build_index(g_host, port.IndexConfig(whitening=None, dba_nqe=cfg["dba_nqe"],
                                                    dba_alpha=cfg["qe_alpha"]), device=dev)
    sync()
    t_dba = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = build_graph(index.device_gallery(), k=cfg["k_graph"], gamma=cfg["gamma"])
    sync()
    t_graph = time.perf_counter() - t0
    graph2 = build_graph(index.device_gallery(), k=cfg["k_graph"], gamma=cfg["gamma"])
    graph_same = all(torch.equal(a, b) for a, b in zip(graph[:4], graph2[:4]))
    del graph2
    index._diffusion_cache[(cfg["k_graph"], float(cfg["gamma"]))] = graph
    t_ranks, ranks = [], []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        ranks.append(index.diffusion_ranks(q_np, k_graph=cfg["k_graph"], k_seed=cfg["k_seed"],
                                           gamma=cfg["gamma"], alpha=cfg["alpha"],
                                           iters=cfg["iters"]))
        t_ranks.append(time.perf_counter() - t0)
    sync()
    t0 = time.perf_counter()   # the solve alone: seeds' search and 30 CG iterations
    diffusion_scores(index.device_gallery(), torch.from_numpy(q_np).to(dev), graph=graph,
                     k_seed=cfg["k_seed"], gamma=cfg["gamma"], alpha=cfg["alpha"],
                     iters=cfg["iters"])
    t_solve = time.perf_counter() - t0
    launches = kernels.launch_counts()
    log(f"[rerank] launches {launches}")
    if launches["scores_blockmax"] <= 0:
        raise AssertionError("kernel scores_blockmax was not launched on the re-ranking path")
    same = bool(np.array_equal(ranks[0], ranks[1]))
    d_moved = float(np.mean(np.asarray(dba.gallery) != g_host))
    log(f"[rerank] Index.query(k=100, qe_nqe=10): p50 {np.median(lat) * 1e3:.3f} ms, p99 "
        f"{np.percentile(lat, 99) * 1e3:.3f} ms, {len(q_np) / np.median(lat):.1f} q/s; "
        f"build_index(dba_nqe=10) {t_dba:.2f} s ({d_moved:.3f} of the values changed); "
        f"build_graph(k=50) {t_graph:.2f} s, {len(graph.src):,} edges, a second build "
        f"bit-equal {graph_same}; diffusion_ranks {t_ranks[0] * 1e3:.1f} / "
        f"{t_ranks[1] * 1e3:.1f} ms, two calls bit-equal {same}, of which the solve "
        f"(diffusion_scores) {t_solve * 1e3:.1f} ms")
    if not (same and graph_same):
        raise AssertionError("diffusion is not deterministic on the card")
    if ranks[0].shape != (n, len(q_np)) or i_qe.shape != (len(q_np), 100):
        raise AssertionError("re-ranking results have the wrong shape")
    if not np.isfinite(np.asarray(dba.gallery)).all():
        raise AssertionError("the DBA gallery is not finite")
    out.update(qe_query_p50_ms=float(np.median(lat) * 1e3),
               qe_query_p99_ms=float(np.percentile(lat, 99) * 1e3),
               qe_query_q_per_s=float(len(q_np) / np.median(lat)), dba_build_s=t_dba,
               graph_build_s=t_graph, graph_edges=int(len(graph.src)),
               diffusion_ranks_ms=[t * 1e3 for t in t_ranks], diffusion_solve_ms=t_solve * 1e3,
               diffusion_bit_equal=same)
    del dba, graph, ranks, index
    torch.cuda.empty_cache()

    # the card against the CPU on the first 10,000 rows. Random weights put
    # path C's core descriptors within ~1e-6 of each other, so a selection
    # (the nQE neighbours, the seeds, a graph row's k) may take another row
    # at such a near tie on each side: each selection is held where its
    # scores are separated, and the arithmetic after it on the card's
    # selection
    t0 = time.perf_counter()
    sl, slc = gallery[:RERANK_SLICE], gallery[:RERANK_SLICE].cpu()
    qt = torch.from_numpy(q_np)
    nqe, kg = cfg["qe_nqe"], cfg["k_graph"] + 1

    def both(fn):
        a, b = fn(sl, qt.to(dev)), fn(slc, qt)
        return tuple(t.cpu().numpy() for t in a), tuple(t.numpy() for t in b)

    def separated(a, b):
        """Indices equal except where two scores lie within twice the
        largest card-vs-CPU difference of a row's score (two sums of 2,048
        products in other orders; 1e-6 at least), scores within 1e-5."""
        noise = 0.0
        for s1, i1, s2, i2 in zip(a[0], a[1], b[0], b[1]):
            _, p1, p2 = np.intersect1d(i1, i2, return_indices=True)
            noise = max(noise, float(np.abs(s1[p1] - s2[p2]).max(initial=0.0)))
        band = max(RANK_TIE_TOL, 2 * noise)
        ok = noise <= TOPK_TOL and _agree_where_separated(a[0], a[1], b[0], b[1], tol=band,
                                                          score_tol=TOPK_TOL)
        return {"ok": ok, "score_diff": noise, "tie_band": band}

    top, top_c = both(lambda g, q: knn_search(g, q, 100))
    graph_knn = (tuple(t.cpu().numpy() for t in knn_search(sl, sl, kg)),
                 tuple(t.numpy() for t in knn_search(slc, slc, kg)))
    same_set = sum(set(a[:nqe]) == set(b[:nqe]) for a, b in zip(top[1], top_c[1]))
    # αQE's arithmetic on the card's neighbours, against the host's, then the
    # search after it on the card's expanded queries on each side
    x = expand_queries(sl, qt.to(dev), nqe=nqe)
    xh = expand_queries_host(slc.numpy()[top[1][:, :nqe]], q_np, top[0][:, :nqe])
    e_qx = float(np.abs(x.cpu().numpy() - xh).max())
    qe = tuple(t.cpu().numpy() for t in knn_search(sl, x, 100))
    qe_c = tuple(t.numpy() for t in knn_search(slc, x.cpu(), 100))
    graph = build_graph(sl, k=cfg["k_graph"], gamma=cfg["gamma"])
    # the graph's arithmetic (weights, offsets, segment-sum degrees): the
    # CPU's graph_from_knn on the card's kNN lists against the card's graph;
    # then the CPU's own build_graph, on the entries of S whose two rows
    # have the same edges on both sides (a list may take another row at a
    # near tie)
    g_card = DiffusionGraph(*(t.cpu() for t in graph[:4]), graph.n)
    g_from = graph_from_knn(torch.from_numpy(graph_knn[0][0]),
                            torch.from_numpy(graph_knn[0][1]), cfg["gamma"])
    g_cpu = build_graph(slc, k=cfg["k_graph"], gamma=cfg["gamma"])
    same_edges = all(torch.equal(getattr(g_card, a), getattr(g_from, a))
                     for a in ("src", "dst", "offsets"))
    e_w = float((g_card.w - g_from.w).abs().max()) if same_edges else float("inf")
    e_s, n_common, n_entries = _graph_entry_diff(g_card, g_cpu)
    s_seed, i_seed = knn_search(sl, qt.to(dev), cfg["k_seed"])
    seeds = seed_matrix(s_seed, i_seed, graph.n, cfg["gamma"])
    f = diffuse(graph, seeds, alpha=cfg["alpha"], iters=cfg["iters"]).cpu().numpy()
    fc = diffuse(DiffusionGraph(*(t.cpu() for t in graph[:4]), graph.n), seeds.cpu(),
                 alpha=cfg["alpha"], iters=cfg["iters"]).numpy()
    e_f = float(np.abs(f - fc).max() / np.abs(fc).max())
    checks = {"top100": separated(top, top_c), "graph_knn": separated(*graph_knn),
              "qe_top100": separated(qe, qe_c)}
    log(f"[rerank] card vs CPU on {RERANK_SLICE:,} rows: top-100, the graph's k={kg} "
        f"lists and the QE top-100 equal where separated: {json.dumps(checks)} "
        f"(places differing: {int((top[1] != top_c[1]).sum())}, "
        f"{int((graph_knn[0][1] != graph_knn[1][1]).sum())}, "
        f"{int((qe[1] != qe_c[1]).sum())}); {same_set} of {len(q_np)} queries have the same "
        f"{nqe} neighbours on both; expanded queries against the host's on the card's "
        f"neighbours max|diff| {e_qx:.3e}; the graph from the card's lists: edges and "
        f"offsets equal {same_edges}, w max|diff| {e_w:.3e}; against the CPU's graph: "
        f"{n_common:,} of {n_entries:,} entries of S between rows with the same edges, "
        f"max|diff| {e_s:.3e}; "
        f"diffusion on one graph and one seeding: f max|diff| / max|f| {e_f:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    if (not all(c["ok"] for c in checks.values()) or e_qx > TOPK_TOL or e_f > TOPK_TOL
            or e_w > GRAPH_TOL or e_s > GRAPH_TOL):
        raise AssertionError("re-ranking on the card disagrees with the CPU")
    out.update(card_vs_cpu=dict(checks, expanded_max_abs_diff=e_qx, f_rel_diff=e_f,
                                graph_w_max_abs_diff=e_w, graph_s_max_abs_diff=e_s,
                                graph_s_entries_compared=n_common, graph_s_entries=n_entries,
                                queries_same_neighbours=int(same_set)))
    del graph, seeds, g_card, g_from, g_cpu

    # scores_blockmax at the graph's block shape (GRAPH_BLOCK queries, one chunk)
    chunk = auto_chunk(n, GRAPH_BLOCK)
    gq, gc = gallery[:GRAPH_BLOCK], gallery[:chunk]
    sb, _ = scores_blockmax(gc, gq)
    pb, _ = scores_blockmax_plain(gc, gq)
    e_sb = (sb[:, :chunk] - pb[:, :chunk]).abs().max().item()
    log(f"[rerank] scores_blockmax {tuple(gq.shape)} x {tuple(gc.shape)} f32: max|err| "
        f"{e_sb:.3e}")
    if e_sb > TOPK_TOL:
        raise AssertionError("scores_blockmax disagrees with its plain version at path F's shape")
    out.update(scores_blockmax_err=e_sb)
    del sb, pb
    torch.cuda.empty_cache()
    log(json.dumps({"rerank": out}))
    return launches, out


SERVE_K = 100        # path G's shortlist: config 4's k
SERVE_REPS = 40      # timed single-query /query requests
# the closed-loop bench: config 4's gallery shape, the JAX bench's clients
SERVE_BENCH = dict(n=100_000, d=2048, concurrency=16, requests=200, k=10, batch_window_ms=5.0)


def _http(url, data=None, headers=None, timeout=120.0):
    """The JSON reply of a request; any status but 200 fails the run (a
    kernel that fails to launch must not pass as a client's 400)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        raise AssertionError(f"{url} answered {e.code}: {e.read()[:300]!r}") from None


def _ms_summary(lat_s):
    import numpy as np

    lat = np.asarray(lat_s) * 1e3
    return {"p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)), "n": int(lat.size)}


@contextlib.contextmanager
def _uncounted():
    """Launches inside are a check's reference computation: the counts are
    put back after it, so a path's window counts the path's own work."""
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels

    saved = {fn: fn.launches for fn in kernels.KERNELS}
    try:
        yield
    finally:
        for fn, n in saved.items():
            fn.launches = n


def serving_phase(dev, e, ann, qd, q_u8):
    """Path G: config 4's deployment served over HTTP on the card, through
    serving.serve and the CLI. The server holds config 4's Index as path E
    built it (100,000 x 2,048 f32, PCA learned on the core and 50,000
    distractors, so the one-hop query whitens on the card) and config 5's
    Extractor (resnet101 bf16, GeM kernel head, 1024 px, seed 0: config 4's
    trunk). In one counting window: path C's 20 query images as PNG bytes
    to /extract_query?k=100, each held against /extract then /query (ids
    equal except where scores lie within twice the measured descriptor
    difference); /query in JSON and raw f32 at k=100 (fused top-k), k=1000
    (score/block-max) and with qe_nqe=10, each equal to a direct
    Index.query bit for bit; serve(pq=...) over path A's D=2048, M=64 PQ
    index with and without refine against PQIndex.search; /healthz, /statz
    and /admin/reload from a saved artifact; micro-batches against lone
    queries bit for bit; `cli serve --no-model` as a subprocess answering a
    /query; and benchmarks.run_serving_bench (100,000 x 2,048, 16 clients,
    200 requests, k=10, unbatched and with a 5 ms window). Every reply
    status but 200 fails the run. After the window, the path's four
    kernels against their plain versions at its own shapes, and fused
    top-k at one query timed beside torch.topk(q @ g.T)."""
    import concurrent.futures
    import dataclasses
    import io
    import signal
    import tempfile
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image
    import image_retrieval_for_image_based_localization_tpu_torch as port
    from image_retrieval_for_image_based_localization_tpu_torch.benchmarks import (
        run_serving_bench,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
        feature_mask,
        rect_sizes,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        adc_scores,
        adc_scores_plain,
        fused_topk_plain,
        fused_topk_search,
        gem_l2n_fused_rect,
        gem_l2n_plain,
        scores_blockmax,
        scores_blockmax_plain,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import _build_luts
    from image_retrieval_for_image_based_localization_tpu_torch.serving import (
        RetrievalService,
        serve,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
        GRADED_CONFIGS,
    )

    t_path = time.perf_counter()
    out = {}
    # whitening in f32, as Index.build keeps it
    m, P = (np.asarray(a, np.float32) for a in e["whitening"])
    index = Index(gallery=e["gallery"], m=m, P=P, storage="float32", device=dev)
    cfg = dataclasses.replace(GRADED_CONFIGS[5].extract, batch_size=16)
    ex = port.Extractor(cfg, seed=0, device=dev)
    nq = len(q_u8)
    n_rows, D = index.gallery.shape

    def png(a):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="PNG", compress_level=1)
        return buf.getvalue()

    blobs = [png(a) for a in q_u8]
    tmp = tempfile.TemporaryDirectory(prefix="serving_")
    procs, servers = [], []
    try:
        ipath = os.path.join(tmp.name, "config4_index.npz")
        t0 = time.perf_counter()
        index.save(ipath, external_gallery=True)
        log(f"[serving] config 4's index ({index.gallery.shape[0]:,} x "
            f"{index.gallery.shape[1]} f32, PCA) saved in {time.perf_counter() - t0:.2f} s; "
            f"{nq} query images as PNG bytes ({sum(map(len, blobs)) / 1e6:.1f} MB)")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        srv = serve(index, extractor=ex, block=False, port=0, reload_paths={"index": ipath},
                    device=dev)
        servers.append(srv)
        url = "http://%s:%d" % srv.server_address[:2]
        health = _http(f"{url}/healthz")
        if (health["gallery"], health["dim"], health["model"]) != (n_rows, D, True):
            raise AssertionError(f"/healthz: {health}")

        # the one hop against /extract then /query, image by image
        one_hop, two_hop, d_two = [], [], []
        lat = {"extract_query": [], "extract": [], "query_after_extract": []}
        for rep in range(2):  # a first pass on two images meets every shape once
            for i, b in enumerate(blobs if rep else blobs[:2]):
                t0 = time.perf_counter()
                r1 = _http(f"{url}/extract_query?k={SERVE_K}", b)
                t1 = time.perf_counter()
                r2 = _http(f"{url}/extract", b)
                t2 = time.perf_counter()
                r3 = _http(f"{url}/query", json.dumps({"descriptors": [r2["descriptor"]],
                                                       "k": SERVE_K}).encode())
                t3 = time.perf_counter()
                if rep:
                    lat["extract_query"].append(t1 - t0)
                    lat["extract"].append(t2 - t1)
                    lat["query_after_extract"].append(t3 - t2)
                    one_hop.append((r1["scores"], r1["ids"]))
                    two_hop.append((r3["scores"][0], r3["ids"][0]))
                    d_two.append(r2["descriptor"])
        s1, i1 = (np.asarray([o[j] for o in one_hop]) for j in (0, 1))
        s2, i2 = (np.asarray([o[j] for o in two_hop]) for j in (0, 1))
        d_two = np.asarray(d_two, np.float32)
        # the one hop's descriptor, as the server makes it: one image a batch
        with _uncounted(), torch.inference_mode():
            d_one = torch.cat([ex.forward_u8(torch.from_numpy(q_u8[i : i + 1]).to(dev),
                                             torch.tensor([q_u8.shape[1:3]], dtype=torch.int32,
                                                          device=dev))
                               for i in range(nq)])
            dq = (index.transform_queries(d_one)
                  - index.transform_queries(torch.from_numpy(d_two).to(dev))).norm(dim=1)
            d_one = d_one.cpu().numpy()
        band = float(dq.max())  # |score difference| <= |whitened query difference|
        agree = _agree_where_separated(s1, i1, s2, i2, tol=2 * band,
                                       score_tol=band + TOPK_TOL)
        d_c = float(np.abs(d_two - qd).max())
        log(f"[serving] /extract_query?k={SERVE_K} vs /extract + /query, {nq} images: ids "
            f"equal {int((i1 == i2).sum())} of {i1.size}, max|score diff| "
            f"{float(np.abs(s1 - s2).max()):.3e}; descriptors one image a batch vs /extract's "
            f"batch of {cfg.batch_size}: max|diff| {float(np.abs(d_one - d_two).max()):.3e}, "
            f"whitened query diff {band:.3e} (band {2 * band:.3e}); /extract vs path C's "
            f"unmasked batch of query pixels max|diff| {d_c:.3e}; agree {agree}")
        if not agree or i1.shape != (nq, SERVE_K):
            raise AssertionError("the one-hop query disagrees with /extract then /query")
        if not (np.isfinite(d_two).all() and np.abs(np.linalg.norm(d_two, axis=1) - 1).max()
                < 1e-4):
            raise AssertionError("/extract's descriptors are not finite unit rows")
        top1_core = float(np.mean(i1[:, 0] < e["n_core"]))
        if top1_core <= 0.8:
            raise AssertionError(f"one-hop top-1 in core {top1_core}: core matches must beat "
                                 f"random distractors")
        out.update(one_hop_vs_two_hop=dict(ids_equal=int((i1 == i2).sum()), places=i1.size,
                                           score_diff=float(np.abs(s1 - s2).max()),
                                           descriptor_diff=float(np.abs(d_one - d_two).max()),
                                           whitened_diff=band, top1_in_core=top1_core))

        # /query over the 20 descriptors: JSON and raw, k = 100, 1000 and αQE
        qraw = np.ascontiguousarray(qd, np.float32)
        for name, k, extra in (("k100", 100, {}), ("k1000", 1000, {}),
                               ("k100_qe10", 100, {"qe_nqe": 10})):
            with _uncounted():
                want_s, want_i = index.query(qraw, k=k, **extra)
            for form in ("json", "raw"):
                if form == "json":
                    r = _http(f"{url}/query", json.dumps({"descriptors": qraw.tolist(), "k": k,
                                                          **extra}).encode())
                else:
                    qs = "&".join([f"k={k}"] + [f"qe={v}" for v in extra.values()])
                    r = _http(f"{url}/query?{qs}", qraw.tobytes(), {"X-Shape": f"{nq},{D}"})
                ids, sc = np.asarray(r["ids"]), np.asarray(r["scores"])
                if not (np.array_equal(ids, want_i)
                        and np.abs(sc - want_s).max() <= TOPK_TOL):
                    raise AssertionError(f"/query {name} {form} differs from Index.query")
            log(f"[serving] /query {name}: JSON and raw equal to Index.query, {nq} x {k}")
        # single-query latency at k=100, raw, and the same search in process
        lat["query"], lat["index_query_in_process"] = [], []
        for rep in range(SERVE_REPS + 5):
            t0 = time.perf_counter()
            r = _http(f"{url}/query?k={SERVE_K}", qraw[rep % nq].tobytes(),
                      {"X-Shape": f"1,{D}"})
            t1 = time.perf_counter()
            with _uncounted():
                index.query(qraw[rep % nq : rep % nq + 1], k=SERVE_K)
            if rep >= 5:
                lat["query"].append(t1 - t0)
                lat["index_query_in_process"].append(time.perf_counter() - t1)
        lat = {k: _ms_summary(v) for k, v in lat.items()}
        two = lat["extract"]["p50_ms"] + lat["query_after_extract"]["p50_ms"]
        log(f"[serving] latency through HTTP on one card: {json.dumps(lat)}; one hop p50 "
            f"{lat['extract_query']['p50_ms']:.3f} ms against two hops (p50 sum) {two:.3f} ms")
        out["latency"] = lat

        # micro-batches against lone queries, bit for bit (k across 128)
        svc = RetrievalService(index, batch_window_ms=20.0, device=dev)
        reqs = [(qraw[[i % nq]], (10, 100, 200)[i % 3]) for i in range(48)]
        try:
            with concurrent.futures.ThreadPoolExecutor(16) as exe:
                got = list(exe.map(lambda a: svc.query(*a), reqs))
            batches = svc.batcher.batches
        finally:
            svc.batcher.close()
        for (q, k), (s, i, _) in zip(reqs, got):
            with _uncounted():
                ws, wi = index.query(q, k=k)
            if not (np.array_equal(i, wi) and np.array_equal(s, ws)):
                raise AssertionError("a micro-batched query differs from the lone query")
        log(f"[serving] micro-batching: {len(reqs)} queries (k 10/100/200) in {batches} "
            f"searches, bit-equal to lone queries")
        out["microbatch"] = {"requests": len(reqs), "batches": batches, "bit_equal": True}

        # /statz, then /admin/reload from the saved artifact: same answers
        statz = _http(f"{url}/statz")
        for ep in ("/extract_query", "/extract", "/query"):
            if statz["endpoints"].get(ep, {}).get("count", 0) <= 0:
                raise AssertionError(f"/statz has no {ep}")
        t0 = time.perf_counter()
        rel = _http(f"{url}/admin/reload", b"")
        t_reload = time.perf_counter() - t0
        if rel != {"reloaded": True, "gallery": n_rows, "dim": D, "ivf": False, "pq": False}:
            raise AssertionError(f"/admin/reload: {rel}")
        r = _http(f"{url}/query", json.dumps({"descriptors": qraw.tolist(), "k": SERVE_K}).encode())
        with _uncounted():
            want_s, want_i = index.query(qraw, k=SERVE_K)
        if not (np.array_equal(np.asarray(r["ids"]), want_i)
                and np.array_equal(np.asarray(r["scores"], np.float32), want_s)):
            raise AssertionError("the reloaded index answers otherwise")
        log(f"[serving] /statz counts "
            f"{ {k: v['count'] for k, v in statz['endpoints'].items()} }; /admin/reload "
            f"{t_reload:.2f} s (load, upload, swap), answers bit-equal after it")
        out.update(reload_s=t_reload)
        svc_main = srv.service
        srv.shutdown()
        srv.server_close()
        servers.remove(srv)

        # PQ serving over path A's D=2048, M=64 index, unwhitened
        g_a, q_a, pq = ann["g"], ann["q"][:32], ann["pq"]
        pq_index = Index.build(g_a, port.IndexConfig(whitening=None), device=dev)
        psrv = serve(pq_index, pq=pq, block=False, port=0, device=dev)
        servers.append(psrv)
        purl = "http://%s:%d" % psrv.server_address[:2]
        h = _http(f"{purl}/healthz")
        if h["pq"] != {"m": pq.codebooks.shape[0], "refine": 0, "ivf": False}:
            raise AssertionError(f"/healthz pq: {h['pq']}")
        gd = pq_index.device_gallery()
        for refine in (0, 400):
            r = _http(f"{purl}/query?k={SERVE_K}&refine={refine}",
                      np.ascontiguousarray(q_a).tobytes(),
                      {"X-Shape": f"{len(q_a)},{q_a.shape[1]}"})
            with _uncounted():
                ws, wi = pq.search(q_a, k=SERVE_K, refine=refine,
                                   gallery=gd if refine else None)
            ids, sc = np.asarray(r["ids"]), np.asarray(r["scores"], np.float32)
            if not (np.array_equal(ids, wi) and np.array_equal(sc, ws)):
                raise AssertionError(f"PQ /query refine={refine} differs from PQIndex.search")
        log(f"[serving] PQ (M={pq.codebooks.shape[0]}) /query for {len(q_a)} queries, refine 0 and 400: equal to "
            f"PQIndex.search bit for bit")
        psrv.shutdown()
        psrv.server_close()
        servers.remove(psrv)
        del pq_index, gd

        # the CLI as a process on the card: `serve --index ... --no-model`
        root = os.path.dirname(os.path.abspath(__file__))
        port_no = _free_port()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "image_retrieval_for_image_based_localization_tpu_torch.cli",
             "serve", "--index", ipath, "--no-model", "--port", str(port_no)],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        procs.append(proc)
        curl = f"http://127.0.0.1:{port_no}"
        while True:
            try:
                with urllib.request.urlopen(f"{curl}/healthz", timeout=5) as resp:
                    ch = json.loads(resp.read())
                break
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError("cli serve exited: "
                                         + proc.stdout.read().decode()[-2000:]) from None
                if time.perf_counter() - t0 > 180:
                    raise AssertionError("cli serve did not answer /healthz in 180 s") from None
                time.sleep(0.25)
        t_up = time.perf_counter() - t0
        r = _http(f"{curl}/query?k={SERVE_K}", qraw[:1].tobytes(), {"X-Shape": f"1,{D}"})
        with _uncounted():
            want_s, want_i = index.query(qraw[:1], k=SERVE_K)
        if not (ch["gallery"] == n_rows and np.array_equal(np.asarray(r["ids"]), want_i)):
            raise AssertionError("cli serve answers otherwise than Index.query")
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        banner = proc.stdout.read().decode()
        procs.remove(proc)
        log(f"[serving] cli serve --no-model as a process: /healthz after {t_up:.1f} s, "
            f"/query k={SERVE_K} equal to Index.query; stopped ({banner.strip()[:120]!r})")
        out.update(cli_serve_up_s=t_up)

        t0 = time.perf_counter()
        bench = run_serving_bench(**SERVE_BENCH, device=dev)
        log(f"[serving] run_serving_bench {json.dumps(SERVE_BENCH)} "
            f"({time.perf_counter() - t0:.1f} s): {json.dumps(bench)}")
        out["bench"] = bench
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for p in procs:
            p.kill()
            p.wait(timeout=30)
        tmp.cleanup()
    log(f"[serving] launches {launches}")
    for name in ("gem_l2n_fused_rect", "scores_blockmax", "fused_topk_search", "adc_scores"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")

    # where one /extract_query's time goes: its stages on one image, each
    # ended by a synchronize, host clock, median of 5
    stages = {"png_decode_and_write": [], "batch_native_decode": [], "trunk_and_head": [],
              "whiten_search_copy": []}
    for _ in range(5):
        t0 = time.perf_counter()
        with svc_main._png_path(blobs[0]) as path:
            t1 = time.perf_counter()
            batch = next(iter(ex.make_input_batches([path], batch_size=1)))
            t2 = time.perf_counter()
        with torch.inference_mode():
            t2b = time.perf_counter()  # the temporary file's unlink is no stage
            d = ex.forward_u8(torch.from_numpy(batch.pixels_u8).to(dev),
                              torch.from_numpy(batch.sizes).to(dev))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            s_, i_ = index.query_device(d, 128)
            s_, i_ = s_.cpu(), i_.cpu()
            t4 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2b, t4 - t3)):
            stages[key].append(dt * 1e3)
    stages = {key: float(np.median(v)) for key, v in stages.items()}
    log(f"[serving] one /extract_query's stages (ms, median of 5): {json.dumps(stages)}")
    out["extract_query_stages_ms"] = stages

    # the four kernels at this path's shapes, against their plain versions
    g = index.device_gallery()
    q1 = index.transform_queries(qraw[:1]).contiguous()
    q20 = index.transform_queries(qraw).contiguous()
    a, ai = fused_topk_search(g, q1, 128)
    b, bi = fused_topk_plain(g, q1, 128)
    e_topk = (a - b).abs().max().item()
    # cuBLAS sums in another order: indices held where scores are separated
    same_i = _agree_where_separated(a.cpu().numpy(), ai.cpu().numpy(), b.cpu().numpy(),
                                    bi.cpu().numpy())
    t_bytes = (g.numel() + q1.numel() + 2 * 128) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * g.numel() / F32_FLOP_PER_S * 1e3
    nq1 = {"ms": time_ms(lambda: fused_topk_search(g, q1, 128)),
           "plain_ms": time_ms(lambda: fused_topk_plain(g, q1, 128)),
           "library_ms": time_ms(lambda: torch.topk(q1 @ g.T, 128, dim=1)),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "max_abs_err": e_topk,
           "shape": f"1 x {g.shape[0]} x {g.shape[1]} f32, k=128 (the one hop's)"}
    s3, _ = scores_blockmax(g, q20)
    p3, _ = scores_blockmax_plain(g, q20)
    e_sb = (s3[:, : g.shape[0]] - p3[:, : g.shape[0]]).abs().max().item()
    lut = _build_luts(torch.from_numpy(pq.codebooks).to(dev), torch.from_numpy(q_a).to(dev))
    codes = torch.from_numpy(pq.codes).to(dev)
    ka, kb = adc_scores(lut, codes)
    pa, pb = adc_scores_plain(lut, codes)
    adc_same = bool(torch.equal(ka, pa) and torch.equal(kb, pb))
    with torch.inference_mode():
        px = torch.from_numpy(q_u8[:1]).to(dev)
        mask = torch.ones(px.shape[:3], dtype=torch.bool, device=dev)
        x = px.to(ex._nrm_a.dtype) * ex._nrm_a + ex._nrm_b
        feats = ex.model.trunk_nhwc(x)
        fsz = rect_sizes(feature_mask(mask, x.shape[1:3], feats.shape[1:3]))
        pgem = ex.model.pool.p
        e_gem = (gem_l2n_fused_rect(feats, pgem, fsz)
                 - gem_l2n_plain(feats, pgem, fsz)).abs().max().item()
    log(f"[serving] kernels at path G's shapes: fused_topk {nq1['shape']} max|err| {e_topk:.3e}"
        f" (indices agree {same_i}), kernel {nq1['ms']:.4f} ms, plain {nq1['plain_ms']:.4f} ms,"
        f" torch.topk(q @ g.T) {nq1['library_ms']:.4f} ms, bound {nq1['bound_ms']:.4f} ms; "
        f"scores_blockmax {tuple(q20.shape)} x {tuple(g.shape)} max|err| {e_sb:.3e}; "
        f"adc_scores {tuple(lut.shape)} x {tuple(codes.shape)} bit-equal {adc_same}; "
        f"gem_l2n_fused_rect {list(feats.shape)} {feats.dtype} max|err| {e_gem:.3e}")
    if not (e_topk <= TOPK_TOL and same_i and e_sb <= TOPK_TOL and adc_same
            and e_gem <= GEM_TOL):
        raise AssertionError("a kernel disagrees with its plain version at path G's shapes")
    out.update(fused_topk_err=e_topk, scores_blockmax_err=e_sb, adc_err=0.0, gem_err=e_gem,
               fused_topk_nq1=nq1, wall_s=time.perf_counter() - t_path)
    del ex, feats, x, g, s3, p3, ka, kb, pa, pb, lut, codes
    torch.cuda.empty_cache()
    log(f"[serving] path G wall {out['wall_s']:.1f} s")
    log(json.dumps({"serving": out}))
    return launches, out


REGIONAL_TOL = 1e-6  # sum of unit region vectors vs the descriptor, one trunk on both
RESUME_SHARD = 32


def other_trunks_phase(dev):
    """Path H: the other trunks, R-MAC and regional extraction on the card,
    random weights from seeded generators, on the in-memory corpus.

    1. densenet121 + GeM, kernel head, f32, 1024 px, three scales (config 2
       with the trunk swapped): extract_features -> build_index(pca) ->
       Index.query(k=10) through the fused top-k kernel -> mAP, held against
       the same run with use_pallas=False; img/s cold and warm, idle share;
    2. alexnet-gem and squeezenet1_1-gem: one padded 720 x 1024 bucket each
       through the masked GeM kernel against the plain head;
    3. vgg16-rmac on bucketed batches: rmac_bucketed per image against rmac
       on the image's own (h, w) corner of the map, region counts equal;
    4. resnet101 + GeM, regional, whiten_dim=2048: extract_regional and
       extract_local on the 20 queries, shapes against rmac_regions, the
       region sum against the model's own descriptor;
    5. extract_resumable over the 100 images in shards of 32, the later two
       shards deleted and resumed, bit for bit;
    6. every MODEL_ZOO preset builds; one .pth saved and loaded back through
       load_model bit for bit.
    The launch counts are read over the whole path: the comparisons run
    plain heads, which launch nothing."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    import image_retrieval_for_image_based_localization_tpu_torch as port
    from image_retrieval_for_image_based_localization_tpu_torch.data.images import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (
        compute_map,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.models import init_random_, zoo
    from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
        feature_mask,
        rect_sizes,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
    from image_retrieval_for_image_based_localization_tpu_torch.ops.normalization import l2n
    from image_retrieval_for_image_based_localization_tpu_torch.ops.pooling import (
        rmac,
        rmac_bucketed,
        rmac_region_counts,
        rmac_regions,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
        GRADED_CONFIGS,
    )

    t_path = time.perf_counter()
    images, labels, q_u8 = make_corpus()
    q_pixels = ((q_u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
    queries = list(q_u8)
    out = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()

    # 1. densenet121 + GeM at config 2's shape
    g2 = GRADED_CONFIGS[2]
    mc = dataclasses.replace(g2.extract.model, arch="densenet121", use_pallas=True)
    cfg = dataclasses.replace(g2.extract, model=mc, batch_size=16)
    log(f"[densenet121] {mc.arch} {mc.pooling} fused head, {cfg.image_size} px, scales "
        f"{tuple(round(s, 4) for s in cfg.scales)}, f32, index {g2.index}, {len(images)} db "
        f"images, {len(queries)} queries")
    ex = port.Extractor(cfg, seed=0, device=dev)
    t0 = time.perf_counter()
    db = ex.extract(images)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    qd = ex(q_pixels)
    index = port.build_index(db, g2.index, device=dev)
    scores, idx = index.query(qd, k=10)
    _, self_idx = index.query(db, k=10)
    ranks = index.ranks(qd)
    gnd = [{"ok": np.flatnonzero(labels == s)} for s in range(len(q_u8))]
    mAP = compute_map(ranks, gnd)[0]
    self_top1 = float(np.mean(self_idx[:, 0] == np.arange(len(db))))
    t0 = time.perf_counter()
    db_warm = ex.extract(images)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    prof = profile_window(lambda: ex.extract(images))
    plain = port.Extractor(dataclasses.replace(cfg, model=dataclasses.replace(
        mc, use_pallas=False)), state_dict=ex.model.state_dict(), device=dev)
    d_err = float(max(np.abs(plain.extract(images) - db).max(), np.abs(plain(q_pixels) - qd).max()))
    log(f"[densenet121] extraction cold {len(images) / t_cold:.2f} img/s ({t_cold:.2f} s), warm "
        f"{len(images) / t_warm:.2f} img/s ({t_warm:.2f} s, max|diff| to cold "
        f"{np.abs(db_warm - db).max():.3e}), descriptors {db.shape}, index "
        f"{index.gallery.shape}, self top-1 {self_top1:.3f}, mAP {mAP:.4f}, kernel vs plain "
        f"head (all 100 + 20 images x 3 scales): max|descriptor err| {d_err:.3e}")
    log(f"[densenet121] profiled extraction: {json.dumps(prof)}")
    if db.shape != (len(images), 1024) or not np.isfinite(db).all() or \
            np.abs(np.linalg.norm(db, axis=1) - 1).max() > 1e-4:
        raise AssertionError("densenet121 descriptors are not finite unit-norm [N, 1024]")
    if self_top1 != 1.0 or not (np.isfinite(scores).all() and 0.0 <= mAP <= 1.0):
        raise AssertionError(f"densenet121: self top-1 {self_top1}, mAP {mAP}")
    if d_err > GEM_TOL:
        raise AssertionError("densenet121 kernel-head descriptors disagree with the plain head")
    out["densenet121"] = {"extract_img_per_s": len(images) / t_cold,
                          "extract_warm_img_per_s": len(images) / t_warm, "map": mAP,
                          "self_top1": self_top1, "d_err": d_err, "profile": prof}
    del plain

    # 5. resumable extraction with the same extractor: stopped after two shards
    cache = tempfile.mkdtemp(prefix="resume_")
    try:
        first = ex.extract_resumable(images, cache, shard_size=RESUME_SHARD)
        shards = sorted(os.listdir(cache))
        for name in shards[2:]:
            os.remove(os.path.join(cache, name))
        resumed = ex.extract_resumable(images, cache, shard_size=RESUME_SHARD)
        left = sorted(os.listdir(cache))
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    bitwise = bool(np.array_equal(resumed, first))
    r_err = float(np.abs(resumed - db_warm).max())
    log(f"[resumable] {len(shards)} shards of {RESUME_SHARD}, {len(shards) - 2} deleted and "
        f"resumed: bit-equal to the uninterrupted run {bitwise}; "
        f"max|diff| to one extract of all 100 (other batches) {r_err:.3e}; files left {left}")
    if not bitwise or left != shards or r_err > GEM_TOL:
        raise AssertionError("resumed extraction differs from the uninterrupted one")
    out["resumable"] = {"shards": len(shards), "bitwise": bitwise, "vs_extract_err": r_err}
    del ex

    # 2. alexnet and squeezenet: one padded bucket each through the masked kernel
    rect = [im for im in images if im.shape == images[1].shape][:16]  # 720 x 1024
    for name in ("alexnet-gem", "squeezenet1_1-gem"):
        zcfg = port.ExtractConfig(model=dataclasses.replace(zoo.MODEL_ZOO[name], use_pallas=True),
                                  image_size=1024, batch_size=16)
        before = kernels.gem_l2n_fused_rect.launches
        zex = port.Extractor(zcfg, seed=1, device=dev)
        d = zex.extract(rect)
        n_rect = kernels.gem_l2n_fused_rect.launches - before
        zplain = port.Extractor(dataclasses.replace(zcfg, model=dataclasses.replace(
            zcfg.model, use_pallas=False)), state_dict=zex.model.state_dict(), device=dev)
        e = float(np.abs(zplain.extract(rect) - d).max())
        log(f"[{name}] one bucket of {len(rect)} {rect[0].shape[0]} x {rect[0].shape[1]} "
            f"images (rows padded to a multiple of 32), C={zex.out_dim}: gem_l2n_fused_rect "
            f"launches {n_rect}, kernel vs plain head max|err| {e:.3e}")
        if n_rect != 1 or e > GEM_TOL or not np.isfinite(d).all():
            raise AssertionError(f"{name}: the bucket did not go through the masked kernel "
                                 f"or disagrees with the plain head")
        out[name] = {"rect_launches": n_rect, "d_err": e}
        del zex, zplain

    # 2b. the three trunks in bf16 on the same bucket: the masked GeM kernel
    # reads the bf16 map; kernel head against plain head, bf16 against the
    # f32 run of the same weights
    for name in ("alexnet-gem", "squeezenet1_1-gem", "densenet121-gem"):
        mc16 = dataclasses.replace(zoo.MODEL_ZOO[name], use_pallas=True, dtype="bfloat16")
        zcfg = port.ExtractConfig(model=mc16, image_size=1024, batch_size=16)
        before = kernels.gem_l2n_fused_rect.launches
        zex = port.Extractor(zcfg, seed=1, device=dev)
        d = zex.extract(rect)
        n_rect = kernels.gem_l2n_fused_rect.launches - before
        sd = zex.model.state_dict()
        zplain = port.Extractor(dataclasses.replace(zcfg, model=dataclasses.replace(
            mc16, use_pallas=False)), state_dict=sd, device=dev)
        e = float(np.abs(zplain.extract(rect) - d).max())
        z32 = port.Extractor(dataclasses.replace(zcfg, model=dataclasses.replace(
            mc16, dtype="float32")), state_dict=sd, device=dev)
        d32 = z32.extract(rect)
        d_32, cos_32 = _desc_gap(d, d32)
        log(f"[{name} bf16] one bucket of {len(rect)} {rect[0].shape[0]} x {rect[0].shape[1]} "
            f"images, bf16 trunk: gem_l2n_fused_rect launches {n_rect}, kernel vs plain head "
            f"max|err| {e:.3e}; bf16 vs f32 run of the same weights max|diff| {d_32:.3e}, min "
            f"cosine {cos_32:.6f} (gates {BF16_DESC_MAX_DIFF}, {BF16_DESC_MIN_COS})")
        if n_rect != 1 or e > GEM_TOL or not np.isfinite(d).all():
            raise AssertionError(f"{name} bf16: the bucket did not go through the masked "
                                 f"kernel or disagrees with the plain head")
        if d_32 > BF16_DESC_MAX_DIFF or cos_32 < BF16_DESC_MIN_COS:
            raise AssertionError(f"{name} bf16 descriptors stray from the f32 run")
        out[f"{name}_bf16"] = {"rect_launches": n_rect, "d_err": e, "vs_f32_max_abs_diff": d_32,
                               "vs_f32_min_cos": cos_32}
        del zex, zplain, z32

    # 3. vgg16-rmac on bucketed batches
    rex = port.Extractor(port.ExtractConfig(model=zoo.MODEL_ZOO["vgg16-rmac"], image_size=1024,
                                            batch_size=16), seed=2, device=dev)
    sub = images[:32]
    drm = rex.extract(sub)
    e_rmac, e_head, n_img, counts = 0.0, 0.0, 0, []
    with torch.no_grad():
        for batch in rex.make_input_batches(sub):
            px = torch.from_numpy(batch.pixels_u8).to(dev)
            sz = torch.from_numpy(batch.sizes).to(dev)
            B, H, W, _ = px.shape
            row = torch.arange(H, device=dev)[None, :, None]
            col = torch.arange(W, device=dev)[None, None, :]
            mask = (row < sz[:, 0, None, None]) & (col < sz[:, 1, None, None])
            x = (px.float() * rex._nrm_a + rex._nrm_b) * mask[..., None]
            feats = rex.model.trunk_nhwc(x).float()
            fsz = rect_sizes(feature_mask(mask, (H, W), feats.shape[1:3]))
            bucketed = rmac_bucketed(feats, fsz)
            n_regions = rmac_region_counts(fsz).tolist()
            e_head = max(e_head, (l2n(bucketed) - rex.forward_u8(px, sz)).abs().max().item())
            for r in range(batch.valid):
                h, w = fsz[r].tolist()
                want = rmac(feats[r:r + 1, :h, :w])
                e_rmac = max(e_rmac, (bucketed[r] - want[0]).abs().max().item())
                if n_regions[r] != 1 + len(rmac_regions(h, w)):
                    raise AssertionError(f"rmac_bucketed pools {n_regions[r]} regions of a "
                                         f"{h} x {w} map, rmac {1 + len(rmac_regions(h, w))}")
                counts.append((h, w, n_regions[r]))
                n_img += 1
    log(f"[vgg16-rmac] {len(sub)} images in buckets: rmac_bucketed vs exact rmac per image "
        f"max|err| {e_rmac:.3e}, head vs l2n(rmac_bucketed) {e_head:.3e}, (h, w, regions) "
        f"{sorted(set(counts))}, descriptors {drm.shape}")
    if n_img != len(sub) or e_rmac > GEM_TOL or e_head > GEM_TOL or not np.isfinite(drm).all():
        raise AssertionError("vgg16-rmac: bucketed R-MAC disagrees with exact-shape R-MAC")
    out["vgg16_rmac"] = {"rmac_err": e_rmac, "head_err": e_head,
                         "grids": sorted(set(counts))}
    del rex

    # 4. resnet101 + GeM, regional, per-region whitening to 2048
    gex = port.Extractor(port.ExtractConfig(model=port.ModelConfig(
        arch="resnet101", regional=True, whiten_dim=2048), image_size=1024, batch_size=16),
        seed=3, device=dev)
    regs = gex.extract_regional(queries)
    locs = gex.extract_local(queries)
    agg = gex.extract(queries)
    fh, fw = (-(-n // 32) for n in q_u8.shape[1:3])  # resnet101's map: 32 x 32 at 1024 px
    n_reg = 1 + len(rmac_regions(fh, fw))
    shapes_ok = (all(r.shape == (n_reg, 2048) for r in regs)
                 and all(f.shape == (fh * fw, 2048) for f in locs)
                 and agg.shape == (len(queries), 2048))
    e_sum = float(max(np.abs(l2n(torch.from_numpy(r.sum(axis=0))).numpy() - a).max()
                      for r, a in zip(regs, agg)))
    e_norm = float(max(np.abs(np.linalg.norm(r, axis=1) - 1).max() for r in regs + locs))
    log(f"[regional] resnet101 + GeM regional, whiten 2048, exact {gex.cfg.exact}: "
        f"extract_regional {len(regs)} x {regs[0].shape}, extract_local {len(locs)} x "
        f"{locs[0].shape}, region sum vs descriptor max|err| {e_sum:.3e}, max|norm - 1| "
        f"{e_norm:.3e}")
    if not (shapes_ok and gex.cfg.exact) or e_sum > REGIONAL_TOL or e_norm > 1e-4:
        raise AssertionError("regional extraction: wrong shapes or the region sum disagrees")
    out["regional"] = {"regions": n_reg, "sum_err": e_sum, "norm_err": e_norm}
    del gex, regs, locs

    # 6. the zoo
    widths = {name: zoo.create_model_from_zoo(name).out_dim for name in zoo.MODEL_ZOO}
    tmp = tempfile.mkdtemp(prefix="zoo_")
    try:
        net = zoo.create_model_from_zoo("densenet121-gem")
        init_random_(net, torch.Generator().manual_seed(4))
        path = os.path.join(tmp, "densenet121-gem.pth")
        torch.save({"state_dict": net.state_dict(), "meta": zoo.model_to_meta(net)}, path)
        loaded, _ = zoo.load_model("densenet121-gem", checkpoint=path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = all(torch.equal(v, loaded.state_dict()[k]) for k, v in net.state_dict().items())
    log(f"[zoo] {len(widths)} presets built, widths {widths}; densenet121-gem .pth loaded back "
        f"bit for bit {same}")
    if len(widths) != 12 or not same:
        raise AssertionError("zoo: a preset failed or the checkpoint did not load back")
    out["zoo"] = {"presets": len(widths), "roundtrip_bitwise": same}

    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"[other trunks] launches {launches}")
    for name in ("gem_l2n_fused_rect", "gem_l2n_fused", "fused_topk_search"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on path H")

    # the search kernel at step 1's own shapes, after the counts are read:
    # these launches compare and do not count
    g = index.device_gallery()
    errs = {}
    for tag, qs in (("queries", qd), ("db", db)):
        qt = index.transform_queries(qs)
        s_k, i_k = kernels.fused_topk_search(g, qt, 10)
        s_p, i_p = kernels.fused_topk_plain(g, qt, 11)
        ok, e = _check_search_case(s_k, i_k.long(), s_p[:, :10], i_p[:, :10].long(),
                                   next_score=s_p[:, 10])
        errs[tag] = e
        log(f"[densenet121] fused_topk_search {tuple(qt.shape)} x {tuple(g.shape)} k 10 vs "
            f"plain: max|err| {e:.3e}, {int((i_k != i_p[:, :10]).sum())} of {i_k.numel()} "
            f"places name another row, ok {ok}")
        if not ok:
            raise AssertionError(f"fused top-k disagrees with its plain version on path H "
                                 f"({tag})")
    out["densenet121"]["topk_err"] = max(errs.values())
    del index, g, qt, s_k, i_k, s_p, i_p
    out["wall_s"] = time.perf_counter() - t_path
    log(f"[other trunks] path H wall {out['wall_s']:.1f} s")
    torch.cuda.empty_cache()
    return launches, out


# cirtorch's retrievalSfM120k-resnet101-gem training recipe (README,
# cirtorch.examples.train): --arch resnet101 --pool gem --loss contrastive
# --loss-margin 0.85 --optimizer adam --lr 5e-7 --neg-num 5 --query-size 2000
# --pool-size 20000 --batch-size 5 --image-size 362; path D cuts the pool
# (synthetic, 100 scenes x 8 views), qsize (100) and the epochs (1). The pool's
# images are written at 272 x 368, so mining, validation and Lw resize them to
# the recipe's 362-px max side as they would SfM-120k's (~1024 px) images
TRAIN_RECIPE = dict(arch="resnet101", pooling="gem", loss="contrastive", margin=0.85,
                    optimizer="adam", lr=5e-7, n_neg=5, batch_tuples=5, image_size=362)
TRAIN_SCENES, TRAIN_VIEWS, TRAIN_QSIZE, TRAIN_HW = 100, 8, 100, (272, 368)
GRAD_REL, GRAD_ATOL = 1e-4, 1e-6  # kernel-head vs plain-head gradients, of max|g|
LOSS_REL = 1e-5


def _grad_check(tag, smi, k_model, p_model, k_loss, p_loss, params_only=None):
    """Kernel-head step against plain-head step on one batch: the losses,
    every parameter's gradient (within GRAD_REL of its tensor's max|g| or
    GRAD_ATOL) and the BN running statistics (equal)."""
    import torch

    rel = abs(float(k_loss) - float(p_loss)) / max(abs(float(p_loss)), 1e-30)
    worst, worst_name, n_grads = 0.0, None, 0
    p_named = dict(p_model.named_parameters())
    for name, pk in k_model.named_parameters():
        if params_only is not None and name not in params_only:
            continue
        gp = p_named[name].grad
        if pk.grad is None or gp is None:
            if (pk.grad is None) != (gp is None):
                raise AssertionError(f"[{tag}] {name}: a gradient on one side only")
            continue
        n_grads += 1
        err = (pk.grad - gp).abs().max().item()
        bound = max(GRAD_REL * gp.abs().max().item(), GRAD_ATOL)
        if err / bound > worst:
            worst, worst_name = err / bound, name
    stats_diff = 0.0
    p_sd = p_model.state_dict()
    for k, v in k_model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            stats_diff = max(stats_diff, (v - p_sd[k]).abs().max().item())
    log(f"[training] {tag}: loss kernel {float(k_loss):.8f} plain {float(p_loss):.8f} "
        f"(rel {rel:.2e}), {n_grads} gradients, worst err/bound {worst:.3f} ({worst_name}), "
        f"BN running stats max|diff| {stats_diff:.3e} | {smi}")
    if rel > LOSS_REL or worst > 1.0 or stats_diff != 0.0 or n_grads == 0:
        raise AssertionError(f"[training] {tag}: the kernel head's step disagrees with the "
                             f"plain head's")
    return {"loss_rel": rel, "worst_err_over_bound": worst, "gradients": n_grads,
            "bn_stats_max_diff": stats_diff}


def _mining_check(dev, smi, args, paths, clusters, qidxs, pidxs):
    """Mining's search at the shape path D gave it: the pool's descriptors
    under the trained (``best``) weights, ``scores_blockmax`` and
    ``knn_search`` on the card against their plain versions, and epoch 0's
    tuples mined on the card against those mined on the CPU from the same
    descriptors. A mined negative may differ only where the two picks tie:
    their plain scores within TOPK_TOL (random weights give descriptors that
    nearly coincide, so each row's top-k is full of such ties)."""
    import numpy as np
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import knn_search
    from image_retrieval_for_image_based_localization_tpu_torch.training.mining import (
        mine_epoch_tuples,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
        ExtractConfig,
        ModelConfig,
    )

    r = TRAIN_RECIPE
    tree, _ = load_checkpoint(args.out_dir, "best")
    ex_cfg = ExtractConfig(model=ModelConfig(arch=r["arch"], pooling=r["pooling"],
                                             use_pallas=True),
                           image_size=r["image_size"], batch_size=args.batch_size)
    vecs = Extractor(ex_cfg, state_dict=tree["model"], device=dev).extract(list(paths))
    # mine_epoch_tuples' query draw for epoch 0; poolsize None keeps the whole pool
    sel = np.sort(np.random.RandomState(0).choice(len(qidxs), TRAIN_QSIZE, replace=False))
    g = torch.from_numpy(np.ascontiguousarray(vecs, np.float32)).to(dev)
    q = g[torch.from_numpy(qidxs[sel]).to(dev)].contiguous()
    k = min(200, len(paths))
    ok_sb, e_sb = _check_blockmax_case(g, q)
    cs, ci = (t.cpu() for t in knn_search(g, q, k))
    # the dense route, as CPU mining runs it, one place further: the first
    # row past the shortlist tells whether the last place is a tie
    ps, pi = knn_search(g.cpu(), q.cpu(), min(k + 1, len(paths)))
    nxt = ps[:, k] if ps.shape[1] > k else None
    ps, pi = ps[:, :k], pi[:, :k]
    ok_knn, e_knn = _check_search_case(cs, ci.long(), ps, pi.long(), next_score=nxt)
    reordered = int((ci.long() != pi.long()).sum())
    spread = float((ps[:, 0] - ps[:, -1]).median())  # the top-k's score range
    # where the card names another row than the CPU, how far apart the two
    # rows' plain scores are (a tie is within TOPK_TOL)
    plain_all = q.cpu() @ g.cpu().T
    diff = ci.long() != pi.long()
    pick_gap = float((plain_all.gather(1, ci.long()) - ps).abs()[diff].max()) if diff.any() \
        else 0.0

    row = {p: i for i, p in enumerate(paths)}
    kw = dict(clusters=clusters, n_neg=r["n_neg"], seed=0, qsize=TRAIN_QSIZE)
    t_card = mine_epoch_tuples(lambda ps_: vecs[[row[p] for p in ps_]], paths, qidxs, pidxs,
                               device=dev, **kw)
    t_cpu = mine_epoch_tuples(lambda ps_: vecs[[row[p] for p in ps_]], paths, qidxs, pidxs,
                              device="cpu", **kw)
    same_pairs = (np.array_equal(t_card.qidxs, qidxs[sel])
                  and np.array_equal(t_card.qidxs, t_cpu.qidxs)
                  and np.array_equal(t_card.pidxs, t_cpu.pidxs))
    rows, cols = np.nonzero(t_card.nidxs != t_cpu.nidxs)
    plain = plain_all.numpy()  # the CPU's scores; rows are sel's queries
    gap = float(np.abs(plain[rows, t_card.nidxs[rows, cols]]
                       - plain[rows, t_cpu.nidxs[rows, cols]]).max()) if len(rows) else 0.0
    log(f"[training] mining search at its shape: Nq {q.shape[0]} Ng {g.shape[0]} D {g.shape[1]} "
        f"k {k} f32: scores_blockmax max|err| {e_sb:.3e} (tol {TOPK_TOL}) ok {ok_sb}, "
        f"knn_search vs the CPU's max|err| {e_knn:.3e} ok {ok_knn}; top-{k} score range "
        f"(median over rows) {spread:.3e}, {reordered} of {ci.numel()} top-{k} places name "
        f"another pool row, their plain scores within {pick_gap:.3e} of the CPU's picks; "
        f"tuples card vs CPU: {len(t_card.qidxs)} tuples, "
        f"{len(np.unique(rows))} rows differ, the differing picks' plain scores within "
        f"{gap:.3e} | {smi}")
    if not (ok_sb and ok_knn and pick_gap <= TOPK_TOL and same_pairs and gap <= TOPK_TOL):
        raise AssertionError("[training] mining: the card's search or tuples disagree with "
                             "the plain search's")
    return {"scores_blockmax_err": e_sb, "knn_err": e_knn, "topk_score_range": spread,
            "topk_places_reordered": reordered, "topk_pick_score_gap": pick_gap, "tuple_rows_differ": int(len(np.unique(rows))),
            "tuple_pick_score_gap": gap}


def training_phase(dev, smi):
    """Path D: the training path, cirtorch's resnet101-GeM recipe at full
    width (TRAIN_RECIPE) through ``run_training`` for one epoch on a
    synthetic pool on disk, ``run_training_bench`` at 362 px, kernel-head
    steps held against plain-head steps (masked u8 and unmasked, a frozen
    trunk with p trainable), and vgg16 + NetVLAD K=64 (config 3's model) for
    two steps; the launch counts over all of it."""
    import argparse
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.benchmarks import (
        run_training_bench,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
        RetrievalNet,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
    from image_retrieval_for_image_based_localization_tpu_torch.training import loop
    from image_retrieval_for_image_based_localization_tpu_torch.training.mining import TupleSet
    from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
        TrainConfig,
        create_train_state,
        make_train_step,
        train_epoch,
        u8_to_input,
    )

    t_path = time.perf_counter()
    cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    r = TRAIN_RECIPE
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    out = {}
    try:
        log(f"[training] path D: cirtorch retrievalSfM120k-resnet101-gem recipe {r}, f32, "
            f"kernel head; cuts: synthetic pool {TRAIN_SCENES} scenes x {TRAIN_VIEWS} views "
            f"(SfM-120k: 91,642 images) written at {TRAIN_HW[0]}x{TRAIN_HW[1]} px (SfM-120k: "
            f"~1024 px max side; both resized to {r['image_size']} px on load), qsize "
            f"{TRAIN_QSIZE} (2000), poolsize the whole pool (20000), 1 epoch, random weights "
            f"from torch.Generator seed 0")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        # 1. run_training, one epoch
        args = argparse.Namespace(
            **r, whiten_dim=None, epochs=1, qsize=TRAIN_QSIZE, poolsize=None,
            out_dir=os.path.join(tmp, "run"), data_root=os.path.join(tmp, "data"), resume=None,
            pallas=True, synth_scenes=TRAIN_SCENES, synth_views=TRAIN_VIEWS, synth_hw=TRAIN_HW,
            batch_size=16)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = loop.run_training(args, device=dev)
        t_run = time.perf_counter() - t0
        with open(os.path.join(args.out_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        pool = next(x for x in recs if x.get("event") == "pool")
        mined = next(x for x in recs if x.get("event") == "mined")
        ep = next(x for x in recs if "train_loss" in x)
        val = next((x["val_map_medium"] for x in recs if "val_map_medium" in x), None)
        files = sorted(os.listdir(args.out_dir))
        wh = np.load(os.path.join(args.out_dir, "whitening.npz"))
        log(f"[training] run_training: pool {pool['images']} images / {pool['pairs']} pairs, "
            f"mining {mined['seconds']:.3f} s (extraction {mined['seconds_extract']:.3f} s, "
            f"knn_search + filter {mined['seconds_search']:.3f} s), {ep['steps']} steps in "
            f"{ep['seconds']:.3f} s, mean train loss {ep['train_loss']:.6f}, val mAP(medium) "
            f"{val}, wall {t_run:.2f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")
        log(f"[training] files {files}, whitening m {wh['m'].shape} P {wh['P'].shape} | {smi}")
        need = {"latest", "best", "latest.meta.json", "best.meta.json", "whitening.npz",
                "metrics.jsonl"}
        if not (np.isfinite(ep["train_loss"]) and need <= set(files) and ep["steps"] > 0
                and np.isfinite(wh["P"]).all() and wh["P"].shape[1] == wh["m"].shape[0]):
            raise AssertionError("run_training: a non-finite loss or a missing artifact")
        out["run_training"] = {"seconds": t_run, "mining_s": mined["seconds"],
                               "mining_extract_s": mined["seconds_extract"],
                               "mining_search_s": mined["seconds_search"],
                               "steps": ep["steps"], "train_s": ep["seconds"],
                               "train_loss": ep["train_loss"], "val_map_medium": val,
                               "whitening_P": list(wh["P"].shape)}
        paths, clusters, qidxs, pidxs, _, _ = loop._real_or_synthetic_pool(
            args.data_root, n_scenes=TRAIN_SCENES, views=TRAIN_VIEWS, hw=TRAIN_HW)
        torch.cuda.empty_cache()

        # 2. the train-step bench at 362 px
        torch.cuda.reset_peak_memory_stats()
        bench = run_training_bench(
            arch=r["arch"], pooling=r["pooling"], image_size=r["image_size"],
            batch_tuples=r["batch_tuples"], n_neg=r["n_neg"], loss=r["loss"], reps=10,
            warmup=2, pallas=True, device=dev, profile=profile_window)
        peak = torch.cuda.max_memory_allocated()
        prof = bench.pop("profile")
        log(f"[training] run_training_bench {r['arch']} {r['image_size']} px, "
            f"{r['batch_tuples']} tuples x {2 + r['n_neg']} images: step p50 "
            f"{bench['lat_p50_ms']} ms p95 {bench['lat_p95_ms']} ms, {bench['tuples_per_sec']} "
            f"tuples/s, {bench['images_per_sec']} images/s, peak memory {peak / 2**30:.2f} GiB, "
            f"idle share {prof['idle_share']:.4f} over {bench['reps']} profiled steps, "
            f"device ms by group {json.dumps(prof['device_ms_by_group'])} | {smi}")
        out["bench"] = dict(bench, max_memory_allocated=peak, profile=prof)
        torch.cuda.empty_cache()

        # 3. kernel head against plain head on one batch of real tuples, with
        # deterministic cuDNN: its default algorithms alone move resnet101's
        # layer1 weight gradients by ~0.5 of the bound from run to run; fixed,
        # the checks read the kernel head's difference alone, reproducibly
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        cache = loop._ResizedImageCache(paths, r["image_size"])
        hw = loop.probe_bucket_shape(paths, r["image_size"])
        rng = np.random.RandomState(0)
        sel = rng.choice(len(qidxs), r["batch_tuples"], replace=False)
        negs = np.stack([rng.choice(np.flatnonzero(clusters != clusters[qidxs[i]]), r["n_neg"],
                                    replace=False) for i in sel])
        tuples = TupleSet(qidxs=qidxs[sel], pidxs=pidxs[sel], nidxs=negs)
        px, sizes, labels = next(loop.iter_tuple_batches(cache, tuples, r["batch_tuples"], hw))
        cfg = TrainConfig(loss=r["loss"], margin=r["margin"], lr=r["lr"], n_neg=r["n_neg"],
                          batch_tuples=r["batch_tuples"])
        mk = create_train_state(RetrievalNet(arch=r["arch"], use_kernel=True), cfg, seed=0,
                                device=dev)
        mp = create_train_state(RetrievalNet(arch=r["arch"], use_kernel=False), cfg,
                                state_dict=copy.deepcopy(mk.model.state_dict()), device=dev)
        checks = {}
        # masked u8 (gem_l2n_fused_rect), then unmasked f32 through train_epoch (gem_l2n_fused)
        sk, lk = make_train_step(mk.model, cfg, from_u8=True)(mk, px, sizes, labels)
        sp, lp = make_train_step(mp.model, cfg, from_u8=True)(mp, px, sizes, labels)
        checks["u8_masked"] = _grad_check(f"{r['arch']} u8 masked step", smi, mk.model, mp.model,
                                          lk, lp)
        full = np.broadcast_to(np.asarray(hw, np.int32), sizes.shape).copy()
        x, _ = u8_to_input(torch.from_numpy(px).to(dev), torch.from_numpy(full).to(dev))
        mp.model.load_state_dict(mk.model.state_dict())
        _, lk = train_epoch(mk, make_train_step(mk.model, cfg), [(x, labels)])
        _, lp = train_epoch(mp, make_train_step(mp.model, cfg), [(x, labels)])
        checks["f32_unmasked"] = _grad_check(f"{r['arch']} f32 unmasked step (train_epoch)", smi,
                                             mk.model, mp.model, lk, lp)
        # frozen trunk, p trainable: p's gradient through the Function
        for st in (mk, mp):
            st.model.features.requires_grad_(False)
        mp.model.load_state_dict(mk.model.state_dict())
        sk, lk = make_train_step(mk.model, cfg, from_u8=True)(mk, px, sizes, labels)
        sp, lp = make_train_step(mp.model, cfg, from_u8=True)(mp, px, sizes, labels)
        gk, gp = mk.model.pool.p.grad, mp.model.pool.p.grad
        if gk is None or float(gk.abs()) == 0.0:
            raise AssertionError("frozen trunk: p got no gradient through the kernel head")
        checks["frozen_trunk_p"] = _grad_check(f"{r['arch']} frozen trunk, p trainable", smi,
                                               mk.model, mp.model, lk, lp,
                                               params_only={"pool.p"})
        log(f"[training] frozen trunk: p.grad kernel {float(gk):.6e} plain {float(gp):.6e} "
            f"| {smi}")
        out["grad_checks"] = checks
        del mk, mp, sk, sp
        torch.cuda.empty_cache()

        # 4. vgg16 + NetVLAD K=64 (config 3's model), two steps, kernel vs plain
        sgd = TrainConfig(loss=r["loss"], margin=r["margin"], lr=1e-3, optimizer="sgd",
                          momentum=0.9, n_neg=r["n_neg"], batch_tuples=r["batch_tuples"])
        vk = create_train_state(RetrievalNet(arch="vgg16", pooling="netvlad", use_kernel=True),
                                sgd, seed=0, device=dev)
        vp = create_train_state(RetrievalNet(arch="vgg16", pooling="netvlad", use_kernel=False),
                                sgd, state_dict=copy.deepcopy(vk.model.state_dict()), device=dev)
        step_k = make_train_step(vk.model, sgd, from_u8=True)
        step_p = make_train_step(vp.model, sgd, from_u8=True)
        nv = []
        for i in range(2):
            # each step compares at the same weights: one update from the
            # kernel head's gradient (within 0.05 of the bound) leaves weights
            # ~1.5e-8 apart, and vgg16's trunk alone turns that into up to
            # 2.8e-3 of max|g| on the next gradient (~100 ReLU sign flips),
            # plain head against plain head (PERF.md, PR 10)
            vp.model.load_state_dict(vk.model.state_dict())
            t0 = time.perf_counter()
            vk, lk = step_k(vk, px, sizes, labels)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            vp, lp = step_p(vp, px, sizes, labels)
            nv.append(dict(_grad_check(f"vgg16 NetVLAD K=64 step {i + 1}", smi, vk.model,
                                       vp.model, lk, lp), step_s=dt))
        out["vgg16_netvlad"] = nv
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
        del vk, vp
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        log(f"[training] launches {launches} | {smi}")
        for name in ("gem_l2n_fused_rect", "gem_l2n_fused", "scores_blockmax",
                     "netvlad_fused_rect"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the training path")
        # 5. outside the counting window: mining's search at its own shape
        out["mining_check"] = _mining_check(dev, smi, args, paths, clusters, qidxs, pidxs)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_path
    log(f"[training] path D wall {out['wall_s']:.1f} s | {smi}")
    log(json.dumps({"training": out}))
    return launches, out


# Path J: data parallelism over the mesh's data axis. Path D's recipe at full
# width on a global batch of 4 tuples (path D takes 5: the data axis of 2
# must divide the batch), 3 steps
DP_TUPLES, DP_STEPS = 4, 3
DP_WORKER_TIMEOUT = 300  # seconds each worker may take, start-up included
DP_DESC_TOL = 1e-5       # descriptors: the same rows run in batches of 8, not 16
DP_STATS_REL, DP_PARAM_REL = 1e-5, 1e-6  # of each tensor's max|ref|
# gradients and parameters: the bounds above (GRAD_REL, DP_PARAM_REL), or
# this many times the one-process step's own spread when its tuples are
# summed in another order, where that is wider: the same sum in another f32
# order moves resnet101's weight gradients ~1e-4 of max|g| (a 1x1 conv's
# weight gradient sums ~230k products a weight), and Adam's first step
# turns a gradient change of ~eps into a parameter change of ~lr
DP_SPREAD = 2.0
# the update check, which a skipped or doubled optimizer step fails: on the
# weights whose reference gradient is at least DP_DRIVEN x its tensor's
# gradient bound (so its sign and size hold under the spread above), the
# data-parallel update p_after - p_before must lie within DP_UPDATE_REL of
# the reference's update (plus 2 ulps of p); at most DP_UPDATE_SHARE of those
# weights may miss (a skipped or doubled update misses with nearly all)
DP_DRIVEN, DP_UPDATE_REL, DP_UPDATE_SHARE, DP_UPDATE_MIN = 100.0, 0.1, 1e-3, 10000


def dp_tuples(seed=0):
    """Path D's masked u8 tuples at its 362-px bucket, made in memory: q, p
    from one scene, 5 negatives from others, each image max side 362 in a
    288 x 384 bucket (portrait and landscape extents), zeroed padding."""
    import numpy as np

    r = TRAIN_RECIPE
    T = 2 + r["n_neg"]
    rng = np.random.RandomState(seed)
    H, W = 288, 384
    protos = [np.kron(rng.rand(H // 16, W // 16, 3), np.ones((16, 16, 1)))
              for _ in range(DP_TUPLES * T)]
    px = np.zeros((DP_TUPLES, T, H, W, 3), np.uint8)
    sizes = np.zeros((DP_TUPLES, T, 2), np.int32)
    for b in range(DP_TUPLES):
        for t in range(T):
            proto = protos[b * T + (0 if t == 1 else t)]  # the positive views the query's scene
            h, w = ((268, 362), (362 - 74, 362), (240, 320))[(b + t) % 3]
            img = np.roll(proto, rng.randint(-8, 9), axis=1)[:h, :w]
            img = img * (1 + 0.1 * rng.randn()) + 0.05 * rng.randn(h, w, 3)
            px[b, t, :h, :w] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            sizes[b, t] = (h, w)
    labels = np.zeros((DP_TUPLES, T), np.int32)
    labels[:, 1], labels[:, 2:] = 1, -1
    return px, sizes, labels


def _dp_train_cfg():
    from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
        TrainConfig,
    )

    r = TRAIN_RECIPE
    return TrainConfig(loss=r["loss"], margin=r["margin"], lr=r["lr"], n_neg=r["n_neg"],
                       batch_tuples=DP_TUPLES)


def _config2_dp_cfg():
    import dataclasses

    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
        GRADED_CONFIGS,
    )

    graded = GRADED_CONFIGS[2]
    mc = dataclasses.replace(graded.extract.model, use_pallas=True)
    return graded, dataclasses.replace(graded.extract, model=mc, batch_size=16)


def data_parallel_phase(dev, smi, c2=None, main_d=None):
    """Path J. J1, one process on one card: config 2 through
    ``Extractor(mesh=create_mesh([2, 1], devices=[cuda:0, cuda:0]))`` against
    config 2's one-device run (``c2``: its db and query descriptors, else
    made here), and ``Index`` sharded on a 2 x 2 mesh against one device's
    ``Index.query(k=10)``. J2, two processes started from this script: the
    same extraction over the data axis, then path D's recipe for 3 steps on
    4 masked u8 tuples, 2 a process, each step against the same step run
    here first by one process with its BatchNorm on the same path (loss,
    gradients, BN running statistics, parameters after the update, and the
    driven weights' updates). NCCL, one card a
    process, on two or more cards; gloo with both processes on cuda:0 on
    one card."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import image_retrieval_for_image_based_localization_tpu_torch as port
    from image_retrieval_for_image_based_localization_tpu_torch.data.images import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (
        compute_map,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (
        global_batch_stats,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
        RetrievalNet,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
    from image_retrieval_for_image_based_localization_tpu_torch.parallel import (
        ShardedIndex,
        create_mesh,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
        create_train_state,
        make_train_step,
    )

    t_path = time.perf_counter()
    cuda0 = torch.device("cuda", 0)
    graded, cfg = _config2_dp_cfg()
    images, labels, q_u8 = make_corpus()
    q_pixels = ((q_u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(
        np.float32)
    gnd = [{"ok": np.flatnonzero(labels == s)} for s in range(len(q_u8))]
    if c2 is None:  # config 2's one-device run, when path J runs alone
        one = port.Extractor(cfg, seed=0, device=dev)
        c2 = one.extract(images), one(q_pixels)
        del one
    db1, qd1 = c2
    out = {}

    # J1: the data axis in one process, both shards on cuda:0
    mesh21 = create_mesh([2, 1], devices=[cuda0, cuda0])
    ex = port.Extractor(cfg, seed=0, mesh=mesh21)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    db = ex.extract(images)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    qd = ex(q_pixels)
    index1 = port.build_index(db1, graded.index, device=dev)
    s1, i1 = index1.query(qd1, k=10)
    sq, iq = index1.query(qd, k=10)
    index = port.build_index(db, graded.index, device=dev)
    map1, map_dp = compute_map(index1.ranks(qd1), gnd)[0], compute_map(index.ranks(qd), gnd)[0]
    mesh22 = create_mesh([2, 2], devices=[cuda0] * 4)
    sindex = ShardedIndex.from_index(index1, mesh=mesh22)
    ss, si = sindex.query(qd1, k=10)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    d_db, d_q = float(np.abs(db - db1).max()), float(np.abs(qd - qd1).max())
    top_ok = _agree_where_separated(sq, iq, s1, i1, tol=DP_DESC_TOL, score_tol=2 * DP_DESC_TOL)
    shard_ok = bool(np.array_equal(si, i1))
    log(f"[data parallel] J1: config 2 on a {mesh21.shape} mesh, both shards on cuda:0 (batch "
        f"{ex.cfg.batch_size}, 8 rows a shard): {len(images) / t_extract:.2f} img/s "
        f"({t_extract:.2f} s); descriptors vs config 2's one-device run max|diff| db "
        f"{d_db:.3e} queries {d_q:.3e} (gate {DP_DESC_TOL}); query top-10 on config 2's "
        f"index equal outside ties within {DP_DESC_TOL}: {top_ok}; mAP {map_dp:.4f} (one "
        f"device {map1:.4f}); Index on a {mesh22.shape} mesh (4 shards on cuda:0, 2 gallery "
        f"shards searched) top-10 ids bit for bit one device's: {shard_ok}, scores max|diff| "
        f"{float(np.abs(ss - s1).max()):.3e}; launches {launches} | {smi}")
    if max(d_db, d_q) > DP_DESC_TOL or not top_ok or map_dp != map1 or not shard_ok:
        raise AssertionError("[data parallel] J1 disagrees with one device")
    for name in ("gem_l2n_fused_rect", "gem_l2n_fused", "fused_topk_search", "scores_blockmax"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on path J1")
    out["j1"] = {"extract_img_per_s": len(images) / t_extract, "db_max_abs_diff": d_db,
                 "queries_max_abs_diff": d_q, "map": map_dp, "map_one_device": map1,
                 "sharded_ids_equal": shard_ok}
    del ex, index, index1, sindex
    torch.cuda.empty_cache()

    # J2: the reference steps in this process, then two worker processes
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 2 else "gloo"
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        np.save(os.path.join(ref_dir, "j1_db.npy"), db)
        px, sizes, tl = dp_tuples()
        np.savez(os.path.join(ref_dir, "tuples.npz"), px=px, sizes=sizes, labels=tl)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        r = TRAIN_RECIPE
        cfg_t = _dp_train_cfg()
        # one process on the whole batch, its BatchNorm on the workers' path
        # (split-invariant float64 sums) over a group of one: no collective
        state = create_train_state(RetrievalNet(arch=r["arch"], use_kernel=True), cfg_t, seed=0,
                                   device=dev)
        step = make_train_step(state.model, cfg_t, from_u8=True)
        torch.save(state.model.state_dict(), os.path.join(ref_dir, "start1.pt"))
        ref_ms = []
        for i in range(1, DP_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with global_batch_stats(None):
                _, loss = step(state, px, sizes, tl)
            torch.cuda.synchronize()
            ref_ms.append((time.perf_counter() - t0) * 1e3)
            torch.save({"loss": float(loss),
                        "grads": {n: p.grad for n, p in state.model.named_parameters()
                                  if p.grad is not None},
                        "after": state.model.state_dict()},
                       os.path.join(ref_dir, f"step{i}.pt"))
        del state, step
        torch.cuda.empty_cache()
        # the one-process step's own spread: the same steps with the tuples
        # in reverse order, each from the reference's weights
        start = torch.load(os.path.join(ref_dir, "start1.pt"))
        ctrl = create_train_state(RetrievalNet(arch=r["arch"], use_kernel=True), cfg_t,
                                  state_dict=start, device=dev)
        step = make_train_step(ctrl.model, cfg_t, from_u8=True)
        rev = np.arange(DP_TUPLES)[::-1]
        spread = []
        for i in range(1, DP_STEPS + 1):
            if i > 1:
                start = ref["after"]
                ctrl.model.load_state_dict(start)
            with global_batch_stats(None):
                _, loss = step(ctrl, px[rev], sizes[rev], tl[rev])
            ref = torch.load(os.path.join(ref_dir, f"step{i}.pt"), map_location=dev)
            spread.append(_step_errors(ctrl.model, loss, ref, start))
        worst = {k: max(x[k] for x in spread) for k in ("loss_rel", "grad_worst", "stats_worst",
                                                         "param_worst", "update_miss_share")}
        with open(os.path.join(ref_dir, "spread.json"), "w") as f:
            json.dump(worst, f)
        del ctrl, step, ref
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[data parallel] J2 the one-process step against itself with its tuples in "
            f"reverse order, worst over {DP_STEPS} steps: loss rel {worst['loss_rel']:.2e}, "
            f"err/bound gradients {worst['grad_worst']:.3f} (by step "
            f"{[round(x['grad_worst'], 3) for x in spread]}, "
            f"{spread[-1]['grad_worst_name']}), BN statistics {worst['stats_worst']:.3f}, "
            f"parameters {worst['param_worst']:.3f} (by step "
            f"{[round(x['param_worst'], 3) for x in spread]}), updates missing the "
            f"reference's by more than {DP_UPDATE_REL} {worst['update_miss_share']:.2e} of "
            f"{min(x['update_driven'] for x in spread)}+ driven weights | {smi}")
        log(f"[data parallel] J2 reference: {r['arch']} + GeM kernel head, {DP_TUPLES} tuples "
            f"x {2 + r['n_neg']} images at {px.shape[2]}x{px.shape[3]} (max side "
            f"{r['image_size']}), one process, BN on the data-parallel path over a group of "
            f"one, step ms {[round(t, 2) for t in ref_ms]}; "
            f"spawning 2 workers: backend {backend}, {n_cards} card(s) | {smi}")
        port_no = _free_port()
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker",
                                   str(rank), str(port_no), ref_dir, backend],
                                  cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for rank in (0, 1)]
        deadline = time.perf_counter() + DP_WORKER_TIMEOUT
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
        except subprocess.TimeoutExpired:
            raise AssertionError(f"[data parallel] a worker outlived {DP_WORKER_TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for rank, (p, text) in enumerate(zip(procs, outs)):
            for line in text.splitlines():
                log(f"[dp worker {rank}] {line}")
            if p.returncode != 0:
                raise AssertionError(f"[data parallel] worker {rank} exited {p.returncode}")
            results.append(next(json.loads(line)["dp_worker"] for line in text.splitlines()
                                if line.startswith('{"dp_worker"')))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
        shutil.rmtree(ref_dir, ignore_errors=True)
    p50 = [w["step_ms_p50"] for w in results]
    d_p50 = None if main_d is None else main_d["bench"]["lat_p50_ms"]
    d_tps = None if main_d is None else main_d["bench"]["tuples_per_sec"]
    log(f"[data parallel] J2 ({backend}, {n_cards} card(s), 2 processes"
        f"{' sharing cuda:0' if backend == 'gloo' else ', one card each'}): DP step p50 "
        f"{p50} ms ({[round(DP_TUPLES / t * 1e3, 2) for t in p50]} tuples/s, {DP_TUPLES} "
        f"tuples a step); one process on the same tuples "
        f"{round(statistics.median(ref_ms), 2)} ms; path D (5 tuples, one process) p50 {d_p50} ms, {d_tps} tuples/s; worst "
        f"err/bound over steps: loss {max(w['loss_rel'] for w in results) / LOSS_REL:.3f}, "
        f"gradients {max(w['grad_worst'] for w in results):.3f}, BN statistics "
        f"{max(w['stats_worst'] for w in results):.3f}, parameters "
        f"{max(w['param_worst'] for w in results):.3f} (gates "
        f"{results[0]['grad_gate']:.3f} and {results[0]['param_gate']:.3f}: the bounds, or "
        f"{DP_SPREAD} x the one-process spread), updates missing the reference's "
        f"{max(w['update_miss_share'] for w in results):.2e} of the driven weights (gate "
        f"{DP_UPDATE_SHARE}); extraction vs J1 "
        f"{max(w['extract_max_abs_diff'] for w in results):.3e} | {smi}")
    out["j2"] = {"backend": backend, "cards": n_cards, "workers": results,
                 "one_process_spread": worst,
                 "reference_step_ms": ref_ms, "path_d_step_p50_ms": d_p50,
                 "path_d_tuples_per_sec": d_tps}
    out["wall_s"] = time.perf_counter() - t_path
    log(f"[data parallel] path J wall {out['wall_s']:.1f} s | {smi}")
    log(json.dumps({"data_parallel": out}))
    return kernels.launch_counts(), out


def _worst_over(got: dict, want: dict, rel: float, atol: float = 0.0):
    """(max over tensors of max|got - want| / max(rel * max|want|, atol), its name)."""
    worst, name = 0.0, None
    for k, w in want.items():
        bound = max(rel * w.abs().max().item(), atol)
        err = (got[k].to(w.device) - w).abs().max().item()
        ratio = err / bound if bound > 0 else (0.0 if err == 0 else float("inf"))
        if ratio > worst:
            worst, name = ratio, k
    return worst, name


def _update_misses(named: dict, ref: dict, start: dict):
    """(share of the driven weights whose update misses the reference's,
    their count): driven weights have a reference gradient of at least
    DP_DRIVEN x their tensor's gradient bound; an update p_after - p_before
    misses where it is further than DP_UPDATE_REL x the reference's update
    plus 2 ulps of p from it. ``start``: the weights before the step."""
    import torch

    missed = driven = 0
    for n, g in ref["grads"].items():
        bound = max(GRAD_REL * g.abs().max().item(), GRAD_ATOL)
        sel = g.abs() >= DP_DRIVEN * bound
        if not bool(sel.any()):
            continue
        before = start[n].to(g.device)[sel]
        want = ref["after"][n][sel] - before
        got = named[n].detach()[sel] - before
        ulp = torch.abs(torch.nextafter(ref["after"][n][sel], torch.full_like(want, float("inf")))
                        - ref["after"][n][sel])
        missed += int(((got - want).abs() > DP_UPDATE_REL * want.abs() + 2 * ulp).sum())
        driven += int(sel.sum())
    return missed / max(driven, 1), driven


def _step_errors(model, loss, ref, start) -> dict:
    """One train step against the reference's (``ref``: its loss, gradients
    and state after the step; ``start``: the weights both began it from):
    the loss's relative error and the worst err/bound of the gradients, the
    BN running statistics and the parameters after the update, each tensor
    against its own max, and the updates' check (:func:`_update_misses`)."""
    named = dict(model.named_parameters())
    g, g_name = _worst_over({n: named[n].grad for n in ref["grads"]}, ref["grads"], GRAD_REL,
                            GRAD_ATOL)
    miss, driven = _update_misses(named, ref, start)
    sd = model.state_dict()
    stats = {k: v for k, v in ref["after"].items() if k.endswith(("running_mean",
                                                                  "running_var"))}
    st, _ = _worst_over({k: sd[k] for k in stats}, stats, DP_STATS_REL)
    p, p_name = _worst_over({n: named[n].detach() for n in named},
                            {n: ref["after"][n] for n in named}, DP_PARAM_REL)
    return {"loss": float(loss), "loss_ref": ref["loss"],
            "loss_rel": abs(float(loss) - ref["loss"]) / max(abs(ref["loss"]), 1e-30),
            "grad_worst": g, "grad_worst_name": g_name, "stats_worst": st, "param_worst": p,
            "param_worst_name": p_name, "update_miss_share": miss, "update_driven": driven}


def dp_worker(rank: int, port_no: int, ref_dir: str, backend: str) -> int:
    """One process of path J2: joins the group, extracts config 2's corpus
    over the data axis, then runs the 3 reference steps data-parallel,
    holding each against the reference (each step starts from the
    reference's weights: after an update the two sides' weights differ in
    their last bits, which ReLU and max-pool near-ties amplify on the next
    gradient). Prints one ``{"dp_worker": ...}`` line; raises on a failed
    gate."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch
    import torch.distributed as dist
    import image_retrieval_for_image_based_localization_tpu_torch as port
    from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
        RetrievalNet,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
    from image_retrieval_for_image_based_localization_tpu_torch.parallel import create_mesh
    from image_retrieval_for_image_based_localization_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
        create_train_state,
        make_train_step,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    if not initialize_distributed(f"127.0.0.1:{port_no}", num_processes=2, process_id=rank,
                                  device="cuda", backend=backend):
        raise RuntimeError("the process group did not form")
    dev = resolve_device("cuda")
    card = torch.device("cuda", torch.cuda.current_device())
    log(f"rank {rank} of {dist.get_world_size()}, backend {dist.get_backend()}, on {card} "
        f"({torch.cuda.get_device_name(card)}), {torch.cuda.device_count()} card(s)")
    mesh = create_mesh([2, 1], devices=[card])
    kernels.reset_launch_counts()

    graded, cfg = _config2_dp_cfg()
    images = make_corpus()[0]
    ex = port.Extractor(cfg, seed=0, mesh=mesh)
    t0 = time.perf_counter()
    db = ex.extract(images)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    d_ext = float(np.abs(db - np.load(os.path.join(ref_dir, "j1_db.npy"))).max())
    log(f"extraction over the data axis: {len(images)} images in {t_extract:.2f} s, "
        f"max|diff| to J1 {d_ext:.3e} (gate {DP_DESC_TOL})")
    if d_ext > DP_DESC_TOL:
        raise AssertionError("data-parallel extraction disagrees with J1")
    del ex
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    z = np.load(os.path.join(ref_dir, "tuples.npz"))
    px, sizes, labels = z["px"], z["sizes"], z["labels"]
    cfg_t = _dp_train_cfg()
    r = TRAIN_RECIPE
    start = torch.load(os.path.join(ref_dir, "start1.pt"), map_location=card)
    state = create_train_state(RetrievalNet(arch=r["arch"], use_kernel=True), cfg_t,
                               state_dict=start, device=dev, mesh=mesh)
    step = make_train_step(state.model, cfg_t, mesh=mesh, from_u8=True)
    ms, rows = [], []
    for i in range(1, DP_STEPS + 1):
        if i > 1:  # each step from the reference's weights
            state.model.load_state_dict(start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = step(state, px, sizes, labels)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        ref = torch.load(os.path.join(ref_dir, f"step{i}.pt"), map_location=card)
        rows.append(dict(_step_errors(state.model, loss, ref, start), step=i, ms=ms[-1]))
        x = rows[-1]
        log(f"step {i}: loss {x['loss']:.8f} (one process {x['loss_ref']:.8f}, rel "
            f"{x['loss_rel']:.2e}); err/bound gradients {x['grad_worst']:.3f} "
            f"({x['grad_worst_name']}), BN statistics {x['stats_worst']:.3f}, parameters "
            f"{x['param_worst']:.3f} ({x['param_worst_name']}), updates missing the "
            f"reference's {x['update_miss_share']:.2e} of {x['update_driven']} driven weights; "
            f"{ms[-1]:.1f} ms")
        start = ref["after"]
        del ref
    launches = kernels.launch_counts()
    res = {"rank": rank, "backend": dist.get_backend(), "cards": torch.cuda.device_count(),
           "device": str(card), "extract_s": t_extract, "extract_max_abs_diff": d_ext,
           "steps": rows, "step_ms_p50": statistics.median(ms),
           "loss_rel": max(x["loss_rel"] for x in rows),
           "grad_worst": max(x["grad_worst"] for x in rows),
           "stats_worst": max(x["stats_worst"] for x in rows),
           "param_worst": max(x["param_worst"] for x in rows),
           "update_miss_share": max(x["update_miss_share"] for x in rows),
           "update_driven": min(x["update_driven"] for x in rows), "launches": launches}
    with open(os.path.join(ref_dir, "spread.json")) as f:
        spread = json.load(f)
    res["grad_gate"] = max(1.0, DP_SPREAD * spread["grad_worst"])
    res["param_gate"] = max(1.0, DP_SPREAD * spread["param_worst"])
    print(json.dumps({"dp_worker": res}), flush=True)
    dist.destroy_process_group()
    if launches["gem_l2n_fused_rect"] <= 0:
        raise AssertionError("kernel B1 (gem_l2n_fused_rect) was not launched in this worker")
    if (res["loss_rel"] > LOSS_REL or res["grad_worst"] > res["grad_gate"]
            or res["stats_worst"] > 1.0 or res["param_worst"] > res["param_gate"]
            or res["update_miss_share"] > DP_UPDATE_SHARE
            or res["update_driven"] < DP_UPDATE_MIN):
        raise AssertionError(f"the data-parallel step disagrees with the one-process step "
                             f"(gates: gradients {res['grad_gate']:.3f}, parameters "
                             f"{res['param_gate']:.3f} of their bounds; updates missing "
                             f"{res['update_miss_share']:.2e} of {res['update_driven']} "
                             f"driven weights, gate {DP_UPDATE_SHARE})")
    return 0


# path K: the tooling (fullsystem, parity, the CLI's download and --network,
# debug checks); K1 and K2 at config 2's model
# K1-K3's model (config 2's: resnet50 + GeM at 1024 px, batch 16); K1's
# corpus: JPEGs of 1200 x 1600, quality 90; K3's `fullsystem --n-images`
TOOLING = dict(arch="resnet50", image_size=1024, batch_size=16, jpegs=64, cli_jpegs=16)
BF16_TOL = 1e-2           # bf16 descriptors against their reference, and cosine
BF16_COS = 0.999
STRESS_COS_MIN = 0.99     # K2: bucketed against exact on the stress set


def _named_launches(events):
    """The GeM launches a profiler recorded: the ranges the wrapper names
    after its entry point (host side), and ``gem_l2n_kernel`` on the card."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name for e in events if e.device_type != cuda]
    return {"gem_l2n_fused_rect": names.count("gem_l2n_fused_rect"),
            "gem_l2n_fused": names.count("gem_l2n_fused"),
            "gem_l2n_kernel_on_card": sum(
                1 for e in events if e.device_type == cuda and "gem_l2n_kernel" in e.name
                and not getattr(e, "is_user_annotation", False))}


def _local_corpus_server(root):
    """``tests/test_download.py``'s layout on a localhost HTTP server: a jpg
    tarball and a gnd pickle (a four-image dataset, ``minik``); returns the
    server and its base URL."""
    import http.server
    import pickle
    import tarfile
    import threading

    import numpy as np
    from PIL import Image

    jpgdir = os.path.join(root, "stage", "jpg")
    os.makedirs(jpgdir)
    rng = np.random.RandomState(0)
    names = [f"img_{i}" for i in range(4)]
    for n in names:
        Image.fromarray((rng.rand(32, 48, 3) * 255).astype(np.uint8)).save(
            os.path.join(jpgdir, f"{n}.jpg"))
    with tarfile.open(os.path.join(root, "images.tgz"), "w:gz") as tf:
        tf.add(jpgdir, arcname="jpg")
    gnd = {"imlist": names[:3], "qimlist": names[3:],
           "gnd": [{"easy": np.array([0]), "hard": np.array([1]), "junk": np.array([2]),
                    "bbx": np.array([0, 0, 20, 20])}]}
    with open(os.path.join(root, "gnd_minik.pkl"), "wb") as f:
        pickle.dump(gnd, f)

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                          lambda *a, **kw: Quiet(*a, directory=root, **kw))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def tooling_phase(dev, smi):
    """Path K: the tooling on the card, in its own launch-count window.

    K1. benchmarks.run_full_system_bench at config 2's model (resnet50 +
        GeM, 1024 px, batch 16; bf16 with the kernel head, as on every
        card) on 64 JPEGs of 1200 x 1600 inside utils.metrics.profile_trace:
        decode img/s per thread count, device img/s, end-to-end img/s,
        overlap_efficiency; the GeM launches the trace names against the
        wrapper's counts; then, on the first 16 JPEGs, the extractor's host
        pipeline alone (img/s), one end-to-end extraction under
        profile_trace and under profile_window (idle shares side by side),
        and the batch through the kernel head against the plain head
        (1e-2, cosine 0.999);
    K2. benchmarks.measure_bucketing_delta with resnet50 at 1024 px, f32,
        kernel head, under profile_trace (B1 and B2 launches from its
        events), beside the same function on the CPU on the same seeded
        weights; gate: stress cos_min >= 0.99;
    K3. cli.main on the card: fullsystem --n-images 16 and parity; download
        of a dataset and extract --network of a cirtorch-layout resnet50 +
        GeM, both from a localhost HTTP server, the descriptors against
        --checkpoint on the same weights (1e-5); each returns 0;
    K4. utils.debug: x / x on zeros raises FloatingPointError on the card;
        one extraction batch through the kernel head passes
        assert_deterministic inside debug_checks.
    Every failed check is collected and the phase raises after K4."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    import image_retrieval_for_image_based_localization_tpu_torch as port
    import image_retrieval_for_image_based_localization_tpu_torch.data.download as dl
    from image_retrieval_for_image_based_localization_tpu_torch.benchmarks import (
        measure_bucketing_delta,
        run_full_system_bench,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.cli import main as cli_main
    from image_retrieval_for_image_based_localization_tpu_torch.models import (
        RetrievalNet,
        init_random_,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
        _CIRTORCH_SEQ_NAMES,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
    from image_retrieval_for_image_based_localization_tpu_torch.utils.debug import (
        assert_deterministic,
        debug_checks,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import (
        MetricsLogger,
        profile_trace,
    )

    K = TOOLING
    t_path = time.perf_counter()
    out, fails = {}, []
    tmp = tempfile.mkdtemp(prefix="tooling_")
    quiet = MetricsLogger()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        # K1: decode, device and end to end at config 2's model
        root = os.path.join(tmp, "fullsys")
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        with profile_trace(os.path.join(tmp, "trace")) as prof:
            fs = run_full_system_bench(n_images=K["jpegs"], image_size=K["image_size"],
                                       arch=K["arch"], batch_size=K["batch_size"], root=root,
                                       device=dev, logger=quiet)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        counted = {k: v - before[k] for k, v in kernels.launch_counts().items()
                   if k.startswith("gem_l2n")}
        traced = _named_launches(prof.events())
        bench_trace = device_summary(prof.events(), wall_ms)
        trace_mb = os.path.getsize(prof.trace_path) / 1e6
        log(f"[tooling K1] run_full_system_bench {K['arch']} + GeM, {K['image_size']} px, batch "
            f"{K['batch_size']}, bf16, kernel head, {K['jpegs']} JPEGs 1200 x 1600 "
            f"({fs['jpeg_mb']} MB), native "
            f"decode {fs['native']}: decode img/s by threads {json.dumps(fs['decode_img_per_sec'])}"
            f", device {fs['device_img_per_sec']} img/s, end to end {fs['e2e_img_per_sec']} "
            f"img/s, overlap_efficiency {fs['overlap_efficiency']} | {smi}")
        log(f"[tooling K1] profile_trace over the bench ({wall_ms / 1e3:.1f} s, trace "
            f"{trace_mb:.1f} MB): launches named in the trace {json.dumps(traced)}, counted by "
            f"the wrappers {json.dumps(counted)}; card busy {bench_trace['busy_ms']:.1f} ms, idle "
            f"share {bench_trace['idle_share']} | {smi}")
        if (traced["gem_l2n_fused_rect"], traced["gem_l2n_fused"]) != \
                (counted["gem_l2n_fused_rect"], counted["gem_l2n_fused"]) or \
                traced["gem_l2n_kernel_on_card"] != sum(counted.values()) or \
                counted["gem_l2n_fused_rect"] == 0:
            fails.append(f"K1: GeM launches in the trace {traced} against the wrappers' "
                         f"{counted}")
        if not fs["e2e_img_per_sec"] > 0 or not fs["device_img_per_sec"] > 0:
            fails.append(f"K1: rates {fs}")
        out["fullsystem"] = dict(fs, trace_launches=traced, wrapper_launches=counted,
                                 trace_idle_share=bench_trace["idle_share"])

        # one batch's worth of the corpus: the host pipeline alone, then one
        # end-to-end extraction under each profiler
        cfg = port.ExtractConfig(model=port.ModelConfig(arch=K["arch"], dtype="bfloat16",
                                                        use_pallas=True),
                                 image_size=K["image_size"], batch_size=K["batch_size"])
        ex = port.Extractor(cfg, device=dev)
        paths = sorted(os.path.join(root, f) for f in os.listdir(root))[:K["batch_size"]]
        t0 = time.perf_counter()
        for _ in ex.make_input_batches(paths):
            pass
        host_rate = len(paths) / (time.perf_counter() - t0)
        ex.extract(paths)  # warm
        t0 = time.perf_counter()
        with profile_trace(os.path.join(tmp, "trace")) as prof:
            ex.extract(paths)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_trace = device_summary(prof.events(), wall_ms)
        by_window = profile_window(lambda: ex.extract(paths))
        log(f"[tooling K1] {len(paths)} of the JPEGs: the extractor's host pipeline alone "
            f"({'native' if fs['native'] else 'PIL'} decode and resize, the prefetch thread's "
            f"work) {host_rate:.2f} img/s; one end-to-end extraction: profile_trace idle share "
            f"{by_trace['idle_share']} (busy {by_trace['busy_ms']:.1f} of "
            f"{by_trace['wall_ms']:.1f} ms), profile_window idle share "
            f"{by_window['idle_share']} (busy {by_window['busy_ms']:.1f} of "
            f"{by_window['wall_ms']:.1f} ms); device ms by group (trace) "
            f"{json.dumps(by_trace['device_ms_by_group'])} | {smi}")
        if by_trace["idle_share"] is None or by_window["idle_share"] is None:
            fails.append("K1: a profiler recorded no kernel on the card")
        out["e2e_profiles"] = {"profile_trace": by_trace, "profile_window": by_window,
                               "host_pipeline_img_per_s": host_rate}

        # one batch: the kernel head against the plain head
        batch = next(iter(ex.make_input_batches(paths)))
        px = torch.from_numpy(batch.pixels_u8).to(dev)
        sz = torch.from_numpy(batch.sizes).to(dev)
        with _uncounted():
            got = ex.forward_u8(px, sz).cpu().numpy()
        ex.model.use_kernel = False
        want = ex.forward_u8(px, sz).cpu().numpy()
        ex.model.use_kernel = True
        err = float(np.abs(got - want).max())
        cos = float(np.min(np.sum(got * want, axis=1)))
        log(f"[tooling K1] B1 on a {list(px.shape)} batch against the plain "
            f"head: max|err| {err:.3e}, min cosine {cos:.7f} (gates {BF16_TOL}, {BF16_COS}) "
            f"| {smi}")
        if not (err <= BF16_TOL and cos >= BF16_COS):
            fails.append(f"K1: kernel head vs plain head {err}, cosine {cos}")
        out["b1_err"] = err

        # K4 first half, on K1's extractor: determinism of the kernel head
        # under the debug checks (the second run is the first one's reference)
        t0 = time.perf_counter()
        with debug_checks():
            assert_deterministic(ex.forward_u8, px, sz)
        log(f"[tooling K4] assert_deterministic(forward_u8) inside debug_checks on one "
            f"bf16 kernel-head batch: passed in {time.perf_counter() - t0:.2f} s | {smi}")
        del ex

        # K2: bucketed against exact, f32, the kernel head on the card
        syn = os.path.join(tmp, "synth")
        before = kernels.launch_counts()
        with profile_trace(os.path.join(tmp, "trace")) as prof:
            bd = measure_bucketing_delta(arch=K["arch"], image_size=K["image_size"],
                                         synth_root=syn, logger=quiet, device=dev)
            torch.cuda.synchronize()
        counted = {k: v - before[k] for k, v in kernels.launch_counts().items()
                   if k.startswith("gem_l2n")}
        traced = _named_launches(prof.events())
        bd_cpu = measure_bucketing_delta(arch=K["arch"], image_size=K["image_size"],
                                         synth_root=syn, logger=quiet, device="cpu")
        log(f"[tooling K2] measure_bucketing_delta {K['arch']}, {K['image_size']} px, f32, "
            f"kernel head: card "
            f"{json.dumps(bd)}; the CPU (plain head, same seeded weights) {json.dumps(bd_cpu)}; "
            f"launches named in the trace {json.dumps(traced)}, counted {json.dumps(counted)} "
            f"| {smi}")
        if not bd["stress_cos_min"] >= STRESS_COS_MIN:
            fails.append(f"K2: stress cos_min {bd['stress_cos_min']} < {STRESS_COS_MIN}")
        if traced["gem_l2n_fused_rect"] != counted["gem_l2n_fused_rect"] or \
                counted["gem_l2n_fused_rect"] == 0:
            fails.append(f"K2: GeM launches in the trace {traced} against {counted}")
        out["bucketing_delta"] = dict(bd, cpu=bd_cpu, trace_launches=traced)

        # K3: the CLI on the card
        rcs = {}
        model = ["--arch", K["arch"], "--image-size", str(K["image_size"]), "--device",
                 str(dev)]
        for name, argv in (
                ("fullsystem", ["fullsystem", "--n-images", str(K["cli_jpegs"]), "--root", root,
                                "--batch-size", str(K["batch_size"])]),
                ("parity", ["parity", "--synth-root", syn])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rcs[name] = cli_main(argv + model)
            last = buf.getvalue().strip().splitlines()[-1]
            log(f"[tooling K3] cli {' '.join(argv[:3])} {' '.join(model)}: rc {rcs[name]} in "
                f"{time.perf_counter() - t0:.1f} s, {last} | {smi}")
        served = os.path.join(tmp, "served")
        os.makedirs(served)
        srv, url = _local_corpus_server(served)
        net = RetrievalNet(K["arch"], "gem")
        init_random_(net, torch.Generator().manual_seed(5))
        seq = _CIRTORCH_SEQ_NAMES["resnet"]
        cirtorch = {}
        for k, v in net.state_dict().items():
            parts = k.split(".")
            if parts[0] == "features":
                parts[1] = str(seq.index(parts[1]))
            cirtorch[".".join(parts)] = v
        torch.save({"state_dict": cirtorch, "meta": {"architecture": K["arch"],
                                                     "pooling": "gem"}},
                   os.path.join(served, "fake-net.pth"))
        plain_pth = os.path.join(tmp, "plain.pth")
        torch.save(net.state_dict(), plain_pth)
        data = os.path.join(tmp, "data")
        saved = (dict(dl.TEST_MANIFESTS), dict(dl.ZOO_MANIFESTS), os.environ.get("IRTPU_OFFLINE"))
        os.environ.pop("IRTPU_OFFLINE", None)
        dl.TEST_MANIFESTS["minik"] = dl.DatasetManifest("minik", artifacts=(
            dl.Artifact(f"{url}/images.tgz", "minik/jpg", extract=True, members_strip=1),
            dl.Artifact(f"{url}/gnd_minik.pkl", "minik/gnd_minik.pkl")),
            required=("minik/gnd_minik.pkl", "minik/jpg"))
        dl.ZOO_MANIFESTS["fake-net"] = dl.Artifact(f"{url}/fake-net.pth",
                                                   "networks/fake-net.pth")
        try:
            # the fetch's progress lines go to a buffer
            with contextlib.redirect_stdout(io.StringIO()):
                rcs["download"] = cli_main(["download", "minik", "--data-root", data])
                jpgs = sorted(os.path.join(data, "minik", "jpg", f)
                              for f in os.listdir(os.path.join(data, "minik", "jpg")))
                descs = {}
                for tag, flags in (("network", ["--network", "fake-net", "--arch", "vgg16"]),
                                   ("checkpoint", ["--checkpoint", plain_pth, "--arch",
                                                   K["arch"]])):
                    path = os.path.join(tmp, f"{tag}.npy")
                    rcs[f"extract --{tag}"] = cli_main(
                        ["extract", "--images", *jpgs, "--out", path, "--data-root", data,
                         "--pallas", "--device", str(dev), *flags])
                    descs[tag] = np.load(path)
        finally:
            dl.TEST_MANIFESTS.clear()
            dl.TEST_MANIFESTS.update(saved[0])
            dl.ZOO_MANIFESTS.clear()
            dl.ZOO_MANIFESTS.update(saved[1])
            if saved[2] is not None:
                os.environ["IRTPU_OFFLINE"] = saved[2]
            srv.shutdown()
            srv.server_close()
        d_net = descs["network"]
        net_err = float(np.abs(d_net - descs["checkpoint"]).max())
        log(f"[tooling K3] cli download minik (localhost HTTP): rc {rcs['download']}, "
            f"{len(jpgs)} images; extract --network fake-net (a cirtorch-layout {K['arch']} + "
            f"GeM fetched into --data-root; --arch vgg16 overridden by its meta) --pallas "
            f"--device {dev}: rc {rcs['extract --network']}, descriptors {d_net.shape}, "
            f"max|diff| to --checkpoint on the same weights {net_err:.3e}; return codes "
            f"{json.dumps(rcs)} | {smi}")
        if any(rc != 0 for rc in rcs.values()):
            fails.append(f"K3: return codes {rcs}")
        if d_net.shape != (len(jpgs), net.out_dim) or not np.isfinite(d_net).all() or \
                net_err > GEM_TOL:
            fails.append(f"K3: --network descriptors {d_net.shape}, {net_err} from --checkpoint")
        out["cli"] = {"return_codes": rcs, "network_vs_checkpoint": net_err}

        # K4, second half: a NaN on the card stops at its operator
        z = torch.zeros(4, device=dev)
        try:
            with debug_checks():
                z / z
            fails.append("K4: x / x on zeros inside debug_checks did not raise")
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        log(f"[tooling K4] debug_checks: x / x on zeros on the card raised FloatingPointError "
            f"({raised}) | {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = kernels.launch_counts()
    out["wall_s"] = time.perf_counter() - t_path
    log(f"[tooling] path K launches {json.dumps(launches)}, wall {out['wall_s']:.1f} s | {smi}")
    if fails:
        raise AssertionError("path K: " + "; ".join(fails))
    return launches, out


def cudnn_bf16_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """The bf16 bottleneck's library yardstick: a function running cuDNN's
    three bf16 convolutions (channels_last) with bias and ReLU and the skip
    added, on a bf16 NHWC x. They round before the bias, so they are a
    time, not a reference."""
    import torch

    xc = x.permute(0, 3, 1, 2)
    lw = [w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
          for w in (w1.t()[:, :, None, None], w2.permute(3, 2, 0, 1), w3.t()[:, :, None, None])]
    lb = [b.to(torch.bfloat16) for b in (b1, b2, b3)]

    def library():
        y = torch.relu(torch.nn.functional.conv2d(xc, lw[0], lb[0]))
        y = torch.relu(torch.nn.functional.conv2d(y, lw[1], lb[1], padding=1))
        return torch.relu(torch.nn.functional.conv2d(y, lw[2], lb[2]) + xc)

    return library


def timing_phase(dev, gem_in, nv_in, adc_in, launches, errs, bn16_shares):
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        adc_scores,
        adc_scores_plain,
        blockmax_topk_search,
        bottleneck_fused,
        bottleneck_plain,
        fused_topk_plain,
        fused_topk_search,
        gem_l2n_fused,
        gem_l2n_fused_rect,
        gem_l2n_plain,
        netvlad_fused,
        netvlad_fused_rect,
        netvlad_plain,
        pack_bf16,
        scores_blockmax,
        scores_blockmax_plain,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        adc,
        gem_l2n as gem_mod,
    )

    x, p, sizes = gem_in["x"], gem_in["p"], gem_in["sizes"]
    B, H, W, C = x.shape
    out_bytes = B * C * 4
    rows = []

    def row(name, src, replaces, ms, plain_ms, byts, flops, library_ms, lookups=0,
            tf32x3_flops=0, bf16_flops=0, **extra):
        # operations: f32 FMA work at the f32 rate, shared-memory lookups at
        # the lookup rate, 3xTF32 work as three TF32 tensor-core flop each, or
        # bf16 tensor-core work at the bf16 rate, whichever takes longer
        t_bytes = byts / HBM_BYTES_PER_S * 1e3
        t_ops = max(flops / F32_FLOP_PER_S, lookups / SMEM_LOOKUPS_PER_S,
                    3 * tf32x3_flops / TF32_FLOP_PER_S, bf16_flops / BF16_FLOP_PER_S) * 1e3
        r = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
             "launches": launches[name],
             "max_abs_err": errs[name], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms}
        if tf32x3_flops:
            r["bound_note"] = "3xTF32 on the tensor cores at 495 TFLOP/s, or the bytes"
        if bf16_flops:
            r["bound_note"] = "bf16 on the tensor cores at 989 TFLOP/s, or the bytes"
        r.update(extra)
        log(json.dumps({"kernel_timing": r}))
        rows.append(r)

    src_gem = CSRC + "gem_l2n.cu"
    valid = gem_in["valid_positions"]

    def gem_bytes(xg, valid_g, rect):
        """Bytes and ~4 ops an element: the rect kernel reads only the valid
        rows of each rectangle (and the extents), the unmasked one all of x."""
        Bg, Cg = xg.shape[0], xg.shape[-1]
        n = valid_g if rect else xg.numel() // Cg
        return n * Cg * 4 + Bg * Cg * 4 + (Bg * 8 if rect else 0) + 4, 4 * n * Cg

    # densenet169's width, [16, 32 x 32, 1664] f32: wrapper and device time
    # beside its bytes bound, for rows 1-2
    at = gem_in["at_timed_width"]
    xw, pw, sw = at["x"], at["p"], at["sizes"]
    width_extra = {}
    for name, fn, plain, rect in (
            ("gem_l2n_fused_rect", lambda: gem_l2n_fused_rect(xw, pw, sw),
             lambda: gem_l2n_plain(xw, pw, sw), True),
            ("gem_l2n_fused", lambda: gem_l2n_fused(xw, pw), lambda: gem_l2n_plain(xw, pw), False)):
        byts, flops = gem_bytes(xw, at["valid_positions"], rect)
        t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
        width_extra[name] = {
            "shape": list(xw.shape), "ms": time_ms(fn), "plain_ms": time_ms(plain),
            "device_ms": at["device_ms"][name], "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations", "bytes": byts}
        log(f"[timing] {name} at {list(xw.shape)} f32: {json.dumps(width_extra[name])}")
    # the scalar path: the same map at C = 1,666 (C % 4 != 0)
    xs = torch.nn.functional.pad(xw, (0, 2)).contiguous()
    width_extra["gem_l2n_fused_rect"]["scalar_c1666"] = {
        "ms": time_ms(lambda: gem_l2n_fused_rect(xs, pw, sw)),
        "device_ms": at["device_ms"]["scalar_rect"]}
    log(f"[timing] gem_l2n_fused_rect scalar path (C % 4 != 0) at C=1666: "
        f"{json.dumps(width_extra['gem_l2n_fused_rect']['scalar_c1666'])}, against C=1664 "
        f"{width_extra['gem_l2n_fused_rect']['ms']:.4f} ms (device "
        f"{at['device_ms']['gem_l2n_fused_rect']} ms)")
    del xs

    byts, flops = gem_bytes(x, valid, True)
    row("gem_l2n_fused_rect", src_gem, PALLAS + "gem_l2n.py:238",
        time_ms(lambda: gem_l2n_fused_rect(x, p, sizes)),
        time_ms(lambda: gem_l2n_plain(x, p, sizes)), byts, flops, None,
        device_ms=gem_in["device_ms"]["gem_l2n_fused_rect"],
        at_c1664=width_extra["gem_l2n_fused_rect"])
    byts, flops = gem_bytes(x, valid, False)
    row("gem_l2n_fused", src_gem, PALLAS + "gem_l2n.py:218",
        time_ms(lambda: gem_l2n_fused(x, p)),
        time_ms(lambda: gem_l2n_plain(x, p)), byts, flops, None,
        device_ms=gem_in["device_ms"]["gem_l2n_fused"], at_c1664=width_extra["gem_l2n_fused"])
    # the plan as the built kernel reports it, with how many clusters the
    # card holds at once: images past that run in a second wave
    log(f"[timing] gem_l2n launch plan at C={C} f32: {json.dumps(gem_mod.launch_plan(C))}")

    g, q, _ = _topk_inputs(dev, torch.float32)
    Nq, D = q.shape
    Ng, k = g.shape[0], 100
    lib_ms = time_ms(lambda: torch.topk(q @ g.T, k, dim=1))
    row("fused_topk_search", CSRC + "fused_topk.cu", PALLAS + "fused_topk.py:170",
        time_ms(lambda: fused_topk_search(g, q, k)),
        time_ms(lambda: fused_topk_plain(g, q, k)),
        Ng * D * 4 + Nq * D * 4 + Nq * k * 8, 2 * Nq * Ng * D, lib_ms)
    log(f"[timing] fused_topk at {Nq} x {Ng} x {D} f32 k={k}: "
        f"{Nq / rows[-1]['ms'] * 1e3:.1f} q/s")
    # serving batches are small: q/s at a few batch sizes, the kernel beside
    # its one-call yardstick
    for nq in (1, 32, 256):
        qs = q[:nq].contiguous()
        ms_k = time_ms(lambda: fused_topk_search(g, qs, k))
        ms_l = time_ms(lambda: torch.topk(qs @ g.T, k, dim=1))
        log(f"[timing] fused_topk sweep Nq={nq} x {Ng} x {D} f32 k={k}: kernel {ms_k:.4f} ms "
            f"({nq / ms_k * 1e3:.1f} q/s), torch.topk(q @ g.T) {ms_l:.4f} ms "
            f"({nq / ms_l * 1e3:.1f} q/s)")

    # NetVLAD at config 3's head width: reads the valid rows of x, the
    # parameters and writes [B, K*C]; logits and aggregation are 2 N C K
    # flops each (the softmax's K exps a row are not counted), taken as
    # 3xTF32 on the tensor cores; the f32-FMA and the bytes bounds beside.
    # ms is through the wrapper, device_ms the summed profiler intervals of
    # the kernels netvlad_forward launches (phase 3, same inputs)
    xv, c, w, b, nsz = nv_in["x"], nv_in["c"], nv_in["w"], nv_in["b"], nv_in["sizes"]
    Bv, Hv, Wv, Cv = xv.shape
    K = c.shape[0]
    par_bytes = (2 * K * Cv + K) * 4 + Bv * K * Cv * 4
    nvalid = nv_in["valid_positions"]
    src_nv = CSRC + "netvlad.cu"
    for name, replaces, fn, plain, byts, flops in (
            ("netvlad_fused_rect", "netvlad_kernel.py:252",
             lambda: netvlad_fused_rect(xv, c, w, b, sizes=nsz),
             lambda: netvlad_plain(xv, c, w, b, nsz),
             nvalid * Cv * 4 + par_bytes + Bv * 8, 4 * nvalid * Cv * K),
            ("netvlad_fused", "netvlad_kernel.py:287", lambda: netvlad_fused(xv, c, w, b),
             lambda: netvlad_plain(xv, c, w, b), xv.numel() * 4 + par_bytes,
             4 * Bv * Hv * Wv * Cv * K)):
        row(name, src_nv, PALLAS + replaces, time_ms(fn), time_ms(plain), byts, 0, None,
            tf32x3_flops=flops, device_ms=nv_in["device_ms"][name],
            f32_fma_bound_ms=max(flops / F32_FLOP_PER_S, byts / HBM_BYTES_PER_S) * 1e3,
            bytes_bound_ms=byts / HBM_BYTES_PER_S * 1e3)

    # scores + block maxima: the one-call yardstick is cuBLAS's f32 q @ g.T
    ng_pad = -(-Ng // 64) * 64
    row("scores_blockmax", CSRC + "score_topk.cu", PALLAS + "score_topk.py:55",
        time_ms(lambda: scores_blockmax(g, q)),
        time_ms(lambda: scores_blockmax_plain(g, q)),
        Ng * D * 4 + Nq * D * 4 + Nq * ng_pad * 4 + Nq * (ng_pad // 64) * 4,
        2 * Nq * Ng * D, time_ms(lambda: q @ g.T))
    search_ms = time_ms(lambda: blockmax_topk_search(g, q, 1000))
    log(f"[timing] blockmax_topk_search at {Nq} x {Ng} x {D} f32 k=1000: {search_ms:.3f} ms "
        f"({Nq / search_ms * 1e3:.1f} q/s), of which scores_blockmax {rows[-1]['ms']:.3f} ms "
        f"and block selection, gather and candidate sort the rest")
    del g, q

    # ADC at path A's shape: N M nq lookups; reads codes and LUT once,
    # writes scores and block maxima. The one-call yardstick is
    # embedding_bag(mode='sum') over the LUT laid out as [M * 256, nq] rows,
    # which gives the scores [n, nq] without the block maxima; its index
    # offsets and table layout are made outside the timed call
    lut, codes = adc_in["lut"], adc_in["codes"]
    nq, M, _ = lut.shape
    n = codes.shape[0]
    n_pad = -(-n // 64) * 64
    bag_idx = codes.long() + 256 * torch.arange(M, device=dev)
    bag_tab = lut.permute(1, 2, 0).reshape(M * 256, nq).contiguous()

    def library():
        return torch.nn.functional.embedding_bag(bag_idx, bag_tab, mode="sum")

    lib_err = (library().T - adc_scores(lut, codes)[0][:, :n]).abs().max().item()
    log(f"[timing] adc_scores vs embedding_bag(mode='sum'): max|score diff| {lib_err:.3e}")
    if lib_err > TOPK_TOL:
        raise AssertionError("adc_scores disagrees with embedding_bag's sums")
    row("adc_scores", CSRC + "adc.cu", PALLAS + "adc_mxu.py:125",
        time_ms(lambda: adc_scores(lut, codes)),
        time_ms(lambda: adc_scores_plain(lut, codes), reps=5),
        n * M + lut.numel() * 4 + nq * n_pad * 4 + nq * (n_pad // 64) * 4, 0,
        time_ms(library), lookups=n * M * nq,
        device_ms=adc_in["device_ms"])
    del bag_idx, bag_tab
    log(f"[timing] adc_scores at {nq} x {n} x M={M}: {rows[-1]['ms']:.4f} ms "
        f"(device {rows[-1]['device_ms']} ms), "
        f"{n * M * nq / rows[-1]['ms'] / 1e9:.3f} G lookups/ms, embedding_bag "
        f"{rows[-1]['library_ms']:.4f} ms; launch plan {json.dumps(adc.launch_plan())}")

    # the fused bottleneck: 2 B H W (2 Cin Cm + 9 Cm^2) flop, three TF32
    # tensor-core products each; reads x and the weights once, writes out;
    # the plain version is three cuDNN convs. The row is layer1 of the
    # 1024 px bucket; every shape is logged, with the f32-FMA bound beside
    # the tensor-core one, and summed over resnet50's 12-block mix.
    mix = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "f32_bound_ms": 0.0}
    for i, ((shape, cm), n_blocks) in enumerate(zip(BOTTLENECK_SHAPES, BOTTLENECK_MIX)):
        args = _bottleneck_inputs(dev, shape, cm, seed=10 + i)
        B, H, W, cin = shape
        flops = 2 * B * H * W * (2 * cin * cm + 9 * cm * cm)
        byts = 2 * B * H * W * cin * 4 + (2 * cin * cm + 9 * cm * cm + 2 * cm + cin) * 4
        ms = time_ms(lambda: bottleneck_fused(*args))
        plain_ms = time_ms(lambda: bottleneck_plain(*args))
        bound = max(3 * flops / TF32_FLOP_PER_S, byts / HBM_BYTES_PER_S) * 1e3
        f32_bound = max(flops / F32_FLOP_PER_S, byts / HBM_BYTES_PER_S) * 1e3
        log(f"[timing] bottleneck_fused {list(shape)} Cm={cm}: {ms:.3f} ms, plain (three "
            f"cuDNN convs) {plain_ms:.3f} ms, bound {bound:.3f} ms (3xTF32 tensor cores; "
            f"f32-FMA bound {f32_bound:.3f} ms), {flops / ms / 1e9:.2f} TFLOP/s (f32 flop)")
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                       ("f32_bound_ms", f32_bound)):
            mix[key] += n_blocks * v
        if i == 0:
            row("bottleneck_fused", CSRC + "bottleneck.cu", PALLAS + "bottleneck_block.py:204",
                ms, plain_ms, byts, 0, None, tf32x3_flops=flops, form="float32")
        del args
    log(f"[timing] bottleneck_fused over resnet50's 12 stride-1 blocks at the 1024 px bucket "
        f"(layers 1-4: {', '.join(map(str, BOTTLENECK_MIX[:4]))} blocks): kernel "
        f"{mix['ms']:.3f} ms, plain (three cuDNN convs) {mix['plain_ms']:.3f} ms, bound "
        f"{mix['bound_ms']:.3f} ms (f32-FMA bound {mix['f32_bound_ms']:.3f} ms)")

    # the bf16 form at the same shapes, its weights packed once as the fused
    # trunk packs them: the same flop at the dense bf16 rate; bytes: x read
    # and out written in bf16, the bf16 weights, the f32 biases. Plain: three
    # f32 cuDNN convolutions of the bf16 values, rounded where the kernel
    # rounds. Library: cuDNN's three bf16 convolutions with bias and ReLU and
    # the skip added (they round before the bias). Summed over resnet101's 29
    # stride-1 blocks at the 1024 px bucket. The row is layer1's. Each shape
    # logs its launch plan, the registers and spills nvcc gave the
    # instantiations it runs, and phase 3's share of values not bit-equal
    # there; PR 14's times (its first kernel, on an H100 80GB HBM3 at 700 W)
    # are quoted on those log lines, never in the kernels line.
    build, build_warnings = bottleneck_bf16_build_info()
    log(f"[timing] bottleneck_fused bf16 build: {json.dumps({'/'.join(map(str, k)): v for k, v in build.items()})}; "
        f"entry registers are the launch bound's, setmaxnreg then gives the consumers "
        f"232 and the producer 40; warnings {build_warnings}")
    mix16 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for i, ((shape, cm), n_blocks) in enumerate(zip(BOTTLENECK_SHAPES, R101_MIX)):
        args = _bottleneck_inputs(dev, shape, cm, seed=10 + i)
        args[0] = args[0].to(torch.bfloat16)
        x, w1, b1, w2, b2, w3, b3 = args
        pk = pack_bf16(w1, w2, w3)
        B, H, W, cin = shape
        flops = 2 * B * H * W * (2 * cin * cm + 9 * cm * cm)
        byts = (2 * B * H * W * cin * BF16_BYTES + (2 * cin * cm + 9 * cm * cm) * BF16_BYTES
                + (2 * cm + cin) * 4)
        library = cudnn_bf16_bottleneck(x, w1, b1, w2, b2, w3, b3)
        ms = time_ms(lambda: bottleneck_fused(*args, packed=pk))
        plain_ms = time_ms(lambda: bottleneck_plain(*args))
        lib_ms = time_ms(library)
        t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, byts / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        plan = bf16_plan(shape, cm)
        regs = {name: build[(name, p["bn"], plan["bk"])]
                for name, p in zip(PHASE_NAMES, plan["phases"])}
        earlier = (f" (quoted from PR 14, not this run: {PR14_BF16_MS[i]} ms)"
                   if i < len(PR14_BF16_MS) else "")
        log(f"[timing] bottleneck_fused bf16 {list(shape)} Cm={cm}: {plan_summary(plan)}; "
            f"registers/spills {json.dumps(regs)}; {ms:.3f} ms{earlier}, "
            f"{flops / ms / 1e9:.2f} TFLOP/s, {bound / ms:.3f} of the bound {bound:.3f} ms "
            f"(operations {t_ops:.3f}, bytes {t_bytes:.3f}); library (three bf16 cuDNN convs) "
            f"{lib_ms:.3f} ms; plain (three f32 cuDNN convs of the bf16 values) "
            f"{plain_ms:.3f} ms; not bit-equal at D = {plan['bk']} (one stage) "
            f"{bn16_shares[(shape, cm)]:.3e} (phase 3)")
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                       ("library_ms", lib_ms)):
            mix16[key] += n_blocks * v
        if i == 0:
            row("bottleneck_fused_bf16", CSRC + "bottleneck_bf16.cu",
                PALLAS + "bottleneck_block.py:204", ms, plain_ms, byts, 0, lib_ms,
                bf16_flops=flops, form="bfloat16", shape=f"{list(shape)} Cm={cm} bf16",
                plan=plan_summary(plan))
        del args, x, pk, library
    torch.cuda.empty_cache()
    log(f"[timing] bottleneck_fused bf16 over resnet101's 29 stride-1 blocks at the 1024 px "
        f"bucket (layers 1-4: {', '.join(map(str, R101_MIX[:4]))} blocks): kernel "
        f"{mix16['ms']:.3f} ms (quoted from PR 14, not this run: {PR14_BF16_29_BLOCKS_MS} "
        f"ms), plain "
        f"{mix16['plain_ms']:.3f} ms, library (three bf16 cuDNN convs) "
        f"{mix16['library_ms']:.3f} ms, bound {mix16['bound_ms']:.3f} ms")
    rows[-1]["r101_29_blocks"] = mix16
    return rows


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    name, smi = device_phase()
    import image_retrieval_for_image_based_localization_tpu_torch  # noqa: F401
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device("cuda")  # also turns TF32 off for convs and matmuls
    build_phase()
    gem_in = check_gem(dev)
    topk_err = check_topk(dev)
    nv_in = check_netvlad(dev)
    sb_err = check_scores_blockmax(dev)
    long_err = check_long_topk(dev)
    check_search_bitwise(dev)
    shape_errs = check_search_shapes(dev)
    adc_in = check_adc(dev)
    bn_err, bn_rel = check_bottleneck(dev)
    bn16_err, bn16_rel, bn16_neq, bn16_shares = check_bottleneck_bf16(dev)
    launches2, main2, c2 = main_path_phase(
        dev, 2, ("gem_l2n_fused_rect", "gem_l2n_fused", "fused_topk_search"))
    launches3, main3, _ = main_path_phase(
        dev, 3, ("netvlad_fused_rect", "netvlad_fused", "fused_topk_search"))
    launches_long, long_main = long_search_phase(dev)
    launches_ann, ann_main, ann_keep = ann_phase(dev)
    launches_b, main_b = fused_trunk_phase(dev, c2[0], main2)
    launches_c5, main_c5, c5_desc, q_u8 = config5_phase(dev)
    launches_i, main_i = config5_fused_phase(dev, c5_desc, main_c5)
    launches_e, main_e, e_keep = config4_phase(dev, *c5_desc, ann_keep)
    launches_f, main_f = rerank_phase(dev, e_keep)
    launches_g, main_g = serving_phase(dev, e_keep, ann_keep, c5_desc[1], q_u8)
    del e_keep, ann_keep, q_u8
    launches_h, main_h = other_trunks_phase(dev)
    launches_d, main_d = training_phase(dev, smi)
    torch.cuda.empty_cache()  # path D's memory, before path J's workers start
    launches_j, main_j = data_parallel_phase(dev, smi, c2, main_d)
    del c2
    launches_k, main_k = tooling_phase(dev, smi)
    by_path = {"config2": launches2, "config3": launches3, "long_search": launches_long,
               "ann": launches_ann, "config2_fused_trunk": launches_b,
               "config5": launches_c5, "config5_fused_trunk": launches_i,
               "config4": launches_e, "rerank": launches_f,
               "serving": launches_g, "other_trunks": launches_h, "training": launches_d,
               "data_parallel": launches_j, "tooling": launches_k}
    # each kernel's launches, summed over the paths' own counting windows
    launches = {n: sum(lp[n] for lp in by_path.values()) for n in launches2}
    errs = dict(gem_in["err"], **nv_in["err"],
                fused_topk_search=max(topk_err, main2["topk_main_err"], main3["topk_main_err"],
                                      main_b["topk_main_err"], shape_errs["fused_topk_search"],
                                      main_g["fused_topk_err"]),
                scores_blockmax=max(sb_err, long_err, long_main["long_query_err"],
                                    main_d["mining_check"]["scores_blockmax_err"],
                                    main_e["scores_blockmax_err"],
                                    main_f["scores_blockmax_err"],
                                    main_g["scores_blockmax_err"],
                                    shape_errs["scores_blockmax"]),
                adc_scores=max(adc_in["err"], main_g["adc_err"]), bottleneck_fused=bn_err,
                bottleneck_fused_bf16=max(bn16_err, main_i["block_max_abs_err"]))
    errs["gem_l2n_fused_rect"] = max(errs["gem_l2n_fused_rect"], main_g["gem_err"],
                                     main_k["b1_err"], main_h["densenet121"]["d_err"],
                                     main_h["alexnet-gem"]["d_err"],
                                     main_h["squeezenet1_1-gem"]["d_err"])
    errs["gem_l2n_fused"] = max(errs["gem_l2n_fused"], main_h["densenet121"]["d_err"])
    bf16 = main_c5["bf16_kernels"]
    for kname, r in bf16.items():
        errs[kname] = max(errs[kname], r["max_abs_err"])
    rows = timing_phase(dev, gem_in, nv_in, adc_in, launches, errs, bn16_shares)
    for r in rows:  # rows 1-4 also carry their bf16 times at path C's shapes
        if r["name"] in bf16:
            r["bf16"] = bf16[r["name"]]
        if r["name"] == "fused_topk_search":  # and the one hop's single query (path G)
            r["serving_nq1"] = main_g["fused_topk_nq1"]
    log(json.dumps({"main_path": {"config2": main2, "config3": main3, "long_search": long_main,
                                  "ann": ann_main, "config2_fused_trunk": main_b,
                                  "config5": {k: v for k, v in main_c5.items()
                                              if k != "bf16_kernels"},
                                  "config5_fused_trunk": main_i,
                                  "config4": main_e, "rerank": main_f,
                                  "serving": main_g, "other_trunks": main_h,
                                  "training": main_d, "data_parallel": main_j,
                                  "tooling": main_k,
                                  "bottleneck_rel_err": bn_rel,
                                  "bottleneck_bf16_rel_err": bn16_rel,
                                  "bottleneck_bf16_not_bit_equal_share": bn16_neq,
                                  "launches_by_path": by_path}}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def main_path_j() -> int:
    """``--path-j``: the device and build phases, then path J alone (it makes
    config 2's one-device descriptors itself); for a run on several cards."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    name, smi = device_phase()
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device("cuda")
    build_phase()
    launches, out = data_parallel_phase(dev, smi)
    log(json.dumps({"launches": launches}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--dp-worker"]:
            sys.exit(dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
        if sys.argv[1:2] == ["--path-j"]:
            sys.exit(main_path_j())
        sys.exit(main())
    except Exception:  # any failed phase: report and exit non-zero, no result line
        traceback.print_exc()
        sys.exit(1)
