#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: name and power limit;
  2. build every CUDA kernel of the port with nvcc (one process per source,
     started together) into build/torch_kernels/;
  3. each kernel against its plain PyTorch version on the card:
     - gem_l2n at the GeM head's full width (B=16, 32x32 map, C=2048, f32
       and bf16, ragged extents);
     - netvlad at config 3's head width (B=16, 64x64 map, C=512, K=64, f32,
       ragged extents with a (0, 0) row, one image with zero-mass clusters);
     - fused_topk and scores_blockmax at the search shape (256 queries x
       100,000 x 2048, f32 and bf16), and the exact long-shortlist search
       (blockmax_topk_search, knn_search) at k=200 and 1000, with planted
       duplicate rows;
  4. three paths at full width, each with the launch counts set to 0 just
     before it and read just after it, on an in-memory clustered corpus of
     100 images in three aspect ratios and 20 queries, random weights from
     a seeded torch.Generator:
     - graded config 2 (resnet50 + GeM, fused head, 1024 px, scales 1,
       1/sqrt(2), 1/2, f32): extract_features -> build_index(pca) ->
       Index.query(k=10) through the fused top-k kernel -> Index.ranks -> mAP;
     - graded config 3 (vgg16 + NetVLAD K=64, fused head, 1024 px, one
       scale, f32): the same through build_index(pca, whiten_dims=4096);
     - exact search with a long shortlist: Index.query(k=1000) over a
       100,000 x 2048 gallery, through the score/block-max kernel;
  5. timings (CUDA events, median of 20) beside each kernel's bound;
each config's extraction also runs once more under torch.profiler, which
gives the card's busy and idle share of the wall time and the device time
of the head kernels, the convolutions and cuDNN's layout transforms;
then one JSON line listing the kernels, the nvidia-smi line, and the result
line {"ok": true, "device": {...}}.

It imports the port only (never JAX) and needs the repository next to it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

# H100 SXM data-sheet peaks: HBM bytes/s and f32 (non-tensor-core) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
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
    spans, groups = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end  # us
        spans.append((start, end))
        n = e.name.lower()
        g = ("head kernel" if "gem_" in n or "netvlad" in n else
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


def check_gem(dev):
    """Both GeM+L2N kernels against the plain version; returns stats."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        gem_l2n_fused,
        gem_l2n_fused_rect,
        gem_l2n_plain,
    )

    B, H, W, C = 16, 32, 32, 2048
    gen = torch.Generator().manual_seed(1)
    x32 = torch.relu(torch.randn((B, H, W, C), generator=gen)).to(dev)
    hs = torch.randint(1, H + 1, (B,), generator=gen)
    ws = torch.randint(1, W + 1, (B,), generator=gen)
    hs[0], ws[0] = H, W      # full extent
    hs[1], ws[1] = 0, 0      # batch-pad row
    hs[2], ws[2] = H - 9, W  # h < H
    hs[3], ws[3] = H, W - 5  # w < W
    sizes = torch.stack([hs, ws], 1).to(torch.int32).to(dev)
    p = torch.tensor([3.0], device=dev)
    err = {"gem_l2n_fused_rect": 0.0, "gem_l2n_fused": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype).contiguous()
        got = gem_l2n_fused_rect(x, p, sizes)
        want = gem_l2n_plain(x, p, sizes)
        e_rect = (got - want).abs().max().item()
        got_u = gem_l2n_fused(x, p)
        e_un = (got_u - gem_l2n_plain(x, p)).abs().max().item()
        torch.cuda.synchronize()
        log(f"[check] gem_l2n {dtype}: rect max|err| {e_rect:.3e}, unmasked {e_un:.3e}")
        if not (e_rect <= GEM_TOL and e_un <= GEM_TOL):
            raise AssertionError(f"gem_l2n {dtype} disagrees with its plain version")
        if got[1].abs().max().item() != 0.0:
            raise AssertionError("a (0, 0) row must give a zero descriptor")
        err["gem_l2n_fused_rect"] = max(err["gem_l2n_fused_rect"], e_rect)
        err["gem_l2n_fused"] = max(err["gem_l2n_fused"], e_un)
    valid = int((hs * ws).sum())
    log(f"[check] gem_l2n extents: {valid} of {B * H * W} positions valid")
    return {"x": x32, "p": p, "sizes": sizes, "valid_positions": valid, "err": err}


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
    """Both NetVLAD kernels against the plain version; returns inputs and errors."""
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        netvlad_fused,
        netvlad_fused_rect,
        netvlad_plain,
    )

    nv = _netvlad_inputs(dev)
    x, c, w, b, sizes = nv["x"], nv["c"], nv["w"], nv["b"], nv["sizes"]
    K, C = c.shape
    got = netvlad_fused_rect(x, c, w, b, sizes=sizes)
    want = netvlad_plain(x, c, w, b, sizes)
    e_rect = (got - want).abs().max().item()
    got_u = netvlad_fused(x, c, w, b)
    e_un = (got_u - netvlad_plain(x, c, w, b)).abs().max().item()
    torch.cuda.synchronize()
    zero = torch.all(got[2].reshape(K, C) == 0, dim=1)
    B, H, W, _ = x.shape
    log(f"[check] netvlad f32 [{B}, {H}x{W}, {C}] K={K}: rect max|err| {e_rect:.3e}, "
        f"unmasked {e_un:.3e}; zero-mass clusters in image 2: {int(zero.sum())} of {K}; "
        f"{nv['valid_positions']} of {B * H * W} positions valid")
    if not (e_rect <= NETVLAD_TOL and e_un <= NETVLAD_TOL):
        raise AssertionError("netvlad disagrees with its plain version")
    if got[1].abs().max().item() != 0.0:
        raise AssertionError("a (0, 0) row must give a zero descriptor")
    if not (0 < int(zero.sum()) < K
            and torch.equal(zero, torch.all(want[2].reshape(K, C) == 0, dim=1))):
        raise AssertionError("zero-mass clusters must give zero rows, as in the plain version")
    norms = got.norm(dim=1)
    if (norms[[0] + list(range(2, len(norms)))] - 1).abs().max().item() > 1e-5:
        raise AssertionError("netvlad descriptors are not unit-norm")
    nv["err"] = {"netvlad_fused_rect": e_rect, "netvlad_fused": e_un}
    return nv


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


def main_path_phase(dev, graded_id, expect):
    """One graded config end to end; ``expect`` names the kernels its run
    must launch. Counts are set to 0 just before the run and read after."""
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
    cfg = dataclasses.replace(graded.extract, model=mc, batch_size=16)
    tag = f"config {graded_id}"
    q_pixels = ((q_u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
    log(f"[{tag}] {graded.name}: {mc.arch} {mc.pooling} fused head, {cfg.image_size} px, "
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
                      "index_dim": int(index.gallery.shape[1]), "profile": prof}


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


def timing_phase(dev, gem_in, nv_in, launches, errs):
    import torch
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        blockmax_topk_search,
        fused_topk_plain,
        fused_topk_search,
        gem_l2n_fused,
        gem_l2n_fused_rect,
        gem_l2n_plain,
        netvlad_fused,
        netvlad_fused_rect,
        netvlad_plain,
        scores_blockmax,
        scores_blockmax_plain,
    )

    x, p, sizes = gem_in["x"], gem_in["p"], gem_in["sizes"]
    B, H, W, C = x.shape
    out_bytes = B * C * 4
    rows = []

    def row(name, src, replaces, ms, plain_ms, byts, flops, library_ms):
        t_bytes = byts / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        r = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
             "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms}
        log(json.dumps({"kernel_timing": r}))
        rows.append(r)

    src_gem = CSRC + "gem_l2n.cu"
    valid = gem_in["valid_positions"]
    # the kernel reads only the valid rows of each rectangle; ~4 ops an element
    row("gem_l2n_fused_rect", src_gem, PALLAS + "gem_l2n.py:238",
        time_ms(lambda: gem_l2n_fused_rect(x, p, sizes)),
        time_ms(lambda: gem_l2n_plain(x, p, sizes)),
        valid * C * 4 + out_bytes + B * 8 + 4, 4 * valid * C, None)
    row("gem_l2n_fused", src_gem, PALLAS + "gem_l2n.py:218",
        time_ms(lambda: gem_l2n_fused(x, p)),
        time_ms(lambda: gem_l2n_plain(x, p)),
        x.numel() * 4 + out_bytes + 4, 4 * x.numel(), None)

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

    # NetVLAD at config 3's head width: reads the valid rows of x, the
    # parameters and writes [B, K*C]; logits and aggregation are 2 N C K
    # flops each (the softmax's K exps a row are not counted)
    xv, c, w, b, nsz = nv_in["x"], nv_in["c"], nv_in["w"], nv_in["b"], nv_in["sizes"]
    Bv, Hv, Wv, Cv = xv.shape
    K = c.shape[0]
    par_bytes = (2 * K * Cv + K) * 4 + Bv * K * Cv * 4
    nvalid = nv_in["valid_positions"]
    src_nv = CSRC + "netvlad.cu"
    row("netvlad_fused_rect", src_nv, PALLAS + "netvlad_kernel.py:252",
        time_ms(lambda: netvlad_fused_rect(xv, c, w, b, sizes=nsz)),
        time_ms(lambda: netvlad_plain(xv, c, w, b, nsz)),
        nvalid * Cv * 4 + par_bytes + Bv * 8, 4 * nvalid * Cv * K, None)
    row("netvlad_fused", src_nv, PALLAS + "netvlad_kernel.py:287",
        time_ms(lambda: netvlad_fused(xv, c, w, b)),
        time_ms(lambda: netvlad_plain(xv, c, w, b)),
        xv.numel() * 4 + par_bytes, 4 * Bv * Hv * Wv * Cv * K, None)

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
    launches2, main2 = main_path_phase(
        dev, 2, ("gem_l2n_fused_rect", "gem_l2n_fused", "fused_topk_search"))
    launches3, main3 = main_path_phase(
        dev, 3, ("netvlad_fused_rect", "netvlad_fused", "fused_topk_search"))
    launches_long, long_main = long_search_phase(dev)
    # each kernel's launches, summed over the paths' own counting windows
    launches = {n: launches2[n] + launches3[n] + launches_long[n] for n in launches2}
    errs = dict(gem_in["err"], **nv_in["err"],
                fused_topk_search=max(topk_err, main2["topk_main_err"], main3["topk_main_err"]),
                scores_blockmax=max(sb_err, long_err, long_main["long_query_err"]))
    rows = timing_phase(dev, gem_in, nv_in, launches, errs)
    log(json.dumps({"main_path": {"config2": main2, "config3": main3, "long_search": long_main,
                                  "launches_by_path": {"config2": launches2,
                                                       "config3": launches3,
                                                       "long_search": launches_long}}}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any failed phase: report and exit non-zero, no result line
        traceback.print_exc()
        sys.exit(1)
