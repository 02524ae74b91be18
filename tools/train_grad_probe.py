#!/usr/bin/env python3
"""Where the training path's kernel-vs-plain gradient checks get their error.

    python3 tools/train_grad_probe.py

Needs one CUDA card. On one batch of ``chip_smoke.py`` path D's tuples (the
same synthetic pool, 5 tuples x 7 images at 362 px, uint8 with the mask),
under deterministic cuDNN:

  * vgg16 + NetVLAD K=64 (SGD, lr 1e-3, momentum 0.9): the kernel head's
    gradient against the plain head's at equal weights; one update of each
    and how far the two models' weights then lie apart; the plain head's
    gradient at those two weights, then with only the trunk's or only the
    head's weights taken from the kernel side; the ReLU sign flips between
    the two weights, and the least NetVLAD cluster mass and residual norm;
  * resnet101 + GeM, plain head, the same gradient twice at the same
    weights: with cuDNN's default algorithms and with deterministic ones.

Each comparison gives the five largest errors, each over its parameter's
bound (1e-4 of the plain gradient's max|g|, or 1e-6), as path D's checks
measure them. Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _top(ga, gb, n=5):
    """The n largest max|ga - gb| over each parameter's bound."""
    rows = []
    for name, b in gb.items():
        bound = max(1e-4 * b.abs().max().item(), 1e-6)
        rows.append(((ga[name] - b).abs().max().item() / bound, name))
    return [(round(r, 3), name) for r, name in sorted(rows, reverse=True)[:n]]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
        RetrievalNet,
        feature_mask,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.training import loop
    from image_retrieval_for_image_based_localization_tpu_torch.training.mining import TupleSet
    from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
        TrainConfig,
        _tuple_loss,
        create_train_state,
        make_train_step,
        u8_to_input,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
        resolve_device,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    smoke = _smoke()
    dev = resolve_device("cuda")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    r = smoke.TRAIN_RECIPE
    tmp = tempfile.mkdtemp(prefix="train_grad_probe_")
    try:
        paths, clusters, qidxs, pidxs, _, _ = loop._real_or_synthetic_pool(
            tmp, n_scenes=smoke.TRAIN_SCENES, views=smoke.TRAIN_VIEWS, hw=smoke.TRAIN_HW)
        hw = loop.probe_bucket_shape(paths, r["image_size"])
        rng = np.random.RandomState(0)  # path D's batch draw
        sel = rng.choice(len(qidxs), r["batch_tuples"], replace=False)
        negs = np.stack([rng.choice(np.flatnonzero(clusters != clusters[qidxs[i]]), r["n_neg"],
                                    replace=False) for i in sel])
        tuples = TupleSet(qidxs=qidxs[sel], pidxs=pidxs[sel], nidxs=negs)
        px, sizes, labels = next(loop.iter_tuple_batches(
            loop._ResizedImageCache(paths, r["image_size"]), tuples, r["batch_tuples"], hw))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    x, mask = u8_to_input(torch.from_numpy(px).to(dev), torch.from_numpy(sizes).to(dev))
    lab = torch.as_tensor(labels).to(dev)
    sgd = TrainConfig(loss=r["loss"], margin=r["margin"], lr=1e-3, optimizer="sgd",
                      momentum=0.9, n_neg=r["n_neg"], batch_tuples=r["batch_tuples"])

    def grads(model, sd=None, cfg=sgd):
        if sd is not None:
            model.load_state_dict(sd)
        model.zero_grad(set_to_none=True)
        _tuple_loss(model, cfg, x, lab, mask).backward()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    out = {}
    vk = create_train_state(RetrievalNet(arch="vgg16", pooling="netvlad", use_kernel=True),
                            sgd, seed=0, device=dev)
    vp = create_train_state(RetrievalNet(arch="vgg16", pooling="netvlad", use_kernel=False),
                            sgd, state_dict=copy.deepcopy(vk.model.state_dict()), device=dev)
    out["vgg16_kernel_vs_plain_equal_weights"] = _top(grads(vk.model), grads(vp.model))
    make_train_step(vk.model, sgd, from_u8=True)(vk, px, sizes, labels)
    make_train_step(vp.model, sgd, from_u8=True)(vp, px, sizes, labels)
    wk = {k: v.detach().clone() for k, v in vk.model.state_dict().items()}
    wp = {k: v.detach().clone() for k, v in vp.model.state_dict().items()}
    out["vgg16_weights_apart_after_one_update"] = max((wk[k] - wp[k]).abs().max().item()
                                                      for k in wk)
    plain = vp.model
    g_wp = grads(plain, wp)
    out["vgg16_plain_twice"] = _top(grads(plain, wp), g_wp)
    out["vgg16_plain_at_the_two_weights"] = _top(grads(plain, wk), g_wp)
    out["vgg16_trunk_weights_swapped"] = _top(
        grads(plain, {k: (wp[k] if k.startswith("pool.") else wk[k]) for k in wp}), g_wp)
    out["vgg16_head_weights_swapped"] = _top(
        grads(plain, {k: (wk[k] if k.startswith("pool.") else wp[k]) for k in wp}), g_wp)

    def relu_signs(sd):
        plain.load_state_dict(sd)
        signs = []
        hooks = [m.register_forward_hook(lambda m, i, o: signs.append(o > 0))
                 for m in plain.features.modules() if isinstance(m, torch.nn.ReLU)]
        with torch.no_grad():
            B, T, H, W, C = x.shape
            feats = plain.trunk_nhwc(x.reshape(B * T, H, W, C))
            fmask = feature_mask(mask.reshape(B * T, H, W), (H, W), feats.shape[1:3])
        for h in hooks:
            h.remove()
        return signs, feats, fmask

    s_p, f_p, fmask = relu_signs(wp)
    s_k, _, _ = relu_signs(wk)
    out["vgg16_relu_sign_flips"] = sum(int((a != b).sum()) for a, b in zip(s_p, s_k))
    out["vgg16_relu_positions"] = sum(a.numel() for a in s_p)
    with torch.no_grad():
        plain.load_state_dict(wp)
        f = f_p.float().reshape(f_p.shape[0], -1, f_p.shape[-1])
        logits = torch.einsum("bnc,ck->bnk", f, plain.pool.assign_w()) + plain.pool.conv.bias
        a = torch.softmax(logits, -1) * fmask.reshape(f.shape[0], -1, 1).float()
        mass = a.sum(1)
        norms = (torch.einsum("bnk,bnc->bkc", a, f)
                 - mass[..., None] * plain.pool.centroids[None]).norm(dim=-1)
    out["netvlad_cluster_mass_min_median"] = [mass.min().item(), mass.median().item()]
    out["netvlad_residual_norm_min_median"] = [norms.min().item(), norms.median().item()]
    del vk, vp, plain
    torch.cuda.empty_cache()

    cfg = TrainConfig(loss=r["loss"], margin=r["margin"], lr=r["lr"], n_neg=r["n_neg"],
                      batch_tuples=r["batch_tuples"])
    rn = RetrievalNet(arch="resnet101", use_kernel=False).to(dev).train()
    sd0 = copy.deepcopy(rn.state_dict())
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        g0 = grads(rn, sd0, cfg)
        out[f"resnet101_plain_twice_deterministic_{det}"] = _top(grads(rn, sd0, cfg), g0)
    print(json.dumps({"train_grad_probe": out, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
