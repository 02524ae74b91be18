"""Contrastive/triplet training step, the JAX package's ``training/trainer.py``.

cirtorch's ``train.py`` recipe: tuples (q, p, n1..nk) batched ``[B, T, H, W,
C]`` and flattened to one ``[B*T, ...]`` conv batch, contrastive or triplet
loss, Adam or SGD with L2 weight decay folded into the gradient, and an
exponential per-epoch lr decay. BatchNorm runs in train mode with flax's
statistics (``models.resnet.bn_train``); the kernel head (``use_kernel``)
differentiates through the GeM and NetVLAD Functions (``ops.kernels``).

Optimizers match the JAX package's optax chains on identical gradients:
Adam is ``torch.optim.Adam(weight_decay=wd, eps=1e-8)`` (``add_decayed_weights``
then ``scale_by_adam``), SGD is ``torch.optim.SGD(momentum=m, dampening=0,
weight_decay=wd)`` (``trace``); the lr is ``lr * lr_decay ** floor(applied /
steps_per_epoch)`` through ``LambdaLR``, stepped once per applied step. With
``update_every = k > 1`` the gradients of k micro-batches are averaged before
one update, as ``optax.MultiSteps`` does.

Not here (each raises): a ``mesh`` (data-parallel training under DDP, ROADMAP
A10: ``parallel/`` shards the search gallery, not the batch), bf16 training
and ``remat`` (ROADMAP C3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.data.images import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.init import init_random_
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    RetrievalNet,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.losses import (
    contrastive_loss,
    triplet_loss,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig``: same fields, same defaults."""

    loss: str = "contrastive"      # 'contrastive' | 'triplet'
    margin: float = 0.7
    lr: float = 1e-6
    lr_decay: float = 0.99         # per epoch: lr * lr_decay ** (applied // steps_per_epoch)
    steps_per_epoch: int = 1       # applied optimizer steps per epoch
    weight_decay: float = 1e-6
    optimizer: str = "adam"        # 'adam' | 'sgd'
    momentum: float = 0.9
    update_every: int = 1          # micro-batches averaged into one update
    n_neg: int = 5
    batch_tuples: int = 5          # tuples per step
    remat: bool = False            # not supported: raises (ROADMAP C3)


@dataclasses.dataclass
class TrainState:
    """The model (in train mode), its optimizer and lr schedule, the number
    of micro-batch steps taken (``step``, as the JAX state's) and how many
    micro-batches the pending update holds (``micro``)."""

    model: RetrievalNet
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0
    micro: int = 0


def check_trainable(model: RetrievalNet, cfg: TrainConfig, mesh=None) -> None:
    """Raise on what this package does not train."""
    if mesh is not None:
        raise NotImplementedError("data-parallel training over a mesh (DDP on its data axis) "
                                  "is not ported yet: parallel/ shards the search gallery "
                                  "only (ROADMAP A10)")
    if model.compute_dtype != torch.float32:
        raise NotImplementedError("bf16 training is not supported: it needs train-mode "
                                  "BatchNorm with flax's bf16 rounding points and its "
                                  "backward (ROADMAP C3, bf16 training)")
    if cfg.remat:
        raise NotImplementedError(
            "remat is not supported: torch.utils.checkpoint re-runs the forward, which "
            "would move the BatchNorm running statistics a second time, where flax's "
            "functional jax.checkpoint does not (ROADMAP C3, remat)")
    if (not model.arch.startswith("resnet") and model.arch != "vgg16") or model.regional \
            or model.pooling not in ("gem", "mac", "spoc", "netvlad"):
        raise NotImplementedError(
            f"training {model.arch} with pooling {model.pooling!r}"
            f"{' (regional)' if model.regional else ''} is not supported: the trainer takes "
            f"the resnet and vgg16 trunks with GeM, MAC, SPoC or NetVLAD; the other trunks "
            f"need flax's train-mode BatchNorm (densenet) and parity tests "
            f"(ROADMAP A11, training the other trunks and heads)")
    if model.use_kernel and model.pooling not in ("gem", "netvlad"):
        raise ValueError(
            "training with use_pallas=True is only supported for GeM and NetVLAD pooling "
            "(gem_l2n_fused and netvlad_fused define autograd Functions) — use "
            "use_pallas=False for training other heads")


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig
                   ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """The reference train.py's optimizer and the per-epoch exponential lr
    schedule (``LambdaLR``, stepped once per applied update)."""
    params = list(params)
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, eps=1e-8, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum, dampening=0.0,
                              weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r} (adam|sgd)")
    spe = max(int(cfg.steps_per_epoch), 1)
    decay = cfg.lr_decay
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: decay ** math.floor(n / spe))
    return opt, sched


def create_train_state(model: RetrievalNet, cfg: TrainConfig = TrainConfig(),
                       state_dict: Optional[dict] = None, seed: int = 0,
                       device: DeviceLike = "cuda") -> TrainState:
    """The model on ``device`` in train mode, holding ``state_dict`` or random
    weights from ``torch.Generator().manual_seed(seed)``, with a fresh
    optimizer over all its parameters."""
    check_trainable(model, cfg)
    dev = resolve_device(device)
    if state_dict is None:
        init_random_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    model.to(dev).train()
    opt, sched = make_optimizer(model.parameters(), cfg)
    return TrainState(model=model, optimizer=opt, scheduler=sched)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _tuple_loss(model: RetrievalNet, cfg: TrainConfig, pixels: torch.Tensor,
                labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pixels [B, T, H, W, C]; labels [B, T] (+1 pos, -1 neg, 0 query);
    mask: optional [B, T, H, W] pixel validity of padded bucket shapes."""
    B, T, H, W, C = pixels.shape
    fmask = None if mask is None else mask.reshape(B * T, H, W)
    desc = model(pixels.reshape(B * T, H, W, C), fmask).reshape(B, T, -1)
    if cfg.loss == "contrastive":
        return contrastive_loss(desc, labels, margin=cfg.margin)
    if cfg.loss == "triplet":
        return triplet_loss(desc, margin=cfg.margin)
    raise ValueError(cfg.loss)


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(device, non_blocking=True)


def u8_to_input(pixels_u8: torch.Tensor, sizes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw uint8 tuples [B, T, H, W, 3] and valid (h, w) [B, T, 2] -> the
    normalized pixels with zeroed padding and the validity mask [B, T, H, W],
    as the JAX u8 step computes them: ``(u8 / 255 - mean) / std``."""
    dev = pixels_u8.device
    _, _, H, W, _ = pixels_u8.shape
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    mask = (row < sizes[..., 0, None, None]) & (col < sizes[..., 1, None, None])
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    x = (pixels_u8.to(torch.float32) / 255.0 - mean) / std
    return x * mask[..., None], mask


def apply_micro_step(state: TrainState, update_every: int) -> None:
    """Count one micro-batch whose gradients ``backward`` has added into the
    parameters' ``.grad``; on every ``update_every``-th, average the summed
    gradients, step the optimizer and the lr schedule. The caller zeroes the
    gradients before the first micro-batch of an update (``micro == 0``)."""
    state.step += 1
    state.micro += 1
    if state.micro < update_every:
        return
    if update_every > 1:
        for p in state.model.parameters():
            if p.grad is not None:
                p.grad.div_(update_every)
    state.optimizer.step()
    state.scheduler.step()
    state.micro = 0


def make_train_step(model: RetrievalNet, cfg: TrainConfig = TrainConfig(), mesh=None,
                    from_u8: bool = False):
    """The train step: ``step(state, pixels, labels) -> (state, loss)`` or,
    with ``from_u8=True``, ``step(state, pixels_u8 [B,T,H,W,3] uint8, sizes
    [B,T,2] int32, labels)``, the production tuple path: normalization, the
    validity mask and zeroed padding on the device, and the mask into the
    mask-aware head (the rect kernels with ``use_kernel``). Inputs may be
    numpy arrays or tensors; they go to the model's device. The loss comes
    back as a detached 0-d tensor. After an applied update the parameters'
    ``.grad`` hold the (averaged) gradients it used."""
    check_trainable(model, cfg, mesh)
    k = max(int(cfg.update_every), 1)

    def run(state: TrainState, x: torch.Tensor, labels, mask) -> Tuple[TrainState, torch.Tensor]:
        if state.micro == 0:
            state.optimizer.zero_grad(set_to_none=True)
        loss = _tuple_loss(state.model, cfg, x, _as_tensor(labels, x.device), mask)
        loss.backward()
        apply_micro_step(state, k)
        return state, loss.detach()

    if from_u8:
        def step_u8(state: TrainState, pixels_u8, sizes, labels):
            dev = _device(state.model)
            x, mask = u8_to_input(_as_tensor(pixels_u8, dev), _as_tensor(sizes, dev))
            return run(state, x, labels, mask)

        return step_u8

    def step(state: TrainState, pixels, labels):
        return run(state, _as_tensor(pixels, _device(state.model)).float(), labels, None)

    return step


def make_val_step(model: RetrievalNet, cfg: TrainConfig = TrainConfig()):
    """Validation loss (reference ``validate()``): ``val_step(state, pixels,
    labels) -> float``, eval-mode forward (running statistics), the same
    tuple loss, no gradients; the model returns to the mode it was in."""

    @torch.no_grad()
    def val_step(state: TrainState, pixels, labels) -> float:
        m = state.model
        was_training = m.training
        m.eval()
        try:
            dev = _device(m)
            loss = _tuple_loss(m, cfg, _as_tensor(pixels, dev).float(), _as_tensor(labels, dev))
        finally:
            m.train(was_training)
        return float(loss)

    return val_step


def validate(state: TrainState, val_step, batches) -> float:
    """Mean validation loss over an iterable of (pixels, labels) batches."""
    losses = [val_step(state, p, lab) for p, lab in batches]
    return float(np.mean(losses)) if losses else 0.0


def make_eval_step(model: RetrievalNet):
    """Descriptor forward in eval mode: ``eval_fn(state, pixels [B, T, H, W,
    C]) -> [B, T, D]``; the model returns to the mode it was in."""

    @torch.no_grad()
    def eval_fn(state: TrainState, pixels) -> torch.Tensor:
        m = state.model
        was_training = m.training
        m.eval()
        try:
            x = _as_tensor(pixels, _device(m)).float()
            B, T, H, W, C = x.shape
            return m(x.reshape(B * T, H, W, C)).reshape(B, T, -1)
        finally:
            m.train(was_training)

    return eval_fn


def tuples_to_batch(images: np.ndarray, n_neg: int) -> Tuple[np.ndarray, np.ndarray]:
    """images: [B, 2+n_neg, H, W, C] (q, p, negs) -> (pixels, labels)."""
    B, T = images.shape[:2]
    if T != 2 + n_neg:
        raise ValueError(f"tuples hold {T} images, expected 2 + {n_neg}")
    labels = np.zeros((B, T), np.int32)
    labels[:, 1] = 1
    labels[:, 2:] = -1
    return images, labels


def train_epoch(state: TrainState, train_step, batches) -> Tuple[TrainState, float]:
    """Run one epoch over an iterable of (pixels, labels) host batches."""
    losses = []
    for pixels, labels in batches:
        state, loss = train_step(state, pixels, labels)
        losses.append(float(loss))
    return state, float(np.mean(losses)) if losses else 0.0
