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

With a ``mesh`` (``parallel.mesh``) the step is data-parallel over its
``data`` axis, one process per card, as the JAX step's batch is sharded over
``data`` under ``jit``: each process takes its contiguous slice of the global
batch, train-mode BatchNorm takes the global batch's statistics
(``models.resnet.global_batch_stats``: float64 sums all-reduced over the
data group, split-invariant), the gradients are averaged over the data group
by one flattened all-reduce once per applied update, and the loss returned
is the global mean; the numbers are those of one process on the global batch
with its BatchNorm on that path. ``create_train_state(mesh=...)`` broadcasts
the data group's first process's weights.

Every trunk, head and dtype of ``models.retrieval_net`` trains, as in the
JAX trainer. ``dtype="bfloat16"`` computes the trunk in bf16 at flax's
rounding points while the parameters, their gradients and the optimizer
state stay f32 (the conv weights reach the bf16 trunk through a cast in the
graph, ``models.resnet.lowp_weight``). ``TrainConfig(remat=True)``, the JAX
step's ``jax.checkpoint`` of the forward, checkpoints each trunk segment
(``models.resnet.remat``): the same loss, gradients and running statistics
as without it, at a lower peak memory.

A JAX package's train state (its Orbax ``latest``, read by
``utils/orbax.py``) loads into a ``TrainState`` through
:func:`load_jax_train_state`: the weights, optax's Adam moments or SGD
trace, the schedule's count and a pending ``MultiSteps`` accumulation, so a
JAX run carries on here as it would there.

Not here (each raises): several devices in one process (ROADMAP C14: one
process per card) and a kernel head on a pooling other than GeM or NetVLAD
(as the JAX ``make_train_step`` refuses it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.data.images import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
    params_to_state_dict,
    variables_to_state_dict,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.init import init_random_
from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (
    global_batch_stats,
    remat,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    RetrievalNet,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.losses import (
    contrastive_loss,
    triplet_loss,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel.distributed import (
    all_reduce_sum,
    broadcast_,
    group_size,
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
    remat: bool = False            # checkpoint each trunk segment (models.resnet.remat)


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
    if mesh is not None and len(set(mesh.local_devices)) > 1:
        raise NotImplementedError(
            f"a train mesh whose shards lie on {len(set(mesh.local_devices))} devices in one "
            f"process: data-parallel training runs one process per card (ROADMAP C14); "
            f"launch a process per card under torch.distributed")
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
                       device: DeviceLike = "cuda", mesh=None) -> TrainState:
    """The model on ``device`` in train mode, holding ``state_dict`` or random
    weights from ``torch.Generator().manual_seed(seed)``, with a fresh
    optimizer over all its parameters. With a ``mesh`` (the train step's)
    every process of its data group takes the group's first process's
    parameters and buffers, as DDP does."""
    check_trainable(model, cfg, mesh)
    dev = resolve_device(device)
    if state_dict is None:
        init_random_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    model.to(dev).train()
    if mesh is not None:
        broadcast_(list(model.parameters()) + list(model.buffers()), mesh.data_group)
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


def apply_micro_step(state: TrainState, update_every: int, group=None,
                     n_proc: int = 1) -> None:
    """Count one micro-batch whose gradients ``backward`` has added into the
    parameters' ``.grad``; on every ``update_every``-th, average the summed
    gradients, step the optimizer and the lr schedule. The caller zeroes the
    gradients before the first micro-batch of an update (``micro == 0``).

    ``n_proc > 1``: the data group (``group``) of a data-parallel step, of
    that many processes; their summed gradients are all-reduced as one flat
    tensor and averaged over the group too, once per applied update."""
    state.step += 1
    state.micro += 1
    if state.micro < update_every:
        return
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    if n_proc > 1 and grads:
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
        flat.div_(n_proc * update_every)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))
    elif update_every > 1:
        for g in grads:
            g.div_(update_every)
    state.optimizer.step()
    state.scheduler.step()
    state.micro = 0


def pending_gradients(state: TrainState, mesh=None) -> Dict[str, torch.Tensor]:
    """The summed gradients of the ``state.micro`` micro-batches a pending
    update holds, by parameter name, on the CPU (empty where none is
    pending). With a ``mesh`` (the train step's; every process of its data
    group calls this) it is the data group's mean of the processes' sums:
    loaded back into every process, ``apply_micro_step``'s all-reduce over
    the group and its division by the group's size give that sum again."""
    if not state.micro:
        return {}
    named = [(n, p.grad) for n, p in state.model.named_parameters() if p.grad is not None]
    group = None if mesh is None else mesh.data_group
    n_proc = 1 if mesh is None else group_size(group)
    if n_proc > 1 and named:
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for _, g in named]), group) / n_proc
        parts = flat.split([g.numel() for _, g in named])
        grads = [v.view_as(g) for (_, g), v in zip(named, parts)]
    else:
        grads = [g for _, g in named]
    return {n: g.detach().cpu().clone() for (n, _), g in zip(named, grads)}


def set_pending_gradients(state: TrainState, grads: Mapping[str, torch.Tensor],
                          micro: int) -> None:
    """Put a pending update of ``micro`` micro-batches, whose summed
    gradients are ``grads`` (by parameter name), into ``state``: the next
    micro-batch's ``backward`` adds to them."""
    state.micro = int(micro)
    state.optimizer.zero_grad(set_to_none=True)
    if not state.micro:
        return
    named = dict(state.model.named_parameters())
    unknown = sorted(set(grads) - set(named))
    if unknown:
        raise ValueError(f"pending gradients of parameters the model lacks: {unknown}")
    for n, g in grads.items():
        p = named[n]
        p.grad = g.to(device=p.device, dtype=p.dtype).clone()


# optax's state of each core transform of the JAX trainer's chain
# (``make_optimizer`` there): scale_by_adam's and trace's fields
OPTAX_CORE = {"adam": ("count", "mu", "nu"), "sgd": ("trace",)}


def _optax_parts(opt_state: Any, cfg: TrainConfig) -> Tuple[Mapping, int, int, Any]:
    """The JAX trainer's optax state, ``[add_decayed_weights, scale_by_adam
    | trace, scale_by_schedule]``, inside ``MultiSteps`` where
    ``update_every > 1``, as ``(core state, applied updates, pending
    micro-batches, acc_grads)``. Raises naming what does not match ``cfg``
    and where the update counts disagree."""
    k = max(int(cfg.update_every), 1)
    multi = isinstance(opt_state, Mapping) and "inner_opt_state" in opt_state
    if multi != (k > 1):
        kind = "optax.MultiSteps (update_every > 1)" if multi else "a chain without " \
            "optax.MultiSteps (update_every 1)"
        raise ValueError(f"the checkpoint's optimizer state is {kind}; the run asks "
                         f"update_every {k}")
    chain, mini, acc, counts = opt_state, 0, None, {}
    if multi:
        chain, acc = opt_state["inner_opt_state"], opt_state["acc_grads"]
        mini = int(opt_state["mini_step"])
        counts["gradient_step"] = int(opt_state["gradient_step"])
        if not 0 <= mini < k:
            raise ValueError(f"the checkpoint holds {mini} pending micro-batches; the run "
                             f"asks update_every {k}")
    if not (isinstance(chain, (list, tuple)) and len(chain) == 3 and chain[0] is None
            and all(isinstance(c, Mapping) for c in chain[1:]) and "count" in chain[2]):
        raise ValueError("the checkpoint's optimizer state is not the JAX trainer's chain "
                         "add_decayed_weights -> scale_by_adam | trace -> scale_by_schedule")
    core = chain[1]
    kind = next((name for name, keys in OPTAX_CORE.items() if set(core) == set(keys)), None)
    if kind != cfg.optimizer:
        raise ValueError(f"the checkpoint's optimizer state is {kind or 'unknown'} "
                         f"({sorted(core)}); the run asks --optimizer {cfg.optimizer}")
    counts["scale_by_schedule"] = int(chain[2]["count"])
    if kind == "adam":
        counts["scale_by_adam"] = int(core["count"])
    if len(set(counts.values())) != 1:
        raise ValueError(f"the optimizer state's update counts disagree: {counts}")
    return core, counts["scale_by_schedule"], mini, acc


def load_jax_train_state(state: TrainState, tree: Mapping[str, Any],
                         cfg: TrainConfig) -> TrainState:
    """Load the JAX package's train state ``{params, batch_stats, opt_state,
    step}`` (as ``utils.orbax.read_orbax`` gives it) into ``state``, made by
    :func:`create_train_state` with the run's ``cfg``: the weights and BN
    statistics; Adam's per-parameter ``step``, ``exp_avg`` and
    ``exp_avg_sq`` (optax's count, ``mu`` and ``nu``) or SGD's
    ``momentum_buffer`` (``trace``); the schedule's count as ``LambdaLR``'s
    ``last_epoch`` and the lr it gives; ``step``; and a pending
    ``MultiSteps`` accumulation as ``micro = mini_step`` with each ``.grad``
    ``acc_grads * mini_step`` (optax keeps the running mean, this package
    the sum). The state's structure must match ``cfg``'s optimizer and
    ``update_every``, as the JAX package's restore with ``target=state``
    requires; else it raises naming what differs."""
    model, opt, sched = state.model, state.optimizer, state.scheduler
    core, count, mini, acc = _optax_parts(tree["opt_state"], cfg)
    named = dict(model.named_parameters())
    names = list(named)
    variables = {"params": tree["params"], "batch_stats": tree.get("batch_stats") or {}}
    model.load_state_dict(variables_to_state_dict(variables, model.arch))

    def moments(key: str) -> Dict[str, torch.Tensor]:
        return params_to_state_dict(core[key], model.arch, names)

    index = {id(p): i for i, p in enumerate(p for g in opt.param_groups for p in g["params"])}
    if cfg.optimizer == "adam":
        mu, nu = moments("mu"), moments("nu")

        def param_state(n):
            return {"step": torch.tensor(float(count)), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    else:
        trace = moments("trace")

        def param_state(n):
            return {"momentum_buffer": trace[n]}
    # optax's zero moments before its first update are torch's empty state
    per_param = {index[id(named[n])]: param_state(n) for n in names} if count else {}
    osd = opt.state_dict()
    osd["state"] = per_param
    opt.load_state_dict(osd)  # to each parameter's device, "step" kept on the host
    lrs = [base * fn(count) for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
    for group, lr in zip(opt.param_groups, lrs):
        group["lr"] = lr
    ssd = sched.state_dict()  # a schedule stepped ``count`` times
    ssd.update(last_epoch=count, _step_count=count + 1, _last_lr=lrs)
    sched.load_state_dict(ssd)
    state.step = int(np.asarray(tree["step"]))
    pending = {}
    if mini:
        pending = {n: g * mini for n, g in params_to_state_dict(acc, model.arch, names).items()}
    set_pending_gradients(state, pending, mini)
    return state


def data_slice(mesh, batch: int) -> slice:
    """The rows of a global batch of ``batch`` tuples this process trains on:
    ``batch / D`` for each of its data rows, contiguous. Refuses a batch the
    data axis does not divide, as the JAX step's sharding does."""
    D = mesh.shape.get("data", 1)
    if batch % D:
        raise ValueError(f"a global batch of {batch} tuples over a data axis of {D}: "
                         f"the batch must be a multiple of the data axis")
    rows = [mesh.data_index(j) for j in mesh.data_rows]
    n = batch // D
    return slice(rows[0] * n, (rows[-1] + 1) * n)


def make_train_step(model: RetrievalNet, cfg: TrainConfig = TrainConfig(), mesh=None,
                    from_u8: bool = False):
    """The train step: ``step(state, pixels, labels) -> (state, loss)`` or,
    with ``from_u8=True``, ``step(state, pixels_u8 [B,T,H,W,3] uint8, sizes
    [B,T,2] int32, labels)``, the production tuple path: normalization, the
    validity mask and zeroed padding on the device, and the mask into the
    mask-aware head (the rect kernels with ``use_kernel``). Inputs may be
    numpy arrays or tensors; they go to the model's device. The loss comes
    back as a detached 0-d tensor. After an applied update the parameters'
    ``.grad`` hold the (averaged) gradients it used.

    With a ``mesh`` every process passes the same global batch and trains on
    its slice (:func:`data_slice`); BatchNorm, the gradients and the loss are
    the global batch's (``models.resnet.global_batch_stats``, split-invariant
    float64 sums, where the data group holds several processes;
    ``F.batch_norm`` in a group of one), so the numbers are those of one
    process on the global batch with its BatchNorm on that path. All of a
    process's shards must share its device (one process per card)."""
    check_trainable(model, cfg, mesh)
    k = max(int(cfg.update_every), 1)
    group = None if mesh is None else mesh.data_group
    n_proc = 1 if mesh is None else group_size(group)

    def run(state: TrainState, x: torch.Tensor, labels, mask) -> Tuple[TrainState, torch.Tensor]:
        if state.micro == 0:
            state.optimizer.zero_grad(set_to_none=True)
        with global_batch_stats(group) if n_proc > 1 else contextlib.nullcontext(), \
                remat() if cfg.remat else contextlib.nullcontext():
            loss = _tuple_loss(state.model, cfg, x, _as_tensor(labels, x.device), mask)
            loss.backward()
        apply_micro_step(state, k, group, n_proc)
        loss = loss.detach()
        if n_proc > 1:
            loss = all_reduce_sum(loss, group) / n_proc
        return state, loss

    def local(*arrays):
        if mesh is None:
            return arrays
        rows = data_slice(mesh, arrays[0].shape[0])
        return tuple(a[rows] for a in arrays)

    if from_u8:
        def step_u8(state: TrainState, pixels_u8, sizes, labels):
            dev = _device(state.model)
            pixels_u8, sizes, labels = local(pixels_u8, sizes, labels)
            x, mask = u8_to_input(_as_tensor(pixels_u8, dev), _as_tensor(sizes, dev))
            return run(state, x, labels, mask)

        return step_u8

    def step(state: TrainState, pixels, labels):
        pixels, labels = local(pixels, labels)
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
