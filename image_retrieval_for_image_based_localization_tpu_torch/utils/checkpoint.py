"""Checkpoint and resume, with the JAX package's layout of names.

A run directory holds ``latest`` (and ``best`` when ``is_best``), each a
directory with one ``state.pt``: ``torch.save`` of the train state as
``{model, optimizer, scheduler, step, micro, pending}``: the state dicts,
the micro-batch steps taken, and the micro-batches a pending gradient
accumulation holds (``update_every > 1``) with their summed gradients by
parameter name (empty where ``micro`` is 0), as the JAX package's
checkpoint keeps ``optax.MultiSteps``' ``mini_step`` and ``acc_grads``.
A checkpoint without ``micro`` loads with none pending. Beside each sits
``<name>.meta.json``, the model's hyperparameters (cirtorch's checkpoint
``meta``). ``load_checkpoint`` takes the run directory or the checkpoint
directory itself, as the JAX package's does.

It also reads the JAX package's run directories: there each checkpoint is
an Orbax directory (it holds ``_CHECKPOINT_METADATA``), read by
``utils/orbax.py`` without Orbax into the tree the JAX loader restores,
as numpy arrays. With a ``target`` such a tree loads into a ``TrainState``
through ``training.trainer.load_jax_train_state`` (optax's state carried
into ``torch.optim``), so ``train --resume`` carries on a JAX run. The
next checkpoint written there is in this package's format, and the JAX
checkpoint it replaces is moved aside, not deleted: an Orbax ``latest``
(or ``best``) becomes ``latest.orbax`` (``best.orbax``), its meta is copied
to ``latest.orbax.meta.json``, and the JAX package's
``load_checkpoint(run, name="latest.orbax")`` restores it as it was. A
later move replaces an older ``<name>.orbax``, so the newest JAX state is
the one kept.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
    load_jax_train_state,
    pending_gradients,
    set_pending_gradients,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.orbax import (
    is_orbax_checkpoint,
    read_orbax,
)

STATE_FILE = "state.pt"


def _as_tree(state: Any, mesh=None) -> Dict[str, Any]:
    """A ``TrainState`` as state dicts, with its pending accumulation (over
    the ``mesh``'s data group, ``pending_gradients``); a dict as it is."""
    if isinstance(state, dict):
        return state
    return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(), "step": int(state.step),
            "micro": int(state.micro), "pending": pending_gradients(state, mesh)}


ORBAX_SUFFIX = ".orbax"


def _move_orbax_aside(path: str) -> None:
    """Move a JAX run's Orbax checkpoint at ``path`` to ``path.orbax`` (an
    older one there is replaced) and copy its meta beside it, so the JAX
    package still restores it once this package's checkpoint takes the
    name."""
    if not is_orbax_checkpoint(path):
        return
    aside = path + ORBAX_SUFFIX
    shutil.rmtree(aside, ignore_errors=True)
    os.replace(path, aside)
    meta = path + ".meta.json"
    if os.path.exists(meta):
        shutil.copyfile(meta, aside + ".meta.json")


def _write(path: str, tree: Dict[str, Any], meta: Optional[Dict], meta_path: str) -> None:
    _move_orbax_aside(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if meta is not None:
        with open(meta_path, "w") as f:
            json.dump(meta, f)


def save_checkpoint(directory: str, state: Any, meta: Optional[Dict] = None,
                    name: str = "latest", is_best: bool = False, mesh=None) -> str:
    """Save a train state (or a dict of state dicts) and its meta under
    ``directory/name``; also as ``directory/best`` when ``is_best``. In a
    data-parallel run every process of the train ``mesh``'s data group
    calls it (the pending gradients are the group's). Returns the
    checkpoint's path."""
    directory = os.path.abspath(directory)
    tree = _as_tree(state, mesh)
    path = os.path.join(directory, name)
    _write(path, tree, meta, os.path.join(directory, f"{name}.meta.json"))
    if is_best:
        best = os.path.join(directory, "best")
        if not is_orbax_checkpoint(best):  # a JAX run's best is moved aside by _write
            shutil.rmtree(best, ignore_errors=True)
        _write(best, tree, meta, os.path.join(directory, "best.meta.json"))
    return path


def _is_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(path, STATE_FILE)) or is_orbax_checkpoint(path)


def resolve_checkpoint(directory: str, name: str = "latest") -> Tuple[str, str, str]:
    """``(path, run_directory, name)`` of ``directory/name``, or of
    ``directory`` itself when that is the checkpoint."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, name)
    if not _is_checkpoint(path) and _is_checkpoint(directory):
        path = directory
        directory, name = os.path.split(directory)
    return path, directory, name


def is_jax_checkpoint(directory: str, name: str = "latest") -> bool:
    """True where ``directory/name`` (or ``directory``) is the JAX
    package's Orbax checkpoint."""
    return is_orbax_checkpoint(resolve_checkpoint(directory, name)[0])


def load_checkpoint(directory: str, name: str = "latest", target: Any = None,
                    cfg: Any = None) -> Tuple[Any, Optional[Dict]]:
    """Load ``directory/name`` (or ``directory`` itself when it is the
    checkpoint) and its meta. With ``target`` (a ``TrainState``) the state
    dicts are loaded into it and it is returned; else the dict of state
    dicts, its tensors on the CPU. A JAX package's Orbax checkpoint gives
    its tree of numpy arrays; into a ``target`` it loads through
    ``load_jax_train_state``, which needs the run's ``TrainConfig`` as
    ``cfg`` (its optimizer and ``update_every`` must match the state's)."""
    path, directory, name = resolve_checkpoint(directory, name)
    jax_tree = is_orbax_checkpoint(path)
    if jax_tree:
        if target is not None and cfg is None:
            raise ValueError(f"{path}: a JAX package's train state loads into a TrainState "
                             f"with the run's TrainConfig (cfg=)")
        tree = read_orbax(path)
    else:
        tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                          weights_only=True)
    meta = None
    meta_path = os.path.join(directory, f"{name}.meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if target is None:
        return tree, meta
    if jax_tree:
        return load_jax_train_state(target, tree, cfg), meta
    target.model.load_state_dict(tree["model"])
    target.optimizer.load_state_dict(tree["optimizer"])
    target.scheduler.load_state_dict(tree["scheduler"])
    target.step = int(tree["step"])
    set_pending_gradients(target, tree.get("pending", {}), tree.get("micro", 0))
    return target, meta
