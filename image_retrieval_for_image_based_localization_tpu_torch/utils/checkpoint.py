"""Checkpoint and resume, with the JAX package's layout of names.

A run directory holds ``latest`` (and ``best`` when ``is_best``), each a
directory with one ``state.pt``: ``torch.save`` of the train state as
``{model, optimizer, scheduler, step}`` state dicts. Beside each sits
``<name>.meta.json``, the model's hyperparameters (cirtorch's checkpoint
``meta``). ``load_checkpoint`` takes the run directory or the checkpoint
directory itself, as the JAX package's does.

It also reads the JAX package's run directories: there each checkpoint is
an Orbax directory (it holds ``_CHECKPOINT_METADATA``), read by
``utils/orbax.py`` without Orbax into the tree the JAX loader restores,
as numpy arrays. Such a tree cannot be loaded into a ``TrainState``: the
optimizer state is optax's chained state (ROADMAP C3).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from image_retrieval_for_image_based_localization_tpu_torch.utils.orbax import (
    is_orbax_checkpoint,
    read_orbax,
)

STATE_FILE = "state.pt"


def _as_tree(state: Any) -> Dict[str, Any]:
    """A ``TrainState`` as state dicts; a dict as it is."""
    if isinstance(state, dict):
        return state
    return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(), "step": int(state.step)}


def _write(path: str, tree: Dict[str, Any], meta: Optional[Dict], meta_path: str) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if meta is not None:
        with open(meta_path, "w") as f:
            json.dump(meta, f)


def save_checkpoint(directory: str, state: Any, meta: Optional[Dict] = None,
                    name: str = "latest", is_best: bool = False) -> str:
    """Save a train state (or a dict of state dicts) and its meta under
    ``directory/name``; also as ``directory/best`` when ``is_best``.
    Returns the checkpoint's path."""
    directory = os.path.abspath(directory)
    tree = _as_tree(state)
    path = os.path.join(directory, name)
    _write(path, tree, meta, os.path.join(directory, f"{name}.meta.json"))
    if is_best:
        best = os.path.join(directory, "best")
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


def load_checkpoint(directory: str, name: str = "latest", target: Any = None
                    ) -> Tuple[Any, Optional[Dict]]:
    """Load ``directory/name`` (or ``directory`` itself when it is the
    checkpoint) and its meta. With ``target`` (a ``TrainState``) the state
    dicts are loaded into it and it is returned; else the dict of state
    dicts, its tensors on the CPU. A JAX package's Orbax checkpoint gives
    its tree of numpy arrays, and refuses a ``target``."""
    path, directory, name = resolve_checkpoint(directory, name)
    if is_orbax_checkpoint(path):
        if target is not None:
            raise ValueError(f"{path}: a JAX package's checkpoint does not load into a "
                             f"TrainState (optax's optimizer state; ROADMAP C3)")
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
    target.model.load_state_dict(tree["model"])
    target.optimizer.load_state_dict(tree["optimizer"])
    target.scheduler.load_state_dict(tree["scheduler"])
    target.step = int(tree["step"])
    return target, meta
