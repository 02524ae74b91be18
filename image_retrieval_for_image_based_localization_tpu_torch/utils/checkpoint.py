"""Checkpoint and resume, with the JAX package's layout of names.

A run directory holds ``latest`` (and ``best`` when ``is_best``), each a
directory with one ``state.pt``: ``torch.save`` of the train state as
``{model, optimizer, scheduler, step}`` state dicts. Beside each sits
``<name>.meta.json``, the model's hyperparameters (cirtorch's checkpoint
``meta``). ``load_checkpoint`` takes the run directory or the checkpoint
directory itself, as the JAX package's does. The JAX package writes Orbax
trees; reading those here is not supported.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

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


def load_checkpoint(directory: str, name: str = "latest", target: Any = None
                    ) -> Tuple[Any, Optional[Dict]]:
    """Load ``directory/name`` (or ``directory`` itself when it is the
    checkpoint) and its meta. With ``target`` (a ``TrainState``) the state
    dicts are loaded into it and it is returned; else the dict of state
    dicts, its tensors on the CPU."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, name)
    if not os.path.exists(os.path.join(path, STATE_FILE)) and \
            os.path.exists(os.path.join(directory, STATE_FILE)):
        path = directory
        directory, name = os.path.split(directory)
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
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
