"""Model zoo and checkpoint-meta factory (the JAX package's ``models/zoo.py``).

Named presets that pair a ``ModelConfig`` with the cirtorch lineage's
networks, the checkpoint ``meta`` contract (``model_to_meta`` /
``create_model_from_meta``, cirtorch's ``init_network(meta)``), and loading
a model with its weights from a local file: a ``.pth``/``.pt`` state dict
(this package's layout, or cirtorch's with numeric trunk keys) or a
checkpoint directory of this package (``utils.checkpoint``), and
``load_pretrained``, which fetches a zoo network through ``data.download``.
"""

from __future__ import annotations

import importlib
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
    cirtorch_to_torchvision_keys,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    RetrievalNet,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import ModelConfig
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)

# Named presets mirroring the cirtorch-lineage zoo (the JAX package's list).
MODEL_ZOO: Dict[str, ModelConfig] = {
    "resnet18-gem": ModelConfig(arch="resnet18", pooling="gem"),
    "resnet50-gem": ModelConfig(arch="resnet50", pooling="gem"),
    "resnet101-gem": ModelConfig(arch="resnet101", pooling="gem"),
    "resnet101-gem-whiten": ModelConfig(arch="resnet101", pooling="gem", whiten_dim=2048),
    "vgg16-gem": ModelConfig(arch="vgg16", pooling="gem"),
    "vgg16-mac": ModelConfig(arch="vgg16", pooling="mac"),
    "vgg16-rmac": ModelConfig(arch="vgg16", pooling="rmac"),
    "vgg16-netvlad64": ModelConfig(arch="vgg16", pooling="netvlad", netvlad_clusters=64),
    "alexnet-gem": ModelConfig(arch="alexnet", pooling="gem"),
    "alexnet-mac": ModelConfig(arch="alexnet", pooling="mac"),
    "squeezenet1_1-gem": ModelConfig(arch="squeezenet1_1", pooling="gem"),
    "densenet121-gem": ModelConfig(arch="densenet121", pooling="gem"),
}


def model_to_meta(model: RetrievalNet) -> Dict[str, Any]:
    """Serializable hyperparameter dict (the checkpoint 'meta' contract)."""
    return {"arch": model.arch, "pooling": model.pooling, "regional": model.regional,
            "whiten_dim": model.whiten_dim, "netvlad_clusters": model.netvlad_clusters,
            "gem_p": model.gem_p}


def create_model_from_meta(meta: Dict[str, Any], **overrides) -> RetrievalNet:
    """Rebuild a RetrievalNet from a checkpoint meta dict."""
    kw = dict(arch=meta.get("arch", "resnet50"), pooling=meta.get("pooling", "gem"),
              regional=bool(meta.get("regional", False)), whiten_dim=meta.get("whiten_dim"),
              netvlad_clusters=meta.get("netvlad_clusters", 64), gem_p=meta.get("gem_p", 3.0))
    kw.update(overrides)
    return RetrievalNet(**kw)


def create_model_from_zoo(name: str, **overrides) -> RetrievalNet:
    if name not in MODEL_ZOO:
        raise KeyError(f"unknown zoo model {name!r}; have {sorted(MODEL_ZOO)}")
    mc = MODEL_ZOO[name]
    kw = dict(arch=mc.arch, pooling=mc.pooling, regional=mc.regional, whiten_dim=mc.whiten_dim,
              netvlad_clusters=mc.netvlad_clusters, gem_p=mc.gem_p)
    kw.update(overrides)
    return RetrievalNet(**kw)


def load_model(name_or_meta, checkpoint: Optional[str] = None,
               arch_hint: Optional[str] = None) -> Tuple[RetrievalNet, Optional[Dict]]:
    """(model, state_dict or None) from a zoo name or a meta dict, with the
    weights of ``checkpoint`` loaded into the model when one is given: a
    ``.pth``/``.pt`` state dict (optionally under ``"state_dict"``; cirtorch's
    numeric trunk keys are renamed for ``arch_hint`` or the model's arch), or
    a checkpoint directory of this package (its ``best``, else the directory
    itself). The model is on the CPU in eval mode."""
    if isinstance(name_or_meta, str):
        model = create_model_from_zoo(name_or_meta)
    else:
        model = create_model_from_meta(name_or_meta)
    sd = None
    if checkpoint:
        if checkpoint.endswith((".pth", ".pt")):
            sd = _torch_load_untrusted(checkpoint)
            sd = sd.get("state_dict", sd)
            sd = dict(cirtorch_to_torchvision_keys(sd, arch_hint or model.arch))
        else:
            from image_retrieval_for_image_based_localization_tpu_torch.utils.checkpoint import (
                load_checkpoint,
            )

            tree, _ = load_checkpoint(checkpoint, name="best")
            sd = tree["model"]
        model.load_state_dict(sd)
    return model.eval(), sd


def meta_from_cirtorch(meta: Dict[str, Any]) -> Dict[str, Any]:
    """cirtorch checkpoint ``meta`` -> this package's meta contract.

    cirtorch stores {'architecture', 'pooling', 'whitening' (bool),
    'outputdim', 'mean', 'std', 'regional', optionally 'Lw'}; the pooling
    field may itself be a dict for NetVLAD variants."""
    arch = meta.get("architecture", meta.get("arch", "resnet101"))
    pooling = meta.get("pooling", "gem")
    clusters = None
    if isinstance(pooling, dict):  # older layouts: {'name': ..., ...}
        clusters = pooling.get("clusters", pooling.get("num_clusters"))
        pooling = pooling.get("name", "gem")
    out: Dict[str, Any] = {"arch": arch, "pooling": pooling}
    if clusters is not None:
        out["netvlad_clusters"] = int(clusters)
    if meta.get("whitening"):
        out["whiten_dim"] = int(meta.get("outputdim", 0)) or None
    return out


def cirtorch_Lw(meta: Dict[str, Any], dataset: str = "retrieval-SfM-120k", scale: str = "ss"):
    """Pre-learned supervised whitening ``(m, P)`` (float64) from a cirtorch
    checkpoint's ``meta['Lw']``, or None when it carries none. cirtorch nests
    ``meta['Lw'][dataset]['ss' | 'ms']`` (single- or multi-scale
    extraction); ``scale`` picks that level, falling back to whichever is
    present, and flat {'m', 'P'} entries work too."""
    lw = meta.get("Lw") or {}
    entry = lw.get(dataset) if isinstance(lw, dict) else None
    if entry is None and isinstance(lw, dict) and lw:
        entry = next(iter(lw.values()))  # any dataset's Lw
    if isinstance(entry, dict) and not ("m" in entry and "P" in entry):
        entry = entry.get(scale) or entry.get("ss") or entry.get("ms")
    if not isinstance(entry, dict) or "m" not in entry or "P" not in entry:
        return None
    m = np.asarray(entry["m"], dtype=np.float64).reshape(-1)
    P = np.asarray(entry["P"], dtype=np.float64)
    return m, P


def _torch_load_untrusted(path: str):
    """``torch.load`` for checkpoints from elsewhere: the restricted
    ``weights_only`` unpickler first, with numpy's array reconstruction
    allowed (cirtorch metas carry numpy arrays); the full unpickler only
    after a warning, for files the caller trusts."""
    allow = [np.ndarray, np.dtype]
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
        try:
            allow.append(importlib.import_module(mod)._reconstruct)
        except (ImportError, AttributeError):
            pass
    allow += [type(np.dtype(t)) for t in ("float32", "float64", "int64")]
    try:
        with torch.serialization.safe_globals(allow):
            return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 - any rejection by the restricted unpickler
        warnings.warn(f"restricted unpickle of {path} failed ({type(e).__name__}: {e}); "
                      "falling back to weights_only=False: only do this for checkpoints "
                      "you trust", stacklevel=2)
        return torch.load(path, map_location="cpu", weights_only=False)


def load_pretrained(name: str, data_root: str = "data",
                    whitening_dataset: str = "retrieval-SfM-120k", whitening_scale: str = "ss",
                    zoo_manifests=None, device: DeviceLike = "cuda"):
    """Fetch (or verify on disk) a pretrained zoo checkpoint and load it.

    The reference's ``init_network(pretrained-name)`` and download in one
    call: ``data.download.download_network`` resolves or downloads the
    ``.pth``, its cirtorch ``meta`` rebuilds the model
    (``meta_from_cirtorch``, ``create_model_from_meta``), and its
    ``state_dict`` loads natively (cirtorch's numeric trunk keys renamed to
    torchvision's; a one-element tensor such as GeM's ``p`` takes the
    model's shape). Any pre-learned Lw whitening comes back as ``(m, P)``
    for ``retrieval.index.Index.build(whitening_mP=...)``;
    ``whitening_scale`` ('ss' or 'ms') picks the checkpoint's single- or
    multi-scale Lw, as cirtorch does by whether extraction is multi-scale.

    Returns ``(model, whitening_mP_or_None)``, the model in eval mode with
    its weights on ``device``. The JAX function returns ``(model,
    variables, mP)``: its flax module holds no weights, so they come back
    as a separate variables tree; here they are the module's own.
    """
    from image_retrieval_for_image_based_localization_tpu_torch.data.download import (
        download_network,
    )

    path = download_network(data_root, name, manifests=zoo_manifests)
    ckpt = _torch_load_untrusted(path)
    meta = ckpt.get("meta", {}) if isinstance(ckpt, dict) else {}
    model = create_model_from_meta(meta_from_cirtorch(meta))
    own = model.state_dict()
    sd = {}
    for k, v in cirtorch_to_torchvision_keys(ckpt.get("state_dict", ckpt), model.arch).items():
        if k in own and v.shape != own[k].shape and v.numel() == own[k].numel() == 1:
            v = v.reshape(own[k].shape)
        sd[k] = v
    model.load_state_dict(sd)
    return (model.to(resolve_device(device)).eval(),
            cirtorch_Lw(meta, whitening_dataset, scale=whitening_scale))
