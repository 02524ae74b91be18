"""Carry weights across from the JAX package's flax variables.

The inverse of the JAX package's ``models/torch_port.py`` (``port_resnet_trunk``,
``port_vgg_trunk``, ``port_alexnet_trunk``, ``port_squeezenet_trunk``,
``port_densenet_trunk`` and ``port_retrieval_net``): flax variables as
nested dicts of numpy arrays become this package's ``state_dict``.

  * conv kernels: HWIO -> OIHW; VGG's and AlexNet's ``conv{i}`` (with bias)
    go to torchvision's ``features.{idx}``, SqueezeNet's ``fire{i}`` to
    ``features.{idx}.squeeze/expand1x1/expand3x3``, DenseNet's
    ``block{b}_layer{l}`` to ``features.denseblock{b}.denselayer{l}``;
  * BatchNorm: scale/bias params + mean/var batch_stats -> weight/bias +
    running_mean/running_var (``num_batches_tracked`` = 0);
  * whitening Dense: [in, out] kernel -> [out, in] Linear weight;
  * GeM p: scalar -> cirtorch's [1]; GeMmp's [C] stays [C];
  * NetVLAD: ``centroids`` -> ``pool.centroids``, ``assign_w`` [C, K] ->
    ``pool.conv.weight`` [K, C, 1, 1], ``assign_b`` -> ``pool.conv.bias``.

``cirtorch_to_torchvision_keys`` is a copy of the JAX package's, so a
cirtorch checkpoint (numeric ``features.N`` trunk keys) loads here too.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.models.alexnet import ALEXNET_CFG
from image_retrieval_for_image_based_localization_tpu_torch.models.densenet import DENSENET_SPECS
from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import RESNET_SPECS
from image_retrieval_for_image_based_localization_tpu_torch.models.squeezenet import fire_indices
from image_retrieval_for_image_based_localization_tpu_torch.models.vgg import conv_indices


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _kernel(conv) -> torch.Tensor:
    return _t(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))


def _bn(sd: Dict[str, torch.Tensor], params, stats, bn_key: str):
    sd[f"{bn_key}.weight"] = _t(params["bn"]["scale"])
    sd[f"{bn_key}.bias"] = _t(params["bn"]["bias"])
    sd[f"{bn_key}.running_mean"] = _t(stats["bn"]["mean"])
    sd[f"{bn_key}.running_var"] = _t(stats["bn"]["var"])
    sd[f"{bn_key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _convbn(sd: Dict[str, torch.Tensor], params, stats, conv_key: str, bn_key: str):
    sd[f"{conv_key}.weight"] = _kernel(params["conv"])
    _bn(sd, params, stats, bn_key)


def _biased(sd: Dict[str, torch.Tensor], conv, key: str):
    sd[f"{key}.weight"] = _kernel(conv)
    sd[f"{key}.bias"] = _t(conv["bias"])


def trunk_state_dict(variables: Mapping[str, Any], arch: str,
                     prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax ResNet trunk variables ``{'params', 'batch_stats'}`` ->
    torchvision-named trunk ``state_dict`` (keys under ``prefix``)."""
    params, stats = variables["params"], variables["batch_stats"]
    kind, stages, _ = RESNET_SPECS[arch]
    n_convs = 2 if kind == "basic" else 3
    sd: Dict[str, torch.Tensor] = {}
    _convbn(sd, params["stem"], stats["stem"], f"{prefix}conv1", f"{prefix}bn1")
    for stage_i, depth in enumerate(stages):
        for block_i in range(depth):
            name = f"layer{stage_i + 1}_{block_i}"
            tname = f"{prefix}layer{stage_i + 1}.{block_i}"
            bp, bs = params[name], stats[name]
            for ci in range(1, n_convs + 1):
                _convbn(sd, bp[f"cb{ci}"], bs[f"cb{ci}"], f"{tname}.conv{ci}",
                        f"{tname}.bn{ci}")
            if "down" in bp:
                _convbn(sd, bp["down"], bs["down"], f"{tname}.downsample.0",
                        f"{tname}.downsample.1")
    return sd


def vgg_state_dict(params: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax VGG-16 trunk params (``conv{i}``) -> torchvision ``features``
    keys ``{prefix}{idx}.weight/bias`` (the inverse of ``port_vgg_trunk``)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, idx in enumerate(conv_indices()):
        _biased(sd, params[f"conv{i}"], f"{prefix}{idx}")
    return sd


def alexnet_state_dict(params: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax AlexNet trunk params (``conv{i}``) -> torchvision ``features``
    keys ``{prefix}{idx}.weight/bias`` (the inverse of ``port_alexnet_trunk``)."""
    sd: Dict[str, torch.Tensor] = {}
    idx, conv_i = 0, 0
    for v in ALEXNET_CFG:
        if v != "M":
            _biased(sd, params[f"conv{conv_i}"], f"{prefix}{idx}")
            conv_i += 1
        idx += 1 if v == "M" else 2  # Conv2d + ReLU
    return sd


def squeezenet_state_dict(params: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax SqueezeNet 1.1 trunk params (``conv0``, ``fire{i}``) -> torchvision
    ``features`` keys (the inverse of ``port_squeezenet_trunk``)."""
    sd: Dict[str, torch.Tensor] = {}
    _biased(sd, params["conv0"], f"{prefix}0")
    for i, idx in enumerate(fire_indices()):
        fire = params[f"fire{i}"]
        for jax_name, torch_name in (("squeeze", "squeeze"), ("expand1", "expand1x1"),
                                     ("expand3", "expand3x3")):
            _biased(sd, fire[jax_name], f"{prefix}{idx}.{torch_name}")
    return sd


def densenet_state_dict(variables: Mapping[str, Any], arch: str,
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax DenseNet trunk variables ``{'params', 'batch_stats'}`` ->
    torchvision-named trunk ``state_dict`` (the inverse of
    ``port_densenet_trunk``)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {f"{prefix}conv0.weight": _kernel(params["conv0"])}
    _bn(sd, params["norm0"], stats["norm0"], f"{prefix}norm0")
    _, blocks, _ = DENSENET_SPECS[arch]
    for bi, n_layers in enumerate(blocks):
        for li in range(n_layers):
            name = f"block{bi + 1}_layer{li + 1}"
            t = f"{prefix}denseblock{bi + 1}.denselayer{li + 1}"
            p, s = params[name], stats[name]
            for k in ("1", "2"):
                _bn(sd, p[f"norm{k}"], s[f"norm{k}"], f"{t}.norm{k}")
                sd[f"{t}.conv{k}.weight"] = _kernel(p[f"conv{k}"])
        if bi < len(blocks) - 1:
            name = f"transition{bi + 1}"
            _bn(sd, params[name]["norm"], stats[name]["norm"], f"{prefix}{name}.norm")
            sd[f"{prefix}{name}.conv.weight"] = _kernel(params[name]["conv"])
    _bn(sd, params["norm5"], stats["norm5"], f"{prefix}norm5")
    return sd


def variables_to_state_dict(variables: Mapping[str, Any], arch: str) -> Dict[str, torch.Tensor]:
    """Flax ``RetrievalNet`` variables -> this package's ``RetrievalNet``
    ``state_dict`` (cirtorch layout: ``features.*``, ``pool.p`` or
    ``pool.centroids`` / ``pool.conv.*``, ``whiten.*``)."""
    params = variables["params"]
    trunk = {"params": params["trunk"],
             "batch_stats": variables.get("batch_stats", {}).get("trunk", {})}
    if arch == "vgg16":
        sd = vgg_state_dict(params["trunk"], prefix="features.")
    elif arch == "alexnet":
        sd = alexnet_state_dict(params["trunk"], prefix="features.")
    elif arch == "squeezenet1_1":
        sd = squeezenet_state_dict(params["trunk"], prefix="features.")
    elif arch.startswith("resnet"):
        sd = trunk_state_dict(trunk, arch, prefix="features.")
    elif arch in DENSENET_SPECS:
        sd = densenet_state_dict(trunk, arch, prefix="features.")
    else:
        raise ValueError(f"unknown arch {arch!r}")
    if "gem_p" in params:
        sd["pool.p"] = _t(np.asarray(params["gem_p"]).reshape(-1))
    if "centroids" in params:
        w = np.asarray(params["assign_w"])  # [C, K]
        sd["pool.centroids"] = _t(params["centroids"])
        sd["pool.conv.weight"] = _t(w.T.reshape(w.shape[1], w.shape[0], 1, 1))
        sd["pool.conv.bias"] = _t(params["assign_b"])
    if "whiten" in params:
        sd["whiten.weight"] = _t(np.asarray(params["whiten"]["kernel"]).T)
        sd["whiten.bias"] = _t(params["whiten"]["bias"])
    return sd


# cirtorch builds the trunk as nn.Sequential(*children), which renames the
# children of archs with NAMED top-level modules to numeric indices
# (resnet: features.0 = conv1, features.4.0.conv1 = layer1.0.conv1).
_CIRTORCH_SEQ_NAMES = {
    "resnet": ["conv1", "bn1", "relu", "maxpool",
               "layer1", "layer2", "layer3", "layer4"],
    "densenet": ["conv0", "norm0", "relu0", "pool0",
                 "denseblock1", "transition1", "denseblock2", "transition2",
                 "denseblock3", "transition3", "denseblock4", "norm5"],
}


def cirtorch_to_torchvision_keys(
    sd: Mapping[str, Any], arch: str, prefix: str = "features."
) -> Mapping[str, Any]:
    """Translate cirtorch's numeric ``features.N.*`` trunk keys back to
    torchvision attribute names (``features.conv1.*`` etc.) for archs whose
    top-level modules are named. No-op when keys already look torchvision
    (or the arch's torchvision layout is numeric anyway)."""
    family = "resnet" if arch.startswith("resnet") else (
        "densenet" if arch.startswith("densenet") else None
    )
    if family is None:
        return sd
    names = _CIRTORCH_SEQ_NAMES[family]
    if not any(k.startswith(f"{prefix}0.") or k == f"{prefix}0.weight" for k in sd):
        return sd  # already torchvision-named
    out = {}
    for k, v in sd.items():
        if k.startswith(prefix):
            rest = k[len(prefix):]
            head, _, tail = rest.partition(".")
            if head.isdigit() and int(head) < len(names):
                k = f"{prefix}{names[int(head)]}" + ("." + tail if tail else "")
        out[k] = v
    return out
