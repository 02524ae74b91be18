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

The same layout rules carry any tree shaped like the flax params into this
package's parameter names (``params_to_state_dict``): optax's Adam moments
``mu`` and ``nu``, SGD's momentum ``trace`` and ``MultiSteps``' pending
``acc_grads``. Each rule is a permutation or a reshape, so it holds for
elementwise optimizer state as it does for the weights.

``cirtorch_to_torchvision_keys`` is a copy of the JAX package's, so a
cirtorch checkpoint (numeric ``features.N`` trunk keys) loads here too.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.models.alexnet import ALEXNET_CFG
from image_retrieval_for_image_based_localization_tpu_torch.models.densenet import DENSENET_SPECS
from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import RESNET_SPECS
from image_retrieval_for_image_based_localization_tpu_torch.models.squeezenet import fire_indices
from image_retrieval_for_image_based_localization_tpu_torch.models.vgg import conv_indices


def _t(a) -> torch.Tensor:
    """A C-contiguous f32 tensor (a transposed kernel laid out as the
    parameter it becomes: a gradient or optimizer moment keeps its strides)."""
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True, order="C"))


def _kernel(conv) -> torch.Tensor:
    return _t(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))


def _at(stats, key: str):
    """``stats[key]``; None where there are no statistics (a params-shaped tree)."""
    return None if stats is None else stats[key]


def _bn(sd: Dict[str, torch.Tensor], params, stats, bn_key: str):
    sd[f"{bn_key}.weight"] = _t(params["bn"]["scale"])
    sd[f"{bn_key}.bias"] = _t(params["bn"]["bias"])
    if stats is None:
        return
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
    torchvision-named trunk ``state_dict`` (keys under ``prefix``); with
    ``batch_stats`` None, the parameters alone."""
    params, stats = variables["params"], variables["batch_stats"]
    kind, stages, _ = RESNET_SPECS[arch]
    n_convs = 2 if kind == "basic" else 3
    sd: Dict[str, torch.Tensor] = {}
    _convbn(sd, params["stem"], _at(stats, "stem"), f"{prefix}conv1", f"{prefix}bn1")
    for stage_i, depth in enumerate(stages):
        for block_i in range(depth):
            name = f"layer{stage_i + 1}_{block_i}"
            tname = f"{prefix}layer{stage_i + 1}.{block_i}"
            bp, bs = params[name], _at(stats, name)
            for ci in range(1, n_convs + 1):
                _convbn(sd, bp[f"cb{ci}"], _at(bs, f"cb{ci}"), f"{tname}.conv{ci}",
                        f"{tname}.bn{ci}")
            if "down" in bp:
                _convbn(sd, bp["down"], _at(bs, "down"), f"{tname}.downsample.0",
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
    ``port_densenet_trunk``); with ``batch_stats`` None, the parameters
    alone."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {f"{prefix}conv0.weight": _kernel(params["conv0"])}
    _bn(sd, params["norm0"], _at(stats, "norm0"), f"{prefix}norm0")
    _, blocks, _ = DENSENET_SPECS[arch]
    for bi, n_layers in enumerate(blocks):
        for li in range(n_layers):
            name = f"block{bi + 1}_layer{li + 1}"
            t = f"{prefix}denseblock{bi + 1}.denselayer{li + 1}"
            p, s = params[name], _at(stats, name)
            for k in ("1", "2"):
                _bn(sd, p[f"norm{k}"], _at(s, f"norm{k}"), f"{t}.norm{k}")
                sd[f"{t}.conv{k}.weight"] = _kernel(p[f"conv{k}"])
        if bi < len(blocks) - 1:
            name = f"transition{bi + 1}"
            _bn(sd, params[name]["norm"], _at(_at(stats, name), "norm"), f"{prefix}{name}.norm")
            sd[f"{prefix}{name}.conv.weight"] = _kernel(params[name]["conv"])
    _bn(sd, params["norm5"], _at(stats, "norm5"), f"{prefix}norm5")
    return sd


def _state_dict(params: Mapping[str, Any], stats: Optional[Mapping[str, Any]],
                arch: str) -> Dict[str, torch.Tensor]:
    """Flax ``RetrievalNet`` params and the trunk's batch statistics (None:
    the parameters alone) -> this package's names and layouts."""
    trunk = {"params": params["trunk"], "batch_stats": stats}
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


def variables_to_state_dict(variables: Mapping[str, Any], arch: str) -> Dict[str, torch.Tensor]:
    """Flax ``RetrievalNet`` variables -> this package's ``RetrievalNet``
    ``state_dict`` (cirtorch layout: ``features.*``, ``pool.p`` or
    ``pool.centroids`` / ``pool.conv.*``, ``whiten.*``)."""
    return _state_dict(variables["params"],
                       variables.get("batch_stats", {}).get("trunk", {}), arch)


class _Reads(Mapping):
    """A nested dict seen through ``[]`` that records the path of each leaf
    read; a missing key raises a ``KeyError`` naming its whole path."""

    def __init__(self, tree: Mapping[str, Any], seen: set, path: Tuple[str, ...] = ()):
        self._tree, self._seen, self._path = tree, seen, path

    def __getitem__(self, key: str) -> Any:
        path = self._path + (key,)
        if key not in self._tree:
            raise KeyError("/".join(path))
        v = self._tree[key]
        if isinstance(v, Mapping):
            return _Reads(v, self._seen, path)
        self._seen.add(path)
        return v

    def __contains__(self, key) -> bool:
        return key in self._tree

    def __iter__(self) -> Iterator[str]:
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


def _leaf_paths(tree: Mapping[str, Any], path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, ...]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, path + (k,))
        else:
            yield path + (k,)


def params_to_state_dict(tree: Mapping[str, Any], arch: str,
                         names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Any tree shaped like the flax ``RetrievalNet`` params (the params,
    optax's ``mu``/``nu``/``trace``, ``MultiSteps``' ``acc_grads``) -> a
    tensor for each of this package's parameter ``names``, in its layout
    (the rules of :func:`variables_to_state_dict`). Raises naming a leaf
    with no parameter here, or a parameter with no leaf."""
    seen: set = set()
    try:
        sd = _state_dict(_Reads(tree, seen), None, arch)
    except KeyError as e:
        raise ValueError(f"the tree has no leaf {e.args[0]} for the port's {arch}") from None
    unread = sorted("/".join(p) for p in _leaf_paths(tree) if p not in seen)
    if unread:
        raise ValueError(f"leaves with no parameter in the port's {arch}: {unread}")
    missing = sorted(set(names) - set(sd))
    extra = sorted(set(sd) - set(names))
    if missing or extra:
        raise ValueError(f"the port's {arch} parameters with no leaf: {missing}; leaves "
                         f"mapped to no parameter of the model: {extra}")
    return {n: sd[n] for n in names}


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
