"""The descriptor model: trunk -> pool -> (whiten FC) -> L2N.

The JAX package's ``models/retrieval_net.py``: ResNet, VGG-16, AlexNet,
SqueezeNet 1.1 and DenseNet trunks with GeM, GeMmp (one exponent per
channel), MAC, SPoC, R-MAC or NetVLAD heads, and cirtorch's regional pool
(``regional=True``: the base pool per R-MAC region, whitened per region,
summed). Submodule names follow cirtorch's ``ImageRetrievalNet``
(``features`` trunk, ``pool.p`` or ``pool.centroids`` / ``pool.conv``,
``whiten``), so a cirtorch ``state_dict`` whose trunk keys are
torchvision-named loads as it is (see ``models.flax_port``).

``use_kernel=True`` swaps the head for the hand-written CUDA kernels
(``ops.kernels.gem_l2n``, ``ops.kernels.netvlad``), the counterpart of the
JAX package's ``use_pallas``. Inputs keep the JAX package's layout: NHWC
pixels ``[B, H, W, 3]`` and an optional validity mask ``[B, H, W]``.

``dtype="bfloat16"`` runs the trunk in bf16 (pixels cast at its input, as
flax casts at the first convolution) with f32 parameters. The head routes
by dtype as the JAX head does: the fused GeM kernel reads the bf16 map as
it is and accumulates in f32; every other head pools ``feats.float()``.

In train mode (``.train()``, f32) the trunk's BatchNorm takes the batch's
statistics as flax does (``models.resnet.bn_train``) and the kernel head
differentiates through the GeM and NetVLAD autograd Functions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from image_retrieval_for_image_based_localization_tpu_torch.models.alexnet import AlexNetTrunk
from image_retrieval_for_image_based_localization_tpu_torch.models.densenet import (
    DENSENET_SPECS,
    DenseNetTrunk,
    densenet_out_channels,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (
    RESNET_SPECS,
    ResNetTrunk,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.squeezenet import (
    SqueezeNetTrunk,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.vgg import VGGTrunk
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    gem_l2n_fused,
    gem_l2n_fused_rect,
    netvlad_fused,
    netvlad_fused_rect,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.netvlad import netvlad_aggregate
from image_retrieval_for_image_based_localization_tpu_torch.ops.normalization import l2n
from image_retrieval_for_image_based_localization_tpu_torch.ops.pooling import (
    gem,
    mac,
    rmac,
    rmac_bucketed,
    rpool,
    spoc,
)

# trunk output channels per arch
OUTPUT_DIM = {**{arch: 512 * spec[2] for arch, spec in RESNET_SPECS.items()}, "vgg16": 512,
              "alexnet": 256, "squeezenet1_1": 512,
              **{arch: densenet_out_channels(arch) for arch in DENSENET_SPECS}}
POOLINGS = ("gem", "gemmp", "mac", "spoc", "rmac", "netvlad")
REGIONAL_BASES = ("gem", "mac", "spoc")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOWP_ARCHS = (*RESNET_SPECS, "vgg16")  # trunks with a bf16 path


def build_trunk(arch: str) -> nn.Module:
    """The feature trunk of ``arch`` (a key of ``OUTPUT_DIM``)."""
    if arch.startswith("resnet"):
        return ResNetTrunk(arch)
    if arch == "vgg16":
        return VGGTrunk()
    if arch == "alexnet":
        return AlexNetTrunk()
    if arch == "squeezenet1_1":
        return SqueezeNetTrunk()
    if arch in DENSENET_SPECS:
        return DenseNetTrunk(arch)
    raise ValueError(f"unknown arch {arch!r} (one of {tuple(OUTPUT_DIM)})")


class GeM(nn.Module):
    """Holds GeM's exponent as cirtorch does: ``p`` of shape [1], or [mp]
    for GeMmp (one exponent per channel, always trainable there)."""

    def __init__(self, p: float = 3.0, trainable: bool = True, mp: int = 1):
        super().__init__()
        t = torch.full((mp,), float(p))
        if trainable:
            self.p = nn.Parameter(t)
        else:
            self.register_buffer("p", t)


class NetVLAD(nn.Module):
    """Holds NetVLAD's parameters as cirtorch does: ``centroids`` [K, C] and
    the assignment 1x1 ``conv`` (weight [K, C, 1, 1], bias [K])."""

    def __init__(self, dim: int, clusters: int = 64):
        super().__init__()
        self.centroids = nn.Parameter(torch.zeros(clusters, dim))
        self.conv = nn.Conv2d(dim, clusters, 1, bias=True)

    def assign_w(self) -> torch.Tensor:
        """The assignment weights as the JAX package holds them, [C, K]."""
        K, C = self.centroids.shape
        return self.conv.weight.reshape(K, C).t()


def feature_mask(mask: torch.Tensor, in_hw, feat_hw) -> torch.Tensor:
    """Pixel mask [B, H, W] -> feature-grid mask [B, h, w], as the JAX model
    downsamples it: stride ``H // h`` (not always 32: a 724-row input gives
    a 23-row map and stride 31), then a crop to the feature grid."""
    sh = in_hw[0] // feat_hw[0]
    sw = in_hw[1] // feat_hw[1]
    return mask[:, ::sh, ::sw][:, : feat_hw[0], : feat_hw[1]]


def rect_sizes(fmask: torch.Tensor) -> torch.Tensor:
    """[B, 2] int32 (rows with any valid cell, columns with any valid cell)."""
    return torch.stack(
        [fmask.any(dim=2).sum(dim=1), fmask.any(dim=1).sum(dim=1)], dim=1
    ).to(torch.int32)


def is_rect(fmask: torch.Tensor, sizes: torch.Tensor) -> bool:
    """Whether every row's mask is the top-left rectangle its extents
    describe (``sum(mask) == h * w``, the bucketing's invariant); one read
    on the host, as the JAX head's ``lax.cond`` decides."""
    return bool(torch.all(fmask.sum(dim=(1, 2)) == sizes[:, 0] * sizes[:, 1]))


class RetrievalNet(nn.Module):
    """Backbone + descriptor head. ``forward`` returns [B, D] f32."""

    def __init__(
        self,
        arch: str = "resnet50",
        pooling: str = "gem",
        whiten_dim: Optional[int] = None,
        gem_p: float = 3.0,
        gem_p_trainable: bool = True,
        use_kernel: bool = False,
        netvlad_clusters: int = 64,
        dtype: str = "float32",
        regional: bool = False,
    ):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"unknown pooling {pooling!r}")
        if dtype not in DTYPES:
            raise ValueError(f"unknown dtype {dtype!r} (one of {tuple(DTYPES)})")
        if dtype != "float32" and arch not in LOWP_ARCHS:
            raise ValueError(f"dtype {dtype!r} runs the resnet and vgg16 trunks only, not "
                             f"{arch!r} (ROADMAP C3, bf16 for the other trunks)")
        if regional and pooling not in REGIONAL_BASES:
            raise ValueError(f"regional pooling wraps gem/mac/spoc, not {pooling!r}")
        self.arch = arch
        self.pooling = pooling
        self.regional = regional
        self.whiten_dim = whiten_dim
        self.gem_p = gem_p
        self.gem_p_trainable = gem_p_trainable
        self.use_kernel = use_kernel
        self.netvlad_clusters = netvlad_clusters
        self.compute_dtype = DTYPES[dtype]
        self.features = build_trunk(arch)
        if pooling == "gem":
            self.pool = GeM(gem_p, gem_p_trainable)
        elif pooling == "gemmp":
            self.pool = GeM(gem_p, True, mp=OUTPUT_DIM[arch])
        elif pooling == "netvlad":
            self.pool = NetVLAD(OUTPUT_DIM[arch], netvlad_clusters)
        if whiten_dim is not None:
            self.whiten = nn.Linear(self.pooled_dim, whiten_dim)

    @property
    def pooled_dim(self) -> int:
        c = OUTPUT_DIM[self.arch]
        return c * self.netvlad_clusters if self.pooling == "netvlad" else c

    @property
    def out_dim(self) -> int:
        return self.whiten_dim if self.whiten_dim is not None else self.pooled_dim

    def trunk_nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC pixels -> NHWC features [B, h, w, C] (contiguous), in the
        compute dtype."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return self.features(x).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_features: bool = False, return_regions: bool = False) -> torch.Tensor:
        """NHWC pixels (+ pixel mask) -> [B, D].

        ``return_features``: the trunk's map [B, h, w, C] in f32, each
        position L2-normalized over the channels and padded positions zeroed
        (cirtorch ``extract_local_vectors``). ``return_regions`` (regional
        models): the region vectors [B, R, D], each pooled, L2-normalized and
        whitened, not summed (cirtorch ``extract_regional_vectors``)."""
        if return_regions and not self.regional:
            raise ValueError("return_regions requires regional=True")
        feats = self.trunk_nhwc(x)
        fmask = None
        if mask is not None:
            fmask = feature_mask(mask, x.shape[1:3], feats.shape[1:3])
        if return_features:
            f = l2n(feats.float())
            return f if fmask is None else f * fmask[..., None].to(f.dtype)
        return self.head(feats, fmask, return_regions=return_regions)

    def head(self, feats: torch.Tensor, fmask: Optional[torch.Tensor] = None,
             return_regions: bool = False) -> torch.Tensor:
        """Pooling, L2N and whitening of an NHWC feature map [B, h, w, C]
        (the trunk's, or the fused trunk's from ``models.fused_trunk``);
        ``fmask`` is at feature resolution."""
        if self.regional:
            return self._regional(feats.float(), fmask, return_regions)
        if self.pooling == "netvlad":
            desc = self._netvlad(feats.float(), fmask)
        elif self.pooling == "gem" and self.use_kernel:
            # the fused head L2-normalizes; a mask from the bucketing is a
            # top-left rectangle, so (h, w) extents describe it exactly
            if fmask is None:
                desc = gem_l2n_fused(feats, self.pool.p)
            else:
                desc = gem_l2n_fused_rect(feats, self.pool.p, rect_sizes(fmask))
        else:
            feats = feats.float()
            if self.pooling in ("gem", "gemmp"):
                pooled = gem(feats, self.pool.p, mask=fmask)
            elif self.pooling == "mac":
                pooled = mac(feats, mask=fmask)
            elif self.pooling == "spoc":
                pooled = spoc(feats, mask=fmask)
            else:
                pooled = self._rmac(feats, fmask)
            desc = l2n(pooled)
        if self.whiten_dim is not None:
            desc = l2n(self.whiten(desc))
        return desc

    def _rmac(self, feats: torch.Tensor, fmask: Optional[torch.Tensor]) -> torch.Tensor:
        """R-MAC; with a mask, each image's own region grid from its valid
        extents when the mask is their rectangle (the bucketing's), else the
        masked R-MAC on the padded grid, as the JAX head routes it."""
        if fmask is None:
            return rmac(feats)
        sizes = rect_sizes(fmask)
        if is_rect(fmask, sizes):
            return rmac_bucketed(feats, sizes)
        return rmac(feats, mask=fmask)

    def _regional(self, feats: torch.Tensor, fmask: Optional[torch.Tensor],
                  return_regions: bool) -> torch.Tensor:
        """cirtorch's Rpool: the base pool per region, L2N, the shared
        whitening FC per region, then the sum and its L2N (the region grid is
        a function of the exact map's shape)."""
        if fmask is not None:
            raise ValueError("regional pooling requires exact shapes (no padding mask): "
                             "use ExtractConfig(exact=True)")
        p = self.pool.p if self.pooling == "gem" else self.gem_p
        whiten = self.whiten if self.whiten_dim is not None else None
        pooled = rpool(feats, base=self.pooling, p=p, whiten_fn=whiten,
                       aggregate=not return_regions)
        return pooled if return_regions else l2n(pooled)

    def _netvlad(self, feats: torch.Tensor, fmask: Optional[torch.Tensor]) -> torch.Tensor:
        """The JAX head's routing: the fused kernel without a mask; with one,
        the rect kernel when every row's mask is the rectangle its extents
        describe (``sum(mask) == h * w``, the bucketing invariant), else the
        plain aggregation, which takes any mask."""
        c, w, b = self.pool.centroids, self.pool.assign_w(), self.pool.conv.bias
        if not self.use_kernel:
            return netvlad_aggregate(feats, c, w, b, mask=fmask)
        if fmask is None:
            return netvlad_fused(feats, c, w, b)
        sizes = rect_sizes(fmask)
        if is_rect(fmask, sizes):
            return netvlad_fused_rect(feats, c, w, b, sizes=sizes)
        return netvlad_aggregate(feats, c, w, b, mask=fmask)
