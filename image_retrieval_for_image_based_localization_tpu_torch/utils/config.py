"""Typed configuration: frozen dataclasses and the five graded configs.

Copied from the JAX package's ``utils/config.py`` (same fields, defaults and
graded configs), so a config written for one package means the same thing in
the other. Every arch, pooling and ``regional`` of the JAX package is taken.
``s2d_stem`` (the JAX package's space-to-depth form of the resnet stem,
the same function of the same parameter) is taken and runs the standard
stem; ``netvlad_prel2`` is the port's own (its default is the JAX package's
model; True is NetVLAD's ``vd16_..._conv5_3_vlad_preL2`` cut, vgg16 +
NetVLAD only);
``fuse_blocks`` is taken for bottleneck resnets in f32 and bf16,
``dtype="bfloat16"`` runs every trunk in bf16 (graded configs 4 and 5), and
``native_preproc`` selects the native C++ decoder for path inputs as in the
JAX package.
What the training path refuses (bf16 training, ``remat``, a train mesh
with several devices in one process) is checked by
``training.trainer.check_trainable``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Multi-scale pyramid used by the reference lineage: [1, 1/sqrt(2), 1/2]
DEFAULT_SCALES: Tuple[float, ...] = (1.0, 2 ** -0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "resnet50"
    pooling: str = "gem"
    regional: bool = False  # cirtorch Rpool: base pool per R-MAC region
    whiten_dim: Optional[int] = None  # learned FC whitening inside the model
    netvlad_clusters: int = 64
    gem_p: float = 3.0
    dtype: str = "float32"  # 'float32' | 'bfloat16' (compute dtype)
    # the JAX package's fused Pallas head; the port reads it as "use the
    # hand-written CUDA head" (RetrievalNet.use_kernel)
    use_pallas: bool = False
    s2d_stem: Optional[bool] = None  # TPU stem layout: the standard stem here
    # vgg16 + NetVLAD: the trunk ends at conv5_3 before its ReLU and each local
    # descriptor is L2-normalized before the aggregation
    netvlad_prel2: bool = False


@dataclasses.dataclass(frozen=True)
class ExtractConfig:
    model: ModelConfig = ModelConfig()
    image_size: int = 1024          # max-side resize target
    scales: Tuple[float, ...] = (1.0,)
    batch_size: int = 16
    # multi-scale power: None -> GeM p when pooling is gem without whitening,
    # else 1 (reference semantics)
    msp: Optional[float] = None
    bucket_multiple: int = 32       # pad H/W up to multiples of this (stride)
    squarify: bool = False          # True: resize to square
    exact: bool = False             # no spatial padding (bucket_multiple 1)
    # C++ decode/resize of path inputs: None uses it where the library loads,
    # True insists on it, False keeps to PIL
    native_preproc: Optional[bool] = None
    upscale: bool = False
    resize_filter: str = "lanczos"  # 'lanczos' (reference) | 'bilinear'
    # fused bottleneck trunk (bottleneck resnets only); None stays off
    fuse_blocks: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    whitening: Optional[str] = "pca"  # 'pca' | 'lw' | None
    whiten_dims: Optional[int] = None  # truncate to this many dims
    shrinkage: float = 0.0
    strict_whitening: bool = False
    # learn whitening on at most this many (deterministically sampled) rows
    whiten_sample: Optional[int] = 200_000
    storage: str = "float32"  # device gallery dtype: float32 | bfloat16 | int8
    dba_nqe: int = 0  # database-side augmentation (αQE of the gallery), 0 = off
    dba_alpha: float = 3.0


@dataclasses.dataclass(frozen=True)
class GradedConfig:
    name: str
    extract: ExtractConfig
    index: IndexConfig
    dataset: str
    note: str = ""


GRADED_CONFIGS = {
    1: GradedConfig(
        name="r18-gem-oxford5k-subset",
        extract=ExtractConfig(model=ModelConfig(arch="resnet18"), image_size=362, scales=(1.0,)),
        index=IndexConfig(whitening=None),
        dataset="oxford5k-subset",
        note="CPU-runnable, single scale, brute-force kNN",
    ),
    2: GradedConfig(
        name="r50-gem-pca-roxford5k",
        extract=ExtractConfig(model=ModelConfig(arch="resnet50"), image_size=1024, scales=DEFAULT_SCALES),
        index=IndexConfig(whitening="pca"),
        dataset="roxford5k",
        note="multi-scale extraction, PCA whitening",
    ),
    3: GradedConfig(
        name="vgg16-netvlad-rparis6k",
        extract=ExtractConfig(
            model=ModelConfig(arch="vgg16", pooling="netvlad", use_pallas=True),
            image_size=1024,
        ),
        index=IndexConfig(whitening="pca", whiten_dims=4096),
        dataset="rparis6k",
        note="exercises the NetVLAD soft-assignment kernel",
    ),
    4: GradedConfig(
        name="r101-gem-100k-sharded",
        extract=ExtractConfig(model=ModelConfig(arch="resnet101", dtype="bfloat16"), image_size=1024),
        index=IndexConfig(whitening="pca"),
        dataset="roxford5k+100k",
        note="100k distractor gallery sharded across chips, distributed top-k",
    ),
    5: GradedConfig(
        name="aachen-1m-pod",
        extract=ExtractConfig(
            model=ModelConfig(arch="resnet101", dtype="bfloat16", use_pallas=True),
            image_size=1024,
        ),
        index=IndexConfig(whitening="pca"),
        dataset="aachen-day-night",
        note="1M-descriptor gallery, batched query streaming at pod scale",
    ),
}

_SUPPORTED_DTYPES = ("float32", "bfloat16")
_BOTTLENECK_ARCHS = ("resnet50", "resnet101", "resnet152")


def check_supported(cfg: ExtractConfig) -> None:
    """Raise on a config field this package does not implement. The arch,
    the pooling and what they admit (bf16 trunks, regional bases) are
    checked where the model is built (``models.retrieval_net``);
    ``regional`` without ``exact`` is taken: the Extractor switches to
    exact shapes."""
    mc = cfg.model
    if cfg.fuse_blocks and mc.arch not in _BOTTLENECK_ARCHS:
        raise ValueError(f"fuse_blocks (fused bottleneck trunk) needs a bottleneck resnet "
                         f"{_BOTTLENECK_ARCHS}, not {mc.arch!r}")
    if mc.dtype not in _SUPPORTED_DTYPES:
        raise ValueError(f"dtype {mc.dtype!r} is not supported (one of {_SUPPORTED_DTYPES})")
