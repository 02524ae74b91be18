"""Public API: extract_features / extract_vectors / build_index / query.

The JAX package's ``api.py`` on PyTorch: batched multi-scale extraction over
uint8 aspect buckets (normalize and mask on the device), the reference's
generalized mean over scales ``l2n((mean_s d_s^msp)^(1/msp))``, then
whitening, index build and exact search; beside it the structured
extraction of region vectors and local features, and extraction that
resumes from shards on disk. Entry points run on the card unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from image_retrieval_for_image_based_localization_tpu_torch.data.images import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    make_batches,
    make_batches_native,
)
from image_retrieval_for_image_based_localization_tpu_torch.data.native import native_available
from image_retrieval_for_image_based_localization_tpu_torch.models.fused_trunk import (
    fold_trunk,
    trunk_apply_fused,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.init import init_random_
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    RetrievalNet,
    feature_mask,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
    ExtractConfig,
    IndexConfig,
    check_supported,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)


def _prefetched(iterator, depth: int = 2):
    """Run an iterator in a background thread, ``depth`` items ahead."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    sentinel = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(sentinel)
        except BaseException as e:  # surface decode errors in the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def rescale(pixels: torch.Tensor, scale: float) -> torch.Tensor:
    """NHWC pixels at ``scale``, the reference's way: ``floor(size * s)``
    (at least 32), bilinear at half-pixel centres, no antialiasing (the JAX
    package's ``jax.image.resize(..., "bilinear", antialias=False)``)."""
    _, H, W, _ = pixels.shape
    size = (max(int(H * scale), 32), max(int(W * scale), 32))
    return F.interpolate(pixels.permute(0, 3, 1, 2), size=size, mode="bilinear",
                         align_corners=False, antialias=False).permute(0, 2, 3, 1)


def resize_mask_nearest(mask: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of a [B, H, W] bool mask, index for index the JAX
    package's ``jax.image.resize(mask, ..., "nearest") >= 0.5``: output row
    i reads input row ``floor((i + 0.5) * H / h)`` computed in float32."""
    B, H, W = mask.shape

    def src(n_in: int, n_out: int) -> torch.Tensor:
        pos = (torch.arange(n_out, dtype=torch.float32, device=mask.device) + 0.5) * n_in / n_out
        return torch.floor(pos).to(torch.int64)

    return mask[:, src(H, size[0])][:, :, src(W, size[1])]


class Extractor:
    """Descriptor extraction engine.

    Args:
      cfg: ExtractConfig (any arch of ``models.retrieval_net.OUTPUT_DIM``
        with GeM/GeMmp/MAC/SPoC/R-MAC/NetVLAD or the regional pool, float32,
        or bfloat16 for the resnet and vgg16 trunks; ``use_pallas`` selects
        the hand-written CUDA head). ``regional=True`` switches to exact
        shapes (``exact=True``), as in the JAX package: the region grid is a
        function of each image's own shape.
      state_dict: weights for ``RetrievalNet`` (this package's layout; see
        ``models.flax_port`` for flax variables). None: random weights from
        ``torch.Generator().manual_seed(seed)``, with random BN statistics.
      device: "cuda" (default) or "cpu".

    ``cfg.fuse_blocks=True`` (bottleneck resnets) folds the trunk's BN once
    here and runs it through ``models.fused_trunk``, the fused bottleneck
    kernel included; the head then runs on the precomputed features.

    With ``dtype="bfloat16"`` the model computes in bf16 (parameters stay
    f32): uint8 input is normalized straight into bf16, a multi-scale
    resize runs on those bf16 pixels, and f32 pixels given to ``__call__``
    are cast at the trunk's input, as in the JAX package.
    """

    def __init__(self, cfg: ExtractConfig, state_dict: Optional[Dict] = None,
                 seed: int = 0, device: DeviceLike = "cuda"):
        check_supported(cfg)
        mc = cfg.model
        if mc.regional and not cfg.exact:
            cfg = dataclasses.replace(cfg, exact=True)
        self.cfg = cfg
        self.device = resolve_device(device)
        model = RetrievalNet(arch=mc.arch, pooling=mc.pooling, whiten_dim=mc.whiten_dim,
                             regional=mc.regional, gem_p=mc.gem_p, use_kernel=mc.use_pallas,
                             netvlad_clusters=mc.netvlad_clusters, dtype=mc.dtype)
        if state_dict is None:
            init_random_(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        # None stays off, as in the JAX package
        self._folded = fold_trunk(self.model.features) if cfg.fuse_blocks else None
        self.scales = tuple(sorted(cfg.scales, reverse=True))
        # u8 -> compute dtype as one scale-and-shift in that dtype, the
        # constants computed in float64 and rounded once to it
        dt = self.model.compute_dtype
        std = np.asarray(IMAGENET_STD, np.float64)
        mean = np.asarray(IMAGENET_MEAN, np.float64)
        self._nrm_a = torch.tensor(1.0 / (255.0 * std), dtype=torch.float64).to(dt).to(self.device)
        self._nrm_b = torch.tensor(-mean / std, dtype=torch.float64).to(dt).to(self.device)

    @property
    def out_dim(self) -> int:
        return self.model.out_dim

    def _msp(self) -> torch.Tensor:
        """Multi-scale power: cfg.msp, else GeM's p for whitening-free GeM
        that is not regional, else 1 (GeMmp, R-MAC and NetVLAD included; a
        regional descriptor is a sum of unit region vectors, so cirtorch
        averages its scales plainly)."""
        if self.cfg.msp is not None:
            return torch.tensor(self.cfg.msp, dtype=torch.float32, device=self.device)
        model = self.model
        if model.pooling == "gem" and model.whiten_dim is None and not model.regional:
            return model.pool.p.reshape(()).float()
        return torch.tensor(1.0, dtype=torch.float32, device=self.device)

    def _single_scale(self, pixels: torch.Tensor, mask: Optional[torch.Tensor],
                      scale: float) -> torch.Tensor:
        if self.model.regional:
            mask = None  # exact shapes: the mask is full, and the regional head takes none
        if scale != 1.0:
            pixels = rescale(pixels, scale)
            if mask is not None:
                mask = resize_mask_nearest(mask, tuple(pixels.shape[1:3]))
        if self._folded is None:
            return self.model(pixels, mask)
        feats = trunk_apply_fused(self._folded, pixels)
        fmask = None if mask is None else feature_mask(mask, pixels.shape[1:3], feats.shape[1:3])
        return self.model.head(feats, fmask)

    @torch.no_grad()
    def forward(self, pixels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, H, W, 3] normalized pixels (+ optional [B, H, W] mask) -> [B, D]."""
        if len(self.scales) == 1:
            return self._single_scale(pixels, mask, self.scales[0])
        msp = self._msp()
        acc = None
        for s in self.scales:
            d = self._single_scale(pixels, mask, s)
            d = torch.where(msp == 1.0, d, torch.pow(torch.clamp(d, min=0.0), msp))
            acc = d if acc is None else acc + d
        acc = acc / len(self.scales)
        acc = torch.where(msp == 1.0, acc, torch.pow(torch.clamp(acc, min=0.0), 1.0 / msp))
        norm = torch.sqrt(torch.sum(acc * acc, dim=-1, keepdim=True))
        return acc / (norm + 1e-6)

    @torch.no_grad()
    def forward_u8(self, pixels_u8: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
        """Raw uint8 [B, H, W, 3] + valid (h, w) [B, 2] -> descriptors [B, D]."""
        B, H, W, _ = pixels_u8.shape
        row = torch.arange(H, device=self.device)[None, :, None]
        col = torch.arange(W, device=self.device)[None, None, :]
        mask = (row < sizes[:, 0, None, None]) & (col < sizes[:, 1, None, None])
        x = pixels_u8.to(self._nrm_a.dtype) * self._nrm_a + self._nrm_b
        x = x * mask[..., None]  # zero padding in normalized space
        return self.forward(x, mask)

    def __call__(self, pixels: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Descriptors of an already-batched NHWC float array. Without a
        mask every pixel is valid, so the head takes its unmasked form."""
        x = torch.as_tensor(np.asarray(pixels, np.float32)).to(self.device)
        m = None if mask is None else torch.as_tensor(np.asarray(mask, bool)).to(self.device)
        return self.forward(x, m).cpu().numpy()

    def make_input_batches(self, images: Sequence, bbxs=None,
                           batch_size: Optional[int] = None):
        """The host pipeline for ``images`` (paths or HWC arrays), by the JAX
        package's rule: all-path inputs go through the native C++ decode and
        resize unless ``native_preproc`` is False, ``squarify`` is on, or the
        library is unavailable (``native_preproc=True`` insists on it); the
        rest go through PIL. One place decides, so both packages give the
        same pixels for the same input. ``batch_size`` overrides the
        config's: serving's one-hop query takes 1, where the config's would
        pad one image to ``cfg.batch_size`` rows of trunk work."""
        cfg = self.cfg
        batch_size = batch_size or cfg.batch_size
        bucket_multiple = 1 if cfg.exact else cfg.bucket_multiple
        use_native = (cfg.native_preproc is not False and not cfg.squarify and len(images) > 0
                      and all(isinstance(im, str) for im in images))
        if use_native and (cfg.native_preproc is True or native_available()):
            return make_batches_native(
                images,
                image_size=cfg.image_size,
                batch_size=batch_size,
                bucket_multiple=bucket_multiple,
                bbxs=bbxs,
                upscale=cfg.upscale,
                resize_filter=cfg.resize_filter,
            )
        return make_batches(
            images,
            image_size=cfg.image_size,
            batch_size=batch_size,
            bucket_multiple=bucket_multiple,
            bbxs=bbxs,
            squarify=cfg.squarify,
            upscale=cfg.upscale,
            resize_filter=cfg.resize_filter,
        )

    def extract(self, images: Sequence, bbxs: Optional[Sequence] = None,
                prefetch: int = 2) -> np.ndarray:
        """Descriptors [N, D] for image paths or HWC arrays. Host resizing
        runs in a background thread ``prefetch`` batches ahead."""
        out = np.zeros((len(images), self.out_dim), dtype=np.float32)
        pending = []  # (device descriptors, host indices), drained lazily
        for batch in _prefetched(self.make_input_batches(images, bbxs=bbxs), prefetch):
            px = torch.from_numpy(batch.pixels_u8).to(self.device, non_blocking=True)
            sz = torch.from_numpy(batch.sizes).to(self.device, non_blocking=True)
            pending.append((self.forward_u8(px, sz), batch.indices))
            while len(pending) > prefetch:
                d, ix = pending.pop(0)
                out[ix] = d[: len(ix)].cpu().numpy()
        for d, ix in pending:
            out[ix] = d[: len(ix)].cpu().numpy()
        return out

    @torch.no_grad()
    def _extract_structured(self, images: Sequence, bbxs, kind: str) -> list:
        """Per-image outputs of the model's structured forms, as a list:
        ``kind`` "regions" gives [R, D] region vectors, "features" [P, C]
        local features (positions flattened row-major). Exact shapes (PIL
        host pipeline, ``bucket_multiple=1``), f32 pixels normalized as the
        JAX package's structured path does; every scale runs and the
        per-scale outputs are concatenated along the first axis."""
        cfg = self.cfg
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=self.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=self.device)
        kw = {"return_regions": True} if kind == "regions" else {"return_features": True}
        out: list = [None] * len(images)
        for batch in make_batches(images, image_size=cfg.image_size, batch_size=cfg.batch_size,
                                  bucket_multiple=1, bbxs=bbxs, squarify=cfg.squarify,
                                  upscale=cfg.upscale, resize_filter=cfg.resize_filter):
            x = torch.from_numpy(batch.pixels_u8).to(self.device).float() / 255.0
            x = (x - mean) / std
            outs = []
            for s in self.scales:
                r = self.model(x if s == 1.0 else rescale(x, s), **kw)
                outs.append(r.reshape(r.shape[0], -1, r.shape[-1]))
            res = torch.cat(outs, dim=1).cpu().numpy()
            for row, ix in enumerate(batch.indices):
                out[ix] = res[row]
        return out

    def extract_regional(self, images: Sequence, bbxs=None) -> list:
        """Per-image region vectors (cirtorch ``extract_regional_vectors``):
        a list of [R_i, D] arrays, each region pooled, L2-normalized and
        whitened (where the model whitens), not summed. Needs a regional
        model. R_i follows each image's exact shape (the R-MAC grid) and, for
        several scales, adds up over them."""
        if not self.model.regional:
            raise ValueError("extract_regional requires ModelConfig(regional=True)")
        return self._extract_structured(images, bbxs, "regions")

    def extract_local(self, images: Sequence, bbxs=None) -> list:
        """Per-image local features (cirtorch ``extract_local_vectors``): a
        list of [P_i, C] arrays, every trunk position L2-normalized over the
        channels; several scales concatenate their positions."""
        return self._extract_structured(images, bbxs, "features")

    def extract_resumable(self, images: Sequence, cache_dir: str,
                          bbxs: Optional[Sequence] = None, shard_size: int = 1024) -> np.ndarray:
        """``extract`` in shards of ``shard_size`` images, each kept on disk as
        ``cache_dir/descs_{start:08d}.npy``: a run that was stopped resumes
        from the shards already written. A shard is written to a ``.tmp``
        file and renamed into place, so no shard is ever torn."""
        os.makedirs(cache_dir, exist_ok=True)
        n = len(images)
        parts = []
        for s in range(0, n, shard_size):
            shard_path = os.path.join(cache_dir, f"descs_{s:08d}.npy")
            if os.path.exists(shard_path):
                parts.append(np.load(shard_path))
                continue
            sel = slice(s, min(s + shard_size, n))
            d = self.extract(images[sel], bbxs=None if bbxs is None else bbxs[sel])
            tmp = shard_path + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, d)
            os.replace(tmp, shard_path)
            parts.append(d)
        return np.concatenate(parts, axis=0)


def extract_features(images: Sequence, cfg: ExtractConfig = ExtractConfig(),
                     state_dict: Optional[Dict] = None, bbxs: Optional[Sequence] = None,
                     device: DeviceLike = "cuda") -> np.ndarray:
    """Extract [N, D] descriptors for images (paths or HWC arrays)."""
    return Extractor(cfg, state_dict=state_dict, device=device).extract(images, bbxs=bbxs)


def extract_vectors(net_or_state_dict, images: Sequence, image_size: int = 1024,
                    ms: Sequence[float] = (1.0,), bbxs: Optional[Sequence] = None,
                    cfg: Optional[ExtractConfig] = None,
                    device: DeviceLike = "cuda") -> np.ndarray:
    """Reference-style alias: an Extractor, or a state_dict + cfg. Returns [N, D]."""
    if isinstance(net_or_state_dict, Extractor):
        ex = net_or_state_dict
    else:
        base = dataclasses.replace(cfg or ExtractConfig(), image_size=image_size,
                                   scales=tuple(ms))
        ex = Extractor(base, state_dict=net_or_state_dict, device=device)
    return ex.extract(images, bbxs=bbxs)


def build_index(descriptors: np.ndarray, cfg: IndexConfig = IndexConfig(),
                ids: Optional[Sequence] = None,
                pairs: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                whitening_mP: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                device: DeviceLike = "cuda") -> Index:
    """Build an exact-search index (whitening learned on the gallery or
    applied from ``whitening_mP``)."""
    return Index.build(descriptors, cfg=cfg, ids=ids, pairs=pairs,
                       whitening_mP=whitening_mP, device=device)


def query(index: Index, qdescriptors: np.ndarray, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k search against an index. Returns (scores, indices)."""
    return index.query(qdescriptors, k=k)
