"""Image loading, resizing and static-shape aspect-ratio batching.

Copied from the JAX package's ``data/images.py`` (NumPy + PIL, no JAX), so
both packages cut the same images into the same buckets: each image is
max-side-resized, then padded to its bucket's (H, W) (multiples of the trunk
stride); a batch carries raw uint8 pixels and per-row valid (h, w) extents,
and normalization and masking happen on the device. PIL is imported only
inside the functions that use it: an array whose max side already equals
``image_size`` never reaches PIL. A uint8 array of raw [0, 255] pixels stays
uint8 from input to batch (PIL resizes it as uint8): the JAX package takes it
to float32 in [0, 1] and rounds it back, a round trip that is the identity,
so the batches are the JAX package's bit for bit, without the float copies.
Path inputs may instead go through the native C++ decoder
(:func:`make_batches_native`, ``data/native.py``), the JAX package's default
for them.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_image(path: str, bbx: Optional[Tuple[float, float, float, float]] = None) -> np.ndarray:
    """Decode an image file to float32 RGB HWC in [0, 1]; optional bbx crop.

    Query bounding boxes follow the reference convention: crop before resize.
    """
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if bbx is not None:
        img = img.crop(tuple(int(round(v)) for v in bbx))
    return np.asarray(img, dtype=np.float32) / 255.0


def _pil_filter(name: str):
    from PIL import Image

    try:
        return {"bilinear": Image.BILINEAR, "lanczos": Image.LANCZOS}[name]
    except KeyError:
        raise ValueError(f"unknown resize filter {name!r} (bilinear|lanczos)")


def max_side_resize(
    img: np.ndarray,
    image_size: int,
    upscale: bool = True,
    resize_filter: str = "bilinear",
) -> np.ndarray:
    """Resize so max(H, W) == image_size, preserving aspect.

    Reference parity: the reference's ``imresize`` thumbnails — shrink-only
    LANCZOS (``upscale=False, resize_filter='lanczos'``; ``ExtractConfig``
    defaults to exactly that). The function-level defaults keep the
    round-1 behavior (bilinear, both ways) for direct callers. Float input
    in [0, 1] gives float32 in [0, 1]; uint8 input is taken as raw
    [0, 255] pixels and gives PIL's uint8 output. No resize returns ``img``
    itself.
    """
    from PIL import Image

    h, w = img.shape[:2]
    m = max(h, w)
    if m == image_size or (not upscale and m < image_size):
        return img
    scale = image_size / m
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    if img.dtype == np.uint8:
        return np.asarray(Image.fromarray(img).resize((nw, nh), _pil_filter(resize_filter)))
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    pil = pil.resize((nw, nh), _pil_filter(resize_filter))
    return np.asarray(pil, dtype=np.float32) / 255.0


def normalize_images(x: np.ndarray) -> np.ndarray:
    """ImageNet mean/std normalize; NHWC float32 in [0,1]."""
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def bucket_shape(h: int, w: int, multiple: int = 32) -> Tuple[int, int]:
    """Round (h, w) up to the bucket grid (multiples of the trunk stride)."""
    r = lambda v: ((v + multiple - 1) // multiple) * multiple  # noqa: E731
    return r(h), r(w)


@dataclasses.dataclass
class ImageBatch:
    """A static-shape batch: raw uint8 pixels + valid extents + indices.

    Pixels travel host->device as uint8 with per-row (h, w) extents —
    4x less transfer than normalized float32 and ~1.3x less again vs a bool
    mask plane (validity is always a top-left rectangle). Normalization,
    mask construction, and zeroing of padding happen on device inside the
    extractor's jitted program. ``pixels``/``mask`` properties materialize
    the old host-side float32 views for tests and host-side consumers.
    """

    pixels_u8: np.ndarray  # [B, H, W, 3] uint8, raw resized, zero-padded
    sizes: np.ndarray      # [B, 2] int32 valid (h, w); (0, 0) = batch-pad row
    indices: np.ndarray    # [B] int — positions in the original image list
    valid: int             # number of real (non batch-padding) rows

    @property
    def mask(self) -> np.ndarray:
        B, H, W, _ = self.pixels_u8.shape
        m = np.zeros((B, H, W), bool)
        for r, (h, w) in enumerate(np.asarray(self.sizes)):
            m[r, :h, :w] = True
        return m

    @property
    def pixels(self) -> np.ndarray:
        """Normalized float32 view with zeroed padding (legacy semantics)."""
        x = self.pixels_u8.astype(np.float32) / 255.0
        x = (x - IMAGENET_MEAN) / IMAGENET_STD
        return x * self.mask[..., None]


ImageSource = Union[str, np.ndarray]


def probe_size(path: str) -> Tuple[int, int]:
    """(h, w) from the image header without decoding pixels."""
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
    return h, w


def make_batches_native(
    paths: Sequence[str],
    image_size: int,
    batch_size: int,
    bucket_multiple: int = 32,
    bbxs: Optional[Sequence] = None,
    upscale: bool = True,
    resize_filter: str = "bilinear",
) -> Iterable[ImageBatch]:
    """Path-input batching with the native C++ decode and resize
    (``data.native``), as the JAX package's ``make_batches_native``.

    Buckets come from header-only size probes; the pixel work of each batch
    is one multi-threaded native call. The buckets, their order, the sizes
    and the indices are ``make_batches``'s; the pixels are the native
    resize's.
    """
    from image_retrieval_for_image_based_localization_tpu_torch.data.native import (
        preprocess_batch_native,
    )

    def target_hw(i: int) -> Tuple[int, int]:
        h, w = probe_size(paths[i])
        if bbxs is not None and bbxs[i] is not None:
            x0, y0, x1, y1 = bbxs[i]
            h = max(1, int(round(y1)) - int(round(y0)))
            w = max(1, int(round(x1)) - int(round(x0)))
        m = max(h, w)
        if m != image_size and (upscale or m > image_size):
            s = image_size / m
            h, w = max(1, round(h * s)), max(1, round(w * s))
        return h, w

    buckets: dict[Tuple[int, int], List[int]] = {}
    for i in range(len(paths)):
        h, w = target_hw(i)
        buckets.setdefault(bucket_shape(h, w, bucket_multiple), []).append(i)

    for (H, W), members in sorted(buckets.items()):
        for s in range(0, len(members), batch_size):
            chunk = members[s : s + batch_size]
            chunk_paths = [paths[i] for i in chunk]
            chunk_bbxs = None if bbxs is None else [bbxs[i] for i in chunk]
            pixels_v, sizes_v = preprocess_batch_native(
                chunk_paths, image_size, H, W, bbxs=chunk_bbxs,
                upscale=upscale, resize_filter=resize_filter,
            )
            pixels_u8 = np.zeros((batch_size, H, W, 3), np.uint8)
            pixels_u8[: len(chunk)] = pixels_v
            sizes = np.zeros((batch_size, 2), np.int32)
            sizes[: len(chunk)] = sizes_v
            for row in range(len(chunk)):
                h, w = sizes[row]
                if h == 0 or w == 0:
                    raise IOError(f"failed to decode {chunk_paths[row]}")
            yield ImageBatch(
                pixels_u8=pixels_u8,
                sizes=sizes,
                indices=np.asarray(chunk, dtype=np.int64),
                valid=len(chunk),
            )


def _raw_u8(img) -> bool:
    """A uint8 array read as raw [0, 255] pixels: non-empty, max above 1.
    (The JAX package reads a uint8 array with max <= 1 as [0, 1] floats.)"""
    return (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.size > 0
            and img.max() > 1)


def _prepare_one(
    img: ImageSource,
    image_size: int,
    bbx=None,
    upscale: bool = True,
    resize_filter: str = "bilinear",
) -> np.ndarray:
    """One image cropped to ``bbx`` and max-side-resized, as the JAX
    package's ``_prepare_one``. A raw uint8 array (:func:`_raw_u8`) stays
    uint8: the crop is a view and, where no resize is needed, the array
    itself is returned, with the pixels the JAX package's float32 round
    trip gives back. Paths, float arrays and every other array give float32
    in [0, 1], as there."""
    if isinstance(img, str):
        img = load_image(img, bbx=bbx)
    elif _raw_u8(img):
        if bbx is not None:
            x0, y0, x1, y1 = (int(round(v)) for v in bbx)
            img = img[y0:y1, x0:x1]
    else:
        img = np.asarray(img, dtype=np.float32)
        if img.size and img.min() < -0.05:
            # ImageNet-normalized input would silently round-trip through
            # uint8 as near-black garbage (negatives clip to 0) — the
            # extractor normalizes on device and expects RAW pixels.
            raise ValueError(
                "array image has negative values — pass raw pixels in [0, 1] "
                "or uint8 [0, 255], not mean/std-normalized arrays (the "
                "extractor normalizes on device)"
            )
        if img.max() > 1.5:  # uint8-range input
            img = img / 255.0
        if bbx is not None:
            x0, y0, x1, y1 = (int(round(v)) for v in bbx)
            img = img[y0:y1, x0:x1]
    return max_side_resize(img, image_size, upscale=upscale, resize_filter=resize_filter)


def make_batches(
    images: Sequence[ImageSource],
    image_size: int,
    batch_size: int,
    bucket_multiple: int = 32,
    bbxs: Optional[Sequence] = None,
    squarify: bool = False,
    upscale: bool = True,
    resize_filter: str = "bilinear",
) -> Iterable[ImageBatch]:
    """Group images into per-bucket static-shape batches.

    Two-pass: resize all (host), group by padded bucket shape, emit batches
    padded to ``batch_size`` rows so at most one compilation per bucket shape.
    ``bucket_multiple=1`` gives exact shapes (no spatial padding).

    Raw uint8 arrays stay uint8 through ``_prepare_one`` and are copied into
    ``pixels_u8`` as they are; only float images are rounded to uint8. The
    batches are the JAX package's ``make_batches``'s bit for bit, for every
    input. ``make_batches.u8_images`` and ``make_batches.float_images`` count
    the images that reached a batch each way (:func:`batch_counts`).
    """
    resized: List[np.ndarray] = []
    for i, img in enumerate(images):
        bbx = bbxs[i] if bbxs is not None else None
        resized.append(
            _prepare_one(
                img, image_size, bbx=bbx, upscale=upscale,
                resize_filter=resize_filter,
            )
        )

    buckets: dict[Tuple[int, int], List[int]] = {}
    for i, img in enumerate(resized):
        if squarify:
            shape = (image_size, image_size)
        else:
            shape = bucket_shape(img.shape[0], img.shape[1], bucket_multiple)
        buckets.setdefault(shape, []).append(i)

    for (H, W), members in sorted(buckets.items()):
        for s in range(0, len(members), batch_size):
            chunk = members[s : s + batch_size]
            B = batch_size
            pixels_u8 = np.zeros((B, H, W, 3), dtype=np.uint8)
            sizes = np.zeros((B, 2), dtype=np.int32)
            for row, gi in enumerate(chunk):
                img = resized[gi]
                h, w = img.shape[:2]
                u8 = img.dtype == np.uint8
                if squarify and (h != H or w != W):
                    from PIL import Image

                    if u8:
                        pil = Image.fromarray(img).resize((W, H), _pil_filter(resize_filter))
                        img = np.asarray(pil)
                    else:
                        pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
                        img = (
                            np.asarray(
                                pil.resize((W, H), _pil_filter(resize_filter)), np.float32
                            )
                            / 255.0
                        )
                    h, w = H, W
                if u8:
                    pixels_u8[row, :h, :w] = img
                    make_batches.u8_images += 1
                else:
                    pixels_u8[row, :h, :w] = np.clip(
                        np.round(img * 255.0), 0, 255
                    ).astype(np.uint8)
                    make_batches.float_images += 1
                sizes[row] = (h, w)
            yield ImageBatch(
                pixels_u8=pixels_u8,
                sizes=sizes,
                indices=np.asarray(chunk, dtype=np.int64),
                valid=len(chunk),
            )


make_batches.u8_images = 0     # images copied into a batch as uint8
make_batches.float_images = 0  # images rounded into a batch from float32


def reset_batch_counts() -> None:
    make_batches.u8_images = 0
    make_batches.float_images = 0


def batch_counts() -> dict:
    """Images ``make_batches`` put into batches since the last reset, by
    path: ``u8_images`` copied as raw uint8, ``float_images`` rounded from
    float32 (paths, float arrays, uint8 arrays with max <= 1)."""
    return {"u8_images": make_batches.u8_images, "float_images": make_batches.float_images}
