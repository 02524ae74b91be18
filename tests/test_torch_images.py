"""The port's host batching (``data/images.py::make_batches``) against the
JAX package's, bit for bit: raw uint8 arrays stay uint8 in the port (no
float32 round trip), and every input kind gives the JAX package's buckets,
order, ``pixels_u8``, ``sizes``, ``indices`` and ``valid``. Also the
counters of the images that reached a batch each way."""

import numpy as np
import pytest

from irtpu.data.images import make_batches as j_make_batches

from image_retrieval_for_image_based_localization_tpu_torch.data.images import (
    _prepare_one,
    batch_counts,
    make_batches,
    reset_batch_counts,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

SIZE = 64


def _u8(rng, h, w, hi=256):
    return rng.randint(0, hi, (h, w, 3)).astype(np.uint8)


def _f32(rng, h, w):
    return rng.rand(h, w, 3).astype(np.float32)


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    from PIL import Image

    path = tmp_path_factory.mktemp("images") / "a.png"
    Image.fromarray(_u8(np.random.RandomState(7), 50, 90)).save(path)
    return str(path)


def _case(name, png):
    """(images, make_batches keyword arguments) of one parity case."""
    rng = np.random.RandomState(sum(map(ord, name)))
    kw = dict(image_size=SIZE, batch_size=3, upscale=False, resize_filter="lanczos")
    if name == "u8_at_size":
        return [_u8(rng, *hw) for hw in [(48, 64), (64, 40), (64, 64), (48, 64), (33, 64)]], kw
    if name == "u8_shrunk":
        return [_u8(rng, *hw) for hw in [(96, 80), (120, 70), (70, 128), (65, 64)]], kw
    if name == "u8_upscaled":
        kw.update(upscale=True, resize_filter="bilinear")
        return [_u8(rng, *hw) for hw in [(40, 30), (20, 50), (64, 17), (90, 60)]], kw
    if name == "u8_bbx":
        imgs = [_u8(rng, *hw) for hw in [(100, 90), (64, 48), (80, 120)]]
        kw["bbxs"] = [(10.4, 5.0, 80.0, 90.6), None, (0, 0, 40, 64)]
        return imgs, kw
    if name == "u8_max_le_1":
        return [_u8(rng, 48, 64, hi=2), _u8(rng, 90, 70, hi=2), _u8(rng, 64, 40)], kw
    if name == "f32":
        return [_f32(rng, *hw) for hw in [(48, 64), (96, 80), (30, 20)]], kw
    if name == "mixed":
        return [_u8(rng, 48, 64), _f32(rng, 70, 90), png, _u8(rng, 100, 60),
                _u8(rng, 64, 64, hi=2), _f32(rng, 64, 48)], kw
    if name == "squarify":
        kw.update(squarify=True, upscale=True, resize_filter="bilinear")
        return [_u8(rng, 48, 64), _u8(rng, 90, 70), _f32(rng, 64, 40), _u8(rng, 64, 64)], kw
    if name == "bucket_multiple_1":
        kw["bucket_multiple"] = 1
        return [_u8(rng, *hw) for hw in [(48, 64), (47, 64), (96, 80), (48, 64)]], kw
    raise KeyError(name)


CASES = ["u8_at_size", "u8_shrunk", "u8_upscaled", "u8_bbx", "u8_max_le_1", "f32", "mixed",
         "squarify", "bucket_multiple_1"]


@pytest.mark.parametrize("name", CASES)
def test_make_batches_bit_identical_to_jax(png, name):
    images, kw = _case(name, png)
    got = list(make_batches(images, **kw))
    want = list(j_make_batches(images, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.pixels_u8.dtype == w.pixels_u8.dtype == np.uint8
        assert g.pixels_u8.shape == w.pixels_u8.shape
        np.testing.assert_array_equal(g.pixels_u8, w.pixels_u8)
        np.testing.assert_array_equal(g.sizes, w.sizes)
        np.testing.assert_array_equal(g.indices, w.indices)
        assert g.valid == w.valid


def test_u8_float_round_trip_is_the_identity():
    """The JAX package's round trip of a raw uint8 pixel, both ways it takes
    (a resized image and one at size), gives every value back."""
    v = np.arange(256, dtype=np.uint8)
    f = v.astype(np.float32) / 255.0
    np.testing.assert_array_equal((np.clip(f, 0, 1) * 255).astype(np.uint8), v)
    np.testing.assert_array_equal(np.clip(np.round(f * 255.0), 0, 255).astype(np.uint8), v)


def test_at_size_u8_counted_u8_and_not_copied():
    rng = np.random.RandomState(0)
    images = [_u8(rng, 48, 64), _u8(rng, 64, 40), _u8(rng, 64, 64), _u8(rng, 64, 33)]
    reset_batch_counts()
    n_rows = sum(b.valid for b in make_batches(images, image_size=SIZE, batch_size=3))
    assert n_rows == len(images)
    assert batch_counts() == {"u8_images": len(images), "float_images": 0}
    # The array itself reaches the batch: no float32 (or any) copy on the way.
    for img in images:
        assert _prepare_one(img, SIZE, upscale=False) is img


def test_float_and_max_le_1_counted_float(png):
    rng = np.random.RandomState(1)
    images = [_f32(rng, 48, 64), _u8(rng, 64, 40, hi=2), png, _u8(rng, 96, 80)]
    reset_batch_counts()
    list(make_batches(images, image_size=SIZE, batch_size=2))
    assert batch_counts() == {"u8_images": 1, "float_images": 3}
    out = _prepare_one(images[1], SIZE)
    assert out.dtype == np.float32 and out.max() <= 1.0
    reset_batch_counts()
    assert batch_counts() == {"u8_images": 0, "float_images": 0}


def test_negative_float_still_raises():
    img = np.full((48, 64, 3), -0.5, np.float32)
    with pytest.raises(ValueError, match="negative values"):
        list(make_batches([img], image_size=SIZE, batch_size=1))
