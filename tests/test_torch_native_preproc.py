"""The port's native (C++) path-input pipeline against the JAX package's.

Both packages build ``native/preproc.cpp``; by default their extractors
decode path inputs with it. Same files in, the same batches out: buckets,
order, indices, sizes and pixels bit for bit, and descriptors of one set of
weights within 2e-5. Skips where either package's library is unavailable
(no C++ compiler, or no libjpeg/libpng headers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irtpu.api import Extractor as JExtractor
from irtpu.data.images import make_batches_native as j_make_batches_native
from irtpu.data.native import native_available as j_native_available
from irtpu.models.torch_port import port_retrieval_net
from irtpu.utils import config as jcfg

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.data.images import (
    make_batches,
    make_batches_native,
)
from image_retrieval_for_image_based_localization_tpu_torch.data.native import (
    native_available,
)
from image_retrieval_for_image_based_localization_tpu_torch.models import (
    RetrievalNet,
    init_random_,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
    check_supported,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

# (h, w) of each file: larger and smaller than the 64 px target, three aspects
SHAPES = [(120, 160), (160, 120), (90, 90), (200, 150), (40, 56), (75, 100)]
BBXS = [(10, 10, 80, 70), None, (0.4, 3.6, 60.2, 81.7), None, (2, 2, 30, 20), None]


@pytest.fixture(scope="module")
def libs():
    if not (native_available() and j_native_available()):
        pytest.skip("native preproc library unavailable (compiler or libjpeg/libpng headers)")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("native_imgs")
    rng = np.random.RandomState(0)
    out = {}
    for ext in ("jpg", "png"):
        paths = []
        for i, (h, w) in enumerate(SHAPES):
            base = rng.rand(h // 5 + 1, w // 5 + 1, 3)
            img = np.kron(base, np.ones((5, 5, 1)))[:h, :w] + 0.1 * rng.rand(h, w, 3)
            p = str(root / f"im{i}.{ext}")
            Image.fromarray(np.clip(img * 230, 0, 255).astype(np.uint8)).save(p)
            paths.append(p)
        out[ext] = paths
    return out


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.sizes, w.sizes)
        assert g.valid == w.valid
        assert g.pixels_u8.dtype == np.uint8
        np.testing.assert_array_equal(g.pixels_u8, w.pixels_u8)


@pytest.mark.parametrize("ext", ["jpg", "png"])
@pytest.mark.parametrize("with_bbxs", [False, True])
@pytest.mark.parametrize("resize_filter,upscale", [("lanczos", False), ("bilinear", True)])
def test_make_batches_native_matches_jax(libs, images, ext, with_bbxs, resize_filter,
                                         upscale):
    kw = dict(image_size=64, batch_size=2, bucket_multiple=32,
              bbxs=BBXS if with_bbxs else None, upscale=upscale,
              resize_filter=resize_filter)
    _same_batches(make_batches_native(images[ext], **kw),
                  j_make_batches_native(images[ext], **kw))


@pytest.fixture(scope="module")
def weights():
    net = RetrievalNet("resnet18", "gem")
    init_random_(net, torch.Generator().manual_seed(0))
    sd = net.state_dict()
    return sd, jax.tree.map(jnp.asarray, port_retrieval_net(sd, "resnet18"))


def _extractors(weights):
    """The two packages' extractors on one set of weights, default config
    (native_preproc None, lanczos, shrink only) at a small size."""
    sd, variables = weights
    cfg_t = port.ExtractConfig(model=port.ModelConfig(arch="resnet18", use_pallas=True),
                               image_size=64, batch_size=4)
    cfg_j = jcfg.ExtractConfig(model=jcfg.ModelConfig(arch="resnet18", use_pallas=True),
                               image_size=64, batch_size=4)
    return (port.Extractor(cfg_t, state_dict=sd, device="cpu"),
            JExtractor(cfg_j, variables=variables))


@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_default_extractor_batches_match_jax(libs, images, weights, ext):
    ex_t, ex_j = _extractors(weights)
    _same_batches(ex_t.make_input_batches(images[ext], bbxs=BBXS),
                  ex_j.make_input_batches(images[ext], bbxs=BBXS))


def test_default_resnet18_gem_descriptors_match_jax(libs, images, weights):
    paths = images["jpg"] + images["png"]
    ex_t, ex_j = _extractors(weights)
    got = ex_t.extract(paths)
    want = np.asarray(ex_j.extract(paths))
    assert got.shape == want.shape == (len(paths), 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_native_preproc_false_keeps_pil(images):
    """native_preproc=False gives make_batches's (PIL) batches, and
    native_preproc=True is a supported setting."""
    cfg = port.ExtractConfig(model=port.ModelConfig(arch="resnet18"), image_size=64,
                             batch_size=4, native_preproc=False)
    ex = port.Extractor(cfg, state_dict=RetrievalNet("resnet18", "gem").state_dict(),
                        device="cpu")
    _same_batches(ex.make_input_batches(images["jpg"], bbxs=BBXS),
                  make_batches(images["jpg"], image_size=64, batch_size=4, bbxs=BBXS,
                               upscale=cfg.upscale, resize_filter=cfg.resize_filter))
    check_supported(port.ExtractConfig(native_preproc=True))


def test_array_inputs_keep_pil(libs):
    """Arrays never reach the native decoder, whatever native_preproc says."""
    rng = np.random.RandomState(1)
    arrays = [rng.rand(h, w, 3).astype(np.float32) for h, w in SHAPES[:3]]
    cfg = port.ExtractConfig(model=port.ModelConfig(arch="resnet18"), image_size=64,
                             batch_size=4, native_preproc=True)
    ex = port.Extractor(cfg, state_dict=RetrievalNet("resnet18", "gem").state_dict(),
                        device="cpu")
    _same_batches(ex.make_input_batches(arrays),
                  make_batches(arrays, image_size=64, batch_size=4,
                               upscale=cfg.upscale, resize_filter=cfg.resize_filter))
