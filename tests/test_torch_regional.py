"""Port parity: the regional model (cirtorch Rpool), structured extraction
(``extract_regional``, ``extract_local``), resumable extraction and
``extract --regional`` against the JAX package, on the same weights and the
same numpy-seeded images (resnet18 at 64 px)."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import irtpu.data.native as jnative
from irtpu.api import Extractor as JExtractor
from irtpu.cli import main as jmain
from irtpu.models.retrieval_net import RetrievalNet as JNet
from irtpu.models.torch_port import port_retrieval_net
from irtpu.utils import config as jcfg

import image_retrieval_for_image_based_localization_tpu_torch as port
import image_retrieval_for_image_based_localization_tpu_torch.api as port_api
from image_retrieval_for_image_based_localization_tpu_torch.api import rescale
from image_retrieval_for_image_based_localization_tpu_torch.cli import main
from image_retrieval_for_image_based_localization_tpu_torch.models import (
    RetrievalNet,
    init_random_,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.normalization import l2n
from image_retrieval_for_image_based_localization_tpu_torch.ops.pooling import rmac_regions
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import DEFAULT_SCALES

TOL = 1e-5


def _x(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _images(seed, shapes=((64, 64), (32, 64), (64, 40))):
    rng = np.random.RandomState(seed)
    return [rng.rand(h, w, 3).astype(np.float32) for h, w in shapes]


def _sd(arch="resnet18", pooling="gem", seed=0, **kw):
    net = RetrievalNet(arch, pooling, **kw)
    init_random_(net, torch.Generator().manual_seed(seed))
    return net.state_dict()


def _extractors(sd, arch="resnet18", **mkw):
    """(port Extractor on the CPU, JAX Extractor) with the same weights.
    ``mkw`` holds ModelConfig fields; ``scales`` and ``batch_size`` go to
    the ExtractConfig."""
    scales = mkw.pop("scales", (1.0,))
    bs = mkw.pop("batch_size", 2)
    cfg_t = port.ExtractConfig(model=port.ModelConfig(arch=arch, **mkw), image_size=64,
                               batch_size=bs, scales=scales)
    cfg_j = jcfg.ExtractConfig(model=jcfg.ModelConfig(arch=arch, **mkw), image_size=64,
                               batch_size=bs, scales=scales)
    variables = jax.tree.map(jnp.asarray, port_retrieval_net(sd, arch))
    return (port.Extractor(cfg_t, state_dict=sd, device="cpu"),
            JExtractor(cfg_j, variables=variables))


@pytest.fixture(scope="module")
def regional_whiten():
    """resnet18 + GeM, regional, whitening to 64 per region."""
    return _extractors(_sd(regional=True, whiten_dim=64, seed=1), regional=True, whiten_dim=64)


@pytest.fixture(scope="module")
def regional_ms():
    """resnet18 + GeM, regional, three scales."""
    return _extractors(_sd(regional=True, seed=2), regional=True, scales=DEFAULT_SCALES,
                       batch_size=1)


@pytest.fixture(scope="module")
def plain_ms():
    """resnet18 + GeM (not regional), three scales."""
    return _extractors(_sd(seed=3), scales=DEFAULT_SCALES)


def test_regional_head_matches_jax():
    sd = _sd(regional=True, whiten_dim=128, seed=4)
    net = RetrievalNet("resnet18", "gem", whiten_dim=128, regional=True).eval()
    net.load_state_dict(sd)
    variables = jax.tree.map(jnp.asarray, port_retrieval_net(sd, "resnet18"))
    jnet = JNet(arch="resnet18", pooling="gem", regional=True, whiten_dim=128)
    x = _x((1, 64, 96, 3), 5)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
        regs = net(torch.from_numpy(x), return_regions=True).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply(variables, jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    want_regs = np.asarray(jnet.apply(variables, jnp.asarray(x), return_regions=True))
    assert regs.shape == want_regs.shape == (1, 1 + len(rmac_regions(2, 3)), 128)
    np.testing.assert_allclose(regs, want_regs, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    mask = torch.ones((1, 64, 96), dtype=torch.bool)
    mask[:, 32:] = False
    with pytest.raises(ValueError, match="exact shapes"):
        net(torch.from_numpy(x), mask)


def test_regional_validation():
    """Regional NetVLAD (and R-MAC) are refused before the pooling dispatch,
    as is return_regions on a model that is not regional."""
    for pooling in ("netvlad", "rmac", "gemmp"):
        with pytest.raises(ValueError, match="regional pooling wraps"):
            RetrievalNet("resnet18", pooling, regional=True)
        with pytest.raises(ValueError, match="regional pooling wraps"):
            port.Extractor(port.ExtractConfig(model=port.ModelConfig(
                arch="resnet18", pooling=pooling, regional=True)), device="cpu")
    with pytest.raises(ValueError, match="return_regions requires regional"):
        RetrievalNet("resnet18", "gem")(torch.zeros((1, 32, 32, 3)), return_regions=True)


def test_regional_bf16_kernel_flag_keeps_the_f32_head():
    """use_pallas + bf16 + regional: the regional head pools the f32 map, so
    the kernel flag changes nothing, bit for bit."""
    sd = _sd(regional=True, seed=6)
    x = torch.from_numpy(_x((1, 64, 64, 3), 7))
    outs = []
    for use_kernel in (True, False):
        net = RetrievalNet("resnet18", "gem", regional=True, dtype="bfloat16",
                           use_kernel=use_kernel).eval()
        net.load_state_dict(sd)
        with torch.no_grad():
            outs.append(net(x).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].dtype == np.float32


def test_regional_extractor_forces_exact(regional_whiten):
    ex, jex = regional_whiten
    assert ex.cfg.exact is True and jex.cfg.exact is True
    imgs = _images(8)
    d = ex.extract(imgs)
    assert d.shape == (3, 64)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(d, jex.extract(imgs), rtol=TOL, atol=TOL)


def test_regional_multiscale_uses_plain_mean(regional_ms):
    """msp = 1 for a regional model: the scales' descriptors are averaged
    and L2-normalized, not power-meaned with GeM's p."""
    ex, jex = regional_ms
    img = _images(9, ((64, 64),))
    got = ex.extract(img)
    per_scale = [port.Extractor(dataclasses.replace(ex.cfg, scales=(s,)),
                                state_dict=ex.model.state_dict(), device="cpu").extract(img)
                 for s in DEFAULT_SCALES]
    want = l2n(torch.from_numpy(np.mean(per_scale, axis=0))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=TOL)
    np.testing.assert_allclose(got, jex.extract(img), rtol=TOL, atol=TOL)


def test_extract_regional_matches_jax(regional_whiten):
    ex, jex = regional_whiten
    imgs = _images(10)
    regs, jregs = ex.extract_regional(imgs), jex.extract_regional(imgs)
    assert len(regs) == 3
    for r, jr in zip(regs, jregs):
        assert r.shape == jr.shape and r.shape[1] == 64
        np.testing.assert_allclose(r, jr, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(np.linalg.norm(r, axis=1), 1.0, atol=1e-5)
    assert regs[1].shape[0] != regs[0].shape[0]  # another aspect, another grid
    agg = ex.extract(imgs)  # the aggregated descriptor is l2n(sum of regions)
    for i, r in enumerate(regs):
        want = l2n(torch.from_numpy(r.sum(axis=0))).numpy()
        np.testing.assert_allclose(agg[i], want, rtol=1e-4, atol=TOL)


def test_extract_regional_multiscale_concatenates_scales(regional_ms):
    ex, jex = regional_ms
    img = _images(11, ((64, 48),))
    regs = ex.extract_regional(img)[0]
    np.testing.assert_allclose(regs, jex.extract_regional(img)[0], rtol=TOL, atol=TOL)
    per_scale = [port.Extractor(dataclasses.replace(ex.cfg, scales=(s,)),
                                state_dict=ex.model.state_dict(),
                                device="cpu").extract_regional(img)[0]
                 for s in sorted(DEFAULT_SCALES, reverse=True)]
    np.testing.assert_allclose(regs, np.concatenate(per_scale, axis=0), rtol=1e-4, atol=TOL)


def test_extract_regional_requires_regional_model(plain_ms):
    with pytest.raises(ValueError, match="regional"):
        plain_ms[0].extract_regional([np.zeros((64, 64, 3), np.float32)])


def test_extract_local_matches_jax(plain_ms):
    """[P, C] unit-norm local features; three scales concatenate positions
    (2x2 + 2x2 + 1x1 for a 64 x 64 image, 1x2 + 1x2 + 1x1 for 32 x 64: the
    scales' sizes are floored at 32 px)."""
    ex, jex = plain_ms
    imgs = _images(12, ((64, 64), (32, 64)))
    locs, jlocs = ex.extract_local(imgs), jex.extract_local(imgs)
    assert [f.shape for f in locs] == [f.shape for f in jlocs] == [(9, 512), (5, 512)]
    for f, jf in zip(locs, jlocs):
        np.testing.assert_allclose(f, jf, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(np.linalg.norm(f, axis=-1), 1.0, atol=1e-4)


def test_extract_resumable_matches_jax(plain_ms, tmp_path):
    """Shards on disk, resumed after one is lost, equal one extraction bit
    for bit; the JAX package's resumable extraction agrees."""
    ex, jex = plain_ms
    imgs = [im for seed in (13, 14) for im in _images(seed, ((48, 64), (64, 64), (48, 64)))][:5]
    cache = tmp_path / "cache"
    d1 = ex.extract_resumable(imgs, str(cache), shard_size=2)
    shards = sorted(os.listdir(cache))
    assert shards == ["descs_00000000.npy", "descs_00000002.npy", "descs_00000004.npy"]
    os.remove(cache / shards[1])
    d2 = ex.extract_resumable(imgs, str(cache), shard_size=2)
    np.testing.assert_array_equal(d1, d2)
    assert sorted(os.listdir(cache)) == shards  # no .tmp file left behind
    np.testing.assert_array_equal(d1, ex.extract(imgs))
    jd = jex.extract_resumable(imgs, str(tmp_path / "jcache"), shard_size=2)
    np.testing.assert_allclose(d1, jd, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hw", [(64, 64), (48, 64), (64, 40), (724, 1024)])
@pytest.mark.parametrize("scale", [2 ** -0.5, 0.5])
def test_rescale_matches_jax_image_resize(hw, scale):
    """The structured path's resize: floor-sized, bilinear, no antialias."""
    x = np.random.RandomState(15).randn(1, *hw, 3).astype(np.float32)
    got = rescale(torch.from_numpy(x), scale).numpy()
    nh, nw = max(int(hw[0] * scale), 32), max(int(hw[1] * scale), 32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, nh, nw, 3), "bilinear",
                                       antialias=False))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


def test_cli_extract_regional_matches_jax(tmp_path):
    """``extract --regional`` through both CLIs on one .pth, PIL decode in both."""
    rng = np.random.RandomState(16)
    paths = []
    for i, (h, w) in enumerate(((64, 64), (48, 64), (64, 48))):
        p = str(tmp_path / f"im{i}.png")
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    pth = str(tmp_path / "r18.pth")
    torch.save(_sd(regional=True, seed=17), pth)
    argv = ["extract", "--images", *paths, "--arch", "resnet18", "--regional",
            "--image-size", "64", "--batch-size", "2", "--checkpoint", pth, "--out"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "native_available", lambda: False)
        mp.setattr(port_api, "native_available", lambda: False)
        assert (jmain(argv + [str(tmp_path / "j.npy")]) or 0) == 0
        assert main(argv + [str(tmp_path / "p.npy"), "--device", "cpu"]) == 0
    dj, dp = np.load(tmp_path / "j.npy"), np.load(tmp_path / "p.npy")
    assert dp.shape == (3, 512)
    np.testing.assert_allclose(dp, dj, rtol=0, atol=2e-5)
