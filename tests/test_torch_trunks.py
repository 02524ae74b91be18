"""Port parity: the AlexNet, SqueezeNet 1.1 and DenseNet trunks and their
descriptor heads against the JAX package, on the same weights (the port's
seeded init, carried into flax by the JAX package's ``torch_port``) and the
same numpy-seeded inputs. DenseNet runs slimmed (same layer structure, a
few narrow layers a block) under an arch name both packages register for
this module."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from irtpu.models import densenet as j_densenet
from irtpu.models import retrieval_net as j_retrieval_net
from irtpu.models.retrieval_net import RetrievalNet as JNet
from irtpu.models.retrieval_net import build_trunk as j_build_trunk
from irtpu.models.torch_port import port_retrieval_net

from image_retrieval_for_image_based_localization_tpu_torch.models import densenet as p_densenet
from image_retrieval_for_image_based_localization_tpu_torch.models import (
    retrieval_net as p_retrieval_net,
)
from image_retrieval_for_image_based_localization_tpu_torch.models import (
    RetrievalNet,
    init_random_,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
    cirtorch_to_torchvision_keys,
    variables_to_state_dict,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    OUTPUT_DIM,
    feature_mask,
)

TOL = 2e-5  # the JAX suite's bound between two f32 trunks (tests/test_models.py)
SLIM = "densenet_slim"  # densenet121's structure: growth 8, 2-3 layers a block
SLIM_SPEC = (8, (2, 3, 2, 2), 16)
ARCHS = ("alexnet", "squeezenet1_1", SLIM)
# input (H, W) per arch: odd sizes where the pools' rounding matters
SHAPES = {"alexnet": (99, 80), "squeezenet1_1": (67, 96), SLIM: (64, 96)}


@pytest.fixture(scope="module", autouse=True)
def slim_densenet():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (j_densenet, p_densenet):
            mp.setitem(mod.DENSENET_SPECS, SLIM, SLIM_SPEC)
        dim = p_densenet.densenet_out_channels(SLIM)
        for table in (j_retrieval_net.OUTPUT_DIM, p_retrieval_net.OUTPUT_DIM):
            mp.setitem(table, SLIM, dim)
        yield


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(arch, pooling="gem", seed=0, **kw):
    """(port model, JAX model, JAX variables) on the port's seeded weights."""
    port = RetrievalNet(arch, pooling, **kw)
    init_random_(port, torch.Generator().manual_seed(seed))
    variables = jax.tree.map(jnp.asarray, port_retrieval_net(port.state_dict(), arch))
    jkw = {"use_pallas": kw.get("use_kernel", False)}
    return port.eval(), JNet(arch=arch, pooling=pooling, **jkw), variables


@pytest.fixture(scope="module")
def pairs():
    return {arch: _pair(arch, seed=i) for i, arch in enumerate(ARCHS)}


@pytest.mark.parametrize("arch", ARCHS)
def test_trunk_parity(arch, pairs):
    port, _, variables = pairs[arch]
    x = _x((2, *SHAPES[arch], 3), 1)
    with torch.no_grad():
        got = port.trunk_nhwc(torch.from_numpy(x)).numpy()
    trunk_vars = {"params": variables["params"]["trunk"]}
    if "batch_stats" in variables:
        trunk_vars["batch_stats"] = variables["batch_stats"]["trunk"]
    want = np.asarray(j_build_trunk(arch).apply(trunk_vars, jnp.asarray(x)))
    assert got.shape == want.shape and got.shape[-1] == OUTPUT_DIM[arch]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_flax_round_trip(arch, pairs):
    """port state_dict -> JAX port_retrieval_net -> variables_to_state_dict
    gives every key back bit for bit and loads strictly."""
    port, _, variables = pairs[arch]
    sd = variables_to_state_dict(jax.tree.map(np.asarray, variables), arch)
    fresh = RetrievalNet(arch, "gem")
    fresh.load_state_dict(sd)  # strict: every key present, none extra
    for key, v in port.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[key].numpy(), v.numpy(), err_msg=key)


def test_densenet_cirtorch_numeric_keys_load(pairs):
    """cirtorch's nn.Sequential(*features) numbers densenet's children."""
    port, _, _ = pairs[SLIM]
    names = ["conv0", "norm0", "relu0", "pool0", "denseblock1", "transition1", "denseblock2",
             "transition2", "denseblock3", "transition3", "denseblock4", "norm5"]
    seq = {n: str(i) for i, n in enumerate(names)}
    sd_ct = {}
    for k, v in port.state_dict().items():
        parts = k.split(".")
        if parts[0] == "features":
            parts[1] = seq[parts[1]]
        sd_ct[".".join(parts)] = v
    back = cirtorch_to_torchvision_keys(sd_ct, SLIM)
    assert set(back) == set(port.state_dict())


@pytest.mark.parametrize("arch", ["densenet121", "densenet169", "densenet201", "densenet161"])
def test_densenet_widths(arch):
    """Each published densenet builds at its width, with the JAX package's
    channel count (C = 1,024 to 2,208: the GeM kernel's new widths)."""
    net = RetrievalNet(arch, "gem")
    assert net.features.out_channels == OUTPUT_DIM[arch] == j_densenet.densenet_out_channels(arch)
    assert OUTPUT_DIM[arch] == j_retrieval_net.OUTPUT_DIM[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_head", "plain_head"])
def test_gem_head_on_bucketed_batch(arch, use_kernel, pairs):
    """A padded bucket with a mask: the kernel head (its plain version on the
    CPU) against the JAX head (Pallas in interpret mode) and the plain one."""
    port, _, variables = pairs[arch]
    port.use_kernel = use_kernel
    jnet = JNet(arch=arch, pooling="gem", use_pallas=use_kernel)
    H, W = 96, 128
    x = _x((2, H, W, 3), 2)
    mask = np.zeros((2, H, W), bool)
    mask[0] = True
    mask[1, :70, :100] = True
    x = x * mask[..., None]
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    port.use_kernel = False
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_alexnet_stride_is_not_32_on_a_1024_x_724_bucket(pairs):
    """AlexNet's padding-free pools give a 63 x 44 map for a 1,024 x 724
    bucket: the mask is sampled every 1024 // 63 = 16 rows and 724 // 44 = 16
    columns, as the JAX model does, and the descriptors agree."""
    port, jnet, variables = pairs["alexnet"]
    H, W = 1024, 724
    mask = np.zeros((2, H, W), bool)
    mask[0] = True
    mask[1, :700, :690] = True
    x = _x((2, H, W, 3), 3) * mask[..., None]
    with torch.no_grad():
        feats = port.trunk_nhwc(torch.from_numpy(x))
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert tuple(feats.shape[1:3]) == (63, 44)
    fm = feature_mask(torch.from_numpy(mask), (H, W), feats.shape[1:3])
    np.testing.assert_array_equal(fm.numpy(), mask[:, ::16, ::16][:, :63, :44])
    assert fm[1].any(dim=1).sum().item() == 44 and fm[1].any(dim=0).sum().item() == 44
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
