"""Port parity: ResNet and VGG-16 trunks, the weights converter and
RetrievalNet (GeM and NetVLAD heads) against the JAX package, with weights
from ``tests/torch_oracles.py`` or the port's seeded init."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from irtpu.models import ResNetTrunk as JTrunk
from irtpu.models import RetrievalNet as JNet
from irtpu.models.torch_port import port_resnet_trunk, port_retrieval_net, port_vgg_trunk
from irtpu.models.vgg import VGGTrunk as JVGGTrunk

from image_retrieval_for_image_based_localization_tpu_torch.models import (
    ResNetTrunk,
    RetrievalNet,
    VGGTrunk,
    init_random_,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
    cirtorch_to_torchvision_keys,
    trunk_state_dict,
    variables_to_state_dict,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    feature_mask,
    rect_sizes,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _oracle(arch, seed):
    from torch_oracles import randomize_bn_stats, resnet18_trunk, resnet50_trunk

    tm = {"resnet18": resnet18_trunk, "resnet50": resnet50_trunk}[arch]()
    return randomize_bn_stats(tm, seed).eval()


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_converter_round_trips_torchvision_state_dict(arch):
    tm = _oracle(arch, 0)
    back = trunk_state_dict(port_resnet_trunk(tm.state_dict(), arch), arch)
    want = tm.state_dict()
    assert set(back) == set(want)
    for key, v in want.items():
        np.testing.assert_array_equal(back[key].numpy(), v.numpy(), err_msg=key)


@pytest.mark.parametrize("arch,tol", [("resnet18", 2e-4), ("resnet50", 5e-4)])
def test_trunk_parity(arch, tol):
    """The JAX suite's own torch-vs-flax bounds (tests/test_models.py)."""
    tm = _oracle(arch, 1)
    port = ResNetTrunk(arch)
    port.load_state_dict(tm.state_dict())  # torchvision names load natively
    port = port.eval().to(memory_format=torch.channels_last)
    x = _x((1, 64, 64, 3), 2)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)
                   .contiguous(memory_format=torch.channels_last))
    got = got.permute(0, 2, 3, 1).numpy()
    v = port_resnet_trunk(tm.state_dict(), arch)
    want = np.asarray(JTrunk(arch).apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _net_pair(arch="resnet18", seed=3, use_kernel=True):
    port = RetrievalNet(arch, "gem", use_kernel=use_kernel)
    init_random_(port, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        port.pool.p.fill_(2.8)
    sd = port.state_dict()
    variables = jax.tree.map(jnp.asarray, port_retrieval_net(sd, arch))
    jnet = JNet(arch=arch, pooling="gem", use_pallas=True)
    return port.eval(), jnet, variables


def test_flax_variables_to_state_dict_loads_strictly():
    port, _, variables = _net_pair()
    sd = variables_to_state_dict(jax.tree.map(np.asarray, variables), "resnet18")
    fresh = RetrievalNet("resnet18", "gem")
    fresh.load_state_dict(sd)  # strict: every key present, none extra
    for key, v in port.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[key].numpy(), v.numpy())


def test_cirtorch_numeric_keys_translate():
    port, _, _ = _net_pair()
    seq = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6",
           "layer4": "7"}
    sd_ct = {}
    for k, v in port.state_dict().items():
        parts = k.split(".")
        if parts[0] == "features":
            parts[1] = seq[parts[1]]
        sd_ct[".".join(parts)] = v
    assert set(cirtorch_to_torchvision_keys(sd_ct, "resnet18")) == set(port.state_dict())


@pytest.mark.parametrize("use_mask", [True, False], ids=["padded_bucket", "unmasked"])
def test_retrieval_net_gem_head(use_mask):
    """use_pallas (Pallas interpret) vs use_kernel (plain version on CPU)."""
    port, jnet, variables = _net_pair()
    x = _x((2, 96, 64, 3), 4)
    mask = np.zeros((2, 96, 64), bool)
    mask[0] = True
    mask[1, :64, :40] = True
    x = x * mask[..., None]
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask) if use_mask else None).numpy()
    want = np.asarray(jnet.apply(variables, jnp.asarray(x),
                                 mask=jnp.asarray(mask) if use_mask else None))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_mask_stride_is_not_always_32():
    """At scale 1/sqrt(2) a 724-row input gives a 23-row map: the mask is
    sampled every 724 // 23 = 31 rows, as the JAX model does."""
    port, jnet, variables = _net_pair(seed=5)
    H, W = 724, 64
    mask = np.zeros((1, H, W), bool)
    mask[0, :690, :] = True  # stride 31 keeps 23 rows valid; stride 32 would keep 22
    with torch.no_grad():
        feats = port.trunk_nhwc(torch.zeros((1, H, W, 3)))
    assert feats.shape[1] == 23
    fm = feature_mask(torch.from_numpy(mask), (H, W), feats.shape[1:3])
    np.testing.assert_array_equal(fm.numpy(), mask[:, ::31, ::32][:, :23, :2])
    assert rect_sizes(fm).tolist() == [[23, 2]]
    x = _x((1, H, W, 3), 6) * mask[..., None]
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_vgg16_trunk_parity():
    """The JAX suite's own torch-vs-flax bound for VGG-16 (tests/test_models.py)."""
    from torch_oracles import VGG16Torch

    tm = VGG16Torch()
    port = VGGTrunk()
    port.load_state_dict(tm.features.state_dict())  # torchvision indices load natively
    port = port.eval().to(memory_format=torch.channels_last)
    x = _x((1, 64, 64, 3), 7)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)
                   .contiguous(memory_format=torch.channels_last))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == (1, 4, 4, 512)  # stride 16: the final max-pool is stripped
    v = port_vgg_trunk(tm.state_dict())
    want = np.asarray(JVGGTrunk().apply({"params": v["params"]}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def _vgg_netvlad_pair(seed=11, clusters=8):
    port = RetrievalNet("vgg16", "netvlad", use_kernel=True, netvlad_clusters=clusters)
    init_random_(port, torch.Generator().manual_seed(seed))
    variables = jax.tree.map(jnp.asarray, port_retrieval_net(port.state_dict(), "vgg16"))
    jnet = JNet(arch="vgg16", pooling="netvlad", netvlad_clusters=clusters, use_pallas=True)
    return port.eval(), jnet, variables


def test_vgg_netvlad_flax_round_trip():
    """port state_dict -> JAX port_retrieval_net -> variables_to_state_dict
    gives every key back, bit for bit, and the JAX model accepts the tree."""
    port, jnet, variables = _vgg_netvlad_pair()
    want_tree = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    assert (jax.tree.map(lambda a: a.shape, want_tree)
            == jax.tree.map(lambda a: a.shape, dict(variables)))
    sd = variables_to_state_dict(jax.tree.map(np.asarray, variables), "vgg16")
    fresh = RetrievalNet("vgg16", "netvlad", netvlad_clusters=8)
    fresh.load_state_dict(sd)  # strict: every key present, none extra
    for key, v in port.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[key].numpy(), v.numpy(), err_msg=key)
    assert port.out_dim == 8 * 512


@pytest.mark.parametrize("use_mask", [True, False], ids=["padded_bucket", "unmasked"])
def test_retrieval_net_vgg_netvlad_head(use_mask):
    """use_pallas (Pallas interpret, rect kernel on the bucket) vs use_kernel
    (the kernels' plain version on CPU)."""
    port, jnet, variables = _vgg_netvlad_pair()
    x = _x((3, 96, 64, 3), 12)
    mask = np.zeros((3, 96, 64), bool)
    mask[0] = True
    mask[1, :64, :48] = True
    mask[2, :16, :64] = True
    x = x * mask[..., None]
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask) if use_mask else None).numpy()
    want = np.asarray(jnet.apply(variables, jnp.asarray(x),
                                 mask=jnp.asarray(mask) if use_mask else None))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_netvlad_nonrect_mask_takes_the_oracle_branch(monkeypatch):
    """A mask that is not a top-left rectangle gives the JAX package's
    oracle-branch result, and the rect kernel is not called for it."""
    from image_retrieval_for_image_based_localization_tpu_torch.models import retrieval_net

    def refuse(*a, **k):
        raise AssertionError("rect kernel called for a non-rectangular mask")

    port, jnet, variables = _vgg_netvlad_pair(seed=13)
    rng = np.random.RandomState(14)
    x = rng.rand(2, 64, 96, 3).astype(np.float32)
    mask = rng.rand(2, 64, 96) > 0.35
    mask[:, 0, 0] = True
    monkeypatch.setattr(retrieval_net, "netvlad_fused_rect", refuse)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_init_random_is_reproducible_for_vgg_netvlad():
    """Every parameter comes from the explicit generator: the same seed
    twice gives bit-identical weights, whatever the global RNG does."""
    sds = []
    for global_seed in (0, 1):
        torch.manual_seed(global_seed)
        net = RetrievalNet("vgg16", "netvlad", netvlad_clusters=8, whiten_dim=16)
        sds.append(init_random_(net, torch.Generator().manual_seed(5)).state_dict())
    for key, v in sds[0].items():
        assert torch.equal(v, sds[1][key]), key
    assert sds[0]["features.0.bias"].abs().sum() > 0
    assert torch.all(sds[0]["pool.conv.bias"] == 0)
