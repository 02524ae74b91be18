"""Port parity: the model zoo and the checkpoint-meta contract against the
JAX package's ``models/zoo.py``, and ``load_model`` from a ``.pth`` file
(this package's layout and cirtorch's) and from a checkpoint directory."""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from irtpu.models import zoo as jzoo
from irtpu.models.torch_port import port_retrieval_net

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.models import init_random_
from image_retrieval_for_image_based_localization_tpu_torch.models import zoo
from image_retrieval_for_image_based_localization_tpu_torch.utils.checkpoint import (
    save_checkpoint,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


def test_zoo_has_the_jax_presets():
    assert zoo.MODEL_ZOO == {k: port.ModelConfig(**v.__dict__)
                             for k, v in jzoo.MODEL_ZOO.items()}
    assert len(zoo.MODEL_ZOO) == 12


@pytest.mark.parametrize("name", sorted(jzoo.MODEL_ZOO))
def test_every_preset_builds_with_the_jax_width(name):
    m = zoo.create_model_from_zoo(name)
    assert m.out_dim == jzoo.create_model_from_zoo(name).out_dim > 0


@pytest.mark.parametrize("name", sorted(jzoo.MODEL_ZOO))
def test_every_preset_builds_an_extractor(name):
    ex = port.Extractor(port.ExtractConfig(model=zoo.MODEL_ZOO[name]), device="cpu")
    assert ex.out_dim == zoo.create_model_from_zoo(name).out_dim


def test_meta_round_trip_and_overrides():
    m = zoo.create_model_from_zoo("resnet18-gem", whiten_dim=32)
    meta = zoo.model_to_meta(m)
    m2 = zoo.create_model_from_meta(meta)
    assert (m2.arch, m2.pooling, m2.whiten_dim, m2.regional) == ("resnet18", "gem", 32, False)
    # a meta written by either package rebuilds the same model in the other
    jm = jzoo.create_model_from_meta(meta)
    assert (jm.arch, jm.pooling, jm.whiten_dim) == (m2.arch, m2.pooling, m2.whiten_dim)
    jmeta = jzoo.model_to_meta(jzoo.create_model_from_zoo("vgg16-netvlad64"))
    pm = zoo.create_model_from_meta(jmeta)
    assert (pm.arch, pm.pooling, pm.netvlad_clusters, pm.out_dim) == ("vgg16", "netvlad", 64,
                                                                       64 * 512)
    r = zoo.create_model_from_meta({"arch": "resnet18", "pooling": "mac", "regional": True})
    assert r.regional and zoo.model_to_meta(r)["regional"] is True


def test_zoo_unknown_raises():
    with pytest.raises(KeyError, match="unknown zoo model"):
        zoo.create_model_from_zoo("nope")


CIRTORCH_METAS = [
    {"architecture": "resnet101", "pooling": "gem", "whitening": True, "outputdim": 2048},
    {"architecture": "vgg16", "pooling": "mac", "whitening": False, "outputdim": 512},
    {"architecture": "vgg16", "pooling": {"name": "netvlad", "clusters": 32}},
    {"architecture": "alexnet", "pooling": "gem", "regional": True},
    {"arch": "densenet121"},
    {},
]


@pytest.mark.parametrize("meta", CIRTORCH_METAS)
def test_meta_from_cirtorch_matches_jax(meta):
    assert zoo.meta_from_cirtorch(meta) == jzoo.meta_from_cirtorch(meta)


def _lw(seed, d=4):
    rng = np.random.RandomState(seed)
    return {"m": rng.randn(d, 1).astype(np.float32), "P": rng.randn(d, d).astype(np.float32)}


LW_METAS = {
    "nested": {"Lw": {"retrieval-SfM-120k": {"ss": _lw(0), "ms": _lw(1)}}},
    "nested_ms_only": {"Lw": {"retrieval-SfM-120k": {"ms": _lw(2)}}},
    "flat": {"Lw": {"retrieval-SfM-120k": _lw(3)}},
    "other_dataset": {"Lw": {"retrieval-SfM-30k": {"ss": _lw(4)}}},
    "none": {},
}


@pytest.mark.parametrize("kind", sorted(LW_METAS))
@pytest.mark.parametrize("scale", ["ss", "ms"])
def test_cirtorch_lw_matches_jax(kind, scale):
    got = zoo.cirtorch_Lw(LW_METAS[kind], scale=scale)
    want = jzoo.cirtorch_Lw(LW_METAS[kind], scale=scale)
    if want is None:
        assert got is None
        return
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    assert got[0].ndim == 1


@pytest.fixture(scope="module")
def r18():
    net = zoo.create_model_from_zoo("resnet18-gem")
    init_random_(net, torch.Generator().manual_seed(0))
    return net.eval()


def _same(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_load_model_from_pth_matches_jax(r18, tmp_path):
    """A .pth with a cirtorch-style {'state_dict', 'meta'} loads bit for bit,
    and the JAX package's load_model gives the same descriptor."""
    path = str(tmp_path / "ckpt.pth")
    torch.save({"state_dict": r18.state_dict(), "meta": {"architecture": "resnet18"}}, path)
    model, sd = zoo.load_model({"arch": "resnet18", "pooling": "gem"}, checkpoint=path)
    _same(model, r18)
    x = np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    jmodel, variables = jzoo.load_model({"arch": "resnet18", "pooling": "gem"}, checkpoint=path)
    want = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_load_model_from_cirtorch_numeric_keys(tmp_path):
    """cirtorch's numbered trunk keys (densenet: features.0 = conv0 ...) load."""
    net = zoo.create_model_from_zoo("densenet121-gem")
    init_random_(net, torch.Generator().manual_seed(2))
    names = ["conv0", "norm0", "relu0", "pool0", "denseblock1", "transition1", "denseblock2",
             "transition2", "denseblock3", "transition3", "denseblock4", "norm5"]
    sd = {}
    for k, v in net.state_dict().items():
        parts = k.split(".")
        if parts[0] == "features":
            parts[1] = str(names.index(parts[1]))
        sd[".".join(parts)] = v
    path = str(tmp_path / "densenet.pth")
    torch.save(sd, path)
    model, _ = zoo.load_model("densenet121-gem", checkpoint=path)
    _same(model, net)


def test_load_model_from_checkpoint_directory(r18, tmp_path):
    save_checkpoint(str(tmp_path / "run"), {"model": r18.state_dict(), "step": 3},
                    meta=zoo.model_to_meta(r18), is_best=True)
    model, _ = zoo.load_model("resnet18-gem", checkpoint=str(tmp_path / "run"))
    _same(model, r18)


def test_untrusted_load_takes_numpy_metas_without_the_full_unpickler(tmp_path):
    path = str(tmp_path / "cirtorch.pth")
    torch.save({"state_dict": {"pool.p": torch.tensor([3.0])},
                "meta": {"architecture": "resnet18", "Lw": LW_METAS["nested"]["Lw"]}}, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the fallback would warn
        ck = zoo._torch_load_untrusted(path)
    np.testing.assert_array_equal(zoo.cirtorch_Lw(ck["meta"])[1],
                                  LW_METAS["nested"]["Lw"]["retrieval-SfM-120k"]["ss"]["P"])


def test_load_pretrained_verifies_a_cached_checkpoint_offline(r18, tmp_path, monkeypatch):
    """With IRTPU_OFFLINE set, a zoo checkpoint already under
    ``networks/`` loads without a fetch: the model its meta names, the
    weights bit for bit (a 0-d ``pool.p`` takes the model's shape), no Lw
    where the meta has none."""
    monkeypatch.setenv("IRTPU_OFFLINE", "1")
    sd = dict(r18.state_dict(), **{"pool.p": r18.state_dict()["pool.p"].reshape(())})
    (tmp_path / "networks").mkdir()
    torch.save({"state_dict": sd, "meta": {"architecture": "resnet18", "pooling": "gem"}},
               tmp_path / "networks" / "rSfM120k-tl-resnet50-gem-w.pth")
    model, mP = zoo.load_pretrained("rSfM120k-tl-resnet50-gem-w", data_root=str(tmp_path),
                                    device="cpu")
    _same(model, r18)
    assert mP is None and not model.training


def test_jax_variables_load_into_zoo_models(r18):
    """The JAX package's port of the same .pth is the same tree the port's
    flax converter inverts (the parity tests' weight path)."""
    from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
        variables_to_state_dict,
    )

    variables = port_retrieval_net(r18.state_dict(), "resnet18")
    fresh = zoo.create_model_from_zoo("resnet18-gem")
    fresh.load_state_dict(variables_to_state_dict(variables, "resnet18"))
    _same(fresh.eval(), r18)
