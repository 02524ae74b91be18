"""Boundaries of the PyTorch/CUDA port: it imports no JAX, and its entry
points never fall back to the CPU unasked."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.cli import main as cli_main
from image_retrieval_for_image_based_localization_tpu_torch.serving import (
    RetrievalService,
    serve,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "image_retrieval_for_image_based_localization_tpu_torch")
# the JAX package and its stack; the port reads Orbax checkpoints with its own
# decoder, so orbax's storage stack is forbidden too
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "optax", "orbax", "irtpu",
             "image_retrieval_for_image_based_localization_tpu", "tensorstore", "zstandard",
             "msgpack")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_and_chip_smoke_import_no_jax():
    files = _port_files()
    assert len(files) > 15 and os.path.exists(files[0])
    bad = {(os.path.relpath(f, ROOT), m) for f in files for m in _imported_roots(f)
           if m in FORBIDDEN}
    assert not bad, sorted(bad)


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")


@pytest.mark.parametrize("entry", ["Extractor", "extract_features", "build_index",
                                   "Index.load", "IVFIndex.build", "PQIndex.build",
                                   "load_pq_artifact", "default_mesh", "ShardedIndex",
                                   "initialize_distributed", "RetrievalService", "serve",
                                   "cli"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, tmp_path):
    _needs_no_cuda()
    cfg = port.ExtractConfig(model=port.ModelConfig(arch="resnet18"), image_size=64)
    cpu_index = port.build_index(np.eye(4, dtype=np.float32), device="cpu")
    calls = {
        "Extractor": lambda: port.Extractor(cfg),
        "extract_features": lambda: port.extract_features(
            [np.zeros((64, 64, 3), np.uint8)], cfg),
        "build_index": lambda: port.build_index(np.eye(4, dtype=np.float32)),
        "Index.load": lambda: port.retrieval.index.Index.load(str(tmp_path / "none")),
        "IVFIndex.build": lambda: port.IVFIndex.build(np.eye(4, dtype=np.float32)),
        "PQIndex.build": lambda: port.PQIndex.build(np.eye(4, dtype=np.float32), m=2),
        "load_pq_artifact": lambda: port.load_pq_artifact(str(tmp_path / "none")),
        "default_mesh": lambda: port.parallel.default_mesh(),
        "ShardedIndex": lambda: port.parallel.ShardedIndex(np.eye(4, dtype=np.float32)),
        "initialize_distributed": lambda: port.parallel.distributed.initialize_distributed(
            "127.0.0.1:1", num_processes=2, process_id=0),
        "RetrievalService": lambda: RetrievalService(cpu_index),
        "serve": lambda: serve(cpu_index, block=False, port=0),
        "cli": lambda: cli_main(["query", "--index", str(tmp_path / "none.npz"),
                                 "--queries", str(tmp_path / "none.npy")]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_unported_options_raise():
    with pytest.raises(ValueError):
        port.Extractor(port.ExtractConfig(model=port.ModelConfig(dtype="float16")), device="cpu")
    # s2d_stem is taken (the JAX package's stem layout: the same function);
    # tests/test_torch_s2d_stem.py holds it against the JAX extractor
    assert port.Extractor(port.ExtractConfig(model=port.ModelConfig(s2d_stem=True)),
                          device="cpu").model.arch == "resnet50"
    # every trunk runs in bf16, densenet121 included
    assert port.Extractor(port.ExtractConfig(model=port.ModelConfig(
        arch="densenet121", dtype="bfloat16")), device="cpu").model.compute_dtype == torch.bfloat16
    # the trainer takes every trunk and head (refused until the port trained
    # them): each builds a train state and takes a step
    rng = np.random.RandomState(0)
    pixels = rng.rand(1, 3, 32, 32, 3).astype(np.float32)
    labels = np.array([[0, 1, -1]], np.int32)
    cfg = port.TrainConfig(n_neg=1, batch_tuples=1, lr=1e-3)
    for kw in (dict(arch="densenet121"), dict(arch="resnet18", pooling="gemmp"),
               dict(arch="resnet18", regional=True)):
        model = port.models.RetrievalNet(**kw)
        state = port.create_train_state(model, cfg, device="cpu")
        state, loss = port.training.make_train_step(model, cfg)(state, pixels, labels)
        assert state.step == 1 and np.isfinite(float(loss)), kw
    # the fused bottleneck trunk takes bottleneck resnets only
    for arch in ("resnet18", "vgg16"):
        with pytest.raises(ValueError, match="fuse_blocks"):
            port.Extractor(port.ExtractConfig(model=port.ModelConfig(arch=arch),
                                              fuse_blocks=True), device="cpu")
    # in f32 and in bf16 (the bf16 form of the fused bottleneck kernel)
    ex = port.Extractor(port.ExtractConfig(model=port.ModelConfig(dtype="bfloat16"),
                                           fuse_blocks=True), device="cpu")
    assert ex._folded and ex.model.compute_dtype == torch.bfloat16
    assert port.Extractor(port.ExtractConfig(fuse_blocks=True), device="cpu")._folded
    # bf16 compute (graded configs 4 and 5) is ported
    assert port.Extractor(port.ExtractConfig(model=port.ModelConfig(
        arch="resnet18", dtype="bfloat16")), device="cpu").model.compute_dtype == torch.bfloat16
    # graded config 3's model is ported
    cfg3 = port.GRADED_CONFIGS[3].extract
    ex = port.Extractor(dataclasses.replace(cfg3, model=dataclasses.replace(
        cfg3.model, netvlad_clusters=4)), device="cpu")
    assert ex.out_dim == 4 * 512
    # database-side augmentation is ported: each row averaged with its 2 nearest
    dba = port.build_index(np.eye(4, dtype=np.float32), port.IndexConfig(whitening=None,
                                                                         dba_nqe=2),
                           device="cpu")
    np.testing.assert_allclose(np.linalg.norm(dba.gallery, axis=1), 1.0, atol=1e-6)
    # a mesh with a data axis (data-parallel extraction and training) is
    # ported: shard s sits at (s // G, s % G), the JAX mesh's row-major order
    mesh = port.parallel.create_mesh([2, 1], devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 2, "gallery": 1}
    assert [(mesh.data_index(j), mesh.gallery_index(j)) for j in range(2)] == [(0, 0), (1, 0)]
    assert mesh.data_rows == [0, 1] and mesh.gallery_shards == [0]


def test_mesh_coordinates_are_the_jax_meshs_row_major_order():
    import jax

    from irtpu.parallel import create_mesh as j_create_mesh

    for sizes in ([2, 1], [2, 2], [4, 2], [1, 8], [8, 1]):
        n = sizes[0] * sizes[1]
        mesh = port.parallel.create_mesh(sizes, devices=["cpu"] * n)
        jmesh = j_create_mesh(sizes, devices=jax.devices()[:n])
        where = {d.id: (int(i), int(j)) for (i, j), d in np.ndenumerate(jmesh.devices)}
        assert [(mesh.data_index(s), mesh.gallery_index(s)) for s in range(n)] == \
            [where[d.id] for d in jax.devices()[:n]], sizes


def test_mesh_refuses_shards_that_straddle_data_rows(monkeypatch):
    """Three processes of two shards on a 2 x 3 mesh: process 1 would hold
    the end of one data row and the start of the next."""
    from image_retrieval_for_image_based_localization_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "_group", lambda: (0, 3))
    with pytest.raises(ValueError, match="whole data rows"):
        mesh_mod.create_mesh([2, 3], devices=["cpu", "cpu"])


def test_data_parallel_training_refusals():
    from image_retrieval_for_image_based_localization_tpu_torch.parallel.mesh import Mesh

    cfg = port.TrainConfig(n_neg=1, batch_tuples=3)
    model = port.models.RetrievalNet("resnet18")
    # shards of one process on two devices: one process per card (ROADMAP C14)
    two_cards = Mesh({"data": 2, "gallery": 1}, [torch.device("cuda", 0),
                                                 torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="one process per card"):
        port.make_train_step(model, cfg, mesh=two_cards)
    # a global batch the data axis does not divide, as the JAX shardings refuse
    state = port.create_train_state(model, cfg, device="cpu")
    step = port.make_train_step(model, cfg, mesh=port.create_mesh([2, 1], devices=["cpu"] * 2))
    px = np.zeros((3, 3, 32, 32, 3), np.float32)
    labels = np.tile(np.array([[0, 1, -1]], np.int32), (3, 1))
    with pytest.raises(ValueError, match="multiple of the data axis"):
        step(state, px, labels)
    # one process holding both data rows trains the whole batch as one
    state, loss = step(state, px[:2], labels[:2])
    assert state.step == 1 and np.isfinite(float(loss))


def test_data_parallel_extraction_refuses_two_devices_in_one_process():
    from image_retrieval_for_image_based_localization_tpu_torch.parallel.mesh import Mesh

    # one process per card (ROADMAP C14), refused before anything reaches a card
    two_cards = Mesh({"data": 2, "gallery": 1}, [torch.device("cuda", 0),
                                                 torch.device("cuda", 1)])
    cfg = port.ExtractConfig(model=port.ModelConfig(arch="resnet18"), image_size=64)
    with pytest.raises(NotImplementedError, match="one process per card"):
        port.Extractor(cfg, mesh=two_cards)


# ---- C13: the sub-packages export what the JAX package's export ------------------

SUBPACKAGES = ("data", "retrieval", "evaluation", "models", "ops")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_the_jax_package(sub):
    import importlib

    path = os.path.join(ROOT, "image_retrieval_for_image_based_localization_tpu", sub,
                        "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.asname or a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
             for a in node.names]
    assert names
    mod = importlib.import_module(f"image_retrieval_for_image_based_localization_tpu_torch.{sub}")
    assert [n for n in names if not hasattr(mod, n)] == []


def test_create_model_matches_the_jax_factory():
    import jax
    import jax.numpy as jnp

    from irtpu.models import create_model as j_create_model

    from image_retrieval_for_image_based_localization_tpu_torch.models import create_model
    from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
        variables_to_state_dict,
    )

    kw = dict(arch="resnet18", pooling="gem", whiten_dim=16, use_pallas=True)
    jm = j_create_model(**kw, dtype=jnp.float32)
    tm = create_model(**kw, dtype=jnp.float32)
    assert (tm.arch, tm.pooling, tm.whiten_dim, tm.use_kernel, tm.compute_dtype) == \
        ("resnet18", "gem", 16, True, torch.float32)
    assert create_model("resnet18", dtype=torch.bfloat16).compute_dtype == torch.bfloat16
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    tm.load_state_dict(variables_to_state_dict(v, "resnet18"))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), rtol=0, atol=2e-5)
    # s2d_stem builds the same model (the JAX stem layout computes the same
    # function of the same parameter)
    s2d = create_model(**kw, dtype=jnp.float32, s2d_stem=True)
    s2d.load_state_dict(variables_to_state_dict(v, "resnet18"))
    with torch.no_grad():
        assert torch.equal(s2d.eval()(torch.from_numpy(x)), torch.from_numpy(got))


def test_normalize_images_matches_the_jax_package():
    from irtpu.data import normalize_images as j_normalize

    from image_retrieval_for_image_based_localization_tpu_torch.data import normalize_images

    x = np.random.RandomState(1).rand(2, 5, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(normalize_images(x), np.asarray(j_normalize(x)))


def test_approx_topk_is_the_jax_approx_topk_on_this_platform():
    import jax.numpy as jnp

    from irtpu.retrieval import approx_topk as j_approx_topk

    from image_retrieval_for_image_based_localization_tpu_torch.retrieval import approx_topk

    rng = np.random.RandomState(2)
    g = rng.randn(300, 32).astype(np.float32)
    q = rng.randn(7, 32).astype(np.float32)
    s, i = approx_topk(torch.from_numpy(g), torch.from_numpy(q), 20)
    js, ji = j_approx_topk(jnp.asarray(g), jnp.asarray(q), 20)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    s2, i2 = approx_topk(g, q, 20, recall_target=1.0)  # numpy inputs too
    assert torch.equal(i2, i)
    with pytest.raises(ValueError, match="recall_target"):
        approx_topk(g, q, 5, recall_target=0.0)
