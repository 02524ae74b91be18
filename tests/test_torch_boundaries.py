"""Boundaries of the PyTorch/CUDA port: it imports no JAX, and its entry
points never fall back to the CPU unasked."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import image_retrieval_for_image_based_localization_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "image_retrieval_for_image_based_localization_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "optax", "orbax", "irtpu",
             "image_retrieval_for_image_based_localization_tpu")


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
                                   "initialize_distributed"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, tmp_path):
    _needs_no_cuda()
    cfg = port.ExtractConfig(model=port.ModelConfig(arch="resnet18"), image_size=64)
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
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_unported_options_raise():
    for mc in (port.ModelConfig(dtype="float16"), port.ModelConfig(s2d_stem=True),
               port.ModelConfig(regional=True), port.ModelConfig(arch="alexnet"),
               port.ModelConfig(arch="squeezenet1_1"), port.ModelConfig(arch="densenet121"),
               port.ModelConfig(arch="vgg16", pooling="gemmp")):
        with pytest.raises(ValueError):
            port.Extractor(port.ExtractConfig(model=mc), device="cpu")
    # the fused bottleneck trunk takes bottleneck resnets only
    for arch in ("resnet18", "vgg16"):
        with pytest.raises(ValueError, match="fuse_blocks"):
            port.Extractor(port.ExtractConfig(model=port.ModelConfig(arch=arch),
                                              fuse_blocks=True), device="cpu")
    # and f32 only: the fused bottleneck kernel has no bf16 variant yet
    with pytest.raises(ValueError, match="fuse_blocks.*bf16 variant"):
        port.Extractor(port.ExtractConfig(model=port.ModelConfig(dtype="bfloat16"),
                                          fuse_blocks=True), device="cpu")
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
    # a mesh with a data axis (data-parallel extraction and training) is not
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        port.parallel.create_mesh([2, 1], devices=["cpu"])
