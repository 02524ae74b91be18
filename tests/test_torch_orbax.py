"""The port's Orbax reader against orbax, tensorstore and zstandard, on the CPU.

``utils/orbax.py`` walks the OCDBT store and the zarr arrays of a JAX
package's checkpoint directory itself, and ``csrc/zstd_decode.cpp`` (built
with the host compiler at first use) decodes its zstd frames and CRC32C.
Held here:

- every leaf of checkpoints written by the JAX package's ``save_checkpoint``
  bit for bit against its ``load_checkpoint`` (orbax's restore): a nested
  dict/list tree of every dtype with empty nodes, arrays in many chunks, a
  JAX train state, a full-width resnet50 ``RetrievalNet``, and the committed
  fixture that path M of ``chip_smoke.py`` reads;
- the OCDBT walk against tensorstore's own reads on multi-level B+trees with
  indirect values, several data files and version-tree nodes;
- zstd frames that tensorstore's zarr writer makes at levels 1, 3 and 19
  over zeros, repeats, random bytes and float weights, against tensorstore's
  read, and zstandard's frames with checksums, several frames, skippable
  frames and no declared size;
- corruption and unknown layouts raising: a flipped byte in a node (CRC32C)
  or in a frame, zarr v3, no OCDBT, another compressor, an unknown value
  type, a failed build of the decoder;
- the CLI: ``extract`` and ``evaluate --checkpoint <JAX run dir>`` against
  the JAX CLI on the same directory, and ``train --resume <JAX run dir>``
  training on from the JAX run's epoch (tests/test_torch_resume.py holds
  that resume against the JAX package's own).
"""

import json
import os
import shutil
import sys
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard

from irtpu.cli import main as jmain
from irtpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from irtpu.utils.checkpoint import save_checkpoint as j_save_checkpoint

from image_retrieval_for_image_based_localization_tpu_torch.cli import main
from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
    make_synthetic_dataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils import orbax
from image_retrieval_for_image_based_localization_tpu_torch.utils.checkpoint import (
    load_checkpoint,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "jax_orbax_squeezenet1_1")
sys.path.insert(0, ROOT)
from chip_smoke import flat_tree  # noqa: E402  (the fixture's tree.npz keys)


def assert_same_tree(got, want, path="tree"):
    """Same nesting (dict, list, tuple, None) and every array bit for bit;
    a bfloat16 leaf comes back as a ``torch.bfloat16`` tensor."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}.{i}")
    elif want is None:
        assert got is None, path
    else:
        want = np.asarray(want)
        if want.dtype == ml_dtypes.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            assert tuple(got.shape) == want.shape, path
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            assert isinstance(got, np.ndarray), path
            assert got.dtype == want.dtype and got.shape == want.shape, path
            assert got.tobytes() == want.tobytes(), path


def _every_dtype_tree():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((3, 4, 5))
    return {
        "f32": f.astype(np.float32), "f64": f, "f16": f.astype(np.float16),
        "bf16": f.astype(np.float32).astype(ml_dtypes.bfloat16),
        "i32": rng.integers(-2**31, 2**31 - 1, (7,), dtype=np.int32),
        "i64": rng.integers(-2**62, 2**62, (2, 3), dtype=np.int64),
        "u32": rng.integers(0, 2**32 - 1, (5,), dtype=np.uint32),
        "u8": rng.integers(0, 255, (4, 4), dtype=np.uint8),
        "i8": rng.integers(-128, 127, (9,), dtype=np.int8),
        "b1": rng.random((3, 3)) > 0.5,
        "scalar": np.float32(2.5), "step": np.int32(7),
        "seq": [np.arange(3, dtype=np.int32), {"x": np.ones((2, 2), np.float32)}, [],
                [np.float64(1.0), None]],
        "empty_dict": {}, "none": None, "empty_tuple": (),
        "deep": {"a": {"b": {"c": f[0].astype(np.float32)}}},
    }


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Run directories the JAX package wrote: name -> (directory, name)."""
    base = tmp_path_factory.mktemp("orbax")
    out = {}
    d = str(base / "dtypes")
    j_save_checkpoint(d, _every_dtype_tree(), meta={"k": 1}, name="best")
    out["every_dtype"] = (d, "best")
    # arrays cut into many chunks (orbax's chunk_byte_size), some ragged
    tree = {"w": np.arange(100 * 37, dtype=np.float32).reshape(100, 37),
            "v": np.arange(1001, dtype=np.int64), "b": np.full((7, 3), 3, np.uint8)}
    d = str(base / "chunks" / "best")
    ck = ocp.StandardCheckpointer()
    ck.save(d, tree, save_args=jax.tree.map(lambda _: ocp.SaveArgs(chunk_byte_size=1024), tree))
    ck.wait_until_finished()
    out["many_chunks"] = (str(base / "chunks"), "best")
    # a JAX run's train state: params, optax's chained state (None, counts)
    from irtpu.models.retrieval_net import RetrievalNet
    from irtpu.training.trainer import create_train_state

    state, _ = create_train_state(RetrievalNet(arch="squeezenet1_1", pooling="gem"),
                                  jax.random.PRNGKey(0), input_shape=(64, 64, 3))
    d = str(base / "run")
    j_save_checkpoint(d, state, meta={"epoch": 0, "arch": "squeezenet1_1"}, name="latest")
    out["train_state"] = (d, "latest")
    # a full-width resnet50 RetrievalNet: params and batch statistics
    net = RetrievalNet(arch="resnet50", pooling="gem")
    v = jax.jit(net.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
    d = str(base / "r50")
    j_save_checkpoint(d, jax.tree.map(np.asarray, dict(v)), name="best")
    out["resnet50"] = (d, "best")
    out["fixture"] = (FIXTURE, "best")
    return out


@pytest.mark.parametrize("case", ["every_dtype", "many_chunks", "train_state", "resnet50",
                                  "fixture"])
def test_reader_matches_orbax_restore_bit_for_bit(ckpts, case, capsys):
    d, name = ckpts[case]
    want, want_meta = j_load_checkpoint(d, name=name)
    t0 = time.perf_counter()
    got, meta = load_checkpoint(d, name=name)
    read_s = time.perf_counter() - t0
    assert_same_tree(got, want)
    assert meta == want_meta
    # the checkpoint directory itself is taken too, as the JAX loader takes it
    again, _ = load_checkpoint(os.path.join(d, name), name="nothing-here")
    assert_same_tree(again, want)
    if case == "many_chunks":
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.join(d, name)}"})
        z = json.loads(kv.result().read(b"w/.zarray").result().value)
        assert z["chunks"] != z["shape"]  # really several chunks
    if case == "fixture":
        flat = flat_tree(got)
        ref = np.load(os.path.join(FIXTURE, "tree.npz"))
        assert sorted(flat) == sorted(ref.files)
        for k in ref.files:
            assert flat[k].dtype == ref[k].dtype and flat[k].tobytes() == ref[k].tobytes(), k
    if case == "resnet50":
        n = sum(os.path.getsize(os.path.join(r, f))
                for r, _, fs in os.walk(os.path.join(d, name)) for f in fs)
        with capsys.disabled():
            print(f"\n[orbax] resnet50 checkpoint, {n} bytes, read in {read_s:.3f} s "
                  f"({n / read_s / 1e6:.1f} MB/s, this host's CPU)")


# ------------------------------------------------------------------ OCDBT
@pytest.mark.parametrize("config,commits", [
    ({"max_decoded_node_bytes": 300, "max_inline_value_bytes": 20}, 1),
    ({"max_decoded_node_bytes": 400, "max_inline_value_bytes": 0, "compression": None}, 1),
    ({"version_tree_arity_log2": 1, "max_inline_value_bytes": 8}, 13),
], ids=["deep-tree", "uncompressed-indirect", "version-nodes"])
def test_ocdbt_walk_matches_tensorstore(tmp_path, config, commits):
    """Multi-level B+trees (node keys relative to their subtree's prefix),
    values inline and in data files, uncompressed nodes, and a manifest with
    version-tree nodes (many commits): every key and value as tensorstore
    reads them."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": config}).result()
    rng = np.random.default_rng(3)
    keys = [f"k{i:03d}/{'abc' * (i % 4)}" for i in range(90)]
    for c in range(commits):
        txn = ts.Transaction()
        for i, k in enumerate(keys):
            if i % commits == c:
                kv.with_transaction(txn)[k] = rng.bytes(int(rng.integers(0, 70)))
        txn.commit_async().result()
    store = orbax.OcdbtStore(str(tmp_path))
    want = {k: kv.read(k).result().value for k in kv.list().result()}
    assert {k: bytes(v) for k, v in store.values.items()} == want
    store.close()


# ------------------------------------------------------------------ zstd
def _zstd_payloads():
    rng = np.random.default_rng(4)
    return {
        "zeros": bytes(300_000),
        "repeats": b"localization" * 20_000 + bytes(range(256)) * 300,
        "random": rng.bytes(200_000),
        "weights": (rng.standard_normal(150_000) * 0.02).astype(np.float32).tobytes(),
    }


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("payload", ["zeros", "repeats", "random", "weights"])
def test_zstd_frames_of_tensorstore_zarr(tmp_path, level, payload):
    """A zarr chunk that tensorstore's zarr writer compresses (its frames:
    raw, RLE and compressed blocks, raw/RLE/Huffman literals, predefined,
    RLE, FSE and repeat tables) decodes to what tensorstore reads back."""
    data = np.frombuffer(_zstd_payloads()[payload], np.uint8)
    spec = {"driver": "zarr", "kvstore": f"file://{tmp_path}",
            "metadata": {"shape": [data.size], "chunks": [data.size], "dtype": "|u1",
                         "compressor": {"id": "zstd", "level": level}}}
    arr = ts.open(spec, create=True).result()
    arr.write(data).result()
    with open(tmp_path / "0", "rb") as f:
        frame = f.read()
    assert frame[:4] == b"\x28\xb5\x2f\xfd"
    want = ts.open({k: spec[k] for k in ("driver", "kvstore")}).result().read().result()
    np.testing.assert_array_equal(orbax.zstd_decompress(frame, data.size), want)
    np.testing.assert_array_equal(orbax.zstd_decompress(frame), want)  # size from the frame


@pytest.mark.parametrize("kind", ["checksum", "frames", "skippable", "streamed", "long-window"])
def test_zstd_frames_of_zstandard(kind):
    """Frame features tensorstore does not write: the XXH64 content checksum
    (checked), concatenated frames, a skippable frame, a streamed frame that
    declares no size, and matches reaching back across many blocks."""
    p = _zstd_payloads()
    data = p["repeats"] + p["weights"][:50_000]
    if kind == "checksum":
        frame = zstandard.ZstdCompressor(level=9, write_checksum=True).compress(data)
    elif kind == "frames":
        frame = (zstandard.ZstdCompressor(level=3).compress(data[:1000])
                 + zstandard.ZstdCompressor(level=19).compress(data[1000:]))
    elif kind == "skippable":
        frame = (b"\x5a\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"12345"
                 + zstandard.ZstdCompressor(level=1).compress(data))
    elif kind == "streamed":
        c = zstandard.ZstdCompressor(level=5, write_content_size=False).compressobj()
        frame = c.compress(data) + c.flush()
    else:
        block = np.random.default_rng(5).bytes(700_000)
        data = block + block
        params = zstandard.ZstdCompressionParameters.from_level(19, window_log=21)
        frame = zstandard.ZstdCompressor(compression_params=params).compress(data)
    assert orbax.zstd_decompress(frame).tobytes() == data
    assert orbax.zstd_decompress(frame, len(data)).tobytes() == data
    with pytest.raises(orbax.OrbaxFormatError):
        orbax.zstd_decompress(frame, len(data) - 1)  # never a short buffer


def test_crc32c_known_values():
    # the CRC32C check value (RFC 3720 B.4) and 32 zero bytes
    assert orbax.crc32c(b"123456789") == 0xE3069283
    assert orbax.crc32c(bytes(32)) == 0x8A9136AA


# ------------------------------------------------------------------ corruption
def _copy_fixture(tmp_path):
    d = str(tmp_path / "run")
    shutil.copytree(FIXTURE, d)
    return d


def test_flipped_byte_in_a_node_raises_a_crc_error(tmp_path):
    d = _copy_fixture(tmp_path)
    node = os.path.join(d, "best", "d", os.listdir(os.path.join(d, "best", "d"))[0])
    with open(node, "r+b") as f:
        f.seek(os.path.getsize(node) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(orbax.OrbaxFormatError, match="CRC32C"):
        load_checkpoint(d, name="best")


def test_flipped_byte_in_a_frame_raises():
    """Every single flipped byte of a frame that carries its checksum raises
    (the checksum, or the structure before it)."""
    data = _zstd_payloads()["weights"][:3000] + b"abcd" * 500
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    for i in range(len(frame)):
        bad = bytearray(frame)
        bad[i] ^= 0x41
        with pytest.raises(orbax.OrbaxFormatError):
            orbax.zstd_decompress(bytes(bad), len(data))


def test_flipped_byte_in_a_checkpoint_frame_raises(tmp_path):
    """A chunk's frame in a data file, its block header broken."""
    d = _copy_fixture(tmp_path)
    pdir = os.path.join(d, "best", "ocdbt.process_0", "d")
    big = max((os.path.join(pdir, f) for f in os.listdir(pdir)), key=os.path.getsize)
    with open(big, "rb") as f:
        raw = bytearray(f.read())
    i = raw.index(b"\x28\xb5\x2f\xfd")  # the first chunk's frame
    assert raw[i + 4] == 0  # no declared size: a window byte, then the first block
    raw[i + 6] |= 0x06  # that block header's type bits: the reserved block type
    with open(big, "wb") as f:
        f.write(raw)
    with pytest.raises(orbax.OrbaxFormatError):
        load_checkpoint(d, name="best")


# ------------------------------------------------------------------ layouts
def _checkpoint_files(path, tree_metadata=None):
    os.makedirs(path)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({}, f)
    tm = tree_metadata or {"('x',)": {"key_metadata": [{"key": "x", "key_type": 2}],
                                      "value_metadata": {"value_type": "np.ndarray",
                                                         "skip_deserialize": False}}}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tm, "use_ocdbt": True, "use_zarr3": False}, f)
    return {"driver": "ocdbt", "base": f"file://{path}"}


def test_missing_chunks_take_the_fill_value(tmp_path):
    """Ragged chunks (tensorstore's zarr writer on an OCDBT store), and
    chunks never written read as ``fill_value``."""
    path = str(tmp_path / "ck")
    arr = ts.open({"driver": "zarr", "kvstore": _checkpoint_files(path), "path": "x",
                   "metadata": {"shape": [10, 9], "chunks": [3, 4], "dtype": "<f4",
                                "fill_value": 1.5, "compressor": {"id": "zstd"}}},
                  create=True).result()
    arr[2:5, 0:9] = np.arange(27, dtype=np.float32).reshape(3, 9)
    got = orbax.read_orbax(path)["x"]
    np.testing.assert_array_equal(got, arr.read().result())
    assert got[0, 0] == 1.5 and got[3, 2] == 11.0


@pytest.mark.parametrize("what,match", [
    ("blosc", "compressor"), ("filters", "filters"), ("order-F", "order"),
    ("dtype", "dtype"), ("value-type", "value type"), ("zarr3", "zarr v3"),
    ("no-ocdbt", "without OCDBT"), ("not-orbax", "_CHECKPOINT_METADATA"),
    ("no-array", "no x/.zarray")])
def test_unknown_layouts_raise(tmp_path, what, match):
    """A layout the reader does not decode raises naming it; nothing is
    guessed. The OCDBT store holds ``x/.zarray`` and one raw chunk."""
    path = str(tmp_path / "ck")
    zarray = {"zarr_format": 2, "shape": [4], "chunks": [4], "dtype": "<f4", "order": "C",
              "compressor": None, "filters": None, "fill_value": None}
    if what == "blosc":
        zarray["compressor"] = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}
    elif what == "filters":
        zarray["filters"] = [{"id": "delta", "dtype": "<f4"}]
    elif what == "order-F":
        zarray["order"] = "F"
    elif what == "dtype":
        zarray["dtype"] = ">f4"
    tm = None
    if what == "value-type":
        tm = {"('x',)": {"key_metadata": [{"key": "x", "key_type": 2}],
                         "value_metadata": {"value_type": "scalar", "skip_deserialize": False}}}
    kv = ts.KvStore.open(_checkpoint_files(path, tm)).result()
    kv["x/.zarray" if what != "no-array" else "y/.zarray"] = json.dumps(zarray).encode()
    kv["x/0"] = np.ones(4, np.float32).tobytes()
    mfile = os.path.join(path, "_METADATA")
    if what in ("zarr3", "no-ocdbt"):
        with open(mfile) as f:
            m = json.load(f)
        m["use_zarr3" if what == "zarr3" else "use_ocdbt"] = what == "zarr3"
        with open(mfile, "w") as f:
            json.dump(m, f)
    if what == "not-orbax":
        os.remove(os.path.join(path, "_CHECKPOINT_METADATA"))
    with pytest.raises(orbax.OrbaxFormatError, match=match):
        orbax.read_orbax(path)


def test_raw_chunks_read(tmp_path):
    """The same store with no compressor reads its raw chunk."""
    path = str(tmp_path / "ck")
    kv = ts.KvStore.open(_checkpoint_files(path)).result()
    kv["x/.zarray"] = json.dumps({"zarr_format": 2, "shape": [4], "chunks": [4],
                                  "dtype": "<f4", "order": "C", "compressor": None,
                                  "filters": None, "fill_value": None}).encode()
    kv["x/0"] = np.arange(4, dtype=np.float32).tobytes()
    np.testing.assert_array_equal(orbax.read_orbax(path)["x"], np.arange(4, dtype=np.float32))


def test_a_failed_decoder_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "zstd_decode.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(orbax, "SOURCE", str(bad))
    monkeypatch.setattr(orbax, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(orbax, "_LIB", None)
    with pytest.raises(RuntimeError, match="failed"):
        orbax.zstd_decompress(b"\x28\xb5\x2f\xfd")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError):
        orbax.crc32c(b"x")


# ------------------------------------------------------------------ the CLI
@pytest.fixture(scope="module")
def small_ds(tmp_path_factory):
    """A PNG dataset below --image-size (no resize): both packages decode
    and feed the same pixels."""
    root = str(tmp_path_factory.mktemp("orbax_ds"))
    ds = make_synthetic_dataset(root, name="orbaxcli", n_scenes=2, views_per_scene=2,
                                n_distractors=2, image_hw=(48, 64), image_format="png")
    return root, ds


ARGS = ["--arch", "squeezenet1_1", "--image-size", "64", "--batch-size", "4"]


def test_cli_extract_from_a_jax_run_matches_the_jax_cli(small_ds, tmp_path):
    root, ds = small_ds
    out = {}
    for tag, run, extra in (("jax", jmain, []), ("port", main, ["--device", "cpu"])):
        d = str(tmp_path / f"{tag}.npy")
        assert (run(["extract", "--images", *ds.image_paths, *ARGS, "--checkpoint", FIXTURE,
                     "--out", d, *extra]) or 0) == 0
        out[tag] = np.load(d)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0, atol=2e-5)
    s_j, s_p = out["jax"] @ out["jax"].T, out["port"] @ out["port"].T
    np.testing.assert_array_equal(np.argsort(-s_p, 1, kind="stable"),
                                  np.argsort(-s_j, 1, kind="stable"))


def test_cli_evaluate_from_a_jax_run_matches_the_jax_cli(small_ds, tmp_path):
    root, _ = small_ds
    import image_retrieval_for_image_based_localization_tpu_torch.evaluation.harness as ph
    import irtpu.evaluation.harness as jh

    seen = {}
    for tag, run, mod, extra in (("jax", jmain, jh, []), ("port", main, ph, ["--device", "cpu"])):
        orig = mod.evaluate_dataset

        def spy(*a, _orig=orig, _tag=tag, **k):
            seen[_tag] = _orig(*a, **k)
            return seen[_tag]

        mod.evaluate_dataset = spy
        try:
            assert (run(["evaluate", "--dataset", "orbaxcli", "--data-root", root, *ARGS,
                         "--checkpoint", FIXTURE, "--metrics-out",
                         str(tmp_path / f"{tag}.jsonl"), *extra]) or 0) == 0
        finally:
            mod.evaluate_dataset = orig
    j, p = seen["jax"], seen["port"]
    for key in ("db", "queries"):
        np.testing.assert_allclose(np.asarray(p[key]), np.asarray(j[key]), rtol=0, atol=2e-5)
    sj = np.asarray(j["db"]) @ np.asarray(j["queries"]).T
    sp = np.asarray(p["db"]) @ np.asarray(p["queries"]).T
    np.testing.assert_array_equal(np.argsort(-sp, 0, kind="stable"),
                                  np.argsort(-sj, 0, kind="stable"))
    for proto in ("easy", "medium", "hard"):
        assert p["results"][proto]["map"] == pytest.approx(j["results"][proto]["map"], abs=1e-12)


def test_train_resume_of_a_jax_run_trains(ckpts, tmp_path):
    run, _ = ckpts["train_state"]
    out = tmp_path / "out"
    assert main(["train", "--resume", run, "--out-dir", str(out), "--synthetic",
                 "--arch", "squeezenet1_1", "--image-size", "64", "--epochs", "2",
                 "--synth-scenes", "4", "--synth-views", "3", "--qsize", "4", "--n-neg", "1",
                 "--batch-tuples", "2", "--data-root", str(tmp_path / "data"),
                 "--device", "cpu"]) == 0
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["start_epoch"] for r in recs if r.get("event") == "resumed"] == [1]
    assert [r["epoch"] for r in recs if "train_loss" in r] == [1]
    # the run's own checkpoint is now this package's, two steps past the JAX state's
    tree, meta = load_checkpoint(str(out), name="latest")
    assert meta["epoch"] == 1 and tree["step"] == 2 and tree["micro"] == 0


def test_train_resume_in_place_keeps_the_jax_checkpoint(ckpts, tmp_path):
    """``train --resume R --out-dir R`` of a JAX run: the port's ``latest``
    takes the name and the JAX Orbax checkpoint moves to ``latest.orbax``,
    which the JAX package restores leaf for leaf, meta included."""
    src, _ = ckpts["train_state"]
    run = str(tmp_path / "run")
    shutil.copytree(src, run)
    want, want_meta = j_load_checkpoint(src, name="latest")
    assert main(["train", "--resume", run, "--out-dir", run, "--synthetic",
                 "--arch", "squeezenet1_1", "--image-size", "64", "--epochs", "2",
                 "--synth-scenes", "4", "--synth-views", "3", "--qsize", "4", "--n-neg", "1",
                 "--batch-tuples", "2", "--data-root", str(tmp_path / "data"),
                 "--device", "cpu"]) == 0
    got, got_meta = j_load_checkpoint(run, name="latest.orbax")
    assert got_meta == want_meta
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path
    tree, meta = load_checkpoint(run)
    assert meta["epoch"] == 1 and tree["step"] == 2 and tree["micro"] == 0
    assert set(tree) >= {"model", "optimizer", "scheduler"}
