"""Port parity: the download engine (``data/download.py``) and
``models.zoo.load_pretrained`` against the JAX package's.

The engine is tested as ``tests/test_download.py`` tests the JAX one,
against a local HTTP server and local archives (no test reaches a network):
install, ``Range`` resume, checksum pins, fail-fast on an unreachable host
and under ``IRTPU_OFFLINE``, path-traversal refusal, shared archives,
flattening and retry after a short read. The manifest tables must equal the
JAX package's, and a cirtorch-layout ``.pth`` served from the local zoo loads
through both packages' ``load_pretrained`` to the same descriptors and the
same Lw whitening.
"""

import hashlib
import http.server
import io
import os
import pickle
import tarfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import irtpu.data.download as jdl
from irtpu.models.zoo import load_pretrained as jax_load_pretrained
from test_download import _make_corpus, _make_fake_network, _manifest, _RangeHandler

import image_retrieval_for_image_based_localization_tpu_torch.data.download as dl
from image_retrieval_for_image_based_localization_tpu_torch.data.download import (
    Artifact,
    DatasetManifest,
    DownloadError,
    _install,
    download_network,
    download_test,
    download_train,
    extract_archive,
    fetch,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.zoo import load_pretrained
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


@pytest.fixture()
def http_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("srv")
    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), lambda *a, **kw: _RangeHandler(*a, directory=str(root), **kw))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield root, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _port_manifest(base_url):
    """``test_download._manifest`` with the port's dataclasses."""
    return {name: DatasetManifest(m.name, tuple(Artifact(**vars(a)) for a in m.artifacts),
                                  tuple(m.required))
            for name, m in _manifest(base_url).items()}


@pytest.mark.parametrize("table", ["TEST_MANIFESTS", "TRAIN_MANIFESTS", "ZOO_MANIFESTS",
                                   "TEST_DATASET_FILES", "TRAIN_DATASET_FILES"])
def test_manifest_tables_equal_the_jax_package(table):
    """Name for name, URL for URL, sha256 for sha256 (every field)."""
    ours, theirs = getattr(dl, table), getattr(jdl, table)
    assert list(ours) == list(theirs)

    def fields(v):
        if isinstance(v, list):
            return v
        if isinstance(v, (dl.Artifact, jdl.Artifact)):
            return vars(v)
        return (v.name, [vars(a) for a in v.artifacts], tuple(v.required))

    for name in ours:
        assert fields(ours[name]) == fields(theirs[name]), name


def test_offline_reads_the_jax_package_variable(monkeypatch):
    for value, want in (("1", True), ("0", False), ("", False), ("yes", True)):
        monkeypatch.setenv("IRTPU_OFFLINE", value)
        assert dl.offline() is jdl.offline() is want


def test_download_test_fetches_and_installs(http_root, tmp_path, monkeypatch):
    root, url = http_root
    _make_corpus(root)
    monkeypatch.delenv("IRTPU_OFFLINE", raising=False)
    download_test(str(tmp_path), "minik", manifests=_port_manifest(url))
    assert os.path.exists(tmp_path / "minik" / "gnd_minik.pkl")
    assert sorted(os.listdir(tmp_path / "minik" / "jpg")) == [f"img_{i}.jpg" for i in range(4)]
    download_test(str(tmp_path), "minik", manifests=_port_manifest(url))  # verify only

    from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
        configdataset,
    )

    ds = configdataset("minik", str(tmp_path))
    assert ds.n == 3 and ds.nq == 1 and ds.image_paths[0].endswith("img_0.jpg")


def test_fetch_resumes_with_range(http_root, tmp_path):
    root, url = http_root
    payload = bytes(np.random.RandomState(1).bytes(300_000))
    (root / "blob.bin").write_bytes(payload)
    dest = str(tmp_path / "blob.bin")
    with open(dest + ".part", "wb") as f:  # a killed transfer's first half
        f.write(payload[:137_000])
    fetch(f"{url}/blob.bin", dest, progress=False)
    assert open(dest, "rb").read() == payload
    assert not os.path.exists(dest + ".part")


def test_fetch_checksum_mismatch_raises(http_root, tmp_path):
    root, url = http_root
    (root / "x.bin").write_bytes(b"hello world")
    with pytest.raises(DownloadError, match="sha256 mismatch"):
        fetch(f"{url}/x.bin", str(tmp_path / "x.bin"),
              sha256=hashlib.sha256(b"different").hexdigest(), retries=1, progress=False)
    assert not os.path.exists(tmp_path / "x.bin")
    assert not os.path.exists(str(tmp_path / "x.bin") + ".part")
    fetch(f"{url}/x.bin", str(tmp_path / "x.bin"),
          sha256=hashlib.sha256(b"hello world").hexdigest(), progress=False)
    assert (tmp_path / "x.bin").read_bytes() == b"hello world"


def test_fetch_unreachable_raises_fast(tmp_path):
    with pytest.raises(DownloadError, match="failed to fetch"):
        fetch("http://127.0.0.1:9/nope", str(tmp_path / "n"), retries=2, timeout=2,
              progress=False)


@pytest.mark.parametrize("member", ["../escape.txt", "a/../../escape.txt"])
def test_extract_rejects_path_traversal(tmp_path, member):
    evil = tmp_path / "evil.tar"
    with tarfile.open(evil, "w") as tf:
        info = tarfile.TarInfo(member)
        info.size = 4
        tf.addfile(info, io.BytesIO(b"boom"))
    with pytest.raises(DownloadError, match="escapes"):
        extract_archive(str(evil), str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "escape.txt")


def test_offline_flag_fails_fast_with_instructions(tmp_path, monkeypatch):
    monkeypatch.setenv("IRTPU_OFFLINE", "1")
    with pytest.raises(FileNotFoundError, match="IRTPU_OFFLINE"):
        download_test(str(tmp_path), "roxford5k")
    with pytest.raises(FileNotFoundError, match="retrieval-SfM-120k.pkl"):
        download_train(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="networks/"):
        download_network(str(tmp_path), "retrievalSfM120k-resnet101-gem")
    with pytest.raises(FileNotFoundError, match="networks/"):
        load_pretrained("retrievalSfM120k-resnet101-gem", data_root=str(tmp_path), device="cpu")


def test_download_failure_lists_required_paths(tmp_path, monkeypatch):
    monkeypatch.delenv("IRTPU_OFFLINE", raising=False)
    mani = {"minik": DatasetManifest(
        "minik", artifacts=(Artifact("http://127.0.0.1:9/x.tgz", "minik/jpg", extract=True),),
        required=("minik/jpg",))}
    with pytest.raises(FileNotFoundError, match="minik/jpg"):
        download_test(str(tmp_path), "minik", manifests=mani)


def test_download_network_local_zoo(http_root, tmp_path, monkeypatch):
    root, url = http_root
    monkeypatch.delenv("IRTPU_OFFLINE", raising=False)
    (root / "net.pth").write_bytes(b"FAKE_CKPT")
    zoo = {"mini-net": Artifact(f"{url}/net.pth", "networks/mini-net.pth")}
    assert open(download_network(str(tmp_path), "mini-net", manifests=zoo), "rb").read() == \
        b"FAKE_CKPT"
    with pytest.raises(KeyError, match="mini-net"):
        download_network(str(tmp_path), "nope", manifests=zoo)


def _tarball(root, name, files, arcname="jpg"):
    stage = root / ("stage_" + name)
    os.makedirs(stage / arcname, exist_ok=True)
    for f in files:
        (stage / arcname / f).write_bytes(b"jpg" + f.encode())
    with tarfile.open(root / name, "w:gz") as tf:
        tf.add(stage / arcname, arcname=arcname)


def test_merge_extract_two_archives(http_root, tmp_path, monkeypatch):
    """paris_1 + paris_2: two archives extracting into one directory."""
    root, url = http_root
    monkeypatch.delenv("IRTPU_OFFLINE", raising=False)
    _tarball(root, "p1.tgz", ["a.jpg", "b.jpg"], "paris")
    _tarball(root, "p2.tgz", ["c.jpg"], "paris")
    mani = {"mparis": DatasetManifest("mparis", artifacts=(
        Artifact(f"{url}/p1.tgz", "mparis/jpg", extract=True, members_strip=1),
        Artifact(f"{url}/p2.tgz", "mparis/jpg", extract=True, members_strip=1),
    ), required=("mparis/jpg",))}
    download_test(str(tmp_path), "mparis", manifests=mani)
    assert sorted(os.listdir(tmp_path / "mparis" / "jpg")) == ["a.jpg", "b.jpg", "c.jpg"]


def test_shared_archive_installs_into_both_datasets(http_root, tmp_path, monkeypatch):
    """paris6k and rparis6k share their tarballs: one dataset's install
    markers must not make the other skip its second archive."""
    root, url = http_root
    monkeypatch.delenv("IRTPU_OFFLINE", raising=False)
    _tarball(root, "part1.tgz", ["a.jpg", "b.jpg"])
    _tarball(root, "part2.tgz", ["c.jpg", "d.jpg"])
    (root / "gnd.pkl").write_bytes(pickle.dumps({"imlist": [], "qimlist": [], "gnd": []}))

    def manifest(ds):
        return DatasetManifest(ds, artifacts=(
            Artifact(f"{url}/part1.tgz", f"{ds}/jpg", extract=True, members_strip=1),
            Artifact(f"{url}/part2.tgz", f"{ds}/jpg", extract=True, members_strip=1),
            Artifact(f"{url}/gnd.pkl", f"{ds}/gnd_{ds}.pkl"),
        ), required=(f"{ds}/gnd_{ds}.pkl", f"{ds}/jpg"))

    table = {"dsa": manifest("dsa"), "dsb": manifest("dsb")}
    for ds in table:
        download_test(str(tmp_path), ds, manifests=table)
    for ds in table:
        assert sorted(os.listdir(tmp_path / ds / "jpg")) == ["a.jpg", "b.jpg", "c.jpg", "d.jpg"]


def test_extract_flatten_drops_directories(tmp_path):
    stage = tmp_path / "pstage"
    for landmark, name in (("defense", "paris_defense_000001.jpg"),
                           ("louvre", "paris_louvre_000002.jpg")):
        os.makedirs(stage / "paris" / landmark)
        (stage / "paris" / landmark / name).write_bytes(b"x")
    arc = tmp_path / "paris_mini.tgz"
    with tarfile.open(arc, "w:gz") as tf:
        tf.add(stage / "paris", arcname="paris")
    extract_archive(str(arc), str(tmp_path / "jpg"), flatten=True)
    assert sorted(os.listdir(tmp_path / "jpg")) == ["paris_defense_000001.jpg",
                                                     "paris_louvre_000002.jpg"]


def test_fetch_retries_incomplete_read(tmp_path):
    """A server that closes mid-body: the short read is retried and resumed."""
    payload = os.urandom(200_000)
    calls = {"n": 0}

    class Truncating(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            calls["n"] += 1
            rng = self.headers.get("Range")
            start = int(rng.split("=")[1].rstrip("-").split("-")[0]) if rng else 0
            body = payload[start:]
            if calls["n"] == 1:
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body[: len(body) // 2])
                self.wfile.flush()
                self.connection.close()
                return
            self.send_response(206 if rng else 200)
            if rng:
                self.send_header("Content-Range",
                                 f"bytes {start}-{len(payload) - 1}/{len(payload)}")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Truncating)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        dest = tmp_path / "file.bin"
        fetch(f"http://127.0.0.1:{srv.server_address[1]}/file.bin", str(dest), progress=False)
        assert dest.read_bytes() == payload and calls["n"] >= 2
    finally:
        srv.shutdown()


def test_install_verifies_existing_pinned_file(tmp_path):
    body = b"genuine gnd"
    man = DatasetManifest("minik", artifacts=(
        Artifact("http://127.0.0.1:9/gnd_minik.pkl", "minik/gnd_minik.pkl",
                 sha256=hashlib.sha256(body).hexdigest()),), required=("minik/gnd_minik.pkl",))
    dest = tmp_path / "minik" / "gnd_minik.pkl"
    dest.parent.mkdir(parents=True)
    dest.write_bytes(b"tampered")
    with pytest.raises(DownloadError, match="sha256"):
        _install(man, str(tmp_path))
    dest.write_bytes(body)
    _install(man, str(tmp_path))  # the genuine file passes without a fetch


# (arch, pooling, Lw nesting) of the fake cirtorch checkpoints
LAYOUTS = [("resnet18", "gem", "flat"), ("resnet18", "netvlad", "ss_ms"),
           ("vgg16", "gem", "ss_ms")]


@pytest.mark.parametrize("arch,pooling,lw_nesting", LAYOUTS)
def test_load_pretrained_matches_jax(http_root, tmp_path, monkeypatch, arch, pooling,
                                     lw_nesting):
    """One cirtorch-layout .pth from the local zoo through both packages:
    the same model, descriptors within 2e-5, the same Lw (m, P)."""
    root, url = http_root
    monkeypatch.delenv("IRTPU_OFFLINE", raising=False)
    _make_fake_network(root, arch=arch, pooling=pooling, lw_nesting=lw_nesting)
    zoo = {"fake-net": Artifact(f"{url}/fake-net.pth", "networks/fake-net.pth")}
    jzoo = {"fake-net": jdl.Artifact(f"{url}/fake-net.pth", "networks/fake-net.pth")}
    for scale in ("ss", "ms"):
        model, mP = load_pretrained("fake-net", data_root=str(tmp_path / "port"),
                                    whitening_scale=scale, zoo_manifests=zoo, device="cpu")
        jmodel, variables, jmP = jax_load_pretrained(
            "fake-net", data_root=str(tmp_path / "jax"), whitening_scale=scale,
            zoo_manifests=jzoo)
        np.testing.assert_array_equal(mP[0], jmP[0])
        np.testing.assert_array_equal(mP[1], jmP[1])
    assert (model.arch, model.pooling, model.netvlad_clusters, model.whiten_dim) == \
        (jmodel.arch, jmodel.pooling, jmodel.netvlad_clusters, jmodel.whiten_dim)
    assert not model.training and next(model.parameters()).device.type == "cpu"
    x = np.random.RandomState(1).rand(2, 64, 96, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
    assert got.shape == want.shape == (2, model.out_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
