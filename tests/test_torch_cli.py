"""The port's command line against the JAX package's, on the CPU.

Both CLIs run on one synthetic dataset with the same resnet18 weights (a
torch ``state_dict`` file, which both load through ``--checkpoint``):
``extract`` -> ``build-index`` -> ``query``, ``evaluate`` and ``shortlist``
give the same descriptors, indices, mAP and pairs. ``--network`` loads a
cirtorch-layout checkpoint from a zoo served on localhost and matches
``--checkpoint`` on the same weights (and the JAX CLI's ``--network``).
The benches, ``fullsystem`` and ``parity`` run at toy sizes, ``download``
verifies or fetches, ``serve`` runs as a subprocess, and ``train
--resume`` of a JAX run directory (an Orbax checkpoint), which the port does
not resume yet, returns 2 with its ROADMAP label.
"""

import ast
import http.server
import json
import os
import socket
import threading
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import irtpu.data.download as jdl
import irtpu.data.native as jnative
from irtpu.cli import main as jmain

import image_retrieval_for_image_based_localization_tpu_torch.api as port_api
import image_retrieval_for_image_based_localization_tpu_torch.data.download as dl
import image_retrieval_for_image_based_localization_tpu_torch.evaluation.harness as harness
import image_retrieval_for_image_based_localization_tpu_torch.serving as serving
from image_retrieval_for_image_based_localization_tpu_torch.cli import main
from image_retrieval_for_image_based_localization_tpu_torch.data import native as pnative
from image_retrieval_for_image_based_localization_tpu_torch.models import (
    RetrievalNet,
    init_random_,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
    _CIRTORCH_SEQ_NAMES,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = ["--arch", "resnet18", "--image-size", "64", "--batch-size", "2"]


@pytest.fixture(scope="module", autouse=True)
def same_decoder():
    """Both CLIs decode the path inputs with one host pipeline: the native
    library where both packages load theirs, else PIL in both.

    Each package builds its native decoder at first use. The JAX package's
    ``make`` writes ``native/libirtpu_preproc.so`` in place, so a worker
    that loads it while another worker's linker is still writing it gets
    an OSError, keeps to PIL for the rest of its life, and the two CLIs
    extract from different pixels: 3.98e-5 apart on this dataset, 20 of
    5,120 elements past the 2e-5 bound. On one decoder they are 1.9e-7
    apart, whatever the thread counts or the load."""
    with pytest.MonkeyPatch.context() as mp:
        if not (jnative.native_available() and pnative.native_available()):
            mp.setattr(jnative, "native_available", lambda: False)
            mp.setattr(port_api, "native_available", lambda: False)
        yield


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The JAX CLI test's dataset, and one resnet18's weights as a .pth."""
    root = str(tmp_path_factory.mktemp("cli_ds"))
    assert main(["synth", "--root", root, "--name", "clitest", "--scenes", "2", "--views", "2",
                 "--distractors", "2"]) == 0
    net = RetrievalNet("resnet18", "gem")
    init_random_(net, torch.Generator().manual_seed(0))
    pth = os.path.join(root, "r18.pth")
    torch.save(net.state_dict(), pth)
    jpg = os.path.join(root, "clitest", "jpg")
    return root, pth, [os.path.join(jpg, f) for f in sorted(os.listdir(jpg))]


def _both(tmp_path, argv_of):
    """Run ``argv_of(tag)`` through both CLIs (the port's with --device cpu)."""
    assert jmain(argv_of("jax")) in (0, None)
    assert main(argv_of("port") + ["--device", "cpu"]) == 0


def test_usage_error():
    assert main([]) == 2
    assert main(["not-a-command"]) == 2
    with pytest.raises(SystemExit):
        main(["query", "--device", "cpu"])  # missing required arguments


def test_extract_build_query_match_jax(synth, tmp_path):
    root, pth, imgs = synth
    out = {}
    for tag, run, extra in (("jax", jmain, []), ("port", main, ["--device", "cpu"])):
        d, i, r = (str(tmp_path / f"{tag}.{ext}") for ext in ("npy", "npz", "r.npz"))
        assert (run(["extract", "--images", *imgs, *MODEL, "--checkpoint", pth, "--out", d,
                     *extra]) or 0) == 0
        assert (run(["build-index", "--descriptors", d, "--out", i, "--whitening", "pca",
                     *extra]) or 0) == 0
        assert (run(["query", "--index", i, "--queries", d, "-k", "4", "--out", r,
                     *extra]) or 0) == 0
        out[tag] = np.load(d), np.load(r)
    (dj, rj), (dp, rp) = out["jax"], out["port"]
    assert dp.shape == (len(imgs), 512)
    np.testing.assert_allclose(dp, dj, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(rp["indices"], rj["indices"])
    np.testing.assert_array_equal(rp["indices"][:, 0], np.arange(len(imgs)))
    # the port reads the JAX CLI's index and the JAX CLI the port's
    cross = str(tmp_path / "cross.npz")
    assert main(["query", "--index", str(tmp_path / "jax.npz"), "--queries",
                 str(tmp_path / "port.npy"), "-k", "4", "--out", cross, "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.load(cross)["indices"], rj["indices"])


def _map_record(path):
    with open(path) as f:
        return next(r for r in map(json.loads, f) if r.get("event") == "map")


@pytest.mark.parametrize("whitening", ["none", "pca"])
def test_evaluate_map_matches_jax(synth, tmp_path, whitening, capsys):
    root, pth, _ = synth

    def argv(tag):
        return ["evaluate", "--dataset", "clitest", "--data-root", root, *MODEL,
                "--checkpoint", pth, "--whitening", whitening,
                "--metrics-out", str(tmp_path / f"{tag}.jsonl")]

    _both(tmp_path, argv)
    mj, mp = _map_record(tmp_path / "jax.jsonl"), _map_record(tmp_path / "port.jsonl")
    for proto in ("easy", "medium", "hard"):
        assert mp[f"map_{proto}"] == pytest.approx(mj[f"map_{proto}"], abs=1e-9), proto
    assert "mAP" in capsys.readouterr().out


def test_shortlist_pairs_match_jax(synth, tmp_path):
    root, pth, imgs = synth
    db_imgs, q_imgs = imgs[:4], imgs[4:6]
    names = str(tmp_path / "names.txt")
    with open(names, "w") as f:
        f.write("\n".join(os.path.basename(p) for p in db_imgs) + "\n")
    descs, index = str(tmp_path / "db.npy"), str(tmp_path / "i.npz")
    assert main(["extract", "--images", *db_imgs, *MODEL, "--checkpoint", pth, "--out", descs,
                 "--device", "cpu"]) == 0
    assert main(["build-index", "--descriptors", descs, "--out", index, "--whitening", "none",
                 "--device", "cpu"]) == 0

    def argv(tag):
        return ["shortlist", "--index", index, "--images", *q_imgs, *MODEL, "--checkpoint", pth,
                "-k", "3", "--db-names", names, "--out", str(tmp_path / f"{tag}.txt")]

    _both(tmp_path, argv)
    with open(tmp_path / "port.txt") as f:
        pairs = [line.split() for line in f if line.strip()]
    with open(tmp_path / "jax.txt") as f:
        assert pairs == [line.split() for line in f if line.strip()]
    assert len(pairs) == 2 * 3
    assert [p[0] for p in pairs[:3]] == [os.path.basename(q_imgs[0])] * 3


def test_pq_ivf_build_and_query_match_jax(tmp_path):
    """build-index --pq / --ivf --pq and query --ivf / --pq: on the JAX
    CLI's artifacts the port answers as the JAX CLI does (k-means may part
    the rows otherwise in each package, so the two compare on one set of
    artifacts), and on the port's own, full refinement is exact search."""
    rng = np.random.RandomState(7)
    g = rng.randn(96, 32).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    descs, qpath = str(tmp_path / "d.npy"), str(tmp_path / "q.npy")
    np.save(descs, g)
    np.save(qpath, g[:5] + 0.05 * rng.randn(5, 32).astype(np.float32))
    cpu = ["--device", "cpu"]

    def build(tag, run, extra):
        index = str(tmp_path / f"{tag}.npz")
        for flags in (["--ivf", "4", "--pq", "8"], ["--pq", "8"]):
            assert (run(["build-index", "--descriptors", descs, "--out", index,
                         "--whitening", "none", *flags, *extra]) or 0) == 0

    def query(tag, run, extra, artifacts):
        index = str(tmp_path / f"{artifacts}.npz")
        out = {}
        for name, flags in (
                ("exact", []),
                ("ivfpq", ["--pq", f"{tmp_path}/{artifacts}.ivfpq.npz", "--nprobe", "4",
                           "--refine", "96"]),
                ("ivf", ["--ivf", f"{tmp_path}/{artifacts}.ivf.npz", "--nprobe", "2"]),
                ("pq", ["--pq", f"{tmp_path}/{artifacts}.pq.npz", "--refine", "96"]),
                ("adc", ["--pq", f"{tmp_path}/{artifacts}.pq.npz"])):
            path = str(tmp_path / f"{tag}_{artifacts}_{name}.npz")
            assert (run(["query", "--index", index, "--queries", qpath, "-k", "3", *flags,
                         "--out", path, *extra]) or 0) == 0
            out[name] = np.load(path)
        return out

    build("jax", jmain, [])
    build("port", main, cpu)
    ref = query("jax", jmain, [], "jax")
    on_jax = query("port", main, cpu, "jax")
    own = query("port", main, cpu, "port")
    for name in ref:
        np.testing.assert_array_equal(on_jax[name]["indices"], ref[name]["indices"],
                                      err_msg=name)
        np.testing.assert_allclose(on_jax[name]["scores"], ref[name]["scores"], rtol=0,
                                   atol=1e-5, err_msg=name)
    for name in ("ivfpq", "pq"):
        np.testing.assert_array_equal(own[name]["indices"], own["exact"]["indices"])
        np.testing.assert_allclose(own[name]["scores"], own["exact"]["scores"], rtol=0,
                                   atol=1e-5)
    # usage errors on the query side: --qe with approximate search, --pq with --ivf
    for flags in (["--qe", "5", "--ivf", str(tmp_path / "port.ivf.npz")],
                  ["--pq", str(tmp_path / "port.pq.npz"), "--ivf", "x.npz"]):
        with pytest.raises(SystemExit):
            main(["query", "--index", str(tmp_path / "port.npz"), "--queries", qpath, *flags,
                  *cpu])


def test_bench_serve_small(capsys):
    assert main(["bench-serve", "-n", "500", "-d", "32", "--concurrency", "4", "--requests",
                 "24", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "unbatched" in out and "batched" in out and "qps ratio" in out


def test_bench_ann_small(capsys):
    assert main(["bench-ann", "-n", "1500", "-d", "32", "--nq", "24", "--clusters", "8", "-m",
                 "4", "--reps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "exact" in out and "ivf_nprobe8" in out and "opq_adc" in out
    rows = {line.split()[0]: float(line.split()[1]) for line in out.splitlines()[1:]}
    assert rows["exact"] == rows["approx_r95"] == 1.0
    assert rows["ivf_nprobe8"] == 1.0  # the full probe
    assert rows["pq_refine100"] >= rows["pq_adc"]


def test_bench_train_tiny(capsys):
    assert main(["bench-train", "--arch", "resnet18", "--image-size", "64", "--batch-tuples",
                 "2", "--n-neg", "2", "--reps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "tuples/s=" in out and "resnet18+gem" in out


def test_train_refuses_network(tmp_path, capsys):
    """The JAX trainer takes --network and ignores it; the port refuses it."""
    assert main(["train", "--network", "fake-net", "--out-dir", str(tmp_path), "--synthetic",
                 "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "--network" in err and "ROADMAP" not in err


@pytest.fixture(scope="module")
def fake_zoo(tmp_path_factory):
    """A zoo on a localhost HTTP server holding one cirtorch-layout
    checkpoint, ``fake-net``: a resnet18 + GeM's weights with cirtorch's
    numeric trunk keys, its meta and a flat Lw, listed in both packages'
    ZOO_MANIFESTS. Yields the same weights in this package's layout as a
    plain ``.pth`` for ``--checkpoint``, and the Lw (m, P)."""
    root = tmp_path_factory.mktemp("zoo")
    net = RetrievalNet("resnet18", "gem")
    init_random_(net, torch.Generator().manual_seed(4))
    names = _CIRTORCH_SEQ_NAMES["resnet"]
    sd = {}
    for k, v in net.state_dict().items():
        parts = k.split(".")
        if parts[0] == "features":
            parts[1] = str(names.index(parts[1]))
        sd[".".join(parts)] = v
    rng = np.random.RandomState(6)
    m, P = rng.randn(512).astype(np.float32), rng.randn(512, 512).astype(np.float32)
    torch.save({"state_dict": sd, "meta": {"architecture": "resnet18", "pooling": "gem",
                                           "whitening": False, "outputdim": 512,
                                           "Lw": {"retrieval-SfM-120k": {"m": m, "P": P}}}},
               root / "fake-net.pth")
    pth = str(root / "plain.pth")
    torch.save(net.state_dict(), pth)
    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0),
        lambda *a, **kw: http.server.SimpleHTTPRequestHandler(*a, directory=str(root), **kw))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/fake-net.pth"
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("IRTPU_OFFLINE", raising=False)
        mp.setattr(dl, "ZOO_MANIFESTS", {"fake-net": dl.Artifact(url, "networks/fake-net.pth")})
        mp.setattr(jdl, "ZOO_MANIFESTS",
                   {"fake-net": jdl.Artifact(url, "networks/fake-net.pth")})
        yield pth, m, P
    srv.shutdown()


@pytest.mark.parametrize("case", ["present", "missing", "unknown", "network"])
def test_download_command(case, tmp_path, monkeypatch, capsys, request):
    """``download`` verifies a dataset in place offline, lists what to place
    where one is missing, refuses an unknown name, and fetches a zoo network."""
    argv = ["download", "--data-root", str(tmp_path)]
    if case == "network":
        pth, _, _ = request.getfixturevalue("fake_zoo")
        assert main(argv + ["fake-net"]) == 0
        with open(tmp_path / "networks" / "fake-net.pth", "rb") as a, \
                open(os.path.join(os.path.dirname(pth), "fake-net.pth"), "rb") as b:
            assert a.read() == b.read()
        return
    monkeypatch.setenv("IRTPU_OFFLINE", "1")
    os.makedirs(tmp_path / "roxford5k" / "jpg")
    (tmp_path / "roxford5k" / "gnd_roxford5k.pkl").write_bytes(b"x")
    if case == "present":
        assert main(argv + ["roxford5k"]) == 0
        assert "roxford5k: present" in capsys.readouterr().out
    elif case == "missing":
        with pytest.raises(FileNotFoundError, match="IRTPU_OFFLINE.*\n.*rparis6k"):
            main(argv + ["rparis6k"])
    else:
        with pytest.raises(SystemExit, match="unknown artifact"):
            main(argv + ["not-a-thing"])


@pytest.mark.parametrize("command", ["fullsystem", "parity"])
def test_tool_commands_run_at_toy_size(command, synth, tmp_path, capsys):
    root, pth, _ = synth
    if command == "fullsystem":
        argv = ["fullsystem", "--n-images", "4", "--image-size", "64", "--arch", "resnet18",
                "--batch-size", "2", "--root", str(tmp_path)]
    else:
        argv = ["parity", "--arch", "resnet18", "--image-size", "64", "--batch-size", "4",
                "--synth-root", str(tmp_path), "--checkpoint", pth]
    assert main(argv + ["--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    if command == "fullsystem":
        res = json.loads(last)
        assert res["n_images"] == 4 and res["e2e_img_per_sec"] > 0
        assert res["device_img_per_sec"] > 0 and res["overlap_efficiency"] > 0
    else:
        res = ast.literal_eval(last)
        assert set(res) == {"bucketed", "exact", "map_delta", "stress_cos_mean",
                            "stress_cos_min"}
        assert res["map_delta"] == pytest.approx(res["bucketed"] - res["exact"])


@pytest.mark.parametrize("command", ["extract", "shortlist", "serve"])
def test_network_flag_matches_checkpoint(command, synth, fake_zoo, tmp_path, monkeypatch):
    """``--network fake-net`` (fetched from the local zoo into --data-root,
    the model rebuilt from the checkpoint's meta: --arch resnet50 is
    overridden) gives what ``--checkpoint`` gives on the same weights."""
    _, imgs = synth[0], synth[2]
    pth = fake_zoo[0]
    model = ["--image-size", "64", "--batch-size", "2", "--device", "cpu"]
    by_network = ["--network", "fake-net", "--arch", "resnet50",
                  "--data-root", str(tmp_path / "cache")]
    by_checkpoint = ["--checkpoint", pth, "--arch", "resnet18"]
    if command == "extract":
        out = {}
        for tag, flags in (("net", by_network), ("ckpt", by_checkpoint)):
            out[tag] = str(tmp_path / f"{tag}.npy")
            assert main(["extract", "--images", *imgs, "--out", out[tag], *model, *flags]) == 0
        got = np.load(out["net"])
        assert got.shape == (len(imgs), 512)
        np.testing.assert_array_equal(got, np.load(out["ckpt"]))
        assert os.path.exists(tmp_path / "cache" / "networks" / "fake-net.pth")
        jout = str(tmp_path / "jax.npy")
        assert (jmain(["extract", "--images", *imgs, "--out", jout, *model[:4], *by_network[:2],
                       "--data-root", str(tmp_path / "jcache")]) or 0) == 0
        np.testing.assert_allclose(got, np.load(jout), rtol=0, atol=2e-5)
    elif command == "shortlist":
        descs, index = str(tmp_path / "db.npy"), str(tmp_path / "i.npz")
        assert main(["extract", "--images", *imgs[:4], "--out", descs, *model,
                     *by_checkpoint]) == 0
        assert main(["build-index", "--descriptors", descs, "--out", index, "--whitening",
                     "none", "--device", "cpu"]) == 0
        pairs = {}
        for tag, flags in (("net", by_network), ("ckpt", by_checkpoint)):
            out = str(tmp_path / f"{tag}.txt")
            assert main(["shortlist", "--index", index, "--images", *imgs[4:6], "-k", "3",
                         "--out", out, *model, *flags]) == 0
            with open(out) as f:
                pairs[tag] = f.read()
        assert pairs["net"] == pairs["ckpt"] and len(pairs["net"].splitlines()) == 6
    else:
        g = np.random.RandomState(5).randn(8, 512).astype(np.float32)
        np.save(tmp_path / "g.npy", g / np.linalg.norm(g, axis=1, keepdims=True))
        index = str(tmp_path / "g.npz")
        assert main(["build-index", "--descriptors", str(tmp_path / "g.npy"), "--out", index,
                     "--whitening", "none", "--device", "cpu"]) == 0
        served = []
        monkeypatch.setattr(serving, "serve", lambda index, extractor=None, **kw:
                            served.append(extractor))
        for flags in (by_network, by_checkpoint):
            assert main(["serve", "--index", index, *model, *flags]) == 0
        assert served[0].model.arch == "resnet18"
        np.testing.assert_array_equal(served[0].extract(imgs[:2]), served[1].extract(imgs[:2]))


def test_evaluate_network_applies_the_checkpoint_lw_as_jax_does(synth, fake_zoo, tmp_path,
                                                                 monkeypatch):
    """``evaluate --network``: the checkpoint's Lw reaches ``Index.build`` as
    the pre-learned whitening, and the mAP is the JAX CLI's."""
    root = synth[0]
    _, m, P = fake_zoo
    seen = {}
    build = harness.Index.build

    def spy(descriptors, *a, **kw):
        seen["mP"] = kw.get("whitening_mP")
        return build(descriptors, *a, **kw)

    monkeypatch.setattr(harness.Index, "build", staticmethod(spy))

    def argv(tag):
        return ["evaluate", "--network", "fake-net", "--dataset", "clitest", "--data-root",
                root, "--image-size", "64", "--batch-size", "2",
                "--metrics-out", str(tmp_path / f"{tag}.jsonl")]

    _both(tmp_path, argv)
    np.testing.assert_array_equal(seen["mP"][0], m)
    np.testing.assert_array_equal(seen["mP"][1], P)
    mj, mp = _map_record(tmp_path / "jax.jsonl"), _map_record(tmp_path / "port.jsonl")
    for proto in ("easy", "medium", "hard"):
        assert mp[f"map_{proto}"] == pytest.approx(mj[f"map_{proto}"], abs=1e-9), proto


def test_port_checkpoint_directory_loads(synth, tmp_path):
    """--checkpoint takes this package's own checkpoint directory (its best)."""
    from image_retrieval_for_image_based_localization_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )

    root, pth, imgs = synth
    sd = torch.load(pth, weights_only=True)
    save_checkpoint(str(tmp_path / "run"), {"model": sd}, is_best=True)
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    for ckpt, out in ((pth, a), (str(tmp_path / "run"), b)):
        assert main(["extract", "--images", *imgs[:2], *MODEL, "--checkpoint", ckpt, "--out",
                     out, "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.load(a), np.load(b))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_subprocess_answers_a_query(tmp_path):
    """``cli serve`` as a process: it loads the index, answers /healthz and
    /query, and stops on SIGTERM."""
    rng = np.random.RandomState(5)
    g = rng.randn(50, 16).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    np.save(tmp_path / "g.npy", g)
    index = str(tmp_path / "g.npz")
    assert main(["build-index", "--descriptors", str(tmp_path / "g.npy"), "--out", index,
                 "--whitening", "none", "--device", "cpu"]) == 0
    port_no = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "image_retrieval_for_image_based_localization_tpu_torch.cli",
         "serve", "--index", index, "--no-model", "--port", str(port_no), "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        url = f"http://127.0.0.1:{port_no}"
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(f"{url}/healthz", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.monotonic() < deadline, "the server did not come up"
                time.sleep(0.2)
        assert health["gallery"] == 50 and health["model"] is False
        body = json.dumps({"descriptors": g[[17]].tolist(), "k": 3}).encode()
        with urllib.request.urlopen(urllib.request.Request(f"{url}/query", data=body),
                                    timeout=30) as r:
            assert json.loads(r.read())["ids"][0][0] == 17
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert b"serving gallery[50] on cpu" in proc.stdout.read()
