"""The port's HTTP server against the JAX package's, on the CPU.

Both servers run in this process over indexes built from the same seeded
descriptors (and, for IVF and PQ, the same artifact, written by the JAX
package and loaded by the port), and answer the same requests: ids and
names equal, scores within 1e-5. Image endpoints run a resnet18 at 64 px
whose weights cross from the JAX package to the port. Then the port's own
contract: micro-batches bit-equal to lone queries, 503 / 504 under
overload, withdrawal from the batch queue, reload. One deliberate
difference (ROADMAP C11): ``k = 0`` is a 400 in the port, where the JAX
server answers an empty 200.
"""

import concurrent.futures
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
from PIL import Image

from irtpu.api import Extractor as JExtractor
from irtpu.retrieval.index import Index as JIndex
from irtpu.retrieval.ivf import IVFIndex as JIVFIndex
from irtpu.retrieval.pq import PQIndex as JPQIndex
from irtpu.serving import serve as jserve
from irtpu.utils import config as jcfg

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
    variables_to_state_dict,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.whitening import (
    pca_whiten_learn,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from image_retrieval_for_image_based_localization_tpu_torch.serving import (
    RetrievalService,
    ServiceTimeout,
    serve,
)

SCORE_TOL = 1e-5


def _unit(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _post(url, data, headers=None):
    """(status, reply, headers) of a POST; error statuses do not raise."""
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _get(url):
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read())


def _url(srv):
    return "http://%s:%d" % srv.server_address[:2]


@pytest.fixture
def servers():
    """Start servers, shut every one down at the end of the test."""
    started = []

    def start(fn, *a, **kw):
        srv = fn(*a, block=False, port=0, **kw)
        started.append(srv)
        return _url(srv)

    yield start
    for srv in started:
        srv.shutdown()
        srv.server_close()
        batcher = getattr(srv.service, "batcher", None)
        if batcher is not None:
            batcher.close()


@pytest.fixture(scope="module")
def plain_pair():
    """Both servers over the same 40 x 16 gallery with ids, no whitening."""
    db = _unit(np.random.RandomState(13), 40, 16)
    ids = [f"db/{i:03d}.jpg" for i in range(40)]
    js = jserve(JIndex.build(db, jcfg.IndexConfig(whitening=None), ids=ids),
                block=False, port=0)
    ps = serve(port.build_index(db, port.IndexConfig(whitening=None), ids=ids, device="cpu"),
               block=False, port=0, device="cpu")
    yield _url(js), _url(ps), db
    for srv in (js, ps):
        srv.shutdown()
        srv.server_close()


def _same_reply(a, b):
    assert a["ids"] == b["ids"]
    assert a["names"] == b["names"]
    np.testing.assert_allclose(np.asarray(a["scores"]), np.asarray(b["scores"]),
                               rtol=0, atol=SCORE_TOL)


def test_healthz_matches(plain_pair):
    jurl, purl, _ = plain_pair
    h = _get(f"{purl}/healthz")
    assert h == _get(f"{jurl}/healthz")
    assert h["ok"] and h["gallery"] == 40 and h["dim"] == 16 and h["model"] is False


@pytest.mark.parametrize("k", [1, 5, 40, 100])
@pytest.mark.parametrize("raw", [False, True], ids=["json", "raw"])
def test_query_matches_jax(plain_pair, k, raw):
    jurl, purl, db = plain_pair
    q = db[[3, 7, 11]] + 0.01
    if raw:
        args = (f"/query?k={k}", np.ascontiguousarray(q, np.float32).tobytes(),
                {"X-Shape": "3,16"})
    else:
        args = ("/query", json.dumps({"descriptors": q.tolist(), "k": k}).encode(), None)
    (cj, rj, _), (cp, rp, _) = (_post(u + args[0], *args[1:]) for u in (jurl, purl))
    assert cj == cp == 200
    _same_reply(rp, rj)
    assert len(rp["ids"][0]) == min(k, 40) and rp["ids"][0][0] == 3
    assert rp["names"][1][0] == "db/007.jpg"


@pytest.mark.parametrize("extra", [{"qe_nqe": 5}, {"qe_nqe": 3, "qe_alpha": 0.0},
                                   {"diffusion": True}, {"diffusion": 1, "qe_nqe": 2}],
                         ids=["qe", "average-qe", "diffusion", "diffusion-qe"])
def test_reranked_query_matches_jax(plain_pair, extra):
    jurl, purl, db = plain_pair
    body = json.dumps({"descriptors": db[[3, 9]].tolist(), "k": 6, **extra}).encode()
    (cj, rj, _), (cp, rp, _) = (_post(f"{u}/query", body) for u in (jurl, purl))
    assert cj == cp == 200
    _same_reply(rp, rj)
    assert rp["ids"][0][0] == 3


def test_k_zero_is_a_bad_request_in_the_port_only(plain_pair):
    """ROADMAP C11: the JAX server answers k=0 with an empty 200; the port
    refuses k < 1 with a 400 on /query (and on /extract_query, below)."""
    jurl, purl, db = plain_pair
    body = json.dumps({"descriptors": db[[3]].tolist(), "k": 0}).encode()
    cj, rj, _ = _post(f"{jurl}/query", body)
    assert cj == 200 and rj["ids"] == [[]]
    raw = np.ascontiguousarray(db[[3]]).tobytes()
    for args in ((f"{purl}/query", body), (f"{purl}/query?k=-2", raw, {"X-Shape": "1,16"})):
        cp, rp, _ = _post(*args)
        assert cp == 400 and "k must be >= 1" in rp["error"]


def test_bad_requests_are_400(plain_pair):
    _, purl, _ = plain_pair
    code, rep, _ = _post(f"{purl}/query", b"not json")
    assert code == 400 and "error" in rep
    code, rep, _ = _post(f"{purl}/extract", b"\xff\xd8bogus")
    assert code == 400 and "no model" in rep["error"]
    code, rep, _ = _post(f"{purl}/admin/reload", b"")
    assert code == 400 and "reloadable" in rep["error"]
    code, _, _ = _post(f"{purl}/nowhere", b"")
    assert code == 404


def test_statz_latency_percentiles(servers):
    db = _unit(np.random.RandomState(14), 30, 16)
    url = servers(serve, port.build_index(db, port.IndexConfig(whitening=None), device="cpu"),
                  device="cpu")
    body = json.dumps({"descriptors": db[[1]].tolist(), "k": 3}).encode()
    for _ in range(5):
        assert _post(f"{url}/query", body)[0] == 200
    st = _get(f"{url}/statz")
    q = st["endpoints"]["/query"]
    assert q["count"] == 5 and q["window"] == 5
    assert 0 <= q["p50_ms"] <= q["p95_ms"] <= q["p99_ms"]
    assert st["batching"] is None and st["admission"]["rejected"] == 0


def test_ivf_serving_matches_jax(servers, tmp_path):
    db = _unit(np.random.RandomState(21), 120, 16)
    jivf = JIVFIndex.build(db, n_clusters=6)
    jivf.save(str(tmp_path / "g.ivf.npz"))
    pivf = port.IVFIndex.load(str(tmp_path / "g.ivf.npz"), device="cpu")
    jurl = servers(jserve, JIndex.build(db, jcfg.IndexConfig(whitening=None)), ivf=jivf,
                   nprobe=3)
    purl = servers(serve, port.build_index(db, port.IndexConfig(whitening=None), device="cpu"),
                   ivf=pivf, nprobe=3, device="cpu")
    assert _get(f"{purl}/healthz") == _get(f"{jurl}/healthz")
    body = json.dumps({"descriptors": (db[[3, 9]] + 0.01).tolist(), "k": 5}).encode()
    for path in ("/query", "/query?nprobe=1", "/query?nprobe=6", "/query?exact=1"):
        (cj, rj, _), (cp, rp, _) = (_post(u + path, body) for u in (jurl, purl))
        assert cj == cp == 200, path
        _same_reply(rp, rj)
    qe = json.dumps({"descriptors": db[[3]].tolist(), "k": 5, "qe_nqe": 2}).encode()
    _same_reply(_post(f"{purl}/query", qe)[1], _post(f"{jurl}/query", qe)[1])


def test_pq_serving_matches_jax(servers, tmp_path):
    db = _unit(np.random.RandomState(33), 120, 16)
    jindex = JIndex.build(db, jcfg.IndexConfig(whitening=None))
    jpq = JPQIndex.build(jindex.gallery, m=4)
    jpq.save(str(tmp_path / "g.pq.npz"))
    ppq = port.load_pq_artifact(str(tmp_path / "g.pq.npz"), device="cpu")
    pindex = port.build_index(db, port.IndexConfig(whitening=None), device="cpu")
    jurl = servers(jserve, jindex, pq=jpq, refine=0)
    purl = servers(serve, pindex, pq=ppq, refine=0, device="cpu")
    assert _get(f"{purl}/healthz") == _get(f"{jurl}/healthz")
    body = json.dumps({"descriptors": (db[[3, 9]] + 0.01).tolist(), "k": 5}).encode()
    for path in ("/query", "/query?refine=20", "/query?refine=120", "/query?exact=1"):
        (cj, rj, _), (cp, rp, _) = (_post(u + path, body) for u in (jurl, purl))
        assert cj == cp == 200, path
        _same_reply(rp, rj)
    # full refinement is exact search
    assert _post(f"{purl}/query?refine=120", body)[1]["ids"] == \
        _post(f"{purl}/query?exact=1", body)[1]["ids"]
    # a refining service by default
    rurl = servers(serve, pindex, pq=ppq, refine=120, device="cpu")
    _same_reply(_post(f"{rurl}/query", body)[1], _post(f"{purl}/query?exact=1", body)[1])


def test_pq_and_ivf_are_exclusive():
    db = _unit(np.random.RandomState(3), 64, 16)
    index = port.build_index(db, port.IndexConfig(whitening=None), device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        RetrievalService(index, ivf=port.IVFIndex.build(db, n_clusters=4, device="cpu"),
                         pq=port.PQIndex.build(db, m=4, device="cpu"), device="cpu")


# -- image endpoints ---------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """resnet18 + GeM at 64 px in both packages: the JAX package's random
    weights, carried into the port by ``models.flax_port``."""
    cfg = dict(image_size=64, batch_size=2)
    jex = JExtractor(jcfg.ExtractConfig(model=jcfg.ModelConfig(arch="resnet18"), **cfg))
    sd = variables_to_state_dict(jax.tree.map(np.asarray, jex.variables), "resnet18")
    pex = port.Extractor(port.ExtractConfig(model=port.ModelConfig(arch="resnet18"), **cfg),
                         state_dict=sd, device="cpu")
    return pex, jex


def _png(a):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Eight images in two aspect ratios, on disk and as PNG bytes."""
    rng = np.random.RandomState(3)
    root = tmp_path_factory.mktemp("serve_imgs")
    arrays = [(rng.rand(*((48, 64) if i % 2 else (64, 40)), 3) * 255).astype(np.uint8)
              for i in range(8)]
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(root / f"im{i}.png"))
        Image.fromarray(a).save(paths[-1])
    return paths, [_png(a) for a in arrays]


@pytest.mark.parametrize("whitened", [False, True], ids=["plain", "pca"])
def test_extract_and_one_hop_match_jax(models, images, servers, whitened):
    pex, jex = models
    paths, blobs = images
    db = pex.extract(paths)
    np.testing.assert_allclose(db, jex.extract(paths), rtol=0, atol=2e-5)
    mP = pca_whiten_learn(db) if whitened else None  # one whitening for both packages
    wcfg = dict(whitening=None)
    pindex = Index.build(db, port.IndexConfig(**wcfg), whitening_mP=mP, device="cpu")
    jindex = JIndex.build(db, jcfg.IndexConfig(**wcfg), whitening_mP=mP)
    purl = servers(serve, pindex, extractor=pex, device="cpu")
    jurl = servers(jserve, jindex, extractor=jex)
    assert _get(f"{purl}/healthz")["model"] is True
    for i in (1, 2, 5):
        (cj, dj, _), (cp, dp, _) = (_post(f"{u}/extract", blobs[i]) for u in (jurl, purl))
        assert cj == cp == 200
        d = np.asarray(dp["descriptor"], np.float32)
        np.testing.assert_allclose(d, np.asarray(dj["descriptor"]), rtol=0, atol=2e-5)
        np.testing.assert_allclose(d, db[i], rtol=0, atol=2e-5)
        (cj, oj, _), (cp, op, _) = (_post(f"{u}/extract_query?k=3", blobs[i])
                                    for u in (jurl, purl))
        assert cj == cp == 200
        assert op["ids"] == oj["ids"] and op["ids"][0] == i
        np.testing.assert_allclose(op["scores"], oj["scores"], rtol=0, atol=1e-4)
        # one hop = /extract then /query
        _, tp, _ = _post(f"{purl}/query", json.dumps({"descriptors": [dp["descriptor"]],
                                                      "k": 3}).encode())
        assert op["ids"] == tp["ids"][0]
        np.testing.assert_allclose(op["scores"], tp["scores"][0], rtol=0, atol=SCORE_TOL)
    code, rep, _ = _post(f"{purl}/extract_query?k=0", blobs[0])
    assert code == 400 and "k must be >= 1" in rep["error"]


def test_one_hop_keeps_the_descriptor_on_the_device_and_buckets_k(models, images,
                                                                   monkeypatch):
    """The one hop hands Index.query_device a tensor (no host bounce) at k
    rounded up to a power of two, and slices back to k."""
    import torch

    pex, _ = models
    paths, blobs = images
    index = Index.build(pex.extract(paths), port.IndexConfig(whitening=None), device="cpu")
    svc = RetrievalService(index, extractor=pex, device="cpu")
    seen = []
    orig = index.query_device

    def spy(q, k, *a, **kw):
        seen.append((type(q), k, q.requires_grad, torch.is_inference_mode_enabled()))
        return orig(q, k, *a, **kw)

    monkeypatch.setattr(index, "query_device", spy)
    s, i, _ = svc.extract_query(blobs[4], k=3)
    assert seen == [(torch.Tensor, 4, False, True)]
    assert i.shape == s.shape == (1, 3) and i[0, 0] == 4
    monkeypatch.undo()
    s2, i2, _ = svc.query(svc.extract(blobs[4])[None], k=3)
    np.testing.assert_array_equal(i, i2)


def test_one_hop_keeps_ivf_routing(models, images):
    pex, _ = models
    paths, blobs = images
    db = pex.extract(paths)
    ivf = port.IVFIndex.build(db, n_clusters=2, device="cpu")
    svc = RetrievalService(Index.build(db, port.IndexConfig(whitening=None), device="cpu"),
                           extractor=pex, ivf=ivf, nprobe=1, device="cpu")
    called = []
    orig = ivf.search
    ivf.search = lambda *a, **kw: called.append(1) or orig(*a, **kw)
    _, i, _ = svc.extract_query(blobs[0], k=2)
    assert called and i.shape == (1, 2)


# -- the port's serving contract ---------------------------------------------

@pytest.mark.parametrize("whitening", [None, "pca"], ids=["plain", "pca"])
@pytest.mark.parametrize("n,ks", [(200, (3, 4, 5, 6)), (300, (100, 150, 7, 129))],
                         ids=["fused-topk", "across-128"])
def test_micro_batches_equal_lone_queries_bit_for_bit(n, ks, whitening):
    """Each request is whitened at its own shape, and the search scores
    each (query, row) pair alike in any batch."""
    db = _unit(np.random.RandomState(8), n, 32)
    index = port.build_index(db, port.IndexConfig(whitening=whitening), device="cpu")
    svc = RetrievalService(index, batch_window_ms=20.0, max_batch=64, device="cpu")
    alone = RetrievalService(index, device="cpu")
    reqs = [(db[[i, i + 1]] + 0.01, ks[(i // 2) % len(ks)]) for i in range(0, 32, 2)]
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=16) as exe:
            got = [f.result() for f in [exe.submit(svc.query, q, k) for q, k in reqs]]
    finally:
        svc.batcher.close()
    for (q, k), (s, i, _) in zip(reqs, got):
        se, ie, _ = alone.query(q, k=k)
        assert i.shape == (2, k)
        np.testing.assert_array_equal(i, ie)
        np.testing.assert_array_equal(s, se)
    assert svc.batcher.batched_reqs == len(reqs)
    assert svc.batcher.batches < len(reqs)


def test_knob_overrides_bypass_the_batcher():
    db = _unit(np.random.RandomState(9), 64, 16)
    svc = RetrievalService(port.build_index(db, port.IndexConfig(whitening=None),
                                            device="cpu"), batch_window_ms=5.0, device="cpu")
    try:
        svc.query(db[[3]], k=5, qe_nqe=2)
        _, i2, _ = svc.query(db[[3]], k=5, exact=True)
        assert svc.batcher.batches == 0
        _, i3, _ = svc.query(db[[3]], k=5)
        assert svc.batcher.batches == 1
        np.testing.assert_array_equal(i2, i3)
    finally:
        svc.batcher.close()


def test_micro_batching_over_http(servers):
    db = _unit(np.random.RandomState(10), 100, 16)
    url = servers(serve, port.build_index(db, port.IndexConfig(whitening=None), device="cpu"),
                  batch_window_ms=25.0, device="cpu")

    def one(i):
        body = json.dumps({"descriptors": (db[[i]] + 0.01).tolist(), "k": 4}).encode()
        return i, _post(f"{url}/query", body)

    with concurrent.futures.ThreadPoolExecutor(max_workers=12) as exe:
        res = list(exe.map(one, range(12)))
    for i, (code, r, _) in res:
        assert code == 200 and r["ids"][0][0] == i
    h = _get(f"{url}/healthz")["batching"]
    assert h["batched_requests"] == 12 and h["batches"] <= 12


class _SlowIndex:
    """An index whose search blocks, standing in for a long search."""

    def __init__(self, index, delay_s):
        self._index = index
        self.delay = delay_s
        self.gallery, self.ids, self.device = index.gallery, index.ids, index.device
        self.entered = threading.Event()  # set when a search has begun

    def transform_queries(self, q):
        return self._index.transform_queries(q)

    def query(self, q, **kw):
        self.entered.set()
        time.sleep(self.delay)
        return self._index.query(q, **kw)

    def query_device(self, q, k, **kw):
        self.entered.set()
        time.sleep(self.delay)
        return self._index.query_device(q, k, **kw)


def _slow(seed, n, delay):
    db = _unit(np.random.RandomState(seed), n, 16)
    return db, _SlowIndex(port.build_index(db, port.IndexConfig(whitening=None),
                                           device="cpu"), delay)


def test_overload_sheds_with_503(servers):
    db, index = _slow(70, 40, 0.3)
    url = servers(serve, index, max_inflight=2, device="cpu")
    body = json.dumps({"descriptors": db[[3]].tolist(), "k": 5}).encode()
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as exe:
        got = list(exe.map(lambda _: _post(f"{url}/query", body), range(8)))
    codes = [c for c, _, _ in got]
    assert 200 in codes and 503 in codes, codes
    shed = next(g for g in got if g[0] == 503)
    assert shed[2]["Retry-After"] == "1" and "in flight" in shed[1]["error"]
    assert _post(f"{url}/query", body)[1]["ids"][0][0] == 3
    adm = _get(f"{url}/statz")["admission"]
    assert adm["rejected"] == codes.count(503) and adm["max_inflight"] == 2
    assert _get(f"{url}/healthz")["ok"]


def test_wait_past_the_timeout_is_504(servers):
    db, index = _slow(71, 30, 0.5)
    url = servers(serve, index, request_timeout_s=0.05, device="cpu")
    body = json.dumps({"descriptors": db[[1]].tolist(), "k": 3}).encode()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as exe:
        holder = exe.submit(_post, f"{url}/query", body)
        assert index.entered.wait(10)  # the holder is inside its 0.5 s search
        code, rep, _ = _post(f"{url}/query", body)
        assert code == 504 and "waiting" in rep["error"]
        assert holder.result()[1]["ids"][0][0] == 1
    assert _get(f"{url}/statz")["admission"]["timed_out"] == 1


def test_batch_queue_timeout_withdraws_the_request():
    db, index = _slow(72, 30, 0.6)
    svc = RetrievalService(index, batch_window_ms=2.0, request_timeout_s=10.0, device="cpu")
    try:
        first = threading.Thread(target=svc.query, args=(db[[1]],), daemon=True)
        first.start()  # searched alone; holds the collector for 0.6 s
        assert index.entered.wait(10)
        second = threading.Thread(target=svc.query, args=(db[[2]],), daemon=True)
        second.start()  # queued ahead of ours, at the default k = 10
        time.sleep(0.05)
        with pytest.raises(ServiceTimeout):
            svc.batcher.submit(db[[3]], 3, timeout=0.05)
        with svc.batcher._lock:  # ours withdrawn by identity, theirs kept
            assert [e[1] for e in svc.batcher._pending] in ([], [10])
        first.join(5)
        second.join(5)
        assert not first.is_alive() and not second.is_alive()
    finally:
        svc.batcher.close()


def test_batch_queue_timeout_through_query_is_counted():
    db, index = _slow(74, 30, 0.6)
    svc = RetrievalService(index, batch_window_ms=2.0, request_timeout_s=0.05, device="cpu")
    try:
        holder = threading.Thread(target=svc.batcher.submit, args=(db[[1]], 3),
                                  daemon=True)
        holder.start()  # holds the collector for 0.6 s
        assert index.entered.wait(10)
        with pytest.raises(ServiceTimeout):
            svc.query(db[[4]], k=3)
        assert svc.timed_out == 1
        holder.join(5)
        assert not holder.is_alive()
    finally:
        svc.batcher.close()


def test_admin_reload_swaps_and_refuses_stale_names(servers, tmp_path):
    rng = np.random.RandomState(60)
    ipath, npath = str(tmp_path / "live.npz"), str(tmp_path / "names.txt")
    g1 = _unit(rng, 30, 16)
    Index.build(g1, port.IndexConfig(whitening=None), device="cpu").save(ipath)
    with open(npath, "w") as f:
        f.write("\n".join(f"a{i}" for i in range(30)) + "\n")
    url = servers(serve, Index.load(ipath, device="cpu"), db_names=[f"a{i}" for i in range(30)],
                  reload_paths={"index": ipath, "db_names": npath}, device="cpu")
    body = json.dumps({"descriptors": g1[[7]].tolist(), "k": 3}).encode()
    assert _post(f"{url}/query", body)[1]["names"][0][0] == "a7"
    # a bigger gallery with the old names file: refused, old servable intact
    g2 = _unit(rng, 50, 16)
    JIndex.build(g2, jcfg.IndexConfig(whitening=None)).save(ipath)  # the JAX package's artifact
    code, rep, _ = _post(f"{url}/admin/reload", b"")
    assert code == 400 and "db_names" in rep["error"]
    assert _get(f"{url}/healthz")["gallery"] == 30
    with open(npath, "w") as f:
        f.write("\n".join(f"b{i}" for i in range(50)) + "\n")
    code, rep, _ = _post(f"{url}/admin/reload", b"")
    assert code == 200 and rep == {"reloaded": True, "gallery": 50, "dim": 16, "ivf": False,
                                   "pq": False}
    res = _post(f"{url}/query", json.dumps({"descriptors": g2[[41]].tolist(), "k": 3}).encode())
    assert res[1]["ids"][0][0] == 41 and res[1]["names"][0][0] == "b41"


def test_reload_under_load(servers, tmp_path):
    """Queries racing reloads (30 <-> 50 rows) through the batcher all
    succeed with rows of some published gallery."""
    rng = np.random.RandomState(73)
    small, big = _unit(rng, 30, 16), _unit(rng, 50, 16)
    ipath = str(tmp_path / "live.npz")
    Index.build(small, port.IndexConfig(whitening=None), device="cpu").save(ipath)
    url = servers(serve, Index.load(ipath, device="cpu"), batch_window_ms=2.0,
                  reload_paths={"index": ipath}, device="cpu")
    stop = threading.Event()
    errors = []

    def hammer(seed):
        body = json.dumps({"descriptors": _unit(np.random.RandomState(seed), 1, 16).tolist(),
                           "k": 5}).encode()
        n = 0
        while not stop.is_set() or n == 0:
            code, res, _ = _post(f"{url}/query", body)
            if code != 200 or len(res["ids"][0]) != 5 or not all(
                    0 <= i < 50 for i in res["ids"][0]):
                errors.append((code, res))
                return n
            n += 1
        return n

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as exe:
        futs = [exe.submit(hammer, s) for s in range(4)]
        for i in range(6):
            Index.build(big if i % 2 == 0 else small, port.IndexConfig(whitening=None),
                        device="cpu").save(ipath)
            assert _post(f"{url}/admin/reload", b"")[0] == 200
            time.sleep(0.05)
        stop.set()
        done = sum(f.result(timeout=60) for f in futs)
    assert not errors, errors[:3]
    assert done >= 4 and _get(f"{url}/healthz")["gallery"] == 30


def test_service_refuses_parts_on_another_device(models):
    import torch

    pex, _ = models
    index = Index.build(np.eye(4, dtype=np.float32), port.IndexConfig(whitening=None),
                        device="cpu")
    index.device = torch.device("meta")
    with pytest.raises(ValueError, match="the index lives on meta"):
        RetrievalService(index, extractor=pex, device="cpu")
