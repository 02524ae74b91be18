"""The serving process: the retrieval stack behind one HTTP port.

The JAX package's ``serving.py`` on PyTorch: a long-lived process that keeps
the model and the gallery on the card and answers queries at interactive
latency, on the standard library's ``http.server`` with a JSON or binary
protocol:

  GET  /healthz            -> {"ok": true, "gallery": N, "dim": D, ...}
  GET  /statz              -> per-endpoint rolling latency percentiles
                              (p50/p95/p99 over the last 2048 requests),
                              admission and micro-batching counters
  POST /query              -> top-k for descriptor queries
        body: {"descriptors": [[...], ...], "k": 10,
               "qe_nqe": 0, "qe_alpha": 3.0, "diffusion": false,
               "nprobe": 8, "exact": 0, "refine": 0}
              (nprobe/exact: IVF knobs; refine: PQ rescore depth)
        or raw float32 bytes with X-Shape: Nq,D and the query parameters in
        the URL (?k=10&qe=0&diffusion=0&nprobe=8&exact=0&refine=0)
        -> {"ids": [[...]], "scores": [[...]], "names": ..., "latency_ms": ...}
  POST /extract            -> descriptor of an image
        body: raw JPEG/PNG bytes -> {"descriptor": [...]}
  POST /extract_query      -> image bytes straight to top-k (one hop)
  POST /admin/reload       -> hot-swap the index/ivf/pq artifacts from the
                              paths the server was started with (clients
                              cannot point the server at other paths)

``k`` below 1 is a bad request (400) on ``/query`` and ``/extract_query``.

Device discipline: one lock serializes the card's work (one card, one
compute stream); HTTP threads overlap only host I/O and JSON encoding.
PyTorch's grad mode is thread-local, so each device section runs under
``torch.inference_mode()`` in the thread that runs it, handler or batcher.

Overload contract (``max_inflight`` / ``request_timeout_s``): at most
``max_inflight`` requests are inside the service at once (waiting and
executing); the rest are shed at once with **503 + Retry-After**, and a
request that waits longer than ``request_timeout_s`` for the device (the
lock or the batch queue) gets **504**. ``/statz`` reports both counters.
``/healthz`` and ``/admin/reload`` bypass admission, so operators can
observe and republish during overload.

Micro-batching (``serve(batch_window_ms=...)``): concurrent default-knob
plain queries coalesce into one search (:class:`MicroBatcher`), rows and k
padded to powers of two and each reply sliced to its own k. Each request's
rows are whitened alone, at the shape they have unbatched, so over exact
search a query's result is the one it gets alone, bit for bit: the search
kernels score each (query, row) pair in one fixed order whatever the batch,
and so do the plain versions' fixed CPU tiles. (IVF and PQ batches score
their probes and lookup tables per batch, so a score can differ in its
last bits from the lone query's.)

Client image bytes are decoded with PIL, written to a temporary lossless
PNG and read back through the Extractor's own path pipeline (the native
decode where it builds), so ``/extract`` gives the pixels a file path gives,
as in the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import IVFIndex
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import (
    IVFPQIndex,
    load_pq_artifact,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import (
    percentile_summary,
)


class ServiceOverloaded(RuntimeError):
    """Admission queue full: HTTP 503 (+ Retry-After), so load sheds at the
    edge instead of queueing without bound on the device lock."""


class ServiceTimeout(RuntimeError):
    """A request waited past its deadline for the device: HTTP 504.

    The deadline covers waiting (admission, the device lock, the batch
    queue). Once a request holds the lock, its work on the card is not
    cancelled (launched CUDA work cannot be), so one long search can still
    outlast the deadline; what this bounds is queue time, the part that
    grows without limit under overload."""


def _check_k(k: int) -> int:
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return k


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _same_device(a, b: torch.device) -> bool:
    a = torch.device(a)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class EndpointStats:
    """Rolling per-endpoint latency window. A deque append is atomic under
    the GIL, so recording takes no lock; summaries copy, then compute."""

    def __init__(self, window: int = 2048):
        self._lat = collections.defaultdict(lambda: collections.deque(maxlen=window))
        self._count = collections.Counter()

    def record(self, endpoint: str, seconds: float) -> None:
        self._lat[endpoint].append(seconds)
        self._count[endpoint] += 1

    def summary(self) -> dict:
        out = {}
        for ep, dq in list(self._lat.items()):
            # list() snapshots under the GIL; iterating the live deque would
            # race the appends of concurrent requests
            lat = np.asarray(list(dq), np.float64)
            if lat.size == 0:
                continue
            out[ep] = {"count": int(self._count[ep]), "window": int(lat.size),
                       **percentile_summary(lat, unit="ms")}
        return out


class MicroBatcher:
    """Coalesce concurrent plain top-k queries into one search.

    Requests enqueue their descriptor rows; the collector thread drains what
    has arrived (at most ``max_batch`` requests, waiting at most
    ``max_wait_ms`` after the first arrival so a burst can gather), makes
    one ``search_fn(parts, rows, k)`` call and hands each request its rows:
    ``parts`` are the requests' row blocks in order, ``rows`` their total
    padded to a power of two, ``k`` the largest k padded the same way, and
    each reply is sliced to its own k.

    Only plain queries batch; re-ranked and knob-overriding requests keep
    their own search.
    """

    def __init__(self, search_fn, max_batch: int = 64, max_wait_ms: float = 2.0):
        self._search_fn = search_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._lock = threading.Condition()
        self._pending = []  # [(q [n, D], k, event, result slot)]
        self._stop = False
        self.batches = 0       # searches run
        self.batched_reqs = 0  # requests they answered
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, q: np.ndarray, k: int, timeout: Optional[float] = None):
        ev = threading.Event()
        slot = {}
        entry = (q, k, ev, slot)
        with self._lock:
            self._pending.append(entry)
            self._lock.notify()
        if not ev.wait(timeout):
            # the deadline covers queue time only: still queued -> withdraw
            # it and time out; already drained into a search -> it is on
            # the card, so wait for its result
            with self._lock:
                # by identity: comparing entries would compare numpy rows
                withdrawn = False
                for i, e in enumerate(self._pending):
                    if e is entry:
                        del self._pending[i]
                        withdrawn = True
                        break
            if withdrawn:
                raise ServiceTimeout(f"query timed out after {timeout:.1f}s in the batch queue")
            ev.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["scores"], slot["idx"]

    def close(self):
        with self._lock:
            self._stop = True
            self._lock.notify()

    def _run(self):
        while True:
            with self._lock:
                while not self._pending and not self._stop:
                    self._lock.wait()
                if self._stop:
                    # fail any stragglers rather than hang their threads
                    for _, _, ev, slot in self._pending:
                        slot["error"] = RuntimeError("batcher closed")
                        ev.set()
                    return
                deadline = time.monotonic() + self.max_wait
                while len(self._pending) < self.max_batch and not self._stop:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._lock.wait(timeout=left)
                batch = self._pending[: self.max_batch]
                del self._pending[: self.max_batch]
            try:
                # rows and k in power-of-two buckets: a burst gives any
                # (rows, k) mix, and the buckets keep the shapes the card
                # sees (and their kernel plans) to a few
                rows = _pow2(sum(b[0].shape[0] for b in batch))
                scores, idx = self._search_fn([b[0] for b in batch], rows,
                                              _pow2(max(b[1] for b in batch)))
                self.batches += 1
                self.batched_reqs += len(batch)
                row = 0
                for q, k, ev, slot in batch:
                    n = q.shape[0]
                    slot["scores"] = scores[row : row + n, :k]
                    slot["idx"] = idx[row : row + n, :k]
                    row += n
                    ev.set()
            except Exception as e:  # noqa: BLE001 - each request gets the error
                for _, _, ev, slot in batch:
                    slot["error"] = e
                    ev.set()


class RetrievalService:
    """The servable: an :class:`Index`, optionally an ``Extractor`` for
    image queries, and optionally an IVF quantizer or a PQ index for
    approximate search.

    With ``ivf``, plain top-k queries probe ``nprobe`` partitions
    (``retrieval.ivf``); ``pq`` (a ``PQIndex`` or ``IVFPQIndex``, exclusive
    with ``ivf``) serves ADC search over the codes, with ``refine``
    candidates rescored exactly. Requests may set ``nprobe``/``refine`` or
    force exact search (``exact=1``); αQE and diffusion requests always
    search the whole gallery exactly.

    ``device`` is where the index and the extractor live ("cuda" by
    default, which raises without a card; "cpu" runs the plain versions).
    """

    def __init__(self, index, extractor=None, db_names=None, ivf=None, nprobe: int = 8,
                 pq=None, refine: int = 0, batch_window_ms: float = 0.0, max_batch: int = 64,
                 max_inflight: int = 64, request_timeout_s: float = 30.0,
                 device: DeviceLike = "cuda"):
        if ivf is not None and pq is not None:
            raise ValueError("ivf and pq are exclusive (an IVFPQIndex already embeds its "
                             "coarse quantizer)")
        self.device = resolve_device(device)
        for name, part in (("index", index), ("extractor", extractor), ("ivf", ivf), ("pq", pq)):
            if part is not None and not _same_device(part.device, self.device):
                raise ValueError(f"the {name} lives on {part.device}, the service on "
                                 f"{self.device}")
        self.index = index
        self.extractor = extractor
        self.db_names = db_names
        self.ivf = ivf
        self.nprobe = nprobe
        self.pq = pq
        self.refine = refine
        self._lock = threading.Lock()  # serializes the card's work
        # admission: at most max_inflight requests inside the service
        # (waiting + executing); the rest are shed with 503 (0 = unlimited)
        self.max_inflight = max_inflight
        self.request_timeout_s = request_timeout_s
        self._admit = threading.BoundedSemaphore(max_inflight) if max_inflight else None
        self.rejected = 0   # ServiceOverloaded count
        self.timed_out = 0  # ServiceTimeout count
        # the counters are incremented from many handler threads
        self._counter_lock = threading.Lock()
        self.stats = EndpointStats()
        self.batcher = None
        if batch_window_ms > 0:
            self.batcher = MicroBatcher(self._batch_search, max_batch=max_batch,
                                        max_wait_ms=batch_window_ms)

    def reload_from_paths(self, paths: dict) -> dict:
        """Hot-swap the servable from the artifact paths the server was
        started with. The new artifacts load and go onto the card outside
        the lock (both galleries are on the card until the old one's last
        request ends); the swap is atomic under it, so requests in flight
        finish on the old gallery and the next search sees the new one."""
        new_index = Index.load(paths["index"], device=self.device)
        new_ivf = new_pq = None
        if paths.get("ivf"):
            new_ivf = IVFIndex.load(paths["ivf"], device=self.device)
        if paths.get("pq"):
            new_pq = load_pq_artifact(paths["pq"], device=self.device)
        new_names = self.db_names
        if paths.get("db_names"):
            with open(paths["db_names"]) as f:
                new_names = [line.strip() for line in f if line.strip()]
        if new_names is not None and len(new_names) != new_index.gallery.shape[0]:
            # a stale name list would mislabel every row it does not cover
            raise ValueError(
                f"db_names has {len(new_names)} entries but the republished gallery has "
                f"{new_index.gallery.shape[0]} rows; republish the names file too")
        with torch.inference_mode():
            new_index.device_gallery()
            for part in (new_ivf, new_pq):
                if part is not None:
                    part._device()
        with self._lock:
            self.index = new_index
            self.ivf = new_ivf
            self.pq = new_pq
            self.db_names = new_names
        return {"gallery": int(new_index.gallery.shape[0]),
                "dim": int(new_index.gallery.shape[1]),
                "ivf": new_ivf is not None, "pq": new_pq is not None}

    @contextlib.contextmanager
    def _admitted(self):
        """An admission slot for one request (queued + executing)."""
        if self._admit is not None and not self._admit.acquire(blocking=False):
            with self._counter_lock:
                self.rejected += 1
            raise ServiceOverloaded(f"{self.max_inflight} requests already in flight")
        try:
            yield
        finally:
            if self._admit is not None:
                self._admit.release()

    @contextlib.contextmanager
    def _device(self, deadline: float):
        """The device lock with a wait deadline (see ServiceTimeout), and
        inference mode in this thread while it is held."""
        if not self._lock.acquire(timeout=max(deadline - time.monotonic(), 0)):
            with self._counter_lock:
                self.timed_out += 1
            raise ServiceTimeout(f"timed out after {self.request_timeout_s:.1f}s waiting "
                                 "for the device")
        try:
            with torch.inference_mode():
                yield
        finally:
            self._lock.release()

    def _refine_rows(self):
        """The f32 rows PQ refinement rescores: the card's copy of the
        gallery, unless that copy is int8-quantized."""
        if self.index.storage == "int8":
            return self.index.gallery
        return self.index.device_gallery()

    def _pq_search(self, qt: torch.Tensor, k: int, refine: int, nprobe: int):
        kw = dict(k=k, refine=refine, gallery=self._refine_rows() if refine else None)
        if isinstance(self.pq, IVFPQIndex):
            kw["nprobe"] = nprobe
        return self.pq.search(qt, **kw)

    def _batch_search(self, parts, rows: int, k: int):
        """The default-knob search of a micro-batch (what the batcher runs):
        each request's rows whitened alone, then one search of the padded
        batch, all under the lock with the index it holds."""
        with self._lock, torch.inference_mode():
            qt = torch.cat([self.index.transform_queries(q) for q in parts])
            if rows > qt.shape[0]:
                qt = torch.cat([qt, qt.new_zeros((rows - qt.shape[0], qt.shape[1]))])
            if self.pq is not None:
                return self._pq_search(qt, k, self.refine, self.nprobe)
            if self.ivf is not None:
                return self.ivf.search(qt, k=k, nprobe=self.nprobe)
            scores, idx = self.index.query_device(qt, k, pre_transformed=True)
            return scores.cpu().numpy(), idx.cpu().numpy()

    def query(self, q: np.ndarray, k: int = 10, qe_nqe: int = 0, qe_alpha: float = 3.0,
              diffusion: bool = False, nprobe: Optional[int] = None, exact: bool = False,
              refine: Optional[int] = None):
        """Top-k of descriptor queries: ``(scores, ids, names)``."""
        k = _check_k(k)
        q = np.atleast_2d(np.asarray(q, np.float32))
        approx_ok = not exact and not diffusion and not qe_nqe
        with self._admitted():
            return self._query_admitted(q, k, qe_nqe, qe_alpha, diffusion, nprobe, refine,
                                        approx_ok)

    def _query_admitted(self, q, k, qe_nqe, qe_alpha, diffusion, nprobe, refine, approx_ok):
        deadline = time.monotonic() + self.request_timeout_s
        if self.batcher is not None and approx_ok and nprobe is None and refine is None:
            try:
                scores, idx = self.batcher.submit(q, k, timeout=self.request_timeout_s)
            except ServiceTimeout:
                with self._counter_lock:
                    self.timed_out += 1
                raise
            return scores, idx, self._names(idx)
        with self._device(deadline):
            if self.pq is not None and approx_ok:
                scores, idx = self._pq_search(self.index.transform_queries(q), k,
                                              self.refine if refine is None else refine,
                                              nprobe or self.nprobe)
            elif self.ivf is not None and approx_ok:
                scores, idx = self.ivf.search(self.index.transform_queries(q), k=k,
                                              nprobe=nprobe or self.nprobe)
            elif diffusion:
                idx = self.index.diffusion_ranks(q, qe_nqe=qe_nqe, qe_alpha=qe_alpha)[:k].T
                scores = np.zeros(idx.shape, np.float32)
            else:
                scores, idx = self.index.query(q, k=k, qe_nqe=qe_nqe, qe_alpha=qe_alpha)
        return scores, idx, self._names(idx)

    def _names(self, idx):
        # fill slots of an under-filled approximate search carry row -1
        if self.db_names is None and self.index.ids is None:
            return None

        def name(i):
            i = int(i)
            if i < 0:
                return None
            if self.db_names is not None:
                return self.db_names[i]
            return str(self.index.ids[i])

        return [[name(i) for i in row] for row in idx]

    def _need_model(self, endpoint: str):
        if self.extractor is None:
            raise RuntimeError(f"no model loaded (start with a model to serve {endpoint})")

    @contextlib.contextmanager
    def _png_path(self, image_bytes: bytes):
        """Client bytes as a temporary lossless PNG, for the Extractor's path
        pipeline (it owns the resize policy and the native decode)."""
        from PIL import Image

        img = Image.open(io.BytesIO(image_bytes)).convert("RGB")
        fd, path = tempfile.mkstemp(suffix=".png")
        try:
            with os.fdopen(fd, "wb") as f:
                # stored, not deflated: the file is read back at once
                img.save(f, format="PNG", compress_level=0)
            yield path
        finally:
            os.unlink(path)

    def extract(self, image_bytes: bytes) -> np.ndarray:
        """The descriptor [D] of one image, as ``Extractor.extract`` gives it."""
        self._need_model("/extract")
        with self._png_path(image_bytes) as path, self._admitted(), self._device(
                time.monotonic() + self.request_timeout_s):
            d = self.extractor.extract([path])
        return d[0]

    def extract_query(self, image_bytes: bytes, k: int = 10):
        """One hop: image bytes -> ``(scores, ids, names)``.

        The host pipeline is ``/extract``'s (``make_input_batches``, here one
        image a batch), so the ranking is that of ``/extract`` then
        ``/query``; the descriptor stays on the card between the trunk and
        the search. k runs at the next power of two and is sliced back (a
        stable top-k's first k are the top k). An IVF or PQ service keeps its
        approximate routing through the two hops."""
        self._need_model("/extract_query")
        k = _check_k(k)
        if self.ivf is not None or self.pq is not None:
            return self.query(self.extract(image_bytes)[None], k=k)
        with self._png_path(image_bytes) as path:
            batch = next(iter(self.extractor.make_input_batches([path], batch_size=1)))
        with self._admitted(), self._device(time.monotonic() + self.request_timeout_s):
            d = self.extractor.forward_u8(torch.from_numpy(batch.pixels_u8).to(self.device),
                                          torch.from_numpy(batch.sizes).to(self.device))
            scores, idx = self.index.query_device(d, _pow2(k))
            scores, idx = scores[:, :k].cpu().numpy(), idx[:, :k].cpu().numpy()
        return scores, idx, self._names(idx)


def _flag(v) -> bool:
    return bool(int(v)) if isinstance(v, (str, int)) else bool(v)


def _make_handler(service: RetrievalService, reload_paths: Optional[dict] = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; metrics go to the JSON replies
            pass

        def _send(self, code: int, obj, extra_headers=None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            batcher = service.batcher
            if self.path.rstrip("/") == "/statz":
                self._send(200, {
                    "endpoints": service.stats.summary(),
                    "admission": {"max_inflight": service.max_inflight,
                                  "rejected": service.rejected,
                                  "timed_out": service.timed_out,
                                  "timeout_s": service.request_timeout_s},
                    "batching": None if batcher is None else {
                        "batches": batcher.batches, "batched_requests": batcher.batched_reqs},
                })
            elif self.path.rstrip("/") in ("", "/healthz"):
                ivf, pq = service.ivf, service.pq
                self._send(200, {
                    "ok": True,
                    "gallery": int(service.index.gallery.shape[0]),
                    "dim": int(service.index.gallery.shape[1]),
                    "model": service.extractor is not None,
                    "ivf": None if ivf is None else {
                        "clusters": int(ivf.centroids.shape[0]), "nprobe": service.nprobe,
                        "pad_ratio": round(ivf.pad_ratio, 3)},
                    "pq": None if pq is None else {
                        "m": int(pq.codebooks.shape[0]), "refine": service.refine,
                        "ivf": hasattr(pq, "centroids")},
                    "batching": None if batcher is None else {
                        "max_batch": batcher.max_batch, "window_ms": batcher.max_wait * 1e3,
                        "batches": batcher.batches, "batched_requests": batcher.batched_reqs},
                })
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def _body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length", 0)))

        def do_POST(self):
            t0 = time.perf_counter()
            try:
                path, _, qs = self.path.partition("?")
                params = dict(kv.split("=", 1) for kv in qs.split("&") if "=" in kv)
                if path == "/admin/reload":
                    if not reload_paths:
                        self._send(400, {"error": "server started without reloadable paths"})
                        return
                    self._send(200, {"reloaded": True,
                                     **service.reload_from_paths(reload_paths)})
                elif path == "/query":
                    raw = self._body()
                    shape = self.headers.get("X-Shape")
                    if shape:  # raw float32 payload
                        nq, d = (int(v) for v in shape.split(","))
                        q = np.frombuffer(raw, np.float32).reshape(nq, d).copy()
                        req = {}
                    else:
                        req = json.loads(raw)
                        q = np.asarray(req["descriptors"], np.float32)
                    np_raw = req.get("nprobe", params.get("nprobe"))
                    rf_raw = req.get("refine", params.get("refine"))
                    scores, idx, names = service.query(
                        q, k=int(req.get("k", params.get("k", 10))),
                        qe_nqe=int(req.get("qe_nqe", params.get("qe", 0))),
                        qe_alpha=float(req.get("qe_alpha", params.get("qe_alpha", 3.0))),
                        diffusion=_flag(req.get("diffusion", params.get("diffusion", 0))),
                        nprobe=None if np_raw is None else int(np_raw),
                        exact=_flag(req.get("exact", params.get("exact", 0))),
                        refine=None if rf_raw is None else int(rf_raw))
                    service.stats.record(path, time.perf_counter() - t0)
                    self._send(200, {
                        "ids": np.asarray(idx).tolist(),
                        "scores": np.asarray(scores, np.float64).tolist(),
                        "names": names,
                        "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
                    })
                elif path == "/extract":
                    d = service.extract(self._body())
                    service.stats.record(path, time.perf_counter() - t0)
                    self._send(200, {
                        "descriptor": d.astype(np.float64).tolist(),
                        "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
                    })
                elif path == "/extract_query":
                    scores, idx, names = service.extract_query(
                        self._body(), k=int(params.get("k", 10)))
                    service.stats.record(path, time.perf_counter() - t0)
                    self._send(200, {
                        "ids": idx[0].tolist(),
                        "scores": np.asarray(scores[0], np.float64).tolist(),
                        "names": None if names is None else names[0],
                        "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
                    })
                else:
                    self._send(404, {"error": f"unknown path {path}"})
            except ServiceOverloaded as e:
                # shed load at the edge: clients back off and retry
                self._send(503, {"error": str(e)}, extra_headers={"Retry-After": "1"})
            except ServiceTimeout as e:
                self._send(504, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - reply, keep serving
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(
    index,
    extractor=None,
    db_names=None,
    host: str = "127.0.0.1",
    port: int = 7878,
    block: bool = True,
    ivf=None,
    nprobe: int = 8,
    pq=None,
    refine: int = 0,
    batch_window_ms: float = 0.0,
    max_batch: int = 64,
    reload_paths: Optional[dict] = None,
    max_inflight: int = 64,
    request_timeout_s: float = 30.0,
    device: DeviceLike = "cuda",
) -> ThreadingHTTPServer:
    """Start the retrieval service and return its server; with
    ``block=False`` it serves from a daemon thread (tests, benches, embedders)
    until ``shutdown()``. ``server_close()`` also stops the batcher.

    ``reload_paths`` ({"index": path, "ivf": path or None, "pq": path or
    None, "db_names": path or None}) enables ``POST /admin/reload``."""
    service = RetrievalService(index, extractor=extractor, db_names=db_names, ivf=ivf,
                               nprobe=nprobe, pq=pq, refine=refine,
                               batch_window_ms=batch_window_ms, max_batch=max_batch,
                               max_inflight=max_inflight, request_timeout_s=request_timeout_s,
                               device=device)

    class _Server(ThreadingHTTPServer):
        # the standard library's listen backlog is 5; a concurrent burst
        # (the micro-batching case) would meet connection resets
        request_queue_size = 128
        daemon_threads = True

        def server_close(self):
            super().server_close()
            if service.batcher is not None:
                service.batcher.close()

    srv = _Server((host, port), _make_handler(service, reload_paths))
    srv.service = service
    if block:
        print(f"serving gallery[{index.gallery.shape[0]}] on {service.device} at "
              f"http://{host}:{srv.server_address[1]}", flush=True)
        try:
            srv.serve_forever()
        finally:
            srv.server_close()
    else:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
