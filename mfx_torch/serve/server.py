"""Minimal production-style serving endpoint — stdlib HTTP around the
recommenders (no framework dependencies). A copy of
``mfx/serve/server.py``, which imports nothing of JAX, so that the port
needs nothing from the reference's ``mfx.serve`` package (whose
``__init__`` imports JAX).

    POST /recommend       {"users": [3, 17], "k": 10}
    POST /similar         {"items": [1, 7], "k": 10}
    POST /recommend_cold  {"histories": [[[12, 4.5], [7, 3.0]]], "k": 10}
    POST /reload          {}   (hot-swap to the newest model, no restart)
    GET  /healthz
    GET  /metrics         (Prometheus text exposition)

Responses are JSON: ``items``/``scores`` per user (plus ``raw_items``
when the loader relabeled the catalog), or ``similar``/``cosine`` per
query item. Concurrent /recommend requests are MICRO-BATCHED: requests
arriving within ``batch_window_ms`` (or queued while the device is
busy) merge into one device dispatch — the scoring program is batched
over users anyway, so QPS scales with device batch capacity instead of
per-dispatch latency; a request that poisons a merged dispatch (id
range, fused pool exhaustion) is isolated by solo retry so the others
still answer. One process serves one card; load-balance above. Start
from the CLI:

    python -m mfx_torch.cli serve --checkpoint ckpt/ --port 8080 \
        --dataset ml-25m --fused --device cuda
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["RecServer"]


class _Stats:
    """Serving observability counters behind GET /metrics. Latency
    quantiles come from a bounded reservoir of the most recent requests
    (exact over the window — no sketch error); sums/counts are
    lifetime. The batcher counters measure micro-batching efficiency:
    requests-per-dispatch is the QPS multiplier the window bought."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._counts: dict[tuple[str, int], int] = {}
        self._lat: dict[str, collections.deque] = {}
        self._lat_sum: dict[str, float] = {}
        self._lat_count: dict[str, int] = {}
        self._window = window
        self.dispatches = 0
        self.dispatch_requests = 0
        self.dispatch_users = 0
        self.solo_retries = 0

    # fixed label set: client-controlled paths must not grow the metric
    # cardinality unboundedly (scanner bots) nor inject characters into
    # the exposition format (a quote in a label value breaks every
    # subsequent scrape)
    _PATHS = frozenset({
        "/recommend", "/similar", "/recommend_cold", "/reload",
        "/healthz", "/metrics",
    })

    def record(self, path: str, code: int, dt: float) -> None:
        if path not in self._PATHS:
            path = "other"
        with self._lock:
            self._counts[(path, code)] = self._counts.get((path, code), 0) + 1
            d = self._lat.get(path)
            if d is None:
                d = self._lat[path] = collections.deque(maxlen=self._window)
            d.append(dt)
            self._lat_sum[path] = self._lat_sum.get(path, 0.0) + dt
            self._lat_count[path] = self._lat_count.get(path, 0) + 1

    def record_dispatch(self, n_requests: int, n_users: int,
                        solo_retry: bool = False) -> None:
        with self._lock:
            self.dispatches += 1
            self.dispatch_requests += n_requests
            self.dispatch_users += n_users
            if solo_retry:
                self.solo_retries += 1

    def render(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        with self._lock:
            lines = [
                "# HELP mfx_requests_total HTTP requests by path and status.",
                "# TYPE mfx_requests_total counter",
            ]
            for (path, code), n in sorted(self._counts.items()):
                lines.append(
                    f'mfx_requests_total{{path="{path}",code="{code}"}} {n}'
                )
            lines += [
                "# HELP mfx_request_latency_seconds Request latency "
                f"(quantiles over the last {self._window} requests).",
                "# TYPE mfx_request_latency_seconds summary",
            ]
            for path in sorted(self._lat):
                recent = np.sort(np.asarray(self._lat[path]))
                for q in (0.5, 0.9, 0.99):
                    v = float(np.quantile(recent, q))
                    lines.append(
                        "mfx_request_latency_seconds"
                        f'{{path="{path}",quantile="{q}"}} {v:.6g}'
                    )
                lines.append(
                    "mfx_request_latency_seconds_sum"
                    f'{{path="{path}"}} {self._lat_sum[path]:.6g}'
                )
                lines.append(
                    "mfx_request_latency_seconds_count"
                    f'{{path="{path}"}} {self._lat_count[path]}'
                )
            lines += [
                "# HELP mfx_batch_dispatches_total Device dispatches by "
                "the /recommend micro-batcher (incl. solo retries).",
                "# TYPE mfx_batch_dispatches_total counter",
                f"mfx_batch_dispatches_total {self.dispatches}",
                "# TYPE mfx_batch_requests_total counter",
                f"mfx_batch_requests_total {self.dispatch_requests}",
                "# TYPE mfx_batch_users_total counter",
                f"mfx_batch_users_total {self.dispatch_users}",
                "# TYPE mfx_batch_solo_retries_total counter",
                f"mfx_batch_solo_retries_total {self.solo_retries}",
            ]
        return "\n".join(lines) + "\n"


class RecServer:
    """HTTP wrapper over a recommender (TopK/Fused/Sharded — anything
    with ``recommend(users, k)``) and optionally a related-items
    function ``similar(items, k)``.

    >>> srv = RecServer(rec, port=8080)
    >>> srv.start()            # serves in a background thread
    >>> srv.stop()
    """

    def __init__(
        self, recommender, similar=None, cold=None, raw_item_ids=None,
        reload=None,
        host: str = "127.0.0.1", port: int = 8080, max_k: int = 1000,
        max_batch: int = 4096, batch_window_ms: float = 2.0,
    ):
        self._rec = recommender
        self._sim = similar
        self._cold = cold
        # reload: zero-arg factory returning a dict with any of
        # {"recommender", "similar", "cold", "raw_item_ids", "info"} —
        # POST /reload calls it and hot-swaps under the dispatch lock
        # (in-flight dispatches finish on the old model; queued ones see
        # the new one). The CLI wires this to "re-read the newest
        # checkpoint step", so a training job's saves go live without a
        # serving restart.
        self._reload = reload
        self._raw = raw_item_ids
        self._lock = threading.Lock()
        self._max_k = max_k
        self._max_batch = max_batch
        # cross-request micro-batching: concurrent /recommend requests
        # that arrive within the window ride ONE device dispatch (the
        # scoring matmul is batched over users anyway — QPS then scales
        # with device batch capacity, not per-dispatch latency)
        self._window = max(0.0, batch_window_ms) / 1e3
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._batcher: threading.Thread | None = None
        self._closed = False
        self._stats = _Stats()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def _reply(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self._reply_raw(code, body, "application/json")

            def _reply_raw(self, code: int, body: bytes,
                           ctype: str) -> None:
                t0 = getattr(self, "_t0", None)
                if t0 is not None:
                    outer._stats.record(
                        self.path, code, time.monotonic() - t0
                    )
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._t0 = time.monotonic()
                if self.path == "/metrics":
                    return self._reply_raw(
                        200, outer._stats.render().encode(),
                        "text/plain; version=0.0.4",
                    )
                if self.path != "/healthz":
                    return self._reply(404, {"error": "unknown path"})
                m = outer._rec.model
                self._reply(200, {
                    "status": "ok",
                    "num_users": int(m.num_users),
                    "num_items": int(m.num_items),
                    "rank": int(m.rank),
                    "recommender": type(outer._rec).__name__,
                })

            def do_POST(self):
                self._t0 = time.monotonic()
                # every malformed input must come back as HTTP 400, never
                # a connection reset from an escaped exception
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError("body must be a JSON object")
                    k = int(req.get("k", 10))
                except (ValueError, TypeError, json.JSONDecodeError) as e:
                    return self._reply(400, {"error": f"bad request: {e}"})
                if not 1 <= k <= outer._max_k:
                    return self._reply(
                        400, {"error": f"k must be in [1, {outer._max_k}]"}
                    )
                try:
                    if self.path == "/recommend":
                        return self._reply(200, outer._recommend(req, k))
                    if self.path == "/similar":
                        if outer._sim is None:
                            return self._reply(
                                404, {"error": "similar endpoint disabled"}
                            )
                        return self._reply(200, outer._similar(req, k))
                    if self.path == "/recommend_cold":
                        if outer._cold is None:
                            return self._reply(
                                404,
                                {"error": "cold-start endpoint disabled"},
                            )
                        return self._reply(
                            200, outer._recommend_cold(req, k)
                        )
                    if self.path == "/reload":
                        if outer._reload is None:
                            return self._reply(
                                404, {"error": "reload disabled"}
                            )
                        return self._reply(200, outer._do_reload())
                except (ValueError, TypeError) as e:
                    # id range / pool exhaustion / malformed lists
                    return self._reply(400, {"error": str(e)})
                except Exception as e:  # device failure etc. — still reply
                    return self._reply(
                        500, {"error": f"{type(e).__name__}: {e}"}
                    )
                return self._reply(404, {"error": "unknown path"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def _ids(self, req, key):
        ids = req.get(key)
        if (not isinstance(ids, list) or not ids
                or len(ids) > self._max_batch):
            raise ValueError(
                f"'{key}' must be a non-empty list (<= {self._max_batch})"
            )
        return np.asarray(ids, np.int32)

    @staticmethod
    def _json_scores(scores):
        # -inf (a seen item overflowing k on the stock path) is not valid
        # JSON (RFC 8259 has no Infinity) — serialize as null
        return [
            [float(s) if np.isfinite(s) else None for s in row]
            for row in scores
        ]

    def _recommend(self, req, k: int) -> dict:
        users = self._ids(req, "users")
        exclude = req.get("exclude")
        if exclude is not None:
            # per-request business-rule exclusions: over-fetch
            # k + len(exclude) and filter — each excluded id can knock
            # out at most one slot, so k survivors are guaranteed
            # (unless the catalog itself runs out — then -inf pads,
            # stock semantics)
            if (not isinstance(exclude, list)
                    or len(exclude) != len(users)
                    or not all(isinstance(e, list) for e in exclude)):
                raise ValueError(
                    "'exclude' must be a list of id lists, one per user"
                )
            if max((len(e) for e in exclude), default=0) > 1024:
                raise ValueError("exclude lists are capped at 1024 ids")
            pool_k = min(
                k + max((len(e) for e in exclude), default=0),
                self._rec.model.num_items,
            )
            items, scores = self._submit(users, pool_k)
            keep_i = np.empty((len(users), k), items.dtype)
            keep_s = np.full((len(users), k), -np.inf, scores.dtype)
            for b, ex in enumerate(exclude):
                mask = ~np.isin(items[b], np.asarray(ex, np.int64))
                took = min(k, int(mask.sum()))
                keep_i[b, :took] = items[b][mask][:k]
                keep_s[b, :took] = scores[b][mask][:k]
                if took < k:
                    # catalog exhausted: pad slots keep VALID item ids
                    # (from the excluded pool, in order) with score null
                    # — never uninitialized memory
                    keep_i[b, took:] = items[b][~mask][: k - took]
            items, scores = keep_i, keep_s
        else:
            items, scores = self._submit(users, k)
        out = {
            "users": [int(u) for u in users],
            "items": items.tolist(),
            "scores": self._json_scores(scores),
        }
        if self._raw is not None:
            out["raw_items"] = [
                [int(self._raw[i]) for i in row] for row in items
            ]
        return out

    # ---- cross-request micro-batching --------------------------------

    def _submit(self, users: np.ndarray, k: int):
        """Enqueue a request for the batcher and wait for its slice."""
        if self._closed:
            raise RuntimeError("server is shutting down")
        box: dict = {}
        done = threading.Event()
        self._q.put((users, k, box, done))
        done.wait()
        if "error" in box:
            raise box["error"]
        return box["items"], box["scores"]

    def _drain(self) -> None:
        import time

        while True:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            # collect whatever else arrives within the window (or is
            # already queued because the device was busy). The window is
            # a TOTAL deadline from the first request, not an idle-gap
            # timer — steady sub-window arrivals must not starve it.
            if self._window > 0:
                deadline = time.monotonic() + self._window
                while len(batch) < 64:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=left)
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._q.put(None)  # re-arm shutdown
                        break
                    batch.append(nxt)
            # group by k (one compiled program per k)
            groups: dict[int, list] = {}
            for item in batch:
                groups.setdefault(item[1], []).append(item)
            for k, grp in groups.items():
                users_cat = np.concatenate([g[0] for g in grp])
                try:
                    with self._lock:
                        items, scores = self._rec.recommend(users_cat, k=k)
                    self._stats.record_dispatch(len(grp), len(users_cat))
                    off = 0
                    for users, _, box, done in grp:
                        n = len(users)
                        box["items"] = items[off:off + n]
                        box["scores"] = scores[off:off + n]
                        off += n
                        done.set()
                except Exception:
                    # one request's data can poison a merged dispatch
                    # (e.g. fused pool exhaustion) — isolate by retrying
                    # each request alone so innocents still get results.
                    # EVERY box gets an answer or an error and EVERY done
                    # fires: an escaped exception here would kill the
                    # batcher thread and hang all future requests.
                    for users, _, box, done in grp:
                        try:
                            with self._lock:
                                box["items"], box["scores"] = (
                                    self._rec.recommend(users, k=k)
                                )
                            self._stats.record_dispatch(
                                1, len(users), solo_retry=True
                            )
                        except Exception as e:
                            box["error"] = e
                        done.set()

    def _recommend_cold(self, req, k: int) -> dict:
        """Anonymous/new-user serving: the body carries histories of
        [item_id, rating] pairs; each folds into a factor row
        (mfx.serve.foldin.recommend_cold) — no table mutation."""
        hs = req.get("histories")
        if (not isinstance(hs, list) or not hs
                or len(hs) > self._max_batch):
            raise ValueError(
                f"'histories' must be a non-empty list (<= {self._max_batch})"
            )
        histories = []
        for h in hs:
            if not isinstance(h, list) or not all(
                isinstance(p, (list, tuple)) and len(p) == 2 for p in h
            ):
                raise ValueError(
                    "each history must be a list of [item_id, rating] pairs"
                )
            ids = np.asarray([p[0] for p in h], np.int32)
            rs = np.asarray([p[1] for p in h], np.float32)
            histories.append((ids, rs))
        with self._lock:
            items, scores = self._cold(histories, k)
        out = {
            "items": items.tolist(),
            "scores": self._json_scores(scores),
        }
        if self._raw is not None:
            out["raw_items"] = [
                [int(self._raw[i]) for i in row] for row in items
            ]
        return out

    def _do_reload(self) -> dict:
        """Build the replacement OUTSIDE the lock (compiles, checkpoint
        IO), swap inside it — request handling pauses only for the
        attribute assignment."""
        new = self._reload()
        if not isinstance(new, dict) or "recommender" not in new:
            raise TypeError(
                "reload factory must return a dict with 'recommender'"
            )
        with self._lock:
            self._rec = new["recommender"]
            if "similar" in new:
                self._sim = new["similar"]
            if "cold" in new:
                self._cold = new["cold"]
            if "raw_item_ids" in new:
                self._raw = new["raw_item_ids"]
            m = self._rec.model
            out = {
                "status": "reloaded",
                "num_users": int(m.num_users),
                "num_items": int(m.num_items),
                "rank": int(m.rank),
            }
        out.update(new.get("info") or {})
        return out

    def _similar(self, req, k: int) -> dict:
        queries = self._ids(req, "items")
        with self._lock:
            nbrs, cos = self._sim(queries, k)
        return {
            "items": [int(q) for q in queries],
            "similar": nbrs.tolist(),
            "cosine": self._json_scores(cos),
        }

    def _start_batcher(self) -> None:
        if self._batcher is None:
            self._batcher = threading.Thread(target=self._drain, daemon=True)
            self._batcher.start()

    def start(self) -> None:
        self._start_batcher()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self._start_batcher()
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._closed = True  # new submissions fail fast from here on
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._batcher is not None:
            self._q.put(None)
            self._batcher.join(timeout=5)
            self._batcher = None
        # a handler that slipped its request in after the sentinel must
        # not block forever on done.wait()
        while not self._q.empty():
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _, _, box, done = item
                box["error"] = RuntimeError("server is shutting down")
                done.set()
