"""HTTP front end for inference: POST /v1/predict + /v1/generate,
/healthz, /health, /metrics.

The PyTorch counterpart of the JAX package's ``serving/server.py``: a
threaded stdlib HTTP server (per-request threads, silent logging,
Content-Length replies) carrying the launcher's per-job shared secret
(``runner/util/secret.py``) as request authentication: when a key is
set, every POST body must be accompanied by ``X-Hvd-Auth:
hex(hmac_sha256(key, body))``. Probe routes stay unauthenticated.
``GET /metrics`` answers this process's exposition
(``metrics.exposition()``: the serving records of this tier and of the
engine behind it). ``GET /health`` answers this process's fleet-health
verdict (``health.verdict()``: off, ok or degraded, with the firing
rules), which ``/healthz`` folds in.

Protocol (the JAX package's, unchanged)::

    POST /v1/predict
    {"inputs": [[...], ...], "dtype": "float32", "timeout_ms": 2000}
    -> 200 {"outputs": [[...], ...], "dtype": "float32", "n": 2}
       400 malformed input          401 bad/missing auth
       413 oversized body           429 admission queue full
       503 draining / injected failure
       504 request deadline expired

    POST /v1/generate                     (decode replicas / front door)
    {"prompt": [17, 4, ...], "max_new_tokens": 64, "timeout_ms": 5000,
     "slo": "interactive", "stream": true}
    -> 200 chunked, one JSON object per line:
       {"tokens": [92]} ... {"done": true, "finish_reason": "eos", "n": 7}
       (stream=false collapses to one {"tokens": [...], "n",
       "finish_reason"} body; the error statuses mirror /v1/predict,
       and an error AFTER streaming began arrives as a final
       {"done": true, "error": ...} chunk — the 200 is already on the
       wire)

The same class fronts a single replica (predict_fn = the batcher) and
the multi-replica dispatch tier (predict_fn = ReplicaSet.predict).
Every request carries an id (``X-Request-Id``, serving/tracing.py),
echoed on the reply and forwarded by the dispatch tier; it keys the
request's ``SERVING_REQUEST`` timeline span and its ``serving_request``
flight record. Each completed POST lands in
``hvd_serving_requests_total`` and ``hvd_serving_request_seconds`` by
status, and the in-flight count in ``hvd_serving_inflight``.
"""

from __future__ import annotations

import hashlib
import hmac
import itertools
import json
import threading
import time
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np

from .. import health as _health
from ..utils import flight, metrics
from ..utils.timeline import active_timeline
from . import tracing
from .batcher import Draining, QueueFull, RequestTimeout

AUTH_HEADER = "X-Hvd-Auth"
REQUEST_ID_HEADER = tracing.REQUEST_ID_HEADER
MAX_BODY_BYTES = 64 << 20  # one request can't swallow the heap
SERVING_REQUEST = "SERVING_REQUEST"  # timeline activity, tid = request id

# a span key gets a process-unique suffix: a client may reuse an id
# (retries, a fixed X-Request-Id), and two concurrent requests with one
# id would otherwise share an open span
_span_seq = itertools.count(1)


def sign_body(key: bytes, body: bytes) -> str:
    """The request auth token: hex HMAC-SHA256 over the raw body with
    the per-job secret (client side of the check above)."""
    return hmac.new(key, body, hashlib.sha256).hexdigest()


class _ServingHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    _request_id = ""  # set per request; echoed on the reply
    _streamed = False  # a chunked 200 is already on the wire

    # -- helpers ------------------------------------------------------------

    def _reply(self, code: int, body: bytes,
               ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if self._request_id:
            self.send_header(REQUEST_ID_HEADER, self._request_id)
        if self.close_connection:
            # tell HTTP/1.1 keep-alive clients the stream ends here
            # (set on paths that left request bytes unread, e.g. 413)
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj: Dict) -> None:
        self._reply(code, json.dumps(obj).encode())

    # manual chunked framing (token streaming): the stdlib server never
    # writes Transfer-Encoding itself, so the handler frames each JSON
    # line as one HTTP/1.1 chunk
    def _start_stream(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Transfer-Encoding", "chunked")
        if self._request_id:
            self.send_header(REQUEST_ID_HEADER, self._request_id)
        self.end_headers()
        self._streamed = True

    def _stream_chunk(self, obj: Dict) -> None:
        data = json.dumps(obj).encode() + b"\n"
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _end_stream(self) -> None:
        self.wfile.write(b"0\r\n\r\n")

    def log_message(self, *args):  # silence per-request logging
        pass

    # -- routes -------------------------------------------------------------

    def do_GET(self):
        srv: "ServingServer" = self.server.serving  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0].rstrip("/")
        if path == "/metrics":
            ctype, body = metrics.exposition()
            self._reply(200, body, ctype)
        elif path == "/healthz":
            self._reply_json(200 if not srv.draining else 503,
                             srv.health())
        elif path == "/health":
            # the verdict alone (the rendezvous store serves the same
            # route for the training fleet)
            self._reply_json(200, _health.verdict())
        else:
            self._reply_json(404, {"error": "not found"})

    def do_POST(self):
        srv: "ServingServer" = self.server.serving  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0].rstrip("/")
        generate = path == "/v1/generate"
        if generate and srv.generate_fn is None:
            self._reply_json(404, {"error": "no generation engine "
                                            "behind this server"})
            return
        if not generate and (path != "/v1/predict"
                             or srv.predict_fn is None):
            self._reply_json(404, {"error": "not found"})
            return
        self._streamed = False
        t0 = time.perf_counter()
        # request trace id: the client's X-Request-Id (sanitized) or a
        # fresh one, bound to this handler thread's context so the
        # batcher/dispatch tier downstream carry the same id
        rid = tracing.sanitize(self.headers.get(REQUEST_ID_HEADER, ""))
        self._request_id = rid
        rid_token = tracing.set_request_id(rid)
        span = f"{rid}#{next(_span_seq)}"
        tl = active_timeline()
        if tl is not None:
            tl.activity_start(span, SERVING_REQUEST, args={"id": rid})
        # count ourselves in-flight BEFORE touching the body: drain()
        # must not report empty (and let SIGTERM os._exit) while a
        # request is mid-read — the whole handling INCLUDING the
        # response write sits inside the in-flight window
        srv._inflight_delta(+1)
        code, resp = 500, {"error": "internal"}
        try:
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    # the oversized body is NOT read: close the
                    # connection so a keep-alive client can't have its
                    # next request parsed out of the unconsumed bytes
                    self.close_connection = True
                    code, resp = 413, {"error": "body too large"}
                    return
                body = self.rfile.read(length)
                if srv.key is not None:
                    token = self.headers.get(AUTH_HEADER, "")
                    if not hmac.compare_digest(
                            token, sign_body(srv.key, body)):
                        code, resp = 401, {"error": "bad auth"}
                        return
                if srv.draining:
                    code, resp = 503, {"error": "draining"}
                    return
                if generate:
                    try:
                        req = json.loads(body)
                        if not isinstance(req, dict) \
                                or "prompt" not in req:
                            raise KeyError("prompt")
                        timeout_s = (float(req["timeout_ms"]) / 1e3
                                     if req.get("timeout_ms") else None)
                    except (ValueError, KeyError, TypeError) as e:
                        code, resp = 400, {"error": f"bad request: {e}"}
                        return
                    code, resp = self._generate(srv, req, timeout_s)
                    return
                try:
                    req = json.loads(body)
                    x = np.asarray(
                        req["inputs"],
                        dtype=np.dtype(req.get("dtype", "float32")))
                    timeout_s = (float(req["timeout_ms"]) / 1e3
                                 if req.get("timeout_ms") else None)
                except (ValueError, KeyError, TypeError) as e:
                    code, resp = 400, {"error": f"bad request: {e}"}
                    return
                y = np.asarray(srv.predict_fn(x, timeout_s))
                code, resp = 200, {"outputs": y.tolist(),
                                   "dtype": str(y.dtype),
                                   "n": int(y.shape[0])}
            except QueueFull as e:
                code, resp = 429, {"error": str(e)}
            except (RequestTimeout, TimeoutError) as e:
                code, resp = 504, {"error": str(e)}
            except Draining as e:
                code, resp = 503, {"error": str(e)}
            except urllib.error.HTTPError as e:
                # front-door role: an upstream replica's verdict (a 400
                # the dispatch tier rightly refused to retry, an
                # exhausted-retry 429/503) passes through with its own
                # status
                code, resp = e.code, {"error": f"replica: {e}"}
            except ValueError as e:
                # malformed inputs (empty batch, bad shape) are the
                # CLIENT's error; a 500 would read as replica death to
                # the dispatch tier and eject a healthy replica
                code, resp = 400, {"error": f"bad request: {e}"}
            except ConnectionError as e:
                # includes faults.InjectedFault — a chaos rule at
                # serving.admit / serving.replica_exec surfaces as a
                # retryable 503, the class a dying replica produces
                code, resp = 503, {"error": f"transient: {e}"}
            except Exception as e:  # noqa: BLE001 — must answer
                code, resp = 500, {"error": f"{type(e).__name__}: {e}"}
        finally:
            try:
                self._finish(code, resp, t0)
            finally:
                srv._inflight_delta(-1)
                if tl is not None:
                    tl.activity_end(span, SERVING_REQUEST)
                tracing.reset_request_id(rid_token)
                self._request_id = ""

    def _generate(self, srv: "ServingServer", req: Dict,
                  timeout_s: Optional[float]):
        """Run one /v1/generate request through ``srv.generate_fn`` (an
        iterator of chunk dicts — scheduler.GenRequest.stream or the
        front door's upstream relay). Admission errors raise BEFORE
        anything is written, so do_POST maps them to 429/503/504 like
        predict."""
        chunks = iter(srv.generate_fn(req, timeout_s))
        if not req.get("stream"):
            tokens, fin = [], {}
            for chunk in chunks:  # admission errors raise on first next
                tokens.extend(int(t) for t in chunk.get("tokens", ()))
                if chunk.get("done"):
                    fin = chunk
                    break
            resp = {"tokens": tokens, "n": len(tokens),
                    "finish_reason": fin.get("finish_reason")}
            if fin.get("error"):
                # tokens flowed, then the engine failed: the partial
                # output is real — deliver it with the error attached
                resp["error"] = fin["error"]
            return 200, resp
        first = next(chunks)
        self._start_stream()
        try:
            self._stream_chunk(first)
            if not first.get("done"):
                for chunk in chunks:
                    self._stream_chunk(chunk)
                    if chunk.get("done"):
                        break
        except Exception as e:  # noqa: BLE001 — 200 is on the wire
            # a generator failure mid-stream must reach the client as an
            # explicit error chunk, or a truncated generation reads as a
            # completed one (best effort: the socket may be the failure)
            try:
                self._stream_chunk({"done": True,
                                    "error": f"{type(e).__name__}: {e}"})
            except Exception:
                pass
            raise
        finally:
            self._end_stream()
        return 200, None

    def _finish(self, code: int, resp: Dict, t0: float) -> None:
        dt = time.perf_counter() - t0
        metrics.record_serving_request(dt, code)
        flight.record("serving_request", self._request_id,
                      code=code, ms=round(dt * 1e3, 3))
        if not self._streamed:
            self._reply_json(code, resp)


class _HTTPServer(ThreadingHTTPServer):
    # a burst of concurrent clients queues in the listen backlog instead
    # of being reset: the stdlib's default of 5 resets a burst of 64
    # one-example requests (one top bucket's worth)
    request_queue_size = 256


class ServingServer:
    """Threaded HTTP server around a ``predict_fn(x, timeout_s)`` and/or
    a ``generate_fn(req_dict, timeout_s) -> iterator of chunk dicts``.

    ``key`` enables the shared-secret auth (pass
    ``secret.secret_from_env()`` in launcher-spawned replicas).
    ``drain()`` implements the preemption contract: stop admission,
    wait for in-flight requests to flush, return — the SIGTERM handler
    (elastic/preemption.py) calls it before exiting 83.
    """

    def __init__(
        self,
        predict_fn: Optional[Callable[[np.ndarray, Optional[float]],
                                      np.ndarray]] = None,
        *,
        generate_fn: Optional[Callable] = None,
        port: int = 0,
        key: Optional[bytes] = None,
        health_extra: Optional[Callable[[], Dict]] = None,
    ):
        if predict_fn is None and generate_fn is None:
            raise ValueError(
                "ServingServer needs predict_fn and/or generate_fn")
        self.predict_fn = predict_fn
        self.generate_fn = generate_fn
        self.key = key
        self.draining = False
        self._health_extra = health_extra
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._httpd = _HTTPServer(("0.0.0.0", port), _ServingHandler)
        self._httpd.serving = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="hvd-serving-http")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> int:
        self._thread.start()
        return self.port

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def health(self) -> Dict:
        h = {"status": "draining" if self.draining else "ok",
             "inflight": self._inflight}
        if self._health_extra is not None:
            try:
                h.update(self._health_extra())
            except Exception:
                pass
        # the fleet-health verdict beside the slots and the queue, so a
        # probe reads one route: "health" (off, ok, degraded), the
        # active alerts' count and names
        h.update(_health.verdict())
        return h

    def _inflight_delta(self, d: int) -> None:
        with self._inflight_lock:
            self._inflight += d
            n = self._inflight
        metrics.set_serving_inflight(n)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting requests and wait for in-flight ones to
        finish; True when the server emptied within the budget."""
        self.draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    return True
            time.sleep(0.01)
        return False

    def shutdown(self) -> None:
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(timeout=5)
        self._httpd.server_close()
