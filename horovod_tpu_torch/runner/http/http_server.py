"""HTTP rendezvous + key/value store for bootstrap.

Reference horovod/runner/http/http_server.py:192,232, as the JAX
package's ``runner/http/http_server.py`` carries it:
``RendezvousServer`` publishes per-slot SlotInfo under scope
``rendezvous`` (workers GET their rank's record); ``KVStoreServer`` is a
generic PUT/GET/DELETE scope/key byte store. Paths: /scope/key. A GET
for a missing key returns 404 so clients can poll-wait.

No launch of the port starts either server yet: the workers bootstrap
through rank 0's TCP store (``runner/exec_run.py``), and elastic
training (ROADMAP queue A entry 8) is the first to serve them. The JAX
server's sharded root tier (``ShardReplica``, relay batches,
``/shard_map``, the request count; entry 14), its ``/metrics``,
``/health`` and ``/clock`` routes, flight-dump receipts and the
clearing of the flight, metrics and health scopes at a new round
(entry 13), and its on-disk state for a restarted driver (entry 8) are
not here.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ...utils import faults
from ..util.hosts import SlotInfo

RENDEZVOUS_SCOPE = "rendezvous"


class _KVHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _split(self) -> Optional[Tuple[str, str]]:
        parts = self.path.strip("/").split("/", 1)
        if len(parts) != 2 or not parts[0] or not parts[1]:
            return None
        return parts[0], parts[1]

    def _injected_503(self) -> bool:
        """Server-side fault point: an ``http.server`` error rule turns
        this request into a 503 — the retryable-status path clients
        must survive (their 5xx-retry discipline, http_client.py)."""
        try:
            faults.inject("http.server", method=self.command)
        except faults.InjectedFault:
            self._reply(503, b"injected fault")
            return True
        return False

    def do_GET(self):
        if self._injected_503():
            return
        sk = self._split()
        if sk is None:
            self._reply(400, b"bad path")
            return
        with self.server.lock:  # type: ignore[attr-defined]
            value = self.server.store.get(  # type: ignore[attr-defined]
                sk[0], {}).get(sk[1])
        if value is None:
            self._reply(404, b"not found")
        else:
            self._reply(200, value)

    def do_PUT(self):
        if self._injected_503():
            return
        sk = self._split()
        if sk is None:
            self._reply(400, b"bad path")
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        with self.server.lock:  # type: ignore[attr-defined]
            self.server.store.setdefault(  # type: ignore[attr-defined]
                sk[0], {})[sk[1]] = body
        self._reply(200, b"ok")

    def do_DELETE(self):
        if self._injected_503():
            return
        sk = self._split()
        if sk is None:
            self._reply(400, b"bad path")
            return
        with self.server.lock:  # type: ignore[attr-defined]
            self.server.store.get(  # type: ignore[attr-defined]
                sk[0], {}).pop(sk[1], None)
        self._reply(200, b"ok")

    def _reply(self, code: int, body: bytes):
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request logging
        pass


class KVStoreServer:
    """Generic scope/key byte store over HTTP (reference :232)."""

    def __init__(self, port: int = 0,
                 store: Optional[Dict[str, Dict[str, bytes]]] = None):
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), _KVHandler)
        self._httpd.store = (  # type: ignore[attr-defined]
            store if store is not None else {})
        self._httpd.lock = threading.Lock()  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="kvstore",
        )

    def start_server(self) -> int:
        self._thread.start()
        return self._httpd.server_address[1]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def store(self) -> Dict[str, Dict[str, bytes]]:
        return self._httpd.store  # type: ignore[attr-defined]

    @property
    def lock(self):
        return self._httpd.lock  # type: ignore[attr-defined]

    def shutdown_server(self) -> None:
        # BaseServer.shutdown() blocks on the serve_forever loop's ack, so
        # only call it if the loop is actually running.
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(timeout=5)
        self._httpd.server_close()


class RendezvousServer(KVStoreServer):
    """KV store that additionally publishes slot assignments
    (reference http_server.py:192; an elastic driver swaps assignments
    on every new rendezvous round)."""

    def __init__(self):
        super().__init__()
        self._round = 0

    def init(self, host_assignments: List[SlotInfo]) -> int:
        """Publish a new round of slot assignments; returns server port."""
        if not self._thread.is_alive():
            self.start_server()
        with self.lock:
            scope = self.store.setdefault(RENDEZVOUS_SCOPE, {})
            scope.clear()
            scope["round"] = str(self._round).encode()
            scope["size"] = str(len(host_assignments)).encode()
            for slot in host_assignments:
                scope[f"rank_{slot.rank}"] = (
                    slot.to_response_string().encode()
                )
        self._round += 1
        return self.port

    @property
    def round(self) -> int:
        return self._round
