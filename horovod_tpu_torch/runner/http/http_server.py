"""HTTP rendezvous + key/value store for bootstrap and elastic rounds.

Reference horovod/runner/http/http_server.py:192,232, as the JAX
package's ``runner/http/http_server.py`` carries it:
``RendezvousServer`` publishes per-slot SlotInfo under scope
``rendezvous`` (workers GET their rank's record); ``KVStoreServer`` is a
generic PUT/GET/DELETE scope/key byte store. Paths: /scope/key. A GET
for a missing key returns 404 so clients can poll-wait.

The elastic driver (``runner/elastic/driver.py``) runs a
``RendezvousServer`` for its rounds; the workers' notification
services and replica stores register in it, and each worker's
:class:`~horovod_tpu_torch.elastic.replication.ReplicaStore` is a
``KVStoreServer``. With ``state_path`` (``RendezvousServer(state_dir=)``,
``hvdrun --rendezvous-state-dir``) the store is durable: every mutation
marks it dirty, a flusher writes an atomic pickle snapshot of the store,
the bound port and the round, and a server built on an existing
snapshot reloads it and binds the same port, so a restarted driver
resumes the job (``horovod_tpu/runner/http/http_server.py:369-540,
1143-1235``). A static launch starts neither server: its workers meet at
rank 0's TCP store (``runner/exec_run.py``).

The JAX server's sharded root tier (``ShardReplica``, ``replica_main``,
relay batches, ``/shard_map``, the request count; entry 14), its
``/metrics``, ``/health`` and ``/clock`` routes, flight-dump receipts
and the clearing of the flight, metrics and health scopes at a new
round (entry 13) are not here.
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ...utils import faults
from ..util.hosts import SlotInfo

RENDEZVOUS_SCOPE = "rendezvous"

LOG = logging.getLogger("horovod_tpu_torch.runner")


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
        self.server.dirty.set()  # type: ignore[attr-defined]
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
        self.server.dirty.set()  # type: ignore[attr-defined]
        self._reply(200, b"ok")

    def _reply(self, code: int, body: bytes):
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request logging
        pass


class KVStoreServer:
    """Generic scope/key byte store over HTTP (reference :232).

    With ``state_path`` the store is durable (see the module docstring):
    a server constructed on an existing snapshot reloads the store and
    rebinds the same port, so a restarted rendezvous answers at the
    address its workers are already retrying against.
    """

    STATE_FORMAT = 1

    def __init__(self, port: int = 0,
                 store: Optional[Dict[str, Dict[str, bytes]]] = None,
                 state_path: Optional[str] = None,
                 flush_interval_s: float = 0.3):
        self._state_path = state_path
        self._flush_interval_s = flush_interval_s
        self._flush_stop = threading.Event()
        self._flush_thread: Optional[threading.Thread] = None
        restored = self._load_state() if state_path else None
        self.restored = restored is not None
        bind_port = port
        if restored is not None and not port:
            bind_port = int(restored.get("port", 0))
        try:
            self._httpd = ThreadingHTTPServer(("0.0.0.0", bind_port),
                                              _KVHandler)
        except OSError:
            if not bind_port or bind_port == port:
                raise
            LOG.warning(
                "could not rebind persisted KV-store port %d; binding "
                "a fresh port (workers polling the old address will "
                "time out)", bind_port)
            self._httpd = ThreadingHTTPServer(("0.0.0.0", port), _KVHandler)
        init_store: Dict[str, Dict[str, bytes]] = (
            store if store is not None else {})
        if restored is not None:
            for scope, kv in restored.get("store", {}).items():
                init_store.setdefault(scope, {}).update(kv)
        self._httpd.store = init_store  # type: ignore[attr-defined]
        self._httpd.lock = threading.Lock()  # type: ignore[attr-defined]
        self._httpd.dirty = threading.Event()  # type: ignore[attr-defined]
        if restored is not None:
            self._apply_state_extra(restored.get("extra", {}))
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="kvstore",
        )

    def start_server(self) -> int:
        self._thread.start()
        if self._state_path and self._flush_thread is None:
            self._flush_stop.clear()
            self._flush_thread = threading.Thread(
                target=self._flush_loop, daemon=True, name="kvstore-flush")
            self._flush_thread.start()
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
        if self._flush_thread is not None:
            self._flush_stop.set()
            self._flush_thread.join(timeout=5)
            self._flush_thread = None
        if self._state_path:
            self.persist()  # final flush: a clean shutdown loses nothing
        self._httpd.server_close()

    # -- persistence -------------------------------------------------------

    def _state_extra(self) -> Dict:
        """Subclass hook: extra durable state (the rendezvous round)."""
        return {}

    def _apply_state_extra(self, extra: Dict) -> None:
        pass

    def persist(self) -> None:
        """Write the atomic on-disk snapshot now (tmp + rename)."""
        if not self._state_path:
            return
        with self.lock:
            snap = {scope: dict(kv) for scope, kv in self.store.items()}
        payload = {
            "format": self.STATE_FORMAT,
            "time_unix": time.time(),
            "port": self.port,
            "store": snap,
            "extra": self._state_extra(),
        }
        try:
            d = os.path.dirname(os.path.abspath(self._state_path))
            os.makedirs(d, exist_ok=True)
            tmp = f"{self._state_path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._state_path)
        except OSError as e:
            LOG.warning("could not persist KV-store state: %s", e)

    def _load_state(self) -> Optional[Dict]:
        try:
            with open(self._state_path, "rb") as f:
                payload = pickle.load(f)
        except FileNotFoundError:
            return None
        except Exception as e:
            LOG.warning("ignoring unreadable KV-store state %s: %s",
                        self._state_path, e)
            return None
        if payload.get("format") != self.STATE_FORMAT:
            LOG.warning("ignoring KV-store state %s with unknown format %r",
                        self._state_path, payload.get("format"))
            return None
        return payload

    def _flush_loop(self) -> None:
        dirty = self._httpd.dirty  # type: ignore[attr-defined]
        while not self._flush_stop.is_set():
            if dirty.wait(timeout=0.5):
                dirty.clear()
                self.persist()
                # debounce: batch bursts of mutations into one write
                self._flush_stop.wait(self._flush_interval_s)


class RendezvousServer(KVStoreServer):
    """KV store that additionally publishes slot assignments
    (reference http_server.py:192; the elastic driver publishes a new
    round of assignments each time it launches the workers).

    With ``state_dir`` its scopes and round counter persist, and a
    restarted server resumes the same job on the same port."""

    STATE_FILE = "rendezvous_state.pkl"

    def __init__(self, state_dir: Optional[str] = None):
        self._round = 0
        super().__init__(
            state_path=(os.path.join(state_dir, self.STATE_FILE)
                        if state_dir else None))

    def _state_extra(self) -> Dict:
        return {"round": self._round}

    def _apply_state_extra(self, extra: Dict) -> None:
        self._round = int(extra.get("round", 0))

    def last_assignments(self) -> List[SlotInfo]:
        """The slot assignments of the persisted round: what a restarted
        driver resumes with instead of reshuffling ranks."""
        out: List[SlotInfo] = []
        with self.lock:
            scope = dict(self.store.get(RENDEZVOUS_SCOPE, {}))
        for key, raw in scope.items():
            if not key.startswith("rank_"):
                continue
            try:
                out.append(SlotInfo.from_response_string(
                    raw.decode() if isinstance(raw, bytes) else raw))
            except Exception:
                LOG.warning("unparseable persisted slot record %s", key)
        out.sort(key=lambda s: s.rank)
        return out

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
        # persist the new round before workers can see it: a driver crash
        # between publish and flush must not resurrect the previous one
        self.persist()
        return self.port

    @property
    def round(self) -> int:
        return self._round
