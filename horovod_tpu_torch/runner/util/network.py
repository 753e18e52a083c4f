"""TCP control-plane services: length-prefixed pickled messages with HMAC.

Reference horovod/runner/common/util/network.py:102,175
(``BasicService``/``BasicClient``) — the transport under the NIC probe's
driver and task services. Wire format: 4-byte big-endian length,
32-byte HMAC-SHA256 over the payload, pickled payload. Any message
failing HMAC verification is dropped and the connection closed (the
launcher control plane only ever runs inside one job's trust domain,
keyed by the per-job secret). Also the local-address helpers the
launcher uses to tell local hosts from remote ones.
"""

from __future__ import annotations

import hashlib
import hmac
import pickle
import socket
import socketserver
import struct
import threading
from typing import Any, List, Optional, Tuple

_LEN = struct.Struct(">I")
_DIGEST_BYTES = 32


class PingRequest:
    pass


class PingResponse:
    def __init__(self, service_name: str, source_address: str):
        self.service_name = service_name
        self.source_address = source_address


class AckResponse:
    """Generic empty OK."""


def _sign(key: bytes, payload: bytes) -> bytes:
    return hmac.new(key, payload, hashlib.sha256).digest()


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise EOFError("connection closed mid-message")
        buf += chunk
    return buf


class Wire:
    """Serialize/deserialize one authenticated message on a stream."""

    def __init__(self, key: bytes):
        self._key = key

    def write(self, obj: Any, wfile) -> None:
        payload = pickle.dumps(obj)
        wfile.write(_LEN.pack(len(payload)))
        wfile.write(_sign(self._key, payload))
        wfile.write(payload)
        wfile.flush()

    def read(self, rfile) -> Any:
        (length,) = _LEN.unpack(_read_exact(rfile, _LEN.size))
        digest = _read_exact(rfile, _DIGEST_BYTES)
        payload = _read_exact(rfile, length)
        if not hmac.compare_digest(digest, _sign(self._key, payload)):
            raise PermissionError("message failed HMAC verification")
        return pickle.loads(payload)


class BasicService:
    """Threaded TCP request/response server.

    Subclasses override `_handle(req, client_address)` and return the
    response object (reference network.py:102).
    """

    def __init__(self, name: str, key: bytes,
                 nics: Optional[List[str]] = None, port: int = 0):
        self._name = name
        self._wire = Wire(key)
        service = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    while True:
                        try:
                            req = service._wire.read(self.rfile)
                        except EOFError:
                            return
                        resp = service._handle(req, self.client_address)
                        service._wire.write(resp, self.wfile)
                except (PermissionError, ConnectionError, BrokenPipeError):
                    return

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        # port 0 (the default) = ephemeral, the launcher-internal case;
        # a fixed port serves standalone registries workers are told
        # about by address (e.g. the serving-replica registry)
        self._server = _Server(("0.0.0.0", port), _Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"{name}-server",
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._port

    def addresses(self) -> List[Tuple[str, int]]:
        """All routable (ip, port) pairs for this service."""
        addrs = [("127.0.0.1", self._port)]
        try:
            hostname_ip = socket.gethostbyname(socket.gethostname())
            if hostname_ip != "127.0.0.1":
                addrs.append((hostname_ip, self._port))
        except OSError:
            pass
        return addrs

    def _handle(self, req: Any, client_address) -> Any:
        if isinstance(req, PingRequest):
            return PingResponse(self._name, client_address[0])
        raise NotImplementedError(f"unhandled request {type(req).__name__}")

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


class BasicClient:
    """Blocking request/response client (reference network.py:175)."""

    def __init__(
        self,
        service_name: str,
        addresses: List[Tuple[str, int]],
        key: bytes,
        attempts: int = 3,
        timeout_s: float = 10.0,
    ):
        self._name = service_name
        self._wire = Wire(key)
        self._timeout = timeout_s
        self._address = self._probe(addresses, attempts)

    def _probe(self, addresses, attempts) -> Tuple[str, int]:
        last_err: Optional[Exception] = None
        for _ in range(attempts):
            for addr in addresses:
                try:
                    resp = self._request_at(addr, PingRequest())
                    if (
                        isinstance(resp, PingResponse)
                        and resp.service_name == self._name
                    ):
                        return addr
                except (OSError, EOFError, PermissionError) as e:
                    last_err = e
        raise ConnectionError(
            f"unable to reach {self._name} at any of {addresses}: {last_err}"
        )

    def _request_at(self, addr: Tuple[str, int], req: Any) -> Any:
        with socket.create_connection(addr, timeout=self._timeout) as sock:
            rfile = sock.makefile("rb")
            wfile = sock.makefile("wb")
            self._wire.write(req, wfile)
            return self._wire.read(rfile)

    def request(self, req: Any) -> Any:
        return self._request_at(self._address, req)

    @property
    def address(self) -> Tuple[str, int]:
        return self._address


def find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def get_local_host_addresses() -> List[str]:
    """Local addresses, loopback first; the last entry is the most
    routable one (real NIC IP when resolvable, else loopback)."""
    addrs = ["127.0.0.1"]
    candidates = []
    try:
        # Debian-style hosts resolve the hostname to 127.0.1.1 — any
        # 127.x.x.x is loopback and useless to remote workers
        candidates.append(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    try:
        # UDP connect sends no packets but selects the outbound NIC
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))
            candidates.append(s.getsockname()[0])
    except OSError:
        pass
    for ip in candidates:
        if not ip.startswith("127.") and ip not in addrs:
            addrs.append(ip)
    return addrs


def routable_host_address() -> str:
    """The address remote workers should use to reach this machine."""
    return get_local_host_addresses()[-1]


def is_local_host(name: str) -> bool:
    """True if `name` refers to this machine (hostname, localhost, or any
    local address)."""
    if name in ("localhost", socket.gethostname()):
        return True
    if name in get_local_host_addresses():
        return True
    try:
        return socket.gethostbyname(name) in get_local_host_addresses() + [
            "127.0.1.1"
        ]
    except OSError:
        return False
