"""Client for the rendezvous/KV HTTP store (reference
runner/http/http_client.py, as the JAX package hardens it).

Every verb runs under the shared
:class:`~horovod_tpu_torch.utils.retry.RetryPolicy` (exponential backoff
+ jitter, ``HOROVOD_RETRY_*`` knobs), so a transient ECONNRESET or a 5xx
from a restarting rendezvous server does not kill a worker mid-
bootstrap. A 404 on GET stays significant (poll-wait contract) and 4xx
responses never retry. ``wait_for_key`` runs on a monotonic deadline —
wall-clock steps cannot break the timeout — and keeps polling through
transient store outages until the deadline. Fault-injection points
``http.put`` / ``http.get`` / ``http.delete`` fire inside the retried
body (utils/faults.py), so injected errors exercise the real retry
path.

The JAX client's shard routing over a sharded root tier
(``ShardClient``, ``HOROVOD_ROOT_ADDRS``) comes with ROADMAP queue A
entry 14; every verb here goes straight to the given address.
``server_clock`` pings the store's ``GET /clock`` once, unretried.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Optional

from ...utils import faults, retry

_TIMEOUT_S = 10.0


def _retryable(exc: BaseException) -> bool:
    """Transport failures and server-side (5xx) errors retry; client
    errors (4xx, notably the 404 poll-wait signal) propagate."""
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code >= 500
    return isinstance(exc, (OSError, EOFError))


def put(addr: str, port: int, scope: str, key: str, value: bytes) -> None:
    def _do() -> None:
        faults.inject("http.put", scope=scope, key=key)
        req = urllib.request.Request(
            f"http://{addr}:{port}/{scope}/{key}", data=value, method="PUT"
        )
        with urllib.request.urlopen(req, timeout=_TIMEOUT_S):
            pass

    retry.default_policy().call(_do, point="http.put", retryable=_retryable)


def get(addr: str, port: int, scope: str, key: str) -> Optional[bytes]:
    def _do() -> Optional[bytes]:
        faults.inject("http.get", scope=scope, key=key)
        try:
            with urllib.request.urlopen(
                f"http://{addr}:{port}/{scope}/{key}", timeout=_TIMEOUT_S
            ) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    return retry.default_policy().call(
        _do, point="http.get", retryable=_retryable
    )


def server_clock(addr: str, port: int,
                 timeout_s: float = 2.0) -> "tuple[float, float]":
    """One ping to the store's ``GET /clock``, without retries (it is a
    measurement, and a backed-off retry would smear its round trip):
    ``(server time_unix, round trip seconds)``."""
    t0 = time.monotonic()
    with urllib.request.urlopen(
            f"http://{addr}:{port}/clock", timeout=timeout_s) as resp:
        body = json.loads(resp.read())
    return float(body["time_unix"]), time.monotonic() - t0


def delete(addr: str, port: int, scope: str, key: str) -> None:
    def _do() -> None:
        faults.inject("http.delete", scope=scope, key=key)
        req = urllib.request.Request(
            f"http://{addr}:{port}/{scope}/{key}", method="DELETE"
        )
        with urllib.request.urlopen(req, timeout=_TIMEOUT_S):
            pass

    retry.default_policy().call(
        _do, point="http.delete", retryable=_retryable
    )


def wait_for_key(
    addr: str, port: int, scope: str, key: str, timeout_s: float = 60.0
) -> bytes:
    deadline = retry.Deadline(timeout_s)
    last_err: Optional[Exception] = None
    while not deadline.expired():
        try:
            v = get(addr, port, scope, key)
        except Exception as e:
            if not _retryable(e):
                raise
            # the store itself is down: the per-call retries gave up,
            # but the poll-wait contract owns the deadline — keep
            # polling until it expires
            last_err = e
            v = None
        if v is not None:
            return v
        time.sleep(0.2)
    raise TimeoutError(
        f"key {scope}/{key} not published within {timeout_s}s"
        + (f" (last error: {last_err})" if last_err else "")
    )
