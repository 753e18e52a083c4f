"""Compute service: a registry of workers by kind, on the control plane.

The port of the JAX package's ``runner/compute_service.py`` (after the
reference Horovod's ``runner/common/service/compute_service.py``
``ComputeService``/``ComputeClient``): a generic registry over the
launcher's authenticated TCP transport (``runner/util/network.py``).
Workers register ``(kind, index, address)``; their users wait for and
look up all workers of a kind; shutdown releases every waiter. The
serving tier registers its replicas here (serving/replica_set.py).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

from .util.network import AckResponse, BasicClient, BasicService

SERVICE_NAME = "compute-service"


class RegisterWorkerRequest:
    def __init__(self, kind: str, index: int, address: str):
        self.kind = kind
        self.index = index
        self.address = address


class WaitForWorkersRequest:
    def __init__(self, kind: str, count: int, timeout_s: float):
        self.kind = kind
        self.count = count
        self.timeout_s = timeout_s


class WorkersResponse:
    def __init__(self, addresses: Dict[int, str]):
        self.addresses = addresses


class ShutdownRequest:
    pass


class ComputeService(BasicService):
    """The registry's server side."""

    def __init__(self, key: bytes, port: int = 0):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._workers: Dict[str, Dict[int, str]] = {}
        self._shutdown = False
        super().__init__(SERVICE_NAME, key, port=port)

    def _handle(self, req, client_address):
        if isinstance(req, RegisterWorkerRequest):
            with self._cv:
                self._workers.setdefault(req.kind, {})[req.index] = (
                    req.address)
                self._cv.notify_all()
            return AckResponse()
        if isinstance(req, WaitForWorkersRequest):
            with self._cv:
                self._cv.wait_for(
                    lambda: self._shutdown
                    or len(self._workers.get(req.kind, {})) >= req.count,
                    timeout=req.timeout_s)
                if self._shutdown:
                    return WorkersResponse({})
                # on timeout, what has registered so far
                return WorkersResponse(dict(self._workers.get(req.kind, {})))
        if isinstance(req, ShutdownRequest):
            with self._cv:
                self._shutdown = True
                self._cv.notify_all()
            return AckResponse()
        return super()._handle(req, client_address)


class ComputeClient(BasicClient):
    """The registry's client side (workers and their users)."""

    def __init__(self, addresses: List[Tuple[str, int]], key: bytes,
                 timeout_s: float = 30.0):
        super().__init__(SERVICE_NAME, addresses, key, timeout_s=timeout_s)

    def register_worker(self, kind: str, index: int, address: str) -> None:
        self.request(RegisterWorkerRequest(kind, index, address))

    def wait_for_workers(self, kind: str, count: int,
                         timeout_s: float = 60.0) -> Dict[int, str]:
        # the transport timeout must outlast the server-side wait, or
        # the socket read times out before the server's wait returns
        saved = self._timeout
        self._timeout = max(saved, timeout_s + 10.0)
        try:
            resp = self.request(WaitForWorkersRequest(kind, count, timeout_s))
        finally:
            self._timeout = saved
        return resp.addresses

    def shutdown_service(self) -> None:
        self.request(ShutdownRequest())
