"""Worker notification protocol: driver -> workers on host-set changes.

``horovod_tpu/runner/elastic/worker.py`` (reference
runner/elastic/worker.py): ``WorkerNotificationService`` runs inside a
worker (on ``runner/util/network.BasicService``); the driver holds a
``WorkerNotificationClient`` per worker and pushes a
``HostsUpdatedRequest`` when discovery sees a change; the worker's
``WorkerNotificationManager`` sets the flag that ``State.commit()``
turns into ``HostsUpdatedInterrupt``. A worker registers its service's
addresses in the rendezvous store under scope ``workers``, key
``rank_{rank}``; ``notification_manager.init()`` does that when the
launcher exported a rendezvous address.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from ...utils import faults
from ..http import http_client
from ..util.network import AckResponse, BasicClient, BasicService
from ..util.secret import secret_from_env

WORKERS_SCOPE = "workers"
SERVICE_NAME = "worker-notification"


class HostsUpdatedRequest:
    def __init__(self, timestamp: int, update_result: int):
        self.timestamp = timestamp
        self.update_result = update_result


class WorkerNotificationService(BasicService):
    """In-worker TCP service receiving host-update pushes."""

    def __init__(self, key: bytes, manager: "WorkerNotificationManager"):
        super().__init__(SERVICE_NAME, key)
        self._manager = manager

    def _handle(self, req, client_address):
        if isinstance(req, HostsUpdatedRequest):
            self._manager.handle_hosts_updated(req.timestamp,
                                               req.update_result)
            return AckResponse()
        return super()._handle(req, client_address)


class WorkerNotificationClient(BasicClient):
    """Driver-side client to one worker's notification service."""

    def __init__(self, addresses: List[Tuple[str, int]], key: bytes,
                 timeout_s: float = 10.0):
        super().__init__(SERVICE_NAME, addresses, key, timeout_s=timeout_s)

    def notify_hosts_updated(self, timestamp: int,
                             update_result: int) -> None:
        self.request(HostsUpdatedRequest(timestamp, update_result))


class WorkerNotificationManager:
    """Worker-side singleton: starts the service, registers its address,
    relays pushes into the elastic state's host-update flag."""

    def __init__(self) -> None:
        self._service: Optional[WorkerNotificationService] = None
        self._timestamp = 0

    def init(self) -> None:
        if self._service is not None:
            return
        rendezvous_addr = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
        if not rendezvous_addr:
            return  # not launched by an elastic hvdrun
        key = secret_from_env()
        self._service = WorkerNotificationService(key, self)
        rank = os.environ.get("HVD_TPU_RANK", "0")
        port = int(os.environ["HVD_TPU_RENDEZVOUS_PORT"])
        payload = json.dumps(self._service.addresses()).encode()
        faults.inject("worker.register", rank=rank)
        http_client.put(rendezvous_addr, port, WORKERS_SCOPE,
                        f"rank_{rank}", payload)

    def handle_hosts_updated(self, timestamp: int,
                             update_result: int) -> None:
        if timestamp <= self._timestamp:
            return
        self._timestamp = timestamp
        from ...elastic.state import host_update_flag

        host_update_flag.signal()

    def shutdown(self) -> None:
        if self._service is not None:
            self._service.shutdown()
            self._service = None


notification_manager = WorkerNotificationManager()


def get_worker_client(rendezvous_addr: str, rendezvous_port: int,
                      rank: int, key: bytes, timeout_s: float = 10.0,
                      ) -> Optional[WorkerNotificationClient]:
    """Driver side: look up a worker's registered address and connect."""
    raw = http_client.get(rendezvous_addr, rendezvous_port, WORKERS_SCOPE,
                          f"rank_{rank}")
    if raw is None:
        return None
    addresses = [tuple(a) for a in json.loads(raw.decode())]
    try:
        return WorkerNotificationClient(addresses, key, timeout_s=timeout_s)
    except ConnectionError:
        return None
