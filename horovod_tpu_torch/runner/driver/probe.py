"""Task-to-task interface routability probing.

Reference horovod/runner/driver/driver_service.py:260
(``get_common_interfaces``) + task_service ring probe, as the JAX
package's ``runner/driver/probe.py`` carries it: on multi-NIC hosts the
address a worker *advertises* may not be the one its peers can *reach*
(management NICs, container bridges, IB-only fabrics). Every task
probes the interfaces of the next task in a ring and the driver
intersects the routable sets.

One TaskProbeService per host (bound 0.0.0.0, so one port serves every
NIC); the driver asks each task to TCP-probe its ring successor's
per-interface addresses and keeps the interfaces every hop could
reach. The launcher exports the result as ``HOROVOD_NICS`` and, for the
port's data plane, as ``NCCL_SOCKET_IFNAME`` and ``GLOO_SOCKET_IFNAME``
(``runner/exec_run.py``), as the reference's gloo launcher does.

``psutil`` is optional: without it :func:`interface_addresses` reads
the interfaces from ``socket.if_nameindex()`` and the ``SIOCGIFADDR``
ioctl (Linux), and only where that fails too names the outbound-route
address ``"default"``.
"""

from __future__ import annotations

import socket
from typing import Dict, List, Optional, Tuple

from ..util.network import AckResponse, BasicClient, BasicService


#: the name :func:`interface_addresses` gives the outbound-route address
#: when it can name no interface; it is no interface NCCL or gloo know
DEFAULT_IFACE = "default"

_SIOCGIFADDR = 0x8915


def _ioctl_interface_addresses(
    nics: Optional[List[str]] = None,
) -> Dict[str, str]:
    """iface -> IPv4 address from the kernel, without psutil: the
    interface names of ``socket.if_nameindex()``, each one's address by
    the ``SIOCGIFADDR`` ioctl. Interfaces without an IPv4 address are
    left out; empty where the platform has neither call."""
    import fcntl
    import struct

    addrs: Dict[str, str] = {}
    try:
        names = [name for _, name in socket.if_nameindex()]
    except OSError:
        return addrs
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for name in names:
            if nics and name not in nics:
                continue
            try:
                req = struct.pack("256s", name.encode()[:15])
                res = fcntl.ioctl(s.fileno(), _SIOCGIFADDR, req)
            except OSError:
                continue
            addrs[name] = socket.inet_ntoa(res[20:24])
    return addrs


def interface_addresses(
    nics: Optional[List[str]] = None,
) -> Dict[str, str]:
    """IPv4 address of each up interface (iface -> ip), loopback
    excluded unless it is all there is. `nics` filters to a user-given
    allowlist (reference --network-interface semantics)."""
    addrs: Dict[str, str] = {}
    try:
        import psutil

        for iface, snics in psutil.net_if_addrs().items():
            if nics and iface not in nics:
                continue
            for sn in snics:
                if sn.family == socket.AF_INET:
                    addrs[iface] = sn.address
                    break
    except ImportError:
        addrs = _ioctl_interface_addresses(nics)
    if not addrs:
        # last resort: the outbound-route trick names one address
        from ..util.network import routable_host_address

        addrs[DEFAULT_IFACE] = routable_host_address()
    if nics:
        # explicit allowlist wins verbatim — a user naming lo means lo
        return addrs
    non_loop = {
        i: a for i, a in addrs.items() if not a.startswith("127.")
    }
    return non_loop or addrs


class InterfacesRequest:
    pass


class InterfacesResponse:
    def __init__(self, iface_addrs: Dict[str, Tuple[str, int]]):
        self.iface_addrs = iface_addrs


class ProbePeerRequest:
    """Ask a task to TCP-probe a peer's per-interface addresses."""

    def __init__(self, iface_addrs: Dict[str, Tuple[str, int]],
                 timeout_s: float = 2.0):
        self.iface_addrs = iface_addrs
        self.timeout_s = timeout_s


class ProbePeerResponse:
    def __init__(self, reachable: List[str]):
        self.reachable = reachable


class RegisterTaskRequest:
    def __init__(self, index: int, addresses: List[Tuple[str, int]]):
        self.index = index
        self.addresses = addresses


class ShutdownTaskRequest:
    pass


class TaskProbeService(BasicService):
    """Per-host probe endpoint (reference task_service.py). Advertises
    its interface map and probes peers on request."""

    def __init__(self, index: int, key: bytes,
                 nics: Optional[List[str]] = None,
                 advertised: Optional[Dict[str, str]] = None):
        super().__init__(f"task-probe-{index}", key)
        self.index = index
        # advertised overrides discovery — tests inject unreachable
        # addresses to model a dark NIC
        self._ifaces = dict(advertised or interface_addresses(nics))
        import threading

        self.stop_event = threading.Event()

    def interface_map(self) -> Dict[str, Tuple[str, int]]:
        # advertised values are plain ips (served on this service's
        # port) or explicit (ip, port) pairs — the latter lets tests
        # model a dark NIC with a dead endpoint
        return {
            i: ((a, self.port) if isinstance(a, str) else tuple(a))
            for i, a in self._ifaces.items()
        }

    def addresses(self) -> List[Tuple[str, int]]:
        """Every interface address (plus loopback) — the driver registers
        the source address it actually saw first, but keeps the rest as
        fallbacks for the ring clients."""
        addrs = [
            (a, self.port) for a in self._ifaces.values()
            if isinstance(a, str)
        ]
        addrs.append(("127.0.0.1", self.port))
        return addrs

    def _handle(self, req, client_address):
        if isinstance(req, InterfacesRequest):
            return InterfacesResponse(self.interface_map())
        if isinstance(req, ProbePeerRequest):
            reachable = []
            for iface, (ip, port) in sorted(req.iface_addrs.items()):
                try:
                    with socket.create_connection(
                        (ip, port), timeout=req.timeout_s
                    ):
                        reachable.append(iface)
                except OSError:
                    continue
            return ProbePeerResponse(reachable)
        if isinstance(req, ShutdownTaskRequest):
            self.stop_event.set()
            return AckResponse()
        return super()._handle(req, client_address)


class DriverProbeService(BasicService):
    """Launcher-side registry the probe tasks report in to
    (reference HorovodRunDriverService)."""

    def __init__(self, num_tasks: int, key: bytes):
        super().__init__("driver-probe", key)
        import threading

        self._num = num_tasks
        self._cv = threading.Condition()
        self.task_addresses: Dict[int, List[Tuple[str, int]]] = {}

    def addresses(self) -> List[Tuple[str, int]]:
        """Every candidate address a remote probe task might reach the
        driver on: all NIC addresses, the default-route pick, loopback.
        The base-class hostname lookup alone is a trap — Debian-style
        hosts resolve to 127.0.1.1 and multi-NIC launchers to an
        arbitrary NIC (the very problem this module exists to fix)."""
        from ..util.network import get_local_host_addresses

        ips = list(interface_addresses().values())
        for a in reversed(get_local_host_addresses()):
            if a not in ips:
                ips.append(a)
        return [(a, self.port) for a in ips]

    def _handle(self, req, client_address):
        if isinstance(req, RegisterTaskRequest):
            with self._cv:
                # record the observed source address first: it is the one
                # address the DRIVER verifiably can reach the task on
                seen = (client_address[0], req.addresses[0][1])
                ordered = [seen] + [
                    a for a in req.addresses if tuple(a) != seen
                ]
                self.task_addresses[req.index] = ordered
                self._cv.notify_all()
            return AckResponse()
        return super()._handle(req, client_address)

    def wait_for_registration(self, timeout_s: float = 60.0) -> None:
        with self._cv:
            ok = self._cv.wait_for(
                lambda: len(self.task_addresses) >= self._num, timeout_s
            )
        if not ok:
            raise TimeoutError(
                f"only {len(self.task_addresses)}/{self._num} probe tasks "
                f"registered within {timeout_s}s"
            )


def find_common_nics(
    task_addresses: List[List[Tuple[str, int]]],
    key: bytes,
    timeout_s: float = 10.0,
) -> List[str]:
    """Ring-probe every task and intersect the routable interface sets
    (reference _run_probe, driver_service.py:122)."""
    clients = [
        BasicClient(f"task-probe-{i}", [tuple(a) for a in addrs], key,
                    timeout_s=timeout_s)
        for i, addrs in enumerate(task_addresses)
    ]
    iface_maps = [
        c.request(InterfacesRequest()).iface_addrs for c in clients
    ]
    common: Optional[set] = None
    n = len(clients)
    for i, c in enumerate(clients):
        peer = iface_maps[(i + 1) % n]
        resp = c.request(ProbePeerRequest(peer))
        s = set(resp.reachable)
        common = s if common is None else common & s
    if not common:
        raise RuntimeError(
            "no common routable interface across all hosts "
            f"(per-task interface maps: {iface_maps}); pass "
            "--network-interface to override "
            "(reference driver_service.py:260)"
        )
    return sorted(common)


def shutdown_tasks(task_addresses, key: bytes) -> None:
    """Accepts an index-ordered list or an {index: addresses} dict (the
    partial-registration case preserves the true task indices)."""
    items = (
        task_addresses.items()
        if isinstance(task_addresses, dict)
        else enumerate(task_addresses)
    )
    for i, addrs in items:
        try:
            BasicClient(
                f"task-probe-{i}", [tuple(a) for a in addrs], key,
                attempts=1, timeout_s=2.0,
            ).request(ShutdownTaskRequest())
        except Exception:
            pass  # task already gone; probing is best-effort cleanup


def get_common_interfaces(
    hosts: List[str],
    key: bytes,
    nics: Optional[List[str]] = None,
    launch_task_fn=None,
    timeout_s: float = 60.0,
) -> Optional[List[str]]:
    """High-level flow (reference get_common_interfaces,
    driver_service.py:260): explicit --network-interface wins; a
    single/local-only host list needs no probing; otherwise launch one
    probe task per host via `launch_task_fn(host, driver_addresses)`,
    wait for registration, ring-probe, intersect, shut the tasks down.
    Returns None when probing is unnecessary."""
    from ..util.network import is_local_host

    if nics:
        return list(nics)
    remote = [h for h in hosts if not is_local_host(h)]
    if not remote:
        return None
    if launch_task_fn is None:
        raise ValueError(
            "remote hosts need a launch_task_fn to start probe tasks"
        )
    driver = DriverProbeService(len(hosts), key)
    try:
        for idx, host in enumerate(hosts):
            launch_task_fn(idx, host, driver.addresses())
        try:
            driver.wait_for_registration(timeout_s)
        except TimeoutError:
            # shut down whatever DID register — otherwise their ssh
            # sessions linger for the full --linger-s and a retried
            # launch doubles them up
            shutdown_tasks(dict(driver.task_addresses), key)
            raise
        ordered = [driver.task_addresses[i] for i in range(len(hosts))]
        try:
            return find_common_nics(ordered, key, timeout_s=10.0)
        finally:
            shutdown_tasks(ordered, key)
    finally:
        driver.shutdown()
