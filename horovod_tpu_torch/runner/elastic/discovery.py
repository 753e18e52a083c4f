"""Host discovery and the blacklist with cooldown and resurrection.

``horovod_tpu/runner/elastic/discovery.py`` (reference
runner/elastic/discovery.py): ``HostDiscovery`` (:226),
``HostDiscoveryScript`` (:232, runs the user's executable and parses
``host[:slots]`` lines), ``HostManager`` (:152, polls discovery and
diffs against the current set), the blacklist with cooldown backoff and
resurrection (:33-111), and ``FixedHosts``, a settable host set.
"""

from __future__ import annotations

import random
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from ...utils import faults, retry
from ..util.hosts import HostInfo

# update classification (reference HostUpdateResult flags)
NO_UPDATE = 0
ADDED = 1
REMOVED = 2
MIXED = ADDED | REMOVED

DEFAULT_COOLDOWN_RANGE = (10.0, 60.0)
COOLDOWN_BACKOFF = 2.0
COOLDOWN_CAP_MULTIPLIER = 16.0


class HostDiscovery:
    """Pluggable discovery interface (reference discovery.py:226)."""

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        """hostname -> slot count of every currently available host."""
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Run a user executable printing ``host[:slots]`` per line
    (reference discovery.py:232)."""

    def __init__(self, discovery_script: str, default_slots: int = 1):
        self._script = discovery_script
        self._default_slots = default_slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = subprocess.check_output(
            self._script, shell=True, timeout=60).decode()
        hosts: Dict[str, int] = {}
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            host, _, slots = line.partition(":")
            hosts[host] = int(slots) if slots else self._default_slots
        return hosts


class FixedHosts(HostDiscovery):
    """A settable host set (tests; reference test_elastic_driver.py's
    mock discovery)."""

    def __init__(self, hosts: Optional[Dict[str, int]] = None):
        self._lock = threading.Lock()
        self._hosts = dict(hosts or {})

    def set(self, hosts: Dict[str, int]) -> None:
        with self._lock:
            self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._hosts)


class _BlacklistEntry:
    def __init__(self, cooldown_range: Optional[Tuple[float, float]]):
        self._range = cooldown_range
        self._failures = 0
        self._until: float = float("inf")  # no cooldown: forever

    def blacklist(self) -> None:
        self._failures += 1
        if self._range is None:
            self._until = float("inf")
            return
        lo, hi = self._range
        backoff = min(COOLDOWN_BACKOFF ** (self._failures - 1),
                      COOLDOWN_CAP_MULTIPLIER)
        self._until = time.time() + random.uniform(lo, hi) * backoff

    @property
    def active(self) -> bool:
        return time.time() < self._until


class DiscoveredHosts:
    """Snapshot of the available hosts minus the blacklisted ones."""

    def __init__(self, hosts: Dict[str, int], order: List[str]):
        self._hosts = dict(hosts)
        self._order = list(order)

    @property
    def available_hosts(self) -> set:
        return set(self._hosts)

    def count_available_slots(self) -> int:
        return sum(self._hosts.values())

    @property
    def host_assignment_order(self) -> List[str]:
        return list(self._order)

    def get_slots(self, host: str) -> int:
        return self._hosts.get(host, 0)

    def host_infos(self) -> List[HostInfo]:
        return [HostInfo(h, self._hosts[h]) for h in self._order]


class HostManager:
    """Tracks the live host set: polls discovery, classifies changes,
    keeps the blacklist (reference discovery.py:152)."""

    def __init__(self, discovery: HostDiscovery,
                 cooldown_range: Optional[Tuple[float, float]] = None):
        self._discovery = discovery
        self._cooldown_range = cooldown_range
        self._lock = threading.Lock()
        self._blacklist: Dict[str, _BlacklistEntry] = {}
        self._order: List[str] = []  # stable assignment order
        self._current = DiscoveredHosts({}, [])

    @property
    def current_hosts(self) -> DiscoveredHosts:
        with self._lock:
            return self._current

    def blacklist(self, host: str) -> None:
        with self._lock:
            entry = self._blacklist.get(host)
            if entry is None:
                entry = _BlacklistEntry(self._cooldown_range)
                self._blacklist[host] = entry
            entry.blacklist()

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            entry = self._blacklist.get(host)
            return entry.active if entry else False

    def _poll_discovery(self) -> Dict[str, int]:
        """One poll under the shared retry policy. Fault point
        ``discovery.poll``: ``error`` raises (retried), ``flap`` reports
        an empty host set for one poll."""
        def _do() -> Dict[str, int]:
            if faults.inject("discovery.poll") == "flap":
                return {}
            return self._discovery.find_available_hosts_and_slots()

        return retry.default_policy().call(
            _do, point="discovery.poll",
            retryable=lambda e: isinstance(
                e, (OSError, subprocess.SubprocessError)))

    def update_available_hosts(self) -> int:
        """Poll discovery once; returns NO_UPDATE/ADDED/REMOVED/MIXED."""
        discovered = self._poll_discovery()
        with self._lock:
            usable = {
                h: s for h, s in discovered.items()
                if not (self._blacklist.get(h)
                        and self._blacklist[h].active)
            }
            prev = self._current
            # surviving hosts keep their position so rank assignments
            # stay put (reference driver.py:240)
            order = [h for h in self._order if h in usable]
            order += [h for h in usable if h not in order]
            self._order = order
            result = NO_UPDATE
            if usable.keys() - prev.available_hosts:
                result |= ADDED
            if prev.available_hosts - usable.keys():
                result |= REMOVED
            if result == NO_UPDATE and any(
                    prev.get_slots(h) != s for h, s in usable.items()):
                result = MIXED
            self._current = DiscoveredHosts(usable, order)
            return result
