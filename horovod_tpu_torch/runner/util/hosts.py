"""Host parsing and slot assignment.

Reference horovod/runner/common/util/hosts.py: ``SlotInfo(rank,
local_rank, cross_rank, ...)`` (:34), ``parse_hosts`` (:87),
``get_host_assignments`` (:100); the JAX package's
``runner/util/hosts.py`` is the same code. rank = global slot index,
local_rank = index within the host (the card the port's ``init()``
binds, ``cuda:local_rank``), cross_rank = index of the host among hosts
that have this local_rank (for a homogeneous job: the host index).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(spec: str) -> "HostInfo":
        host, _, n = spec.strip().partition(":")
        if not host:
            raise ValueError(f"bad host spec {spec!r}")
        return HostInfo(host, int(n) if n else 1)


@dataclasses.dataclass
class SlotInfo:
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int

    def to_response_string(self) -> str:
        return ":".join(
            str(v)
            for v in (
                self.hostname, self.rank, self.local_rank, self.cross_rank,
                self.size, self.local_size, self.cross_size,
            )
        )

    @staticmethod
    def from_response_string(s: str) -> "SlotInfo":
        host, rank, lrank, crank, size, lsize, csize = s.split(":")
        return SlotInfo(
            host, int(rank), int(lrank), int(crank),
            int(size), int(lsize), int(csize),
        )


INVALID_SLOT_INFO = SlotInfo("", -1, -1, -1, -1, -1, -1)


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """"h1:4,h2:4" → [HostInfo]. (reference hosts.py:87)"""
    return [
        HostInfo.from_string(spec)
        for spec in hosts_string.split(",")
        if spec.strip()
    ]


def parse_host_files(filename: str) -> str:
    """Hostfile with `host slots=N` or `host:N` lines → "h:N,h:N"."""
    specs = []
    with open(filename) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            host = parts[0]
            slots = 1
            if ":" in host:
                host, _, s = host.partition(":")
                slots = int(s)
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p[len("slots="):])
            specs.append(f"{host}:{slots}")
    return ",".join(specs)


def get_host_assignments(
    hosts: List[HostInfo],
    min_np: int,
    max_np: Optional[int] = None,
    rank_assignments: Optional[Dict[str, List[int]]] = None,
) -> List[SlotInfo]:
    """Assign global/local/cross ranks over hosts in order.

    `rank_assignments` maps hostname → previously-held global ranks, used by
    the elastic driver to keep surviving workers' ranks stable across a
    world resize (reference hosts.py:100, elastic/driver.py:240).
    """
    np_total = sum(h.slots for h in hosts)
    if max_np is not None:
        np_total = min(np_total, max_np)
    if np_total < min_np:
        raise ValueError(
            f"{np_total} slots available on {len(hosts)} hosts, "
            f"but at least {min_np} required"
        )

    # slots in host order
    slot_hosts: List[str] = []
    local_ranks: List[int] = []
    local_sizes: Dict[str, int] = {}
    for h in hosts:
        take = min(h.slots, np_total - len(slot_hosts))
        for i in range(take):
            slot_hosts.append(h.hostname)
            local_ranks.append(i)
        local_sizes[h.hostname] = take
        if len(slot_hosts) >= np_total:
            break

    # global ranks: honor prior assignments for surviving hosts, fill the
    # rest with unused ranks in order
    n = len(slot_hosts)
    ranks: List[Optional[int]] = [None] * n
    used = set()
    if rank_assignments:
        per_host_prior = {h: list(r) for h, r in rank_assignments.items()}
        for i, host in enumerate(slot_hosts):
            prior = per_host_prior.get(host)
            if prior:
                r = prior.pop(0)
                if 0 <= r < n and r not in used:
                    ranks[i] = r
                    used.add(r)
    free = iter(r for r in range(n) if r not in used)
    for i in range(n):
        if ranks[i] is None:
            ranks[i] = next(free)

    # cross ranks: among slots sharing a local_rank, order by host order
    cross_sizes: Dict[int, int] = {}
    for lr in local_ranks:
        cross_sizes[lr] = cross_sizes.get(lr, 0) + 1
    cross_seen: Dict[int, int] = {}
    assignments = []
    for i in range(n):
        lr = local_ranks[i]
        cr = cross_seen.get(lr, 0)
        cross_seen[lr] = cr + 1
        assignments.append(
            SlotInfo(
                hostname=slot_hosts[i],
                rank=ranks[i],
                local_rank=lr,
                cross_rank=cr,
                size=n,
                local_size=local_sizes[slot_hosts[i]],
                cross_size=cross_sizes[lr],
            )
        )
    assignments.sort(key=lambda s: s.rank)
    return assignments
