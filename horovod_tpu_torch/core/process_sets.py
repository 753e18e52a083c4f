"""Process sets: collectives over subsets of ranks.

The counterpart of the JAX package's ``core/process_sets.py``. A
process set is a sorted subset of the world's ranks; the global set
(id 0, every rank) exists from ``init()``. Where the JAX package turns a
set into replica groups of one mesh axis, here each registered proper
subset carries a ``torch.distributed`` group of its ranks
(``dist.new_group``), and the collectives of ``ops/collectives.py`` run
on it.

``dist.new_group`` is collective over the whole world: every rank,
member or not, must create the same groups in the same order. So
:func:`add_process_set` and :func:`remove_process_set` are collective
too, as the JAX package's docstring requires under its runtime: every
rank calls them with the same membership, in the same order. Each call
validates locally first (duplicate ranks, ranks out of range, a set
that exists already, removing id 0, an unknown id), before any
cross-rank traffic; :func:`add_process_set` then checks, with one small
all-gather over the world, that every rank asked for the same ranks,
and raises on every rank if not. With the eager runtime live
(``HVD_TPU_NATIVE=1``) a set is also registered with its controller,
negotiated, and its executor makes a group of its own for the set;
removal deregisters it there first.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .exceptions import ProcessSetError
from .state import global_state


class ProcessSet:
    """A set of ranks (``ranks``, ``process_set_id``, ``size()``,
    ``included()``, ``rank()``), as in the JAX package. ``group`` is the
    ``torch.distributed`` group of a registered proper subset (None for
    the global set, whose collectives run on the world's group)."""

    def __init__(self, ranks: Sequence[int]):
        rs = [int(r) for r in ranks]
        if len(set(rs)) != len(rs):
            raise ProcessSetError(f"duplicate ranks in process set: {rs}")
        self.ranks: List[int] = sorted(rs)
        self.process_set_id: Optional[int] = None  # set on registration
        self.group = None

    def size(self) -> int:
        return len(self.ranks)

    def included(self, rank: Optional[int] = None) -> bool:
        if rank is None:
            rank = global_state().rank
        return rank in self.ranks

    def rank(self, global_rank: Optional[int] = None) -> int:
        """Set-local rank of ``global_rank`` (or of this process)."""
        if global_rank is None:
            global_rank = global_state().rank
        try:
            return self.ranks.index(global_rank)
        except ValueError:
            raise ProcessSetError(
                f"rank {global_rank} is not a member of process set "
                f"{self.process_set_id} (ranks={self.ranks})")

    def axis_index_groups(self, world_size: int
                          ) -> Optional[List[List[int]]]:
        """The set as replica groups partitioning ``[0, world_size)``:
        the set as one group, every non-member in its own singleton
        group; None for the whole world. The layout of the JAX package's
        SPMD form, which the port's tests compare against."""
        if self.ranks == list(range(world_size)):
            return None
        members = set(self.ranks)
        groups = [list(self.ranks)]
        groups.extend([r] for r in range(world_size) if r not in members)
        return groups

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


class ProcessSetTable:
    """id -> ProcessSet registry; id 0 is the global set. Ids count up
    from registration to registration and are never reused, so ranks
    that register the same sets in the same order agree on them."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._table: Dict[int, ProcessSet] = {}
        self._next_id = 0
        self._register(ProcessSet(range(world_size)))

    def check(self, ps: ProcessSet) -> None:
        """Raise if ``ps`` cannot be registered: a set with its ranks
        exists, or a rank is out of range."""
        for existing in self._table.values():
            if existing.ranks == ps.ranks:
                raise ProcessSetError(
                    f"a process set with ranks {ps.ranks} already exists "
                    f"(id={existing.process_set_id})")
        bad = [r for r in ps.ranks if not 0 <= r < self.world_size]
        if bad:
            raise ProcessSetError(
                f"ranks {bad} out of range for world size "
                f"{self.world_size}")

    def _register(self, ps: ProcessSet) -> ProcessSet:
        self.check(ps)
        ps.process_set_id = self._next_id
        self._table[self._next_id] = ps
        self._next_id += 1
        return ps

    def add(self, ps: ProcessSet) -> ProcessSet:
        return self._register(ps)

    def remove(self, ps_or_id) -> ProcessSet:
        pid = (ps_or_id.process_set_id if isinstance(ps_or_id, ProcessSet)
               else int(ps_or_id))
        if pid == 0:
            raise ProcessSetError("cannot remove the global process set")
        ps = self._table.pop(pid, None)
        if ps is None:
            raise ProcessSetError(f"no process set with id {pid}")
        ps.process_set_id = None
        return ps

    def get(self, pid: int) -> ProcessSet:
        try:
            return self._table[pid]
        except KeyError:
            raise ProcessSetError(f"no process set with id {pid}")

    def ids(self) -> List[int]:
        return sorted(self._table)

    @property
    def global_set(self) -> ProcessSet:
        return self._table[0]


def _table() -> ProcessSetTable:
    st = global_state()
    if st.process_set_table is None:
        raise ProcessSetError("horovod_tpu_torch is not initialized")
    return st.process_set_table


def global_process_set() -> ProcessSet:
    return _table().global_set


def _agree(ranks: List[int]) -> None:
    """One all-gather over the world of each rank's membership mask;
    raise on every rank unless all asked for the same ranks."""
    st = global_state()
    if st.size == 1:
        return
    mask = torch.zeros(st.size, dtype=torch.int32, device=st.device)
    mask[ranks] = 1
    rows = [torch.empty_like(mask) for _ in range(st.size)]
    dist.all_gather(rows, mask)
    if any(not torch.equal(row, rows[0]) for row in rows):
        asked = [torch.nonzero(row).flatten().tolist() for row in rows]
        raise ProcessSetError(
            "add_process_set must be called on every rank with the same "
            f"ranks; the ranks asked for {asked}")


def _world_barrier() -> None:
    st = global_state()
    if st.size > 1:
        dist.all_reduce(torch.zeros(1, device=st.device))


def add_process_set(ranks_or_set) -> ProcessSet:
    """Register a new process set and create its group (reference
    process_sets.py:123). Collective: every rank calls it with the same
    ranks, in the same order as its other registrations."""
    table = _table()
    ps = (ranks_or_set if isinstance(ranks_or_set, ProcessSet)
          else ProcessSet(ranks_or_set))
    table.check(ps)
    _agree(ps.ranks)
    ps.group = dist.new_group(ps.ranks)
    ps = table.add(ps)
    rt = global_state().eager_runtime
    if rt is not None:
        # negotiated registration with the eager runtime, which makes
        # the set's group of its own (horovod_tpu/core/process_sets.py:
        # 189-191)
        try:
            rt.register_process_set(ps.process_set_id, ps.ranks)
        except Exception:
            table.remove(ps.process_set_id)
            raise
    return ps


def add_or_get_process_set(ranks: Sequence[int]) -> ProcessSet:
    """The registered set with exactly these ranks (the global set for
    every rank), or a new one registered as :func:`add_process_set`
    does; collective like it."""
    table = _table()
    want = sorted(int(r) for r in ranks)
    for pid in table.ids():
        ps = table.get(pid)
        if ps.ranks == want:
            return ps
    return add_process_set(want)


def remove_process_set(ps_or_id) -> None:
    """Unregister a set and destroy its group (reference
    process_sets.py:147). Collective: every rank calls it, after its
    last collective on the set."""
    table = _table()
    pid = (ps_or_id.process_set_id if isinstance(ps_or_id, ProcessSet)
           else int(ps_or_id))
    ps = table.get(pid)
    if pid == 0:
        raise ProcessSetError("cannot remove the global process set")
    rt = global_state().eager_runtime
    if rt is not None:
        # deregister with the runtime before the local table changes
        # (horovod_tpu/core/process_sets.py:235-236)
        rt.deregister_process_set(pid)
    _world_barrier()
    if ps.included():
        dist.destroy_process_group(ps.group)
    ps.group = None
    table.remove(pid)


def get_process_set_by_id(pid: int) -> ProcessSet:
    return _table().get(pid)


def destroy_groups() -> None:
    """Destroy the registered sets' groups (``shutdown()`` when the
    world's group is not its own to end)."""
    st = global_state()
    if st.process_set_table is None:
        return
    for pid in st.process_set_table.ids():
        ps = st.process_set_table.get(pid)
        if ps.group is not None and ps.included():
            dist.destroy_process_group(ps.group)
        ps.group = None


class SetContext(NamedTuple):
    """Where a collective over a process set runs: ``group`` (None: the
    world's), its ``size``, whether this rank is a ``member``, its
    ``rank`` within the set (0 for a non-member) and the set's global
    ``ranks``."""

    group: Any
    size: int
    member: bool
    rank: int
    ranks: List[int]


def set_context(process_set) -> SetContext:
    """The :class:`SetContext` of ``process_set`` (None: the global
    set). A set of every rank is the global set, registered or not; any
    other set must be registered (it carries the group)."""
    st = global_state()
    if process_set is None or process_set.process_set_id == 0 or \
            process_set.ranks == list(range(st.size)):
        return SetContext(None, st.size, True, st.rank,
                          list(range(st.size)))
    pid = process_set.process_set_id
    table = _table()
    if pid is None or pid not in table.ids() or \
            table.get(pid).ranks != process_set.ranks:
        raise ProcessSetError(
            f"{process_set!r} is not registered: call add_process_set "
            "with its ranks on every rank first")
    member = st.rank in process_set.ranks
    return SetContext(table.get(pid).group, process_set.size(), member,
                      process_set.ranks.index(st.rank) if member else 0,
                      list(process_set.ranks))
