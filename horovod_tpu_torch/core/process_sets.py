"""Process sets: the global set.

The counterpart of the JAX package's ``core/process_sets.py``, reduced
to what the data-parallel training path uses: :class:`ProcessSet` and
the global set (id 0, every rank), which ``init()`` creates.
Registering further sets (``add_process_set``) is not ported yet
(ROADMAP item 10); a collective given any set but the global one
raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .exceptions import ProcessSetError
from .state import global_state


class ProcessSet:
    """A set of ranks (``ranks``, ``process_set_id``, ``size()``,
    ``included()``, ``rank()``), as in the JAX package."""

    def __init__(self, ranks: Sequence[int]):
        rs = [int(r) for r in ranks]
        if len(set(rs)) != len(rs):
            raise ProcessSetError(f"duplicate ranks in process set: {rs}")
        self.ranks: List[int] = sorted(rs)
        self.process_set_id: Optional[int] = None

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

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


def global_process_set() -> ProcessSet:
    st = global_state()
    if st.global_set is None:
        raise ProcessSetError("horovod_tpu_torch is not initialized")
    return st.global_set


def require_global(process_set) -> None:
    """Raise unless ``process_set`` is None or the global set."""
    if process_set is None or process_set.process_set_id == 0:
        return
    raise NotImplementedError(
        "collectives over a process set other than the global one are "
        "not ported yet (ROADMAP item 10)")
