"""Per-process global state.

The counterpart of the JAX package's ``core/state.py``. Where that holds
a device mesh, this holds the ``torch.distributed`` process group the
collectives run on, the device they run on, the rank/size fields read
from the launcher's environment, the device mesh, the knobs, the
process-set table, the eager negotiation runtime, the host timeline and
the handles of asynchronous collectives.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from .knobs import Knobs


class GlobalState:
    """One per process. ``init()`` fills it, ``shutdown()`` resets it."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.initialized: bool = False
        self.knobs: Knobs = Knobs()
        # ProcessSetTable: the global set (id 0) and the registered ones
        self.process_set_table: Optional[Any] = None
        # torch.device the collectives and the kernels run on
        self.device: Optional[Any] = None
        self.backend: Optional[str] = None  # "nccl" | "gloo"
        # whether init() created the process group (and shutdown() ends it)
        self.owns_group: bool = False
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.cross_rank = 0
        self.cross_size = 1
        # whether every host runs as many ranks (init() reads it)
        self.homogeneous = True
        # the device mesh (parallel/mesh.Mesh) HOROVOD_MESH names, bound
        # to the world
        self.mesh: Optional[Any] = None
        # the eager negotiation runtime (ops/eager_runtime.py), live
        # when init() ran with HVD_TPU_NATIVE=1
        self.eager_runtime: Optional[Any] = None
        # the host timeline (utils/timeline.Timeline); init() builds it,
        # writing when HOROVOD_TIMELINE names a file
        self.timeline: Optional[Any] = None
        # async collectives: handle -> (work, result-maker)
        self.handles: Dict[int, Any] = {}
        self.next_handle = 1

    def reset(self) -> None:
        self.__init__()


_global_state = GlobalState()


def global_state() -> GlobalState:
    return _global_state
