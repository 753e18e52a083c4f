"""Per-slot worker state registry.

``horovod_tpu/runner/elastic/registration.py`` (reference
runner/elastic/registration.py:28, ``WorkerStateRegistry``): collects
READY/SUCCESS/FAILURE/ABORTED reports per slot for the current round;
when every slot of the round has reached a terminal state it fires the
driver's barrier callback.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"
# stopped by the launcher because ANOTHER worker failed, or preempted:
# terminal for the barrier, but not the worker's own fault, so its host
# is not blacklisted
ABORTED = "ABORTED"

_TERMINAL = (SUCCESS, FAILURE, ABORTED)


class WorkerStateRegistry:
    def __init__(self, on_barrier: Callable[[Dict[str, str]], None]):
        self._on_barrier = on_barrier
        self._lock = threading.Lock()
        self._expected = 0
        self._round = 0
        self._states: Dict[str, str] = {}  # "host:local_rank" -> state

    def reset(self, expected_workers: int) -> None:
        """A new rendezvous round."""
        with self._lock:
            self._expected = expected_workers
            self._states = {}
            self._round += 1

    @property
    def round(self) -> int:
        return self._round

    def _record(self, key: str, state: str) -> None:
        fire: Optional[Dict[str, str]] = None
        with self._lock:
            # the first terminal state wins (FAILURE then exit 0 is FAILURE)
            if self._states.get(key) in _TERMINAL:
                return
            self._states[key] = state
            terminal = [s for s in self._states.values() if s in _TERMINAL]
            if self._expected and len(terminal) >= self._expected:
                fire = dict(self._states)
        if fire is not None:
            self._on_barrier(fire)

    def record_ready(self, host: str, local_rank: int) -> None:
        self._record(f"{host}:{local_rank}", READY)

    def record_success(self, host: str, local_rank: int) -> None:
        self._record(f"{host}:{local_rank}", SUCCESS)

    def record_failure(self, host: str, local_rank: int) -> None:
        self._record(f"{host}:{local_rank}", FAILURE)

    def record_aborted(self, host: str, local_rank: int) -> None:
        self._record(f"{host}:{local_rank}", ABORTED)

    def count(self, state: str) -> int:
        with self._lock:
            return sum(1 for s in self._states.values() if s == state)

    def get(self, host: str, local_rank: int) -> Optional[str]:
        with self._lock:
            return self._states.get(f"{host}:{local_rank}")
