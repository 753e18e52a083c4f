"""Preemption-safe shutdown: SIGTERM -> emergency snapshot + a distinct
"host going away" exit code.

The port of ``horovod_tpu/elastic/preemption.py``. A preempted worker
(spot reclaim, maintenance) gets SIGTERM and a short grace window.
Without a handler it dies mid-step, every step since the last commit is
lost, and the elastic driver blacklists a healthy host. The handler:

* takes the state's preemption snapshot
  (:meth:`~horovod_tpu_torch.elastic.state.State.preemption_snapshot`:
  an ``ObjectState`` snapshots now, a ``TorchState`` keeps its last
  commit, since its tensors may be half-way through ``optimizer.step()``);
* on rank 0 writes it as the *emergency snapshot*
  (``HOROVOD_EMERGENCY_CHECKPOINT`` or an explicit path): format 2, a
  pickle of the snapshot with its sha256, then passed through the
  ``emergency.payload`` corruption gate, written to a temporary name,
  fsynced and renamed into place; the JAX package reads the file and
  writes ones this module reads;
* exits with :data:`PREEMPTED_EXIT_CODE` (83), which the elastic driver
  ends the round on without blacklisting the host.

``@hvd.elastic.run`` installs the handler (knob ``HOROVOD_PREEMPTION``,
default on); a script outside the wrapper calls :func:`install`.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import signal
import threading
import time
from typing import Callable, Optional, Tuple

from ..utils import faults

LOG = logging.getLogger("horovod_tpu_torch.elastic")

# distinct from ordinary failures and shell signal codes (128 + N): the
# elastic driver maps it to ABORTED, not FAILURE
PREEMPTED_EXIT_CODE = 83

# format 2: the snapshot's pickle inside an envelope with its sha256, so
# a torn or damaged file is detected; format 1 (no checksum) still loads
_EMERGENCY_FORMAT = 2


def emergency_save(state, path: str) -> str:
    """Write the state's preemption snapshot to ``path`` atomically
    (tmp + fsync + rename) with its checksum; returns the path."""
    epoch = state.preemption_snapshot()
    saved_bytes = pickle.dumps(state._saved,
                               protocol=pickle.HIGHEST_PROTOCOL)
    digest = hashlib.sha256(saved_bytes).hexdigest()
    # digest first, damage second: an `emergency.payload:corrupt` rule
    # simulates damage on disk, which the checksum must catch
    saved_bytes = faults.corrupt("emergency.payload", saved_bytes)
    payload = {
        "format": _EMERGENCY_FORMAT,
        "time_unix": time.time(),
        "epoch": int(epoch),
        "sha256": digest,
        "saved_pickle": saved_bytes,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def emergency_read(path: str) -> Tuple[int, dict]:
    """Load and verify an emergency snapshot: ``(commit epoch, saved
    dict)``. Raises ``ValueError`` on an unknown format or a checksum
    mismatch, and ``OSError``/unpickling errors on a missing or
    truncated file; the recovery ladder falls through on any of them."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    fmt = payload.get("format")
    if fmt == 1:  # written before the checksum: nothing to verify
        return 0, payload["saved"]
    if fmt != _EMERGENCY_FORMAT:
        raise ValueError(
            f"unknown emergency checkpoint format in {path}: {fmt!r}")
    saved_bytes = payload["saved_pickle"]
    digest = hashlib.sha256(saved_bytes).hexdigest()
    if digest != payload.get("sha256"):
        raise ValueError(
            f"emergency checkpoint {path} failed checksum verification "
            f"(stored {payload.get('sha256')!r}, computed {digest!r})")
    return int(payload.get("epoch", 0)), pickle.loads(saved_bytes)


def emergency_restore(state, path: str) -> None:
    """Load an emergency snapshot into ``state`` and restore it; its
    keys must be attributes the state registered."""
    epoch, saved = emergency_read(path)
    unknown = [k for k in saved if k not in state._known]
    if unknown:
        raise ValueError(
            f"emergency checkpoint {path} carries unregistered state "
            f"attributes {unknown}; registered: {state._known}")
    state._saved = saved
    state.restore()
    if epoch:
        state._commit_count = max(int(state._commit_count), epoch)
        state._saved_epoch = epoch


def _is_rank0() -> bool:
    return int(os.environ.get(
        "HOROVOD_RANK", os.environ.get("HVD_TPU_RANK", "0")) or 0) == 0


class PreemptionHandler:
    """Installable SIGTERM/SIGINT handler. One per process; installing
    again updates the state and path it writes."""

    def __init__(self) -> None:
        # RLock: the handler runs on the main thread and may interrupt
        # install()/uninstall() inside their critical section
        self._lock = threading.RLock()
        self._installed_signals: dict = {}
        self._state = None
        self._checkpoint_path: Optional[str] = None
        self._on_preempt: Optional[Callable[[], None]] = None
        self._exit: Callable[[int], None] = os._exit
        self._fired = False

    @property
    def installed(self) -> bool:
        return bool(self._installed_signals)

    def install(self, state=None, checkpoint_path: Optional[str] = None,
                signals=(signal.SIGTERM,),
                on_preempt: Optional[Callable[[], None]] = None,
                exit_fn: Optional[Callable[[int], None]] = None) -> bool:
        """Arm the handler. False when signal handlers cannot be
        installed from this thread (only the main thread can)."""
        with self._lock:
            self._state = state
            self._checkpoint_path = checkpoint_path or None
            self._on_preempt = on_preempt
            if exit_fn is not None:
                self._exit = exit_fn
            for sig in signals:
                if (sig in self._installed_signals
                        and signal.getsignal(sig) == self._handle):
                    continue
                try:
                    prev = signal.signal(sig, self._handle)
                except ValueError:  # not the main thread
                    return False
                # a handler installed over ours since keeps our first
                # predecessor as the one to put back
                self._installed_signals.setdefault(sig, prev)
            self._fired = False
            return True

    def uninstall(self) -> None:
        with self._lock:
            for sig, prev in self._installed_signals.items():
                try:
                    signal.signal(sig, prev)
                except ValueError:
                    pass
            self._installed_signals = {}
            self._state = None
            self._checkpoint_path = None
            self._on_preempt = None
            self._exit = os._exit
            self._fired = False

    def _handle(self, signum, frame) -> None:
        # idempotent: the platform may send SIGTERM more than once
        with self._lock:
            if self._fired:
                return
            self._fired = True
            state = self._state
            path = self._checkpoint_path
            on_preempt = self._on_preempt
            exit_fn = self._exit
        LOG.warning("received signal %d: writing the elastic state and "
                    "exiting with preemption code %d", signum,
                    PREEMPTED_EXIT_CODE)
        # no metrics here: the handler may interrupt a holder of the
        # registry's locks; the driver counts the preemption from the
        # exit code
        try:
            if state is not None:
                if path and _is_rank0():
                    emergency_save(state, path)
                else:
                    state.preemption_snapshot()
            if on_preempt is not None:
                on_preempt()
        except Exception as e:
            # the exit code must still say "preempted"
            LOG.error("preemption snapshot failed: %s", e)
        exit_fn(PREEMPTED_EXIT_CODE)


handler = PreemptionHandler()


def install(state=None, checkpoint_path: Optional[str] = None,
            **kwargs) -> bool:
    """Arm the process-wide preemption handler
    (:meth:`PreemptionHandler.install`)."""
    return handler.install(state=state, checkpoint_path=checkpoint_path,
                           **kwargs)


def uninstall() -> None:
    handler.uninstall()
