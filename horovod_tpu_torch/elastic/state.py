"""Elastic state: commit / restore / sync across world changes.

The port of ``horovod_tpu/elastic/state.py`` (reference
common/elastic.py:26 ``State`` and ``ObjectState``, torch/elastic/
state.py:27 ``TorchState``, and the ``run_fn`` wrapper,
common/elastic.py:151, that catches ``HorovodInternalError`` to restore
and re-initialize, and ``HostsUpdatedInterrupt`` to re-sync):

* :class:`State` (``:53`` there): ``commit()`` runs the ``worker`` fault
  point, snapshots, hands the snapshot to the replicator and raises
  ``HostsUpdatedInterrupt`` when the driver said the host set changed;
* :class:`ObjectState` (``:103``): plain attributes, snapshot by
  deepcopy, sync by rank 0's ``broadcast_object``;
* :class:`TorchState`, in place of the JAX ``TpuState`` (``:140``; the
  reference Horovod's name): ``nn.Module``, optimizer and tensor
  attributes beside plain values. ``save()`` copies each to host memory
  (pinned, for a tensor on the card) as :class:`HostTensor`s, dtype,
  shape and raw bytes, so bf16 survives bit for bit and a replica's
  pickle ships each tensor as one out-of-band buffer; ``restore()``
  writes a module's and a tensor's bytes back in place on the device
  (a module's gradients are dropped) and loads an optimizer's state
  dict; ``sync()`` broadcasts each from rank 0 (``broadcast_parameters``,
  ``broadcast_optimizer_state``, ``broadcast_``, ``broadcast_object``).
  ``TpuState`` is an alias, so a JAX script's spelling finds it.

  Its tensors change in place inside a step (``optimizer.step()`` writes
  one parameter after another), so a snapshot taken at an arbitrary
  moment could be torn. The preemption handler therefore writes the
  last ``commit()``'s snapshot and takes no new one
  (:meth:`State.preemption_snapshot`); an ``ObjectState``, whose
  attributes are replaced whole, is snapshotted anew as in the JAX
  package;
* :func:`run` (``:199``) and ``_reinitialize`` (``:271``):
  ``shutdown()`` then ``init()`` on the same device kind; shutdown drops
  the process sets (the two-level wire's block sets among them) and
  detaches every ``DistributedOptimizer`` of the old world, so a
  ``train`` function builds its optimizer wrapper again.
"""

from __future__ import annotations

import copy
import os
import threading
import warnings
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..core.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from ..utils import faults
from . import replication


class _HostUpdateFlag:
    """Worker-side mailbox the notification service sets when the host
    set changes (reference WorkerNotificationManager)."""

    def __init__(self) -> None:
        self._updated = threading.Event()
        self._timestamp = 0

    def signal(self) -> None:
        self._timestamp += 1
        self._updated.set()

    def consume(self) -> bool:
        was = self._updated.is_set()
        self._updated.clear()
        return was


host_update_flag = _HostUpdateFlag()


class HostTensor:
    """A tensor's value in host memory: its dtype's name, its shape and
    its bytes as a uint8 numpy array. Pickles through the array, so
    protocol 5 carries the bytes out of band."""

    __slots__ = ("dtype", "shape", "data")

    def __init__(self, dtype: str, shape, data: np.ndarray):
        self.dtype = dtype
        self.shape = tuple(shape)
        self.data = data

    def __reduce__(self):
        return (HostTensor, (self.dtype, self.shape, self.data))

    @staticmethod
    def start(t: torch.Tensor) -> "HostTensor":
        """Start copying ``t`` to the host: a pinned buffer and a
        non-blocking copy for a tensor on the card (read it only after
        the stream is synchronized), a plain copy otherwise."""
        t = t.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
        else:
            host = t.clone(memory_format=torch.contiguous_format)
        return HostTensor(str(t.dtype).rsplit(".", 1)[-1], t.shape,
                          host.reshape(-1).view(torch.uint8).numpy())

    def tensor(self, copy: bool = False) -> torch.Tensor:
        """The value as a CPU tensor over these bytes (``copy``: its own
        writable memory)."""
        with warnings.catch_warnings():
            # bytes unpickled from a buffer are read-only; the view is
            # only read (copied onto the device or cloned)
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.from_numpy(self.data)
        out = flat.view(getattr(torch, self.dtype)).reshape(self.shape)
        return out.clone() if copy else out


def _to_host(obj, pending: List[bool]):
    """``obj`` with every tensor replaced by a :class:`HostTensor`
    (dicts, lists and tuples walked), other leaves deep-copied;
    ``pending`` gets an entry when a copy from the card is in flight."""
    if torch.is_tensor(obj):
        if obj.is_cuda:
            pending.append(True)
        return HostTensor.start(obj)
    if isinstance(obj, dict):
        return {k: _to_host(v, pending) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, pending) for v in obj)
    return copy.deepcopy(obj)


def _from_host(obj):
    """The inverse of :func:`_to_host`, into writable CPU tensors."""
    if isinstance(obj, HostTensor):
        return obj.tensor(copy=True)
    if isinstance(obj, dict):
        return {k: _from_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_host(v) for v in obj)
    return copy.deepcopy(obj)


class State:
    """Base elastic state (common/elastic.py:26)."""

    def __init__(self, **kwargs: Any) -> None:
        self._reset_callbacks: List[Callable] = []
        self._commit_count = 0
        # the commit epoch of the snapshot in _saved
        self._saved_epoch = 0

    def register_reset_callbacks(self, callbacks: List[Callable]) -> None:
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        for cb in self._reset_callbacks:
            cb()

    def commit(self) -> None:
        """Snapshot the state and surface pending host updates
        (common/elastic.py:60)."""
        # the in-worker chaos hook: `worker:kill:rank=R:step=N` dies at
        # this rank's Nth commit (utils/faults.py)
        self._commit_count += 1
        if faults.enabled():
            faults.inject(
                "worker",
                rank=int(os.environ.get("HOROVOD_RANK", "0") or 0),
                step=self._commit_count)
        self.save()
        self._saved_epoch = self._commit_count
        # async peer replication: a reference hand-off when on, one
        # predicted branch when off
        replication.on_commit(self)
        self.check_host_updates()

    def check_host_updates(self) -> None:
        if host_update_flag.consume():
            raise HostsUpdatedInterrupt(skip_sync=False)

    def preemption_snapshot(self) -> int:
        """What the preemption handler writes: snapshot now and return
        the epoch to stamp it with."""
        self.save()
        return self._commit_count

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError


class ObjectState(State):
    """Elastic state of plain Python attributes (common/elastic.py:118):
    snapshot by deepcopy, sync by rank 0's broadcast_object."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._saved: Dict[str, Any] = {}
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._known = list(kwargs)
        self.save()

    def register(self, name: str) -> None:
        """Track an attribute added after construction (the elastic
        callbacks' batch and epoch cursors)."""
        if name not in self._known:
            self._known.append(name)
            self._saved[name] = copy.deepcopy(getattr(self, name))

    def save(self) -> None:
        # one rebind: a handler that interrupts save() sees the previous
        # snapshot whole
        self._saved = {k: copy.deepcopy(getattr(self, k))
                       for k in self._known}

    def restore(self) -> None:
        for k, v in self._saved.items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self) -> None:
        from ..optim.functions import broadcast_object

        values = {k: getattr(self, k) for k in self._known}
        values = broadcast_object(values, root_rank=0)
        for k, v in values.items():
            setattr(self, k, v)
        self.save()


def _kind(v: Any) -> str:
    if isinstance(v, torch.nn.Module):
        return "module"
    if torch.is_tensor(v):
        return "tensor"
    if all(hasattr(v, a) for a in ("param_groups", "state_dict",
                                   "load_state_dict")):
        return "optimizer"
    return "object"


class TorchState(ObjectState):
    """Elastic state of modules, optimizers, tensors and plain values
    (reference torch/elastic/state.py:27; see the module docstring)."""

    def __init__(self, **kwargs: Any) -> None:
        self._kinds: Dict[str, str] = {k: _kind(v)
                                       for k, v in kwargs.items()}
        super().__init__(**kwargs)

    def register(self, name: str) -> None:
        if name not in self._known:
            self._kinds[name] = _kind(getattr(self, name))
            self._known.append(name)
            saved = dict(self._saved)
            saved[name] = self._snapshot(name)
            self._saved = saved

    def _snapshot(self, k: str, pending=None):
        v = getattr(self, k)
        kind = self._kinds[k]
        own = pending is None
        pending = [] if own else pending
        if kind == "module":
            out = _to_host(dict(v.state_dict()), pending)
        elif kind == "optimizer":
            out = _to_host(v.state_dict(), pending)
        else:
            out = _to_host(v, pending)
        if own and pending:
            torch.cuda.synchronize()
        return out

    def save(self) -> None:
        pending: List[bool] = []
        saved = {k: self._snapshot(k, pending) for k in self._known}
        if pending:
            torch.cuda.synchronize()
        self._saved = saved

    def preemption_snapshot(self) -> int:
        # the tensors may be half-way through an in-place update: write
        # the last commit, never a new snapshot
        return self._saved_epoch

    def restore(self) -> None:
        for k, saved in self._saved.items():
            kind = self._kinds[k]
            v = getattr(self, k)
            if kind == "module":
                with torch.no_grad():
                    for name, t in v.state_dict().items():
                        t.copy_(saved[name].tensor())
                v.zero_grad(set_to_none=True)
            elif kind == "optimizer":
                v.load_state_dict(_from_host(saved))
            elif kind == "tensor":
                with torch.no_grad():
                    v.copy_(saved.tensor())
            else:
                setattr(self, k, copy.deepcopy(saved))

    def sync(self) -> None:
        from ..ops.collectives import broadcast_
        from ..optim.functions import (broadcast_object,
                                       broadcast_optimizer_state,
                                       broadcast_parameters)

        for k in self._known:
            v = getattr(self, k)
            kind = self._kinds[k]
            if kind == "module":
                broadcast_parameters(v.state_dict(), root_rank=0)
            elif kind == "optimizer":
                broadcast_optimizer_state(v, root_rank=0)
            elif kind == "tensor":
                with torch.no_grad():
                    broadcast_(v, 0)
            else:
                setattr(self, k, broadcast_object(v, root_rank=0))
        self.save()


#: the JAX package's name for the framework state
TpuState = TorchState


def run(func: Callable) -> Callable:
    """Elastic run wrapper (common/elastic.py:151 run_fn).

    ``@hvd.elastic.run`` around a ``train(state, ...)`` function: on
    ``HorovodInternalError`` restore the last commit, re-initialize and
    retry; on ``HostsUpdatedInterrupt`` re-initialize (unless it skips
    the sync) and re-sync. On entry it arms the preemption handler
    (``HOROVOD_PREEMPTION``, default on) and runs the recovery ladder
    (``HOROVOD_RECOVERY_LADDER``, default on)."""

    def wrapper(state: State, *args: Any, **kwargs: Any):
        from ..core.state import global_state
        from ..utils import metrics

        knobs = global_state().knobs
        if knobs.preemption_enabled:
            from . import preemption

            preemption.install(
                state=state,
                checkpoint_path=knobs.emergency_checkpoint or None)
        if knobs.recovery_ladder:
            replication.run_recovery_ladder(
                state, emergency_path=knobs.emergency_checkpoint or None,
                orbax_restore=getattr(state, "orbax_restore", None))
        reset_limit = knobs.reset_limit
        resets = 0
        notify_needed = False
        while True:
            try:
                if notify_needed:
                    state.on_reset()
                    notify_needed = False
                if resets:  # re-sync after a world change
                    metrics.record_elastic_event("sync")
                state.sync()
                return func(state, *args, **kwargs)
            except HorovodInternalError:
                metrics.record_elastic_event("reset")
                # the survivor's own host memory: the ladder's top rung
                metrics.record_recovery_rung("local")
                state.restore()
                _reinitialize()
                notify_needed = True
            except HostsUpdatedInterrupt as e:
                metrics.record_elastic_event("hosts_updated")
                if not e.skip_sync:
                    _reinitialize()
                notify_needed = True
            resets += 1
            if reset_limit and resets >= reset_limit:
                raise RuntimeError(
                    f"elastic reset limit {reset_limit} reached")

    return wrapper


def _reinitialize() -> None:
    """Tear down and join the world again on the same kind of device
    (elastic.py:171-173: shutdown + init)."""
    from ..core import basics
    from ..core.state import global_state

    dev = global_state().device
    basics.shutdown()
    basics.init(device="cpu" if dev is not None and dev.type == "cpu"
                else None)
