"""Data loader base classes and the device placement of batches.

The port of ``horovod_tpu/data/data_loader_base.py`` (reference
horovod/data/data_loader_base.py): ``BaseDataLoader`` (the iteration
contract), ``AsyncDataLoaderMixin`` (a background thread filling a
bounded queue; ``close()`` drains it), ``ShardedDataLoader`` and
``device_prefetch``. Where the JAX loader places a host batch on the
mesh with a named sharding, the port's world is one process a card:
``ShardedDataLoader`` puts a rank's rows on its device, the rows of its
coordinate on the mesh's data axes when given a ``mesh`` (each batch
then the global one). ``device_prefetch`` keeps
``size`` batches in flight: each copied into pinned host memory and on
to the card by a ``non_blocking`` copy on a side stream, whose event the
consuming stream waits on.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch


class BaseDataLoader:
    """Iteration contract (reference BaseDataLoader)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def _iterate(self) -> Iterator[Any]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Any]:
        return self._iterate()


class AsyncDataLoaderMixin:
    """Prefetch batches on a background thread through a bounded queue
    (reference AsyncDataLoaderMixin: async_loader_queue_size).

    Mix in *before* the loader class:
        class AsyncLoader(AsyncDataLoaderMixin, MyLoader): ...
    """

    def __init__(self, *args, async_loader_queue_size: int = 4, **kwargs):
        self._async_queue_size = async_loader_queue_size
        self._async_queue: Optional[queue.Queue] = None
        self._async_thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        super().__init__(*args, **kwargs)

    _END = object()

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer closed the loader
        (an abandoned iteration must not pin the fill thread forever)."""
        while not self._closed.is_set():
            try:
                self._async_queue.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        try:
            for item in super()._iterate():
                if not self._put(item):
                    return
            self._put(self._END)
        except BaseException as e:  # surface loader errors to the consumer
            self._put((self._END, e))

    def _iterate(self) -> Iterator[Any]:
        if self._async_queue_size <= 0:
            yield from super()._iterate()
            return
        self._async_queue = queue.Queue(maxsize=self._async_queue_size)
        self._closed.clear()
        self._async_thread = threading.Thread(target=self._fill, daemon=True)
        self._async_thread.start()
        try:
            while True:
                item = self._async_queue.get()
                if item is self._END:
                    break
                if (
                    isinstance(item, tuple) and len(item) == 2
                    and item[0] is self._END
                ):
                    raise item[1]
                yield item
        finally:
            # break/exception in the consumer: release the fill thread
            self.close()

    def close(self) -> None:
        """Stop the prefetch thread, draining the queue."""
        self._closed.set()
        if self._async_queue is not None:
            while True:
                try:
                    self._async_queue.get_nowait()
                except queue.Empty:
                    break
        if self._async_thread is not None:
            self._async_thread.join(timeout=5)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaf_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x))


def _default_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    from ..core import basics

    return basics.device() if basics.is_initialized() else \
        torch.device("cpu")


class ShardedDataLoader(BaseDataLoader):
    """Wrap an iterable of host batches (arrays, tensors, or
    dicts/lists/tuples of them), placing each on ``device`` (default:
    the rank's, ``hvd.device()``, after ``init()``; else the CPU).

    Without ``mesh`` each batch is this rank's own rows. With ``mesh``
    (a ``parallel.mesh.Mesh``) each batch is the global batch and the
    rank keeps its rows of every leaf (dimension 0): the block at its
    row-major position over ``axis`` (an axis name or a tuple of them;
    default the mesh's live data axes, dp and fsdp), as the JAX
    package's loader shards the batch dimension over the axis. Ranks
    that differ only in tp or sp get the same rows."""

    def __init__(self, source, mesh=None, axis=None, device=None):
        self._source = source
        self._mesh = mesh
        if mesh is not None and axis is None:
            from ..parallel.mesh import data_axes

            axis = data_axes(mesh)
        self._axes = (axis,) if isinstance(axis, str) else tuple(axis or ())
        self._device = device

    def __len__(self) -> int:
        return len(self._source)

    def _rows(self, x):
        mesh = self._mesh
        n = math.prod(mesh.axis_size(a) for a in self._axes)
        if n == 1 or x.dim() == 0:  # a scalar has no rows to split
            return x
        if x.shape[0] % n:
            raise ValueError(
                f"a leaf of {x.shape[0]} rows does not split over the "
                f"{n} ranks of mesh axes {self._axes}")
        k = x.shape[0] // n
        i = mesh.group_index(self._axes)
        return x[i * k:(i + 1) * k]

    def _iterate(self):
        dev = _default_device(self._device)
        for batch in self._source:
            yield _tree_map(
                lambda x: self._rows(_leaf_tensor(x)).to(dev)
                if self._mesh is not None else _leaf_tensor(x).to(dev),
                batch)


def device_prefetch(iterator, device=None, size: int = 2):
    """Keep ``size`` batches in flight to ``device`` (default: the
    rank's) ahead of the consumer, so the host-to-card copy overlaps the
    current step's compute: each leaf is copied into pinned host memory
    and on by a ``non_blocking`` copy on a side stream, and the stream
    that consumes the batch waits on the copy's event. On the CPU the
    batches are just converted to tensors. ``size <= 0`` places each
    batch when it is consumed.

        for batch in device_prefetch(iter(loader), size=2):
            loss = step(batch)
    """
    import collections

    dev = _default_device(device)
    if dev.type != "cuda":
        for b in iterator:
            yield _tree_map(lambda x: _leaf_tensor(x).to(dev), b)
        return
    side = torch.cuda.Stream(dev)

    def put(b):
        with torch.cuda.stream(side):
            out = _tree_map(
                lambda x: _leaf_tensor(x).pin_memory().to(
                    dev, non_blocking=True), b)
            ev = torch.cuda.Event()
            ev.record(side)
        return out, ev

    def take(item):
        out, ev = item
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(ev)
        # allocated on the side stream, used on the consumer's: the
        # allocator must not hand the memory out again before the
        # consumer is done with it
        _tree_map(lambda t: t.record_stream(consumer), out)
        return out

    buf = collections.deque()
    if size <= 0:
        for b in iterator:
            yield take(put(b))
        return
    for b in iterator:
        buf.append(put(b))
        if len(buf) >= size:
            yield take(buf.popleft())
    while buf:
        yield take(buf.popleft())
