"""Deadline-aware dynamic batching behind a bounded admission queue.

The PyTorch counterpart of the JAX package's ``serving/batcher.py``.
The engine (engine.py) executes fixed-bucket batches; this module
manufactures them from a stream of small independent requests. A
single worker thread holds the first request of a window open for
``max_wait_ms`` of co-arrivals, cuts the batch at ``max_batch``
examples, runs the model once, and fans results back out to
per-request futures.

Contract points:

* admission is **bounded** (``queue_limit`` pending examples) — beyond
  it ``submit`` raises :class:`QueueFull` immediately instead of
  building unbounded latency (the front end maps it to HTTP 429);
* every request carries a **deadline**; a request that expires while
  queued completes with :class:`RequestTimeout` and never wastes a
  bucket slot;
* requests of different example shapes or dtypes never share a batch;
* ``close(drain=True)`` is the preemption path (elastic/preemption.py
  SIGTERM handler): admission stops (:class:`Draining`), the wait
  window collapses to zero, and every in-flight request flushes before
  the call returns — drain-then-exit, not drop-then-exit.

The ``serving.admit`` fault point fires inside ``submit``. The decode
scheduler (scheduler.py) raises the same three admission errors, with
the same HTTP mapping. Each request's queue wait and its time to the
answer (its TTFT: a one-shot answer is its first token) land in the
metrics; each batch is a ``SERVING_EXEC`` timeline span keyed by the
batcher, and a ``serving_batch`` (or ``serving_batch_error``) flight
record naming the request ids it carried, so a slow request can be
followed into the batch that served it.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..utils import faults, flight, metrics
from ..utils.timeline import active_timeline
from . import tracing
from .engine import serving_knobs

SERVING_EXEC = "SERVING_EXEC"  # timeline activity around a batch run

# a batcher's timeline span key: two batchers in one process (in-process
# replicas, tests) must not share an open span
_batcher_seq = itertools.count(1)


class QueueFull(RuntimeError):
    """Admission queue at capacity — shed load now, retry later (429)."""


class Draining(RuntimeError):
    """The server is draining for shutdown; no new admissions (503)."""


class RequestTimeout(TimeoutError):
    """The request's deadline expired before results arrived (504)."""


class _Pending:
    __slots__ = ("x", "n", "enqueue_t", "deadline_t", "req_id",
                 "_event", "_result", "_error")

    def __init__(self, x: np.ndarray, enqueue_t: float,
                 deadline_t: Optional[float]):
        self.x = x
        self.n = x.shape[0]
        self.enqueue_t = enqueue_t
        self.deadline_t = deadline_t
        # trace id bound by the HTTP handler (serving/tracing.py);
        # carried on the pending because the worker thread that
        # executes the batch runs outside the request's context
        self.req_id = tracing.current_request_id()
        self._event = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    # future surface ---------------------------------------------------------

    def set_result(self, y: np.ndarray) -> None:
        self._result = y
        self._event.set()

    def set_error(self, e: BaseException) -> None:
        self._error = e
        self._event.set()

    def result(self, timeout_s: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout_s):
            raise RequestTimeout(
                f"no result within {timeout_s}s (queue stuck?)")
        if self._error is not None:
            raise self._error
        return self._result


class DynamicBatcher:
    """Coalesce requests into covering batches for ``run_fn``.

    ``run_fn(x)`` gets a ``[n, ...]`` array with ``n <= max_batch`` and
    returns ``[n, ...]`` results in order (the engine pads to its
    bucket internally). ``clock`` is injectable for deterministic tests.
    """

    def __init__(
        self,
        run_fn: Callable[[np.ndarray], np.ndarray],
        *,
        max_batch: int = 0,
        max_wait_ms: Optional[float] = None,
        queue_limit: Optional[int] = None,
        default_timeout_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        knobs = serving_knobs()
        self._run = run_fn
        self._max_batch = int(max_batch) or 64
        if max_wait_ms is None:
            max_wait_ms = knobs.serving_max_wait_ms
        self._max_wait_s = max(float(max_wait_ms), 0.0) / 1e3
        self._queue_limit = (int(queue_limit) if queue_limit is not None
                             else int(knobs.serving_queue_limit))
        if default_timeout_s is None:
            default_timeout_s = knobs.serving_request_timeout_seconds
        self._default_timeout_s = float(default_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[_Pending] = []
        self._queued_examples = 0
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._span_key = f"serving_batch#{next(_batcher_seq)}"

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "DynamicBatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="hvd-serving-batcher")
            self._thread.start()
        return self

    def close(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop admission; with ``drain`` flush everything already
        queued (the wait window collapses to zero once draining) before
        stopping the worker, else fail queued requests immediately."""
        with self._cv:
            self._draining = True
            if not drain:
                for p in self._queue:
                    p.set_error(Draining("batcher closed"))
                self._queue.clear()
                self._queued_examples = 0
            self._cv.notify_all()
        if self._thread is not None:
            # the worker flushes remaining batches back-to-back (the
            # draining flag skips the co-arrival wait) and exits once
            # the queue is empty
            self._thread.join(timeout=timeout_s)

    @property
    def pending(self) -> int:
        with self._lock:
            return self._queued_examples

    # -- admission ----------------------------------------------------------

    def submit(self, x: np.ndarray,
               timeout_s: Optional[float] = None) -> _Pending:
        """Admit one request (``[n, ...]`` examples); returns its
        future. Raises :class:`QueueFull` / :class:`Draining` /
        :class:`~horovod_tpu_torch.utils.faults.InjectedFault`
        synchronously."""
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(f"submit needs [n, ...] input, got {x.shape}")
        if x.shape[0] > self._queue_limit:
            # bigger than the queue can EVER hold: a client error
            # (reject permanently, 400), not backpressure — a 429 would
            # send the dispatch tier retrying a request that can never
            # succeed across every replica
            raise ValueError(
                f"request of {x.shape[0]} examples exceeds this "
                f"replica's admission capacity ({self._queue_limit}); "
                "split the batch client-side")
        faults.inject("serving.admit", n=x.shape[0])
        if timeout_s is None:
            timeout_s = self._default_timeout_s
        now = self._clock()
        p = _Pending(x, now, now + timeout_s if timeout_s else None)
        with self._cv:
            if self._draining:
                raise Draining("serving replica is draining")
            if self._queued_examples + p.n > self._queue_limit:
                raise QueueFull(
                    f"admission queue at capacity "
                    f"({self._queued_examples}/{self._queue_limit} examples)")
            self._queue.append(p)
            self._queued_examples += p.n
            self._cv.notify_all()
        return p

    def __call__(self, x: np.ndarray,
                 timeout_s: Optional[float] = None) -> np.ndarray:
        """Blocking convenience: submit + wait for the result."""
        if timeout_s is None:
            timeout_s = self._default_timeout_s
        # the worker enforces the queue-side deadline; the +1s margin
        # covers result delivery so a stuck worker still unblocks us
        return self.submit(x, timeout_s).result(
            timeout_s + 1.0 if timeout_s else None)

    # -- worker -------------------------------------------------------------

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block until a batch is ready (first arrival + wait window /
        max_batch / drain); None once draining and empty."""
        with self._cv:
            while not self._queue:
                if self._draining:
                    return None
                self._cv.wait(0.1)
            first_t = self._clock()
            cutoff = first_t + self._max_wait_s
            while (self._queued_examples < self._max_batch
                   and not self._draining):
                remaining = cutoff - self._clock()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            # coalesce only shape/dtype-compatible requests: one
            # concatenated array feeds one graph, so a request with a
            # different example shape (or a dtype that would silently
            # upcast its batchmates) forms its OWN batch next iteration
            head = self._queue[0]
            sig = (head.x.shape[1:], head.x.dtype)
            batch: List[_Pending] = [self._queue.pop(0)]
            total = head.n
            i = 0
            while i < len(self._queue):
                p = self._queue[i]
                if (p.x.shape[1:], p.x.dtype) != sig:
                    i += 1
                    continue
                if total + p.n > self._max_batch:
                    break
                batch.append(self._queue.pop(i))
                total += p.n
            self._queued_examples -= total
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            now = self._clock()
            live: List[_Pending] = []
            for p in batch:
                if p.deadline_t is not None and now > p.deadline_t:
                    if p.req_id:
                        flight.record("serving_timeout", p.req_id,
                                      queued_s=round(now - p.enqueue_t, 4))
                    p.set_error(RequestTimeout(
                        f"request expired after {now - p.enqueue_t:.3f}s "
                        "in the admission queue"))
                else:
                    metrics.record_serving_queue_wait(now - p.enqueue_t)
                    live.append(p)
            if not live:
                continue
            x = (live[0].x if len(live) == 1
                 else np.concatenate([p.x for p in live], axis=0))
            # which request ids rode this batch (gathered only when a
            # timeline or the flight recorder will read them)
            tl = active_timeline()
            ids = ([p.req_id for p in live if p.req_id]
                   if (tl is not None or flight.enabled()) else [])
            if ids:
                flight.record("serving_batch", ids[0], ids=ids,
                              n=int(x.shape[0]))
            if tl is not None:
                tl.activity_start(self._span_key, SERVING_EXEC,
                                  args={"ids": ids, "n": int(x.shape[0])})
            try:
                y = self._run(x)
            except BaseException as e:
                if ids:
                    flight.record("serving_batch_error", ids[0], ids=ids,
                                  error=str(e)[:120])
                for p in live:
                    p.set_error(e)
                continue
            finally:
                if tl is not None:
                    tl.activity_end(self._span_key, SERVING_EXEC)
            off = 0
            done_t = self._clock()
            for p in live:
                p.set_result(np.asarray(y)[off:off + p.n])
                off += p.n
                # a one-shot answer is its first token: TTFT is enqueue
                # to result, billed to the default "standard" class
                metrics.record_serving_ttft(done_t - p.enqueue_t)
