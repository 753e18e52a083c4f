"""Iteration-level continuous batching for autoregressive decode.

The PyTorch counterpart of the JAX package's ``serving/scheduler.py``,
over :class:`~horovod_tpu_torch.serving.decode.GenerationEngine`. The
batch is rebuilt EVERY token:

* each iteration (1) evicts finished sequences — EOS, length cap or
  deadline — releasing their cache slots at once, (2) admits queued
  prefills into the freed slots without touching co-resident
  sequences, then (3) runs one decode step for every occupied slot;
* admission: a bounded queue (:class:`~.batcher.QueueFull` -> 429),
  per-request deadlines (queued expiry -> :class:`~.batcher.RequestTimeout`
  -> 504; mid-generation expiry ends the stream with
  ``finish_reason="deadline"``) and :class:`~.batcher.Draining` on
  shutdown;
* SLO classes (``interactive`` < ``standard`` < ``batch``): the queue
  admits in (class, deadline) order, and a request arriving at a full
  queue sheds the newest strictly-lower-class queued request instead
  of being rejected;
* streaming: every generated token is pushed to the request's chunk
  queue the iteration it exists.

``clock`` is injectable: tests drive a fake clock and call
:meth:`DecodeScheduler.step_once` directly, without the thread.

Each request records the clock at its first token (``first_token_t``)
and at its end (``done_t``), from which a caller reads time to first
token and time per output token.
"""

from __future__ import annotations

import itertools
import logging
import queue as queue_mod
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import tracing
from .batcher import Draining, QueueFull, RequestTimeout
from .engine import serving_knobs

_log = logging.getLogger(__name__)

#: admission classes, best-first. Lower value = stricter SLO = admitted
#: first and shed last.
SLO_CLASSES = {"interactive": 0, "standard": 1, "batch": 2}

_req_seq = itertools.count(1)


class GenRequest:
    """One submitted generation: future + token stream.

    The scheduler pushes chunk dicts (``{"tokens": [...]}``, then
    ``{"done": True, "finish_reason": ..., "n": ...}``) into a queue; a
    consumer drains them via :meth:`stream` or waits for the whole
    thing via :meth:`result`.
    """

    __slots__ = ("prompt", "max_new", "slo", "slo_name", "enqueue_t",
                 "deadline_t", "req_id", "seq", "tokens",
                 "finish_reason", "first_token_t", "done_t", "_chunks",
                 "_done", "_error")

    def __init__(self, prompt: np.ndarray, max_new: int, slo: str,
                 enqueue_t: float, deadline_t: Optional[float]):
        self.prompt = prompt
        self.max_new = max_new
        self.slo_name = slo
        self.slo = SLO_CLASSES[slo]
        self.enqueue_t = enqueue_t
        self.deadline_t = deadline_t
        self.req_id = tracing.current_request_id()
        self.seq = next(_req_seq)
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.first_token_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self._chunks: "queue_mod.Queue" = queue_mod.Queue()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

    # -- scheduler side ------------------------------------------------------

    def push_tokens(self, toks: Sequence[int]) -> None:
        self.tokens.extend(int(t) for t in toks)
        self._chunks.put({"tokens": [int(t) for t in toks]})

    def finish(self, reason: str) -> None:
        self.finish_reason = reason
        self._chunks.put({"done": True, "finish_reason": reason,
                          "n": len(self.tokens)})
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        self._error = exc
        self._chunks.put({"done": True, "error": str(exc)})
        self._done.set()

    # -- consumer side -------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def stream(self, timeout_s: Optional[float] = None):
        """Yield chunk dicts until the done chunk (inclusive). An error
        BEFORE any token raises; after tokens flowed the stream ends
        with the error chunk."""
        saw_tokens = False
        while True:
            chunk = self._chunks.get(timeout=timeout_s)
            if chunk.get("done") and self._error is not None \
                    and not saw_tokens:
                raise self._error
            yield chunk
            if chunk.get("done"):
                return
            saw_tokens = True

    def result(self, timeout_s: Optional[float] = None):
        """Block for completion; returns ``(tokens, finish_reason)``."""
        if not self._done.wait(timeout_s):
            raise RequestTimeout(
                f"no completion within {timeout_s}s (scheduler stuck?)")
        if self._error is not None:
            raise self._error
        return list(self.tokens), self.finish_reason


class DecodeScheduler:
    """Continuous-batching loop over a ``GenerationEngine``.

    Invariants (tests/test_torch_decode.py):

    * a sequence's token stream is a pure function of its prompt and
      the engine — co-residents, admissions and evictions in other
      slots never perturb it;
    * a freed slot is admittable on the very next iteration;
    * eviction reasons are exactly one of eos / length / deadline /
      shed / drain / error, each counted in :meth:`stats`.
    """

    def __init__(
        self,
        engine,
        *,
        queue_limit: Optional[int] = None,
        default_timeout_s: Optional[float] = None,
        default_max_new: Optional[int] = None,
        stats_every: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        knobs = serving_knobs()
        self._engine = engine
        self._queue_limit = (int(queue_limit) if queue_limit is not None
                             else int(knobs.serving_queue_limit))
        if default_timeout_s is None:
            default_timeout_s = knobs.serving_request_timeout_seconds
        self._default_timeout_s = float(default_timeout_s)
        self._default_max_new = int(
            default_max_new if default_max_new is not None
            else knobs.serving_decode_max_new or 64)
        self._stats_every = int(
            stats_every if stats_every is not None
            else knobs.serving_decode_stats_every or 0)
        self._clock = clock
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[GenRequest] = []
        self._active: Dict[int, GenRequest] = {}  # slot -> request
        S = engine.slots
        self._tokens = np.zeros(S, np.int32)   # last token per slot
        self._lengths = np.zeros(S, np.int32)  # cache rows valid
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._iterations = 0
        self._tokens_out = 0
        self._evictions: Dict[str, int] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "DecodeScheduler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="hvd-decode-scheduler")
            self._thread.start()
        return self

    def close(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop admission; with ``drain`` finish every admitted
        sequence (bounded by its own max_new/deadline) before
        returning, else fail queued AND active immediately."""
        with self._cv:
            self._draining = True
            if not drain:
                for r in self._queue:
                    r.fail(Draining("decode scheduler closed"))
                self._queue.clear()
                for slot, r in list(self._active.items()):
                    self._finish_locked(slot, r, "drain")
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
        elif drain:
            # manual-step mode (tests): run the loop body inline
            deadline = time.monotonic() + timeout_s
            while ((self._queue or self._active)
                   and time.monotonic() < deadline):
                self.step_once()

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def slot_stats(self) -> Dict[str, int]:
        """Slots total, occupied and queued prefills: what tells a
        probe "full" from "wedged"."""
        with self._lock:
            return {"total": int(self._engine.slots),
                    "occupied": len(self._active),
                    "queued_prefills": len(self._queue)}

    def stats(self) -> Dict[str, object]:
        """Iterations, tokens emitted, slot occupancy and evictions by
        reason since construction."""
        with self._lock:
            return {"iterations": self._iterations,
                    "tokens": self._tokens_out,
                    "slots_total": int(self._engine.slots),
                    "slots_occupied": len(self._active),
                    "queued_prefills": len(self._queue),
                    "evictions": dict(self._evictions)}

    # -- admission -----------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        *,
        max_new_tokens: Optional[int] = None,
        timeout_s: Optional[float] = None,
        slo: str = "standard",
    ) -> GenRequest:
        """Admit one generation request; returns its
        :class:`GenRequest`. Raises :class:`QueueFull` /
        :class:`Draining` / ``ValueError`` synchronously."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("generate needs at least one prompt token")
        top_prefill = self._engine.prefill_buckets[-1]
        if (prompt.shape[0] >= self._engine.max_len
                or prompt.shape[0] > top_prefill):
            # can never fit: a client error at admission, not a deep
            # engine failure after the request already cost a slot
            raise ValueError(
                f"prompt of {prompt.shape[0]} tokens exceeds this "
                f"replica's limits (cache max_len "
                f"{self._engine.max_len}, top prefill bucket "
                f"{top_prefill}); truncate client-side or target a "
                "longer-context bucket")
        if slo not in SLO_CLASSES:
            raise ValueError(
                f"unknown slo class {slo!r}; expected one of "
                f"{sorted(SLO_CLASSES)}")
        if timeout_s is None:
            timeout_s = self._default_timeout_s
        if max_new_tokens is None:
            max_new = self._default_max_new
        else:
            max_new = int(max_new_tokens)
            if max_new < 1:
                raise ValueError(
                    f"max_new_tokens must be >= 1, got {max_new}")
        # the cache bounds generation: prompt rows + generated rows
        # must fit max_len (the last token is never written)
        max_new = max(1, min(max_new,
                             self._engine.max_len - prompt.shape[0]))
        now = self._clock()
        r = GenRequest(prompt, max_new, slo, now,
                       now + timeout_s if timeout_s else None)
        with self._cv:
            if self._draining:
                raise Draining("decode scheduler is draining")
            if len(self._queue) >= self._queue_limit:
                victim = self._shed_candidate_locked(r)
                if victim is None:
                    raise QueueFull(
                        f"decode admission queue at capacity "
                        f"({len(self._queue)}/{self._queue_limit} "
                        "requests)")
                self._queue.remove(victim)
                victim.fail(QueueFull(
                    f"shed for an arriving {r.slo_name!r}-class "
                    "request (queue at capacity)"))
                self._count_eviction("shed")
            self._queue.append(r)
            self._cv.notify_all()
        return r

    def _shed_candidate_locked(self, incoming: GenRequest):
        """The queued request to shed for ``incoming``: the NEWEST
        queued request of the LOWEST class strictly below the incoming
        class (None = nothing sheddable)."""
        worst = None
        for r in self._queue:
            if r.slo <= incoming.slo:
                continue
            if (worst is None or r.slo > worst.slo
                    or (r.slo == worst.slo and r.seq > worst.seq)):
                worst = r
        return worst

    # -- the iteration -------------------------------------------------------

    def _count_eviction(self, reason: str) -> None:
        self._evictions[reason] = self._evictions.get(reason, 0) + 1

    def _evict_locked(self, slot: int) -> None:
        self._active.pop(slot, None)
        self._tokens[slot] = 0
        self._lengths[slot] = 0
        self._engine.release_slot(slot)

    def _finish_locked(self, slot: int, r: GenRequest,
                       reason: str) -> None:
        r.done_t = self._clock()
        r.finish(reason)
        self._count_eviction(reason)
        self._evict_locked(slot)

    def step_once(self) -> bool:
        """One scheduler iteration: expire, evict, admit, decode.
        Returns whether any work happened."""
        now = self._clock()
        admitted: List[tuple] = []  # (slot, request)
        with self._cv:
            # queued requests past their deadline fail with a timeout
            # (504); they never cost a slot
            for r in [q for q in self._queue
                      if q.deadline_t is not None and now > q.deadline_t]:
                self._queue.remove(r)
                r.fail(RequestTimeout(
                    f"request expired after {now - r.enqueue_t:.3f}s "
                    "in the decode admission queue"))
                self._count_eviction("deadline")
            # active sequences past deadline end with what they have
            for slot, r in list(self._active.items()):
                if r.deadline_t is not None and now > r.deadline_t:
                    self._finish_locked(slot, r, "deadline")
            # admit queued prefills into freed slots, best class /
            # earliest deadline first
            while self._queue:
                slot = self._engine.claim_slot()
                if slot is None:
                    break
                r = min(self._queue,
                        key=lambda q: (q.slo,
                                       q.deadline_t
                                       if q.deadline_t is not None
                                       else float("inf"),
                                       q.seq))
                self._queue.remove(r)
                self._active[slot] = r
                admitted.append((slot, r))
        # prefills run outside the scheduler lock (submit must not
        # block on compute; the engine serializes execution itself)
        for slot, r in admitted:
            try:
                first, _ = self._engine.prefill(slot, r.prompt)
            except Exception as e:  # noqa: BLE001 — fail only this one
                with self._cv:
                    r.fail(e)
                    self._count_eviction("error")
                    self._evict_locked(slot)
                continue
            with self._cv:
                if slot not in self._active:
                    continue  # evicted between admit and prefill
                r.first_token_t = self._clock()
                self._tokens[slot] = first
                self._lengths[slot] = r.prompt.shape[0]
                r.push_tokens([first])
                self._tokens_out += 1
                if (self._engine.eos_id is not None
                        and first == self._engine.eos_id):
                    self._finish_locked(slot, r, "eos")
                elif len(r.tokens) >= r.max_new:
                    self._finish_locked(slot, r, "length")
        # one decode iteration for every occupied slot
        with self._lock:
            active = dict(self._active)
            tokens = self._tokens.copy()
            lengths = self._lengths.copy()
        did_decode = False
        if active:
            nxt, _ = self._engine.decode(tokens, lengths)
            did_decode = True
            with self._cv:
                for slot, r in list(self._active.items()):
                    if slot not in active:
                        continue  # admitted after the snapshot
                    tok = int(nxt[slot])
                    self._tokens[slot] = tok
                    self._lengths[slot] += 1
                    r.push_tokens([tok])
                    self._tokens_out += 1
                    if (self._engine.eos_id is not None
                            and tok == self._engine.eos_id):
                        self._finish_locked(slot, r, "eos")
                    elif (len(r.tokens) >= r.max_new
                          or self._lengths[slot]
                          >= self._engine.max_len):
                        self._finish_locked(slot, r, "length")
        with self._lock:
            self._iterations += 1
            iterations = self._iterations
        if self._stats_every and iterations % self._stats_every == 0:
            _log.info("decode stats %s", self.stats())
        return bool(admitted) or did_decode

    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._draining and not self._queue and not self._active:
                    return
                if not self._queue and not self._active:
                    self._cv.wait(0.05)
                    continue
            try:
                self.step_once()
            except Exception as e:  # noqa: BLE001 — the loop must live
                # an engine-level failure poisons every resident
                # sequence; fail them rather than hang their clients
                _log.exception("decode iteration failed")
                with self._cv:
                    for slot, r in list(self._active.items()):
                        r.fail(e)
                        self._count_eviction("error")
                        self._evict_locked(slot)
