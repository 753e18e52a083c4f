"""Shared control-plane retry policy: exponential backoff + jitter,
monotonic-clock deadlines, injectable clock/sleep for tests.

The port of the JAX package's ``utils/retry.py``. The launcher's HTTP
key/value store client (``runner/http/http_client.py``) runs every verb
under :func:`default_policy`, so one transient ECONNRESET or 5xx from a
restarting rendezvous server does not kill a worker mid-bootstrap, and
backoff behaviour (and its telemetry: ``hvd_retries_total`` /
``hvd_retry_giveups_total`` by call point) is uniform and testable with
a fake clock.

Deliberately NOT used on the data plane: a collective that failed in
``torch.distributed`` is not retried, since retrying it would
desynchronize the ranks' order of collectives.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

from . import metrics as _metrics


class Deadline:
    """A monotonic-clock deadline: immune to wall-clock steps (NTP
    slew, manual `date -s`) that broke every `time.time() + timeout`
    loop in the control plane. ``timeout_s=None`` never expires."""

    def __init__(self, timeout_s: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._timeout = timeout_s
        self._t0 = clock()

    def remaining(self) -> float:
        if self._timeout is None:
            return float("inf")
        return self._timeout - (self._clock() - self._t0)

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def elapsed(self) -> float:
        return self._clock() - self._t0


def _default_retryable(exc: BaseException) -> bool:
    """Transport-shaped failures retry; everything else propagates.
    OSError covers ConnectionError/TimeoutError/socket errors and
    urllib's URLError (an OSError subclass)."""
    return isinstance(exc, (OSError, EOFError))


class RetryPolicy:
    """Exponential backoff with jitter and an overall deadline.

    Two jitter disciplines (``jitter=``):

    * ``"bounded"`` — the historical ±``jitter_frac`` symmetric band
      around the exponential delay. Fine for one isolated caller;
      useless against synchronized fleets: after a rendezvous failover
      every host computes the SAME schedule ±25%, so hundreds of
      reconnects land on the root in tight waves (thundering herd).
    * ``"full"`` — AWS-style full jitter: the delay is uniform on
      ``[0, exp_backoff]``, spreading a fleet's retries across the
      whole backoff window. The shared :func:`default_policy` uses
      this (``HOROVOD_RETRY_JITTER=bounded`` restores the old band).

    ``max_elapsed_s`` is a shared cap on TOTAL elapsed time across
    attempts, applied even when no per-call ``deadline_s`` was given —
    the fleet-wide bound that keeps a reconnect storm finite
    (``HOROVOD_RETRY_MAX_ELAPSED``; <=0 disables).

    All time arithmetic runs on an injectable monotonic ``clock`` and
    ``sleep`` so tests exercise the exact schedule with zero real
    waiting (tests/test_torch_faults.py). ``seed`` pins the jitter sequence.
    """

    def __init__(
        self,
        max_attempts: int = 5,
        base_delay_s: float = 0.1,
        max_delay_s: float = 2.0,
        multiplier: float = 2.0,
        jitter_frac: float = 0.25,
        deadline_s: Optional[float] = None,
        retryable: Optional[Callable[[BaseException], bool]] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        seed: Optional[int] = None,
        record_metrics: bool = True,
        jitter: str = "bounded",
        max_elapsed_s: Optional[float] = None,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if jitter not in ("bounded", "full"):
            raise ValueError(f"unknown jitter mode {jitter!r}")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.jitter_frac = float(jitter_frac)
        self.deadline_s = deadline_s
        self.retryable = retryable or _default_retryable
        self.clock = clock
        self.sleep = sleep
        self.seed = seed
        self.jitter = jitter
        self.max_elapsed_s = (
            float(max_elapsed_s)
            if max_elapsed_s and max_elapsed_s > 0 else None)
        # record_metrics=False is for callers that may run inside a
        # signal handler: the metrics registry locks must never be
        # touched there (a handler that interrupts their holder would
        # deadlock on them).
        self.record_metrics = record_metrics

    def delay_for_attempt(self, attempt: int,
                          rng: Optional[random.Random] = None) -> float:
        """Backoff before retry number ``attempt`` (1-based): full
        jitter draws uniformly on [0, exp_backoff]; bounded jitters
        symmetrically by ±jitter_frac."""
        d = min(
            self.base_delay_s * (self.multiplier ** (attempt - 1)),
            self.max_delay_s,
        )
        if rng is not None:
            if self.jitter == "full":
                d *= rng.random()
            elif self.jitter_frac:
                d *= 1.0 + self.jitter_frac * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)

    def call(self, fn: Callable, *args, point: str = "",
             retryable: Optional[Callable[[BaseException], bool]] = None,
             **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying retryable failures.

        ``point`` labels the retry/giveup counters in the metrics
        registry (e.g. "http.put"). Gives up — re-raising the last
        failure — after ``max_attempts`` tries or when the monotonic
        ``deadline_s`` budget is spent, whichever comes first.
        """
        is_retryable = retryable or self.retryable
        budget = self.deadline_s
        if self.max_elapsed_s is not None:
            # the shared cap binds even deadline-less callers, and
            # tightens any caller deadline that exceeds it
            budget = (self.max_elapsed_s if budget is None
                      else min(budget, self.max_elapsed_s))
        deadline = Deadline(budget, clock=self.clock)
        rng = random.Random(self.seed)
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                if not is_retryable(e):
                    raise
                attempt += 1
                if attempt >= self.max_attempts or deadline.expired():
                    if self.record_metrics:
                        _metrics.record_retry_giveup(point or "unnamed")
                    raise
                delay = self.delay_for_attempt(attempt, rng)
                remaining = deadline.remaining()
                if remaining != float("inf"):
                    if remaining <= 0:
                        if self.record_metrics:
                            _metrics.record_retry_giveup(point or "unnamed")
                        raise
                    delay = min(delay, remaining)
                if self.record_metrics:
                    _metrics.record_retry(point or "unnamed")
                self.sleep(delay)


# ---------------------------------------------------------------------------
# process-wide default policy (env-tunable; the one control-plane call
# sites share so HOROVOD_RETRY_* steers every bootstrap path at once)
# ---------------------------------------------------------------------------

_default_policy: Optional[RetryPolicy] = None


def default_policy() -> RetryPolicy:
    """The shared control-plane policy, built once from
    ``HOROVOD_RETRY_MAX_ATTEMPTS`` / ``HOROVOD_RETRY_BASE_DELAY`` /
    ``HOROVOD_RETRY_MAX_DELAY`` (``HVD_TPU_`` prefixes win, as for
    every knob). Worker processes read it before ``init()``, so it
    parses the env directly instead of going through the Knobs
    snapshot."""
    global _default_policy
    if _default_policy is None:
        from ..core.knobs import _env, _env_float, _env_int

        jitter = (_env("RETRY_JITTER", "full") or "full").strip().lower()
        if jitter not in ("bounded", "full"):
            jitter = "full"
        _default_policy = RetryPolicy(
            max_attempts=_env_int("RETRY_MAX_ATTEMPTS", 5),
            base_delay_s=_env_float("RETRY_BASE_DELAY", 0.1),
            max_delay_s=_env_float("RETRY_MAX_DELAY", 2.0),
            # fleet discipline: full jitter + a shared elapsed cap, so
            # hundreds of hosts reconnecting after a rendezvous
            # failover spread across the backoff window instead of
            # retrying in lockstep (thundering herd on the root)
            jitter=jitter,
            max_elapsed_s=_env_float("RETRY_MAX_ELAPSED", 60.0),
        )
    return _default_policy


def set_default_policy(policy: Optional[RetryPolicy]) -> None:
    """Override the shared policy (tests: zero-sleep policies). Pass
    None to fall back to the env-built default on next use."""
    global _default_policy
    _default_policy = policy


def configure(knobs) -> None:
    """Rebuild the shared policy from a Knobs snapshot — the
    programmatic twin of the env path (``init()`` calls this, so
    ``Knobs(retry_max_attempts=...)`` works like every other knob)."""
    jitter = str(getattr(knobs, "retry_jitter", "full") or "full")
    if jitter not in ("bounded", "full"):
        jitter = "full"
    set_default_policy(RetryPolicy(
        max_attempts=int(getattr(knobs, "retry_max_attempts", 5)),
        base_delay_s=float(getattr(knobs, "retry_base_delay_seconds", 0.1)),
        max_delay_s=float(getattr(knobs, "retry_max_delay_seconds", 2.0)),
        jitter=jitter,
        max_elapsed_s=float(
            getattr(knobs, "retry_max_elapsed_seconds", 60.0)),
    ))
