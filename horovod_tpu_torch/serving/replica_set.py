"""Multi-replica data-parallel dispatch for the serving tier.

The PyTorch counterpart of the JAX package's ``serving/replica_set.py``.
One replica = one process owning its card, running engine + batcher (or
the decode scheduler) behind the HTTP front end (server.py). This
module is everything around them:

* **registration** — replicas announce ``(kind="serving", index,
  host:port)`` (decode replicas under ``"serving-decode"``) through the
  authenticated registry (``runner/compute_service.py``); the front
  door waits for N replicas of its kind;
* **routing** — :class:`ReplicaSet` tracks per-replica in-flight counts
  locally and routes each request to the least-loaded live replica;
* **failover** — a replica that dies mid-request (connection error or
  5xx) is ejected and the request retried on another replica under the
  shared :class:`~horovod_tpu_torch.utils.retry.RetryPolicy`
  (``serving.dispatch`` retry point) — the client never sees the death.
  A 429 retries elsewhere without ejecting. When every replica is
  ejected the set forgives them all once and re-probes;
* **drain-then-exit** — ``python -m horovod_tpu_torch.serving.replica_set``
  installs the preemption handler (elastic/preemption.py): SIGTERM
  stops admission, flushes the batcher (or finishes every admitted
  generation) and the in-flight HTTP requests, then exits with
  ``PREEMPTED_EXIT_CODE`` (83).

* **autoscaling** — :class:`ReplicaAutoscaler` grows and shrinks the
  fleet through a :class:`ReplicaSupervisor` off the replicas' live
  signals: slot occupancy from ``/healthz`` and the queue-wait
  histogram's deltas from ``/metrics``.

Fault points: ``serving.dispatch`` fires before every routed attempt
(front door), ``serving.replica_exec`` before every executed batch
(replica, engine.py), ``serving.admit`` at admission (batcher.py).
Metrics and flight records, as in the JAX package: each replica's
in-flight count, each ejection (``hvd_serving_failovers_total``), the
rotation's size on every membership change, the dispatch and failover
of each request under its id, the autoscaler's actions; a replica
process turns metrics on, so its ``/metrics`` always answers.

Not ported yet: the registrations' mirror into a pod relay's KV (ROADMAP
queue A entry 14).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils import faults, flight, metrics, retry
from . import tracing
from .batcher import RequestTimeout
from .server import AUTH_HEADER, REQUEST_ID_HEADER, ServingServer, sign_body

SERVING_KIND = "serving"
#: decode replicas register under their own kind: a front door pools
#: ONE capability, so /v1/generate can never be routed to a predict
#: replica (whose 404 is a terminal client error, not a retryable
#: failover) in a mixed fleet
SERVING_DECODE_KIND = "serving-decode"


def _build_body(x: np.ndarray,
                timeout_s: Optional[float] = None) -> bytes:
    """Serialize one predict request ONCE — the dispatch tier reuses
    these bytes across failover attempts."""
    x = np.asarray(x)
    body_obj = {"inputs": x.tolist(), "dtype": str(x.dtype)}
    if timeout_s:
        body_obj["timeout_ms"] = int(timeout_s * 1e3)
    return json.dumps(body_obj).encode()


def _post_body(addr: str, body: bytes, sock_timeout: float,
               key: Optional[bytes] = None,
               request_id: str = "") -> np.ndarray:
    req = urllib.request.Request(
        f"http://{addr}/v1/predict", data=body, method="POST",
        headers={"Content-Type": "application/json"})
    if key is not None:
        req.add_header(AUTH_HEADER, sign_body(key, body))
    if request_id:
        # the front door's trace id travels to the replica, so both
        # tiers name the SAME request
        req.add_header(REQUEST_ID_HEADER, request_id)
    with urllib.request.urlopen(req, timeout=sock_timeout) as resp:
        payload = json.loads(resp.read())
    return np.asarray(payload["outputs"],
                      dtype=np.dtype(payload.get("dtype", "float32")))


def predict_remote(
    addr: str,
    x: np.ndarray,
    timeout_s: Optional[float] = None,
    key: Optional[bytes] = None,
) -> np.ndarray:
    """One POST /v1/predict against ``host:port`` (no retries — that's
    the ReplicaSet's job). Raises urllib.error.HTTPError / OSError."""
    return _post_body(addr, _build_body(x, timeout_s),
                      (timeout_s or 30.0) + 5.0, key=key)


def generate_stream_remote(
    addr: str,
    req: Dict,
    timeout_s: Optional[float] = None,
    key: Optional[bytes] = None,
    request_id: str = "",
):
    """One streaming POST /v1/generate against ``host:port``: a
    generator of parsed chunk dicts, yielded as the replica's chunked
    response delivers them. No retries; failover is
    :meth:`ReplicaSet.generate`'s job."""
    body_obj = dict(req)
    body_obj["stream"] = True
    if timeout_s:
        body_obj["timeout_ms"] = int(timeout_s * 1e3)
    body = json.dumps(body_obj).encode()
    r = urllib.request.Request(
        f"http://{addr}/v1/generate", data=body, method="POST",
        headers={"Content-Type": "application/json"})
    if key is not None:
        r.add_header(AUTH_HEADER, sign_body(key, body))
    if request_id:
        r.add_header(REQUEST_ID_HEADER, request_id)
    with urllib.request.urlopen(r, timeout=(timeout_s or 30.0) + 5.0) \
            as resp:
        for line in resp:
            line = line.strip()
            if not line:
                continue
            chunk = json.loads(line)
            yield chunk
            if chunk.get("done"):
                return


def generate_remote(addr: str, req: Dict,
                    timeout_s: Optional[float] = None,
                    key: Optional[bytes] = None):
    """Blocking convenience over :func:`generate_stream_remote`:
    returns ``(tokens, finish_reason)``."""
    tokens, reason = [], None
    for chunk in generate_stream_remote(addr, req, timeout_s, key):
        tokens.extend(int(t) for t in chunk.get("tokens", ()))
        if chunk.get("done"):
            reason = chunk.get("finish_reason")
            if chunk.get("error"):
                raise RuntimeError(f"generation failed mid-stream: "
                                   f"{chunk['error']}")
    return tokens, reason


def _dispatch_retryable(exc: BaseException) -> bool:
    """5xx (replica dying/draining) and 429 (that replica saturated)
    retry on another replica; other HTTP codes are client errors and
    propagate. Transport failures retry — except the dispatch tier's
    own deadline marker, which says the request budget is SPENT."""
    if isinstance(exc, RequestTimeout):
        return False
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code == 429 or (exc.code >= 500 and exc.code != 504)
    return isinstance(exc, (OSError, EOFError))


def _ejects_replica(exc: BaseException) -> bool:
    """Failures that mean the REPLICA is gone (eject it from dispatch),
    vs merely busy: a 429 is backpressure from a healthy replica, and
    ejecting it would cut capacity exactly when load is highest."""
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code >= 500 and exc.code != 504
    return isinstance(exc, (OSError, EOFError))


class ReplicaSet:
    """Least-loaded dispatch with transparent failover.

    ``replicas`` maps index -> "host:port" (usually the ComputeService's
    WorkersResponse). Thread-safe: the front end calls ``predict`` and
    ``generate`` from concurrent request threads.
    """

    def __init__(
        self,
        replicas: Dict[int, str],
        *,
        key: Optional[bytes] = None,
        policy: Optional[retry.RetryPolicy] = None,
        default_timeout_s: float = 30.0,
    ):
        if not replicas:
            raise ValueError("ReplicaSet needs at least one replica")
        self._replicas = dict(replicas)
        self._key = key
        # failover must outlast losing every replica but one: give the
        # policy enough attempts to walk the whole set and then some
        self._policy = policy or retry.RetryPolicy(
            max_attempts=max(len(replicas) + 2, 4),
            base_delay_s=0.05, max_delay_s=0.5)
        self._default_timeout_s = default_timeout_s
        self._lock = threading.Lock()
        self._inflight: Dict[int, int] = {i: 0 for i in replicas}
        self._dead: Dict[int, str] = {}
        self._rr = 0

    # -- bookkeeping --------------------------------------------------------

    @property
    def replicas(self) -> Dict[int, str]:
        return dict(self._replicas)

    @property
    def dead(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._dead)

    def _pick(self) -> Tuple[int, str]:
        with self._lock:
            live = [i for i in self._replicas if i not in self._dead]
            if not live:
                # total eclipse: forgive everyone once instead of
                # locking the front door shut — a restarted replica
                # answers, a still-dead one re-ejects on its next miss
                self._dead.clear()
                live = list(self._replicas)
            self._rr += 1
            idx = min(live, key=lambda i: (self._inflight[i],
                                           (i + self._rr) % len(live)))
            self._inflight[idx] += 1
            n = self._inflight[idx]
        metrics.set_serving_inflight(n, replica=str(idx))
        return idx, self._replicas[idx]

    def _release(self, idx: int) -> None:
        with self._lock:
            self._inflight[idx] -= 1
            n = self._inflight[idx]
        metrics.set_serving_inflight(n, replica=str(idx))

    def _mark_dead(self, idx: int, why: BaseException) -> None:
        with self._lock:
            already = idx in self._dead
            self._dead[idx] = f"{type(why).__name__}: {why}"
        if not already:
            metrics.record_serving_failover(str(idx))

    def revive(self, idx: Optional[int] = None) -> None:
        """Forgive one replica (or all) — e.g. after an external health
        check saw it come back."""
        with self._lock:
            if idx is None:
                self._dead.clear()
            else:
                self._dead.pop(idx, None)

    # -- live membership ----------------------------------------------------

    def add_replica(self, idx: int, addr: str) -> None:
        """Bring a new replica into rotation. Idempotent on the same
        (idx, addr); re-adding a dead index revives it — the process
        behind it is fresh."""
        with self._lock:
            self._replicas[idx] = addr
            self._inflight.setdefault(idx, 0)
            self._dead.pop(idx, None)
            n = len(self._replicas)
        metrics.set_serving_replicas(n)

    def remove_replica(self, idx: int) -> None:
        """Take a replica out of rotation BEFORE draining it: no new
        requests route to it, its in-flight work finishes under the
        SIGTERM drain contract. The last replica cannot be removed."""
        with self._lock:
            if idx not in self._replicas:
                return
            if len(self._replicas) <= 1:
                raise ValueError(
                    "refusing to remove the last serving replica")
            self._replicas.pop(idx)
            self._dead.pop(idx, None)
            n = len(self._replicas)
        metrics.set_serving_replicas(n)

    # -- dispatch -----------------------------------------------------------

    def predict(self, x: np.ndarray,
                timeout_s: Optional[float] = None) -> np.ndarray:
        """Route one request; retried across replicas on failure so a
        replica death is invisible to the caller."""
        if timeout_s is None:
            timeout_s = self._default_timeout_s
        # serialize once; every failover attempt reuses the bytes
        body = _build_body(x, timeout_s)
        deadline = retry.Deadline(timeout_s)
        rid = tracing.current_request_id()

        def _attempt() -> np.ndarray:
            if deadline.expired():
                # more attempts only delay the 504 the client has
                # already paid for
                raise RequestTimeout(
                    f"request budget {timeout_s}s exhausted during "
                    f"dispatch/failover")
            idx, addr = self._pick()
            flight.record("serving_dispatch", str(idx),
                          n=int(x.shape[0]), req=rid)
            try:
                faults.inject("serving.dispatch", replica=idx)
                remaining = max(deadline.remaining(), 0.5)
                # a replica that accepts the connection but never
                # answers must not swallow the whole budget: with peers
                # available, cap each attempt at half the remaining
                # deadline so there is room for one failover
                att = (remaining / 2.0 if len(self._replicas) > 1
                       else remaining)
                att = max(att, 0.5)
                return _post_body(addr, body, att + 1.0, key=self._key,
                                  request_id=rid)
            except BaseException as e:
                if _ejects_replica(e):
                    self._mark_dead(idx, e)
                    flight.record("serving_failover", str(idx),
                                  error=str(e)[:120])
                raise
            finally:
                self._release(idx)

        return self._policy.call(
            _attempt, point="serving.dispatch",
            retryable=_dispatch_retryable)

    def __call__(self, x: np.ndarray,
                 timeout_s: Optional[float] = None) -> np.ndarray:
        return self.predict(x, timeout_s)

    def generate(self, req: Dict, timeout_s: Optional[float] = None):
        """Route one generation request, streaming chunks through as
        the chosen replica produces them. Failover is
        **pre-first-chunk only**: a replica that fails before emitting
        anything (draining 503, queue-full 429, death) is retried on a
        peer like predict; once tokens flowed, the stream is committed
        to that replica and a mid-stream death ends it with an in-band
        ``{"done": true, "error": ...}`` chunk (replaying a prefix on
        another replica would emit its tokens twice)."""
        if timeout_s is None:
            timeout_s = self._default_timeout_s
        deadline = retry.Deadline(timeout_s)
        rid = tracing.current_request_id()
        attempts = max(len(self._replicas) + 2, 4)
        last_exc: Optional[BaseException] = None
        for attempt in range(attempts):
            if deadline.expired():
                raise last_exc or RequestTimeout(
                    f"request budget {timeout_s}s exhausted during "
                    "generate dispatch/failover")
            idx, addr = self._pick()
            flight.record("serving_dispatch", str(idx), req=rid,
                          route="generate")
            yielded = False
            try:
                faults.inject("serving.dispatch", replica=idx)
                for chunk in generate_stream_remote(
                        addr, req, max(deadline.remaining(), 0.5),
                        key=self._key, request_id=rid):
                    yielded = True
                    yield chunk
                return
            except GeneratorExit:
                # the consumer stopped reading (done chunk seen, client
                # hung up): not a replica failure
                raise
            except BaseException as e:
                if _ejects_replica(e):
                    self._mark_dead(idx, e)
                    flight.record("serving_failover", str(idx),
                                  error=str(e)[:120])
                if yielded:
                    yield {"done": True,
                           "error": f"{type(e).__name__}: {e}"}
                    return
                if not _dispatch_retryable(e):
                    raise
                last_exc = e
                metrics.record_retry("serving.dispatch")
                time.sleep(min(0.05 * (attempt + 1), 0.5))
            finally:
                self._release(idx)
        raise last_exc or RuntimeError("generate dispatch exhausted")


class ReplicaSupervisor:
    """Owns spawned replicas: process lifecycle only.

    ``spawn_fn(index) -> (addr, handle)`` starts one replica and blocks
    until it is serving; ``handle`` needs ``send_signal``/``wait`` (a
    ``subprocess.Popen`` works as-is). Drain reuses the preemption
    contract: the replica leaves dispatch first, then SIGTERM → it stops
    admission, finishes every resident request and exits
    ``PREEMPTED_EXIT_CODE`` (83), so the drain is invisible to clients.
    """

    def __init__(self, spawn_fn, replica_set: ReplicaSet,
                 *, base_index: int = 100):
        self._spawn = spawn_fn
        self._rs = replica_set
        self._next_index = base_index
        self._owned: Dict[int, object] = {}  # index -> handle
        self._lock = threading.Lock()

    @property
    def owned(self) -> Dict[int, object]:
        with self._lock:
            return dict(self._owned)

    def grow(self) -> int:
        with self._lock:
            idx = self._next_index
            self._next_index += 1
        addr, handle = self._spawn(idx)
        with self._lock:
            self._owned[idx] = handle
        self._rs.add_replica(idx, addr)
        flight.record("autoscale_grow", str(idx), addr=addr)
        return idx

    def shrink(self, timeout_s: float = 60.0) -> Optional[int]:
        """Drain the newest supervisor-owned replica; returns its index
        (None when this supervisor owns nothing — replicas it did not
        spawn are never its to kill)."""
        import signal as signal_mod

        with self._lock:
            if not self._owned:
                return None
            idx = max(self._owned)
            handle = self._owned[idx]
        # out of rotation first; the handle leaves _owned only once the
        # process is reaped, so a refused removal (last replica) or a
        # drain timeout never orphans a live subprocess
        self._rs.remove_replica(idx)
        handle.send_signal(signal_mod.SIGTERM)
        rc = handle.wait(timeout=timeout_s)
        with self._lock:
            self._owned.pop(idx, None)
        flight.record("autoscale_shrink", str(idx), exit_code=rc)
        return idx

    def stop_all(self, timeout_s: float = 30.0) -> None:
        while True:
            with self._lock:
                if not self._owned:
                    return
            try:
                self.shrink(timeout_s=timeout_s)
            except ValueError:
                # last replica in the set: leave it serving
                return


class ReplicaAutoscaler:
    """Grow and shrink the replica fleet off the replicas' live decode
    signals: slot occupancy (``hvd_serving_decode_slots``, served as
    ``slots{}`` on every replica's unauthenticated ``/healthz``) and the
    admission queue's wait (``hvd_serving_queue_wait_seconds`` deltas
    from ``/metrics``).

    Policy: a poll is *hot* when the fleet's occupancy is at least
    ``hi_occupancy``, or prefills queue while the recent queue wait is
    at least ``queue_wait_hi_s``; *cold* when occupancy is at most
    ``lo_occupancy`` with an empty queue. ``sustain`` hot (cold) polls
    in a row outside the ``cooldown_s`` window grow (shrink) the fleet
    by one replica, within [``min_replicas``, ``max_replicas``]. Every
    action lands in ``hvd_serving_autoscale_events_total{action=}`` and
    the flight recorder. ``signal_fn`` (default: the scrape) and
    ``clock`` let a test drive the policy; each argument left None reads
    its ``HOROVOD_SERVING_AUTOSCALE_*`` knob.
    """

    def __init__(
        self,
        supervisor: ReplicaSupervisor,
        replica_set: ReplicaSet,
        *,
        signal_fn=None,
        min_replicas: Optional[int] = None,
        max_replicas: Optional[int] = None,
        hi_occupancy: Optional[float] = None,
        lo_occupancy: Optional[float] = None,
        queue_wait_hi_s: Optional[float] = None,
        sustain: Optional[int] = None,
        cooldown_s: Optional[float] = None,
        clock=time.monotonic,
    ):
        from .engine import serving_knobs

        k = serving_knobs()

        def _k(v, name):
            return v if v is not None else getattr(k, name)

        self._sup = supervisor
        self._rs = replica_set
        self._signal_fn = signal_fn or self._scrape_signals
        self.min_replicas = int(_k(min_replicas,
                                   "serving_autoscale_min_replicas"))
        self.max_replicas = int(_k(max_replicas,
                                   "serving_autoscale_max_replicas"))
        self.hi_occupancy = float(_k(hi_occupancy,
                                     "serving_autoscale_hi_occupancy"))
        self.lo_occupancy = float(_k(lo_occupancy,
                                     "serving_autoscale_lo_occupancy"))
        self.queue_wait_hi_s = float(_k(queue_wait_hi_s,
                                        "serving_autoscale_queue_wait_s"))
        self.sustain = int(_k(sustain, "serving_autoscale_sustain"))
        self.cooldown_s = float(_k(cooldown_s,
                                   "serving_autoscale_cooldown_s"))
        self._clock = clock
        self._hot_streak = 0
        self._cold_streak = 0
        self._last_action_t = -1e9
        self._last_wait: Dict[str, Tuple[float, float]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self.decisions: list = []  # (t, action): the trail

    # -- signals -------------------------------------------------------------

    def _scrape_signals(self) -> Dict:
        """The fleet's occupancy and queue over the live replicas:
        ``slots{}`` from ``/healthz``, the queue wait's sum and count
        deltas from ``/metrics``. A replica that does not answer within
        2 s adds nothing (the dispatch tier's failover owns it)."""
        total = occupied = queued = 0
        dsum = dcount = 0.0
        for idx, addr in self._rs.replicas.items():
            try:
                with urllib.request.urlopen(
                        f"http://{addr}/healthz", timeout=2.0) as r:
                    h = json.loads(r.read())
                slots = h.get("slots") or {}
                total += int(slots.get("total", 0))
                occupied += int(slots.get("occupied", 0))
                queued += int(slots.get("queued_prefills", 0))
            except Exception:
                continue
            try:
                with urllib.request.urlopen(
                        f"http://{addr}/metrics", timeout=2.0) as r:
                    text = r.read().decode()
                s = c = 0.0
                # the histogram is labeled by SLO class: sum its series
                for line in text.splitlines():
                    if line.startswith(
                            "hvd_serving_queue_wait_seconds_sum"):
                        s += float(line.rsplit(" ", 1)[1])
                    elif line.startswith(
                            "hvd_serving_queue_wait_seconds_count"):
                        c += float(line.rsplit(" ", 1)[1])
                ps, pc = self._last_wait.get(addr, (0.0, 0.0))
                self._last_wait[addr] = (s, c)
                dsum += max(s - ps, 0.0)
                dcount += max(c - pc, 0.0)
            except Exception:
                continue
        return {
            "occupancy": (occupied / total) if total else 0.0,
            "queued": queued,
            "queue_wait_s": (dsum / dcount) if dcount else 0.0,
        }

    # -- the control loop ----------------------------------------------------

    def poll_once(self) -> Optional[str]:
        """One observe-decide-act cycle; returns "grow" or "shrink" when
        an action fired, else None."""
        sig = self._signal_fn()
        now = self._clock()
        n = len(self._rs.replicas)
        hot = (sig.get("occupancy", 0.0) >= self.hi_occupancy
               or (sig.get("queued", 0) > 0
                   and sig.get("queue_wait_s", 0.0)
                   >= self.queue_wait_hi_s))
        cold = (sig.get("occupancy", 0.0) <= self.lo_occupancy
                and sig.get("queued", 0) == 0)
        self._hot_streak = self._hot_streak + 1 if hot else 0
        self._cold_streak = self._cold_streak + 1 if cold else 0
        if now - self._last_action_t < self.cooldown_s:
            return None
        action = None
        if self._hot_streak >= self.sustain and n < self.max_replicas:
            self._sup.grow()
            action = "grow"
        elif (self._cold_streak >= self.sustain
                and n > self.min_replicas and self._sup.owned):
            if self._sup.shrink() is not None:
                action = "shrink"
        if action:
            self._last_action_t = now
            self._hot_streak = self._cold_streak = 0
            self.decisions.append((now, action))
            metrics.record_autoscale(action)
        return action

    def start(self, interval_s: Optional[float] = None) -> None:
        """Poll every ``interval_s`` (default the knob) on a thread of its
        own until :meth:`stop`."""
        from .engine import serving_knobs

        if interval_s is None:
            interval_s = float(serving_knobs().serving_autoscale_interval_s)
        if self._thread is not None:
            return
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.poll_once()
                except Exception as e:  # noqa: BLE001 — keep scaling
                    flight.record("autoscale_error", "",
                                  error=str(e)[:120])

        t = threading.Thread(target=loop, daemon=True,
                             name="hvd-serving-autoscaler")
        t.start()
        self._thread, self._stop = t, stop

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None
            self._stop = None


# ---------------------------------------------------------------------------
# process entry points: the registry, one replica, or the front door
# ---------------------------------------------------------------------------

def _secret_or_none() -> Optional[bytes]:
    from ..runner.util import secret

    try:
        return secret.secret_from_env()
    except RuntimeError:
        return None


def _install_drain_handler(server: ServingServer, batcher,
                           drain_timeout_s: float) -> None:
    from ..elastic import preemption

    def _drain():
        server.draining = True          # stop admission first
        if batcher is not None:
            batcher.close(drain=True, timeout_s=drain_timeout_s)
        server.drain(timeout_s=drain_timeout_s)
        # settle: in-flight handlers decrement before their response
        # write; give those last writes a beat before os._exit
        time.sleep(0.25)

    preemption.install(on_preempt=_drain)


def _register(register: str, index: int, port: int,
              key: Optional[bytes], kind: str = SERVING_KIND) -> None:
    from ..runner.compute_service import ComputeClient
    from ..runner.util.network import routable_host_address

    if key is None:
        raise RuntimeError(
            "--register needs the per-job secret in the environment "
            "(HVD_TPU_SECRET_KEY) — the registry authenticates")
    host, _, p = register.rpartition(":")
    client = ComputeClient([(host, int(p))], key)
    client.register_worker(kind, index, f"{routable_host_address()}:{port}")


def serve_replica(argv=None) -> int:
    """``python -m horovod_tpu_torch.serving.replica_set --checkpoint
    ...``: restore, capture the buckets' graphs, serve until SIGTERM
    drains us. Replicas run on the card unless ``--device cpu``."""
    ap = argparse.ArgumentParser(
        description="horovod_tpu_torch serving replica / front door")
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint dir (checkpoint.save_model) with "
                         "serving metadata")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--register", default="",
                    help="host:port of the ComputeService registry")
    ap.add_argument("--buckets", default="",
                    help="override HOROVOD_SERVING_BUCKETS")
    ap.add_argument("--decode", action="store_true",
                    help="serve autoregressive generation "
                         "(/v1/generate) from a transformer_lm "
                         "checkpoint instead of one-shot predict")
    ap.add_argument("--device", default=None,
                    help="the engine's device (default: the card; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--queue-limit", type=int, default=None)
    ap.add_argument("--no-warmup", action="store_true",
                    help="capture each graph on first use")
    ap.add_argument("--drain-timeout", type=float, default=30.0)
    ap.add_argument("--front-door", action="store_true",
                    help="serve as the dispatch tier instead of a "
                         "replica (needs --register + --wait-replicas "
                         "or --replicas)")
    ap.add_argument("--registry", action="store_true",
                    help="run the standalone ComputeService registry "
                         "replicas/front door --register against "
                         "(binds --port)")
    ap.add_argument("--wait-replicas", type=int, default=0,
                    help="front door: replicas to wait for in the "
                         "registry before serving")
    ap.add_argument("--wait-timeout", type=float, default=300.0,
                    help="front door: seconds to wait for "
                         "--wait-replicas registrations (replicas "
                         "register only after checkpoint restore + "
                         "graph capture)")
    ap.add_argument("--replicas", default="",
                    help="front door: comma list of host:port "
                         "(skips the registry)")
    args = ap.parse_args(argv)

    metrics.enable()  # serving is an observability-first workload
    faults.configure()  # arm HOROVOD_TPU_FAULT_SPEC if the env set one
    key = _secret_or_none()

    if args.registry:
        from ..runner.compute_service import ComputeService

        if key is None:
            raise RuntimeError("--registry needs HVD_TPU_SECRET_KEY")
        svc = ComputeService(key, port=args.port)
        print(f"SERVING_REGISTRY_READY index=0 port={svc.port}",
              flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            svc.shutdown()
            return 0

    # a front door pools ONE capability: --decode selects the
    # serving-decode registry kind and mounts /v1/generate; otherwise
    # the predict kind and /v1/predict
    fleet_kind = SERVING_DECODE_KIND if args.decode else SERVING_KIND
    batcher = None
    if args.front_door:
        if args.replicas:
            replicas = {i: a for i, a in
                        enumerate(args.replicas.split(","))}
        elif args.register and args.wait_replicas:
            from ..runner.compute_service import ComputeClient

            host, _, p = args.register.rpartition(":")
            if key is None:
                raise RuntimeError("--register needs HVD_TPU_SECRET_KEY")
            client = ComputeClient([(host, int(p))], key)
            replicas = client.wait_for_workers(
                fleet_kind, args.wait_replicas,
                timeout_s=args.wait_timeout)
            if len(replicas) < args.wait_replicas:
                # silently serving at partial capacity despite
                # --wait-replicas N would hide a broken replica fleet
                raise RuntimeError(
                    f"only {len(replicas)}/{args.wait_replicas} "
                    f"{fleet_kind} replicas registered within "
                    f"{args.wait_timeout}s")
        else:
            raise RuntimeError(
                "front door needs --replicas or --register + "
                "--wait-replicas")
        rs = ReplicaSet(replicas, key=key)
        server = ServingServer(
            predict_fn=None if args.decode else rs.predict,
            generate_fn=rs.generate if args.decode else None,
            port=args.port, key=key,
            health_extra=lambda: {"replicas": rs.replicas,
                                  "dead": rs.dead})
        role = "front-door"
    elif args.decode:
        from .decode import GenerationEngine
        from .scheduler import DecodeScheduler

        if not args.checkpoint:
            ap.error("--checkpoint is required for a replica")
        engine = GenerationEngine.from_checkpoint(args.checkpoint,
                                                  device=args.device)
        if not args.no_warmup:
            engine.warmup()
        scheduler = DecodeScheduler(
            engine, queue_limit=args.queue_limit).start()
        batcher = scheduler  # close(drain=) shares the batcher contract

        def generate_local(req, timeout_s, _s=scheduler):
            pending = _s.submit(
                req["prompt"],
                max_new_tokens=req.get("max_new_tokens"),
                timeout_s=timeout_s,
                slo=req.get("slo", "standard"))
            return pending.stream(
                timeout_s=(timeout_s
                           or _s._default_timeout_s) + 5.0)

        server = ServingServer(
            generate_fn=generate_local, port=args.port, key=key,
            # probe body: the slots triple is what lets probes tell
            # "full" from "wedged"
            health_extra=lambda: {
                "slots": scheduler.slot_stats(),
                "queued": scheduler.pending,
                "bucket_cache": engine.cached_executables,
            })
        role = "replica"
    else:
        from .batcher import DynamicBatcher
        from .engine import InferenceEngine, SERVING_META_KEY, parse_buckets

        if not args.checkpoint:
            ap.error("--checkpoint is required for a replica")
        engine = InferenceEngine.from_checkpoint(
            args.checkpoint,
            buckets=parse_buckets(args.buckets) if args.buckets else None,
            device=args.device)
        meta = getattr(engine, "metadata", {}).get(SERVING_META_KEY, {})
        if not args.no_warmup and meta.get("input_shape"):
            engine.warmup(tuple(meta["input_shape"]),
                          meta.get("dtype", "float32"))
        batcher = DynamicBatcher(
            engine, max_batch=engine.buckets[-1],
            max_wait_ms=args.max_wait_ms, queue_limit=args.queue_limit,
        ).start()
        server = ServingServer(
            batcher.__call__, port=args.port, key=key,
            # probe body: queue depth + graph-cache size (the in-flight
            # count comes from ServingServer.health itself) — enough for
            # a probe to tell "idle" from "wedged" without auth
            health_extra=lambda: {
                "buckets": list(engine.buckets),
                "queued": batcher.pending,
                "bucket_cache": engine.cached_executables,
            })
        role = "replica"

    port = server.start()
    if args.register and not args.front_door:
        _register(args.register, args.index, port, key, kind=fleet_kind)
    _install_drain_handler(server, batcher, args.drain_timeout)
    print(f"SERVING_{role.upper().replace('-', '_')}_READY "
          f"index={args.index} port={port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(serve_replica() or 0)
