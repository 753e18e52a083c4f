"""Cross-rank flight recorder: post-hoc forensics for distributed stalls.

The port of the JAX package's ``utils/flight.py``. The timeline and the
metrics are per process: when a world hangs, each rank holds only its
own view. The recorder is an aircraft-style black box:

* a **bounded ring** of control-plane events (retries, faults, elastic
  transitions, recoveries, preemption, signals, the eager runtime's
  enqueues, responses, executions and plan changes, the serving tier's
  requests, batches, dispatches and failovers, decode admissions and
  evictions, the autoscaler's actions), each stamped with a per-rank sequence number and the monotonic and
  wall clocks. :func:`record` takes no lock: one enabled check, a
  ``deque.append`` (atomic under the GIL) and an ``itertools.count``
  step;
* **dumps** (:func:`dump`): rank-local JSONL under
  ``HOROVOD_FLIGHT_DIR`` (header line, then one event a line), shipped
  to the launcher's rendezvous store with ``PUT /flight/<rank>``, which
  stamps a receipt; the header carries the clock offset to the store
  measured through its ``GET /clock`` (:func:`clock_probe`), so dumps
  of several ranks align. Triggers: the preemption handler's SIGTERM,
  ``SIGUSR2`` on demand, an uncaught exception (the excepthook), and a
  caller (:func:`straggler_report`, :func:`anomaly_dump`);
* **straggler attribution** (:func:`straggler_report`): peers' last
  dumps, fetched from the store, against this rank's pending tensors
  name the ranks that have not submitted them.

``python -m horovod_tpu_torch.tools.flight_analyze`` merges the dumps of
a job into a straggler and critical-path report.

Signal safety: :func:`record` and :func:`dump` run inside signal
handlers (SIGUSR2, the preemption handler's SIGTERM) that may interrupt
a holder of the metrics locks, so neither takes one. The one lock here
serializes whole dumps and is only ever acquired without blocking.
"""

from __future__ import annotations

import itertools
import json
import os
import signal as _signal
import sys
import tempfile
import threading
import time
import urllib.request
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_CAPACITY = 4096

_enabled = False
_configured = False  # True when configure() enabled the recorder
_events: "deque" = deque(maxlen=DEFAULT_CAPACITY)
_seq = itertools.count()
_rank = -1
_sink: Optional[Tuple[str, int]] = None  # the rendezvous store
_dir = ""
_dump_lock = threading.Lock()
_dump_count = 0
_handlers_installed = False
_prev_excepthook = None
_prev_sigusr2 = None
# the autotuner's last agreed pin (entry 12 records it), kept out of the
# ring so that it survives wraparound
_last_autotune: Optional[dict] = None

FLIGHT_SCOPE = "flight"  # the rendezvous KV scope dumps land in


def _default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "hvd_flight")


def enabled() -> bool:
    """Whether the recorder records. A site that assembles a record
    (a list of names) gates on it to skip that work too."""
    return _enabled


def enable(capacity: Optional[int] = None) -> None:
    global _enabled, _events
    if capacity is not None and capacity != _events.maxlen:
        _events = deque(_events, maxlen=max(int(capacity), 16))
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def set_rank(rank: int) -> None:
    global _rank
    _rank = int(rank)


def rank() -> int:
    return _rank


def set_sink(addr: Optional[str], port: int = 0) -> None:
    """Where dumps ship: the rendezvous store. None: dumps stay
    rank-local files."""
    global _sink
    _sink = (addr, int(port)) if addr and port else None
    if _sink is not None:
        # loaded here, not at the first dump: a dump may run in a
        # signal handler, which should not import a package
        from ..runner.http import http_client  # noqa: F401


def sink() -> Optional[Tuple[str, int]]:
    return _sink


def dump_dir() -> str:
    return _dir or _default_dir()


# -- recording ------------------------------------------------------------------

def record(kind: str, name: str = "", **detail) -> None:
    """Append one event to the ring (the oldest falls off its far end).
    Lock-free: safe from any thread and from signal handlers."""
    if not _enabled:
        return
    if kind == "autotune" and name in ("pin", "final", "warm_start"):
        global _last_autotune
        _last_autotune = {"name": name, **detail}
    _events.append((
        next(_seq), time.monotonic(), time.time(), kind, name,
        detail or None,
    ))


def last_autotune() -> Optional[dict]:
    """The last autotune pin recorded (None before any)."""
    return _last_autotune


def snapshot() -> List[tuple]:
    """A copy of the ring, oldest first."""
    return list(_events)


def event_count() -> int:
    return len(_events)


def clear() -> None:
    _events.clear()


# -- clock alignment and dumps ----------------------------------------------------

def clock_probe() -> dict:
    """One ping to the sink's ``GET /clock``: the offset that maps this
    rank's wall clock onto the store's (``t_store = t_wall +
    clock_offset_s``) and the ping's round trip, or {} with no
    reachable sink."""
    if _sink is None:
        return {}
    from ..runner.http.http_client import server_clock

    addr, port = _sink
    try:
        t0w = time.time()
        server_t, rtt = server_clock(addr, port)
    except (OSError, ValueError, KeyError):
        return {}  # a dump still carries its own stamps
    # the store stamped mid-flight: request start + rtt / 2 is our best
    # estimate of that instant
    return {"clock_offset_s": server_t - (t0w + rtt / 2.0),
            "clock_rtt_s": rtt}


_push_policy = None
_push_outage = None


def _push_degradation():
    """The dump push's bounded policy (``record_metrics=False``: pushes
    run in signal handlers, which must not take the metrics locks) and
    its outage tracker (one warning an outage, not one a dump)."""
    global _push_policy, _push_outage
    if _push_policy is None:
        import logging

        from . import retry as _retry

        _push_policy = _retry.RetryPolicy(
            max_attempts=2, base_delay_s=0.1, max_delay_s=0.25,
            record_metrics=False)
        _push_outage = _retry.Outage(
            logging.getLogger("horovod_tpu_torch.flight"),
            "flight-dump push to the rendezvous store")
    return _push_policy, _push_outage


def _push(payload: bytes) -> bool:
    """Ship a dump to ``PUT /flight/<rank>`` on the sink: one quick
    retry, so a dead driver costs at most two short timeouts."""
    if _sink is None:
        return False
    addr, port = _sink
    policy, outage = _push_degradation()

    def _do() -> None:
        req = urllib.request.Request(
            f"http://{addr}:{port}/{FLIGHT_SCOPE}/{_rank}",
            data=payload, method="PUT")
        with urllib.request.urlopen(req, timeout=2.0):
            pass

    try:
        policy.call(_do, point="flight.push")
    except Exception as e:
        outage.failure(e)
        return False
    outage.success()
    return True


def dump(reason: str = "manual") -> Optional[str]:
    """Write the ring as rank-local JSONL and ship it to the driver.

    Line 1 is the header (rank, reason, dump number, wall and monotonic
    stamps, the clock offset to the store, the event count); each
    further line is one event. Returns the local file's path (None when
    nothing could be written; the push may still have landed), or None
    at once when another dump holds the lock."""
    if not _enabled:
        return None
    # non-blocking: a signal handler on the main thread may interrupt a
    # dump in flight, and blocking on this non-reentrant lock would
    # deadlock it (and eat a preemption's grace window); the dump in
    # flight carries the same ring
    if not _dump_lock.acquire(blocking=False):
        return None
    try:
        global _dump_count
        _dump_count += 1
        events = snapshot()
        header = {
            "flight_header": 1,
            "rank": _rank,
            "reason": reason,
            "dump": _dump_count,
            "time_unix": time.time(),
            "monotonic": time.monotonic(),
            "events": len(events),
        }
        if _last_autotune is not None:
            header["autotune"] = _last_autotune
        header.update(clock_probe())
        lines = [json.dumps(header)]
        for seq, t_mono, t_wall, kind, name, detail in events:
            ev = {
                "seq": seq,
                "t_mono": round(t_mono, 6),
                "t_wall": round(t_wall, 6),
                "kind": kind,
                "name": name,
            }
            if detail:
                for k, v in detail.items():
                    ev.setdefault(k, v)
            lines.append(json.dumps(ev, default=str))
        payload = ("\n".join(lines) + "\n").encode()
        path: Optional[str] = None
        try:
            d = dump_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"flight_rank{_rank}.jsonl")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
        except OSError:
            path = None  # the push below still carries the dump
        _push(payload)
        return path
    finally:
        _dump_lock.release()


def dump_count() -> int:
    return _dump_count


# one rate-limit slot per rule: a flapping rule must not turn the
# recorder into a dump firehose, but two rules firing back to back each
# get their snapshot
_anomaly_last: Dict[str, float] = {}
ANOMALY_DUMP_MIN_INTERVAL_S = 30.0


def anomaly_dump(rule: str,
                 min_interval_s: float = ANOMALY_DUMP_MIN_INTERVAL_S,
                 ) -> Optional[str]:
    """A dump with reason ``anomaly:<rule>``, at most one a rule per
    ``min_interval_s`` (the health monitor's trigger)."""
    if not _enabled:
        return None
    now = time.monotonic()
    last = _anomaly_last.get(rule)
    if last is not None and now - last < min_interval_s:
        return None
    _anomaly_last[rule] = now
    return dump(f"anomaly:{rule}")


# -- cross-rank straggler attribution ----------------------------------------------

def parse_dump(text: str) -> Tuple[dict, List[dict]]:
    """(header, events) of a dump's JSONL. Unparseable lines are
    skipped: a truncated dump still yields what it carries."""
    header: dict = {}
    events: List[dict] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if obj.get("flight_header"):
            header = obj
        else:
            events.append(obj)
    return header, events


def fetch_peer_dump(peer_rank: int) -> Optional[Tuple[dict, List[dict]]]:
    """A peer's last dump from the sink (``GET /flight/<rank>``), or
    None when the sink has none or cannot be reached."""
    if _sink is None:
        return None
    addr, port = _sink
    try:
        with urllib.request.urlopen(
                f"http://{addr}:{port}/{FLIGHT_SCOPE}/{peer_rank}",
                timeout=2.0) as resp:
            text = resp.read().decode("utf-8", "replace")
    except OSError:
        return None
    return parse_dump(text)


def _enqueue_counts(names: Sequence[str], events) -> Dict[str, int]:
    """Enqueue counts of ``names``. Counts, not sets: a tensor enqueued
    every step but missing from this one still reads as behind."""
    want = set(names)
    counts: Dict[str, int] = {}
    for ev in events:
        if isinstance(ev, dict):
            kind, name = ev.get("kind"), ev.get("name")
        else:
            kind, name = ev[3], ev[4]
        if kind == "enqueue" and name in want:
            counts[name] = counts.get(name, 0) + 1
    return counts


def _fmt_names(names: Sequence[str], limit: int = 6) -> str:
    names = list(names)
    head = ", ".join(names[:limit])
    if len(names) > limit:
        head += f" (+{len(names) - limit} more)"
    return head


def straggler_report(pending_names: Sequence[str], world_size: int,
                     my_rank: Optional[int] = None,
                     reason: str = "stall_abort") -> str:
    """Attribute a stall: dump this rank's ring (so the driver and the
    peers see it), fetch every peer's last dump from the sink, and name
    the ranks whose enqueue counts of the tensors still pending here lag
    this rank's. Returns a one-line report ('' with the recorder off)."""
    if not _enabled:
        return ""
    my_rank = _rank if my_rank is None else my_rank
    pending = sorted(set(pending_names))
    path = dump(reason)
    parts: List[str] = []
    stragglers: List[Tuple[int, List[str]]] = []
    unavailable: List[int] = []
    fetched = 0
    if pending and _sink is not None and world_size > 1:
        mine = _enqueue_counts(pending, snapshot())
        # a budget on the whole sweep: a stall is when the sink is most
        # likely wedged, and recovery waits on this report
        fetch_deadline = time.monotonic() + 8.0
        for r in range(world_size):
            if r == my_rank:
                continue
            if time.monotonic() >= fetch_deadline:
                unavailable.append(r)
                continue
            peer = fetch_peer_dump(r)
            if peer is None:
                unavailable.append(r)
                continue
            fetched += 1
            theirs = _enqueue_counts(pending, peer[1])
            behind = [n for n in pending
                      if theirs.get(n, 0) < mine.get(n, 0)]
            if behind:
                stragglers.append((r, behind))
    if stragglers:
        parts.append(
            "suspected straggler "
            + ("rank" if len(stragglers) == 1 else "ranks")
            + " (per peer flight dumps): "
            + "; ".join(f"rank {r} has not submitted {_fmt_names(b)}"
                        for r, b in stragglers))
    if pending and world_size > 1:
        if _sink is None:
            parts.append("no flight sink configured to fetch peer dumps")
        elif unavailable:
            # a peer without a dump may be the dead rank itself
            parts.append(
                "no peer flight dumps available to attribute the stall"
                if not fetched else f"no dumps from ranks {unavailable}")
        elif not stragglers and fetched:
            parts.append("peer dumps show no enqueue lag")
    if pending:
        parts.append(f"locally pending: {_fmt_names(pending)}")
    if path:
        parts.append(f"flight dump: {path}")
    return "; ".join(parts)


# -- triggers: SIGUSR2 on demand, the crash excepthook -------------------------------

def _sigusr2(signum, frame) -> None:
    record("signal_dump", signum=signum)
    dump("sigusr2")
    # chain: an application's own SIGUSR2 handler keeps firing (the
    # recorder is on by default and must not eat the signal)
    prev = _prev_sigusr2
    if callable(prev):
        prev(signum, frame)


def _excepthook(exc_type, exc, tb):
    # a crashing worker leaves its last control-plane moments behind;
    # the traceback is printed whatever the dump does
    try:
        record("crash", exc_type.__name__, error=str(exc)[:200])
        dump("crash")
    finally:
        if _prev_excepthook is not None:
            _prev_excepthook(exc_type, exc, tb)


def install_handlers() -> bool:
    """Arm SIGUSR2 (a dump on demand) and the crash excepthook.
    Idempotent; False when this thread cannot install signal handlers
    (the excepthook is chained all the same)."""
    global _handlers_installed, _prev_excepthook, _prev_sigusr2
    if _handlers_installed:
        return True
    if _prev_excepthook is None and sys.excepthook is not _excepthook:
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
    try:
        prev = _signal.signal(_signal.SIGUSR2, _sigusr2)
    except (ValueError, AttributeError, OSError):
        return False  # not the main thread, or no SIGUSR2 here
    if prev is not _sigusr2 and prev not in (
            _signal.SIG_IGN, _signal.SIG_DFL, None):
        _prev_sigusr2 = prev
    _handlers_installed = True
    return True


def uninstall_handlers() -> None:
    """Put back the SIGUSR2 handler and the excepthook found by
    :func:`install_handlers` (tests and a process that hosts several
    worlds)."""
    global _handlers_installed, _prev_excepthook, _prev_sigusr2
    if sys.excepthook is _excepthook:
        sys.excepthook = _prev_excepthook or sys.__excepthook__
    _prev_excepthook = None
    if _handlers_installed:
        try:
            if _signal.getsignal(_signal.SIGUSR2) is _sigusr2:
                _signal.signal(_signal.SIGUSR2,
                               _prev_sigusr2 or _signal.SIG_DFL)
        except ValueError:
            pass  # not the main thread: the handler stays, disabled
    _prev_sigusr2 = None
    _handlers_installed = False


# -- lifecycle (core/basics.py calls configure and on_shutdown) -----------------------

def _env_first(*names: str) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def configure(knobs=None, *, enabled_override: Optional[bool] = None,
              rank: Optional[int] = None,
              sink_addr: Optional[str] = None,
              sink_port: Optional[int] = None,
              directory: Optional[str] = None,
              capacity: Optional[int] = None,
              handlers: Optional[bool] = None) -> None:
    """Arm the recorder from the knobs (``init()``) or explicit
    overrides (tests). The rank defaults to the launcher's
    ``HOROVOD_RANK``, the sink to the rendezvous store the launcher
    exported, so a worker's dumps reach its driver with no wiring."""
    global _configured, _dir
    want = bool(getattr(knobs, "flight_recorder", True)
                if enabled_override is None else enabled_override)
    if rank is not None:
        set_rank(rank)
    elif _rank < 0:
        env_rank = _env_first("HVD_TPU_RANK", "HOROVOD_RANK")
        if env_rank is not None:
            set_rank(int(env_rank))
    if sink_addr is not None:
        set_sink(sink_addr, sink_port or 0)
    elif _sink is None:
        from .metrics import push_endpoint

        endpoint = push_endpoint()
        if endpoint is not None:
            set_sink(endpoint[0], endpoint[1])
    if directory is not None:
        _dir = directory
    elif not _dir:
        _dir = getattr(knobs, "flight_dir", "") or ""
    cap = capacity if capacity is not None else getattr(
        knobs, "flight_capacity", None)
    if not want:
        disable()
        return
    _configured = True
    enable(cap)
    if handlers if handlers is not None else True:
        install_handlers()


def on_shutdown() -> None:
    """``shutdown()``: stop recording if ``configure()`` started it. The
    handlers stay (they do nothing while disabled); the ring keeps its
    events for inspection."""
    global _configured
    if _configured:
        _configured = False
        disable()


def reset() -> None:
    """Test hook: clear the events and counters and return to the
    disabled, unconfigured state (the handlers stay as they are)."""
    global _configured, _dump_count, _rank, _sink, _dir, _seq
    global _push_policy, _push_outage, _last_autotune
    _push_policy = _push_outage = None
    _anomaly_last.clear()
    disable()
    _configured = False
    _events.clear()
    _seq = itertools.count()
    _dump_count = 0
    _rank = -1
    _sink = None
    _dir = ""
    _last_autotune = None
