"""Online fleet-health monitor.

The port of the JAX package's ``health/``. ``utils/metrics.py`` exposes
gauges and ``utils/flight.py`` dumps forensics after a crash, but
nothing watches the run while it is still healthy. This package

* folds the live StepStats and serving streams through sliding-window
  **detectors** (``health/detectors.py``) that classify anomalies as
  straggler-host / slow-link / input-bound / compute-regression /
  queue-saturation,
* evaluates declarative **SLO rules** (``health/rules.py``: multi-window
  burn rate for serving TTFT/TPOT/queue-wait, envelopes for training
  step time and MFU), surfacing them as ``hvd_alert_active{rule=...}``
  gauges, JSONL incident records and the ``GET /health`` verdict
  routes (the rendezvous store's and ``ServingServer``'s),
* publishes a compact per-rank summary to the **fleet** evaluator
  (``health/fleet.py``) at the metrics-push endpoint, so the driver
  names suspected straggler ranks live, and
* on a firing rule triggers **forensic capture**: a rate-limited
  flight-recorder dump and a forced ``utils/prof.py`` sample of the
  next step.

Same lifecycle and hot-path discipline as metrics and flight: off by
default (``HOROVOD_HEALTH``), ``configure(knobs)`` from ``init()``, and
every observer entry point opens with the disabled check. Disabled, the
monitor costs nothing on the step path: the metrics-side observer slots
stay ``None``. The publisher thread waits on its stop event, so
``on_shutdown`` returns once its last tick has published.
"""

import json
import os
import threading
import time
from typing import Optional

from . import detectors as _detectors
from . import fleet as _fleet
from . import rules as _rules
from ..utils import flight as _flight
from ..utils import metrics as _metrics
from ..utils import prof as _prof

# -- module state ------------------------------------------------------------

_enabled = False
_configured = False
_lock = threading.Lock()

_step_det: Optional[_detectors.StepDetectors] = None
_serving_det: Optional[_detectors.ServingDetectors] = None
_engine: Optional[_rules.RuleEngine] = None

_rank = 0
_endpoint = None          # (addr, port) push target, None = local only
_interval_s = 2.0
_capture = True
_incident_path = ""
_incident_fh = None

_pub_thread: Optional[threading.Thread] = None
_pub_stop: Optional[threading.Event] = None

_recent_anomalies = []    # last few classified anomalies (bounded)
_incident_count = 0
_RECENT_MAX = 16


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Arm the monitor (installs the metrics-side observers). Usually
    reached through ``configure``; a manual enable uses the default
    detectors and rules."""
    global _enabled, _step_det, _serving_det, _engine
    with _lock:
        if _step_det is None:
            _step_det = _detectors.StepDetectors()
        if _serving_det is None:
            _serving_det = _detectors.ServingDetectors()
        if _engine is None:
            _engine = _rules.RuleEngine(
                _rules.parse_rules(_rules.DEFAULT_RULES))
        _enabled = True
    _metrics.set_step_observer(observe_step)
    _metrics.set_serving_observer(observe_serving)


def disable() -> None:
    global _enabled
    _enabled = False
    _metrics.set_step_observer(None)
    _metrics.set_serving_observer(None)


# -- hot-path observers ------------------------------------------------------

def observe_step(record: dict) -> None:
    """One closed step record (``StepStats.end_step`` calls this through
    the metrics step-observer slot)."""
    if not _enabled:
        return
    det, eng = _step_det, _engine
    if det is None or eng is None:
        return
    with _lock:
        anomalies = det.update(record)
        if anomalies:
            _recent_anomalies.extend(anomalies)
            del _recent_anomalies[:-_RECENT_MAX]
    for a in anomalies:
        _metrics.record_health_anomaly(a["class"])
        _flight.record("health_anomaly", a["class"],
                       signal=a["signal"], value=a["value"])
    dt = record.get("step_time_s")
    if isinstance(dt, (int, float)):
        eng.observe("step_time", float(dt))
    mfu = record.get("mfu")
    if isinstance(mfu, (int, float)):
        eng.observe("mfu", float(mfu))
    _handle_transitions(eng.evaluate())


def observe_serving(kind: str, slo: str, seconds: float) -> None:
    """One serving latency sample (ttft | tpot | queue_wait | request),
    through the metrics serving-observer slot. The rules are evaluated
    on the publisher's tick, so a request pays only the append."""
    if not _enabled:
        return
    eng = _engine
    if eng is None:
        return
    eng.observe(kind, seconds, slo=slo)
    if kind == "queue_wait" and _serving_det is not None:
        with _lock:
            anomalies = _serving_det.update_queue_wait(seconds)
            if anomalies:
                _recent_anomalies.extend(anomalies)
                del _recent_anomalies[:-_RECENT_MAX]
        for a in anomalies:
            _metrics.record_health_anomaly(a["class"])


# -- alert transitions -> gauges, incidents, forensics -----------------------

def _handle_transitions(transitions) -> None:
    global _incident_count
    for t in transitions:
        _metrics.set_alert_active(t["rule"], t["state"] == "fire")
        _metrics.record_health_incident(t["rule"], t["state"])
        rec = {
            "time_unix": time.time(),
            "rank": _rank,
            **t,
        }
        with _lock:
            _incident_count += 1
            fh = _incident_fh
            if fh is not None:
                try:
                    fh.write(json.dumps(rec) + "\n")
                    fh.flush()
                except Exception:
                    pass
        # the incident also lands in the step JSONL as an out-of-band
        # event line, where tools.metrics_summary and trace_merge read it
        _metrics.step_stats.emit_event("incident", rec)
        _flight.record("health_alert", t["rule"], state=t["state"])
        if t["state"] == "fire" and _capture:
            _capture_forensics(t["rule"])


def _capture_forensics(rule: str) -> None:
    """Anomaly-triggered capture: flight dump (rate-limited in
    flight.py) + one forced profiler sample on the next step."""
    try:
        _flight.anomaly_dump(rule)
    except Exception:
        pass
    try:
        _prof.request_sample(f"anomaly:{rule}")
    except Exception:
        pass


# -- summaries ---------------------------------------------------------------

def summary() -> dict:
    """The compact per-rank summary published to the fleet
    evaluator."""
    det, eng = _step_det, _engine
    with _lock:
        recent = list(_recent_anomalies[-8:])
    s = {
        "rank": _rank,
        "time_unix": time.time(),
        "steps": det.steps if det is not None else 0,
        "step_time_recent_s": (
            det.step_time_recent_s() if det is not None else None),
        "alerts": eng.alert_summary() if eng is not None else {},
        "alerts_active": eng.active_count() if eng is not None else 0,
        "anomalies": recent,
        "incidents": _incident_count,
    }
    pod = _metrics.pod_label()
    if pod:
        s["pod"] = pod
    return s


def verdict() -> dict:
    """The local process verdict for ``/healthz`` and the serving
    ``GET /health`` route: off / ok / degraded + active alert names."""
    if not _enabled or _engine is None:
        return {"health": "off", "alerts_active": 0}
    active = [n for n, v in _engine.active().items() if v]
    return {
        "health": "degraded" if active else "ok",
        "alerts_active": len(active),
        "alerts": active,
    }


def incident_count() -> int:
    return _incident_count


# -- publisher thread --------------------------------------------------------

def _pub_loop(stop: threading.Event, interval_s: float) -> None:
    while not stop.wait(max(interval_s, 0.05)):
        _tick()
    _tick()  # final flush: short-lived workers still publish last state


def _tick() -> None:
    """One monitor tick: advance serving rules (they must clear even
    when no new samples arrive) and publish the rank summary."""
    eng = _engine
    if eng is not None:
        _handle_transitions(eng.evaluate())
    ep = _endpoint
    if ep is not None:
        _fleet.publish_once(ep[0], ep[1], _rank, summary())


def _start_publisher(interval_s: float) -> None:
    global _pub_thread, _pub_stop
    _stop_publisher()
    stop = threading.Event()
    t = threading.Thread(target=_pub_loop, args=(stop, interval_s),
                         daemon=True, name="hvd-health")
    t.start()
    _pub_thread, _pub_stop = t, stop


def _stop_publisher() -> None:
    global _pub_thread, _pub_stop
    if _pub_thread is not None:
        _pub_stop.set()
        _pub_thread.join(timeout=5)
        _pub_thread = None
        _pub_stop = None


# -- baseline ----------------------------------------------------------------

def _load_autotune_baseline(path: str):
    """Best-effort (step_s, mfu) from the newest entry of the
    autotuner's persisted cache (``ops/autotune.TuneCache``'s JSON,
    ``HOROVOD_AUTOTUNE_CACHE``, whose entries sit under its
    ``"entries"``; a bare mapping of entries reads too): the cross-run
    reference the step-time and MFU envelopes also guard. Read as plain
    JSON, so health needs nothing of the tuner. (The JAX package's
    loader reads the file's top level, where the cache's envelope holds
    no entry, so it never finds a baseline there: ROADMAP queue C.)"""
    try:
        with open(path) as f:
            data = json.load(f)
        entries = data.get("entries", data)
        newest = max(
            (e for e in entries.values() if isinstance(e, dict)),
            key=lambda e: e.get("time_unix", 0.0), default=None)
        if newest is None:
            return None, None
        step_s = newest.get("step_s")
        mfu = newest.get("mfu")
        return (
            float(step_s) if isinstance(step_s, (int, float)) else None,
            float(mfu) if isinstance(mfu, (int, float)) else None,
        )
    except Exception:
        return None, None


# -- lifecycle (core/basics.py calls these) ----------------------------------

def configure(knobs=None, *, enabled_override: Optional[bool] = None,
              rank: Optional[int] = None, endpoint=None,
              interval_s: Optional[float] = None,
              rules: Optional[str] = None,
              incident_file: Optional[str] = None,
              capture: Optional[bool] = None,
              window: Optional[int] = None,
              min_steps: Optional[int] = None,
              step_time_factor: Optional[float] = None,
              baseline_step_s: Optional[float] = None,
              baseline_mfu: Optional[float] = None) -> None:
    """Arm the monitor per the knobs (``HOROVOD_HEALTH*``) or explicit
    overrides (tests). Knobs that ask for nothing, with no override,
    leave a manual ``enable()`` alone. ``rank`` (``init()`` passes the
    world's) defaults to the launcher's environment, else 0."""
    global _configured, _enabled, _rank, _endpoint, _interval_s
    global _capture, _incident_path, _incident_fh
    global _step_det, _serving_det, _engine

    want = bool(getattr(knobs, "health_enabled", False))
    if enabled_override is not None:
        want = enabled_override
    if not want:
        return

    if rules is None:
        rules = getattr(knobs, "health_rules", "") or ""
    spec = rules or _rules.DEFAULT_RULES
    engine = _rules.RuleEngine(_rules.parse_rules(spec))

    if window is None:
        window = int(getattr(knobs, "health_window", 32) or 32)
    if min_steps is None:
        min_steps = int(getattr(knobs, "health_min_steps", 8) or 8)
    if step_time_factor is None:
        step_time_factor = float(
            getattr(knobs, "health_step_time_factor", 1.75) or 1.75)
    if baseline_step_s is None and baseline_mfu is None:
        cache = getattr(knobs, "autotune_cache", "") or ""
        if cache and os.path.exists(cache):
            baseline_step_s, baseline_mfu = _load_autotune_baseline(cache)
    det = _detectors.StepDetectors(
        window=window, min_steps=min_steps,
        step_time_factor=step_time_factor,
        baseline_step_s=baseline_step_s, baseline_mfu=baseline_mfu)

    with _lock:
        _step_det = det
        _serving_det = _detectors.ServingDetectors(window=4 * window)
        _engine = engine

    if rank is None:
        env_rank = (os.environ.get("HVD_TPU_RANK")
                    or os.environ.get("HOROVOD_RANK"))
        try:
            rank = int(env_rank) if env_rank is not None else 0
        except ValueError:
            rank = 0
    _rank = int(rank)

    if endpoint is None:
        # the fleet summary rides the metrics push's route: the
        # rendezvous store the launcher exported (None outside one)
        endpoint = _metrics.push_endpoint()
    _endpoint = endpoint

    if interval_s is None:
        interval_s = float(
            getattr(knobs, "health_interval_s", 2.0) or 2.0)
    _interval_s = float(interval_s)

    if capture is None:
        capture = bool(getattr(knobs, "health_capture", True))
    _capture = bool(capture)

    if incident_file is None:
        incident_file = getattr(knobs, "health_incident_file", "") or ""
    if incident_file:
        with _lock:
            if _incident_fh is not None:
                _incident_fh.close()
            _incident_path = incident_file
            _incident_fh = open(incident_file, "a")

    _configured = True
    # the monitor rides the metrics stream: without metrics the step
    # observer never fires, so health implies metrics
    _metrics.enable()
    enable()
    _start_publisher(_interval_s)


def on_shutdown() -> None:
    """``shutdown()``: stop publishing, close the incident log, and
    disarm only if ``configure()`` armed the monitor."""
    global _configured, _incident_fh, _incident_path
    _stop_publisher()
    with _lock:
        if _incident_fh is not None:
            try:
                _incident_fh.close()
            except Exception:
                pass
            _incident_fh = None
            _incident_path = ""
    if _configured:
        _configured = False
        disable()


def reset() -> None:
    """Test hook: return to the pristine disabled state."""
    global _configured, _enabled, _step_det, _serving_det, _engine
    global _rank, _endpoint, _interval_s, _capture
    global _recent_anomalies, _incident_count
    on_shutdown()
    disable()
    with _lock:
        _configured = False
        _step_det = None
        _serving_det = None
        _engine = None
        _rank = 0
        _endpoint = None
        _interval_s = 2.0
        _capture = True
        _recent_anomalies = []
        _incident_count = 0
