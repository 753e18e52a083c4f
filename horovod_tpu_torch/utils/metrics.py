"""Runtime telemetry, the counter part: a thread-safe registry of
counters and gauges that the control plane feeds.

The JAX package's ``utils/metrics.py``, cut to what the launcher's
utilities and elastic training call: ``record_retry`` and
``record_retry_giveup`` (``utils/retry.py``), ``record_fault``
(``utils/faults.py``), ``record_elastic_event`` and
``record_recovery_rung`` (``elastic/``, ``runner/elastic/``;
``horovod_tpu/utils/metrics.py:1245, 1284``) and the replicator's
``record_replication``/``record_replication_error``, and the eager
runtime's counters and gauge (``ops/eager_runtime.py``:
``record_stall_abort``, ``record_fused_batch``, ``set_queue_depth``;
``horovod_tpu/utils/metrics.py:903-919, 1235, 1297``). Its histograms,
per-step ``StepStats``, the Prometheus exposition, the metrics push and
the flight-recorder hooks come with the observability entry (ROADMAP
queue A entry 13).

Cost discipline: off by default, and every record function begins with
``if not _enabled: return``, so a disabled site costs one predicted
branch.
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence

_enabled = False


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


class _Counter:
    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock) -> None:
        self.value = 0.0
        self._lock = lock

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v


class _Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock) -> None:
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v


class MetricFamily:
    """One named metric with a fixed label set; children keyed by the
    label-value tuple (the Prometheus data model)."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Sequence[str] = ()):
        if kind not in ("counter", "gauge"):
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[tuple, object] = {}

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(kv[n] for n in self.labelnames)
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {key}"
            )
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    # children share the family lock: value += v is a
                    # read-modify-write
                    cls = _Counter if self.kind == "counter" else _Gauge
                    child = cls(self._lock)
                    self._children[key] = child
        return child

    def inc(self, v: float = 1.0) -> None:
        self.labels().inc(v)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._children.items())
        return {",".join(key): child.value for key, child in items}


class MetricsRegistry:
    """Thread-safe family registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def _family(self, name: str, kind: str, help: str,
                labelnames: Sequence[str] = ()) -> MetricFamily:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = MetricFamily(name, kind, help, labelnames)
                    self._families[name] = fam
        if fam.kind != kind or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name} re-registered with different "
                f"kind/labels ({fam.kind}/{fam.labelnames} vs "
                f"{kind}/{tuple(labelnames)})"
            )
        return fam

    def counter(self, name, help="", labelnames=()) -> MetricFamily:
        return self._family(name, "counter", help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> MetricFamily:
        return self._family(name, "gauge", help, labelnames)

    def snapshot(self) -> dict:
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        return {f.name: f.snapshot() for f in fams}

    def clear(self) -> None:
        with self._lock:
            self._families.clear()


registry = MetricsRegistry()


def record_retry(point: str) -> None:
    """One backed-off retry of a control-plane call (utils/retry.py),
    labeled by call point (http.put, http.get, ...)."""
    if not _enabled:
        return
    registry.counter(
        "hvd_retries_total",
        "Control-plane retries, by call point", ("point",),
    ).labels(point).inc()


def record_retry_giveup(point: str) -> None:
    """A retried call that exhausted its attempts/deadline and
    re-raised."""
    if not _enabled:
        return
    registry.counter(
        "hvd_retry_giveups_total",
        "Control-plane retry give-ups, by call point", ("point",),
    ).labels(point).inc()


def record_fault(point: str, action: str) -> None:
    """One injected fault fired (utils/faults.py), by injection point
    and action — lets chaos runs prove the faults actually happened."""
    if not _enabled:
        return
    registry.counter(
        "hvd_faults_injected_total",
        "Injected faults fired, by point and action",
        ("point", "action"),
    ).labels(point, action).inc()


def record_elastic_event(kind: str) -> None:
    """An elastic lifecycle transition (round, reset, hosts_updated,
    sync, blacklist, worker_preempted)."""
    if not _enabled:
        return
    registry.counter(
        "hvd_elastic_events_total",
        "Elastic lifecycle transitions, by event", ("event",),
    ).labels(kind).inc()


def record_recovery_rung(rung: str) -> None:
    """One state recovery, by the ladder rung that supplied the
    snapshot: peer / emergency / orbax / local / none."""
    if not _enabled:
        return
    registry.counter(
        "hvd_recovery_rung_total",
        "State recoveries, by ladder rung (peer/emergency/orbax/"
        "local/none)", ("rung",),
    ).labels(rung).inc()


def record_replication(nbytes: int, n_partners: int) -> None:
    """One committed snapshot shipped to ring partners."""
    if not _enabled:
        return
    registry.counter(
        "hvd_replication_snapshots_total",
        "Committed snapshots replicated to ring partners").inc()
    registry.counter(
        "hvd_replication_bytes_total",
        "Snapshot payload bytes shipped to ring partners",
    ).inc(nbytes * max(n_partners, 1))


def record_replication_error() -> None:
    """A replication attempt that reached no ring partner."""
    if not _enabled:
        return
    registry.counter(
        "hvd_replication_errors_total",
        "Snapshot replications that reached no ring partner").inc()


def record_stall_abort() -> None:
    """A stalled collective converted into HorovodInternalError by the
    negotiation watchdog (HOROVOD_STALL_ABORT_S)."""
    if not _enabled:
        return
    registry.counter(
        "hvd_stall_aborts_total",
        "Collectives aborted by the stall watchdog").inc()


def record_fused_batch(op: str, n_tensors: int, nbytes: int) -> None:
    """One negotiated fused batch executed by the eager runtime's data
    plane: the tensors it carried and their bytes, by op (the counter
    half of the JAX ``record_batch_execution``; its latency histogram
    comes with the histograms)."""
    if not _enabled:
        return
    registry.counter(
        "hvd_fused_tensors_total",
        "Tensors carried by executed fused batches", ("op",),
    ).labels(op).inc(n_tensors)
    registry.counter(
        "hvd_fused_batch_bytes_total",
        "Bytes carried by executed fused batches", ("op",),
    ).labels(op).inc(nbytes)


def set_queue_depth(n: int) -> None:
    """Pending tensors in the eager runtime's input table."""
    if not _enabled:
        return
    registry.gauge(
        "hvd_eager_queue_depth",
        "Tensors enqueued and awaiting negotiation/execution").set(n)


def reset() -> None:
    """Test hook: clear every family and return to the disabled
    state."""
    disable()
    registry.clear()
