"""Runtime telemetry, the counter part: a thread-safe registry of
counters and gauges that the control plane feeds.

The JAX package's ``utils/metrics.py``, cut to what the launcher's
utilities call: ``record_retry`` and ``record_retry_giveup``
(``utils/retry.py``) and ``record_fault`` (``utils/faults.py``). Its
histograms, per-step ``StepStats``, the Prometheus exposition, the
metrics push and the flight-recorder hooks come with the observability
entry (ROADMAP queue A entry 13).

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


def reset() -> None:
    """Test hook: clear every family and return to the disabled
    state."""
    disable()
    registry.clear()
