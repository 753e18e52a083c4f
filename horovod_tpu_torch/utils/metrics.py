"""Runtime telemetry: the metrics registry and per-step stats.

The port of the JAX package's ``utils/metrics.py``: a thread-safe
registry of counters, gauges and fixed-bucket histograms that the hot
paths feed while training runs, exposed as

* Prometheus text (:func:`scrape`, :func:`exposition`) on ``GET
  /metrics``: mounted on the rendezvous/KV HTTP server
  (``runner/http/http_server.py``), which merges the workers' pushes
  (``PUT /metrics_push/<rank>``, :func:`start_metrics_push`) into one
  rank-labeled cluster scrape, and, with ``HOROVOD_METRICS_PORT``, on a
  standalone per-process endpoint (:func:`start_http_server`);
* a JSON-lines log of one record per step (``HOROVOD_TPU_METRICS_FILE``,
  :class:`StepStats`, closed by ``with hvd.metrics.step():``), read by
  ``python -m horovod_tpu_torch.tools.metrics_summary``.

The record sites: the eager collectives (``record_collective``,
``ops/collectives.py``), the fusion plan (``record_fusion_plan``,
``ops/fusion.py``), the DistributedOptimizer's executed reduction
(``record_grad_reduction``, ``record_wire_bytes``,
``optim/distributed.py``), closed timeline spans
(``record_timeline_activity``, ``utils/timeline.py``), the control plane
(``record_retry``/``record_retry_giveup``, ``record_fault``), elastic
training (``record_elastic_event``, ``record_recovery_rung``,
``record_replication``), the eager runtime (``record_stall_abort``,
``record_negotiation_latency``, ``record_batch_execution``,
``set_queue_depth``, its wire's ``record_wire_bytes`` and, pulled at
every scrape through :func:`set_native_stats_provider`, the controller's
cumulative ``hvd_cache_hits_total``/``hvd_coord_*`` and the plan cache's
``hvd_eager_fast_path_*`` gauges), the fused kernels' first launch
(``record_fused_collective``), the FSDP step (``record_fsdp_step``,
``record_overlap_window``), the serving tier (``record_serving_*``,
``set_serving_inflight``, ``set_serving_replicas``), decode
(``record_decode_*``, ``set_decode_slots``) and the replica autoscaler
(``record_autoscale``). The retry, fault, recovery, elastic, eviction
and autoscale records also land in the flight recorder
(``utils/flight.py``), which has its own gate. Still to come: the
autotuner's trail (ROADMAP queue A entry 12); the pod label stays unset
until entry 14. The sampled profiler (``utils/prof.py``) feeds
``record_mfu`` and ``record_step_attribution`` through the step wrapper,
and the health monitor (``health/``) reads each closed step record and
serving latency sample through the observer slots.

Cost discipline: off by default, and every record function begins with
``if not _enabled: return``, so a disabled site costs one predicted
branch and touches no lock. Enabled, an update is a dict lookup and a
float add under its family's lock; no I/O happens on a hot path (the
JSONL writes at step boundaries, the HTTP server and the push in their
own threads).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import threading
import time
import urllib.request
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from . import flight as _flight

_enabled = False
_configured = False  # True when configure() turned metrics on


def enabled() -> bool:
    """Whether telemetry is recording. Callers that assemble a larger
    record (byte totals over buckets) gate on it to skip that work."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


# -- registry ----------------------------------------------------------------

#: latency histogram buckets (seconds): 50 us .. 10 s
LATENCY_BUCKETS: Tuple[float, ...] = (
    50e-6, 100e-6, 250e-6, 500e-6, 1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3,
    50e-3, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: fill-ratio buckets (0..1] for the fusion buffers
RATIO_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0,
)


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


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


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "count", "_lock")

    def __init__(self, buckets: Sequence[float],
                 lock: threading.Lock) -> None:
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # the last: +Inf
        self.sum = 0.0
        self.count = 0
        self._lock = lock

    def observe(self, v: float) -> None:
        with self._lock:
            self.counts[bisect.bisect_left(self.buckets, v)] += 1
            self.sum += v
            self.count += 1


class MetricFamily:
    """One named metric with a fixed label set; children keyed by the
    label-value tuple (the Prometheus data model)."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        if kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets) if buckets else LATENCY_BUCKETS
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
                    # children share the family lock: an update is a
                    # read-modify-write (value += v; bucket, sum, count)
                    if self.kind == "counter":
                        child = _Counter(self._lock)
                    elif self.kind == "gauge":
                        child = _Gauge(self._lock)
                    else:
                        child = _Histogram(self._buckets, self._lock)
                    self._children[key] = child
        return child

    def inc(self, v: float = 1.0) -> None:
        self.labels().inc(v)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def _labelstr(self, key: tuple, extra: str = "") -> str:
        parts = [f'{n}="{_escape_label(v)}"'
                 for n, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            if self.kind in ("counter", "gauge"):
                lines.append(
                    f"{self.name}{self._labelstr(key)} {_fmt(child.value)}")
                continue
            with self._lock:  # a consistent (counts, sum, count) triple
                counts = list(child.counts)
                hsum, hcount = child.sum, child.count
            cum = 0
            for b, c in zip(child.buckets, counts):
                cum += c
                le = 'le="' + _fmt(b) + '"'
                lines.append(
                    f"{self.name}_bucket{self._labelstr(key, le)} {cum}")
            cum += counts[-1]
            inf_labels = self._labelstr(key, 'le="+Inf"')
            lines.append(f"{self.name}_bucket{inf_labels} {cum}")
            lines.append(f"{self.name}_sum{self._labelstr(key)} {_fmt(hsum)}")
            lines.append(f"{self.name}_count{self._labelstr(key)} {hcount}")
        return lines

    def snapshot(self) -> dict:
        out = {}
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            k = ",".join(key)
            if self.kind in ("counter", "gauge"):
                out[k] = child.value
            else:
                with self._lock:
                    out[k] = {"count": child.count, "sum": child.sum}
        return out


class MetricsRegistry:
    """Thread-safe family registry and pre-scrape collector hooks."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}
        self._collectors: List[Callable[[], None]] = []

    def _family(self, name: str, kind: str, help: str,
                labelnames: Sequence[str] = (),
                buckets: Optional[Sequence[float]] = None) -> MetricFamily:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = MetricFamily(name, kind, help, labelnames, buckets)
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

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> MetricFamily:
        return self._family(name, "histogram", help, labelnames, buckets)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn`` runs before every render and snapshot: the pull hook of
        a source that keeps its own cumulative state (the eager
        runtime)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect(self) -> None:
        """Run the collectors, holding no lock of the registry: a
        collector takes its source's lock (the runtime's) and then a
        family's, the order every record site keeps."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                pass  # a dead provider must not break the scrape

    def render(self) -> str:
        self.collect()
        lines: List[str] = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            lines.extend(fam.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        self.collect()
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        return {f.name: f.snapshot() for f in fams}

    def clear(self) -> None:
        with self._lock:
            self._families.clear()
            self._collectors.clear()


registry = MetricsRegistry()

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: the rendezvous KV scope workers push their expositions into (the
#: source of the rendezvous server's aggregated /metrics)
METRICS_PUSH_SCOPE = "metrics_push"


def scrape() -> str:
    """Prometheus text exposition of this process's registry."""
    return registry.render()


def exposition(
    pushed: Optional[Dict[str, bytes]] = None,
) -> Tuple[str, bytes]:
    """``(content type, body)`` of a scrape served over HTTP: the one
    definition the standalone endpoint and the rendezvous server mount.

    With ``pushed`` (rank label -> exposition payload, as the rendezvous
    server holds the workers' ``PUT /metrics_push/<rank>``) the scrape
    is the cluster's: this process's series stay unlabeled and every
    pushed series gains a ``rank="<r>"`` label (and ``pod="<pod>"`` for
    a ``<rank>@<pod>`` key)."""
    if not pushed:
        return PROM_CONTENT_TYPE, scrape().encode()
    payloads: List[Tuple[str, str]] = [("", scrape())]
    for rank_label in sorted(pushed, key=lambda r: (len(r), r)):
        body = pushed[rank_label]
        text = (body.decode("utf-8", "replace")
                if isinstance(body, (bytes, bytearray)) else str(body))
        payloads.append((rank_label, text))
    return PROM_CONTENT_TYPE, merge_expositions(payloads).encode()


def merge_expositions(payloads: Iterable[Tuple[str, str]]) -> str:
    """Merge Prometheus text payloads into one exposition, adding a
    ``rank`` label to every sample of a payload with a non-empty label
    (and a ``pod`` label when the label is ``<rank>@<pod>``). Families
    are regrouped so that HELP/TYPE appear once, before all of a
    family's samples, as parsers and :func:`lint_exposition` require."""
    help_: Dict[str, str] = {}
    type_: Dict[str, str] = {}
    samples: Dict[str, List[str]] = {}
    order: List[str] = []
    for rank_label, text in payloads:
        fam: Optional[str] = None
        for line in text.splitlines():
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                name, _, tail = line[7:].partition(" ")
                if not name:
                    continue
                target = help_ if line.startswith("# HELP ") else type_
                target.setdefault(name, tail)
                fam = name
                continue
            if not line.strip() or line.startswith("#"):
                continue
            key, _, val = line.rpartition(" ")
            if not key:
                continue
            name, brace, labels = key.partition("{")
            family = (
                fam if fam and name in (
                    fam, fam + "_bucket", fam + "_sum", fam + "_count")
                else name
            )
            if rank_label:
                rank_part, _, pod_part = str(rank_label).partition("@")
                extra = f'rank="{_escape_label(rank_part)}"'
                if pod_part:
                    extra += f',pod="{_escape_label(pod_part)}"'
                inner = labels[:-1] if brace else ""
                line = (f"{name}{{" + (inner + "," if inner else "")
                        + extra + f"}} {val}")
            bucket = samples.get(family)
            if bucket is None:
                bucket = samples[family] = []
                order.append(family)
            bucket.append(line)
    out: List[str] = []
    for family in order:
        if family in help_:
            out.append(f"# HELP {family} {help_[family]}")
        if family in type_:
            out.append(f"# TYPE {family} {type_[family]}")
        out.extend(samples[family])
    return "\n".join(out) + ("\n" if out else "")


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"           # metric name
    r"(?:\{(.*)\})?"                          # optional label block
    r" (NaN|[+-]?Inf|-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)$"
)
_LABEL_RE = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')
_PROM_KINDS = ("counter", "gauge", "histogram", "summary", "untyped")


def _split_labels(block: str) -> List[str]:
    """Split 'a="x",b="y,z"' on the commas outside quotes."""
    parts, buf, in_q, esc = [], [], False, False
    for ch in block:
        if esc:
            buf.append(ch)
            esc = False
        elif ch == "\\":
            buf.append(ch)
            esc = True
        elif ch == '"':
            buf.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return parts


def lint_exposition(text: str) -> List[str]:
    """Validate Prometheus text exposition; returns the problems (empty:
    parseable). Checks the sample grammar, label syntax, TYPE kinds,
    TYPE before samples, duplicate series, and histogram buckets
    cumulative with a closing ``le="+Inf"``."""
    errors: List[str] = []
    typed: Dict[str, str] = {}
    seen: set = set()
    hist: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            name, _, tail = line[7:].partition(" ")
            if not name:
                errors.append(f"line {i}: malformed comment header")
                continue
            if line.startswith("# TYPE "):
                if tail not in _PROM_KINDS:
                    errors.append(f"line {i}: unknown TYPE {tail!r}")
                if name in typed:
                    errors.append(f"line {i}: duplicate TYPE for {name}")
                typed[name] = tail
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {i}: unparseable sample: {line!r}")
            continue
        name, labels, val = m.groups()
        label_parts = _split_labels(labels) if labels else []
        for part in label_parts:
            if not _LABEL_RE.match(part):
                errors.append(f"line {i}: bad label {part!r}")
        key = (name, labels or "")
        if key in seen:
            errors.append(f"line {i}: duplicate series {name}{{{labels}}}")
        seen.add(key)
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed:
                family = name[: -len(suffix)]
                break
        if family not in typed:
            errors.append(f"line {i}: sample {name} precedes its TYPE header")
        if typed.get(family) == "histogram" and name == family + "_bucket":
            le, rest = None, []
            for part in label_parts:
                if part.startswith('le="'):
                    le = part[4:-1]
                else:
                    rest.append(part)
            if le is None:
                errors.append(f"line {i}: histogram bucket missing le=")
            else:
                hist.setdefault((family, ",".join(rest)), []).append(
                    (float("inf") if le == "+Inf" else float(le),
                     float(m.group(3))))
    for (family, series), buckets in hist.items():
        buckets.sort(key=lambda b: b[0])
        if not buckets or buckets[-1][0] != float("inf"):
            errors.append(f'{family}{{{series}}}: histogram lacks le="+Inf"')
        cum = -1.0
        for le, v in buckets:
            if v < cum:
                errors.append(f"{family}{{{series}}}: bucket counts not "
                              f"cumulative at le={le}")
                break
            cum = v
    return errors


# -- per-step aggregation ------------------------------------------------------

class StepStats:
    """Accumulates telemetry between ``begin_step`` and ``end_step`` and
    emits one JSONL record a step: the step's host time, collectives by
    op and dtype, the fusion plans and their fill, gradient and wire
    bytes, the eager queue depth, elastic events and retries."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._log_fh = None
        self._log_path = ""
        self.step = 0
        self._t0: Optional[float] = None
        self._last_native: Dict[str, float] = {}
        self._reset_interval()

    def _reset_interval(self) -> None:
        self.collectives: Dict[str, List[float]] = {}  # op/dtype -> [n, B]
        self.neg_count = 0  # the eager runtime's negotiation latencies
        self.neg_sum = 0.0
        self.fusion_plans = 0
        self.fusion_buckets = 0
        self.fusion_fill_sum = 0.0
        self.grad_bytes = 0
        self.wire_logical = 0
        self.wire_sent = 0
        self.overlap_window = None  # the staged schedule's pin (0..1)
        self.fsdp_param_bytes = None  # a rank's resident parameter bytes
        self.fsdp_gather_bytes = 0  # forward all-gather bytes
        self.fsdp_regather_bytes = 0  # backward re-gather bytes
        self.fsdp_offload_bytes = 0  # stage carries parked on the host
        self.queue_depth = 0
        self.elastic_events: List[str] = []
        self.mfu = None  # model-FLOPs utilization of the step (0..1)
        self.attribution = None  # the last sampled step's attribution
        self.retries: Dict[str, int] = {}
        self.retry_giveups: Dict[str, int] = {}

    def add_collective(self, op: str, dtype: str, nbytes: int) -> None:
        with self._lock:
            ent = self.collectives.setdefault(f"{op}/{dtype}", [0, 0])
            ent[0] += 1
            ent[1] += int(nbytes)

    def add_negotiation(self, seconds: float) -> None:
        with self._lock:
            self.neg_count += 1
            self.neg_sum += seconds

    def add_fusion(self, n_buckets: int, fill_sum: float) -> None:
        with self._lock:
            self.fusion_plans += 1
            self.fusion_buckets += n_buckets
            self.fusion_fill_sum += fill_sum

    def add_grad_bytes(self, nbytes: int) -> None:
        with self._lock:
            self.grad_bytes += int(nbytes)

    def add_wire(self, logical: int, sent: int) -> None:
        with self._lock:
            self.wire_logical += int(logical)
            self.wire_sent += int(sent)

    def set_overlap_window(self, frac: float) -> None:
        with self._lock:
            self.overlap_window = float(frac)

    def add_fsdp(self, param_bytes: int, gather_bytes: int,
                 regather_bytes: int = 0, offload_bytes: int = 0) -> None:
        with self._lock:
            self.fsdp_param_bytes = int(param_bytes)
            self.fsdp_gather_bytes += int(gather_bytes)
            self.fsdp_regather_bytes += int(regather_bytes)
            self.fsdp_offload_bytes += int(offload_bytes)

    def add_elastic_event(self, kind: str) -> None:
        with self._lock:
            self.elastic_events.append(kind)

    def add_retry(self, point: str) -> None:
        with self._lock:
            self.retries[point] = self.retries.get(point, 0) + 1

    def add_retry_giveup(self, point: str) -> None:
        with self._lock:
            self.retry_giveups[point] = self.retry_giveups.get(point, 0) + 1

    def set_queue_depth(self, n: int) -> None:
        self.queue_depth = int(n)

    def set_mfu(self, mfu: float) -> None:
        with self._lock:
            self.mfu = float(mfu)

    def set_attribution(self, attribution: dict) -> None:
        """The last sampled step's device attribution (``utils/prof.py``).
        It is parsed off the step's thread, so it lands in the record of
        the step during which the parse finished; its ``sampled_step``
        names the step measured."""
        with self._lock:
            self.attribution = dict(attribution)

    def emit_event(self, kind: str, payload: dict) -> None:
        """One out-of-band line in the JSONL, ``{"event": kind, kind:
        payload}``, written at once rather than at a step's end (a health
        incident); ``tools.metrics_summary`` keeps such lines apart from
        the step records."""
        with self._lock:
            if self._log_fh is None:
                return
            rec = {"event": kind, "time_unix": time.time(),
                   kind: dict(payload)}
            self._log_fh.write(json.dumps(rec) + "\n")
            self._log_fh.flush()

    def open_log(self, path: str) -> None:
        with self._lock:
            if self._log_fh is not None:
                self._log_fh.close()
            self._log_path = path
            self._log_fh = open(path, "a")

    def close_log(self) -> None:
        with self._lock:
            if self._log_fh is not None:
                self._log_fh.close()
                self._log_fh = None
                self._log_path = ""

    def begin_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self, extra: Optional[dict] = None) -> dict:
        """Close the interval: build the record, write it to the JSONL,
        feed the step series of the registry, reset the accumulators."""
        now = time.perf_counter()
        dt = (now - self._t0) if self._t0 is not None else 0.0
        self._t0 = None
        # the provider takes the runtime's lock: read it before ours
        native = _native_stats_snapshot()
        with self._lock:
            self.step += 1
            n_coll = sum(v[0] for v in self.collectives.values())
            record = {
                "step": self.step,
                "time_unix": time.time(),
                "step_time_s": dt,
                "collectives": {
                    k: {"count": int(v[0]), "bytes": int(v[1])}
                    for k, v in sorted(self.collectives.items())
                },
                "negotiation": {
                    "count": self.neg_count, "sum_s": self.neg_sum,
                },
                "fusion": {
                    "plans": self.fusion_plans,
                    "buckets": self.fusion_buckets,
                    "fill_ratio_mean": (
                        self.fusion_fill_sum / self.fusion_buckets
                        if self.fusion_buckets else 0.0
                    ),
                },
                "grad_bytes": self.grad_bytes,
                "queue_depth": self.queue_depth,
                "elastic_events": list(self.elastic_events),
            }
            if self.wire_logical or self.wire_sent:
                record["wire"] = {
                    "logical_bytes": self.wire_logical,
                    "sent_bytes": self.wire_sent,
                }
            if self.overlap_window is not None:
                record["overlap_window_frac"] = self.overlap_window
            if self.fsdp_param_bytes is not None:
                record["fsdp"] = {
                    "hbm_param_bytes": self.fsdp_param_bytes,
                    "gather_bytes": self.fsdp_gather_bytes,
                    "regather_bytes": self.fsdp_regather_bytes,
                    "offload_bytes": self.fsdp_offload_bytes,
                }
            if self.mfu is not None:
                record["mfu"] = self.mfu
            if self.attribution is not None:
                record["attribution"] = self.attribution
            if self.retries:
                record["retries"] = dict(self.retries)
            if self.retry_giveups:
                record["retry_giveups"] = dict(self.retry_giveups)
            if _pod_label:
                record["pod"] = _pod_label
            if native:
                delta = {
                    k: native[k] - self._last_native.get(k, 0.0)
                    for k in ("cache_hits", "bytes_negotiated",
                              "stall_warnings")
                    if k in native
                }
                hits = delta.get("cache_hits", 0.0)
                record["native"] = {
                    **{k: int(v) for k, v in delta.items()},
                    # hits against the collectives issued this step: the
                    # controller's cache counts no lookups of its own
                    "cache_hit_rate": (
                        min(hits / n_coll, 1.0) if n_coll else 0.0),
                }
                if "cycles" in native:
                    record["native"]["coord_cycles"] = int(native["cycles"])
                self._last_native = native
            if extra:
                record.update(extra)
            # written under the lock: close_log (shutdown, maybe on
            # another thread) takes it too
            if self._log_fh is not None:
                self._log_fh.write(json.dumps(record) + "\n")
                self._log_fh.flush()
            self._reset_interval()
        if _enabled:
            registry.counter(
                "hvd_steps_total", "Completed training steps").inc()
            registry.histogram(
                "hvd_step_seconds", "Step wall time").observe(dt)
        obs = _step_observer
        if obs is not None:
            try:
                obs(record)
            except Exception:
                # a broken detector must not take the step loop down
                pass
        return record


step_stats = StepStats()

# the step wrapper (begin_step() -> token, end_step(token)) runs around
# every ``step()`` body, the step observer gets each closed record and
# the serving observer each serving latency sample; the profiler
# (``utils/prof.py``) and the health monitor (``health/``) fill them.
# None, the default, costs one load and an is-None check a step
_step_wrapper = None
_step_observer = None
_serving_observer = None


def set_step_wrapper(wrapper) -> None:
    """Install (or remove, None) the step wrapper: ``wrapper.begin_step()``
    runs before the step body and returns a token,
    ``wrapper.end_step(token)`` after it and before the record closes,
    so what it adds to ``step_stats`` lands in the step's record."""
    global _step_wrapper
    _step_wrapper = wrapper


def set_step_observer(fn) -> None:
    """Install (or remove, None) the observer ``fn(record)``, called
    after each record closes, outside the stats lock."""
    global _step_observer
    _step_observer = fn


def set_serving_observer(fn) -> None:
    """Install (or remove, None) the serving-latency observer
    ``fn(kind, slo, seconds)``, kind one of ttft, tpot, queue_wait,
    request: the health monitor's burn-rate feed."""
    global _serving_observer
    _serving_observer = fn


@contextlib.contextmanager
def step(extra: Optional[dict] = None):
    """Mark one training step: ``with hvd.metrics.step(): step_fn(...)``.
    Its time is the host's, from entering to leaving the block: a caller
    that wants the device's time reads a result of the step inside the
    block. A no-op when metrics are off and no step wrapper is set."""
    # both gates read once: an enable()/disable() mid-step must not
    # split a begin from its end
    w = _step_wrapper
    en = _enabled
    if not en and w is None:
        yield step_stats
        return
    token = w.begin_step() if w is not None else None
    if en:
        step_stats.begin_step()
    try:
        yield step_stats
    finally:
        if w is not None:
            w.end_step(token)
        if en:
            step_stats.end_step(extra)


# -- record functions (each begins with the disabled fast path) ----------------

def record_collective(op: str, dtype: str, nbytes: int) -> None:
    """One issued eager collective (``ops/collectives.py``)."""
    if not _enabled:
        return
    registry.counter(
        "hvd_collectives_total",
        "Collectives issued, by op and dtype", ("op", "dtype"),
    ).labels(op, dtype).inc()
    registry.counter(
        "hvd_collective_bytes_total",
        "Payload bytes of issued collectives, by op and dtype",
        ("op", "dtype"),
    ).labels(op, dtype).inc(nbytes)
    step_stats.add_collective(op, dtype, nbytes)


def record_fusion_plan(n_tensors: int, n_buckets: int, threshold: int,
                       bucket_bytes: Sequence[int] = ()) -> None:
    """One fusion plan (``ops/fusion.pytree_bucket_plan``): its bucket
    count and each bucket's fill of the threshold."""
    if not _enabled:
        return
    registry.counter("hvd_fusion_plans_total", "Fusion plans computed").inc()
    registry.counter(
        "hvd_fusion_buckets_total", "Fusion buckets produced").inc(n_buckets)
    registry.counter(
        "hvd_fusion_tensors_total", "Tensors entering fusion plans"
    ).inc(n_tensors)
    fill_sum = 0.0
    hist = registry.histogram(
        "hvd_fusion_fill_ratio",
        "Bucket bytes / fusion threshold per produced bucket",
        buckets=RATIO_BUCKETS,
    )
    for b in bucket_bytes:
        r = min(b / threshold, 1.0) if threshold else 0.0
        hist.observe(r)
        fill_sum += r
    step_stats.add_fusion(n_buckets, fill_sum)


def record_grad_reduction(nbytes: int, n_buckets: int) -> None:
    """One executed gradient reduction: the DistributedOptimizer's
    ``synchronize`` of a step (``optim/distributed.py``)."""
    if not _enabled:
        return
    registry.counter(
        "hvd_grad_reduced_bytes_total",
        "Gradient bytes moved by executed reductions").inc(nbytes)
    registry.counter(
        "hvd_grad_reductions_total", "Executed gradient reductions").inc()
    step_stats.add_grad_bytes(nbytes)


def record_wire_bytes(logical: int, sent: int) -> None:
    """One step's gradient payload at logical precision against what the
    ``HOROVOD_COMPRESSION`` wire moves (payload and scales); equal on
    the uncompressed wire. ``tools.metrics_summary`` reports the
    ratio."""
    if not _enabled:
        return
    registry.counter(
        "hvd_wire_bytes_logical_total",
        "Collective payload bytes at logical precision").inc(int(logical))
    registry.counter(
        "hvd_wire_bytes_sent_total",
        "Collective payload bytes on the compressed wire").inc(int(sent))
    step_stats.add_wire(int(logical), int(sent))


def record_negotiation_latency(seconds: float) -> None:
    """One tensor's wait in the eager runtime from its enqueue to the
    negotiated batch that carries it."""
    if not _enabled:
        return
    registry.histogram(
        "hvd_negotiation_seconds",
        "Enqueue-to-negotiated latency in the eager runtime",
    ).observe(seconds)
    step_stats.add_negotiation(seconds)


def record_batch_execution(op: str, n_tensors: int, nbytes: int,
                           seconds: float) -> None:
    """One fused batch executed by the eager runtime's data plane,
    negotiated or replayed from the plan cache: its host seconds in the
    executor, its tensors and bytes, by op."""
    if not _enabled:
        return
    registry.histogram(
        "hvd_batch_execution_seconds",
        "Fused-batch execution wall time, by op", ("op",),
    ).labels(op).observe(seconds)
    registry.counter(
        "hvd_fused_tensors_total",
        "Tensors carried by executed fused batches", ("op",),
    ).labels(op).inc(n_tensors)
    registry.counter(
        "hvd_fused_batch_bytes_total",
        "Bytes carried by executed fused batches", ("op",),
    ).labels(op).inc(nbytes)


def record_fused_collective(surface: str) -> None:
    """A fused computation-collective kernel's surface, recorded once a
    process at its first launch on the card (``ops/quantized_collectives``,
    ``ops/ring_pack``, ``ops/decode_attention``; the JAX package records
    it at lowering): a breadcrumb of which fused surfaces ran, not a
    step counter, since fusion moves the same bytes."""
    if not _enabled:
        return
    registry.gauge(
        "hvd_fused_collectives_enabled",
        "1 when the fused Pallas collective backend is selected").set(1)
    registry.counter(
        "hvd_fused_collective_lowerings_total",
        "Fused computation-collective kernels lowered, by surface",
        labelnames=("surface",)).labels(surface=surface).inc()


def record_overlap_window(frac: float) -> None:
    """The staged step's overlap pin (``ops/overlap.py``): the share of
    the backward's cost that runs after the first gradient collective
    is issued, the least overlap window a correct schedule grants."""
    if not _enabled:
        return
    registry.gauge(
        "hvd_overlap_window_frac",
        "Backward fraction pinned after the first gradient collective "
        "by the overlap schedule").set(float(frac))
    step_stats.set_overlap_window(frac)


def record_fsdp_step(param_bytes: int, gather_bytes: int,
                     regather_bytes: int = 0,
                     offload_bytes: int = 0) -> None:
    """One executed FSDP step (``ops/overlap.py``): a rank's resident
    parameter bytes (about 1/world of the replicated size), the bytes
    its forward all-gathers materialized, the backward's re-gathers
    (regather mode) and the stage carries parked on the host
    (HOROVOD_FSDP_OFFLOAD)."""
    if not _enabled:
        return
    registry.gauge(
        "hvd_hbm_param_bytes",
        "Per-device parameter bytes resident in HBM (sharded "
        "footprint under FSDP; replicated size otherwise)").set(
            float(param_bytes))
    registry.counter(
        "hvd_fsdp_gather_bytes_total",
        "Full-precision parameter bytes materialized by FSDP forward "
        "all-gathers").inc(float(gather_bytes))
    if regather_bytes:
        registry.counter(
            "hvd_fsdp_regather_bytes_total",
            "Full-precision parameter bytes re-materialized by FSDP "
            "backward re-gathers (regather mode)").inc(
                float(regather_bytes))
    if offload_bytes:
        registry.counter(
            "hvd_fsdp_offload_bytes_total",
            "Stage-boundary activation bytes offloaded to host RAM "
            "per step (HOROVOD_FSDP_OFFLOAD)").inc(float(offload_bytes))
    step_stats.add_fsdp(param_bytes, gather_bytes, regather_bytes,
                        offload_bytes)


def record_timeline_activity(activity: str, seconds: float) -> None:
    """A closed timeline span (``utils/timeline.py``) into a latency
    histogram keyed by its activity."""
    if not _enabled:
        return
    registry.histogram(
        "hvd_timeline_activity_seconds",
        "Host-side timeline phase durations, by activity", ("activity",),
    ).labels(activity).observe(seconds)


def record_retry(point: str) -> None:
    """One backed-off retry of a control-plane call (``utils/retry.py``),
    by call point (http.put, http.get, ...)."""
    _flight.record("retry", point)  # the recorder has its own gate
    if not _enabled:
        return
    registry.counter(
        "hvd_retries_total",
        "Control-plane retries, by call point", ("point",),
    ).labels(point).inc()
    step_stats.add_retry(point)


def record_retry_giveup(point: str) -> None:
    """A retried call that exhausted its attempts or deadline and
    re-raised."""
    _flight.record("retry_giveup", point)
    if not _enabled:
        return
    registry.counter(
        "hvd_retry_giveups_total",
        "Control-plane retry give-ups, by call point", ("point",),
    ).labels(point).inc()
    step_stats.add_retry_giveup(point)


def record_fault(point: str, action: str) -> None:
    """One injected fault fired (``utils/faults.py``), by injection point
    and action."""
    _flight.record("fault", point, action=action)
    if not _enabled:
        return
    registry.counter(
        "hvd_faults_injected_total",
        "Injected faults fired, by point and action",
        ("point", "action"),
    ).labels(point, action).inc()


def record_stall_abort() -> None:
    """A stalled collective converted into HorovodInternalError by the
    negotiation watchdog (HOROVOD_STALL_ABORT_S)."""
    if not _enabled:
        return
    registry.counter(
        "hvd_stall_aborts_total",
        "Collectives aborted by the stall watchdog").inc()


def record_recovery_rung(rung: str) -> None:
    """One state recovery, by the ladder rung that supplied the
    snapshot: peer / emergency / orbax / local / none."""
    _flight.record("recovery", rung)
    if not _enabled:
        return
    registry.counter(
        "hvd_recovery_rung_total",
        "State recoveries, by ladder rung (peer/emergency/orbax/"
        "local/none)", ("rung",),
    ).labels(rung).inc()
    step_stats.add_elastic_event(f"recovery:{rung}")


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


def record_elastic_event(kind: str) -> None:
    """An elastic lifecycle transition (round, reset, hosts_updated,
    sync, blacklist, worker_preempted)."""
    _flight.record("elastic", kind)
    if not _enabled:
        return
    registry.counter(
        "hvd_elastic_events_total",
        "Elastic lifecycle transitions, by event", ("event",),
    ).labels(kind).inc()
    step_stats.add_elastic_event(kind)


def record_mfu(mfu: float) -> None:
    """Model-FLOPs utilization of the step just closed: the declared
    model FLOPs over (step time x cards x the card's peak FLOP/s;
    ``utils/mfu.py``), computed by ``utils/prof.py`` once
    ``prof.set_step_flops`` declared the step's cost."""
    if not _enabled:
        return
    registry.gauge(
        "hvd_mfu",
        "Model-FLOPs utilization of the last completed step").set(
            float(mfu))
    step_stats.set_mfu(mfu)


def record_step_attribution(attribution: dict) -> None:
    """One sampled step's device attribution (``utils/prof.py`` ->
    ``utils/kineto.attribute``): where its wall time went, compute,
    exposed collective wire (collective time not hidden under compute)
    and idle; ``measured_overlap_frac`` is the collective time the card
    hid under compute."""
    if not _enabled:
        return
    if "compute_frac" in attribution:
        registry.gauge(
            "hvd_step_compute_frac",
            "Compute fraction of the last sampled step's wall time",
        ).set(float(attribution["compute_frac"]))
    if "exposed_wire_frac" in attribution:
        registry.gauge(
            "hvd_step_exposed_wire_frac",
            "Exposed (un-overlapped) collective fraction of the last "
            "sampled step's wall time",
        ).set(float(attribution["exposed_wire_frac"]))
    if "idle_frac" in attribution:
        registry.gauge(
            "hvd_step_idle_frac",
            "Device-idle fraction of the last sampled step's wall "
            "time").set(float(attribution["idle_frac"]))
    overlap = attribution.get("measured_overlap_frac")
    # -1: the sample held no collectives (overlap undefined); keeping the
    # previous sample's value would pair a stale overlap with fresh
    # fractions
    registry.gauge(
        "hvd_overlap_window_measured_frac",
        "Measured overlapped share of collective time in the last "
        "sampled step (1.0 = wire fully hidden under compute; -1 = no "
        "collectives in the sample; the measured twin of "
        "hvd_overlap_window_frac)",
    ).set(-1.0 if overlap is None else float(overlap))
    step_stats.set_attribution(attribution)


def set_queue_depth(n: int) -> None:
    """Pending tensors in the eager runtime's input table."""
    if not _enabled:
        return
    registry.gauge(
        "hvd_eager_queue_depth",
        "Tensors enqueued and awaiting negotiation/execution").set(n)
    step_stats.set_queue_depth(n)


# -- the serving tier (``serving/``: engine, batcher, server, dispatch) ------

def record_serving_request(seconds: float, code: int) -> None:
    """One completed front-end request (``serving/server.py``), by HTTP
    status."""
    if not _enabled:
        return
    registry.counter(
        "hvd_serving_requests_total",
        "Serving requests completed, by HTTP status", ("code",),
    ).labels(str(code)).inc()
    registry.histogram(
        "hvd_serving_request_seconds",
        "End-to-end serving request latency, by HTTP status", ("code",),
    ).labels(str(code)).observe(seconds)


def record_serving_queue_wait(seconds: float,
                              slo: str = "standard") -> None:
    """One request's wait in the batching queue, admission to dispatch,
    by SLO class."""
    if not _enabled:
        return
    registry.histogram(
        "hvd_serving_queue_wait_seconds",
        "Request wait in the dynamic-batching queue, by SLO class",
        ("slo",),
    ).labels(slo).observe(seconds)
    obs = _serving_observer
    if obs is not None:
        obs("queue_wait", slo, seconds)


def record_serving_ttft(seconds: float, slo: str = "standard") -> None:
    """Time to first token, admission to the first emitted token, by SLO
    class; the health burn-rate rules read it."""
    if not _enabled:
        return
    registry.histogram(
        "hvd_serving_ttft_seconds",
        "Time to first token per request, by SLO class", ("slo",),
    ).labels(slo).observe(seconds)
    obs = _serving_observer
    if obs is not None:
        obs("ttft", slo, seconds)


def record_serving_tpot(seconds: float, slo: str = "standard") -> None:
    """Time per output token: one decode iteration's wall time billed
    to each live sequence it advanced, by SLO class."""
    if not _enabled:
        return
    registry.histogram(
        "hvd_serving_tpot_seconds",
        "Time per output token for live sequences, by SLO class",
        ("slo",),
    ).labels(slo).observe(seconds)
    obs = _serving_observer
    if obs is not None:
        obs("tpot", slo, seconds)


def record_serving_batch(bucket: int, n_real: int) -> None:
    """One executed inference batch: its padded bucket and the real
    examples it carried (the rest is padding)."""
    if not _enabled:
        return
    registry.counter(
        "hvd_serving_batches_total",
        "Inference batches executed, by padded bucket", ("bucket",),
    ).labels(str(bucket)).inc()
    registry.counter(
        "hvd_serving_examples_total",
        "Real examples served through executed batches").inc(n_real)
    registry.counter(
        "hvd_serving_padding_examples_total",
        "Padding examples added to reach the bucket size",
    ).inc(max(bucket - n_real, 0))
    registry.histogram(
        "hvd_serving_batch_fill_ratio",
        "Real examples / padded bucket size per executed batch",
        buckets=RATIO_BUCKETS,
    ).observe(n_real / bucket if bucket else 0.0)


def record_serving_compile(bucket: int, seconds: float) -> None:
    """One bucket's step built by an engine: on the card the capture of
    its CUDA graph, the port's counterpart of the JAX package's AOT
    compile (on the CPU, which has no graphs, the step is only created
    and its seconds are 0)."""
    if not _enabled:
        return
    registry.counter(
        "hvd_serving_compiles_total",
        "Bucket executables AOT-compiled, by bucket", ("bucket",),
    ).labels(str(bucket)).inc()
    registry.histogram(
        "hvd_serving_compile_seconds",
        "AOT compile wall time per bucket executable",
    ).observe(seconds)


def set_serving_inflight(n: int, replica: str = "") -> None:
    """Requests in flight, by replica ('' = this process's server)."""
    if not _enabled:
        return
    registry.gauge(
        "hvd_serving_inflight",
        "In-flight serving requests, by replica", ("replica",),
    ).labels(replica).set(n)


def record_serving_failover(replica: str) -> None:
    """A replica ejected from dispatch after a failed request (the
    request itself is retried on another)."""
    if not _enabled:
        return
    registry.counter(
        "hvd_serving_failovers_total",
        "Replicas ejected from dispatch after a failure", ("replica",),
    ).labels(replica).inc()


# -- decode (``serving/decode.py``, ``serving/scheduler.py``) -----------------

def record_decode_prefill(bucket: int, seconds: float) -> None:
    """One prompt prefilled into a claimed slot, by prompt-length
    bucket."""
    if not _enabled:
        return
    registry.counter(
        "hvd_serving_decode_prefills_total",
        "Prompts prefilled into cache slots, by prompt-length bucket",
        ("bucket",),
    ).labels(str(bucket)).inc()
    registry.histogram(
        "hvd_serving_decode_prefill_seconds",
        "Prefill executable wall time per admitted prompt",
    ).observe(seconds)


def record_decode_iteration(slots: int, seconds: float) -> None:
    """One decode iteration (every slot advances one position), its
    wall time up to the next tokens on the host."""
    if not _enabled:
        return
    registry.counter(
        "hvd_serving_decode_iterations_total",
        "Decode iterations executed").inc()
    registry.histogram(
        "hvd_serving_decode_iteration_seconds",
        "Decode-iteration executable wall time",
    ).observe(seconds)


def record_decode_tokens(n: int) -> None:
    """Tokens delivered to live sequences (inactive slots' ride-along
    outputs excluded)."""
    if not _enabled:
        return
    registry.counter(
        "hvd_serving_decode_tokens_total",
        "Tokens generated for live sequences").inc(n)


def set_decode_slots(total: int, occupied: int, queued: int) -> None:
    """Slot occupancy and queued prefills after a scheduler iteration:
    the signals the replica autoscaler scales on."""
    if not _enabled:
        return
    g = registry.gauge(
        "hvd_serving_decode_slots",
        "Decode cache slots, by state", ("state",))
    g.labels("total").set(total)
    g.labels("occupied").set(occupied)
    registry.gauge(
        "hvd_serving_decode_queued_prefills",
        "Requests admitted but waiting for a free slot").set(queued)
    registry.gauge(
        "hvd_serving_decode_slot_occupancy",
        "Occupied fraction of decode cache slots").set(
            occupied / total if total else 0.0)


def record_decode_eviction(reason: str) -> None:
    """One sequence leaving its slot or the queue, by reason: eos,
    length, deadline, shed, drain or error."""
    _flight.record("decode_evict", reason)
    if not _enabled:
        return
    registry.counter(
        "hvd_serving_decode_evictions_total",
        "Sequences evicted from decode, by reason", ("reason",),
    ).labels(reason).inc()


def record_autoscale(action: str) -> None:
    """One replica-autoscaler decision acted on (grow or shrink)."""
    _flight.record("autoscale", action)
    if not _enabled:
        return
    registry.counter(
        "hvd_serving_autoscale_events_total",
        "Replica autoscaler actions, by direction", ("action",),
    ).labels(action).inc()


def set_serving_replicas(n: int) -> None:
    """Replicas in the front door's dispatch rotation."""
    if not _enabled:
        return
    registry.gauge(
        "hvd_serving_replicas",
        "Replicas in the dispatch rotation").set(n)


# -- the fleet-health monitor (``health/``) -----------------------------------

def set_alert_active(rule: str, active: bool) -> None:
    """1 while the named health rule fires, 0 once it clears."""
    if not _enabled:
        return
    registry.gauge(
        "hvd_alert_active",
        "1 while the named health rule fires, by rule", ("rule",),
    ).labels(rule).set(1.0 if active else 0.0)


def record_health_anomaly(cls: str) -> None:
    """One classified detector anomaly (straggler-host, slow-link,
    input-bound, compute-regression, queue-saturation)."""
    if not _enabled:
        return
    registry.counter(
        "hvd_health_anomalies_total",
        "Detector anomalies, by classified cause", ("cause",),
    ).labels(cls).inc()


def record_health_incident(rule: str, state: str) -> None:
    """One alert transition (fire or clear), by rule and state."""
    if not _enabled:
        return
    registry.counter(
        "hvd_health_incidents_total",
        "Health alert transitions, by rule and state",
        ("rule", "state"),
    ).labels(rule, state).inc()


# -- the eager runtime's cumulative stats, pulled at every scrape ------------

_native_provider: Optional[Callable[[], dict]] = None


def set_native_stats_provider(fn: Optional[Callable[[], dict]]) -> None:
    """The eager runtime registers its cumulative-stats snapshot
    (``EagerRuntime.metrics_snapshot``) here at start and ``None`` at
    shutdown; the gauges below refresh from it at every render."""
    global _native_provider
    _native_provider = fn
    if fn is not None:
        registry.register_collector(_collect_native)


def _native_stats_snapshot() -> Dict[str, float]:
    fn = _native_provider
    if fn is None:
        return {}
    try:
        return {k: float(v) for k, v in fn().items()}
    except Exception:
        return {}


_NATIVE_GAUGES = {
    "cache_hits": ("hvd_cache_hits_total",
                   "Response-cache hits (native runtime, cumulative)"),
    "bytes_negotiated": ("hvd_bytes_negotiated_total",
                         "Tensor bytes negotiated (cumulative)"),
    "stall_warnings": ("hvd_stall_warnings_total",
                       "Stall-inspector warnings (cumulative)"),
    "queue_depth": ("hvd_eager_queue_depth",
                    "Tensors enqueued and awaiting negotiation/execution"),
    "fast_path_hits": (
        "hvd_eager_fast_path_hits_total",
        "Eager collectives that bypassed negotiation via the "
        "steady-state plan cache (cumulative)"),
    "fast_path_steps": (
        "hvd_eager_fast_path_steps_total",
        "Whole steps executed off a cached plan (cumulative)"),
    "fast_path_activations": (
        "hvd_eager_fast_path_activations_total",
        "Plans frozen after steady-state warmup (cumulative)"),
    "fast_path_invalidations": (
        "hvd_eager_fast_path_invalidations_total",
        "Cached plans dropped (deviation/churn/fault, cumulative)"),
    "fast_path_active": (
        "hvd_eager_fast_path_active",
        "1 while a frozen plan is live, 0 otherwise"),
    "negotiation_bypassed_bytes": (
        "hvd_eager_negotiation_bypassed_bytes_total",
        "Tensor bytes whose negotiation the plan cache skipped "
        "(cumulative; the fast-path analog of "
        "hvd_bytes_negotiated_total)"),
    "cycles": ("hvd_coord_cycles_total",
               "Coordinator negotiation cycles (rank 0)"),
    "busy_cycles": ("hvd_coord_busy_cycles_total",
                    "Coordinator cycles that produced responses (rank 0)"),
    "wait_us": ("hvd_coord_wait_seconds_total",
                "Coordinator wall time blocked on worker frames (rank 0)"),
    "work_us": ("hvd_coord_work_seconds_total",
                "Coordinator CPU work per cycle, summed (rank 0)"),
    "bytes_rx": ("hvd_coord_bytes_rx_total",
                 "Control-plane bytes received by the coordinator"),
    "bytes_tx": ("hvd_coord_bytes_tx_total",
                 "Control-plane bytes sent by the coordinator"),
    "cache_hit_positions": ("hvd_coord_cache_hit_positions_total",
                            "Cache-hit positions in coordinator cycles"),
    "responses": ("hvd_coord_responses_total",
                  "Responses emitted by the coordinator"),
}


def _collect_native() -> None:
    """The registry's collector: the provider's snapshot (taken before
    any family lock) into the gauges of ``_NATIVE_GAUGES``."""
    if not _enabled:
        return
    stats = _native_stats_snapshot()
    for key, (name, help) in _NATIVE_GAUGES.items():
        if key in stats:
            v = stats[key]
            if key in ("wait_us", "work_us"):
                v = v / 1e6
            registry.gauge(name, help).set(v)


# -- the standalone endpoint ---------------------------------------------------

_http_server = None
_http_thread = None


def start_http_server(port: int = 0) -> int:
    """Serve ``GET /metrics`` on a port of its own (0: a free one);
    returns the bound port. Idempotent per process."""
    global _http_server, _http_thread
    if _http_server is not None:
        return _http_server.server_address[1]
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            if self.path.split("?", 1)[0].rstrip("/") in ("", "/metrics"):
                ctype, body = exposition()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
            else:
                body = b"not found"
                self.send_response(404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    _http_server = ThreadingHTTPServer(("0.0.0.0", port), _Handler)
    _http_thread = threading.Thread(
        target=_http_server.serve_forever, daemon=True, name="hvd-metrics")
    _http_thread.start()
    return _http_server.server_address[1]


def stop_http_server() -> None:
    global _http_server, _http_thread
    if _http_server is not None:
        _http_server.shutdown()
        _http_server.server_close()
        _http_server = None
        _http_thread = None


def http_port() -> Optional[int]:
    return _http_server.server_address[1] if _http_server else None


# -- the push to the rendezvous store ------------------------------------------

_push_thread: Optional[threading.Thread] = None
_push_stop: Optional[threading.Event] = None
_push_policy = None
_push_outage = None

# the pod of this process under a multipod topology ("" = one pod);
# stamped on the step records. Set by multipod (entry 14)
_pod_label = ""


def set_pod_label(label: str) -> None:
    global _pod_label
    _pod_label = str(label or "")


def pod_label() -> str:
    return _pod_label


def _push_degradation():
    """The push's bounded policy and outage tracker, built on first use:
    a rendezvous outage costs one quick retry within the interval and
    one warning, not one a push; the next interval is the real retry."""
    global _push_policy, _push_outage
    if _push_policy is None:
        import logging

        from . import retry as _retry

        _push_policy = _retry.RetryPolicy(
            max_attempts=2, base_delay_s=0.1, max_delay_s=0.25)
        _push_outage = _retry.Outage(
            logging.getLogger("horovod_tpu_torch.metrics"),
            "metrics push to the rendezvous store")
    return _push_policy, _push_outage


def push_once(addr: str, port: int, rank: int) -> bool:
    """PUT this process's exposition to ``/metrics_push/<rank>`` on the
    rendezvous store. Best effort: a dead driver never stalls a worker,
    and its outage warns once; returns whether the push landed."""
    body = scrape().encode()
    policy, outage = _push_degradation()

    def _do() -> None:
        req = urllib.request.Request(
            f"http://{addr}:{port}/{METRICS_PUSH_SCOPE}/{rank}",
            data=body, method="PUT")
        with urllib.request.urlopen(req, timeout=2.0):
            pass

    try:
        policy.call(_do, point="metrics.push")
    except Exception as e:
        outage.failure(e)
        return False
    outage.success()
    return True


def start_metrics_push(addr: str, port: int, rank: int,
                       interval_s: float = 5.0) -> None:
    """Start (or restart) the push loop: one push now, one an interval,
    and a last one when it stops, so a short-lived worker still
    publishes its final state."""
    global _push_thread, _push_stop
    stop_metrics_push()
    stop = threading.Event()

    def loop():
        push_once(addr, port, rank)
        while not stop.wait(max(interval_s, 0.05)):
            push_once(addr, port, rank)
        push_once(addr, port, rank)

    t = threading.Thread(target=loop, daemon=True, name="hvd-metrics-push")
    t.start()
    _push_thread, _push_stop = t, stop


def stop_metrics_push() -> None:
    global _push_thread, _push_stop
    if _push_thread is not None:
        _push_stop.set()
        _push_thread.join(timeout=5)
        _push_thread = None
        _push_stop = None


def push_endpoint() -> Optional[Tuple[str, int]]:
    """Where this worker's pushes and flight dumps go: the rendezvous
    store whose address the launcher exported (the JAX package's
    ``multipod.relay.push_endpoint`` without its pod-relay branch, which
    comes with entry 14), or None outside a launched world."""
    addr = (os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
            or os.environ.get("HOROVOD_GLOO_RENDEZVOUS_ADDR"))
    port = (os.environ.get("HVD_TPU_RENDEZVOUS_PORT")
            or os.environ.get("HOROVOD_GLOO_RENDEZVOUS_PORT"))
    if not addr or not port:
        return None
    try:
        return addr, int(port)
    except ValueError:
        return None


# -- lifecycle (core/basics.py calls these) --------------------------------------

def configure(knobs) -> None:
    """Turn telemetry on as the knobs ask (``HOROVOD_METRICS``,
    ``HOROVOD_TPU_METRICS_FILE``, ``HOROVOD_METRICS_PORT``). Knobs that
    ask for nothing leave a manual ``enable()`` alone. A launched worker
    also pushes its exposition to the launcher's rendezvous store every
    ``HOROVOD_METRICS_PUSH_INTERVAL_S``."""
    global _configured
    want = bool(knobs.metrics_enabled or knobs.metrics_file
                or knobs.metrics_port)
    if not want:
        return
    _configured = True
    enable()
    if knobs.metrics_file:
        step_stats.open_log(knobs.metrics_file)
    if knobs.metrics_port:
        start_http_server(knobs.metrics_port)
    endpoint = push_endpoint()
    rank = (os.environ.get("HVD_TPU_RANK")
            or os.environ.get("HOROVOD_RANK"))
    interval = float(knobs.metrics_push_interval_s or 0.0)
    if interval > 0 and endpoint is not None and rank is not None:
        start_metrics_push(endpoint[0], endpoint[1], int(rank), interval)


def on_shutdown() -> None:
    """``shutdown()``: the last push, the step log and the endpoint
    close; metrics turn off only if ``configure()`` turned them on."""
    global _configured
    stop_metrics_push()  # joins after a final push
    step_stats.close_log()
    stop_http_server()
    set_native_stats_provider(None)
    if _configured:
        _configured = False
        disable()


def reset() -> None:
    """Test hook: clear every family and accumulator and return to the
    disabled state."""
    global _configured, _push_policy, _push_outage
    _push_policy = _push_outage = None
    set_pod_label("")
    set_step_wrapper(None)
    set_step_observer(None)
    set_serving_observer(None)
    on_shutdown()
    disable()
    _configured = False
    registry.clear()
    step_stats.close_log()
    step_stats.step = 0
    step_stats._last_native = {}
    step_stats._reset_interval()
