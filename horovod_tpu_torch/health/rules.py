"""Declarative SLO rule engine: burn-rate + envelope alerting.

Rules come from one spec string (knob ``HOROVOD_HEALTH_RULES``), in
the same colon-separated grammar the fault injector uses
(``utils/faults.py``); the port of the JAX package's
``health/rules.py``::

    name:kind:key=value[:key=value...][;next-rule...]

Two evaluator kinds:

``burn``
    Multi-window error-budget burn rate over a latency stream (the SRE
    workbook's multiwindow multi-burn-rate alert). Every observed
    latency sample is *good* when it lands at or under ``target``
    seconds; the burn rate over a window is ``bad_fraction /
    error_budget`` where the budget is ``1 - objective``. The rule
    fires when BOTH the fast window (page-fast, noise-resistant) and
    the slow window (sustained) burn above their factors, and clears
    when the fast window drops back below 1x budget — so a cleared
    alert means the budget has stopped burning, not merely slowed.
    Keys: ``signal`` (ttft | tpot | queue_wait | request), ``slo``
    (SLO class label, optional — empty matches every class),
    ``target`` (seconds, required), ``objective`` (default 0.99),
    ``fast`` / ``slow`` (window seconds, default 30 / 300),
    ``fast_factor`` / ``slow_factor`` (default 14.4 / 6).

``envelope``
    A scalar stream (step_time | mfu) against its own rolling median.
    ``factor`` (high side: fires when the last ``breach`` samples all
    exceed ``factor * median``) or ``drop`` (low side: fires when they
    all fall under ``(1 - drop) * median``); ``window`` (samples,
    default 32), ``min`` (warmup samples, default 8), ``breach``
    (consecutive breaching samples to fire, default 2), ``clear``
    (consecutive in-envelope samples to clear, default 4).

Default rule set (``DEFAULT_RULES``): training step-time and MFU
envelopes plus interactive-class TTFT/TPOT/queue-wait burn rates.
"""

import threading
import time
from collections import deque
from typing import Dict, List, Optional

DEFAULT_RULES = (
    "step_time_envelope:envelope:signal=step_time:factor=1.75;"
    "mfu_envelope:envelope:signal=mfu:drop=0.3;"
    "ttft_interactive:burn:signal=ttft:slo=interactive:target=0.5;"
    "tpot_interactive:burn:signal=tpot:slo=interactive:target=0.1;"
    "queue_wait_interactive:burn:signal=queue_wait:slo=interactive"
    ":target=0.25"
)

# which anomaly classes a firing rule implicates, by signal — the
# fleet evaluator uses these to decide whether a rank's alert blames
# the host itself (health/fleet.py)
_SIGNAL_CLASSES = {
    "step_time": ("straggler-host",),
    "mfu": ("compute-regression",),
    "ttft": ("queue-saturation",),
    "tpot": ("queue-saturation",),
    "queue_wait": ("queue-saturation",),
    "request": ("queue-saturation",),
}


class RuleSpecError(ValueError):
    pass


class Rule:
    """One parsed rule: name, evaluator kind, signal/slo selector and
    evaluator parameters."""

    def __init__(self, name: str, kind: str, signal: str, slo: str,
                 params: Dict[str, float]):
        self.name = name
        self.kind = kind
        self.signal = signal
        self.slo = slo
        self.params = params

    def classes(self) -> tuple:
        return _SIGNAL_CLASSES.get(self.signal, ())


def parse_rules(spec: str) -> List[Rule]:
    """``spec`` -> rules; raises RuleSpecError on malformed input so a
    typo'd knob fails loudly at configure time, not silently at alert
    time."""
    rules: List[Rule] = []
    for chunk in (spec or "").split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        if len(parts) < 2:
            raise RuleSpecError(f"rule needs name:kind, got {chunk!r}")
        name, kind = parts[0].strip(), parts[1].strip()
        if kind not in ("burn", "envelope"):
            raise RuleSpecError(
                f"unknown rule kind {kind!r} in {chunk!r} "
                "(burn | envelope)")
        kv: Dict[str, str] = {}
        for p in parts[2:]:
            if "=" not in p:
                raise RuleSpecError(
                    f"expected key=value, got {p!r} in {chunk!r}")
            k, v = p.split("=", 1)
            kv[k.strip()] = v.strip()
        signal = kv.pop("signal", "")
        slo = kv.pop("slo", "")
        if not signal:
            raise RuleSpecError(f"rule {name!r} lacks signal=")
        params: Dict[str, float] = {}
        for k, v in kv.items():
            try:
                params[k] = float(v)
            except ValueError:
                raise RuleSpecError(
                    f"non-numeric {k}={v!r} in rule {name!r}")
        if kind == "burn" and "target" not in params:
            raise RuleSpecError(f"burn rule {name!r} lacks target=")
        if kind == "envelope" and not (
                "factor" in params or "drop" in params):
            raise RuleSpecError(
                f"envelope rule {name!r} lacks factor= or drop=")
        rules.append(Rule(name, kind, signal, slo, params))
    return rules


class BurnRate:
    """Multi-window multi-burn-rate evaluator over a good/bad sample
    stream. Pure arithmetic with an injectable clock."""

    def __init__(self, target_s: float, objective: float = 0.99,
                 fast_s: float = 30.0, slow_s: float = 300.0,
                 fast_factor: float = 14.4, slow_factor: float = 6.0,
                 clock=time.monotonic):
        if not 0.0 < objective < 1.0:
            raise RuleSpecError(f"objective must be in (0,1): {objective}")
        self.target_s = float(target_s)
        self.budget = 1.0 - float(objective)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.fast_factor = float(fast_factor)
        self.slow_factor = float(slow_factor)
        self._clock = clock
        self._samples = deque()  # (t, good)

    def observe(self, seconds: float, now: Optional[float] = None) -> None:
        t = self._clock() if now is None else now
        self._samples.append((t, seconds <= self.target_s))
        self._prune(t)

    def _prune(self, now: float) -> None:
        horizon = now - self.slow_s
        q = self._samples
        while q and q[0][0] < horizon:
            q.popleft()

    def burn(self, window_s: float, now: Optional[float] = None) -> float:
        """Error-budget burn rate over the trailing window: 0 = no
        errors, 1 = burning exactly at budget, >1 = overspending."""
        t = self._clock() if now is None else now
        horizon = t - window_s
        total = bad = 0
        for ts, good in self._samples:
            if ts >= horizon:
                total += 1
                if not good:
                    bad += 1
        if not total:
            return 0.0
        return (bad / total) / self.budget

    def firing(self, now: Optional[float] = None) -> bool:
        t = self._clock() if now is None else now
        self._prune(t)
        return (self.burn(self.fast_s, t) >= self.fast_factor
                and self.burn(self.slow_s, t) >= self.slow_factor)

    def cleared(self, now: Optional[float] = None) -> bool:
        t = self._clock() if now is None else now
        return self.burn(self.fast_s, t) < 1.0

    def state(self, currently_firing: bool,
              now: Optional[float] = None) -> bool:
        """Hysteresis step: fire on both windows, stay until the fast
        window is back under 1x budget."""
        if currently_firing:
            return not self.cleared(now)
        return self.firing(now)

    def snapshot(self, now: Optional[float] = None) -> dict:
        t = self._clock() if now is None else now
        return {
            "fast_burn": round(self.burn(self.fast_s, t), 3),
            "slow_burn": round(self.burn(self.slow_s, t), 3),
            "samples": len(self._samples),
        }


class Envelope:
    """Rolling-median envelope with consecutive-sample hysteresis."""

    def __init__(self, factor: Optional[float] = None,
                 drop: Optional[float] = None, window: int = 32,
                 min_samples: int = 8, breach_n: int = 2,
                 clear_n: int = 4):
        self.factor = factor
        self.drop = drop
        self.window = deque(maxlen=max(int(window), 2))
        self.min_samples = int(min_samples)
        self.breach_n = max(int(breach_n), 1)
        self.clear_n = max(int(clear_n), 1)
        self._breaching = 0
        self._ok = 0
        self.last = None
        self.reference = None

    def _median(self) -> Optional[float]:
        vals = sorted(self.window)
        if not vals:
            return None
        mid = len(vals) // 2
        if len(vals) % 2:
            return vals[mid]
        return 0.5 * (vals[mid - 1] + vals[mid])

    def observe(self, value: float) -> None:
        med = self._median()
        self.last = float(value)
        breach = False
        if med is not None and len(self.window) >= self.min_samples:
            self.reference = med
            if self.factor is not None and value > self.factor * med:
                breach = True
            if self.drop is not None and value < (1.0 - self.drop) * med:
                breach = True
        if breach:
            self._breaching += 1
            self._ok = 0
        else:
            self._ok += 1
            self._breaching = 0
        self.window.append(float(value))

    def state(self, currently_firing: bool) -> bool:
        if currently_firing:
            return self._ok < self.clear_n
        return self._breaching >= self.breach_n

    def snapshot(self) -> dict:
        return {
            "last": self.last,
            "reference": self.reference,
            "breaching": self._breaching,
        }


class RuleEngine:
    """Holds the rule set, routes observed samples to evaluators, and
    turns evaluator state flips into fire/clear transition events."""

    def __init__(self, rules: List[Rule], clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.rules = list(rules)
        self._eval = {}
        self._active: Dict[str, bool] = {}
        for r in self.rules:
            if r.kind == "burn":
                p = r.params
                self._eval[r.name] = BurnRate(
                    target_s=p["target"],
                    objective=p.get("objective", 0.99),
                    fast_s=p.get("fast", 30.0),
                    slow_s=p.get("slow", 300.0),
                    fast_factor=p.get("fast_factor", 14.4),
                    slow_factor=p.get("slow_factor", 6.0),
                    clock=clock)
            else:
                p = r.params
                self._eval[r.name] = Envelope(
                    factor=p.get("factor"), drop=p.get("drop"),
                    window=int(p.get("window", 32)),
                    min_samples=int(p.get("min", 8)),
                    breach_n=int(p.get("breach", 2)),
                    clear_n=int(p.get("clear", 4)))
            self._active[r.name] = False

    def observe(self, signal: str, value: float,
                slo: str = "") -> None:
        """Feed one sample to every rule selecting this signal (and
        SLO class, when the rule names one)."""
        with self._lock:
            for r in self.rules:
                if r.signal != signal:
                    continue
                if r.slo and slo and r.slo != slo:
                    continue
                self._eval[r.name].observe(value)

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Advance every rule's alert state; return the transitions
        (``state`` fire|clear) that happened on this evaluation."""
        t = self._clock() if now is None else now
        out: List[dict] = []
        with self._lock:
            for r in self.rules:
                ev = self._eval[r.name]
                was = self._active[r.name]
                if isinstance(ev, BurnRate):
                    is_now = ev.state(was, t)
                    snap = ev.snapshot(t)
                else:
                    is_now = ev.state(was)
                    snap = ev.snapshot()
                if is_now != was:
                    self._active[r.name] = is_now
                    out.append({
                        "rule": r.name,
                        "state": "fire" if is_now else "clear",
                        "signal": r.signal,
                        "slo": r.slo,
                        "classes": list(r.classes()),
                        **snap,
                    })
        return out

    def active(self) -> Dict[str, bool]:
        with self._lock:
            return dict(self._active)

    def active_count(self) -> int:
        with self._lock:
            return sum(1 for v in self._active.values() if v)

    def alert_summary(self) -> Dict[str, dict]:
        """Per-rule {active, classes} — what a rank publishes to the
        fleet evaluator."""
        with self._lock:
            return {
                r.name: {
                    "active": self._active[r.name],
                    "classes": list(r.classes()),
                }
                for r in self.rules
            }
