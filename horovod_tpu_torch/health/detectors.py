"""Per-rank sliding-window anomaly detectors over the StepStats stream
(the port of the JAX package's ``health/detectors.py``).

Each completed training step's record (utils/metrics.py ``StepStats``
JSONL dict) is folded into fixed-size sliding windows; a step that
breaks its envelope becomes an anomaly classified by which companion
signal moved with it:

* ``straggler-host``     — step time spiked, wire share did not: the
                           host itself is slow (the live analogue of
                           the coordinator naming who is late)
* ``slow-link``          — exposed-wire fraction drifted up, or the
                           retry counters burst: the interconnect (or
                           a peer) is the bottleneck
* ``input-bound``        — device idle fraction rose with step time:
                           the input pipeline is starving the chip
* ``compute-regression`` — MFU dropped against its rolling median or
                           the autotuner's persisted baseline
* ``queue-saturation``   — eager/decode queue depth built up across
                           consecutive steps

The detectors are pure bookkeeping (deque + median) so they can run
inside the step observer without touching the step's critical path
budget; the rule engine (``health/rules.py``) decides when an anomaly
stream becomes an *alert*.
"""

from collections import deque
from typing import List, Optional

ANOMALY_CLASSES = (
    "straggler-host",
    "slow-link",
    "input-bound",
    "compute-regression",
    "queue-saturation",
)


class Window:
    """Fixed-size sliding sample window with cheap order statistics."""

    def __init__(self, size: int = 32):
        self._q = deque(maxlen=max(int(size), 2))

    def push(self, value: float) -> None:
        self._q.append(float(value))

    def __len__(self) -> int:
        return len(self._q)

    def last(self) -> Optional[float]:
        return self._q[-1] if self._q else None

    def mean(self, n: int = 0) -> Optional[float]:
        vals = list(self._q)[-n:] if n else list(self._q)
        return sum(vals) / len(vals) if vals else None

    def median(self) -> Optional[float]:
        vals = sorted(self._q)
        if not vals:
            return None
        mid = len(vals) // 2
        if len(vals) % 2:
            return vals[mid]
        return 0.5 * (vals[mid - 1] + vals[mid])


class StepDetectors:
    """Fold step records in, get classified anomaly dicts out.

    ``baseline_step_s`` / ``baseline_mfu`` come from the autotuner's
    persisted per-(model, topology) cache entry when one exists (its
    JSON file; the tuner itself comes with ROADMAP queue A entry 12):
    the envelope then guards not just against drift within this run but
    against regressing the tuned steady state of previous runs.
    """

    def __init__(self, window: int = 32, min_steps: int = 8,
                 step_time_factor: float = 1.75,
                 wire_drift: float = 0.15, mfu_drop: float = 0.25,
                 idle_rise: float = 0.2, retry_burst: int = 3,
                 queue_factor: float = 2.0,
                 baseline_step_s: Optional[float] = None,
                 baseline_mfu: Optional[float] = None):
        self.min_steps = max(int(min_steps), 2)
        self.step_time_factor = float(step_time_factor)
        self.wire_drift = float(wire_drift)
        self.mfu_drop = float(mfu_drop)
        self.idle_rise = float(idle_rise)
        self.retry_burst = int(retry_burst)
        self.queue_factor = float(queue_factor)
        self.baseline_step_s = baseline_step_s
        self.baseline_mfu = baseline_mfu
        self.step_time = Window(window)
        self.wire_frac = Window(window)
        self.idle_frac = Window(window)
        self.mfu = Window(window)
        self.queue_depth = Window(window)
        self.steps = 0

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _num(value) -> Optional[float]:
        return float(value) if isinstance(value, (int, float)) else None

    def _anomaly(self, cls: str, signal: str, value, reference,
                 step) -> dict:
        return {
            "class": cls,
            "signal": signal,
            "value": round(float(value), 6),
            "reference": (round(float(reference), 6)
                          if reference is not None else None),
            "step": step,
        }

    # -- the fold ----------------------------------------------------------

    def update(self, record: dict) -> List[dict]:
        """One step record in; the classified anomalies it triggered
        out. Windows are compared BEFORE the new sample is pushed, so a
        single spike cannot drag its own reference with it."""
        out: List[dict] = []
        step = record.get("step")
        dt = self._num(record.get("step_time_s"))
        mfu = self._num(record.get("mfu"))
        attr = record.get("attribution") or {}
        wire = self._num(attr.get("exposed_wire_frac"))
        idle = self._num(attr.get("idle_frac"))
        qd = self._num(record.get("queue_depth"))
        retries = sum((record.get("retries") or {}).values())
        retries += sum((record.get("retry_giveups") or {}).values())

        warm = self.steps >= self.min_steps
        dt_med = self.step_time.median()
        wire_med = self.wire_frac.median()
        idle_med = self.idle_frac.median()
        mfu_med = self.mfu.median()
        qd_med = self.queue_depth.median()

        # companion signals for classifying a step-time breach
        wire_up = (wire is not None and wire_med is not None
                   and wire > wire_med + self.wire_drift)
        idle_up = (idle is not None and idle_med is not None
                   and idle > idle_med + self.idle_rise)
        mfu_down = (mfu is not None and mfu_med is not None
                    and mfu < (1.0 - self.mfu_drop) * mfu_med)

        if dt is not None and warm and dt_med:
            breach = dt > self.step_time_factor * dt_med
            base_breach = (
                self.baseline_step_s is not None
                and dt > self.step_time_factor * self.baseline_step_s
            )
            if breach or base_breach:
                if wire_up:
                    cls = "slow-link"
                elif idle_up:
                    cls = "input-bound"
                elif mfu_down:
                    cls = "compute-regression"
                else:
                    cls = "straggler-host"
                out.append(self._anomaly(
                    cls,
                    "step_time_baseline" if (base_breach and not breach)
                    else "step_time",
                    dt,
                    self.baseline_step_s if (base_breach and not breach)
                    else dt_med,
                    step))
        if wire_up and warm:
            out.append(self._anomaly(
                "slow-link", "exposed_wire_frac", wire, wire_med, step))
        if idle_up and warm and not any(
                a["class"] == "input-bound" for a in out):
            out.append(self._anomaly(
                "input-bound", "idle_frac", idle, idle_med, step))
        if mfu is not None:
            base_mfu_low = (
                self.baseline_mfu is not None and self.baseline_mfu > 0
                and mfu < (1.0 - self.mfu_drop) * self.baseline_mfu
            )
            if (mfu_down and warm) or base_mfu_low:
                out.append(self._anomaly(
                    "compute-regression",
                    "mfu" if (mfu_down and warm) else "mfu_baseline",
                    mfu,
                    mfu_med if (mfu_down and warm) else self.baseline_mfu,
                    step))
        if retries >= self.retry_burst:
            out.append(self._anomaly(
                "slow-link", "retry_burst", retries,
                self.retry_burst, step))
        if (qd is not None and warm and qd_med is not None
                and qd > max(self.queue_factor * qd_med, qd_med + 2)):
            out.append(self._anomaly(
                "queue-saturation", "queue_depth", qd, qd_med, step))

        if dt is not None:
            self.step_time.push(dt)
        if wire is not None:
            self.wire_frac.push(wire)
        if idle is not None:
            self.idle_frac.push(idle)
        if mfu is not None:
            self.mfu.push(mfu)
        if qd is not None:
            self.queue_depth.push(qd)
        self.steps += 1
        return out

    def step_time_recent_s(self, n: int = 4) -> Optional[float]:
        """Mean of the last ``n`` step times — the number a rank
        publishes for the fleet-median comparison (health/fleet.py)."""
        return self.step_time.mean(n)


class ServingDetectors:
    """Decode queue-wait buildup -> ``queue-saturation`` anomalies.

    The serving stack has no step boundary, so this watches the
    queue-wait stream directly: sustained growth of the recent mean
    over the window median marks the scheduler as saturated (the
    batcher is admitting faster than decode retires)."""

    def __init__(self, window: int = 64, factor: float = 2.0,
                 floor_s: float = 0.05, min_samples: int = 16):
        self.factor = float(factor)
        self.floor_s = float(floor_s)
        self.min_samples = int(min_samples)
        self.queue_wait = Window(window)

    def update_queue_wait(self, seconds: float) -> List[dict]:
        out: List[dict] = []
        med = self.queue_wait.median()
        recent = self.queue_wait.mean(8)
        if (len(self.queue_wait) >= self.min_samples
                and med is not None and recent is not None
                and seconds > self.floor_s
                and recent > max(self.factor * med, self.floor_s)):
            out.append({
                "class": "queue-saturation",
                "signal": "queue_wait",
                "value": round(float(recent), 6),
                "reference": round(float(med), 6),
                "step": None,
            })
        self.queue_wait.push(seconds)
        return out
