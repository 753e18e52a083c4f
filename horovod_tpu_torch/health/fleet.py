"""Fleet-level health view: rank summaries -> a driver-side verdict.

The port of the JAX package's ``health/fleet.py``. Each rank's health
monitor publishes a compact JSON summary to the rendezvous KV store
under ``PUT /health/<rank>`` through the same path its metrics push
takes (``utils/metrics.push_endpoint``). Keys may carry a pod label
(``<rank>@<pod>``), which a pod relay stamps in the JAX package; the
port's relays come with ROADMAP queue A entry 14.

``evaluate()`` folds the latest summary per rank into one verdict that
names suspected straggler ranks *live*: the runtime analogue of
``flight.straggler_report``, which only runs after a stall watchdog or
crash has already dumped the ring. A rank is suspected when

* it self-reports a firing alert whose anomaly class implicates the
  host (``straggler-host`` / ``compute-regression``), or
* its recent step time is an outlier against the fleet median
  (the wire is shared, local compute is not), or
* its summary has gone stale — a wedged rank cannot publish, and
  silence from one rank while the rest keep reporting is itself the
  Horovod coordinator's classic straggler signal.

Import-light by design: the rendezvous HTTP server serves ``GET
/health`` from this module, which imports the standard library only.
"""

import json
import time
import urllib.request
from typing import Dict, Mapping, Optional

# KV-store scope for rank health summaries (cleared per rendezvous
# round like the metrics/flight scopes — runner/http/http_server.py)
HEALTH_SCOPE = "health"

# a rank whose newest summary is older than this many seconds (by the
# driver's clock vs the summary's own time_unix stamp) is "silent"
STALE_AFTER_S = 15.0

# recent-step-time outlier factor vs the fleet median, and the absolute
# floor below which jitter is never called a straggler
STRAGGLER_FACTOR = 1.75
STRAGGLER_FLOOR_S = 1e-3

# alert classes that implicate the reporting host itself
_HOST_CLASSES = ("straggler-host", "compute-regression")


def publish_once(addr: str, port: int, rank: int, summary: dict,
                 timeout_s: float = 2.0) -> bool:
    """One summary PUT to ``/health/<rank>`` at the push endpoint.
    Best-effort: a dead driver must never stall a worker."""
    try:
        body = json.dumps(summary).encode()
        req = urllib.request.Request(
            f"http://{addr}:{port}/{HEALTH_SCOPE}/{rank}",
            data=body, method="PUT",
        )
        with urllib.request.urlopen(req, timeout=timeout_s):
            pass
        return True
    except Exception:
        return False


def parse_summaries(pushed: Mapping[str, bytes]) -> Dict[str, dict]:
    """Decode the raw ``/health`` scope (``<rank>`` or ``<rank>@<pod>``
    keys -> JSON bytes) into per-key summary dicts, dropping anything
    unparseable — the store is fed over an unauthenticated HTTP surface
    and a malformed entry must not take down the verdict route."""
    out: Dict[str, dict] = {}
    for key, raw in pushed.items():
        try:
            if isinstance(raw, bytes):
                raw = raw.decode("utf-8", "replace")
            s = json.loads(raw)
            if isinstance(s, dict):
                rank, _, pod = str(key).partition("@")
                s.setdefault("rank", int(rank))
                if pod:
                    s.setdefault("pod", pod)
                out[str(key)] = s
        except Exception:
            continue
    return out


def _median(values):
    vals = sorted(values)
    if not vals:
        return None
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def evaluate(summaries: Mapping[str, dict],
             now_unix: Optional[float] = None,
             straggler_factor: float = STRAGGLER_FACTOR,
             stale_after_s: float = STALE_AFTER_S) -> dict:
    """Fold per-rank summaries into one fleet verdict (see module
    docstring for the suspicion rules)."""
    now = time.time() if now_unix is None else now_unix
    by_rank: Dict[str, dict] = {}
    recents: Dict[int, float] = {}
    suspects = set()
    silent = []
    alerts_active = 0

    for key, s in summaries.items():
        try:
            rank = int(s.get("rank", str(key).partition("@")[0]))
        except (TypeError, ValueError):
            continue
        age = now - float(s.get("time_unix", 0.0) or 0.0)
        alerts = {
            name: a for name, a in (s.get("alerts") or {}).items()
            if isinstance(a, dict)
        }
        firing = {n: a for n, a in alerts.items() if a.get("active")}
        alerts_active += len(firing)
        recent = s.get("step_time_recent_s")
        if isinstance(recent, (int, float)) and recent > 0:
            recents[rank] = float(recent)
        if age > stale_after_s:
            silent.append(rank)
            suspects.add(rank)
        for a in firing.values():
            classes = a.get("classes") or []
            if any(c in _HOST_CLASSES for c in classes):
                suspects.add(rank)
        by_rank[str(rank)] = {
            "pod": s.get("pod", ""),
            "age_s": round(age, 3),
            "steps": s.get("steps", 0),
            "step_time_recent_s": recent,
            "alerts_active": sorted(firing),
            "classes": sorted({
                c for a in firing.values()
                for c in (a.get("classes") or [])
            }),
        }

    fleet_median = _median(recents.values())
    if fleet_median is not None and len(recents) >= 2:
        for rank, recent in recents.items():
            if (recent > straggler_factor * fleet_median
                    and recent > STRAGGLER_FLOOR_S):
                suspects.add(rank)
                by_rank[str(rank)].setdefault("classes", [])
                if "straggler-host" not in by_rank[str(rank)]["classes"]:
                    by_rank[str(rank)]["classes"].append("straggler-host")

    status = "ok"
    if suspects or alerts_active or silent:
        status = "degraded"
    if not summaries:
        status = "unknown"
    return {
        "status": status,
        "ranks": len(by_rank),
        "alerts_active": alerts_active,
        "suspected_straggler_ranks": sorted(suspects),
        "silent_ranks": sorted(silent),
        "fleet_step_time_median_s": fleet_median,
        "by_rank": by_rank,
        "time_unix": now,
    }


def evaluate_store(pushed: Mapping[str, bytes],
                   now_unix: Optional[float] = None) -> dict:
    """Convenience for the rendezvous ``GET /health`` route: raw scope
    contents in, verdict out."""
    return evaluate(parse_summaries(pushed or {}), now_unix=now_unix)
