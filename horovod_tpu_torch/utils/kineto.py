"""Device-trace reading and step attribution over ``torch.profiler``.

The port's counterpart of the JAX package's ``utils/xplane.py``. There,
``jax.profiler`` leaves an XSpace protobuf and the module decodes it;
here ``torch.profiler`` (Kineto) exports a Chrome trace
(``export_chrome_trace``): JSON whose ``traceEvents`` hold the host's
``cpu_op`` spans and, with CUDA activity, the card's ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` spans, each with ``ts`` and ``dur`` in
microseconds and its device index in ``args``. So only the interval
math is a copy (``horovod_tpu/utils/xplane.py:301-541``); the protobuf
decoder has no counterpart.

Three layers, as there:

* **load** — :func:`load_trace` / :func:`find_traces`: the newest
  Chrome trace under a directory (or a file);
* **extract** — :func:`op_events`: the card's spans as ``{name, cat,
  start_us, dur_us, plane, line, async, collective}`` dicts, one plane
  a device (``/device:GPU:<i>``), one line a stream. A collective is an
  NCCL kernel (``nccl*Kernel*``). The GPU-side copies of user
  annotations are not device work and are left out. A capture without
  CUDA activity has no device: ``device_ops=False`` reads its host
  ``cpu_op`` spans instead, as the JAX package reads the CPU backend's
  client threads;
* **attribute** — :func:`attribute`, :func:`attribute_by_plane`:
  compute / collective / exposed collective / idle / host gap, the
  JAX package's arithmetic unchanged.

``utils/prof.py`` drives this for each sampled step;
``python -m horovod_tpu_torch.tools.device_summary`` and
``tools.trace_merge --xplane`` are the command lines.
"""

from __future__ import annotations

import fnmatch
import glob
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple


class TraceUnavailable(RuntimeError):
    """No readable Chrome trace, or none with device work, where one was
    expected."""


#: Chrome-trace categories of the card's own work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the category of a host operator span (a CPU-only capture's "device")
HOST_OP_CAT = "cpu_op"
#: a collective kernel: NCCL's (``ncclDevKernel_AllReduce_...``,
#: ``ncclKernel_...``)
COLLECTIVE_PATTERN = "nccl*Kernel*"


def is_collective(name: str) -> bool:
    """Does this kernel move bytes between ranks (an NCCL kernel)?"""
    return fnmatch.fnmatchcase(name, COLLECTIVE_PATTERN)


def find_traces(path: str) -> List[str]:
    """Chrome traces (``*.json``) under ``path``, oldest first by
    modification time; the sidecar ``hvd_prof_meta.json`` is not one."""
    found = [p for p in glob.glob(os.path.join(path, "**", "*.json"),
                                  recursive=True)
             if os.path.basename(p) != "hvd_prof_meta.json"]
    return sorted(found, key=lambda p: (os.path.getmtime(p), p))


def load_trace(path: str) -> Tuple[dict, str]:
    """(trace, file) from a capture directory (its newest trace) or a
    trace file. Raises :class:`TraceUnavailable` when nothing readable
    is there."""
    if os.path.isfile(path):
        f = path
    else:
        found = find_traces(path)
        if not found:
            raise TraceUnavailable(
                f"no Chrome trace (*.json) under {path!r}: was the "
                "torch.profiler window exported (export_chrome_trace)?")
        f = found[-1]
    try:
        with open(f) as fh:
            trace = json.load(fh)
    except (OSError, ValueError) as e:
        raise TraceUnavailable(f"cannot read {f!r}: {e}") from e
    if isinstance(trace, list):  # a bare event array is valid Chrome JSON
        trace = {"traceEvents": trace}
    if not isinstance(trace, dict) or not isinstance(
            trace.get("traceEvents"), list):
        raise TraceUnavailable(f"{f!r} has no traceEvents array")
    return trace, f


def op_events(trace: dict, device_ops: bool = True,
              skip: Iterable[str] = ()) -> List[dict]:
    """Flatten the trace's spans into op dicts sorted by start (µs on
    the trace's clock). ``device_ops``: the card's kernel, memcpy and
    memset spans; else the host's ``cpu_op`` spans. Spans whose name
    holds one of ``skip`` are left out."""
    cats = DEVICE_CATS if device_ops else (HOST_OP_CAT,)
    skip = tuple(skip)
    out: List[dict] = []
    for e in trace.get("traceEvents", ()):
        if e.get("ph") != "X" or e.get("cat") not in cats:
            continue
        dur = float(e.get("dur", 0.0) or 0.0)
        if dur <= 0:
            continue
        name = str(e.get("name", ""))
        if skip and any(s in name for s in skip):
            continue
        args = e.get("args") or {}
        if device_ops:
            plane = f"/device:GPU:{args.get('device', e.get('pid', 0))}"
            line = f"stream {args.get('stream', e.get('tid', 0))}"
        else:
            plane = "/host:CPU"
            line = f"thread {e.get('tid', 0)}"
        out.append({
            "name": name,
            "cat": e["cat"],
            "start_us": float(e["ts"]),
            "dur_us": dur,
            "plane": plane,
            "line": line,
            "async": False,
            "collective": is_collective(name),
        })
    out.sort(key=lambda o: o["start_us"])
    return out


# ---------------------------------------------------------------------------
# interval arithmetic + attribution (horovod_tpu/utils/xplane.py:360-541)
# ---------------------------------------------------------------------------

def merge_intervals(
        spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of (start, end) intervals, sorted and coalesced."""
    spans = sorted((s, e) for s, e in spans if e > s)
    if not spans:
        return []
    out = [spans[0]]
    for s, e in spans[1:]:
        ls, le = out[-1]
        if s > le:
            out.append((s, e))
        else:
            out[-1] = (ls, max(le, e))
    return out


def _total(intervals: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


def _intersect(a: List[Tuple[float, float]],
               b: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def attribute(ops: List[dict],
              host_wall_us: Optional[float] = None) -> dict:
    """Attribute a sampled window into compute / collective / exposed
    collective / idle / host-gap buckets.

    * ``compute_us`` — union of non-collective device op time;
    * ``collective_us`` — union of collective op time;
    * ``exposed_collective_us`` — collective time not overlapped by
      compute: the wire time the step pays;
    * ``idle_us`` — gaps in the device timeline inside the window;
    * ``host_gap_us`` — host wall time beyond the device window, only
      when ``host_wall_us`` is given.

    Fractions normalize by the host wall when known, else the device
    wall. ``measured_overlap_frac`` is the overlapped share of
    collective time (None when the window has no collectives)."""
    compute = merge_intervals(
        (e["start_us"], e["start_us"] + e["dur_us"])
        for e in ops if not e["collective"])
    coll = merge_intervals(
        (e["start_us"], e["start_us"] + e["dur_us"])
        for e in ops if e["collective"])
    busy = merge_intervals(compute + coll)
    wall = (busy[-1][1] - busy[0][0]) if busy else 0.0
    compute_us = _total(compute)
    coll_us = _total(coll)
    overlapped_us = _total(_intersect(compute, coll))
    exposed_us = coll_us - overlapped_us
    idle_us = max(wall - _total(busy), 0.0)
    host_gap_us = None
    denom = wall
    if host_wall_us is not None:
        host_gap_us = max(host_wall_us - wall, 0.0)
        denom = max(host_wall_us, wall)
    denom = denom or 1.0
    out = {
        "ops": len(ops),
        "device_wall_us": round(wall, 3),
        "compute_us": round(compute_us, 3),
        "collective_us": round(coll_us, 3),
        "exposed_collective_us": round(exposed_us, 3),
        "idle_us": round(idle_us, 3),
        "compute_frac": round(compute_us / denom, 6),
        "exposed_wire_frac": round(exposed_us / denom, 6),
        "idle_frac": round(idle_us / denom, 6),
        "measured_overlap_frac": (
            round(overlapped_us / coll_us, 6) if coll_us > 0 else None
        ),
    }
    if host_gap_us is not None:
        out["host_wall_us"] = round(host_wall_us, 3)
        out["host_gap_us"] = round(host_gap_us, 3)
        out["host_gap_frac"] = round(host_gap_us / denom, 6)
    return out


def attribute_by_plane(ops: List[dict],
                       host_wall_us: Optional[float] = None) -> dict:
    """:func:`attribute` computed for each device plane on its own axis
    and then aggregated, so one card's compute cannot mask another's
    exposed collective wait. Per-plane fractions average with equal
    weight; ``measured_overlap_frac`` is the overlapped share of all
    collective microseconds. A single-plane capture returns
    :func:`attribute`'s dict unchanged."""
    planes: Dict[str, List[dict]] = {}
    for e in ops:
        planes.setdefault(e["plane"], []).append(e)
    if len(planes) <= 1:
        return attribute(ops, host_wall_us=host_wall_us)
    per = {name: attribute(evs, host_wall_us=host_wall_us)
           for name, evs in sorted(planes.items())}
    vals = list(per.values())
    n = len(vals)
    coll_us = sum(a["collective_us"] for a in vals)
    overlapped_us = sum(
        a["collective_us"] - a["exposed_collective_us"] for a in vals)
    out = {
        "ops": len(ops),
        "planes": n,
        "device_wall_us": round(max(a["device_wall_us"] for a in vals), 3),
        "compute_us": round(sum(a["compute_us"] for a in vals), 3),
        "collective_us": round(coll_us, 3),
        "exposed_collective_us": round(
            sum(a["exposed_collective_us"] for a in vals), 3),
        "idle_us": round(sum(a["idle_us"] for a in vals), 3),
        "compute_frac": round(
            sum(a["compute_frac"] for a in vals) / n, 6),
        "exposed_wire_frac": round(
            sum(a["exposed_wire_frac"] for a in vals) / n, 6),
        "idle_frac": round(sum(a["idle_frac"] for a in vals) / n, 6),
        "measured_overlap_frac": (
            round(overlapped_us / coll_us, 6) if coll_us > 0 else None),
        "per_plane": {
            name: {k: a[k] for k in (
                "device_wall_us", "compute_frac", "exposed_wire_frac",
                "idle_frac", "measured_overlap_frac")}
            for name, a in per.items()},
    }
    if host_wall_us is not None:
        out["host_wall_us"] = round(host_wall_us, 3)
        out["host_gap_us"] = round(
            sum(a.get("host_gap_us", 0.0) for a in vals) / n, 3)
        out["host_gap_frac"] = round(
            sum(a.get("host_gap_frac", 0.0) for a in vals) / n, 6)
    return out


def summarize(ops: List[dict]) -> List[dict]:
    """Busy/idle and time by category and by op for each plane of
    ``ops`` (the JAX ``summarize_plane``'s accounting, over Chrome-trace
    spans: a category is the span's ``cat``)."""
    planes: Dict[str, List[dict]] = {}
    for o in ops:
        planes.setdefault(o["plane"], []).append(o)
    out = []
    for name, evs in sorted(planes.items()):
        by_op: Dict[str, float] = {}
        by_cat: Dict[str, float] = {}
        occur: Dict[str, int] = {}
        spans = []
        for o in evs:
            by_op[o["name"]] = by_op.get(o["name"], 0.0) + o["dur_us"]
            by_cat[o["cat"]] = by_cat.get(o["cat"], 0.0) + o["dur_us"]
            occur[o["name"]] = occur.get(o["name"], 0) + 1
            spans.append((o["start_us"], o["start_us"] + o["dur_us"]))
        busy = _total(merge_intervals(spans))
        wall = max(e for _, e in spans) - min(s for s, _ in spans)
        out.append({
            "plane": name,
            "wall_us": wall,
            "busy_us": busy,
            "idle_frac": 1.0 - busy / max(wall, 1e-9),
            "by_cat": by_cat,
            "by_op": by_op,
            "occur": occur,
        })
    return out
