"""Merge per-rank host timelines, flight dumps, profiler samples and
incident logs into ONE clock-aligned Chrome/Perfetto trace.

The port's recorders are separate views: the host timeline
(``utils/timeline.py``, Chrome JSON per rank on a relative microsecond
axis), the flight recorder (``utils/flight.py``, JSONL dumps per rank on
the wall clock) and the sampled profiler (``utils/prof.py``, a
``torch.profiler`` Chrome trace a sampled step with a
``hvd_prof_meta.json`` sidecar). This tool fuses them:

* every host timeline opens with a ``CLOCK_ANCHOR`` instant mapping its
  relative axis to the rank's wall clock;
* every flight dump's header and every profiler sidecar carries the
  rank's clock offset to the rendezvous store (its ``GET /clock``), so
  the ranks' wall clocks map onto one driver axis;
* a sample's card spans are placed from its sidecar's wall start.

Output is Chrome trace JSON (``traceEvents``) for Perfetto or
chrome://tracing: one process a rank, with ``host:*``, ``device:*``,
``flight`` and ``incidents`` threads; host spans stay B/E pairs, card
spans become X completes, flight events thread-scoped instants, and
health incident records (``--incidents``) process-scoped ``rule:state``
annotations. The twin of the JAX package's ``scripts/trace_merge.py``;
its ``--xplane`` flag keeps its name but reads ``utils/prof.py``'s
sample directories, each a Chrome trace where the JAX tool reads an
``.xplane.pb``.

Usage:
    python -m horovod_tpu_torch.tools.trace_merge --out merged.json \\
        --timeline /tmp/t_rank0.json --timeline /tmp/t_rank1.json \\
        --flight /tmp/hvd_flight --xplane /tmp/hvd_prof/rank0

Exit 0 when at least one source merged; the printed report counts
events by rank and source (``--json`` writes it too).
"""

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

from ..utils import kineto
from ..utils.flight import parse_dump
from ..utils.prof import SPIN_KERNEL


def _rank_from_name(path: str) -> int:
    m = re.search(r"rank(\d+)", os.path.basename(path))
    if m is None:
        m = re.search(r"rank(\d+)", path)
    if m is None:
        # multiple unknown-rank sources would silently collapse onto
        # one pid track and mis-nest their spans — say so
        print(f"trace_merge: {path}: no rank in source metadata or "
              "filename — assuming rank 0", file=sys.stderr)
        return 0
    return int(m.group(1))


# ---------------------------------------------------------------------------
# source loaders — each returns (rank, events_on_wall_unix_seconds, meta)
# ---------------------------------------------------------------------------

def load_timeline(path: str) -> Optional[dict]:
    """One host timeline JSON → {rank, clock_offset?, events:[(t_unix,
    chrome_event), ...]}. Needs the CLOCK_ANCHOR instant; a timeline
    without one is refused with a warning."""
    try:
        with open(path) as f:
            evs = json.load(f)
    except (OSError, ValueError) as e:
        print(f"trace_merge: cannot read timeline {path}: {e}",
              file=sys.stderr)
        return None
    anchor = next((e for e in evs if e.get("name") == "CLOCK_ANCHOR"), None)
    if anchor is None:
        print(f"trace_merge: {path} has no CLOCK_ANCHOR (pre-unified "
              "timeline?) — skipped; re-record with this build",
              file=sys.stderr)
        return None
    args = anchor.get("args", {})
    rank = int(args.get("rank", -1))
    if rank < 0:
        rank = _rank_from_name(path)
    t0_unix = float(args["time_unix"])
    ts0 = float(anchor["ts"])
    out = []
    for e in evs:
        if e.get("name") == "CLOCK_ANCHOR":
            continue
        t_unix = t0_unix + (float(e["ts"]) - ts0) / 1e6
        out.append((t_unix, e))
    return {"rank": rank, "events": out, "source": path}


def load_flight(path: str) -> Optional[dict]:
    """One flight dump JSONL → rank, clock offset, wall-stamped
    events."""
    try:
        with open(path) as f:
            header, events = parse_dump(f.read())
    except OSError as e:
        print(f"trace_merge: cannot read flight dump {path}: {e}",
              file=sys.stderr)
        return None
    rank = int(header.get("rank", -1))
    if rank < 0:
        rank = _rank_from_name(path)
    offset = header.get("clock_offset_s")
    out = [(float(ev.get("t_wall", 0.0)), ev)
           for ev in events if ev.get("t_wall")]
    return {"rank": rank, "clock_offset_s": offset, "events": out,
            "source": path}


def load_incidents(path: str) -> List[dict]:
    """One incident JSONL (HOROVOD_HEALTH_INCIDENT_FILE, or a step log
    whose out-of-band ``incident`` event lines ride among step records)
    → per-rank {rank, events:[(t_unix, rec)]} sources. Incidents are
    wall-stamped at emission, so they align like flight events."""
    recs = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(r, dict):
                    continue
                if r.get("event") == "incident" and "incident" in r:
                    r = r["incident"]
                if "rule" in r and "state" in r and "time_unix" in r:
                    recs.append(r)
    except OSError as e:
        print(f"trace_merge: cannot read incidents {path}: {e}",
              file=sys.stderr)
        return []
    by_rank: Dict[int, List] = {}
    for r in recs:
        by_rank.setdefault(int(r.get("rank", 0)), []).append(
            (float(r["time_unix"]), r))
    return [{"rank": rank, "events": evs, "source": path}
            for rank, evs in sorted(by_rank.items())]


def find_prof_samples(root: str) -> List[str]:
    """Profiler sample directories under a root: any directory holding
    the ``hvd_prof_meta.json`` sidecar ``utils/prof.py`` writes a
    capture."""
    if os.path.isfile(os.path.join(root, "hvd_prof_meta.json")):
        return [root]
    return sorted(
        os.path.dirname(p) for p in glob.glob(
            os.path.join(root, "**", "hvd_prof_meta.json"),
            recursive=True)
    )


def load_prof_sample(sample_dir: str) -> Optional[dict]:
    """One profiler capture → rank, clock offset, the card's spans (the
    host's, for a capture without a card) placed in the sample's
    wall-clock window; the profiler's leading spins are left out."""
    meta = {}
    try:
        with open(os.path.join(sample_dir, "hvd_prof_meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        pass
    try:
        trace, _ = kineto.load_trace(sample_dir)
    except kineto.TraceUnavailable as e:
        print(f"trace_merge: {e}", file=sys.stderr)
        return None
    ops = (kineto.op_events(trace, skip=(SPIN_KERNEL,))
           or kineto.op_events(trace, device_ops=False))
    if not ops:
        return None
    rank = int(meta.get("rank", -1))
    if rank < 0:
        rank = _rank_from_name(sample_dir)
    try:
        t_start = float(meta["t_start_unix"])
    except (KeyError, TypeError, ValueError):
        # no wall anchor: the spans would land at the 1970 epoch and
        # stretch the merged axis by decades; skip loudly instead
        print(f"trace_merge: {sample_dir} has no usable "
              "hvd_prof_meta.json wall anchor (torn sidecar?) — "
              "sample skipped", file=sys.stderr)
        return None
    base_us = min(o["start_us"] for o in ops)
    out = [(t_start + (o["start_us"] - base_us) / 1e6, o) for o in ops]
    return {
        "rank": rank,
        "clock_offset_s": meta.get("clock_offset_s"),
        "step": meta.get("step"),
        "events": out,
        "source": sample_dir,
    }


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def merge(timelines: List[dict], flights: List[dict],
          samples: Optional[List[dict]] = None,
          incidents: Optional[List[dict]] = None) -> Tuple[dict, dict]:
    """(chrome_trace, report). Every source's wall stamps shift by its
    rank's /clock offset (from its flight dump's header or its profiler
    sidecar; a rank with no probed offset uses 0: one host's ranks share
    a clock anyway), then the merged axis rebases to the earliest
    event."""
    samples = samples or []
    offsets: Dict[int, float] = {}
    for src in flights + samples:
        off = src.get("clock_offset_s")
        if off is not None and src["rank"] not in offsets:
            offsets[src["rank"]] = float(off)

    aligned: List[Tuple[float, int, str, dict]] = []  # (t, rank, kind, ev)
    for tl in timelines:
        off = offsets.get(tl["rank"], 0.0)
        for t, e in tl["events"]:
            aligned.append((t + off, tl["rank"], "host", e))
    for fl in flights:
        off = offsets.get(fl["rank"], 0.0)
        for t, e in fl["events"]:
            aligned.append((t + off, fl["rank"], "flight", e))
    for sm in samples:
        off = offsets.get(sm["rank"], 0.0)
        for t, e in sm["events"]:
            aligned.append((t + off, sm["rank"], "device", e))
    for inc in incidents or []:
        off = offsets.get(inc["rank"], 0.0)
        for t, e in inc["events"]:
            aligned.append((t + off, inc["rank"], "incident", e))

    report = {
        "what": "cross-rank merged trace",
        "ranks": sorted({r for _, r, _, _ in aligned}),
        "events": len(aligned),
        "by_source": {},
        "clock_offsets_s": {str(r): v for r, v in sorted(offsets.items())},
    }
    for _, r, kind, _ in aligned:
        key = f"rank{r}/{kind}"
        report["by_source"][key] = report["by_source"].get(key, 0) + 1
    if not aligned:
        return {"traceEvents": []}, report

    t_base = min(t for t, _, _, _ in aligned)
    report["t_base_unix"] = round(t_base, 6)
    report["span_s"] = round(
        max(t for t, _, _, _ in aligned) - t_base, 6)

    trace: List[dict] = []
    for rank in report["ranks"]:
        trace.append({"ph": "M", "name": "process_name", "pid": rank,
                      "args": {"name": f"rank {rank}"}})
    seen_tids = set()

    def _tid(rank: int, tid: str) -> str:
        key = (rank, tid)
        if key not in seen_tids:
            seen_tids.add(key)
            trace.append({"ph": "M", "name": "thread_name", "pid": rank,
                          "tid": tid, "args": {"name": tid}})
        return tid

    for t, rank, kind, e in sorted(aligned, key=lambda x: x[0]):
        ts = (t - t_base) * 1e6  # us on the merged axis
        if kind == "host":
            ev = {
                "ph": e.get("ph", "i"),
                "name": e.get("name", ""),
                "ts": round(ts, 3),
                "pid": rank,
                "tid": _tid(rank, f"host:{e.get('tid', '')}"),
            }
            if e.get("args"):
                ev["args"] = e["args"]
            if ev["ph"] == "i":
                ev["s"] = "t"
            trace.append(ev)
        elif kind == "device":
            trace.append({
                "ph": "X",
                "name": e["name"],
                "cat": ("collective" if e.get("collective")
                        else str(e.get("cat", "op"))),
                "ts": round(ts, 3),
                "dur": round(e["dur_us"], 3),
                "pid": rank,
                "tid": _tid(rank, f"device:{e.get('line', '')}"),
            })
        elif kind == "incident":
            # annotation track: one process-scoped instant per alert
            # transition, named rule:state so a firing alert reads
            # straight off the merged axis next to the host and card
            # spans it implicates
            trace.append({
                "ph": "i",
                "s": "p",
                "name": f"{e.get('rule', '?')}:{e.get('state', '?')}",
                "ts": round(ts, 3),
                "pid": rank,
                "tid": _tid(rank, "incidents"),
                "args": {k: v for k, v in e.items()
                         if k != "time_unix"},
            })
        else:  # flight
            name = e.get("kind", "event")
            if e.get("name"):
                name = f"{name}:{e['name']}"
            args = {k: v for k, v in e.items()
                    if k not in ("t_mono", "t_wall", "seq")}
            trace.append({
                "ph": "i",
                "s": "t",
                "name": name,
                "ts": round(ts, 3),
                "pid": rank,
                "tid": _tid(rank, "flight"),
                "args": args,
            })
    chrome = {
        "traceEvents": trace,
        "displayTimeUnit": "ms",
        "metadata": {
            "tool": "horovod_tpu_torch.tools.trace_merge",
            "t_base_unix": report["t_base_unix"],
        },
    }
    return chrome, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeline", action="append", default=[],
                    metavar="FILE",
                    help="host timeline JSON (repeatable; globs ok)")
    ap.add_argument("--flight", action="append", default=[],
                    metavar="FILE_OR_DIR",
                    help="flight dump JSONL or a dump directory "
                         "(repeatable)")
    ap.add_argument("--xplane", action="append", default=[],
                    metavar="DIR",
                    help="profiler capture dir (utils/prof.py) — a "
                         "single sample or a rank root of samples "
                         "(repeatable)")
    ap.add_argument("--incidents", action="append", default=[],
                    metavar="FILE",
                    help="health incident JSONL (or a step log with "
                         "incident event lines) rendered as an "
                         "annotation track (repeatable; globs ok)")
    ap.add_argument("--out", required=True,
                    help="merged Chrome trace JSON path")
    ap.add_argument("--json", dest="json_out", default="",
                    help="also write the merge report JSON here")
    args = ap.parse_args(argv)

    timelines: List[dict] = []
    for pat in args.timeline:
        for path in (sorted(glob.glob(pat)) or [pat]):
            tl = load_timeline(path)
            if tl is not None:
                timelines.append(tl)
    flights: List[dict] = []
    for item in args.flight:
        paths = (sorted(glob.glob(os.path.join(item, "flight_rank*.jsonl")))
                 if os.path.isdir(item) else (sorted(glob.glob(item))
                                              or [item]))
        for path in paths:
            fl = load_flight(path)
            if fl is not None:
                flights.append(fl)
    samples: List[dict] = []
    for root in args.xplane:
        for d in find_prof_samples(root):
            sm = load_prof_sample(d)
            if sm is not None:
                samples.append(sm)
    incidents: List[dict] = []
    for pat in args.incidents:
        for path in (sorted(glob.glob(pat)) or [pat]):
            incidents.extend(load_incidents(path))

    chrome, report = merge(timelines, flights, samples, incidents)
    if not chrome["traceEvents"]:
        print("trace_merge: no events from any source", file=sys.stderr)
        return 1
    with open(args.out, "w") as f:
        json.dump(chrome, f)
        f.write("\n")
    report["out"] = args.out
    print(json.dumps(report, indent=1))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
