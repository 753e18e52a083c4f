"""Merge per-rank flight-recorder dumps into a straggler report.

The flight recorder (``horovod_tpu_torch/utils/flight.py``) leaves one
JSONL dump per rank: rank-local files under ``HOROVOD_FLIGHT_DIR`` and
copies shipped to the rendezvous store (``PUT /flight/<rank>``; the
elastic driver persists a failed round's). One rank's view cannot
attribute a distributed stall; this tool merges them:

* **clock alignment**: each dump's header carries the clock offset to
  the store's ``GET /clock`` at dump time, so the ranks' wall stamps map
  onto one (driver) time axis;
* **straggler attribution**: for every tensor still pending on some
  rank (enqueued, never executed), the ranks whose enqueue *count* of
  it lags the largest are named as not having submitted it;
* **critical path**: each rank's mean enqueue-to-exec latency over the
  tensors that completed, and its aligned last activity: the quietest
  or slowest rank is the candidate even when no tensor is missing.

The twin of the JAX package's ``scripts/flight_analyze.py``; either
reads the other's dumps.

Usage:
    python -m horovod_tpu_torch.tools.flight_analyze \\
        /tmp/hvd_flight/flight_rank*.jsonl
    python -m horovod_tpu_torch.tools.flight_analyze \\
        --from-server 127.0.0.1:4567 --world 8 [--json report.json]

Exit 0 when dumps were merged (the report may still name stragglers:
it is forensics, not a gate), 1 when no dump could be read.
"""

import argparse
import json
import os
import re
import sys
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from ..runner.http.http_client import server_clock
from ..utils.flight import parse_dump as _parse_dump_text


def load_file(path: str) -> Optional[Tuple[int, dict, List[dict]]]:
    try:
        with open(path, "r") as f:
            header, events = _parse_dump_text(f.read())
    except OSError as e:
        print(f"flight_analyze: cannot read {path}: {e}", file=sys.stderr)
        return None
    rank = header.get("rank")
    if rank is None:
        m = re.search(r"rank(\d+)", os.path.basename(path))
        rank = int(m.group(1)) if m else -1
    return int(rank), header, events


def load_server(addr: str, port: int, world: int
                ) -> List[Tuple[int, dict, List[dict]]]:
    out = []
    for r in range(world):
        try:
            with urllib.request.urlopen(
                    f"http://{addr}:{port}/flight/{r}", timeout=3.0) as rs:
                text = rs.read().decode("utf-8", "replace")
        except OSError:
            continue  # no dump from this rank
        header, events = _parse_dump_text(text)
        out.append((r, header, events))
    return out


def probe_server_clock(addr: str, port: int) -> Optional[dict]:
    """Analyzer-side clock context for a --from-server run: how far
    THIS machine's clock sits from the rendezvous server the dumps
    were aligned against (the same /clock route the recorder probes at
    dump time, ``runner/http/http_client.server_clock``)."""
    try:
        server_t, rtt = server_clock(addr, port)
    except OSError:
        return None
    return {
        "analyzer_offset_s": round(server_t - (time.time() - rtt / 2.0),
                                   6),
        "rtt_s": round(rtt, 6),
    }


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def analyze(dumps: List[Tuple[int, dict, List[dict]]]) -> dict:
    """Merge (rank, header, events) triples into the forensics report
    dict (see module docstring for the sections)."""
    ranks: Dict[int, dict] = {}
    enq_counts: Dict[int, Dict[str, int]] = {}
    pending: Dict[int, List[str]] = {}
    # key on rank only: two dumps can share a rank (a local file AND a
    # server fetch), and tuple comparison would fall through to the
    # header dicts and TypeError. Stable sort → the later-listed
    # duplicate wins below (per-rank dicts overwrite).
    for rank, header, events in sorted(dumps, key=lambda d: d[0]):
        offset = float(header.get("clock_offset_s", 0.0) or 0.0)
        enq: Dict[str, int] = {}
        done: Dict[str, int] = {}
        lat_sum, lat_n = 0.0, 0
        open_t: Dict[str, float] = {}
        last_wall = header.get("time_unix", 0.0)
        kinds: Dict[str, int] = {}
        last_ev: Optional[dict] = None
        for ev in events:
            kind = ev.get("kind", "")
            kinds[kind] = kinds.get(kind, 0) + 1
            last_ev = ev
            name = ev.get("name", "")
            if kind == "enqueue" and name:
                enq[name] = enq.get(name, 0) + 1
                open_t[name] = float(ev.get("t_mono", 0.0))
            elif kind == "exec_end":
                for n in ev.get("names") or [name]:
                    done[n] = done.get(n, 0) + 1
                    t0 = open_t.pop(n, None)
                    if t0 is not None:
                        lat_sum += float(ev.get("t_mono", t0)) - t0
                        lat_n += 1
        if events:
            last_wall = float(events[-1].get("t_wall", last_wall))
        enq_counts[rank] = enq
        pending[rank] = sorted(
            n for n, c in enq.items() if c > done.get(n, 0)
        )
        ranks[rank] = {
            "events": len(events),
            "dump_reason": header.get("reason"),
            "clock_offset_s": round(offset, 6),
            "clock_rtt_s": header.get("clock_rtt_s"),
            "event_kinds": kinds,
            "last_event": (
                {"kind": last_ev.get("kind"),
                 "name": last_ev.get("name")}
                if last_ev else None
            ),
            # driver-axis stamp of the rank's last recorded activity:
            # the oldest value here is the quietest rank
            "last_activity_aligned_unix": round(last_wall + offset, 6),
            "mean_enqueue_to_exec_s": (
                round(lat_sum / lat_n, 6) if lat_n else None
            ),
            "pending": pending[rank],
        }

    # straggler attribution: for every tensor pending ANYWHERE, a rank
    # whose enqueue count lags the max has not submitted it (count, not
    # set: steady training re-enqueues the same names every step, so a
    # rank one step behind still reads as behind)
    all_pending = sorted({n for p in pending.values() for n in p})
    max_count = {
        n: max((c.get(n, 0) for c in enq_counts.values()), default=0)
        for n in all_pending
    }
    stragglers: Dict[int, List[str]] = {}
    for rank, counts in enq_counts.items():
        behind = [
            n for n in all_pending if counts.get(n, 0) < max_count[n]
        ]
        if behind:
            stragglers[rank] = behind

    last_seen = {
        r: info["last_activity_aligned_unix"] for r, info in ranks.items()
    }
    quietest = min(last_seen, key=last_seen.get) if last_seen else None
    slowest = None
    lats = {
        r: info["mean_enqueue_to_exec_s"]
        for r, info in ranks.items()
        if info["mean_enqueue_to_exec_s"] is not None
    }
    if lats:
        slowest = max(lats, key=lats.get)

    suspected = sorted(
        stragglers,
        key=lambda r: (-len(stragglers[r]), r),
    )
    return {
        "what": "flight-recorder cross-rank forensics",
        "ranks": ranks,
        "stragglers": {str(r): v for r, v in stragglers.items()},
        "suspected_straggler_ranks": suspected,
        "pending_tensors": all_pending,
        "quietest_rank": quietest,
        "slowest_rank_by_latency": slowest,
        "critical_path_mean_s": ({str(r): v for r, v in lats.items()}
                                 or None),
    }


def render(report: dict) -> str:
    lines = ["flight forensics:"]
    for rank, info in sorted(report["ranks"].items()):
        lines.append(
            f"  rank {rank}: {info['events']} events "
            f"(dump: {info['dump_reason']}), last activity "
            f"{info['last_activity_aligned_unix']:.3f} (aligned), "
            f"pending {len(info['pending'])}"
        )
    if report["stragglers"]:
        for rank in report["suspected_straggler_ranks"]:
            missing = report["stragglers"][str(rank)]
            head = ", ".join(missing[:6])
            if len(missing) > 6:
                head += f" (+{len(missing) - 6} more)"
            lines.append(
                f"  SUSPECTED STRAGGLER rank {rank}: has not "
                f"submitted {head}"
            )
    elif report["pending_tensors"]:
        lines.append(
            "  tensors pending everywhere (no single straggler): "
            + ", ".join(report["pending_tensors"][:8])
        )
    else:
        lines.append("  no pending tensors — no stall in evidence")
    if report.get("quietest_rank") is not None:
        lines.append(f"  quietest rank (oldest aligned activity): "
                     f"{report['quietest_rank']}")
    if report.get("slowest_rank_by_latency") is not None:
        lines.append(
            f"  slowest rank by mean enqueue→exec latency: "
            f"{report['slowest_rank_by_latency']}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dumps", nargs="*",
                    help="per-rank flight dump JSONL files")
    ap.add_argument("--from-server", dest="server",
                    help="rendezvous addr:port to fetch GET /flight/<r>")
    ap.add_argument("--world", type=int, default=8,
                    help="ranks to probe with --from-server")
    ap.add_argument("--json", dest="json_out", default="",
                    help="also write the report JSON here")
    args = ap.parse_args(argv)

    loaded: List[Tuple[int, dict, List[dict]]] = []
    for path in args.dumps:
        one = load_file(path)
        if one is not None:
            loaded.append(one)
    server_clock_info = None
    if args.server:
        addr, _, port = args.server.rpartition(":")
        addr = addr or "127.0.0.1"
        loaded.extend(load_server(addr, int(port), args.world))
        server_clock_info = probe_server_clock(addr, int(port))
    if not loaded:
        print("flight_analyze: no readable dumps", file=sys.stderr)
        return 1

    report = analyze(loaded)
    if server_clock_info is not None:
        report["analyzer_server_clock"] = server_clock_info
    print(render(report))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
