"""Summarize a per-step metrics JSONL (``HOROVOD_TPU_METRICS_FILE``).

Each line of the input is one step record written by
``horovod_tpu_torch.utils.metrics.StepStats.end_step``. This renders
the run as a table: step-time percentiles, collective counts and bytes
by op/dtype, the fusion fill ratio, gradient and wire bytes, elastic
events and retries: the offline companion of the live ``GET /metrics``.
Out-of-band event lines ride along (the autotuner's decision trail, the
decode scheduler's stat events, the health monitor's incidents), as the
JAX package's logs carry them. The twin of the JAX package's
``scripts/metrics_summary.py``: the same file prints the same table.

Usage:
    python -m horovod_tpu_torch.tools.metrics_summary run.jsonl [--last N]
    python -m horovod_tpu_torch.tools.metrics_summary run.jsonl --check

``--check`` is a smoke gate: it exits non-zero with a one-line reason
when the file is missing or empty, or a line is malformed or lacks a
step field.
"""

import argparse
import json
import sys

REQUIRED_FIELDS = ("step", "step_time_s", "collectives")


def load_records(path):
    """Parse the JSONL; returns (records, errors) where errors is a list
    of '<lineno>: <reason>' strings."""
    records, errors = [], []
    try:
        fh = open(path)
    except OSError as e:
        return [], [f"cannot open {path}: {e}"]
    with fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                errors.append(f"line {lineno}: invalid JSON ({e})")
                continue
            if not isinstance(rec, dict):
                errors.append(f"line {lineno}: not an object")
                continue
            if "event" in rec:
                # out-of-band event record (StepStats.emit_event):
                # e.g. the autotuner's decision trail — carries
                # {"event": kind, kind: payload} instead of step fields
                records.append(rec)
                continue
            if "rule" in rec and "state" in rec and "step" not in rec:
                # a bare incident record (HOROVOD_HEALTH_INCIDENT_FILE
                # JSONL) — normalize to the event-line shape so one
                # loader serves both files
                records.append({"event": "incident", "incident": rec})
                continue
            missing = [f for f in REQUIRED_FIELDS if f not in rec]
            if missing:
                errors.append(
                    f"line {lineno}: missing field(s) {missing}")
                continue
            records.append(rec)
    return records, errors


def percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[i]


def _human_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024


def _fmt_overrides(d):
    return " ".join(f"{k}={v}" for k, v in sorted(d.items()))


def summarize_autotune(events):
    """Render the autotuner's decision trail (its ``autotune`` event
    records) as a sweep table: every measured candidate with its
    step-time/MFU score, failures, and the per-dimension pin/reject
    outcomes ending in the pinned configuration."""
    if not events:
        return
    print("\nautotune sweep (decision trail):")
    width = max((len(e.get("dimension", "")) for e in events), default=9)
    width = max(width, len("dimension"))
    print(f"  {'dimension':<{width}}  {'outcome':<8}  detail")
    final = None
    for e in events:
        dim = e.get("dimension", "?")
        kind = e.get("kind", "?")
        if kind == "trial":
            if "error" in e:
                detail = (f"FAILED {_fmt_overrides(e.get('overrides', {}))}"
                          f" ({e['error']})")
            else:
                detail = f"{e.get('step_s', 0) * 1e3:.2f} ms"
                if "mfu" in e:
                    detail += f"  mfu {e['mfu']:.4f}"
                detail += f"  {_fmt_overrides(e.get('overrides', {}))}"
            print(f"  {dim:<{width}}  {'trial':<8}  {detail}")
        elif kind in ("pin", "reject"):
            detail = f"best {e.get('step_s', 0) * 1e3:.2f} ms"
            src = e.get("source", "sweep")
            if src != "sweep":
                detail += f"  [{src}]"
            print(f"  {dim:<{width}}  {kind:<8}  {detail}")
            if dim in ("final", "warm_start"):
                final = e
    if final is not None:
        src = final.get("source", "sweep")
        print(f"  pinned configuration ({src}): "
              f"{_fmt_overrides(final.get('config', {}))}")


def summarize_decode(events):
    """Render the decode scheduler's periodic event lines
    (serving/scheduler.py emits one per
    HOROVOD_SERVING_DECODE_STATS_EVERY iterations): cumulative
    iterations/tokens, last-seen occupancy, evictions by reason."""
    if not events:
        return
    last = events[-1]
    total = last.get("slots_total", 0)
    occ = last.get("slots_occupied", 0)
    print(f"\ndecode: {last.get('iterations', 0)} iterations, "
          f"{last.get('tokens', 0)} tokens "
          f"({len(events)} stat events); last occupancy "
          f"{occ}/{total}, queued {last.get('queued_prefills', 0)}")
    ev = last.get("evictions") or {}
    if ev:
        print("decode evictions: " + ", ".join(
            f"{k}={int(v)}" for k, v in sorted(ev.items())))


def summarize_incidents(events):
    """Render the health monitor's incident trail (one ``incident``
    event line per alert fire/clear transition): a per-rule
    rollup plus the chronological record — which rank, which signal,
    and how long each alert stayed active when the pair is present."""
    if not events:
        return
    by_rule = {}
    for e in events:
        ent = by_rule.setdefault(e.get("rule", "?"),
                                 {"fire": 0, "clear": 0})
        st = e.get("state")
        if st in ent:
            ent[st] += 1
    print(f"\nhealth incidents ({len(events)} transitions):")
    width = max(max(len(r) for r in by_rule), len("rule"))
    print(f"  {'rule':<{width}}  {'fires':>5}  {'clears':>6}  "
          f"{'open':>4}")
    for rule in sorted(by_rule):
        ent = by_rule[rule]
        still = ent["fire"] - ent["clear"]
        print(f"  {rule:<{width}}  {ent['fire']:>5}  "
              f"{ent['clear']:>6}  {max(still, 0):>4}")
    last_fire = {}
    for e in events:
        key = (e.get("rank"), e.get("rule"))
        if e.get("state") == "fire":
            last_fire[key] = e
        elif e.get("state") == "clear" and key in last_fire:
            f = last_fire.pop(key)
            t0, t1 = f.get("time_unix"), e.get("time_unix")
            dur = (f"  active {t1 - t0:.1f}s"
                   if isinstance(t0, float) and isinstance(t1, float)
                   else "")
            print(f"  rank {e.get('rank', '?')}: {e.get('rule')} "
                  f"({e.get('signal', '?')}){dur}")


def summarize(records):
    autotune_events = [r["autotune"] for r in records
                       if r.get("event") == "autotune" and "autotune" in r]
    decode_events = [r["decode"] for r in records
                     if r.get("event") == "decode" and "decode" in r]
    incident_events = [r["incident"] for r in records
                       if r.get("event") == "incident"
                       and "incident" in r]
    records = [r for r in records if "event" not in r]
    if not records:
        summarize_decode(decode_events)
        summarize_autotune(autotune_events)
        summarize_incidents(incident_events)
        return
    times = sorted(r["step_time_s"] for r in records)
    print(f"steps: {len(records)}  "
          f"(#{records[0]['step']} .. #{records[-1]['step']})")
    print("step time: "
          f"mean {sum(times) / len(times) * 1e3:.2f} ms  "
          f"p50 {percentile(times, 0.50) * 1e3:.2f} ms  "
          f"p90 {percentile(times, 0.90) * 1e3:.2f} ms  "
          f"max {times[-1] * 1e3:.2f} ms")

    coll = {}
    for r in records:
        for key, v in r.get("collectives", {}).items():
            ent = coll.setdefault(key, [0, 0])
            ent[0] += v.get("count", 0)
            ent[1] += v.get("bytes", 0)
    if coll:
        print("\ncollectives (op/dtype, whole run):")
        width = max(len(k) for k in coll)
        print(f"  {'op/dtype':<{width}}  {'count':>8}  {'bytes':>12}")
        for key in sorted(coll):
            n, b = coll[key]
            print(f"  {key:<{width}}  {n:>8}  {_human_bytes(b):>12}")

    neg_n = sum(r.get("negotiation", {}).get("count", 0) for r in records)
    neg_s = sum(r.get("negotiation", {}).get("sum_s", 0.0) for r in records)
    if neg_n:
        print(f"\nnegotiation: {neg_n} tensors, "
              f"mean {neg_s / neg_n * 1e6:.0f} us")

    buckets = sum(r.get("fusion", {}).get("buckets", 0) for r in records)
    if buckets:
        fill = [r["fusion"]["fill_ratio_mean"] for r in records
                if r.get("fusion", {}).get("buckets")]
        print(f"fusion: {buckets} buckets over "
              f"{sum(r['fusion']['plans'] for r in records if 'fusion' in r)}"
              f" plans, mean fill {sum(fill) / len(fill):.2f}")

    grad = sum(r.get("grad_bytes", 0) for r in records)
    if grad:
        print(f"gradient bytes reduced: {_human_bytes(grad)}")

    wire_logical = sum(
        r.get("wire", {}).get("logical_bytes", 0) for r in records)
    wire_sent = sum(
        r.get("wire", {}).get("sent_bytes", 0) for r in records)
    if wire_logical and wire_sent:
        print(f"wire compression: {_human_bytes(wire_logical)} logical "
              f"-> {_human_bytes(wire_sent)} sent "
              f"(ratio {wire_logical / wire_sent:.2f}x)")

    # backward-interleaved collective scheduler (ops/overlap.py):
    # steps carrying overlap_window_frac ran with the staged schedule
    ow = [r["overlap_window_frac"] for r in records
          if "overlap_window_frac" in r]
    if ow:
        print(f"overlap: scheduled — pinned window "
              f"{sum(ow) / len(ow):.2f} of backward behind the first "
              f"collective ({len(ow)}/{len(records)} steps)")
    elif grad:
        print("overlap: unscheduled (HOROVOD_OVERLAP_SCHEDULE off — "
              "collectives placed at the compiler's discretion)")

    # fully-sharded parameters (optim/fsdp.py): steps
    # carrying the fsdp object ran the prefetch-interleaved FSDP step
    fsdp = [r["fsdp"] for r in records if "fsdp" in r]
    if fsdp:
        last = fsdp[-1]
        gathered = sum(f.get("gather_bytes", 0) for f in fsdp)
        line = (f"fsdp: param shard "
                f"{_human_bytes(last['hbm_param_bytes'])}"
                f" resident/device, {_human_bytes(gathered)} gathered "
                f"over {len(fsdp)}/{len(records)} sharded steps")
        regathered = sum(f.get("regather_bytes", 0) for f in fsdp)
        if regathered:
            line += (f", {_human_bytes(regathered)} re-gathered on "
                     f"backward")
        offloaded = sum(f.get("offload_bytes", 0) for f in fsdp)
        if offloaded:
            line += (f", {_human_bytes(offloaded)} carries offloaded "
                     f"to host")
        print(line)

    # continuous profiler (entry 13, part 2): hvd_mfu is
    # per-step once set_step_flops declared the model cost; attribution
    # rides the steps whose sampled capture finished parsing
    mfus = [r["mfu"] for r in records if "mfu" in r]
    if mfus:
        print(f"mfu: mean {sum(mfus) / len(mfus):.4f}  "
              f"last {mfus[-1]:.4f}  ({len(mfus)}/{len(records)} steps)")
    attrs = [r["attribution"] for r in records if "attribution" in r]
    if attrs:
        a = attrs[-1]
        overlap = a.get("measured_overlap_frac")
        print(f"device attribution ({len(attrs)} sampled, last = step "
              f"#{a.get('sampled_step', '?')}): "
              f"compute {a.get('compute_frac', 0):.1%}  "
              f"exposed wire {a.get('exposed_wire_frac', 0):.1%}  "
              f"idle {a.get('idle_frac', 0):.1%}"
              + (f"  measured overlap {overlap:.1%}"
                 if overlap is not None else ""))

    hits = sum(r.get("native", {}).get("cache_hits", 0) for r in records)
    n_coll = sum(v[0] for v in coll.values())
    if hits or n_coll:
        rate = min(hits / n_coll, 1.0) if n_coll else 0.0
        print(f"response cache: {hits} hits ({rate:.0%} of collectives)")
    stalls = sum(
        r.get("native", {}).get("stall_warnings", 0) for r in records)
    if stalls:
        print(f"stall warnings: {stalls}")

    elastic = [e for r in records for e in r.get("elastic_events", [])]
    if elastic:
        by_kind = {}
        for e in elastic:
            by_kind[e] = by_kind.get(e, 0) + 1
        print("elastic events: " + ", ".join(
            f"{k}={v}" for k, v in sorted(by_kind.items())))

    retries, giveups = {}, {}
    for r in records:
        for point, n in r.get("retries", {}).items():
            retries[point] = retries.get(point, 0) + n
        for point, n in r.get("retry_giveups", {}).items():
            giveups[point] = giveups.get(point, 0) + n
    if retries or giveups:
        print("control-plane retries: " + ", ".join(
            f"{p}={int(n)}" for p, n in sorted(retries.items())))
        if giveups:
            print("retry GIVE-UPS: " + ", ".join(
                f"{p}={int(n)}" for p, n in sorted(giveups.items())))

    summarize_pods(records)
    summarize_decode(decode_events)
    summarize_autotune(autotune_events)
    summarize_incidents(incident_events)


def summarize_pods(records):
    """Per-pod rollup alongside the per-rank view: step records carry
    a ``pod`` field under a multipod topology (utils/metrics.py stamps
    the relay's pod label), and a JSONL concatenated across ranks —
    or one rank per pod — rolls up by it. Silent when no record is
    pod-labeled (the single-pod world)."""
    by_pod = {}
    for r in records:
        pod = r.get("pod")
        if pod:
            by_pod.setdefault(pod, []).append(r)
    if not by_pod:
        return
    print("\nper-pod rollup:")
    width = max(max(len(p) for p in by_pod), len("pod"))
    print(f"  {'pod':<{width}}  {'steps':>6}  {'p50 ms':>8}  "
          f"{'p90 ms':>8}  {'grad bytes':>12}  {'retries':>8}")
    for pod in sorted(by_pod):
        rs = by_pod[pod]
        times = sorted(r["step_time_s"] for r in rs)
        grad = sum(r.get("grad_bytes", 0) for r in rs)
        retries = sum(n for r in rs
                      for n in r.get("retries", {}).values())
        print(f"  {pod:<{width}}  {len(rs):>6}  "
              f"{percentile(times, 0.50) * 1e3:>8.2f}  "
              f"{percentile(times, 0.90) * 1e3:>8.2f}  "
              f"{_human_bytes(grad):>12}  {retries:>8}")
    unlabeled = len(records) - sum(len(v) for v in by_pod.values())
    if unlabeled:
        print(f"  ({unlabeled} records without a pod label)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Summarize a horovod_tpu_torch per-step metrics JSONL")
    ap.add_argument("jsonl", help="metrics JSONL path "
                    "(HOROVOD_TPU_METRICS_FILE of the run)")
    ap.add_argument("--last", type=int, default=0,
                    help="only summarize the last N steps")
    ap.add_argument("--check", action="store_true",
                    help="smoke gate: exit 1 on empty/malformed input, "
                    "print nothing but the verdict")
    args = ap.parse_args(argv)

    records, errors = load_records(args.jsonl)

    steps = [r for r in records if "event" not in r]
    if args.check:
        if errors:
            print(f"metrics check FAILED: {errors[0]}"
                  + (f" (+{len(errors) - 1} more)" if len(errors) > 1
                     else ""))
            return 1
        if not steps:
            print(f"metrics check FAILED: no step records in {args.jsonl}")
            return 1
        print(f"metrics check OK: {len(steps)} step records"
              + (f" (+{len(records) - len(steps)} event records)"
                 if len(records) > len(steps) else ""))
        return 0

    for e in errors:
        print(f"warning: {e}", file=sys.stderr)
    if not records:
        print(f"no step records in {args.jsonl}", file=sys.stderr)
        return 1
    if args.last:
        steps = steps[-args.last:]
        records = [r for r in records if "event" in r] + steps
    summarize(records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
