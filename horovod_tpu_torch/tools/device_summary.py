"""Summarize a device trace: time by category, the top kernels, and the
card's idle share.

Reads the Chrome trace that ``torch.profiler`` exports
(``utils/prof.py``'s samples under ``HOROVOD_PROF_DIR``,
``utils/timeline.profiler_trace``, or any ``export_chrome_trace``) and
prints, for each device (``/device:GPU:<i>``):

  - the wall span against the union of span time (idle = the gaps);
  - time by category (``kernel``, ``gpu_memcpy``, ``gpu_memset``);
  - the top-N kernels by total time, with their counts.

The twin of the JAX package's ``scripts/xplane_summary.py``, on a Chrome
trace instead of an ``.xplane.pb`` (``utils/kineto.py`` reads it). A
trace without CUDA activity is summarized over its host ``cpu_op``
spans, as the JAX tool summarizes a CPU backend's capture. ``--json``
emits one machine-readable object (to stdout or a file);
``--attribute`` adds the compute / exposed-collective / idle
attribution over the whole trace.

Usage:
    python -m horovod_tpu_torch.tools.device_summary /tmp/hvd_prof/rank0/step4
    python -m horovod_tpu_torch.tools.device_summary trace.json --json out.json
"""

import argparse
import json
import sys

from ..utils import kineto
from ..utils.prof import SPIN_KERNEL


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logdir", help="capture directory or Chrome trace file")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="FILE",
                    help="emit a machine-readable summary (to FILE, or "
                         "stdout with no argument) instead of only the "
                         "human tables")
    ap.add_argument("--attribute", action="store_true",
                    help="also print the compute/exposed-collective/"
                         "idle attribution over the whole trace")
    args = ap.parse_args(argv)

    try:
        trace, path = kineto.load_trace(args.logdir)
    except kineto.TraceUnavailable as e:
        print(f"device_summary: {e}", file=sys.stderr)
        return 1

    print(f"# {path}")
    ops = kineto.op_events(trace, skip=(SPIN_KERNEL,))
    host = not ops
    if host:
        ops = kineto.op_events(trace, device_ops=False)
    if not ops:
        print("device_summary: the trace holds no device or host op "
              "spans", file=sys.stderr)
        return 1
    if host:
        print(f"(no device spans; {len(ops)} host operator spans — a "
              "capture without CUDA activity)")
    summaries = kineto.summarize(ops)
    for s in summaries:
        print(f"\n== plane: {s['plane']} ==")
        print(f"wall {s['wall_us']:.0f}us  busy {s['busy_us']:.0f}us  "
              f"idle {s['idle_frac']:.1%}")
        total = sum(s["by_cat"].values()) or 1.0
        print("\n-- by category --")
        for cat, us in sorted(s["by_cat"].items(),
                              key=lambda kv: -kv[1]):
            print(f"{us:12.0f}us  {us / total:6.1%}  {cat}")
        print(f"\n-- top {args.top} ops --")
        top = sorted(s["by_op"].items(), key=lambda kv: -kv[1])
        for name, us in top[:args.top]:
            print(f"{us:12.0f}us  {us / total:6.1%}  "
                  f"x{s['occur'][name]:<4d} {name[:110]}")

    want_attr = args.attribute or args.json is not None
    attribution = kineto.attribute_by_plane(ops) if want_attr else None
    if args.attribute:
        overlap = attribution["measured_overlap_frac"]
        print("\n-- attribution (whole trace) --")
        print(f"compute {attribution['compute_frac']:.1%}  "
              f"exposed wire {attribution['exposed_wire_frac']:.1%}  "
              f"idle {attribution['idle_frac']:.1%}  "
              f"overlap of collectives: "
              + (f"{overlap:.1%}" if overlap is not None
                 else "n/a (no collectives)"))

    if args.json is not None:
        obj = {
            "what": "device-trace summary",
            "trace": path,
            "planes": [
                {
                    "plane": s["plane"],
                    "wall_us": s["wall_us"],
                    "busy_us": s["busy_us"],
                    "idle_frac": s["idle_frac"],
                    "by_cat": dict(sorted(s["by_cat"].items(),
                                          key=lambda kv: -kv[1])),
                }
                for s in summaries
            ],
            "op_events": len(ops),
            "attribution": attribution,
        }
        if args.json == "-":
            print(json.dumps(obj))
        else:
            with open(args.json, "w") as f:
                json.dump(obj, f, indent=1)
                f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
