"""``hvdrun`` — the horovodrun-equivalent CLI of the PyTorch port.

Reference horovod/runner/launch.py — parse_args (:286), ``_run_static``
(:583); the JAX package's ``runner/launch.py`` is the same launcher. Its
command lines parse here unchanged (``parse_args`` is the same parser),
and ``python -m horovod_tpu_torch.runner.launch`` takes them. The data
plane is ``torch.distributed`` (NCCL on the card, gloo with the
worker's ``--device cpu``), bootstrapped by rank 0's TCP store
(``runner/exec_run.py``).

``--host-discovery-script`` (or ``--min-np``/``--max-np``) runs the
job elastically (``_run_elastic``, ``horovod_tpu/runner/launch.py:504-
560``): an ``ElasticDriver`` (``runner/elastic/``) polls the script,
launches each round's workers with the rendezvous store's address,
blacklists a host whose worker failed, keeps a preempted one (exit 83),
and starts a new round until one succeeds; ``--emergency-checkpoint``,
``--replication``, ``--no-preemption`` and the retry flags reach the
workers' knobs, ``--rendezvous-state-dir`` makes the driver's store
durable.

``--cycle-time-ms``, ``--cache-capacity`` and the stall flags set the
eager negotiation runtime's knobs (``HVD_TPU_NATIVE=1`` in the workers'
environment starts it), and every slot gets the runtime's coordinator
address (``runner/exec_run.py``).

``--timeline-filename``, ``--timeline-mark-cycles``,
``--flight-recorder``/``--no-flight-recorder``, ``--flight-dir``,
``--prof-every``, ``--prof-dir`` and ``--prof-duty-cycle`` set the
workers' telemetry knobs (``HOROVOD_TIMELINE*``, ``HOROVOD_FLIGHT_*``,
``HOROVOD_PROF_*``); every launch runs a rendezvous store whose
``/metrics`` merges the workers' pushes, whose ``/flight/<rank>`` holds
their dumps and whose ``/health`` judges their health summaries
(``runner/exec_run.py``). ``--autotune``, ``--autotune-bayes``,
``--autotune-log``, ``--autotune-cache``, ``--autotune-mfu`` and
``--autotune-wire`` set the workers' autotune knobs
(``HOROVOD_AUTOTUNE*``, ``ops/autotune.py``).

A flag whose feature the port does not have yet — the sharded control
plane — is
refused when given (on the command line or in ``--config-file``): the launcher
exits 2 naming its ROADMAP queue A entry (``UNPORTED``), and exports
nothing no worker would read.

Usage:
    python -m horovod_tpu_torch.runner.launch -np 4 -H h1:2,h2:2 \
        python -m horovod_tpu_torch.examples.gpt2_pretraining --flash
    python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
        python train.py --device cpu
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 \
        --max-np 4 --host-discovery-script ./discover.sh \
        --emergency-checkpoint /ckpt/emergency.pkl \
        python -m horovod_tpu_torch.examples.gpt2_elastic --flash
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
from typing import List, Optional, Tuple

from .util import config_parser
from .util.hosts import HostInfo, parse_host_files, parse_hosts

#: ROADMAP queue A entry -> what it brings
ENTRIES = {
    14: "multipod and the sharded control plane",
}

#: argparse dest of a flag the port refuses -> its ROADMAP queue A entry
UNPORTED = {
    **dict.fromkeys((
        "root_replicas", "root_state_dir", "root_lease_ttl",
        "root_heartbeat", "pod_relays"), 14),
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hvdrun",
        description="Launch a horovod_tpu_torch training job.",
    )
    p.add_argument("-v", "--version", action="store_true")
    p.add_argument("--check-build", dest="check_build",
                   action="store_true",
                   help="Print availability of frameworks, controllers "
                        "and ops, then exit (reference launch.py:110).")
    p.add_argument(
        "-np", "--num-proc", dest="np", type=int,
        help="Total number of worker processes (slots).",
    )
    p.add_argument(
        "-H", "--hosts", dest="hosts",
        help="Comma-separated host:slots list, e.g. h1:1,h2:1.",
    )
    p.add_argument(
        "-hostfile", "--hostfile", dest="hostfile",
        help="Hostfile with `host slots=N` lines.",
    )
    p.add_argument("--verbose", action="count", default=0)
    p.add_argument("--config-file", dest="config_file")

    # elastic (reference launch.py:676)
    p.add_argument("--min-np", dest="min_np", type=int)
    p.add_argument("--max-np", dest="max_np", type=int)
    p.add_argument(
        "--host-discovery-script", dest="host_discovery_script",
        help="Executable printing the current host:slots list, one per line.",
    )
    p.add_argument("--slots-per-host", dest="slots", type=int, default=1)
    p.add_argument("--elastic-timeout", dest="elastic_timeout", type=float)
    p.add_argument("--reset-limit", dest="reset_limit", type=int)
    p.add_argument(
        "--blacklist-cooldown-range", dest="cooldown_range", nargs=2,
        type=float, metavar=("MIN_S", "MAX_S"),
    )

    # runtime knobs → env (reference launch.py:286-580, config_parser)
    p.add_argument("--fusion-threshold-mb", dest="fusion_threshold_mb",
                   type=int)
    p.add_argument("--cycle-time-ms", dest="cycle_time_ms", type=float)
    p.add_argument("--cache-capacity", dest="cache_capacity", type=int)
    p.add_argument("--timeline-filename", dest="timeline_filename")
    p.add_argument("--timeline-mark-cycles", dest="timeline_mark_cycles",
                   action="store_true", default=None)
    p.add_argument("--autotune", dest="autotune", action="store_true",
                   default=None)
    p.add_argument("--autotune-bayes", dest="autotune_bayes",
                   action="store_true",
                   help="Bayesian (GP + expected-improvement) autotune "
                        "search instead of coordinate descent")
    p.add_argument("--autotune-log", dest="autotune_log")
    p.add_argument("--autotune-cache", dest="autotune_cache",
                   help="persistent warm-start cache for the "
                        "closed-loop OnlineTuner "
                        "(HOROVOD_AUTOTUNE_CACHE, docs/autotune.md): "
                        "winners persist per (model fingerprint, "
                        "topology); later runs and serving replicas "
                        "pin the cached configuration with zero "
                        "tuning compiles")
    p.add_argument("--autotune-mfu", dest="autotune_mfu",
                   choices=["0", "1"],
                   help="score autotune trials by measured hvd_mfu "
                        "when the continuous profiler is live "
                        "(HOROVOD_AUTOTUNE_MFU, default 1; the "
                        "step-time p50 via StepStats is always "
                        "recorded and is the fallback score)")
    p.add_argument("--autotune-wire", dest="autotune_wire",
                   choices=["0", "1"],
                   help="opt IN to the NUMERICS-CHANGING autotune "
                        "dimensions — wire dtype/block and eager "
                        "fast-path warmup K (HOROVOD_AUTOTUNE_WIRE, "
                        "default 0; int8 on the wire is lossy, so "
                        "the tuner never sweeps or warm-starts these "
                        "without explicit consent)")
    p.add_argument("--compression", dest="compression",
                   choices=["none", "fp16", "bf16", "int8", "int8-raw"],
                   help="compressed collective data plane "
                        "(HOROVOD_COMPRESSION, docs/compression.md): "
                        "cast wires halve gradient bytes, int8 "
                        "block-quantizes them ~4x with error feedback")
    p.add_argument("--compression-block", dest="compression_block",
                   type=int,
                   help="int8 quantization block (elements per scale, "
                        "HOROVOD_COMPRESSION_BLOCK, default 256)")
    p.add_argument("--overlap-schedule", dest="overlap_schedule",
                   choices=["off", "stage", "double"],
                   help="backward-interleaved collective scheduler "
                        "(HOROVOD_OVERLAP_SCHEDULE, docs/overlap.md): "
                        "'stage' issues each fusion bucket's "
                        "collective inside the backward, pinned before "
                        "the next segment's compute; 'double' also "
                        "defers optimizer consumption until the last "
                        "segment retires; default off")
    p.add_argument("--fsdp", dest="fsdp", choices=["0", "1"],
                   help="fully-sharded parameters / ZeRO-3 routing "
                        "(HOROVOD_FSDP, docs/fsdp.md): 1 (default) "
                        "routes FullyShardedOptimizer train steps "
                        "through the prefetch-interleaved FSDP path — "
                        "params + optimizer state ~1/world per chip; "
                        "0 disables routing (such a step then raises; "
                        "non-FSDP configs are untouched either way)")
    p.add_argument("--fsdp-prefetch", dest="fsdp_prefetch", type=int,
                   help="FSDP forward all-gather look-ahead in stages "
                        "(HOROVOD_FSDP_PREFETCH, default 1): bucket "
                        "k+1's parameter gather issues at segment k's "
                        "boundary and overlaps its compute; 0 "
                        "serializes gathers at their need boundaries")
    p.add_argument("--fsdp-regather", dest="fsdp_regather",
                   choices=["0", "1"],
                   help="FSDP backward re-gather policy "
                        "(HOROVOD_FSDP_REGATHER, docs/fsdp.md): 1 "
                        "(default) drops each gathered bucket at its "
                        "last forward use and re-issues the all-gather "
                        "at its backward-first-use boundary — "
                        "within-step peak param liveness capped at "
                        "sharded + one bucket working set, bitwise "
                        "equal to 0 (save gathered weights across the "
                        "whole step — the pre-regather lowering)")
    p.add_argument("--fsdp-offload", dest="fsdp_offload",
                   choices=["0", "1"],
                   help="FSDP host-RAM activation offload "
                        "(HOROVOD_FSDP_OFFLOAD, docs/fsdp.md): 1 parks "
                        "inter-stage carries in pinned host memory on "
                        "forward and prefetches each back one backward "
                        "segment ahead; bitwise no-op on values; "
                        "default 0")
    p.add_argument("--fsdp-offload-duty", dest="fsdp_offload_duty",
                   type=float,
                   help="fraction of eligible stage carries the "
                        "offload parks on the host "
                        "(HOROVOD_FSDP_OFFLOAD_DUTY, default 1.0): "
                        "earliest stages first — bound the host PCIe "
                        "duty cycle when full offload would not hide "
                        "under compute")
    p.add_argument("--fused-collectives", dest="fused_collectives",
                   choices=["0", "1"],
                   help="HOROVOD_FUSED_COLLECTIVES, read for parity "
                        "with horovod_tpu: on the card the int8 wire, "
                        "the bucket pack and the decode KV-append+"
                        "attention always run their CUDA kernels")
    p.add_argument("--compression-wire-dtype",
                   dest="compression_wire_dtype",
                   choices=["bfloat16", "float16"])
    p.add_argument("--fp16-allreduce", dest="compression_wire_dtype",
                   action="store_const", const="bfloat16",
                   help="bf16-on-the-wire gradient compression (the "
                        "bf16 form of the reference's fp16 allreduce).")
    p.add_argument("--hierarchical-allreduce",
                   dest="hierarchical_allreduce", action="store_true",
                   default=None)
    p.add_argument("--hierarchical-allgather",
                   dest="hierarchical_allgather", action="store_true",
                   default=None)
    p.add_argument("--hierarchical-local-size",
                   dest="hierarchical_local_size", type=int,
                   help="ranks per inner (ICI) domain for hierarchical "
                        "collectives; 0 = auto (local device count)")
    p.add_argument("--stall-check-disable", dest="stall_check_disable",
                   action="store_true", default=None)
    p.add_argument("--stall-warning-time-seconds",
                   dest="stall_warning_time_seconds", type=float)
    p.add_argument("--stall-shutdown-time-seconds",
                   dest="stall_shutdown_time_seconds", type=float)
    p.add_argument("--stall-abort-seconds", dest="stall_abort_s",
                   type=float,
                   help="Negotiation watchdog: a collective making no "
                        "progress for this long raises "
                        "HorovodInternalError so elastic training "
                        "restores and retries (0 = off).")

    # fault tolerance / chaos (docs/faults.md)
    p.add_argument("--fault-spec", dest="fault_spec",
                   help="Fault-injection spec for workers, e.g. "
                        "'http.put:error:0.3:seed=7' (docs/faults.md).")
    p.add_argument("--retry-max-attempts", dest="retry_max_attempts",
                   type=int,
                   help="Control-plane retry attempts (default 5).")
    p.add_argument("--retry-base-delay", dest="retry_base_delay",
                   type=float,
                   help="First control-plane backoff in seconds "
                        "(default 0.1).")
    p.add_argument("--retry-max-delay", dest="retry_max_delay",
                   type=float,
                   help="Control-plane backoff cap in seconds "
                        "(default 2.0).")
    p.add_argument("--vanish-grace", dest="vanish_grace", type=float,
                   help="Seconds a host may drop out of discovery "
                        "before its worker is counted failed "
                        "(default 5).")
    p.add_argument("--spawn-join", dest="spawn_join", type=float,
                   help="Post-round spawn-thread join budget in "
                        "seconds (default 30).")
    p.add_argument("--no-preemption", dest="preemption",
                   action="store_const", const="0", default=None,
                   help="Disable the SIGTERM preemption handler in "
                        "workers (elastic/preemption.py).")
    p.add_argument("--emergency-checkpoint", dest="emergency_checkpoint",
                   help="Rank-0 emergency snapshot path written on "
                        "preemption (SIGTERM).")
    p.add_argument("--replication", dest="replication",
                   action="store_const", const="1", default=None,
                   help="Async peer snapshot replication: every "
                        "state.commit() ships the committed snapshot "
                        "to ring-partner ranks so a respawned worker "
                        "restores from a surviving peer instead of "
                        "stale disk state (docs/recovery.md).")
    p.add_argument("--replication-partners", dest="replication_partners",
                   type=int,
                   help="Ring partners each rank replicates its "
                        "snapshot to (default 1).")
    p.add_argument("--rendezvous-state-dir", dest="rendezvous_state_dir",
                   help="Directory for the rendezvous server's atomic "
                        "on-disk state snapshot; a restarted driver "
                        "pointed at the same directory resumes the "
                        "same job on the same port (docs/recovery.md).")

    # sharded root control plane (docs/control_plane.md)
    p.add_argument("--root-replicas", dest="root_replicas", type=int,
                   help="Shard the root KV tier across N supervised "
                        "replica processes with consistent-hash "
                        "routing, lease/fencing takeover, and "
                        "write-through ring backups; hvdrun spawns, "
                        "backoff-restarts and reaps them. Default 1 = "
                        "today's single root, bit-for-bit "
                        "(docs/control_plane.md).")
    p.add_argument("--root-state-dir", dest="root_state_dir",
                   help="Directory for the root replicas' persisted "
                        "state snapshots (default: a fresh temp dir); "
                        "a supervisor-restarted replica reloads its "
                        "store from here before re-pulling deltas "
                        "from peers.")
    p.add_argument("--root-lease-ttl", dest="root_lease_ttl",
                   type=float,
                   help="Replica lease TTL in seconds (default 3.0): "
                        "a silent replica is fenced and taken over "
                        "after this long.")
    p.add_argument("--root-heartbeat", dest="root_heartbeat",
                   type=float,
                   help="Replica lease heartbeat cadence in seconds "
                        "(default 0.5).")
    p.add_argument("--pod-relays", dest="pod_relays", type=int,
                   help="Spawn N launcher-supervised per-pod relay "
                        "processes (multipod/relay.py) targeting the "
                        "root tier, replacing the operator-run relays "
                        "of docs/multipod.md; crashed relays restart "
                        "under backoff with flap counting.")
    p.add_argument("--prof-every", dest="prof_every", type=int,
                   help="Continuous step profiler: sample every N-th "
                        "step with device tracing and export compute/"
                        "exposed-wire/idle attribution + hvd_mfu "
                        "(0 = off; docs/timeline.md).")
    p.add_argument("--prof-dir", dest="prof_dir",
                   help="Root directory for sampled profiler captures "
                        "(default <tmpdir>/hvd_prof/rank<r>); feed it "
                        "to tools.trace_merge --xplane.")
    p.add_argument("--prof-duty-cycle", dest="prof_duty_cycle",
                   type=float,
                   help="Cap on the fraction of wall time the sampled "
                        "profiler may consume (default 0.02).")
    p.add_argument("--flight-recorder", dest="flight_recorder",
                   action="store_const", const="1", default=None,
                   help="Force the control-plane flight recorder on in "
                        "workers (default on; docs/flight.md).")
    p.add_argument("--no-flight-recorder", dest="flight_recorder",
                   action="store_const", const="0",
                   help="Disable the flight recorder (its record sites "
                        "become single predicted branches).")
    p.add_argument("--flight-dir", dest="flight_dir",
                   help="Directory for rank-local flight dumps "
                        "(default <tmpdir>/hvd_flight); dumps also "
                        "ship to the rendezvous server.")
    p.add_argument("--log-level", dest="log_level",
                   choices=["TRACE", "DEBUG", "INFO", "WARNING", "ERROR",
                            "FATAL"])
    p.add_argument("--mesh", dest="mesh",
                   help='Mesh axis spec for workers, e.g. "dp=4,tp=2".')
    p.add_argument(
        "--network-interface", dest="nics",
        help="Comma-separated NICs to bind: rank 0's TCP store binds "
             "the first one's address, and workers get them as "
             "HOROVOD_NICS, "
             "NCCL_SOCKET_IFNAME and GLOO_SOCKET_IFNAME.",
    )

    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="Training command to run on every slot.")

    for action in p._actions:
        if action.dest in UNPORTED:
            action.help = (f"[not in horovod_tpu_torch yet: ROADMAP queue "
                           f"A entry {UNPORTED[action.dest]}] "
                           + (action.help or ""))
    return p


def _own_argv(argv: List[str], args) -> List[str]:
    """hvdrun's own arguments: the trainee command captured by
    REMAINDER may contain identically-named flags."""
    return argv[: len(argv) - len(args.command)] if args.command else argv


def parse_args(argv: Optional[List[str]] = None):
    p = _parser()
    args = p.parse_args(argv)

    if args.config_file:
        full_argv = list(argv if argv is not None else sys.argv[1:])
        explicit = _explicit_dests(_own_argv(full_argv, args), p)
        config_parser.apply_config_file(args, args.config_file, explicit)
    return args


def _explicit_dests(argv, parser) -> set:
    """Dests the user set on the command line (beat the config file)."""
    explicit = set()
    for action in parser._actions:
        for opt in action.option_strings:
            if any(a == opt or a.startswith(opt + "=") for a in argv):
                explicit.add(action.dest)
    return explicit


def unported_flags(args, argv: List[str]) -> List[Tuple[str, int]]:
    """(flag, ROADMAP entry) for every flag the port refuses that the
    user gave: explicitly on the command line, or through the config
    file (a value other than the flag's default)."""
    p = _parser()
    own = _own_argv(list(argv), args)
    explicit = _explicit_dests(own, p)
    out = []
    for action in p._actions:
        entry = UNPORTED.get(action.dest)
        if entry is None:
            continue
        given = [o for o in action.option_strings
                 if any(a == o or a.startswith(o + "=") for a in own)]
        if given or (action.dest not in explicit
                     and getattr(args, action.dest) != action.default):
            out.append(((given or action.option_strings)[-1], entry))
    return sorted(set(out))


def _resolve_hosts(args) -> List[HostInfo]:
    if args.hostfile:
        return parse_hosts(parse_host_files(args.hostfile))
    if args.hosts:
        return parse_hosts(args.hosts)
    np = args.np or 1
    return [HostInfo("localhost", np)]


def is_elastic(args) -> bool:
    return bool(args.host_discovery_script or args.min_np or args.max_np)


def _run_static(args) -> int:
    from .exec_run import run_static

    hosts = _resolve_hosts(args)
    if args.np is None:
        args.np = sum(h.slots for h in hosts)
    env = config_parser.env_from_args(args, dict(os.environ))
    codes = run_static(
        args.command, hosts, args.np, env=env,
        nics=args.nics.split(",") if args.nics else None,
    )
    # a failing rank exits with its own (positive) code; the ranks the
    # launcher stopped after it report the signal (negative codes)
    failed = [c for c in codes if c > 0] or [abs(c) for c in codes if c]
    return failed[0] if failed else (0 if codes else 1)


def _run_elastic(args) -> int:
    from .elastic.discovery import HostDiscoveryScript, HostManager
    from .elastic.driver import ElasticDriver
    from .elastic.settings import ElasticSettings

    if not args.host_discovery_script:
        raise ValueError(
            "elastic mode requires --host-discovery-script "
            "(reference launch.py:676)")
    settings = ElasticSettings(
        min_np=args.min_np or args.np or 1,
        max_np=args.max_np,
        timeout_s=args.elastic_timeout or 600.0,
        reset_limit=args.reset_limit or 0,
        cooldown_range=tuple(args.cooldown_range)
        if args.cooldown_range else None,
        # None falls back to the HOROVOD_ELASTIC_* knobs
        host_vanish_grace_s=args.vanish_grace,
        spawn_join_timeout_s=args.spawn_join,
    )
    discovery = HostDiscoveryScript(args.host_discovery_script, args.slots)
    env = config_parser.env_from_args(args, dict(os.environ))
    driver = ElasticDriver(
        HostManager(discovery, settings.cooldown_range),
        settings,
        command=args.command,
        env=env,
        nics=args.nics.split(",") if args.nics else None,
        rendezvous_state_dir=args.rendezvous_state_dir or None,
    )
    return driver.run()


def _check_build() -> int:
    """Availability table (reference launch.py:110 check_build): the
    port's framework, its controllers (``torch.distributed``'s NCCL and
    gloo, and the eager runtime's native control plane, built here if
    it is not yet) and tensor operations, CUDA, and the ``nvcc`` that
    ``ops/_build.py`` compiles the kernels with
    (``horovod_tpu/runner/launch.py:583-602``)."""
    import torch

    from .. import __version__
    from .. import _native
    from ..core import basics
    from ..ops import _build

    def mark(ok: bool) -> str:
        return "X" if ok else " "

    try:
        _native.build()
        native = True
    except (OSError, RuntimeError):
        native = False

    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = ""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"horovod_tpu_torch v{__version__}:\n")
    print("Available Frameworks:")
    print(f"    [X] PyTorch {torch.__version__}")
    print("\nAvailable Controllers:")
    print(f"    [{mark(basics.nccl_built())}] NCCL (torch.distributed)")
    print(f"    [{mark(basics.gloo_built())}] Gloo (torch.distributed)")
    print(f"    [{mark(native)}] Native eager control plane "
          f"(libhvd_torch_core)")
    print("\nAvailable Tensor Operations:")
    print(f"    [{mark(basics.nccl_built())}] NCCL")
    print(f"    [{mark(basics.gloo_built())}] Gloo")
    print(f"    [{mark(native)}] Negotiated eager (DistExecutor)")
    print(f"    [{mark(basics.cuda_built())}] CUDA "
          f"{torch.version.cuda or 'not built'}, {cards} card(s) visible")
    print("\nKernel build (ops/_build.py):")
    print(f"    [{mark(bool(nvcc))}] nvcc {nvcc}")
    return 0


def run_commandline(argv: Optional[List[str]] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    args = parse_args(argv)
    refused = unported_flags(args, argv)
    if refused:
        for flag, entry in refused:
            print(f"hvdrun: {flag} is not in horovod_tpu_torch yet: "
                  f"ROADMAP queue A entry {entry} ({ENTRIES[entry]})",
                  file=sys.stderr)
        return 2
    if args.version:
        from .. import __version__

        print(__version__)
        return 0
    if args.check_build:
        return _check_build()
    if not args.command:
        print("hvdrun: no command given", file=sys.stderr)
        return 2
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if is_elastic(args):
        return _run_elastic(args)
    return _run_static(args)


def main() -> None:
    # SIGTERM raises SystemExit in the main thread, which launch_slots
    # turns into stopping every slot's process tree before exiting
    signal.signal(signal.SIGTERM,
                  lambda signum, frame: sys.exit(128 + signum))
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
