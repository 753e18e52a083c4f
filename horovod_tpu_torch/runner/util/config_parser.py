"""CLI/YAML/JSON config → environment-variable knobs.

Reference horovod/runner/common/util/config_parser.py + launch.py:286-580:
every launcher flag maps onto a ``HOROVOD_*`` env var that the worker's
``core/knobs.py`` reads (here: every flag ``runner/launch.py`` does not
refuse). Config files set the same keys; explicit CLI
flags win over the file. A config file is YAML when ``yaml`` is
installed, else JSON or flat ``key: value`` lines.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

# flag name (argparse dest) → env var set for workers: the JAX
# package's map, whole, so a config or command line means the same in
# both packages; runner/launch.py refuses the flags of features the
# port lacks (launch.UNPORTED) before anything is exported
ARG_TO_ENV = {
    "fusion_threshold_mb": "HOROVOD_FUSION_THRESHOLD",
    "cycle_time_ms": "HOROVOD_CYCLE_TIME",
    "cache_capacity": "HOROVOD_CACHE_CAPACITY",
    "timeline_filename": "HOROVOD_TIMELINE",
    "timeline_mark_cycles": "HOROVOD_TIMELINE_MARK_CYCLES",
    "autotune": "HOROVOD_AUTOTUNE",
    "autotune_bayes": "HOROVOD_AUTOTUNE_BAYES",
    "autotune_log": "HOROVOD_AUTOTUNE_LOG",
    # closed-loop OnlineTuner warm start + scoring (docs/autotune.md).
    # --autotune-mfu / --autotune-wire store literal "0"/"1"
    # (env_from_args skips boolean False, so a store_false flag could
    # never reach the env — the --fsdp precedent)
    "autotune_cache": "HOROVOD_AUTOTUNE_CACHE",
    "autotune_mfu": "HOROVOD_AUTOTUNE_MFU",
    "autotune_wire": "HOROVOD_AUTOTUNE_WIRE",
    "compression_wire_dtype": "HOROVOD_COMPRESSION_WIRE_DTYPE",
    "compression": "HOROVOD_COMPRESSION",
    "compression_block": "HOROVOD_COMPRESSION_BLOCK",
    "overlap_schedule": "HOROVOD_OVERLAP_SCHEDULE",
    # --fsdp stores the literal "0"/"1" (env_from_args skips boolean
    # False, so a store_false flag could never reach the env)
    "fsdp": "HOROVOD_FSDP",
    "fsdp_prefetch": "HOROVOD_FSDP_PREFETCH",
    "fsdp_regather": "HOROVOD_FSDP_REGATHER",
    "fsdp_offload": "HOROVOD_FSDP_OFFLOAD",
    "fsdp_offload_duty": "HOROVOD_FSDP_OFFLOAD_DUTY",
    "fused_collectives": "HOROVOD_FUSED_COLLECTIVES",
    "hierarchical_allreduce": "HOROVOD_HIERARCHICAL_ALLREDUCE",
    "hierarchical_allgather": "HOROVOD_HIERARCHICAL_ALLGATHER",
    "hierarchical_local_size": "HOROVOD_HIERARCHICAL_LOCAL_SIZE",
    "elastic_timeout": "HOROVOD_ELASTIC_TIMEOUT",
    "reset_limit": "HOROVOD_RESET_LIMIT",
    "stall_check_disable": "HOROVOD_STALL_CHECK_DISABLE",
    "stall_warning_time_seconds": "HOROVOD_STALL_CHECK_TIME_SECONDS",
    "stall_shutdown_time_seconds": "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
    "stall_abort_s": "HOROVOD_STALL_ABORT_S",
    "fault_spec": "HOROVOD_TPU_FAULT_SPEC",
    "retry_max_attempts": "HOROVOD_RETRY_MAX_ATTEMPTS",
    "retry_base_delay": "HOROVOD_RETRY_BASE_DELAY",
    "retry_max_delay": "HOROVOD_RETRY_MAX_DELAY",
    "vanish_grace": "HOROVOD_ELASTIC_VANISH_GRACE",
    "spawn_join": "HOROVOD_ELASTIC_SPAWN_JOIN",
    # --no-preemption stores the literal "0" (env_from_args skips
    # boolean False, so a store_false flag could never reach the env)
    "preemption": "HOROVOD_PREEMPTION",
    "emergency_checkpoint": "HOROVOD_EMERGENCY_CHECKPOINT",
    # --replication stores the literal "1" (same reason as preemption)
    "replication": "HOROVOD_REPLICATION",
    "replication_partners": "HOROVOD_REPLICATION_PARTNERS",
    # --no-flight-recorder stores "0" for the same reason
    "flight_recorder": "HOROVOD_FLIGHT_RECORDER",
    "flight_dir": "HOROVOD_FLIGHT_DIR",
    # sharded root control plane (docs/control_plane.md): the replica
    # count + timing knobs ride to workers so in-worker clients and
    # knobs.from_env agree with the launcher-spawned tier.
    # HOROVOD_ROOT_ADDRS itself is NOT here — the launcher computes it
    # after reserving ports and exports it directly.
    "root_replicas": "HOROVOD_ROOT_REPLICAS",
    "root_lease_ttl": "HOROVOD_ROOT_LEASE_TTL",
    "root_heartbeat": "HOROVOD_ROOT_HEARTBEAT",
    "prof_every": "HOROVOD_PROF_EVERY",
    "prof_dir": "HOROVOD_PROF_DIR",
    "prof_duty_cycle": "HOROVOD_PROF_DUTY_CYCLE",
    "log_level": "HOROVOD_LOG_LEVEL",
    "mesh": "HOROVOD_MESH",
}


def _to_env_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    return str(v)


def env_from_args(args, env: Optional[Dict[str, str]] = None
                  ) -> Dict[str, str]:
    """Collect worker env vars from parsed CLI args (None values skipped)."""
    env = dict(env or {})
    for dest, var in ARG_TO_ENV.items():
        v = getattr(args, dest, None)
        if v is None or v is False or v == "":
            continue
        if dest == "fusion_threshold_mb":
            v = int(v) * 1024 * 1024
        env[var] = _to_env_value(v)
    return env


def load_config_file(path: str) -> Dict[str, object]:
    """YAML, JSON or flat ``key: value`` config file → {argparse dest:
    value}. Without ``yaml`` installed a JSON object reads as JSON (YAML
    reads it the same way) and anything else as ``key: value`` lines."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml  # type: ignore

        data = yaml.safe_load(text) or {}
    except ImportError:
        if text.lstrip().startswith("{"):
            data = json.loads(text)
        else:
            data = {}
            for line in text.splitlines():
                line = line.split("#", 1)[0].strip()
                if not line or ":" not in line:
                    continue
                k, _, v = line.partition(":")
                data[k.strip()] = _parse_scalar(v.strip())
    flat: Dict[str, object] = {}
    _flatten(data, flat)
    return {k.replace("-", "_"): v for k, v in flat.items()}


def _flatten(d, out):
    for k, v in d.items():
        if isinstance(v, dict):
            _flatten(v, out)
        elif k in out and out[k] != v:
            raise ValueError(
                f"config key {k!r} appears in multiple sections with "
                f"different values ({out[k]!r} vs {v!r})"
            )
        else:
            out[k] = v


def _parse_scalar(v: str):
    low = v.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def apply_config_file(args, path: str, explicit_dests) -> None:
    """Set args fields from the config file unless given explicitly on the
    command line (reference config_parser.py behavior)."""
    for dest, value in load_config_file(path).items():
        if dest in explicit_dests:
            continue
        if hasattr(args, dest):
            setattr(args, dest, value)
