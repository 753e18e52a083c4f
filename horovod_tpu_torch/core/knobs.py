"""Environment-variable knobs read by the PyTorch port.

Same names, prefixes and defaults as the JAX package's registry
(``horovod_tpu/core/knobs.py``): ``HVD_TPU_X`` beats ``HOROVOD_X``
beats the default, so one launch script configures either package.
Only the fields this package reads are carried.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name: str, default: Optional[str] = None) -> Optional[str]:
    """HVD_TPU_X beats HOROVOD_X beats default."""
    for prefix in ("HVD_TPU_", "HOROVOD_"):
        v = os.environ.get(prefix + name)
        if v is not None:
            return v
    return default


def _env_int(name: str, default: int) -> int:
    v = _env(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        return default


def _env_bool(name: str, default: bool) -> bool:
    v = _env(name)
    if v is None or v == "":
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_float(name: str, default: float) -> float:
    v = _env(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        return default


@dataclasses.dataclass
class Knobs:
    """Typed snapshot of the knobs the port reads."""

    # --- gradient fusion (ops/fusion.py, optim/distributed.py) ---
    fusion_threshold_bytes: int = 128 * 1024 * 1024
    # on: each fusion bucket is issued from the backward's gradient
    # hooks, in plan order, as soon as its gradients exist (the JAX
    # package chains the buckets so that XLA cannot merge them); off:
    # the hooks only count, and synchronize() issues every bucket in
    # plan order after the backward (the combiner's schedule)
    ordered_buckets: bool = True
    # bucket gradients in the order backward produces them (last layer
    # first, embeddings last), so the first bucket is ready first
    bucket_backward_order: bool = True
    # wire compression of the gradient reduction (optim/compression.py):
    # "none", "fp16"/"bf16" (cast on the wire), "int8" (block-quantized
    # quantize -> exchange -> reduce -> requantize -> gather, with error
    # feedback), "int8-raw" (int8 without error feedback)
    compression: str = "none"
    # elements per int8 scale
    compression_block: int = 256
    # legacy cast-wire name ("bfloat16", "float16"), read when
    # `compression` is unset
    compression_wire_dtype: str = ""
    # The JAX package's switch between its XLA and Pallas int8 wires,
    # which give the same bits. Read for parity, it chooses nothing
    # here: a CUDA tensor always runs the hand-written kernels
    # (ops/quantized_collectives.py) and a CPU tensor their plain
    # versions.
    fused_collectives: bool = False
    # two-level (inner x outer) collectives (ops/hierarchical.py): the
    # global set's SUM/AVERAGE allreduce (and the DistributedOptimizer's
    # int8 buckets) as an inner reduce-scatter, an outer allreduce and
    # an inner all-gather; the global allgather as an inner then an
    # outer gather. local_size: ranks per inner domain (0: the
    # launcher's ranks per host, HOROVOD_LOCAL_SIZE)
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    hierarchical_local_size: int = 0

    # --- the eager negotiation runtime (ops/eager_runtime.py) ---
    # HVD_TPU_NATIVE=1: init() starts the C++ controller and the runtime,
    # and the top-level collectives (and, at world > 1, the
    # DistributedOptimizer's buckets) go through enqueue -> negotiation
    # -> fused execution -> synchronize
    native_eager: bool = False
    # the controller's negotiation cycle (operations.cc:515)
    cycle_time_ms: float = 1.0
    # response-cache entries; HOROVOD_CACHE_CAPACITY=0 turns it off
    cache_capacity: int = 1024
    cache_enabled: bool = True
    # stall inspector (stall_inspector.h:75-83): a warning after this
    # long, a shutdown of the world's pending collectives after that (0:
    # never)
    stall_check_enabled: bool = True
    stall_warning_time_seconds: float = 60.0
    stall_shutdown_time_seconds: float = 0.0
    # the runtime's watchdog: a collective wait making no progress for
    # this long raises HorovodInternalError, which elastic.run catches
    # (0: waits are bounded only by their callers)
    stall_abort_time_seconds: float = 0.0
    # the steady-state plan cache (HOROVOD_EAGER_FAST_PATH): after this
    # many identical enqueue sequences the negotiated fusion buckets and
    # their order are frozen and later steps skip the coordinator; any
    # deviation falls back to negotiation
    eager_fast_path: bool = True
    eager_fast_path_warmup: int = 3

    # --- backward-interleaved collective scheduler (ops/overlap.py) ---
    # "off" (default), "stage" or "double", as in the JAX package.
    # The port's replicated optimizers train through the hook-driven
    # step in every mode: with the backward-ordered plan
    # (bucket_backward_order) their hooks already issue each fusion
    # bucket at the first backward boundary where all of its gradients
    # exist, and consume every bucket after the backward. Spellings:
    # ops/overlap.normalize_mode.
    overlap_schedule: str = "off"

    # --- fully-sharded parameters (optim/fsdp.py) ---
    # routing gate: on, make_lm_train_step trains a FullyShardedOptimizer
    # through the FSDP step; off, such a step raises (other optimizers
    # never read it)
    fsdp: bool = True
    # forward all-gather look-ahead in stages (0: each gather at the
    # stage that first needs its bucket)
    fsdp_prefetch: int = 1
    # on: the forward keeps only the stage-boundary activations and the
    # backward gathers each bucket again and recomputes its stages; off:
    # the gathered buckets live from forward to backward. The same bits
    # either way
    fsdp_regather: bool = True
    # regather mode: park the stage-boundary activations in pinned host
    # memory until the backward, each fetched one stage ahead
    fsdp_offload: bool = False
    # the share of the eligible activations offloaded, earliest stages
    # first
    fsdp_offload_duty: float = 1.0

    # --- elastic training (elastic/, runner/elastic/) ---
    elastic_timeout_seconds: float = 600.0
    reset_limit: int = 0  # 0 = unlimited
    # SIGTERM handler (elastic/preemption.py): write the last commit as
    # the emergency snapshot and exit with the code the driver does not
    # blacklist
    preemption_enabled: bool = True
    emergency_checkpoint: str = ""  # rank 0's emergency snapshot path
    # async peer replication of each commit (elastic/replication.py)
    replication_enabled: bool = False
    replication_partners: int = 1
    replication_chunk_bytes: int = 1 << 20
    replication_duty_cycle: float = 0.02
    # on entry to elastic.run: restore from the freshest verified source
    # (peer replica, emergency snapshot, checkpoint)
    recovery_ladder: bool = True

    # --- mesh (parallel/mesh.py) ---
    # comma-separated axis spec, e.g. "dp=8" or "dp=4,tp=2"; empty = one
    # flat data-parallel axis over the world
    mesh_spec: str = ""

    # --- inference serving ---
    # padded batch-size buckets the engine captures a CUDA graph for;
    # requests are coalesced into the smallest covering bucket
    serving_buckets: str = "1,4,16,64"
    # dynamic-batching window: how long the batcher holds the first
    # request of a batch open for co-arrivals
    serving_max_wait_ms: float = 5.0
    serving_queue_limit: int = 256
    serving_request_timeout_seconds: float = 30.0

    # --- autoregressive generation ---
    serving_kv_dtype: str = "fp32"
    serving_kv_block: int = 0
    serving_decode_buckets: str = "4x128"
    serving_prefill_buckets: str = ""
    serving_decode_max_new: int = 64
    serving_decode_stats_every: int = 50
    # --- the replica autoscaler (serving/replica_set.ReplicaAutoscaler) ---
    serving_autoscale_interval_s: float = 2.0
    serving_autoscale_hi_occupancy: float = 0.85
    serving_autoscale_lo_occupancy: float = 0.25
    serving_autoscale_queue_wait_s: float = 0.5
    serving_autoscale_min_replicas: int = 1
    serving_autoscale_max_replicas: int = 4
    # consecutive over- or under-threshold polls before acting
    serving_autoscale_sustain: int = 2
    # seconds after an action before the next is considered
    serving_autoscale_cooldown_s: float = 10.0

    # --- autotune (ops/autotune.py) ---
    # HOROVOD_AUTOTUNE: init() builds the ParameterManager (without the
    # eager runtime) or starts the controller's tuner (with it)
    autotune: bool = False
    # the controller's Gaussian-process search instead of coordinate
    # descent (its copy of bayes.cc)
    autotune_bayes: bool = False
    # the ParameterManager's CSV log; the step tuners write "<log>.spmd"
    autotune_log: str = ""
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    # the OnlineTuner's warm-start cache: winners persist per (model
    # fingerprint, topology) at this path, and later runs and serving
    # replicas pin them without a sweep; "" = no cache
    autotune_cache: str = ""
    # score trials by the measured hvd_mfu when the sampled profiler is
    # live; the step-time p50 is always recorded and is the fallback
    autotune_mfu: bool = True
    # opt in to the numerics-changing dimensions (wire dtype and block,
    # the eager fast path's warmup): never swept or warm-started
    # without this consent
    autotune_wire: bool = False

    # --- timeline (utils/timeline.py) ---
    # the Chrome trace file init() starts writing ("" = none), and the
    # negotiation cycle's instants in it
    timeline_filename: str = ""
    timeline_mark_cycles: bool = False

    # --- metrics (utils/metrics.py) ---
    # counters, gauges, histograms and the step records; off by default
    metrics_enabled: bool = False
    # the per-step JSONL (canonical env HOROVOD_TPU_METRICS_FILE;
    # HVD_TPU_METRICS_FILE and HOROVOD_METRICS_FILE are read too)
    metrics_file: str = ""
    # a standalone GET /metrics port; 0 = none (the rendezvous store
    # mounts /metrics regardless)
    metrics_port: int = 0
    # a launched worker pushes its exposition to the rendezvous store
    # this often; 0 = no push
    metrics_push_interval_s: float = 5.0

    # --- sampled step profiler (utils/prof.py) ---
    # wrap every N-th hvd.metrics.step() in a torch.profiler window,
    # read its trace off the step's thread (utils/kineto.py) and export
    # the compute / exposed-wire / idle attribution; 0 = off (no step
    # hook installed)
    prof_every: int = 0
    # the sample root; "" = <tmpdir>/hvd_prof/rank<r>
    prof_dir: str = ""
    # the most of the wall time the profiler may take: after a sample
    # costing T the next waits T*(1/d - 1)
    prof_duty_cycle: float = 0.02

    # --- flight recorder (utils/flight.py) ---
    # on by default: a black box that is off when the plane crashes is
    # no black box
    flight_recorder: bool = True
    flight_dir: str = ""  # dump directory; "" = <tmpdir>/hvd_flight
    flight_capacity: int = 4096  # events kept in the ring

    # --- fleet-health monitor (health/) ---
    # live straggler and anomaly detection and SLO alerting over the
    # step and serving streams; off by default (the metrics-side
    # observer slots stay None)
    health_enabled: bool = False
    # the rank summary's publish cadence to the fleet evaluator (the
    # metrics push's endpoint); also the serving rules' evaluation tick
    health_interval_s: float = 2.0
    # the detectors' window (steps) and their warm-up before an anomaly
    health_window: int = 32
    health_min_steps: int = 8
    # the step-time factor over the rolling median (or the autotuner's
    # persisted baseline)
    health_step_time_factor: float = 1.75
    # the rule spec (health/rules.py grammar); "" = DEFAULT_RULES
    health_rules: str = ""
    # the incident JSONL (fire and clear transitions); "" = the step
    # log's event lines only
    health_incident_file: str = ""
    # on a firing rule: a flight dump and a forced profiler sample
    health_capture: bool = True

    # --- fault injection (utils/faults.py) ---
    # canonical env HOROVOD_TPU_FAULT_SPEC; empty = disabled no-op
    fault_spec: str = ""

    # --- control-plane retry (utils/retry.py default policy) ---
    retry_max_attempts: int = 5
    retry_base_delay_seconds: float = 0.1
    retry_max_delay_seconds: float = 2.0
    # "full": uniform on [0, backoff]; "bounded": +-25% around it
    retry_jitter: str = "full"
    # cap on the total seconds of one call's retries; <=0 disables
    retry_max_elapsed_seconds: float = 60.0

    # --- logging (utils/logging.py) ---
    log_level: str = "WARNING"
    log_hide_timestamp: bool = False
    # "[rank N]" line prefix, the rank read from the launcher's env
    log_rank: bool = False

    @staticmethod
    def from_env() -> "Knobs":
        return Knobs(
            fusion_threshold_bytes=_env_int(
                "FUSION_THRESHOLD", 128 * 1024 * 1024),
            ordered_buckets=_env_bool("ORDERED_BUCKETS", True),
            bucket_backward_order=_env_bool("BUCKET_BACKWARD_ORDER", True),
            compression=_env("COMPRESSION", "") or "none",
            compression_block=_env_int("COMPRESSION_BLOCK", 256),
            compression_wire_dtype=_env("COMPRESSION_WIRE_DTYPE", "") or "",
            fused_collectives=_env_bool("FUSED_COLLECTIVES", False),
            hierarchical_allreduce=_env_bool("HIERARCHICAL_ALLREDUCE",
                                             False),
            hierarchical_allgather=_env_bool("HIERARCHICAL_ALLGATHER",
                                             False),
            hierarchical_local_size=_env_int("HIERARCHICAL_LOCAL_SIZE", 0),
            native_eager=_env_bool("NATIVE", False),
            cycle_time_ms=_env_float("CYCLE_TIME", 1.0),
            cache_capacity=_env_int("CACHE_CAPACITY", 1024),
            cache_enabled=_env_int("CACHE_CAPACITY", 1024) > 0,
            stall_check_enabled=not _env_bool("STALL_CHECK_DISABLE", False),
            stall_warning_time_seconds=_env_float(
                "STALL_CHECK_TIME_SECONDS", 60.0),
            stall_shutdown_time_seconds=_env_float(
                "STALL_SHUTDOWN_TIME_SECONDS", 0.0),
            stall_abort_time_seconds=_env_float("STALL_ABORT_S", 0.0),
            eager_fast_path=_env_bool("EAGER_FAST_PATH", True),
            eager_fast_path_warmup=_env_int("EAGER_FAST_PATH_WARMUP", 3),
            overlap_schedule=_env("OVERLAP_SCHEDULE", "") or "off",
            fsdp=_env_bool("FSDP", True),
            fsdp_prefetch=_env_int("FSDP_PREFETCH", 1),
            fsdp_regather=_env_bool("FSDP_REGATHER", True),
            fsdp_offload=_env_bool("FSDP_OFFLOAD", False),
            fsdp_offload_duty=_env_float("FSDP_OFFLOAD_DUTY", 1.0),
            elastic_timeout_seconds=_env_float("ELASTIC_TIMEOUT", 600.0),
            reset_limit=_env_int("RESET_LIMIT", 0),
            preemption_enabled=_env_bool("PREEMPTION", True),
            emergency_checkpoint=_env("EMERGENCY_CHECKPOINT", "") or "",
            replication_enabled=_env_bool("REPLICATION", False),
            replication_partners=_env_int("REPLICATION_PARTNERS", 1),
            replication_chunk_bytes=_env_int("REPLICATION_CHUNK_BYTES",
                                             1 << 20),
            replication_duty_cycle=_env_float("REPLICATION_DUTY_CYCLE",
                                              0.02),
            recovery_ladder=_env_bool("RECOVERY_LADDER", True),
            serving_buckets=_env("SERVING_BUCKETS", "1,4,16,64")
            or "1,4,16,64",
            serving_max_wait_ms=_env_float("SERVING_MAX_WAIT_MS", 5.0),
            serving_queue_limit=_env_int("SERVING_QUEUE_LIMIT", 256),
            serving_request_timeout_seconds=_env_float(
                "SERVING_REQUEST_TIMEOUT", 30.0),
            serving_kv_dtype=_env("SERVING_KV_DTYPE", "fp32") or "fp32",
            serving_kv_block=_env_int("SERVING_KV_BLOCK", 0),
            serving_decode_buckets=_env(
                "SERVING_DECODE_BUCKETS", "4x128") or "4x128",
            serving_prefill_buckets=_env(
                "SERVING_PREFILL_BUCKETS", "") or "",
            serving_decode_max_new=_env_int("SERVING_DECODE_MAX_NEW", 64),
            serving_decode_stats_every=_env_int(
                "SERVING_DECODE_STATS_EVERY", 50),
            serving_autoscale_interval_s=_env_float(
                "SERVING_AUTOSCALE_INTERVAL_S", 2.0),
            serving_autoscale_hi_occupancy=_env_float(
                "SERVING_AUTOSCALE_HI_OCCUPANCY", 0.85),
            serving_autoscale_lo_occupancy=_env_float(
                "SERVING_AUTOSCALE_LO_OCCUPANCY", 0.25),
            serving_autoscale_queue_wait_s=_env_float(
                "SERVING_AUTOSCALE_QUEUE_WAIT_S", 0.5),
            serving_autoscale_min_replicas=_env_int(
                "SERVING_AUTOSCALE_MIN_REPLICAS", 1),
            serving_autoscale_max_replicas=_env_int(
                "SERVING_AUTOSCALE_MAX_REPLICAS", 4),
            serving_autoscale_sustain=_env_int(
                "SERVING_AUTOSCALE_SUSTAIN", 2),
            serving_autoscale_cooldown_s=_env_float(
                "SERVING_AUTOSCALE_COOLDOWN_S", 10.0),
            autotune=_env_bool("AUTOTUNE", False),
            autotune_bayes=_env_bool("AUTOTUNE_BAYES", False),
            autotune_log=_env("AUTOTUNE_LOG", "") or "",
            autotune_warmup_samples=_env_int("AUTOTUNE_WARMUP_SAMPLES", 3),
            autotune_steps_per_sample=_env_int(
                "AUTOTUNE_STEPS_PER_SAMPLE", 10),
            autotune_cache=_env("AUTOTUNE_CACHE", "") or "",
            autotune_mfu=_env_bool("AUTOTUNE_MFU", True),
            autotune_wire=_env_bool("AUTOTUNE_WIRE", False),
            timeline_filename=_env("TIMELINE", "") or "",
            timeline_mark_cycles=_env_bool("TIMELINE_MARK_CYCLES", False),
            metrics_enabled=_env_bool("METRICS", False),
            # canonical name first so it wins when both are set
            metrics_file=(os.environ.get("HOROVOD_TPU_METRICS_FILE", "")
                          or _env("METRICS_FILE") or ""),
            metrics_port=_env_int("METRICS_PORT", 0),
            metrics_push_interval_s=_env_float("METRICS_PUSH_INTERVAL_S",
                                               5.0),
            flight_recorder=_env_bool("FLIGHT_RECORDER", True),
            flight_dir=_env("FLIGHT_DIR", "") or "",
            flight_capacity=_env_int("FLIGHT_CAPACITY", 4096),
            prof_every=_env_int("PROF_EVERY", 0),
            prof_dir=_env("PROF_DIR", "") or "",
            prof_duty_cycle=_env_float("PROF_DUTY_CYCLE", 0.02),
            health_enabled=_env_bool("HEALTH", False),
            health_interval_s=_env_float("HEALTH_INTERVAL_S", 2.0),
            health_window=_env_int("HEALTH_WINDOW", 32),
            health_min_steps=_env_int("HEALTH_MIN_STEPS", 8),
            health_step_time_factor=_env_float(
                "HEALTH_STEP_TIME_FACTOR", 1.75),
            health_rules=_env("HEALTH_RULES", "") or "",
            health_incident_file=_env("HEALTH_INCIDENT_FILE", "") or "",
            health_capture=_env_bool("HEALTH_CAPTURE", True),
            # canonical name first so it wins when both are set
            fault_spec=(os.environ.get("HOROVOD_TPU_FAULT_SPEC", "")
                        or _env("FAULT_SPEC") or ""),
            retry_max_attempts=_env_int("RETRY_MAX_ATTEMPTS", 5),
            retry_base_delay_seconds=_env_float("RETRY_BASE_DELAY", 0.1),
            retry_max_delay_seconds=_env_float("RETRY_MAX_DELAY", 2.0),
            retry_jitter=_env("RETRY_JITTER", "full") or "full",
            retry_max_elapsed_seconds=_env_float("RETRY_MAX_ELAPSED", 60.0),
            log_level=_env("LOG_LEVEL", "WARNING") or "WARNING",
            log_hide_timestamp=_env_bool("LOG_HIDE_TIME", False),
            log_rank=_env_bool("LOG_RANK", False),
            mesh_spec=_env("MESH", "") or "",
        )
