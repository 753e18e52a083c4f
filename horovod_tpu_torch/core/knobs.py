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

    # --- inference serving ---
    serving_queue_limit: int = 256
    serving_request_timeout_seconds: float = 30.0

    # --- autoregressive generation ---
    serving_kv_dtype: str = "fp32"
    serving_kv_block: int = 0
    serving_decode_buckets: str = "4x128"
    serving_prefill_buckets: str = ""
    serving_decode_max_new: int = 64
    serving_decode_stats_every: int = 50

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
            overlap_schedule=_env("OVERLAP_SCHEDULE", "") or "off",
            fsdp=_env_bool("FSDP", True),
            fsdp_prefetch=_env_int("FSDP_PREFETCH", 1),
            fsdp_regather=_env_bool("FSDP_REGATHER", True),
            fsdp_offload=_env_bool("FSDP_OFFLOAD", False),
            fsdp_offload_duty=_env_float("FSDP_OFFLOAD_DUTY", 1.0),
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
        )
