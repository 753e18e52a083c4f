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
    # two-level (local x cross) allreduce; the port has no process sets
    # for it yet, so the int8 wire refuses it rather than running flat
    hierarchical_allreduce: bool = False

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
        )
