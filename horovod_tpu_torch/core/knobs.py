"""Environment-variable knobs read by the PyTorch serving path.

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
    """Typed snapshot of the knobs the serving path reads."""

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
