"""Elastic job settings (``horovod_tpu/runner/elastic/settings.py``;
reference runner/elastic/settings.py, constants.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ...core.knobs import _env_float

ELASTIC_TIMEOUT_SECS_DEFAULT = 600.0
DISCOVERY_INTERVAL_SECS = 1.0


@dataclasses.dataclass
class ElasticSettings:
    min_np: int
    max_np: Optional[int] = None
    timeout_s: float = ELASTIC_TIMEOUT_SECS_DEFAULT
    reset_limit: int = 0  # 0 = unlimited resets
    cooldown_range: Optional[Tuple[float, float]] = None
    discovery_interval_s: float = DISCOVERY_INTERVAL_SECS
    # seconds a round's host may be absent from discovery before its
    # hung worker is counted failed (the driver's vanish watchdog), and
    # the post-round spawn-thread join budget; None reads the
    # HOROVOD_ELASTIC_VANISH_GRACE / HOROVOD_ELASTIC_SPAWN_JOIN knobs
    # (defaults 5.0 / 30.0)
    host_vanish_grace_s: Optional[float] = None
    spawn_join_timeout_s: Optional[float] = None

    def __post_init__(self):
        if self.min_np < 1:
            raise ValueError("min_np must be >= 1")
        if self.max_np is not None and self.max_np < self.min_np:
            raise ValueError("max_np must be >= min_np")
        if self.host_vanish_grace_s is None:
            self.host_vanish_grace_s = _env_float("ELASTIC_VANISH_GRACE",
                                                  5.0)
        if self.spawn_join_timeout_s is None:
            self.spawn_join_timeout_s = _env_float("ELASTIC_SPAWN_JOIN",
                                                   30.0)
        if self.host_vanish_grace_s <= 0:
            raise ValueError("host_vanish_grace_s must be > 0")
        if self.spawn_join_timeout_s <= 0:
            raise ValueError("spawn_join_timeout_s must be > 0")
