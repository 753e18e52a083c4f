"""Leveled, rank-prefixed logging.

The port of the JAX package's ``utils/logging.py`` (reference
horovod/common/logging.{cc,h}): levels TRACE/DEBUG/INFO/WARNING/ERROR/
FATAL from ``HOROVOD_LOG_LEVEL`` (the launcher's ``--log-level``),
``HOROVOD_LOG_HIDE_TIME``, and with ``HOROVOD_LOG_RANK=1`` (or the
``rank_prefix`` argument, which ``core/basics.init()`` passes) a
``[rank N]`` prefix on every line, the rank read from the launcher's
``HOROVOD_RANK`` env, so the prefix is right from the first line of a
spawned worker, before ``init()``. Interleaved stderr from a multi-rank
launch is then attributable by grep alone.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "trace": logging.DEBUG,  # python has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

LOGGER = logging.getLogger("horovod_tpu_torch")


def _env_rank() -> int:
    """The launcher-assigned rank, or -1 outside a launched worker."""
    for key in ("HVD_TPU_RANK", "HOROVOD_RANK"):
        v = os.environ.get(key)
        if v:
            try:
                return int(v)
            except ValueError:
                pass
    return -1


class _RankFilter(logging.Filter):
    """Stamps ``record.hvd_rank``: launcher env first (cheap, correct
    before ``init()``), the ``torch.distributed`` rank as the fallback
    for worlds started without the launcher. The resolved value is
    cached."""

    def __init__(self) -> None:
        super().__init__()
        self._rank = _env_rank()

    def filter(self, record: logging.LogRecord) -> bool:
        if self._rank < 0:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                self._rank = dist.get_rank()
        record.hvd_rank = self._rank
        return True


def _env_truthy(name: str) -> bool:
    v = (os.environ.get("HVD_TPU_" + name)
         or os.environ.get("HOROVOD_" + name) or "")
    return v.strip().lower() in ("1", "true", "yes", "on")


def configure_logging(level: str = "WARNING",
                      hide_timestamp: bool = False,
                      rank_prefix: bool = None) -> None:
    """(Re)configure the horovod_tpu_torch logger. ``rank_prefix`` (default:
    the HOROVOD_LOG_RANK env) switches to the ``[rank N]`` line format;
    re-calling updates the level and format of the existing handler."""
    if rank_prefix is None:
        rank_prefix = _env_truthy("LOG_RANK")
    LOGGER.setLevel(_LEVELS.get(level.strip().lower(), logging.WARNING))
    if not LOGGER.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.addFilter(_RankFilter())
        h._hvd_managed = True  # only OUR handler gets re-formatted
        LOGGER.addHandler(h)
        LOGGER.propagate = False
    if rank_prefix:
        fmt = "[rank %(hvd_rank)s] <%(levelname)s> %(message)s"
    else:
        fmt = "[%(hvd_rank)s]<%(levelname)s> %(message)s"
    if not hide_timestamp:
        fmt = "%(asctime)s " + fmt
    for h in LOGGER.handlers:
        # re-applying on re-init keeps rank_prefix/level switchable,
        # but user-attached handlers keep their own formatters
        if getattr(h, "_hvd_managed", False):
            h.setFormatter(logging.Formatter(fmt))


def get_logger() -> logging.Logger:
    return LOGGER
