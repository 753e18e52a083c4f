"""Exception types of horovod_tpu_torch.

The JAX package's ``core/exceptions.py`` classes that the ported
surface raises or documents: a collective failure, the interrupt of a
changed host set, use before ``init()``, a bad process set.
"""


class HorovodTpuError(Exception):
    """Base class for all horovod_tpu_torch errors."""


class HorovodInternalError(HorovodTpuError):
    """A collective operation failed (the process group reported an
    error, or a peer went away). ``elastic.run`` catches it, restores
    the last commit and joins the world again."""


class HostsUpdatedInterrupt(HorovodTpuError):
    """Raised inside ``State.commit()``/``check_host_updates()`` when the
    elastic driver told this worker that the host set changed
    (``horovod_tpu/core/exceptions.py:24``; reference
    common/elastic.py:57-99)."""

    def __init__(self, skip_sync: bool = False):
        super().__init__("hosts updated")
        self.skip_sync = skip_sync


class NotInitializedError(HorovodTpuError):
    """An API requiring ``horovod_tpu_torch.init()`` was called before
    init."""

    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call "
            "horovod_tpu_torch.init() first.")


class ProcessSetError(HorovodTpuError):
    """Invalid process-set operation (unknown set, duplicate ranks)."""
