"""Exception types of horovod_tpu_torch.

The JAX package's ``core/exceptions.py`` classes that the ported
surface raises or documents: a collective failure, use before
``init()``, a bad process set.
"""


class HorovodTpuError(Exception):
    """Base class for all horovod_tpu_torch errors."""


class HorovodInternalError(HorovodTpuError):
    """A collective operation failed (the process group reported an
    error, or a peer went away)."""


class NotInitializedError(HorovodTpuError):
    """An API requiring ``horovod_tpu_torch.init()`` was called before
    init."""

    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call "
            "horovod_tpu_torch.init() first.")


class ProcessSetError(HorovodTpuError):
    """Invalid process-set operation (unknown set, duplicate ranks)."""
