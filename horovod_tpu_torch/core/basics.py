"""init / shutdown / topology queries.

The counterpart of the JAX package's ``core/basics.py``. The world is
processes, one card each, as in the reference Horovod: ``init()`` reads
the slot environment the launcher exports (``horovod_tpu_torch.runner``'s,
the same as the JAX package's:
``HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE/CROSS_RANK/CROSS_SIZE`` and
``HVD_TPU_COORDINATOR_ADDRESS``; ``HVD_TPU_X`` beats ``HOROVOD_X``) and
sets up a ``torch.distributed`` process group over it: NCCL on the card
(``torch.cuda.set_device(local_rank)``), or gloo when the caller passes
``device="cpu"``. Without that environment the world is one process;
its process group lives in an in-process store, so the collectives
still run through the backend. Without a card and without
``device="cpu"``, ``init()`` raises, and so it does when the local rank
has no card of its own (more slots on a host than cards). It also sets
up logging, fault injection and the control-plane retry policy from the
knobs.

A process group the caller set up before ``init()`` is adopted as it
is (its rank and size win over the environment) and left alone at
``shutdown()``.
"""

from __future__ import annotations

import atexit
from typing import Optional

import torch
import torch.distributed as dist

from .exceptions import NotInitializedError
from .knobs import Knobs, _env, _env_int
from .process_sets import ProcessSet
from .state import global_state


def init(device: Optional[str] = None) -> None:
    """Initialize horovod_tpu_torch (a no-op when already initialized).

    ``device``: None runs on the card of this process's local rank over
    NCCL; ``"cpu"`` runs on the CPU over gloo (tests, drive scripts)."""
    st = global_state()
    with st.lock:
        if st.initialized:
            return
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError(f"init(device={device!r}): pass None (the "
                             "card) or 'cpu'")
        on_cpu = device is not None
        if not on_cpu and not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch.init(): no CUDA device is visible; the "
                "port runs on the card unless init(device='cpu') asks for "
                "the CPU")

        size = _env_int("SIZE", 1)
        rank = _env_int("RANK", 0)
        local_rank = _env_int("LOCAL_RANK", rank)
        local_size = _env_int("LOCAL_SIZE", size)
        cross_rank = _env_int("CROSS_RANK", 0)
        cross_size = _env_int("CROSS_SIZE", 1)
        backend = "gloo" if on_cpu else "nccl"
        if on_cpu:
            dev = torch.device("cpu")
        else:
            _check_card(local_rank)
            torch.cuda.set_device(local_rank)
            dev = torch.device("cuda", local_rank)

        owns = False
        if dist.is_initialized():
            rank, size = dist.get_rank(), dist.get_world_size()
            backend = dist.get_backend()
        elif size > 1:
            addr = _env("COORDINATOR_ADDRESS")
            if not addr:
                raise RuntimeError(
                    f"a world of {size} ranks needs the coordinator "
                    "address (HVD_TPU_COORDINATOR_ADDRESS=host:port), as "
                    "the launcher exports it")
            dist.init_process_group(backend, init_method=f"tcp://{addr}",
                                    world_size=size, rank=rank)
            owns = True
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0)
            owns = True

        st.knobs = Knobs.from_env()
        _configure_control_plane(st.knobs)
        st.device, st.backend, st.owns_group = dev, backend, owns
        st.rank, st.size = rank, size
        st.local_rank, st.local_size = local_rank, local_size
        st.cross_rank, st.cross_size = cross_rank, cross_size
        st.global_set = ProcessSet(range(size))
        st.global_set.process_set_id = 0
        st.initialized = True


def _check_card(local_rank: int) -> None:
    """Local rank r runs on card r: a host given more slots than it has
    cards must fail here, naming why, and never fall back to the CPU."""
    import os

    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(
            f"horovod_tpu_torch.init(): local rank {local_rank} needs card "
            f"cuda:{local_rank}, but {count} card(s) are visible "
            f"(CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES', '<unset>')}); give "
            "this host at most as many slots as it has cards")


def _configure_control_plane(knobs: Knobs) -> None:
    """Logging, fault injection and the control-plane retry policy from
    the knob snapshot, as the JAX package's ``init()`` sets them up."""
    from ..utils import faults, retry
    from ..utils.logging import configure_logging

    configure_logging(knobs.log_level, knobs.log_hide_timestamp,
                      rank_prefix=knobs.log_rank)
    # faults armed itself from the env at import (a launched worker
    # needs that); an explicitly knobbed spec re-compiles here so the
    # HVD_TPU_ precedence matches every other knob
    if knobs.fault_spec:
        faults.configure(knobs.fault_spec)
    retry.configure(knobs)


def shutdown() -> None:
    """Tear down the state; end the process group if init() made it."""
    st = global_state()
    with st.lock:
        if st.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        st.reset()


atexit.register(shutdown)


def is_initialized() -> bool:
    return global_state().initialized


def _require_init():
    st = global_state()
    if not st.initialized:
        raise NotInitializedError()
    return st


def size() -> int:
    return _require_init().size


def rank() -> int:
    return _require_init().rank


def local_size() -> int:
    return _require_init().local_size


def local_rank() -> int:
    return _require_init().local_rank


def cross_size() -> int:
    return _require_init().cross_size


def cross_rank() -> int:
    return _require_init().cross_rank


def device() -> torch.device:
    """The device this process's collectives and kernels run on."""
    return _require_init().device


# Build and run-time capability queries, answered for this process: the
# data plane is torch.distributed, NCCL on the card and gloo on the CPU.
def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False


def gloo_built() -> bool:
    return dist.is_available() and dist.is_gloo_available()


def gloo_enabled() -> bool:
    return global_state().backend == "gloo"


def nccl_built() -> bool:
    return dist.is_available() and dist.is_nccl_available()


def nccl_enabled() -> bool:
    return global_state().backend == "nccl"


def cuda_built() -> bool:
    return torch.version.cuda is not None


def cuda_enabled() -> bool:
    st = global_state()
    return st.device is not None and st.device.type == "cuda"


def rocm_built() -> bool:
    return getattr(torch.version, "hip", None) is not None


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def xla_built() -> bool:
    return False


def xla_enabled() -> bool:
    return False
