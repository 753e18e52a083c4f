"""init / shutdown / topology queries.

The counterpart of the JAX package's ``core/basics.py``. The world is
processes, one card each, as in the reference Horovod: ``init()`` reads
the slot environment the launcher exports (``horovod_tpu_torch.runner``'s,
the same as the JAX package's:
``HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE/CROSS_RANK/CROSS_SIZE`` and
``HVD_TPU_COORDINATOR_ADDRESS``; ``HVD_TPU_X`` beats ``HOROVOD_X``) and
sets up a ``torch.distributed`` process group over it (rank 0 hosts the
TCP store at ``HVD_TPU_COORDINATOR_ADDRESS``; each world formed on it
gets a prefix of its own, see ``_world_store``): NCCL on the card
(``torch.cuda.set_device(local_rank)``), or gloo when the caller passes
``device="cpu"``. Without that environment the world is one process;
its process group lives in an in-process store, so the collectives
still run through the backend. Without a card and without
``device="cpu"``, ``init()`` raises, and so it does when the local rank
has no card of its own (more slots on a host than cards). It also sets
up logging, fault injection and the control-plane retry policy from the
knobs, the host timeline, metrics and the flight recorder
(``utils/timeline.py``, ``metrics.py``, ``flight.py``), and, with
``HOROVOD_REPLICATION``, the peer replication of elastic commits.

A process group the caller set up before ``init()`` is adopted as it
is (its rank and size win over the environment) and left alone at
``shutdown()``.

``init(process_sets=[...])`` registers those process sets, in order,
once the world is up, as ``add_process_set`` would (collective: every
rank passes the same list). Then it builds the device mesh
``HOROVOD_MESH`` names (``"dp=2,tp=2"``; unset: one ``dp`` axis over
the world), registering a process set for each slice of each live axis
(collective too); ``mesh()`` returns it.

With ``HVD_TPU_NATIVE=1`` (``Knobs.native_eager``) ``init()`` also
starts the eager negotiation runtime (``ops/eager_runtime.py``): the
C++ controller, whose rank 0 binds ``HVD_TPU_NATIVE_COORDINATOR_PORT``
at ``HVD_TPU_NATIVE_COORDINATOR_ADDR`` (the launcher publishes both),
and a ``DistExecutor`` on a process group of its own, created
collectively here. ``shutdown()`` stops it first.
"""

from __future__ import annotations

import atexit
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .exceptions import NotInitializedError
from .knobs import Knobs, _env, _env_int
from . import process_sets as _ps
from .state import global_state


def init(device: Optional[str] = None,
         process_sets: Optional[Sequence] = None) -> None:
    """Initialize horovod_tpu_torch (a no-op when already initialized).

    ``device``: None runs on the card of this process's local rank over
    NCCL; ``"cpu"`` runs on the CPU over gloo (tests, drive scripts).
    ``process_sets``: ``ProcessSet`` objects (or rank lists) to register
    after the world is up (reference common/basics.py:48-100)."""
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
            dist.init_process_group(backend, store=_world_store(addr, rank),
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
        st.process_set_table = _ps.ProcessSetTable(size)
        _configure_telemetry(st)
        st.initialized = True
    if st.knobs.native_eager:
        try:
            _start_native_eager(st)
        except BaseException:
            # no world without the runtime it was asked for
            shutdown()
            raise
    for ps in process_sets or ():
        _ps.add_process_set(ps)
    from ..parallel.mesh import mesh_from_spec

    try:
        # collectives: every rank gathers the local sizes and registers
        # the mesh's axis groups
        st.homogeneous = _homogeneous(st)
        st.mesh = mesh_from_spec(st.knobs.mesh_spec, st.size,
                                 st.rank).bind()
    except BaseException:
        shutdown()
        raise
    if st.knobs.replication_enabled:
        # peer replication of elastic commits (elastic/replication.py)
        from ..elastic import replication

        replication.configure(st.knobs)


def _homogeneous(st) -> bool:
    """Whether every host runs as many ranks as this one: a world of one
    rank is; any other world all-gathers the ranks' local sizes
    (collective: every rank's ``init()`` runs it). Only the world's size,
    which every rank agrees on, decides whether to gather: the
    launcher's ``cross_size`` counts the hosts with a slot at this
    rank's local rank, so it differs between ranks of uneven hosts."""
    if st.size == 1:
        return True
    mine = torch.tensor([st.local_size], dtype=torch.int64, device=st.device)
    every = [torch.empty_like(mine) for _ in range(st.size)]
    dist.all_gather(every, mine)
    return len({int(t) for t in every}) == 1


def _start_native_eager(st) -> None:
    """Start the background negotiation runtime and its data plane (the
    reference's InitializeHorovodOnce spawning BackgroundThreadLoop,
    operations.cc:827, 401; ``horovod_tpu/core/basics.py:315-346``).
    Where the JAX package gives a world of one the loopback executor,
    the port's world always has a process group, so every world gets a
    ``DistExecutor`` on a group of its own (ROADMAP queue C)."""
    import os

    from ..ops.eager_runtime import EagerRuntime, make_dist_executor

    addr = os.environ.get("HVD_TPU_NATIVE_COORDINATOR_ADDR", "127.0.0.1")
    port = int(os.environ.get("HVD_TPU_NATIVE_COORDINATOR_PORT", "0") or 0)
    if st.size > 1 and port == 0:
        raise RuntimeError(
            "HVD_TPU_NATIVE=1 with several processes needs the launcher "
            "to publish HVD_TPU_NATIVE_COORDINATOR_ADDR/PORT (hvdrun "
            "does; see runner/exec_run.py slot_env)")
    k = st.knobs
    st.eager_runtime = EagerRuntime(
        rank=st.rank,
        size=st.size,
        coordinator_addr=addr,
        coordinator_port=port,
        executor=make_dist_executor(),
        cycle_ms=k.cycle_time_ms,
        fusion_threshold=k.fusion_threshold_bytes,
        cache_capacity=k.cache_capacity if k.cache_enabled else 0,
        # the inspector is off at 0 (stall_inspector.h enabled())
        stall_warning_s=(k.stall_warning_time_seconds
                         if k.stall_check_enabled else 0.0),
        stall_shutdown_s=k.stall_shutdown_time_seconds,
        stall_abort_s=k.stall_abort_time_seconds,
        fast_path=k.eager_fast_path,
        fast_path_warmup=k.eager_fast_path_warmup,
        device=st.device,
    )
    from ..optim.compression import resolve_wire
    from ..utils.logging import get_logger

    wire = resolve_wire(k)
    get_logger().info(
        "eager runtime: rank %d of %d, coordinator %s:%d, cycle %s ms, "
        "cache %d, stall abort %s s, wire %s", st.rank, st.size, addr,
        port, k.cycle_time_ms, k.cache_capacity if k.cache_enabled else 0,
        k.stall_abort_time_seconds, wire.describe() if wire else "none")


#: coordinator address -> [its TCP store, the worlds formed on it]
_STORES: dict = {}


def _world_store(addr: str, rank: int):
    """The store a world forms on: rank 0's TCP store at ``addr``, kept
    for the life of the process, under a prefix of its own for each
    world formed on it. An elastic re-init (``shutdown()`` then
    ``init()`` on every rank) forms its new world under the next prefix
    of the same store, so a rank that re-joins before rank 0 has torn
    its world down can never register in a store about to close. The
    ranks count their worlds alike: each forms the same ones."""
    from torch.distributed.constants import default_pg_timeout

    entry = _STORES.get(addr)
    if entry is None:
        host, port = addr.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), is_master=rank == 0,
                              timeout=default_pg_timeout,
                              wait_for_workers=False)
        entry = _STORES[addr] = [store, 0]
    entry[1] += 1
    return dist.PrefixStore(f"hvd_world_{entry[1]}", entry[0])


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


def _configure_telemetry(st) -> None:
    """The host timeline (``HOROVOD_TIMELINE``), metrics
    (``HOROVOD_METRICS``, ``HOROVOD_TPU_METRICS_FILE``), the flight
    recorder (on unless ``HOROVOD_FLIGHT_RECORDER=0``), the sampled
    profiler (``HOROVOD_PROF_EVERY``) and the health monitor
    (``HOROVOD_HEALTH``), in the JAX package's order
    (``horovod_tpu/core/basics.py:212-251``), before the eager runtime
    starts: the profiler after flight, whose rank and sink its sidecar
    reads, health last, since it installs metrics observers and
    captures through flight and the profiler. The recorder takes the
    world's rank first: the timeline's anchor names it (the JAX package
    reads the rank from the launcher's environment, after its timeline
    has started), and so does the health monitor's summary."""
    from .. import health
    from ..utils import flight, metrics, prof
    from ..utils.timeline import Timeline

    flight.set_rank(st.rank)
    st.timeline = Timeline(st.knobs.timeline_filename or None,
                           mark_cycles=st.knobs.timeline_mark_cycles)
    metrics.configure(st.knobs)
    flight.configure(st.knobs)
    prof.configure(st.knobs)
    health.configure(st.knobs, rank=st.rank)


def shutdown() -> None:
    """Tear down the state; end the process group if init() made it.
    The world's DistributedOptimizers are detached and the replicator
    stops, so an elastic re-init keeps nothing of the old world."""
    import sys

    for name, fn in (("optim.distributed", "detach_all"),
                     ("elastic.replication", "on_shutdown")):
        mod = sys.modules.get(f"horovod_tpu_torch.{name}")
        if mod is not None:
            getattr(mod, fn)()
    st = global_state()
    with st.lock:
        if st.eager_runtime is not None:
            st.eager_runtime.shutdown()
            st.eager_runtime = None
        if st.timeline is not None:
            st.timeline.close()
        from .. import health
        from ..utils import flight, metrics, prof

        health.on_shutdown()  # before metrics: removes its observers
        prof.on_shutdown()  # before metrics: joins a parse in flight
        metrics.on_shutdown()
        flight.on_shutdown()
        if st.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        elif dist.is_initialized():
            _ps.destroy_groups()
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


def mesh():
    """The device mesh (``parallel/mesh.Mesh``) ``HOROVOD_MESH`` names
    over the world, bound to it; without the knob one ``dp`` axis over
    every rank."""
    return _require_init().mesh


def device() -> torch.device:
    """The device this process's collectives and kernels run on."""
    return _require_init().device


def dp_axis_names() -> tuple:
    """The names of :func:`mesh`'s axes, every one of which the JAX
    package's default mesh treats as data-parallel (``("dp",)`` without
    ``HOROVOD_MESH``)."""
    return tuple(_require_init().mesh.axis_names)


def is_homogeneous() -> bool:
    """Whether every host runs the same number of ranks (reference:
    ``horovod_is_homogeneous``, operations.cc:1135); read at
    ``init()`` by an all-gather of the ranks' local sizes."""
    return _require_init().homogeneous


# The reference's in-graph queries (tensorflow/mpi_ops.py size_op,
# rank_op, ...): int32 scalars on the world's device, for steps that
# mask or index with the topology without a host round trip.
def _int32(value: int) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32,
                        device=_require_init().device)


def size_op(process_set_id: int = 0) -> torch.Tensor:
    """The world's size, or the process set's with its id."""
    if process_set_id != 0:
        return _int32(_ps.get_process_set_by_id(process_set_id).size())
    return _int32(size())


def rank_op(process_set_id: int = 0) -> torch.Tensor:
    """This rank, or its rank within the process set (-1 outside it:
    mask with :func:`process_set_included_op`)."""
    if process_set_id != 0:
        ps = _ps.get_process_set_by_id(process_set_id)
        return _int32(ps.rank(rank()) if ps.included(rank()) else -1)
    return _int32(rank())


def local_size_op() -> torch.Tensor:
    return _int32(local_size())


def local_rank_op() -> torch.Tensor:
    return _int32(local_rank())


def process_set_included_op(process_set_id: int = 0) -> torch.Tensor:
    """1 if this rank belongs to the process set, else 0 (reference
    tensorflow/mpi_ops.py:571)."""
    ps = _ps.get_process_set_by_id(process_set_id)
    return _int32(1 if ps.included(rank()) else 0)


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
