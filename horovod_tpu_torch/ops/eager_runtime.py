"""Eager multi-controller runtime: negotiation-ordered collective execution.

The port of the JAX package's ``ops/eager_runtime.py`` (the
background-loop architecture of the reference Horovod,
operations.cc:401: BackgroundThreadLoop -> ComputeResponseList ->
PerformOperation, seen from Python). The native control plane
(``horovod_tpu_torch/_native``: the TCP controller, the response cache,
fusion planning, the stall inspector) decides *which tensors are
globally ready, in what fused order*; this module owns the data plane:
it pulls execution batches and runs them.

The data plane is a pluggable executor:

* :class:`LoopbackExecutor`: single-process worlds and tests. It applies
  the collective semantics locally (sum x n for the allreduce of a
  replicated input, and so on), so the whole enqueue -> negotiate ->
  fuse -> execute -> complete pipeline runs without a second process.
  Its int8 wire goes through ``optim/compression.quantize_dequantize``.
* :class:`DistExecutor`: worlds of processes, in place of the JAX
  package's ``XlaExecutor``. It runs each batch as ``torch.distributed``
  collectives (NCCL on the card, gloo on the CPU) on a process group of
  its own, so its calls, made from the runtime's execute thread, never
  interleave on one communicator with the direct calls of the
  DistributedOptimizer's hooks, ZeRO or FSDP. Every process runs the
  same batches in the same order (the controller fixes it), which is
  the consistency a collective needs. A fused allreduce or
  reducescatter batch is packed into one flat buffer and moved by one
  collective; the int8 wire runs the hand-written kernels of
  ``ops/quantized_collectives.py`` (B12 or B11, all-to-all, B13, B11,
  all-gather, B14) with an error-feedback residual per fused bucket.
  A process set's batch runs on a group the executor made for that set
  when it was registered.

Tensors stay on their device from enqueue to result. On the card the
execute thread runs the executor on a CUDA stream of the runtime's own:
``enqueue`` records a ready event on the caller's current stream, which
that stream waits on before it reads (the reference Horovod's ready
event); the batch records a completion event, and ``synchronize`` makes
the caller's current stream wait on it and records the outputs on that
stream for the caching allocator.

The stall watchdog (``stall_abort_s``) raises ``HorovodInternalError``
("stalled") in the waiting thread when a collective makes no observable
progress. A collective on the card cannot be cancelled, so the abort
also aborts the executor's group and leaves the runtime able to shut
down without joining a thread stuck in the data plane.

Telemetry, as in the JAX package: each enqueue and negotiated response
lands in the flight recorder (the unit the cross-rank straggler report
counts), each tensor's negotiation and execution in the timeline
(``NEGOTIATE_<OP>`` and ``<OP>`` spans, a cycle mark a negotiation
cycle, instants where a plan activates or is dropped), each tensor's
enqueue-to-negotiated wait in ``hvd_negotiation_seconds``, each executed
batch, negotiated or replayed, in ``hvd_batch_execution_seconds`` and
the fused-tensor counters, each allreduce batch's logical and sent bytes
in ``hvd_wire_*``, and the controller's and the plan cache's cumulative
counters (``metrics_snapshot``) in gauges refreshed at every scrape. No
metrics record is made while the runtime's lock is held: a scrape takes
that lock through ``metrics_snapshot``.

Left for a later entry: autotune (``autotune=True`` raises; ROADMAP
queue A entry 12). Adasum is reduced by ``ops/adasum.py`` outside the
runtime; the executor refuses it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.exceptions import HorovodInternalError
from ..utils import faults as _faults
from ..utils import flight as _flight
from ..utils import metrics as _metrics
from .collectives import (ReduceOp, _all_gather_tiled,
                          _reduce_scatter_tiled, average_, dist_op, scale_)
from .._native import (
    BATCHED,
    DONE,
    FAILED,
    OP_ALLGATHER,
    OP_ALLREDUCE,
    OP_ALLTOALL,
    OP_BARRIER,
    OP_BROADCAST,
    OP_JOIN,
    OP_REDUCESCATTER,
    ExecutionBatch,
    NativeRuntime,
    torch_dtype,
)

_REDUCE_AVERAGE = 0
_REDUCE_SUM = 1
_REDUCE_ADASUM = 2
_REDUCE_MIN = 3
_REDUCE_MAX = 4
_REDUCE_PRODUCT = 5

# op id -> (negotiation activity, execution activity): the reference's
# per-tensor phase names (common.h:79-113, timeline.cc)
_OP_ACTIVITIES = {
    OP_ALLREDUCE: ("NEGOTIATE_ALLREDUCE", "ALLREDUCE"),
    OP_ALLGATHER: ("NEGOTIATE_ALLGATHER", "ALLGATHER"),
    OP_BROADCAST: ("NEGOTIATE_BROADCAST", "BROADCAST"),
    OP_ALLTOALL: ("NEGOTIATE_ALLTOALL", "ALLTOALL"),
    OP_REDUCESCATTER: ("NEGOTIATE_REDUCESCATTER", "REDUCESCATTER"),
}

# op id -> metric label
_OP_METRIC_NAMES = {
    OP_ALLREDUCE: "allreduce",
    OP_ALLGATHER: "allgather",
    OP_BROADCAST: "broadcast",
    OP_ALLTOALL: "alltoall",
    OP_REDUCESCATTER: "reducescatter",
}

# ops a frozen ExecutionPlan may replay without renegotiating: every
# field the executor needs (shapes, splits matrix, per-member dims,
# process-set membership) was captured from the negotiated batch and is
# invariant while the enqueue signatures stay invariant
_PLAN_OPS = frozenset(_OP_METRIC_NAMES)

#: the int8 wire's error-feedback residuals each executor keeps, at most
LOOPBACK_RESIDUALS = 4096
DIST_RESIDUALS = 256


class _PlanEntry:
    """One tensor slot of a frozen plan: the enqueue signature that must
    repeat for the slot to stay valid, plus the raw enqueue kwargs needed
    to replay the tensor through full negotiation on plan invalidation."""

    __slots__ = ("sig", "kwargs")

    def __init__(self, sig: tuple, kwargs: dict):
        self.sig = sig
        self.kwargs = kwargs


class ExecutionPlan:
    """A frozen steady-state step: the fusion buckets and controller
    ordering one negotiation round produced, replayable without the
    coordinator.

    Once K identical enqueue sequences have negotiated identically, the
    plan (the fusion buckets in the controller's order) is cached and
    the round trip skipped. The batches were captured from negotiated
    responses, so they are identical on every rank even when ranks
    enqueued in different orders; replaying them in plan order keeps
    the ranks' collectives in one order.

    ``wire_key`` is the compressed wire the executor held at freeze time
    (``WireSpec.key``, None uncompressed): ``set_wire()`` flushes any
    plan frozen under another wire, so a fast-path step is bitwise a
    negotiated step under the same wire."""

    def __init__(self, batches: List[ExecutionBatch],
                 entries: Dict[str, _PlanEntry], wire_key=None):
        self.batches = batches
        self.entries = entries
        self.names = frozenset(entries)
        self.total_bytes = sum(int(b.total_bytes) for b in batches)
        self.wire_key = wire_key


def _timeline():
    """The active host-side timeline, or None (utils/timeline.py)."""
    from ..utils.timeline import active_timeline

    return active_timeline()


_RESIDUAL_EVICTION_WARNED = [False]


def _warn_residual_eviction_once() -> None:
    """The executor's bounded error-feedback store cycled an entry out:
    the evicted bucket restarts from a zero residual."""
    if _RESIDUAL_EVICTION_WARNED[0]:
        return
    _RESIDUAL_EVICTION_WARNED[0] = True
    from ..utils.logging import get_logger

    get_logger().warning(
        "int8 error-feedback residual store exceeded its bound; "
        "evicted buckets restart error feedback from zero (the wire "
        "degrades toward int8-raw for them). This indicates bucket "
        "churn: more distinct fused buckets than the store holds.")


def _resolve_executor_wire(wire):
    """"auto" resolves the HOROVOD_COMPRESSION knob (the environment
    before init); a string parses; a WireSpec or None passes through."""
    from ..optim import compression as _comp

    if wire == "auto":
        return _comp.resolve_wire()
    if isinstance(wire, str):
        return _comp.parse_wire(wire)
    return wire


def batch_dtype(batch: ExecutionBatch) -> torch.dtype:
    """The ``torch.dtype`` of a batch's payload: native batches carry
    the controller's code, batches built in Python the dtype's name."""
    return torch_dtype(batch.dtype)


def _wire_applies(spec, batch: ExecutionBatch) -> bool:
    """The compressed wire covers floating SUM/AVERAGE allreduce
    payloads; everything else moves at logical precision."""
    if spec is None or batch.op != OP_ALLREDUCE:
        return False
    if batch.reduce_op not in (_REDUCE_SUM, _REDUCE_AVERAGE):
        return False
    return batch_dtype(batch).is_floating_point


def _record_wire_batch(spec, batch: ExecutionBatch, n_elements: int
                       ) -> None:
    """``hvd_wire_bytes_{logical,sent}_total`` of one executed allreduce
    batch: ``sent`` equals ``logical`` on the uncompressed wire."""
    if not _metrics.enabled() or batch.op != OP_ALLREDUCE:
        return
    from ..optim.compression import wire_sent_bytes

    itemsize = batch_dtype(batch).itemsize
    _metrics.record_wire_bytes(
        n_elements * itemsize,
        wire_sent_bytes(n_elements, itemsize,
                        spec if _wire_applies(spec, batch) else None))


class LoopbackExecutor:
    """Executes batches with single-process semantics (every rank's
    contribution equals ours).

    ``wire`` ("auto" = the HOROVOD_COMPRESSION knob) simulates the
    compressed data plane: cast wires accumulate in the cast dtype; the
    int8 wire applies both quantization stages (the contribution and the
    reduced shard) with error-feedback residuals keyed by tensor name."""

    def __init__(self, world_size: int, rank: int = 0, wire="auto"):
        self._n = world_size
        self._rank = rank
        self.wire = _resolve_executor_wire(wire)
        self._residuals: Dict[str, torch.Tensor] = {}

    def set_wire(self, wire) -> None:
        self.wire = _resolve_executor_wire(wire)
        self._residuals = {}

    def _wire_allreduce(self, batch: ExecutionBatch, name: str, x):
        """Wire-compressed SUM/AVERAGE of n identical contributions."""
        from ..optim import compression as _comp

        spec = self.wire
        n = self._set_world(batch)[0]
        scaled = x.to(torch.float32) * batch.prescale
        if spec.kind == "int8":
            eff = scaled
            if spec.error_feedback:
                res = self._residuals.get(name)
                if res is not None and res.shape == eff.shape:
                    eff = eff + res
            dq1 = _comp.quantize_dequantize(eff, spec.block)
            if spec.error_feedback:
                self._residuals.pop(name, None)
                self._residuals[name] = eff - dq1
                while len(self._residuals) > LOOPBACK_RESIDUALS:
                    # bounded: churn in tensor names must not pin
                    # residuals forever
                    self._residuals.pop(next(iter(self._residuals)))
                    _warn_residual_eviction_once()
            r = _comp.quantize_dequantize(dq1 * n, spec.block)
        else:
            w = scaled.to(spec.wire_dtype)
            r = (w * n).to(torch.float32)
        if batch.reduce_op == _REDUCE_AVERAGE:
            r = r / n
        return (r * batch.postscale).to(x.dtype)

    def _set_world(self, batch: ExecutionBatch):
        """(size, local_rank) of the batch's process set: the set's
        member count and this rank's position in it; the global world
        when the batch is unscoped."""
        if batch.set_ranks:
            return len(batch.set_ranks), batch.set_ranks.index(self._rank)
        return self._n, self._rank

    def __call__(self, batch: ExecutionBatch,
                 tensors: Dict[str, torch.Tensor]) -> Dict[str, object]:
        n, rank = self._set_world(batch)
        wired = _wire_applies(self.wire, batch)
        if batch.op == OP_ALLREDUCE:
            _record_wire_batch(self.wire, batch, sum(
                tensors[nm].numel() for nm in batch.names if nm in tensors))
        out = {}
        for name in batch.names:
            if name not in tensors:
                continue
            x = tensors[name]
            if batch.op == OP_ALLREDUCE and wired:
                out[name] = self._wire_allreduce(batch, name, x)
            elif batch.op == OP_ALLREDUCE:
                scaled = scale_(x.clone(), batch.prescale)
                # n identical contributions: sum = x*n, min/max/adasum = x,
                # product = x**n
                if batch.reduce_op == _REDUCE_PRODUCT:
                    r = scaled ** n
                elif batch.reduce_op in (
                    _REDUCE_ADASUM, _REDUCE_MIN, _REDUCE_MAX
                ):
                    r = scaled
                else:
                    r = scaled * n
                    if batch.reduce_op == _REDUCE_AVERAGE:
                        r = average_(r, n)
                out[name] = scale_(r, batch.postscale)
            elif batch.op == OP_ALLGATHER:
                dims = batch.rank_dim0
                if dims and len(set(dims)) > 1:
                    # truly ragged peers cannot be simulated from our
                    # buffer alone: a fabricated result would have the
                    # negotiated total rows but garbage content
                    raise HorovodInternalError(
                        f"loopback executor cannot materialize ragged "
                        f"allgather '{name}' (negotiated dims {dims}); "
                        f"use the torch.distributed executor "
                        f"(make_dist_executor)"
                    )
                out[name] = torch.cat([x] * n, dim=0)
            elif batch.op == OP_BROADCAST:
                out[name] = x.clone()
            elif batch.op == OP_REDUCESCATTER:
                chunk = x.shape[0] // n
                r = scale_(x[:chunk].clone(), batch.prescale) * n
                if batch.reduce_op == _REDUCE_AVERAGE:
                    r = average_(r, n)
                out[name] = scale_(r, batch.postscale)
            elif batch.op == OP_ALLTOALL:
                # identical inputs: each peer sends us the chunk destined
                # to our rank; with the negotiated splits matrix the recv
                # layout is column `rank` (reference operations.cc:1858)
                m = torch.tensor(batch.all_splits,
                                 dtype=torch.int64).reshape(n, n)
                pieces, recv_splits = [], []
                for j in range(n):
                    # peer j's buffer == ours; its chunk to us starts at
                    # the sum of ITS splits before us (row j's prefix)
                    start = int(m[j, :rank].sum())
                    pieces.append(x[start:start + int(m[j, rank])])
                    recv_splits.append(int(m[j, rank]))
                out[name] = (torch.cat(pieces, dim=0),
                             torch.tensor(recv_splits, dtype=torch.int64))
            else:
                raise HorovodInternalError(
                    f"executor received unknown op {batch.op} for tensor "
                    f"'{name}'; refusing to pass input through unchanged"
                )
        return out


def _wait_ready(stream, events) -> None:
    """Make ``stream`` wait on the producers' ready events before it
    reads their tensors."""
    for ev in events:
        stream.wait_event(ev)


def _deliver(value, done):
    """A result handed to the caller: on the card, the caller's current
    stream waits on the batch's completion event, and the outputs are
    recorded on that stream so the caching allocator does not reuse
    their memory before the caller's work on them."""
    if done is None:
        return value
    outs = [t for t in (value if isinstance(value, tuple) else (value,))
            if isinstance(t, torch.Tensor) and t.is_cuda]
    if outs:
        stream = torch.cuda.current_stream(outs[0].device)
        stream.wait_event(done)
        for t in outs:
            t.record_stream(stream)
    return value


class EagerRuntime:
    """Per-process facade: enqueue named tensors, a worker thread executes
    negotiated batches in controller order, ``synchronize`` returns the
    results."""

    def __init__(
        self,
        rank: int,
        size: int,
        coordinator_addr: str = "127.0.0.1",
        coordinator_port: int = 0,
        executor: Optional[Callable] = None,
        cycle_ms: float = 1.0,
        fusion_threshold: int = 128 << 20,
        cache_capacity: int = 1024,
        stall_warning_s: float = 60.0,
        stall_shutdown_s: float = 0.0,
        stall_abort_s: float = 0.0,
        autotune: bool = False,
        fast_path: bool = True,
        fast_path_warmup: int = 3,
        pipeline_depth: int = 2,
        wire="auto",
        device=None,
    ):
        if autotune:
            raise NotImplementedError(
                "EagerRuntime(autotune=True): autotune is not in "
                "horovod_tpu_torch yet (ROADMAP queue A entry 12)")
        self._rank, self._size = int(rank), int(size)
        self._native = NativeRuntime()
        self._native.init(
            rank, size, coordinator_addr, coordinator_port,
            cycle_ms=cycle_ms, fusion_threshold=fusion_threshold,
            cache_capacity=cache_capacity, stall_warning_s=stall_warning_s,
            stall_shutdown_s=stall_shutdown_s,
        )
        self._executor = executor or LoopbackExecutor(size, rank,
                                                      wire=wire)
        #: the port rank 0's controller binds in a world of more than one
        self.coordinator_port = int(coordinator_port)
        #: the device the execute thread runs on (None: the CPU)
        self._device = torch.device(device) if device is not None else None
        self._streams: Dict[torch.device, object] = {}
        # negotiation watchdog (HOROVOD_STALL_ABORT_S): a collective
        # wait with no observable progress for this long aborts with
        # HorovodInternalError instead of hanging; elastic run()'s
        # restore-and-retry needs a raise to catch. 0 = off.
        self._stall_abort_s = float(stall_abort_s)
        self._aborted = False
        self._lock = threading.Lock()
        self._inputs: Dict[str, torch.Tensor] = {}
        #: ready events of the inputs on the card, by name
        self._ready: Dict[str, object] = {}
        #: handle -> (result, completion event or None)
        self._results: Dict[int, tuple] = {}
        self._handle_name: Dict[int, str] = {}
        self._handle_op: Dict[int, int] = {}
        #: enqueue times of negotiated handles, stamped only while
        #: metrics are on (the negotiation-latency histogram)
        self._handle_ts: Dict[int, float] = {}
        self._last_cycle = -1
        self._last_exec_error = ""
        self._exec_seconds = 0.0
        self._exec_batches = 0
        self._shutdown = threading.Event()
        # ---- steady-state plan cache (HOROVOD_EAGER_FAST_PATH) ----
        # All _fp_* state is guarded by self._lock; _fp_cond shares the
        # lock so fast-path waiters and the dispatching thread hand off
        # without a second mutex.
        self._fp_cond = threading.Condition(self._lock)
        self._fp_on = bool(fast_path)
        self._fp_warmup = max(1, int(fast_path_warmup))
        self._fp_plan: Optional[ExecutionPlan] = None
        # native data-op handles issued but not yet synchronize()d. The
        # capture/freeze gates key on THIS (not on worker-thread handle
        # bookkeeping): it mutates only in user-thread program order, so
        # under the SPMD contract (all ranks run the same program) every
        # rank evaluates the gates identically at the identical step: a
        # worker-timing-dependent gate could activate the plan on one
        # rank and not another, splitting the world between bypassed and
        # negotiated execution (a distributed hang).
        self._fp_outstanding: set = set()
        self._fp_window: Dict[str, Tuple[tuple, dict]] = {}
        self._fp_prev: Optional[Dict[str, Tuple[tuple, dict]]] = None
        self._fp_repeats = 0
        self._fp_capture: Optional[List[ExecutionBatch]] = None
        self._fp_capture_names: frozenset = frozenset()
        self._fp_step: Dict[str, Tuple[int, object]] = {}
        self._fp_inflight: Dict[str, Tuple[int, object]] = {}
        self._fp_dispatching = False
        self._fp_alias: Dict[int, int] = {}   # fast handle -> native handle
        self._fp_failed: Dict[int, str] = {}  # fast handle -> error
        self._fp_next_handle = -1  # native handles are >= 1
        self._fp_hits = 0
        self._fp_steps = 0
        self._fp_activations = 0
        self._fp_invalidations = 0
        self._fp_bypassed_bytes = 0
        self._fp_last_invalidation = ""
        # ---- pipelined negotiate/execute double buffer ----
        # The pop thread pulls cycle N+1's batches out of the native loop
        # while the execute thread is still running cycle N: a bounded
        # queue is the double buffer; a single execute thread preserves
        # the controller's order.
        self._exec_q: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(pipeline_depth)))
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="hvd-eager-negotiator"
        )
        self._exec_worker = threading.Thread(
            target=self._exec_loop, daemon=True, name="hvd-eager-executor"
        )
        self._worker.start()
        self._exec_worker.start()
        # the controller's and the plan cache's cumulative counters,
        # pulled into their gauges at every scrape
        _metrics.set_native_stats_provider(self.metrics_snapshot)

    # ------------------------------------------------------------ enqueue

    @staticmethod
    def _qualify(name: str, process_set_id: int) -> str:
        """Set-qualified wire name: name-keyed tables (tensor queue,
        message tables, response cache, stall inspector) never collide
        across sets (the reference reaches the same end with whole
        per-set controller instances, process_set.h:89)."""
        return name if process_set_id == 0 else f"ps{process_set_id}:{name}"

    @staticmethod
    def _prep_entry(name, tensor, op, reduce_op, root_rank, prescale,
                    postscale, splits, group, group_size, process_set_id):
        """Fault hook, tensor normalization, ready event and kwargs dict:
        the per-tensor front half shared by enqueue and enqueue_batch."""
        # chaos hook: `collective:delay` simulates slow negotiation,
        # `collective:error` a failed one, surfaced as the same
        # HorovodInternalError a real negotiation failure raises so
        # elastic recovery exercises its production path
        if _faults.enabled():
            try:
                _faults.inject("collective", name=name, op=op)
            except _faults.InjectedFault as e:
                raise HorovodInternalError(str(e)) from e
        # negotiation only needs shape and dtype: the tensor stays on its
        # device, and a tensor on the card gets its producer's ready event
        arr = (tensor.detach() if isinstance(tensor, torch.Tensor)
               else torch.as_tensor(tensor))
        ready = None
        if arr.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(arr.device))
        kwargs = dict(
            op=op, reduce_op=reduce_op, root_rank=root_rank,
            prescale=float(prescale), postscale=float(postscale),
            splits=[int(s) for s in splits] if splits is not None else None,
            group=group, group_size=group_size,
            process_set_id=process_set_id,
        )
        return arr, ready, kwargs

    def enqueue(self, name: str, tensor, op: int = OP_ALLREDUCE,
                reduce_op: int = _REDUCE_SUM, root_rank: int = 0,
                prescale: float = 1.0, postscale: float = 1.0,
                splits: Optional[List[int]] = None,
                group: Optional[str] = None, group_size: int = 0,
                process_set_id: int = 0) -> int:
        arr, ready, kwargs = self._prep_entry(
            name, tensor, op, reduce_op, root_rank, prescale, postscale,
            splits, group, group_size, process_set_id)
        name = self._qualify(name, process_set_id)
        steps: tuple = ()
        try:
            with self._lock:
                handle, steps = self._enqueue_locked(name, arr, ready,
                                                     kwargs)
                depth = len(self._inputs) + len(self._fp_step)
            _metrics.set_queue_depth(depth)
        finally:
            # dispatch even when the enqueue raised: a step moved to
            # inflight (_fp_dispatching set) MUST execute or every
            # later plan step would be held forever
            for plan, step in steps:
                self._fp_dispatch(plan, step)
        return handle

    def enqueue_batch(self, entries: List[dict]) -> List[int]:
        """Batched enqueue: the whole step's gradient set pays ONE
        lock/queue round instead of one per tensor. Each entry is a dict
        with the keyword arguments of :meth:`enqueue` plus the required
        ``name`` and ``tensor`` keys. Returns the handles in entry
        order."""
        prepared = []
        for e in entries:
            arr, ready, kwargs = self._prep_entry(
                e["name"], e["tensor"], e.get("op", OP_ALLREDUCE),
                e.get("reduce_op", _REDUCE_SUM), e.get("root_rank", 0),
                e.get("prescale", 1.0), e.get("postscale", 1.0),
                e.get("splits"), e.get("group"), e.get("group_size", 0),
                e.get("process_set_id", 0))
            prepared.append(
                (self._qualify(e["name"], kwargs["process_set_id"]),
                 arr, ready, kwargs))
        handles: List[int] = []
        steps_all: List[tuple] = []
        try:
            with self._lock:
                for name, arr, ready, kwargs in prepared:
                    h, steps = self._enqueue_locked(name, arr, ready,
                                                    kwargs)
                    handles.append(h)
                    steps_all.extend(steps)
                depth = len(self._inputs) + len(self._fp_step)
            _metrics.set_queue_depth(depth)
        finally:
            # a later entry's native enqueue may raise AFTER an earlier
            # entry completed a plan step: the collected steps must
            # still dispatch
            for plan, step in steps_all:
                self._fp_dispatch(plan, step)
        return handles

    def _enqueue_locked(self, name: str, arr, ready, kwargs: dict):
        """Route one tensor: plan fast path when a frozen plan covers it
        with an identical signature, full negotiation otherwise (with
        window bookkeeping so a steady state can be detected). Returns
        (handle, ready-steps-to-dispatch-after-unlock)."""
        if self._fp_on and kwargs["op"] in _PLAN_OPS:
            sig = self._fp_sig(arr, kwargs)
            if self._fp_plan is None and name in self._fp_window:
                # a name repeating = the previous step's sequence ended
                self._fp_close_window_locked()
            plan = self._fp_plan
            if plan is not None:
                entry = plan.entries.get(name)
                if (entry is not None and entry.sig == sig
                        and name not in self._fp_step):
                    return self._fp_hit_locked(name, arr, ready)
                # sequence deviation (new tensor, shape change, repeat
                # before the step completed): drop the plan, push any
                # held tensors back through negotiation, renegotiate
                self._fp_flush_locked(f"deviation:{name}")
            self._fp_window[name] = (sig, dict(kwargs))
            if len(self._fp_window) > 4096:
                # an unbounded stream of fresh names (auto-named ops)
                # never closes a window: don't let the table grow
                self._fp_window = {}
                self._fp_prev = None
                self._fp_repeats = 0
        return self._native_enqueue_locked(name, arr, ready, kwargs), ()

    def _native_enqueue_locked(self, name: str, arr, ready,
                               kwargs: dict) -> int:
        # input + handle bookkeeping must be visible before the worker
        # thread can snapshot them, so the WHOLE enqueue runs under the
        # runtime lock: on a fast-negotiating world (response-cache hit,
        # world 1, 1 ms cycles) the background loop can emit the batch
        # microseconds after native.enqueue returns. The native enqueue
        # only pushes onto the C++ tensor queue; it never waits on this
        # lock, so holding it across the call cannot deadlock.
        prev_in = self._inputs.get(name)
        prev_ready = self._ready.get(name)
        self._inputs[name] = arr
        if ready is not None:
            self._ready[name] = ready
        try:
            handle = self._native.enqueue(
                name, kwargs["op"], arr.dtype, list(arr.shape),
                reduce_op=kwargs["reduce_op"],
                root_rank=kwargs["root_rank"],
                prescale=kwargs["prescale"], postscale=kwargs["postscale"],
                splits=kwargs["splits"], group=kwargs["group"],
                group_size=kwargs["group_size"],
                process_set_id=kwargs["process_set_id"],
            )
        except Exception:
            # restore rather than pop: a fast-path fallback may have
            # just replayed a same-named tensor whose input must survive
            for table, prev in ((self._inputs, prev_in),
                                (self._ready, prev_ready)):
                if prev is not None:
                    table[name] = prev
                else:
                    table.pop(name, None)
            raise
        self._handle_name[handle] = name
        self._handle_op[handle] = kwargs["op"]
        if kwargs["op"] in _PLAN_OPS:
            self._fp_outstanding.add(handle)
        # the enqueue is the unit the cross-rank straggler report counts
        _flight.record("enqueue", name, op=kwargs["op"], handle=handle)
        if _metrics.enabled():  # stamped only when someone reads it
            self._handle_ts[handle] = time.perf_counter()
        # the span opens only once the controller took the tensor: an
        # unclosed B would break the trace's nesting
        tl = _timeline()
        if tl is not None and kwargs["op"] in _OP_ACTIVITIES:
            tl.activity_start(name, _OP_ACTIVITIES[kwargs["op"]][0],
                              args={"shape": list(arr.shape),
                                    "dtype": str(arr.dtype)})
        return handle

    # ------------------------------------------- steady-state fast path

    @staticmethod
    def _fp_sig(arr, kwargs: dict) -> tuple:
        """Rolling-fingerprint element: everything negotiation would
        look at. Two enqueues with equal signatures would negotiate
        identically, which is what makes replaying the cached plan
        sound."""
        sp = kwargs.get("splits")
        return (
            kwargs["op"], kwargs["reduce_op"], kwargs["root_rank"],
            kwargs["prescale"], kwargs["postscale"], str(arr.dtype),
            tuple(int(d) for d in arr.shape),
            tuple(sp) if sp is not None else None,
            kwargs.get("group"), kwargs.get("group_size", 0),
            kwargs["process_set_id"],
        )

    def _fp_close_window_locked(self) -> None:
        """A step sequence just ended (one of its names re-appeared):
        compare it with the previous sequence, count repeats, and drive
        the capture -> freeze ladder. Window equality is ORDER-free (a
        name -> signature map): ranks may legally enqueue the same step
        in different orders, and the plan's batch order comes from the
        captured negotiated responses, not from local submit order, so
        every rank freezes the identical plan at the identical step."""
        w = self._fp_window
        self._fp_window = {}
        prev = self._fp_prev
        same = (
            prev is not None and len(w) == len(prev)
            and all(n in prev and prev[n][0] == s
                    for n, (s, _) in w.items())
        )
        self._fp_repeats = self._fp_repeats + 1 if same else 1
        captured = self._fp_capture
        self._fp_capture = None
        self._fp_prev = w
        if same and captured is not None:
            self._fp_try_freeze_locked(captured, w)
        if (self._fp_plan is None
                and self._fp_repeats >= self._fp_warmup
                and not self._fp_outstanding):
            # K identical sequences seen and every issued handle already
            # synchronized (a PROGRAM-ORDER fact, identical on all ranks,
            # see _fp_outstanding): record the NEXT sequence's
            # negotiated batches as the plan
            self._fp_capture = []
            self._fp_capture_names = frozenset(w)

    def _fp_try_freeze_locked(self, captured: List[ExecutionBatch],
                              window: Dict[str, tuple]) -> None:
        """Freeze the captured negotiated round into an ExecutionPlan if
        it cleanly covers the window (every tensor exactly once, nothing
        foreign fused in, nothing still in flight). Every input to this
        decision is identical on every rank, so either every rank
        freezes this plan at this step or none does."""
        seen: List[str] = []
        for b in captured:
            seen.extend(b.names)
        if (len(seen) != len(set(seen)) or set(seen) != set(window)
                or self._fp_outstanding):
            return  # not a clean steady-state round; re-capture later
        if _faults.enabled():
            try:
                _faults.inject("eager.fast_path", tensors=len(window))
            except _faults.InjectedFault:
                # a chaos rule vetoed activation: stay on full
                # negotiation (correct, just slower) and restart warmup
                self._fp_invalidations += 1
                self._fp_last_invalidation = "fault_injected"
                self._fp_repeats = 0
                return
        entries = {
            n: _PlanEntry(sig, kw) for n, (sig, kw) in window.items()
        }
        wire = self._executor_wire()
        self._fp_plan = ExecutionPlan(
            list(captured), entries,
            wire_key=wire.key if wire is not None else None)
        self._fp_activations += 1
        _flight.record("plan_activate", batches=len(captured),
                       tensors=len(entries))
        tl = _timeline()
        if tl is not None:
            tl.instant("fast_path", "PLAN_ACTIVATED",
                       args={"batches": len(captured),
                             "tensors": len(entries)})

    def _fp_hit_locked(self, name: str, arr, ready):
        """Negotiation bypassed: append the tensor straight into its
        pre-sized plan slot; when the step's last tensor lands, hand the
        whole step back for dispatch (outside the lock)."""
        plan = self._fp_plan
        h = self._fp_next_handle  # native handles are >= 1; ours < 0
        self._fp_next_handle -= 1
        self._fp_step[name] = (h, arr)
        if ready is not None:
            self._ready[name] = ready
        self._fp_hits += 1
        # a bypassed enqueue still counts as a submission: peers on the
        # negotiated path must not read this rank as a straggler
        _flight.record("enqueue", name, handle=h, fast_path=True)
        steps = ()
        if (len(self._fp_step) == len(plan.names)
                and not self._fp_dispatching):
            if self._native.pending_joins() > 0:
                # a peer joined (stopped contributing): only
                # negotiation's zero-contribution join semantics can
                # reconcile the world, so push this whole step back
                # through the coordinator instead of dispatching a
                # collective the joiner will never issue. The signal is
                # advisory (a ~2-cycle propagation window exists); the
                # stall watchdog owns that residual race
                self._fp_flush_locked("peer_join")
                return h, ()  # flush aliased h to a native handle
            step = self._fp_step
            self._fp_step = {}
            self._fp_inflight = step
            self._fp_dispatching = True
            steps = ((plan, step),)
        return h, steps

    def _fp_flush_locked(self, reason: str) -> None:
        """Fall off the fast path: replay any held (not yet dispatched)
        step tensors through full negotiation (their issued fast
        handles get aliased to the replayed native handles, so
        synchronize() on them keeps working), then invalidate the plan
        and reset the learning windows."""
        plan = self._fp_plan
        if plan is not None and self._fp_step:
            for name, (fh, arr) in list(self._fp_step.items()):
                try:
                    nh = self._native_enqueue_locked(
                        name, arr, self._ready.get(name),
                        plan.entries[name].kwargs)
                except Exception:
                    self._fp_failed[fh] = (
                        f"fast-path fallback re-enqueue failed for "
                        f"'{name}': {self._native.last_error()}"
                    )
                    continue
                self._fp_alias[fh] = nh
            self._fp_step = {}
        self._fp_invalidate_locked(reason)

    def _fp_invalidate_locked(self, reason: str) -> None:
        had_plan = self._fp_plan is not None
        self._fp_plan = None
        self._fp_capture = None
        self._fp_window = {}
        self._fp_prev = None
        self._fp_repeats = 0
        if had_plan:
            self._fp_invalidations += 1
            self._fp_last_invalidation = reason
            _flight.record("plan_invalidate", reason=reason)
            tl = _timeline()
            if tl is not None:
                tl.instant("fast_path", "PLAN_INVALIDATED",
                           args={"reason": reason})
        self._fp_cond.notify_all()

    def _fp_dispatch(self, plan: ExecutionPlan, step: Dict[str, tuple]
                     ) -> None:
        """Execute one cached-plan step in the calling thread: no
        coordinator round trip and no worker-thread handoff; the
        batches are replayed in frozen controller order, which keeps the
        ranks' collectives in one order."""
        handles = {n: h for n, (h, _) in step.items()}
        tensors_all = {n: t for n, (_, t) in step.items()}
        error = None
        for batch in plan.batches:
            try:
                tensors = {n: tensors_all[n] for n in batch.names}
                results, done = self._execute(batch, tensors, batch.names,
                                              fast_path=True)
                with self._lock:
                    for n in batch.names:
                        if n in results:
                            self._results[handles[n]] = (results[n], done)
                        else:
                            self._fp_failed[handles[n]] = (
                                f"fast-path executor returned no result"
                                f" for '{n}'")
            except Exception:
                import traceback

                error = traceback.format_exc(limit=8)
                self._last_exec_error = error
            if error is not None:
                break
        with self._fp_cond:
            if error is not None:
                for n, h in handles.items():
                    if h not in self._results and h not in self._fp_failed:
                        self._fp_failed[h] = (
                            "fast-path execution failed:\n" + error)
                if self._fp_plan is plan:
                    self._fp_invalidate_locked("executor_error")
            else:
                self._fp_steps += 1
                self._fp_bypassed_bytes += plan.total_bytes
            self._fp_inflight = {}
            self._fp_dispatching = False
            self._fp_cond.notify_all()

    def _fp_sync(self, handle: int, timeout_s: float):
        """Resolve a fast-path handle: (True, result) when the plan
        step already executed, (False, native_handle) when the tensor
        was (or is now being) replayed through negotiation."""
        deadline = time.monotonic() + timeout_s
        with self._fp_cond:
            while True:
                if handle in self._results:
                    return True, self._results.pop(handle)
                if handle in self._fp_failed:
                    raise HorovodInternalError(self._fp_failed.pop(handle))
                nh = self._fp_alias.pop(handle, None)
                if nh is not None:
                    return False, nh
                held = any(h == handle for h, _ in self._fp_step.values())
                if held and not self._fp_dispatching:
                    # the caller blocks before the plan step completed:
                    # this submit/sync interleaving is finer than the
                    # plan's step granularity, so replay the held tensors
                    # through negotiation and wait there (the plan is
                    # dropped; steady state will re-learn)
                    self._fp_flush_locked("sync_before_step_complete")
                    continue
                inflight = any(
                    h == handle for h, _ in self._fp_inflight.values())
                if inflight or self._fp_dispatching:
                    if time.monotonic() >= deadline:
                        raise HorovodInternalError(
                            f"timed out waiting for fast-path handle "
                            f"{handle}")
                    self._fp_cond.wait(
                        min(0.25, max(0.01,
                                      deadline - time.monotonic())))
                    continue
                raise HorovodInternalError(
                    f"no result for handle {handle}: "
                    f"{self._native.last_error() or self._last_exec_error}"
                )

    def _fp_barrier(self, reason: str) -> None:
        """Topology or membership is about to change (process-set churn,
        join, explicit invalidation): push held fast-path tensors back
        through negotiation and drop the plan before the change lands."""
        with self._fp_cond:
            self._fp_flush_locked(reason)

    def invalidate_plan(self, reason: str = "user") -> None:
        """Drop the cached plan (if any) and reset steady-state
        detection. Held tensors are replayed through full negotiation;
        outstanding handles stay valid."""
        self._fp_barrier(reason)

    def set_fast_path(self, enabled: bool) -> None:
        """Toggle the steady-state fast path live. Disabling flushes the
        active plan so later enqueues take the negotiated path exactly
        as with HOROVOD_EAGER_FAST_PATH=0."""
        with self._fp_cond:
            if not enabled:
                self._fp_flush_locked("disabled")
            self._fp_on = bool(enabled)

    def _executor_wire(self):
        return getattr(self._executor, "wire", None)

    def set_wire(self, wire) -> None:
        """Switch the executor's wire compression live (a
        HOROVOD_COMPRESSION-style name, a WireSpec, or None). Any frozen
        plan was captured under the old wire, so the plan cache
        restarts; the change must land on every rank at the same program
        point. Refuses while collectives are outstanding: a batch
        negotiated before the flip could otherwise execute under
        different wires on different ranks."""
        spec = _resolve_executor_wire(wire)
        set_fn = getattr(self._executor, "set_wire", None)
        if set_fn is None:
            raise HorovodInternalError(
                "this executor does not support wire compression")
        with self._lock:
            if self._fp_outstanding or self._fp_step:
                raise HorovodInternalError(
                    f"set_wire with "
                    f"{len(self._fp_outstanding) + len(self._fp_step)} "
                    "outstanding collective handle(s): synchronize "
                    "every pending collective on every rank first, or "
                    "a batch could execute under different wires on "
                    "different ranks")
        self._fp_barrier("wire_change")
        set_fn(spec)

    def fast_path_stats(self) -> dict:
        with self._lock:
            wire = self._executor_wire()
            return {
                "enabled": self._fp_on,
                "active": self._fp_plan is not None,
                "hits": self._fp_hits,
                "steps": self._fp_steps,
                "activations": self._fp_activations,
                "invalidations": self._fp_invalidations,
                "bypassed_bytes": self._fp_bypassed_bytes,
                "last_invalidation": self._fp_last_invalidation,
                "warmup": self._fp_warmup,
                "wire": wire.kind if wire is not None else "none",
                "plan_wire_key": (self._fp_plan.wire_key
                                  if self._fp_plan is not None else None),
            }

    # --------------------------------------------------- process sets

    def register_process_set(self, set_id: int, ranks,
                             timeout_s: float = 60.0) -> None:
        """Negotiated registration: every world rank must call with
        identical membership before any rank's call returns (reference
        process_sets.py:123). The executor then makes the set's group
        (collective over the world, as ``dist.new_group`` is)."""
        # membership churn changes fusion and the sets' groups: any
        # cached plan (and steady-state learning) restarts from scratch
        self._fp_barrier("process_set_register")
        ranks = sorted(int(r) for r in ranks)
        h = self._native.register_set(set_id, ranks)
        state = self._await_handle(h, timeout_s)
        self._native.release(h)
        if state != DONE:
            raise HorovodInternalError(
                f"process set {set_id} registration failed: "
                f"{self._native.last_error()}"
            )
        add_set = getattr(self._executor, "add_set", None)
        if add_set is not None:
            add_set(ranks)

    def deregister_process_set(self, set_id: int,
                               timeout_s: float = 60.0) -> None:
        self._fp_barrier("process_set_deregister")
        ranks = self._native.set_members(set_id)
        h = self._native.deregister_set(set_id)
        state = self._await_handle(h, timeout_s)
        self._native.release(h)
        if state != DONE:
            raise HorovodInternalError(
                f"process set {set_id} deregistration failed: "
                f"{self._native.last_error()}"
            )
        remove_set = getattr(self._executor, "remove_set", None)
        if remove_set is not None and ranks is not None:
            remove_set(ranks)

    def process_set_members(self, set_id: int) -> Optional[List[int]]:
        """Sorted global ranks of a registered set; None if unknown."""
        return self._native.set_members(set_id)

    def allreduce_async(self, name: str, tensor, average: bool = False,
                        prescale: float = 1.0, postscale: float = 1.0,
                        process_set_id: int = 0) -> int:
        return self.enqueue(
            name, tensor, OP_ALLREDUCE,
            reduce_op=_REDUCE_AVERAGE if average else _REDUCE_SUM,
            prescale=prescale, postscale=postscale,
            process_set_id=process_set_id,
        )

    def allgather_async(self, name: str, tensor,
                        process_set_id: int = 0) -> int:
        """Ragged-capable: dim 0 may differ per rank; the controller
        negotiates per-rank sizes (reference controller.cc:497). The
        LoopbackExecutor refuses truly ragged worlds (it cannot fabricate
        peers' data); the DistExecutor handles them."""
        return self.enqueue(name, tensor, OP_ALLGATHER,
                            process_set_id=process_set_id)

    def alltoall_async(self, name: str, tensor, splits=None,
                       process_set_id: int = 0) -> int:
        """Uneven-capable: ``splits[j]`` rows go to set member j;
        synchronize returns ``(output, received_splits)`` (reference
        operations.cc:1858)."""
        return self.enqueue(name, tensor, OP_ALLTOALL, splits=splits,
                            process_set_id=process_set_id)

    def broadcast_async(self, name: str, tensor, root_rank: int = 0,
                        process_set_id: int = 0) -> int:
        return self.enqueue(name, tensor, OP_BROADCAST, root_rank=root_rank,
                            process_set_id=process_set_id)

    def join(self) -> int:
        # a joining rank stops contributing: peers' sequences now
        # include tensors we never enqueue, which only negotiation's
        # zero-contribution join semantics can reconcile
        self._fp_barrier("join")
        return self._native.join()

    def join_sync(self, timeout_s: float = 60.0) -> int:
        """Join and block until every rank has joined (the worker thread
        completes OP_JOIN batches). Returns 0, as the JAX package does:
        the order in which ranks joined is not tracked."""
        self._fp_barrier("join")
        h = self._native.join()
        # a join handle stays PENDING until every rank has joined
        # (controller.cc kJoin emits only on full coverage): keep waiting
        # through PENDING timeouts like synchronize does; the stall
        # watchdog and inspector own genuinely stuck worlds
        state = self._await_handle(h, timeout_s)
        self._native.release(h)
        if state != DONE:
            raise HorovodInternalError(
                f"join failed: {self._native.last_error()}"
            )
        return 0

    def barrier(self, timeout_s: float = 60.0,
                process_set_id: int = 0) -> None:
        if process_set_id == 0:
            h = self._native.barrier()
        else:
            # per-set barrier: completes when every MEMBER has arrived
            # (reference process_set.h:89: each set negotiates alone)
            h = self._native.enqueue(
                self._qualify("__barrier__", process_set_id),
                OP_BARRIER, "uint8", [],
                process_set_id=process_set_id,
            )
        state = self._native.wait(h, timeout_s)
        while state == BATCHED:
            state = self._native.wait(h, timeout_s)
        self._native.release(h)
        if state != DONE:
            raise HorovodInternalError(
                f"barrier failed: {self._native.last_error()}"
            )

    # --------------------------------------------------------- completion

    def poll(self, handle: int) -> bool:
        if handle < 0:  # fast-path handle
            with self._lock:
                if handle in self._results or handle in self._fp_failed:
                    return True
                nh = self._fp_alias.get(handle)
            if nh is None:
                return False
            handle = nh
        return self._native.poll(handle) in (DONE, FAILED)

    # -- stall watchdog ----------------------------------------------------

    def _progress_marker(self, handle: int) -> tuple:
        """Cheap observable-progress fingerprint for a pending wait.
        Deliberately excludes coordinator cycle counts: an idle
        coordinator keeps cycling while a lost peer stalls the world,
        and that must read as NO progress."""
        stats = {}
        try:
            stats = self._native.stats()
        except Exception:
            pass
        with self._lock:
            n_results = len(self._results)
        return (
            self._native.poll(handle),
            stats.get("responses", 0),
            stats.get("bytes_negotiated", 0),
            n_results,
        )

    def _abort_stalled(self, handle: int, waited_s: float) -> None:
        """Convert a stalled collective into HorovodInternalError:
        release the handle, drop its bookkeeping, abort the executor's
        group (a collective on the card cannot be cancelled otherwise)
        and raise; the elastic run() wrapper restores committed state
        and retries instead of hanging past every deadline."""
        _metrics.record_stall_abort()
        self._native.release(handle)
        with self._lock:
            # everything still awaiting negotiation or execution: the
            # tensors the straggler report attributes (taken before the
            # aborting handle's own input goes)
            pending = sorted(set(self._inputs) | set(self._fp_step))
            self._fp_outstanding.discard(handle)
            name = self._handle_name.pop(handle, None)
            op = self._handle_op.pop(handle, None)
            self._handle_ts.pop(handle, None)
            if name is not None:
                self._inputs.pop(name, None)
                self._ready.pop(name, None)
        straggler = ""
        if _flight.enabled():
            _flight.record("stall_abort", name or "", handle=handle,
                           waited_s=round(waited_s, 3))
            try:
                straggler = _flight.straggler_report(
                    pending, self._size, self._rank, reason="stall_abort")
            except Exception:
                straggler = ""
        tl = _timeline()
        if tl is not None and name is not None and op in _OP_ACTIVITIES:
            tl.activity_end(name, _OP_ACTIVITIES[op][0])
            tl.instant(name, "STALL_ABORT")
        self._aborted = True
        abort = getattr(self._executor, "abort", None)
        if abort is not None:
            try:
                abort()
            except Exception:
                pass
        raise HorovodInternalError(
            f"collective stalled: handle {handle}"
            + (f" ({name})" if name else "")
            + f" made no progress for {waited_s:.1f}s "
            "(HOROVOD_STALL_ABORT_S watchdog; a peer likely died; "
            "elastic training will restore and retry)"
            + (f"; {straggler}" if straggler else "")
        )

    def _await_handle(self, handle: int, timeout_s: float,
                      results_gate: bool = False) -> int:
        """Block until the handle leaves PENDING/BATCHED (or, with
        ``results_gate``, until its result lands), aborting via the
        stall watchdog when enabled. Returns the last native state."""
        abort_s = self._stall_abort_s
        if abort_s <= 0:
            slice_s = timeout_s
            stall_at = None
        else:
            # short wait slices keep the watchdog responsive without
            # busy-spinning; progress checks run only on this slow path
            slice_s = max(min(timeout_s, abort_s / 4.0, 0.25), 0.01)
            stall_at = time.monotonic() + abort_s
        last_marker = None
        state = self._native.wait(handle, slice_s)
        while state in (0, BATCHED):  # pending or awaiting executor
            if results_gate:
                with self._lock:
                    if handle in self._results:
                        return state
            if stall_at is not None:
                marker = self._progress_marker(handle)
                if marker != last_marker:
                    last_marker = marker
                    stall_at = time.monotonic() + abort_s
                elif time.monotonic() >= stall_at:
                    self._abort_stalled(handle, abort_s)
            state = self._native.wait(handle, slice_s)
        return state

    def synchronize(self, handle: int, timeout_s: float = 60.0):
        if handle < 0:  # fast-path handle
            done, value = self._fp_sync(handle, timeout_s)
            if done:
                return _deliver(*value)
            handle = value  # replayed through negotiation: wait there
        self._await_handle(handle, timeout_s, results_gate=True)
        failed = self._native.poll(handle) == FAILED
        self._native.release(handle)
        if failed:
            # a handle that never reached the executor failed in
            # negotiation: its NEGOTIATE span is still open
            with self._lock:
                self._fp_outstanding.discard(handle)
                name = self._handle_name.pop(handle, None)
                op = self._handle_op.pop(handle, None)
                self._handle_ts.pop(handle, None)
                self._inputs.pop(name, None)
                self._ready.pop(name, None)
            tl = _timeline()
            if tl is not None and name is not None and op in _OP_ACTIVITIES:
                tl.activity_end(name, _OP_ACTIVITIES[op][0])
                tl.instant(name, "ERROR")
            raise HorovodInternalError(
                self._native.last_error() or self._last_exec_error)
        with self._lock:
            self._fp_outstanding.discard(handle)
            if handle not in self._results:
                raise HorovodInternalError(
                    f"no result for handle {handle}: "
                    f"{self._native.last_error() or self._last_exec_error}"
                )
            value = self._results.pop(handle)
        return _deliver(*value)

    # ------------------------------------------------------------- worker

    def _stream(self, device):
        """The runtime's own CUDA stream on ``device``."""
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device)
        return s

    def _execute(self, batch: ExecutionBatch, tensors: Dict[str, object],
                 spans=(), fast_path: bool = False):
        """Run the executor on one batch: on the card, on the runtime's
        stream after the inputs' ready events, recording a completion
        event. ``spans`` are the tensors (this rank's) whose execution
        span the timeline shows. Returns ``(results, event or None)``."""
        tl = _timeline()
        execute = _OP_ACTIVITIES.get(batch.op, (None, None))[1]
        if execute is None:
            tl = None
        if tl is not None:
            # the span carries the fused batch's composition
            args = {"batch_id": batch.batch_id,
                    "fused_with": len(batch.names)}
            if fast_path:
                args["fast_path"] = True
            for n in spans:
                tl.activity_start(n, execute, args=args)
        head = batch.names[0] if batch.names else ""
        fp = {"fast_path": True} if fast_path else {}
        if _flight.enabled():
            _flight.record("exec_begin", head, op=batch.op,
                           n=len(batch.names), bytes=int(batch.total_bytes),
                           names=list(batch.names), **fp)
        device = self._device
        if device is None or device.type != "cuda":
            device = next((t.device for t in tensors.values()
                           if isinstance(t, torch.Tensor) and t.is_cuda),
                          None)
        t0 = time.perf_counter()
        try:
            if device is None:
                results, done = self._executor(batch, tensors), None
            else:
                stream = self._stream(device)
                with torch.cuda.stream(stream):
                    with self._lock:
                        events = [self._ready.pop(n) for n in batch.names
                                  if n in self._ready]
                    _wait_ready(stream, events)
                    for t in tensors.values():
                        if isinstance(t, torch.Tensor) and t.is_cuda:
                            # the caller may drop its tensor before the
                            # runtime's stream has read it
                            t.record_stream(stream)
                    results = self._executor(batch, tensors)
                    done = torch.cuda.Event()
                    done.record(stream)
        except Exception as e:
            if _flight.enabled():
                _flight.record("exec_error", head, op=batch.op,
                               error=str(e)[:200], **fp)
                _flight.dump("executor_error")
            raise
        finally:
            if tl is not None:
                for n in spans:
                    tl.activity_end(n, execute)
        dt = time.perf_counter() - t0
        with self._lock:
            self._exec_seconds += dt
            self._exec_batches += 1
        _metrics.record_batch_execution(
            _OP_METRIC_NAMES.get(batch.op, str(batch.op)),
            len(batch.names), int(batch.total_bytes), dt)
        if _flight.enabled():
            _flight.record("exec_end", head, op=batch.op,
                           names=list(batch.names), **fp)
        return results, done

    def _run(self) -> None:
        """Pop half of the pipelined worker: pull negotiated batches out
        of the native loop and hand them to the execute thread. The
        bounded queue is the double buffer: while the execute thread
        runs cycle N's batch, this thread is already blocked in
        next_batch pulling cycle N+1."""
        try:
            while not self._shutdown.is_set():
                batch = self._native.next_batch(timeout_s=0.1)
                if batch is None:
                    continue
                tl = _timeline()
                if tl is not None and batch.cycle != self._last_cycle:
                    # one mark a negotiation cycle, however many fused
                    # batches it produced (the reference's
                    # MarkCycleStart, operations.cc:734)
                    self._last_cycle = batch.cycle
                    tl.mark_cycle_start()
                if _flight.enabled():
                    # the moment the tensors' negotiation ended here
                    _flight.record(
                        "response", batch.names[0] if batch.names else "",
                        op=batch.op, cycle=int(batch.cycle),
                        n=len(batch.names), names=list(batch.names))
                ours: List[str] = []
                if batch.op not in (OP_JOIN, OP_BARRIER):
                    # spans only for the tensors this rank enqueued: a
                    # joined rank receives batches naming tensors it
                    # never started
                    waits: List[float] = []
                    with self._lock:
                        ours = [self._handle_name[h] for h in batch.handles
                                if h in self._handle_name]
                        if self._handle_ts:
                            now = time.perf_counter()
                            for h in batch.handles:
                                ts = self._handle_ts.pop(h, None)
                                if ts is not None:
                                    waits.append(now - ts)
                    for w in waits:  # recorded outside the lock
                        _metrics.record_negotiation_latency(w)
                    negotiate = _OP_ACTIVITIES.get(batch.op, (None,))[0]
                    if tl is not None and negotiate is not None:
                        for n in ours:
                            tl.activity_end(n, negotiate)
                self._exec_q.put((batch, ours))
        finally:
            self._exec_q.put(None)

    def _exec_loop(self) -> None:
        """Execute half of the pipeline: runs batches in controller
        order (a single thread preserves it) while _run pulls the next
        cycle's batches."""
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            item = self._exec_q.get()
            if item is None:
                return
            batch, ours = item
            if batch.op in (OP_JOIN, OP_BARRIER):
                # completed in controller order so a barrier cannot
                # overtake a data batch negotiated before it
                self._native.batch_done(batch, ok=True)
                continue
            try:
                with self._lock:
                    tensors = {
                        n: self._inputs[n]
                        for n in batch.names if n in self._inputs
                    }
                results, done = self._execute(batch, tensors, ours)
                with self._lock:
                    for h in batch.handles:
                        name = self._handle_name.pop(h, None)
                        self._handle_op.pop(h, None)
                        # a handle stamped while metrics were on whose
                        # negotiation ended after a disable()
                        self._handle_ts.pop(h, None)
                        if name is not None and name in results:
                            self._results[h] = (results[name], done)
                        self._inputs.pop(name, None)
                    if (self._fp_capture is not None
                            and batch.op in _PLAN_OPS):
                        # plan capture: record this negotiated batch as
                        # a frozen bucket IF it stays inside the
                        # captured sequence; a batch fusing a foreign
                        # tensor in means the round was not steady
                        bn = set(batch.names)
                        if bn <= self._fp_capture_names:
                            self._fp_capture.append(batch)
                        elif bn & self._fp_capture_names:
                            self._fp_capture = None
                    depth = len(self._inputs) + len(self._fp_step)
                _metrics.set_queue_depth(depth)
                self._native.batch_done(batch, ok=True)
            except Exception:
                # keep the executor's failure for synchronize()'s error
                # message: the native error channel only carries
                # negotiation and transport failures
                import traceback

                self._last_exec_error = traceback.format_exc(limit=8)
                self._native.batch_done(batch, ok=False)
                with self._lock:
                    for h in batch.handles:
                        name = self._handle_name.pop(h, None)
                        self._handle_op.pop(h, None)
                        self._handle_ts.pop(h, None)
                        self._inputs.pop(name, None)
                        self._ready.pop(name, None)

    # ------------------------------------------------------------ stats

    def metrics_snapshot(self) -> dict:
        """Cumulative native cycle and cache stats, the live queue depth,
        the fast-path counters and the executor's host seconds (the
        time the execute thread and the fast path spent inside the
        executor; on the card, issuing the work)."""
        s = self._native.stats()
        with self._lock:
            s["queue_depth"] = len(self._inputs) + len(self._fp_step)
            s["fast_path_hits"] = self._fp_hits
            s["fast_path_steps"] = self._fp_steps
            s["fast_path_activations"] = self._fp_activations
            s["fast_path_invalidations"] = self._fp_invalidations
            s["fast_path_active"] = 1 if self._fp_plan is not None else 0
            s["negotiation_bypassed_bytes"] = self._fp_bypassed_bytes
            s["executor_seconds"] = self._exec_seconds
            s["executor_batches"] = self._exec_batches
        return s

    def cache_hits(self) -> int:
        return self._native.cache_hits()

    def bytes_negotiated(self) -> int:
        return self._native.bytes_negotiated()

    def stall_warnings(self) -> int:
        return self._native.stall_warnings()

    def bound_port(self) -> int:
        """The port rank 0's controller listens on (0 in a world of one,
        whose controller has no transport)."""
        return self._native.coordinator_port()

    def shutdown(self) -> None:
        _metrics.set_native_stats_provider(None)
        with self._fp_cond:
            # fail any tensors still held in an incomplete plan step so
            # their waiters see a terminal state, mirroring the native
            # loop failing still-pending handles on shutdown
            self._fp_on = False
            held = list(self._fp_step.items()) + list(
                self._fp_inflight.items())
            for name, (h, _) in held:
                self._fp_failed.setdefault(h, "runtime shut down")
            self._fp_step = {}
            self._fp_plan = None
            self._fp_cond.notify_all()
        self._shutdown.set()
        self._native.shutdown()
        self._worker.join(timeout=5)
        # after a stall abort the execute thread may be stuck in the
        # data plane for good: it is a daemon, and is not waited for
        self._exec_worker.join(timeout=0 if self._aborted else 5)


class DistExecutor:
    """The data plane on ``torch.distributed``: executes negotiated
    batches as collectives on ``group``, a process group of the runtime's
    own (NCCL on the card, gloo on the CPU). A process set's batch runs
    on the group :meth:`add_set` made for it at registration."""

    def __init__(self, rank: int, world: int, group, device=None,
                 wire="auto"):
        self._rank = int(rank)
        self._world = int(world)
        self._group = group
        self._device = torch.device(device) if device is not None else \
            torch.device("cpu")
        # sorted member tuple -> the set's group
        self._set_groups: Dict[tuple, object] = {}
        # the compressed wire (optim/compression.py WireSpec) and the
        # int8 wire's error-feedback residuals, one per fused bucket,
        # on the device
        self.wire = _resolve_executor_wire(wire)
        self._wire_residuals: Dict[tuple, torch.Tensor] = {}

    def set_wire(self, wire) -> None:
        """Swap the wire (every process at the same point of the batch
        stream; the runtime's set_wire flushes the plan first). The old
        wire's residuals describe the old grid and are dropped."""
        self.wire = _resolve_executor_wire(wire)
        self._wire_residuals = {}

    def add_set(self, ranks) -> None:
        """Make a process set's group. Collective over the world, as
        ``dist.new_group`` is: every rank calls it, in one order."""
        members = tuple(sorted(int(r) for r in ranks))
        group = dist.new_group(list(members))
        if list(members) != list(range(self._world)):
            self._set_groups[members] = group

    def remove_set(self, ranks) -> None:
        self._set_groups.pop(tuple(sorted(int(r) for r in ranks)), None)

    def abort(self) -> None:
        """Abort the runtime's NCCL groups after a stall: an NCCL
        collective cannot be cancelled, and a stuck one would otherwise
        keep its thread and the card forever. A gloo group has no abort;
        its waits end with the peer's socket."""
        from torch.distributed import distributed_c10d as c10d

        for group in [self._group, *self._set_groups.values()]:
            if group is None or dist.get_backend(group) != "nccl":
                continue
            c10d._abort_process_group(group)

    # -------------------------------------------------------- plumbing

    def _batch_ctx(self, batch):
        """(group, set size, this rank's position in the set, member
        tuple) of a batch's process set; the runtime's world group and
        () for unscoped batches."""
        members = tuple(batch.set_ranks)
        if not members or list(members) == list(range(self._world)):
            return self._group, self._world, self._rank, ()
        if self._rank not in members:
            raise HorovodInternalError(
                f"rank {self._rank} received a batch for process set "
                f"{batch.process_set_id} (members {list(members)}) it "
                "does not belong to"
            )
        group = self._set_groups.get(members)
        if group is None:
            raise HorovodInternalError(
                f"no group for process set {batch.process_set_id} "
                f"(members {list(members)}): it was not registered "
                "through the runtime")
        return group, len(members), members.index(self._rank), members

    def _materialize(self, batch: ExecutionBatch,
                     tensors: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Per-tensor local inputs in batch order; zeros for tensors this
        process never enqueued (join semantics: a joined rank contributes
        zero tensors, reference collective_operations.h:325)."""
        dtype = batch_dtype(batch)
        out = []
        for i, name in enumerate(batch.names):
            if name in tensors:
                out.append(tensors[name])
            else:
                shape = (batch.shapes[i] if i < len(batch.shapes)
                         else batch.first_shape)
                out.append(torch.zeros(shape, dtype=dtype,
                                       device=self._device))
        return out

    @staticmethod
    def _specs(batch, inputs):
        """The fused bucket's (numel, shape) per tensor, memoized on the
        batch: a cached-plan step replays the same ExecutionBatch."""
        memo = getattr(batch, "_ar_specs", None)
        if memo is None:
            memo = tuple((x.numel(), tuple(x.shape)) for x in inputs)
            batch._ar_specs = memo
        return memo

    def _hier_block(self, batch, n: int, tag) -> int:
        """The two-level route's inner domain size, when the controller
        stamped the batch with a hierarchical sample point (autotune):
        the global set's SUM/AVERAGE only; 0 keeps the flat route."""
        if not getattr(batch, "tuned_hierarchical", False) or tag:
            return 0
        if batch.reduce_op not in (_REDUCE_SUM, _REDUCE_AVERAGE):
            return 0
        from .hierarchical import resolve_block

        block = resolve_block(n, int(getattr(batch, "tuned_hier_block", 0)))
        return block if block > 1 else 0

    @staticmethod
    def _unpack(flat: torch.Tensor, specs, names, tensors) -> dict:
        out, off = {}, 0
        for name, (size, shape) in zip(names, specs):
            if name in tensors:
                out[name] = flat[off:off + size].view(shape)
            off += size
        return out

    # ------------------------------------------------------- execution

    def __call__(self, batch: ExecutionBatch,
                 tensors: Dict[str, torch.Tensor]) -> Dict[str, object]:
        op = batch.op
        if op == OP_ALLREDUCE:
            return self._run_allreduce(batch, tensors)
        if op == OP_REDUCESCATTER:
            return self._run_reducescatter(batch, tensors)
        if op == OP_ALLGATHER:
            return self._run_allgather(batch, tensors)
        if op == OP_BROADCAST:
            return self._run_broadcast(batch, tensors)
        if op == OP_ALLTOALL:
            return self._run_alltoall(batch, tensors)
        raise HorovodInternalError(
            f"executor received unknown op {op} for batch {batch.names}; "
            "refusing to pass input through unchanged"
        )

    def _run_allreduce(self, batch, tensors):
        group, n, _, tag = self._batch_ctx(batch)
        inputs = self._materialize(batch, tensors)
        _record_wire_batch(self.wire, batch, sum(x.numel() for x in inputs))
        wire = self.wire if _wire_applies(self.wire, batch) else None
        if wire is not None and wire.kind == "int8":
            return self._run_allreduce_int8(batch, tensors, inputs, group,
                                            n, tag)
        reduce_op = batch.reduce_op
        if reduce_op == _REDUCE_ADASUM:
            raise HorovodInternalError(
                "the runtime's executor does not carry Adasum: it is "
                "reduced by ops/adasum.py outside the runtime")
        specs = self._specs(batch, inputs)
        hier_block = self._hier_block(batch, n, tag)
        # pack the fused batch into one flat buffer (always a new
        # tensor: the inputs are never written), one collective for it
        flat = torch.cat([x.reshape(-1) for x in inputs])
        # a cast wire: ONE cast per fused bucket around the reduce; the
        # whole payload (prescale, sum, average, postscale) runs in the
        # wire dtype and casts back
        buf = flat.to(wire.wire_dtype) if wire is not None else flat
        scale_(buf, batch.prescale)
        if hier_block:
            from .hierarchical import hierarchical_psum

            buf = hierarchical_psum(buf, hier_block)
        else:
            dist.all_reduce(buf, op=dist_op(ReduceOp(reduce_op)),
                            group=group)
        if reduce_op == _REDUCE_AVERAGE:
            buf = average_(buf, n)
        scale_(buf, batch.postscale)
        if wire is not None:
            buf = buf.to(flat.dtype)
        return self._unpack(buf, specs, batch.names, tensors)

    def _run_allreduce_int8(self, batch, tensors, inputs, group, n, tag):
        """A fused allreduce on the int8 block-quantized wire: the
        tensors packed, this bucket's error-feedback residual added, the
        quantized SUM (B12 or B11, all-to-all, B13, B11, all-gather,
        B14 on the card; flat, or in two levels when the controller
        stamped a hierarchy block), the sum sliced back out. The
        residual is one float32 buffer per fused bucket, keyed by the
        batch's signature."""
        from . import quantized_collectives as qc

        spec = self.wire
        reduce_op = batch.reduce_op
        hier_block = self._hier_block(batch, n, tag)
        specs = self._specs(batch, inputs)
        total = sum(size for size, _ in specs)
        ef = spec.error_feedback
        rkey = (tuple(batch.names), specs, tag, spec.key, hier_block)
        packed = torch.cat([x.reshape(-1) for x in inputs])
        scale_(packed, batch.prescale)
        res = None
        if ef:
            res = self._wire_residuals.get(rkey)
            if res is None:
                res = torch.zeros(total, dtype=torch.float32,
                                  device=packed.device)
        flat = packed.to(torch.float32).contiguous()
        if hier_block:
            from .hierarchical import start_hierarchical_psum

            finish, err = start_hierarchical_psum(flat, hier_block, spec,
                                                  res)
        else:
            finish, err = qc.start_quantized_psum(flat, n, spec.block, res,
                                                  group=group)
        y = finish().to(packed.dtype)
        if ef:
            # bounded LRU-style: each entry is a bucket-sized float32
            # buffer on the device, and bucket churn would otherwise pin
            # stale copies until out of memory
            self._wire_residuals.pop(rkey, None)
            self._wire_residuals[rkey] = err
            while len(self._wire_residuals) > DIST_RESIDUALS:
                self._wire_residuals.pop(next(iter(self._wire_residuals)))
                _warn_residual_eviction_once()
        if reduce_op == _REDUCE_AVERAGE:
            y = (y / n).to(packed.dtype)
        scale_(y, batch.postscale)
        return self._unpack(y, specs, batch.names, tensors)

    def _run_reducescatter(self, batch, tensors):
        group, n, _, _ = self._batch_ctx(batch)
        inputs = self._materialize(batch, tensors)
        for name, x in zip(batch.names, inputs):
            if x.dim() == 0 or x.shape[0] % n:
                raise HorovodInternalError(
                    f"reducescatter '{name}': dim0 of {tuple(x.shape)} "
                    f"not divisible by set size {n}")
        # pack the fused batch rank-major into ONE flat buffer (chunk k
        # of every member, concatenated), so one reduce-scatter hands
        # rank k exactly its chunks of every member
        packed = torch.cat([x.reshape(n, -1) for x in inputs],
                           dim=1).reshape(-1)
        scale_(packed, batch.prescale)
        out, work = _reduce_scatter_tiled(packed, n, group)
        work.wait()
        if batch.reduce_op == _REDUCE_AVERAGE:
            out = average_(out, n)
        scale_(out, batch.postscale)
        res, off = {}, 0
        for name, x in zip(batch.names, inputs):
            m = x.numel() // n
            if name in tensors:
                res[name] = out[off:off + m].view(
                    (x.shape[0] // n,) + tuple(x.shape[1:]))
            off += m
        return res

    def _run_allgather(self, batch, tensors):
        group, n, _, _ = self._batch_ctx(batch)
        dims = [int(d) for d in batch.rank_dim0]  # set-local member order
        dtype = batch_dtype(batch)
        out = {}
        for i, name in enumerate(batch.names):
            x = tensors.get(name)
            tail = (tuple(batch.shapes[i][1:]) if i < len(batch.shapes)
                    else tuple(batch.first_shape[1:]))
            mx = max(dims) if dims else x.shape[0]
            # ragged: pad every contribution to the negotiated max dim-0,
            # gather uniformly, slice the real rows back out (reference
            # allgather size collection, controller.cc:497)
            padded = torch.zeros((mx,) + tail, dtype=dtype,
                                 device=self._device if x is None
                                 else x.device)
            if x is not None:
                padded[:x.shape[0]] = x
            g, work = _all_gather_tiled(padded.reshape(-1), n, group)
            work.wait()
            if x is None:
                continue
            g = g.view((n, mx) + tail)
            if dims and len(set(dims)) > 1:
                out[name] = torch.cat([g[r, :dims[r]] for r in range(n)])
            else:
                out[name] = g.reshape((n * mx,) + tail)
        return out

    def _run_broadcast(self, batch, tensors):
        group, _, _, tag = self._batch_ctx(batch)
        inputs = self._materialize(batch, tensors)
        # root_rank is a GLOBAL rank (reference semantics, also for
        # process sets), and so is torch.distributed's src
        root = batch.root_rank
        if tag and root not in tag:
            raise HorovodInternalError(
                f"broadcast root {root} is not a member of process "
                f"set {batch.process_set_id} ({list(tag)})"
            )
        out = {}
        for name, x in zip(batch.names, inputs):
            buf = x.clone()
            dist.broadcast(buf, src=root, group=group)
            if name in tensors:
                out[name] = buf
        return out

    def _run_alltoall(self, batch, tensors):
        group, world, rank, _ = self._batch_ctx(batch)
        m = torch.tensor(batch.all_splits, dtype=torch.int64).reshape(
            world, world)
        send = [int(v) for v in m[rank]]
        recv = [int(v) for v in m[:, rank]]
        dtype = batch_dtype(batch)
        out = {}
        for name in batch.names:
            x = tensors.get(name)
            if x is None:
                # a joined rank's row is all zeros; it still takes part
                x = torch.zeros((0,) + tuple(batch.first_shape[1:]),
                                dtype=dtype, device=self._device)
            x = x.contiguous()
            res = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
            dist.all_to_all_single(res, x, output_split_sizes=recv,
                                   input_split_sizes=send, group=group)
            if name in tensors:
                out[name] = (res, torch.tensor(recv, dtype=torch.int64))
        return out


def make_dist_executor(rank: Optional[int] = None,
                       world: Optional[int] = None,
                       device=None, wire="auto") -> DistExecutor:
    """The data plane of an initialized world: a :class:`DistExecutor`
    on a new process group of every rank (collective: every rank calls
    it, in the same order as its other group creations), on this
    process's device. ``rank``/``world`` default to, and must equal, the
    world's."""
    from ..core.basics import _require_init

    st = _require_init()
    rank = st.rank if rank is None else int(rank)
    world = st.size if world is None else int(world)
    if (rank, world) != (st.rank, st.size):
        raise HorovodInternalError(
            f"native runtime rank {rank} of {world} is not this process's "
            f"rank {st.rank} of {st.size}: the executor indexes the "
            "world's ranks in the controller's order")
    group = dist.new_group(list(range(world)))
    return DistExecutor(rank, world, group,
                        device=st.device if device is None else device,
                        wire=wire)
