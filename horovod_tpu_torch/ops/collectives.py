"""Collectives over the world or a process set.

The counterpart of the JAX package's ``ops/collectives.py``, with the
names and arguments of its ``horovod_tpu/torch`` surface: ``allreduce``
(Average/Sum/Adasum/Min/Max/Product, ``prescale_factor``/
``postscale_factor``), ``grouped_allreduce``, ``allgather`` and
``grouped_allgather`` (the first dimension may differ between ranks),
``broadcast``, ``reducescatter`` and ``grouped_reducescatter`` (Average
or Sum, dim 0 split evenly), ``alltoall`` (equal chunks, or ``splits``
with the received splits returned), ``masked_allreduce``, ``barrier``,
``join``, and the asynchronous forms, which return an integer handle
for ``poll`` and ``synchronize``.

They run on ``torch.distributed`` (NCCL on the card, gloo on the CPU).
``process_set`` restricts a collective to a registered set
(``core/process_sets.py``): it runs on the set's group, Average divides
by the set's size, and ``broadcast``'s ``root_rank`` is a global rank
that must be a member. A rank outside the set sends nothing: the
allreduce family and ``broadcast`` return its input as it is, and the
shape-changing collectives (``allgather``, ``grouped_allgather``,
``reducescatter``, ``alltoall``) raise ``ProcessSetError`` there, as the
reference Horovod refuses a non-member's submission. Each returns a new
tensor and leaves its input alone, except the in-place ``*_`` forms.

``allreduce`` routes sparse slices (``ops/sparse.py``'s IndexedSlices
or a sparse COO tensor) to ``sparse_allreduce``, and ``op=Adasum`` to
``ops/adasum.py``; a collective without sparse semantics refuses sparse
slices. A collective whose peer went away fails in the process group
(gloo's closed socket raises ``RuntimeError``, NCCL's
``DistBackendError``); :func:`lost_peer` turns that into
``HorovodInternalError``, which ``elastic.run`` catches, where the
collective is waited on: ``synchronize``, the blocking forms, and the
optimizers' bucket waits. The private tiled exchanges are
:func:`_all_to_all_tiled`, :func:`_all_gather_tiled` (the int8 wire) and
:func:`_reduce_scatter_tiled` (ZeRO); they run over the world or a
given group.

With the eager negotiation runtime live (``HVD_TPU_NATIVE=1``,
``ops/eager_runtime.py``) a member's collective goes through it, as in
the JAX package (``horovod_tpu/ops/collectives.py:560-600``): it is
enqueued by name (``name``; unnamed calls get ``<op>.noname.<n>``, so
the ranks must issue them in one order), negotiated with the other
ranks, fused and executed by the runtime's executor; the grouped forms
go as one all-or-nothing group. ``allgather`` is then ragged by
negotiation, ``alltoall`` negotiates its splits matrix, ``barrier`` on
the world is negotiated and ``join`` does the join accounting. Adasum
and sparse slices keep their own paths.

Telemetry, as the JAX package's eager dispatch has it
(``horovod_tpu/ops/collectives.py:434-441``, ``:480-498``): every
tensor a member issues is counted once by ``metrics.record_collective``
(op, dtype, bytes), and each collective handed to ``torch.distributed``
is a host span ``XLA_COLLECTIVE`` (its ``tid`` the op) on the timeline.
The private tiled exchanges, which the optimizers run and account for
per step, are neither.
"""

from __future__ import annotations

import contextlib
import enum
import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.basics import _require_init
from ..core.exceptions import (HorovodInternalError, HorovodTpuError,
                               ProcessSetError)
from ..core.process_sets import set_context
from ..optim.compression import Compression
from ..utils import metrics
from ..utils.timeline import XLA_COLLECTIVE, active_timeline
from .sparse import is_sparse


class ReduceOp(enum.IntEnum):
    """Reduction op ids, value-compatible with the reference and the JAX
    package (Average=0, Sum=1, Adasum=2, Min=3, Max=4, Product=5)."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}


def resolve_op(average: Optional[bool], op: Optional[ReduceOp]) -> ReduceOp:
    """``average`` is the deprecated bool alias of Average/Sum."""
    if op is None:
        op = ReduceOp.AVERAGE if (average is None or average) else \
            ReduceOp.SUM
    elif average is not None:
        raise ValueError("specify either average= or op=, not both")
    return ReduceOp(op)


def dist_op(op: ReduceOp):
    """The ``torch.distributed`` op that carries ``op`` (Average is a
    SUM followed by a division; Adasum has none)."""
    return _DIST_OPS[ReduceOp.SUM if op == ReduceOp.AVERAGE else op]


def scale_(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x *= factor`` with the factor in x's dtype, as the JAX package
    scales (an integer tensor's factor is truncated)."""
    if factor != 1.0:
        x.mul_(torch.tensor(factor, dtype=x.dtype, device=x.device))
    return x


def average_(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x /= n`` in x's dtype (integers truncate, as ``astype`` does)."""
    if x.is_floating_point():
        return x.div_(n)
    return x.copy_(torch.div(x, n).to(x.dtype))


def _member_context(process_set, what: str):
    """The set's context; a non-member of a shape-changing collective
    has no defined result and raises."""
    ctx = set_context(process_set)
    if not ctx.member:
        raise ProcessSetError(
            f"{what}: rank {_require_init().rank} is not a member of "
            f"{process_set!r}; only its members may call it")
    return ctx


def _reject_sparse(tensor, what: str) -> None:
    """Collectives without sparse semantics fail loudly: running them
    over sparse slices would mix indices with values."""
    if is_sparse(tensor):
        raise TypeError(
            f"{what} does not accept IndexedSlices or sparse tensors; "
            "sparse tensors reduce via allreduce/sparse_allreduce "
            "(reference tensorflow/__init__.py:56)")


@contextlib.contextmanager
def lost_peer():
    """Raise a process group's failure inside the block as
    ``HorovodInternalError`` (usable as a decorator too). Out-of-memory
    and not-implemented errors, and the package's own, pass as they
    are."""
    try:
        yield
    except (HorovodTpuError, NotImplementedError, torch.OutOfMemoryError):
        raise
    except RuntimeError as e:
        raise HorovodInternalError(f"collective failed: {e}") from e


def _register(finish: Callable[[], object], *works) -> int:
    """A handle for ``finish``, done when every one of ``works`` is."""
    st = _require_init()
    with st.lock:
        h = st.next_handle
        st.next_handle += 1
        st.handles[h] = (works, finish)
    return h


def poll(handle: int) -> bool:
    """True when the collective behind ``handle`` has completed."""
    st = _require_init()
    try:
        works, _ = st.handles[handle]
    except KeyError:
        raise ValueError(f"unknown handle {handle}")
    return all(w.is_completed() for w in works)


@lost_peer()
def synchronize(handle: int):
    """Wait for the collective behind ``handle``; returns its result."""
    st = _require_init()
    with st.lock:
        try:
            _, finish = st.handles.pop(handle)
        except KeyError:
            raise ValueError(f"unknown handle {handle}")
    return finish()


# -- telemetry -----------------------------------------------------------------

def _count(op_kind: str, tensors) -> None:
    """Count each issued tensor (``metrics.record_collective``; its
    dtype as numpy names it)."""
    if not metrics.enabled():
        return
    for t in tensors:
        metrics.record_collective(op_kind, str(t.dtype).split(".")[-1],
                                  t.numel() * t.element_size())


def _span(op_kind: str):
    """The host span around a collective's dispatch."""
    tl = active_timeline()
    if tl is None:
        return contextlib.nullcontext()
    return tl.activity(op_kind, XLA_COLLECTIVE)


# -- the eager negotiation runtime -------------------------------------------

#: op kind -> the controller's op code (``_native`` OP_*)
_NATIVE_OPS = {"allreduce": 0, "allgather": 1, "broadcast": 2,
               "alltoall": 3, "reducescatter": 4}
_AUTO_NAME_COUNTERS: dict = {}


def _auto_name(op_kind: str) -> str:
    """``<op>.noname.<n>``: the ranks name an unnamed collective alike by
    issuing it in the same order."""
    import itertools

    c = _AUTO_NAME_COUNTERS.setdefault(op_kind, itertools.count())
    return f"{op_kind}.noname.{next(c)}"


def _leaf_names(name: Optional[str], n: int, op_kind: str) -> List[str]:
    """Per-tensor names of a call: the first keeps ``name``, later ones
    get ``.k`` suffixes; unnamed tensors get automatic names."""
    if name is None:
        return [_auto_name(op_kind) for _ in range(n)]
    return [name if i == 0 else f"{name}.{i}" for i in range(n)]


def _native_rt(process_set=None):
    """``(runtime, process set id)`` when this collective goes through
    the eager negotiation runtime (``HVD_TPU_NATIVE=1``): a member's
    collective on the world or on a set registered with it; ``(None,
    0)`` otherwise. A non-member keeps the semantics without the
    runtime (its input back, or ``ProcessSetError``)."""
    st = _require_init()
    rt = st.eager_runtime
    if rt is None:
        return None, 0
    ctx = set_context(process_set)
    if not ctx.member:
        return None, 0
    sid = 0 if ctx.group is None else process_set.process_set_id
    if sid and rt.process_set_members(sid) is None:
        raise HorovodInternalError(
            f"process set {sid} is not registered with the native "
            "runtime; call add_process_set on every rank first "
            "(reference process_sets.py:123)")
    return rt, sid


class _NativeWork:
    """The runtime's handles of one call, as a work ``poll`` can ask."""

    def __init__(self, rt, handles):
        self.rt, self.handles = rt, handles

    def is_completed(self) -> bool:
        return all(self.rt.poll(h) for h in self.handles)


def _native_start(rt, op_kind, tensors, op=ReduceOp.SUM, prescale=1.0,
                  postscale=1.0, root_rank=0, name=None, splits=None,
                  grouped=False, process_set_id=0):
    """Enqueue ``tensors`` through the runtime in one batched round
    (``horovod_tpu/ops/collectives.py:1269-1314``): a grouped call tags
    them as one all-or-nothing group (reference group_table.h:25), its
    tag derived from the names so every rank computes the same one.
    Returns ``(works, finish)``; ``finish()`` gives each tensor's
    result in order."""
    import hashlib

    names = _leaf_names(name, len(tensors), op_kind)
    group, group_size = None, 0
    if grouped and len(names) > 1:
        group = hashlib.sha1("|".join(names).encode()).hexdigest()[:16]
        group_size = len(names)
    hs = rt.enqueue_batch([
        dict(name=n, tensor=t.detach(), op=_NATIVE_OPS[op_kind],
             reduce_op=int(op), root_rank=int(root_rank),
             prescale=float(prescale), postscale=float(postscale),
             splits=splits, group=group, group_size=group_size,
             process_set_id=process_set_id)
        for n, t in zip(names, tensors)])

    def finish():
        return [rt.synchronize(h) for h in hs]

    return [_NativeWork(rt, hs)], finish


# -- allreduce ---------------------------------------------------------------

def _two_level(kind: str, op, process_set) -> int:
    """The inner domain's size when the knobs route this collective
    through two levels (``ops/hierarchical.py``): the global set's SUM
    or AVERAGE allreduce, or its allgather (``op`` None); 1 keeps the
    flat route."""
    from .hierarchical import two_level_block

    if op not in (None, ReduceOp.SUM, ReduceOp.AVERAGE):
        return 1
    return two_level_block(kind, process_set)


def _allreduce_start(tensor, average, compression, op, prescale_factor,
                     postscale_factor, process_set, out=None, name=None):
    """Enqueue one allreduce; returns (works, finish)."""
    op = resolve_op(average, op)
    if is_sparse(tensor):
        if op == ReduceOp.ADASUM:
            raise ValueError("adasum does not support sparse "
                             "(IndexedSlices) gradients; use op=Average/Sum")
        if out is not None:
            raise TypeError("an in-place allreduce cannot take sparse "
                            "slices")
        from .sparse import sparse_allreduce

        res = sparse_allreduce(tensor, op=op, process_set=process_set)
        return [], lambda: res
    _require_init()
    ctx = set_context(process_set)
    compression = compression or Compression.none
    if getattr(compression, "kind", "none") == "int8":
        # summing int8 codes would overflow and mix the ranks' scales
        raise ValueError(
            "allreduce cannot carry the int8 wire: use "
            "optim.compression.quantized_psum or the DistributedOptimizer")
    if op == ReduceOp.ADASUM:
        # over the world only: a proper subset raises on every rank
        from .adasum import adasum_allreduce

        _count("allreduce", [tensor])
        wire, wctx = compression.compress(tensor.detach())
        buf = scale_(wire.clone(), prescale_factor)
        red = scale_(adasum_allreduce(buf, process_set=process_set),
                     postscale_factor)
        res = compression.decompress(red, wctx)
        if out is not None:
            res = out.copy_(res)
        return [], lambda: res
    if not ctx.member:
        res = tensor if out is not None else tensor.detach().clone()
        return [], lambda: res
    _count("allreduce", [tensor])
    wire, wctx = compression.compress(tensor.detach())
    rt, sid = _native_rt(process_set)
    if rt is not None:
        works, reduced = _native_start(
            rt, "allreduce", [wire], op, prescale_factor, postscale_factor,
            name=name, process_set_id=sid)

        def finish_native():
            res = compression.decompress(reduced()[0], wctx)
            return res if out is None else out.copy_(res)

        return works, finish_native
    # a private copy: the input is never written (the wire cast may
    # already have made one)
    buf = wire.clone() if wire.data_ptr() == tensor.data_ptr() else wire
    scale_(buf, prescale_factor)
    block = _two_level("allreduce", op, process_set)
    if block > 1:
        # two levels (ops/hierarchical.py); AVERAGE divides the sum
        from .hierarchical import start_hierarchical_psum

        summed, _ = start_hierarchical_psum(buf, block)
        works = []
    else:
        with _span("allreduce"):
            works = [dist.all_reduce(buf, op=dist_op(op), group=ctx.group,
                                     async_op=True)]

        def summed():
            works[0].wait()
            return buf

    def finish():
        red = summed()
        if op == ReduceOp.AVERAGE:
            average_(red, ctx.size)
        scale_(red, postscale_factor)
        res = compression.decompress(red, wctx)
        if out is None:
            return res
        out.copy_(res)
        return out

    return works, finish


@lost_peer()
def allreduce(tensor, average=None, name=None, compression=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0, process_set=None):
    """Reduce ``tensor`` over the set's ranks; returns a new tensor (the
    input itself, copied, on a non-member). ``name`` names it in the
    eager runtime (``HVD_TPU_NATIVE=1``), where the ranks negotiate by
    name; without a name the ranks' calls are paired by order."""
    _, finish = _allreduce_start(tensor, average, compression, op,
                                 prescale_factor, postscale_factor,
                                 process_set, name=name)
    return finish()


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=None) -> int:
    works, finish = _allreduce_start(tensor, average, None, op,
                                     prescale_factor, postscale_factor,
                                     process_set, name=name)
    return _register(finish, *works)


@lost_peer()
def allreduce_(tensor, average=None, name=None, op=None, prescale_factor=1.0,
               postscale_factor=1.0, process_set=None):
    """In-place :func:`allreduce`."""
    _, finish = _allreduce_start(tensor, average, None, op, prescale_factor,
                                 postscale_factor, process_set, out=tensor,
                                 name=name)
    return finish()


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=None) -> int:
    works, finish = _allreduce_start(tensor, average, None, op,
                                     prescale_factor, postscale_factor,
                                     process_set, out=tensor, name=name)
    return _register(finish, *works)


def _by_dtype(tensors) -> dict:
    """Index groups per dtype, in submission order within each."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _grouped_start(tensors, average, op, prescale_factor, postscale_factor,
                   process_set, name=None):
    """One allreduce per dtype over the dense tensors' flat
    concatenation (in order; Adasum combines each concatenation as a
    whole); sparse members reduce one by one through the sparse path.
    With the eager runtime, dense tensors go as one all-or-nothing group
    and the controller fuses them. Returns (works, finish)."""
    op = resolve_op(average, op)
    tensors = list(tensors)
    if tensors and op != ReduceOp.ADASUM and \
            not any(is_sparse(t) for t in tensors):
        rt, sid = _native_rt(process_set)
        if rt is not None:
            _count("allreduce", tensors)
            return _native_start(rt, "allreduce", tensors, op,
                                 prescale_factor, postscale_factor,
                                 name=name, grouped=True,
                                 process_set_id=sid)
    sparse = {i: _allreduce_start(t, None, None, op, 1.0, 1.0,
                                  process_set)[1]
              for i, t in enumerate(tensors) if is_sparse(t)}
    dense = [i for i in range(len(tensors)) if i not in sparse]
    _require_init()
    ctx = set_context(process_set)
    pending = []
    for idxs in _by_dtype([tensors[i] for i in dense]).values():
        idxs = [dense[j] for j in idxs]
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idxs])
        if not ctx.member:
            pending.append((idxs, flat, None))
            continue
        _count("allreduce", [flat])
        scale_(flat, prescale_factor)
        if op == ReduceOp.ADASUM:
            from .adasum import adasum_allreduce

            flat = scale_(adasum_allreduce(flat, process_set=process_set),
                          postscale_factor)
            pending.append((idxs, flat, None))
            continue
        block = _two_level("allreduce", op, process_set)
        if block > 1:
            from .hierarchical import hierarchical_psum

            flat = hierarchical_psum(flat, block)
            if op == ReduceOp.AVERAGE:
                average_(flat, ctx.size)
            pending.append((idxs, scale_(flat, postscale_factor), None))
            continue
        with _span("allreduce"):
            work = dist.all_reduce(flat, op=dist_op(op), group=ctx.group,
                                   async_op=True)
        pending.append((idxs, flat, work))

    def finish():
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for i, fin in sparse.items():
            out[i] = fin()
        for idxs, flat, work in pending:
            if work is not None:
                work.wait()
                if op == ReduceOp.AVERAGE:
                    average_(flat, ctx.size)
                scale_(flat, postscale_factor)
            off = 0
            for i in idxs:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].view(tensors[i].shape)
                off += n
        return out

    return [w for _, _, w in pending if w is not None], finish


@lost_peer()
def grouped_allreduce(tensors: Sequence[torch.Tensor], average=None,
                      name=None, op=None, prescale_factor=1.0,
                      postscale_factor=1.0, process_set=None):
    """Reduce a list of tensors in one collective per dtype (through
    the eager runtime: one negotiated group, fused by the controller)."""
    return _grouped_start(tensors, average, op, prescale_factor,
                          postscale_factor, process_set, name=name)[1]()


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set=None) -> int:
    works, finish = _grouped_start(tensors, average, op, prescale_factor,
                                   postscale_factor, process_set, name=name)
    return _register(finish, *works)


def masked_allreduce(tensor, valid, process_set=None):
    """Average over only the ranks where ``valid`` is true, the SPMD
    form of join: ``Sum(x * valid) / max(Sum(valid), 1)``, the
    reference's join-with-zero-contribution and recount."""
    v = torch.as_tensor(valid, device=tensor.device)
    num = allreduce(tensor * v.to(tensor.dtype), op=Sum,
                    process_set=process_set)
    den = allreduce(v.to(torch.float32), op=Sum, process_set=process_set)
    return (num / den.clamp(min=1.0).to(tensor.dtype)).to(tensor.dtype)


# -- reducescatter -----------------------------------------------------------

# torch 2.13 renames reduce_scatter_tensor to reduce_scatter_single and
# deprecates the old name; torch 2.11 has only the old one. NCCL and
# gloo both run it, so no backend falls back to an allreduce followed by
# a slice
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _reduce_scatter_tiled(flat: torch.Tensor, n: int, group=None):
    """Start a SUM reduce-scatter of a flat contiguous tensor over the
    ``n`` ranks of ``group`` (default: the world): rank r gets the sum
    over the ranks of chunk r (``numel / n`` elements). Returns
    ``(output, work)``."""
    out = flat.new_empty(flat.numel() // n)
    return out, _reduce_scatter_single(out, flat, op=dist.ReduceOp.SUM,
                                       group=group, async_op=True)


def _reducescatter_op(op) -> ReduceOp:
    op = ReduceOp.AVERAGE if op is None else ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("reducescatter supports Sum and Average (as the "
                         "reference: collective_operations.h:342)")
    return op


def _check_dim0(t: torch.Tensor, n: int, what: str) -> None:
    if t.dim() == 0 or t.shape[0] % n:
        d0 = t.shape[0] if t.dim() else "(a scalar)"
        raise HorovodInternalError(
            f"{what} dim0 {d0} not divisible by set size {n}")


def _reducescatter_start(tensors, op, prescale_factor, postscale_factor,
                         process_set, what, name=None):
    """Enqueue one reduce-scatter per dtype over ``tensors``, each split
    into ``n`` chunks along dim 0 and packed rank-major (chunk r of every
    tensor, in order), so that one collective hands set rank r its chunk
    of each. Returns ``(works, finish)``; ``finish()`` gives this rank's
    chunks in the tensors' order."""
    _require_init()
    tensors = list(tensors)
    for t in tensors:
        _reject_sparse(t, what)
    ctx = _member_context(process_set, what)
    op = _reducescatter_op(op)
    n = ctx.size
    for t in tensors:
        _check_dim0(t, n, what)
    rt, sid = _native_rt(process_set)
    if rt is not None:
        _count("reducescatter", tensors)
        return _native_start(rt, "reducescatter", tensors, op,
                             prescale_factor, postscale_factor, name=name,
                             grouped=len(tensors) > 1, process_set_id=sid)
    pending = []
    for idxs in _by_dtype(tensors).values():
        packed = torch.cat([tensors[i].detach().reshape(n, -1)
                            for i in idxs], dim=1).reshape(-1)
        scale_(packed, prescale_factor)  # a new tensor: inputs stay
        _count("reducescatter", [packed])
        with _span("reducescatter"):
            out, work = _reduce_scatter_tiled(packed, n, ctx.group)
        pending.append((idxs, out, work))

    def finish():
        res: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for idxs, out, work in pending:
            work.wait()
            if op == ReduceOp.AVERAGE:
                average_(out, n)
            scale_(out, postscale_factor)
            off = 0
            for i in idxs:
                t = tensors[i]
                m = t.numel() // n
                res[i] = out[off:off + m].view((t.shape[0] // n,)
                                               + tuple(t.shape[1:]))
                off += m
        return res

    return [w for _, _, w in pending], finish


@lost_peer()
def reducescatter(tensor, op=None, name=None, prescale_factor=1.0,
                  postscale_factor=1.0, process_set=None):
    """Reduce ``tensor`` over the set's ranks and scatter dim 0: set
    rank r gets chunk r of ``n`` equal chunks (dim 0 must divide evenly,
    as in the JAX package). ``op`` is Average (default) or Sum; returns
    a new tensor. ``name`` names it in the eager runtime."""
    _, finish = _reducescatter_start([tensor], op, prescale_factor,
                                     postscale_factor, process_set,
                                     "reducescatter", name=name)
    return finish()[0]


def reducescatter_async(tensor, op=None, name=None, prescale_factor=1.0,
                        postscale_factor=1.0, process_set=None) -> int:
    works, finish = _reducescatter_start([tensor], op, prescale_factor,
                                         postscale_factor, process_set,
                                         "reducescatter", name=name)
    return _register(lambda: finish()[0], *works)


@lost_peer()
def grouped_reducescatter(tensors: Sequence[torch.Tensor], op=None,
                          name=None, prescale_factor=1.0,
                          postscale_factor=1.0, process_set=None):
    """Reduce-scatter a list of tensors in one collective per dtype."""
    tensors = list(tensors)
    if not tensors:
        return []
    return _reducescatter_start(tensors, op, prescale_factor,
                                postscale_factor, process_set,
                                "grouped_reducescatter", name=name)[1]()


def grouped_reducescatter_async(tensors, op=None, name=None,
                                prescale_factor=1.0, postscale_factor=1.0,
                                process_set=None) -> int:
    works, finish = _reducescatter_start(
        list(tensors), op, prescale_factor, postscale_factor, process_set,
        "grouped_reducescatter", name=name)
    return _register(finish, *works)


# -- the int8 wire's tiled exchanges -----------------------------------------

def _all_to_all_tiled(x: torch.Tensor, group=None):
    """Start an all-to-all of a flat contiguous tensor over the ranks of
    ``group`` (default: the world): its chunk j (of as many equal chunks
    as ranks) goes to rank j, and the output holds every rank's chunk
    for this rank, in rank order. Returns ``(output, work)``."""
    out = torch.empty_like(x)
    return out, dist.all_to_all_single(out, x, group=group, async_op=True)


# torch 2.13 renames all_gather_into_tensor to all_gather_single and
# deprecates the old name; torch 2.11 has only the old one
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _all_gather_tiled(x: torch.Tensor, n: int, group=None):
    """Start an all-gather of a flat contiguous tensor over the ``n``
    ranks of ``group`` (default: the world): the output is every rank's
    tensor, concatenated in rank order. Returns ``(output, work)``."""
    out = x.new_empty(n * x.numel())
    return out, _all_gather_single(out, x, group=group, async_op=True)


# -- allgather ---------------------------------------------------------------

def _grouped_allgather_start(tensors, process_set, what, name=None):
    """Gather every member's tensors along dim 0 (which may differ
    between ranks): one small all-gather of the dim-0 sizes, then one
    all-gather per dtype of each rank's tensors, flattened,
    concatenated and padded to the longest. Returns (works, finish)."""
    st = _require_init()
    for t in tensors:
        _reject_sparse(t, what)
    tensors = [t.detach() for t in tensors]
    for t in tensors:
        if t.dim() == 0:
            raise HorovodInternalError(f"{what} needs tensors with a dim 0")
    ctx = _member_context(process_set, what)
    rt, sid = _native_rt(process_set)
    if rt is not None:
        # the controller negotiates each rank's dim 0 (ragged)
        _count("allgather", tensors)
        return _native_start(rt, "allgather", tensors, name=name,
                             grouped=len(tensors) > 1, process_set_id=sid)
    n = ctx.size
    mine = torch.tensor([t.shape[0] for t in tensors], dtype=torch.int64,
                        device=st.device)
    rows = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(rows, mine, group=ctx.group)
    sizes = torch.stack(rows).tolist()  # [rank][tensor] dim 0
    pending = []
    for idxs in _by_dtype(tensors).values():
        row = [math.prod(tensors[i].shape[1:]) for i in idxs]
        lengths = [sum(sizes[r][i] * w for i, w in zip(idxs, row))
                   for r in range(n)]
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        longest = max(lengths)
        if flat.numel() < longest:
            flat = torch.cat([flat, flat.new_zeros(longest - flat.numel())])
        parts = [torch.empty_like(flat) for _ in range(n)]
        _count("allgather", [flat])
        with _span("allgather"):
            work = dist.all_gather(parts, flat, group=ctx.group,
                                   async_op=True)
        pending.append((idxs, row, parts, work))

    def finish():
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for idxs, row, parts, work in pending:
            work.wait()
            pieces = {i: [] for i in idxs}
            for r, part in enumerate(parts):
                off = 0
                for i, w in zip(idxs, row):
                    m = sizes[r][i] * w
                    pieces[i].append(part[off:off + m].view(
                        (sizes[r][i],) + tuple(tensors[i].shape[1:])))
                    off += m
            for i in idxs:
                out[i] = torch.cat(pieces[i])
        return out

    return [w for _, _, _, w in pending], finish


@lost_peer()
def allgather(tensor, name=None, process_set=None):
    """Concatenate every member's ``tensor`` along dim 0, in set-rank
    order; the first dimension may differ between ranks. With
    ``HOROVOD_HIERARCHICAL_ALLGATHER`` the global set's gather runs in
    two levels (``ops/hierarchical.py``), to the same result; through
    the eager runtime it is negotiated, ragged."""
    block = _two_level("allgather", None, process_set)
    if block > 1 and _native_rt(process_set)[0] is None:
        from .hierarchical import hierarchical_allgather

        _reject_sparse(tensor, "allgather")
        return hierarchical_allgather(tensor.detach(), block)
    return _grouped_allgather_start([tensor], process_set, "allgather",
                                    name=name)[1]()[0]


def allgather_async(tensor, name=None, process_set=None) -> int:
    works, finish = _grouped_allgather_start([tensor], process_set,
                                             "allgather", name=name)
    return _register(lambda: finish()[0], *works)


@lost_peer()
def grouped_allgather(tensors, name=None, process_set=None):
    """Allgather a list of tensors: one gather per dtype (and one of the
    sizes), dim 0 may differ between ranks."""
    tensors = list(tensors)
    if not tensors:
        return []
    return _grouped_allgather_start(tensors, process_set,
                                    "grouped_allgather", name=name)[1]()


def grouped_allgather_async(tensors, name=None, process_set=None) -> int:
    works, finish = _grouped_allgather_start(list(tensors), process_set,
                                             "grouped_allgather", name=name)
    return _register(finish, *works)


# -- alltoall ----------------------------------------------------------------

def _alltoall_start(tensor, splits, process_set, name=None):
    """Exchange dim-0 chunks between the set's ranks. Equal chunks
    (``splits`` None: dim 0 divides by the set's size), or ``splits[j]``
    rows to set rank j, after an exchange of the split sizes (the JAX
    package's ``alltoall_splits_exchange``). Returns (works, finish)."""
    st = _require_init()
    _reject_sparse(tensor, "alltoall")
    ctx = _member_context(process_set, "alltoall")
    x = tensor.detach().contiguous()
    n = ctx.size
    send = None
    if splits is None:
        _check_dim0(x, n, "alltoall")
    else:
        send = [int(s) for s in
                torch.as_tensor(splits).reshape(-1).tolist()]
        if len(send) != n or min(send) < 0 or sum(send) != x.shape[0]:
            raise HorovodInternalError(
                f"alltoall splits {send} must give each of the {n} ranks "
                f"of the set a count and sum to dim0 {x.shape[0]}")
    _count("alltoall", [x])
    rt, sid = _native_rt(process_set)
    if rt is not None:
        # the controller negotiates the splits matrix
        works, exchanged = _native_start(rt, "alltoall", [x], name=name,
                                         splits=send, process_set_id=sid)

        def finish_native():
            out, recv = exchanged()[0]
            if send is None:
                return out
            return out, recv.to(torch.int32).to(tensor.device)

        return works, finish_native
    if splits is None:
        out = torch.empty_like(x)
        with _span("alltoall"):
            work = dist.all_to_all_single(out, x, group=ctx.group,
                                          async_op=True)

        def finish_equal():
            work.wait()
            return out

        return [work], finish_equal
    sent = torch.tensor(send, dtype=torch.int64, device=st.device)
    got = torch.empty_like(sent)
    dist.all_to_all_single(got, sent, group=ctx.group)
    recv = got.tolist()
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    with _span("alltoall"):
        work = dist.all_to_all_single(out, x, output_split_sizes=recv,
                                      input_split_sizes=send,
                                      group=ctx.group, async_op=True)

    def finish_split():
        work.wait()
        return out, torch.tensor(recv, dtype=torch.int32,
                                 device=tensor.device)

    return [work], finish_split


@lost_peer()
def alltoall(tensor, splits=None, name=None, process_set=None):
    """Exchange dim-0 chunks between the set's ranks (torch/mpi_ops.py
    alltoall): chunk j goes to set rank j, and the result holds the
    chunks for this rank in set-rank order. With ``splits`` (rows for
    each set rank, summing to dim 0) it returns ``(output,
    received_splits)``, the int32 counts received from each rank."""
    return _alltoall_start(tensor, splits, process_set, name=name)[1]()


def alltoall_async(tensor, splits=None, name=None, process_set=None) -> int:
    works, finish = _alltoall_start(tensor, splits, process_set, name=name)
    return _register(finish, *works)


# -- broadcast / barrier / join ----------------------------------------------

def _broadcast_ctx(tensor, root_rank, process_set):
    _require_init()
    _reject_sparse(tensor, "broadcast")
    ctx = set_context(process_set)
    if root_rank not in ctx.ranks:
        raise HorovodInternalError(
            f"broadcast root {root_rank} not in process set {ctx.ranks}")
    return ctx


def broadcast(tensor, root_rank: int = 0, name=None, process_set=None):
    """``root_rank``'s tensor (a global rank, a member of the set) on
    every member; returns a new tensor."""
    _reject_sparse(tensor, "broadcast")
    return broadcast_(tensor.detach().clone(), root_rank, name=name,
                      process_set=process_set)


def _broadcast_start(buf, root_rank, process_set, name=None):
    """Start the broadcast of ``buf`` in place; returns (works,
    finish)."""
    ctx = _broadcast_ctx(buf, root_rank, process_set)
    if not ctx.member:
        return [], lambda: buf
    _count("broadcast", [buf])
    rt, sid = _native_rt(process_set)
    if rt is not None:
        works, received = _native_start(rt, "broadcast", [buf],
                                        root_rank=root_rank, name=name,
                                        process_set_id=sid)
        return works, lambda: buf.copy_(received()[0])
    with _span("broadcast"):
        work = dist.broadcast(buf, src=root_rank, group=ctx.group,
                              async_op=True)

    def finish():
        work.wait()
        return buf

    return [work], finish


@lost_peer()
def broadcast_(tensor, root_rank: int = 0, name=None, process_set=None):
    """In-place :func:`broadcast`."""
    return _broadcast_start(tensor, root_rank, process_set, name)[1]()


def broadcast_async(tensor, root_rank: int = 0, name=None,
                    process_set=None) -> int:
    _reject_sparse(tensor, "broadcast")
    works, finish = _broadcast_start(tensor.detach().clone(), root_rank,
                                     process_set, name)
    return _register(finish, *works)


def broadcast_async_(tensor, root_rank: int = 0, name=None,
                     process_set=None) -> int:
    works, finish = _broadcast_start(tensor, root_rank, process_set, name)
    return _register(finish, *works)


@lost_peer()
def barrier(process_set=None) -> None:
    """Block until every member of the set arrives (a non-member
    returns at once). With the eager runtime the world's barrier is
    negotiated, so it cannot overtake a collective enqueued before it
    (``horovod_tpu/ops/collectives.py:1181-1184``)."""
    st = _require_init()
    ctx = set_context(process_set)
    if st.eager_runtime is not None and ctx.group is None:
        st.eager_runtime.barrier()
        return
    if ctx.member:
        dist.barrier(group=ctx.group)


@lost_peer()
def join(device=None) -> int:
    """Ragged-end data parallelism (torch/mpi_ops.py:1250, JoinOp
    collective_operations.h:325). With the eager runtime
    (``HVD_TPU_NATIVE=1``) a rank that ran out of data joins: the
    collectives still pending on the other ranks complete with zeros
    from it, and the call returns once every rank has joined. Without
    the runtime it is a barrier over the world, and uneven data is
    handled inside the step with :func:`masked_allreduce`. Returns 0
    either way, as the JAX package does
    (``horovod_tpu/ops/eager_runtime.py:1112-1129``)."""
    del device
    rt = _require_init().eager_runtime
    if rt is not None:
        return rt.join_sync()
    barrier()
    return 0
