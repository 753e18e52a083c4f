"""Collectives over the world's process group.

The counterpart of the JAX package's ``ops/collectives.py``, with the
names and arguments of its ``horovod_tpu/torch`` surface: ``allreduce``
(Average/Sum/Min/Max/Product, ``prescale_factor``/``postscale_factor``),
``grouped_allreduce``, ``allgather`` (the first dimension may differ
between ranks), ``broadcast``, ``barrier``, and the asynchronous forms,
which return an integer handle for ``poll`` and ``synchronize``.

They run on ``torch.distributed`` (NCCL on the card, gloo on the CPU)
over every rank; the only process set is the global one. Each returns a
new tensor and leaves its input alone, except the in-place ``*_``
forms. ``reducescatter`` and ``grouped_reducescatter`` (Average or Sum,
dim 0 split evenly over the ranks) and their asynchronous forms are
here too; ``alltoall``, ``join`` and Adasum are not ported yet (ROADMAP
item 2). The private tiled exchanges are :func:`_all_to_all_tiled`,
:func:`_all_gather_tiled` (the int8 wire) and
:func:`_reduce_scatter_tiled` (ZeRO).
"""

from __future__ import annotations

import enum
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.basics import _require_init
from ..core.exceptions import HorovodInternalError
from ..core.process_sets import require_global
from ..optim.compression import Compression


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
    op = ReduceOp(op)
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP item 2)")
    return op


def dist_op(op: ReduceOp):
    """The ``torch.distributed`` op that carries ``op`` (Average is a
    SUM followed by a division)."""
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


def synchronize(handle: int):
    """Wait for the collective behind ``handle``; returns its result."""
    st = _require_init()
    with st.lock:
        try:
            _, finish = st.handles.pop(handle)
        except KeyError:
            raise ValueError(f"unknown handle {handle}")
    return finish()


# -- allreduce ---------------------------------------------------------------

def _allreduce_start(tensor, average, compression, op, prescale_factor,
                     postscale_factor, process_set, out=None):
    """Enqueue one allreduce; returns (work, finish)."""
    st = _require_init()
    require_global(process_set)
    op = resolve_op(average, op)
    compression = compression or Compression.none
    if getattr(compression, "kind", "none") == "int8":
        # summing int8 codes would overflow and mix the ranks' scales
        raise ValueError(
            "allreduce cannot carry the int8 wire: use "
            "optim.compression.quantized_psum or the DistributedOptimizer")
    wire, ctx = compression.compress(tensor.detach())
    # a private copy: the input is never written (the wire cast may
    # already have made one)
    buf = wire.clone() if wire.data_ptr() == tensor.data_ptr() else wire
    scale_(buf, prescale_factor)
    work = dist.all_reduce(buf, op=dist_op(op), async_op=True)

    def finish():
        work.wait()
        if op == ReduceOp.AVERAGE:
            average_(buf, st.size)
        scale_(buf, postscale_factor)
        res = compression.decompress(buf, ctx)
        if out is None:
            return res
        out.copy_(res)
        return out

    return work, finish


def allreduce(tensor, average=None, name=None, compression=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0, process_set=None):
    """Reduce ``tensor`` over every rank; returns a new tensor. ``name``
    is accepted for parity and unused."""
    del name
    _, finish = _allreduce_start(tensor, average, compression, op,
                                 prescale_factor, postscale_factor,
                                 process_set)
    return finish()


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=None) -> int:
    del name
    work, finish = _allreduce_start(tensor, average, None, op,
                                    prescale_factor, postscale_factor,
                                    process_set)
    return _register(finish, work)


def allreduce_(tensor, average=None, name=None, op=None, prescale_factor=1.0,
               postscale_factor=1.0, process_set=None):
    """In-place :func:`allreduce`."""
    del name
    _, finish = _allreduce_start(tensor, average, None, op, prescale_factor,
                                 postscale_factor, process_set, out=tensor)
    return finish()


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=None) -> int:
    del name
    work, finish = _allreduce_start(tensor, average, None, op,
                                    prescale_factor, postscale_factor,
                                    process_set, out=tensor)
    return _register(finish, work)


def _grouped_start(tensors, average, op, process_set):
    """One allreduce per dtype over the tensors' flat concatenation
    (in order); returns (works, finish)."""
    st = _require_init()
    require_global(process_set)
    op = resolve_op(average, op)
    tensors = list(tensors)
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    pending = []
    for idxs in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idxs])
        pending.append((idxs, flat,
                        dist.all_reduce(flat, op=dist_op(op),
                                        async_op=True)))

    def finish():
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for idxs, flat, work in pending:
            work.wait()
            if op == ReduceOp.AVERAGE:
                average_(flat, st.size)
            off = 0
            for i in idxs:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].view(tensors[i].shape)
                off += n
        return out

    return [w for _, _, w in pending], finish


def grouped_allreduce(tensors: Sequence[torch.Tensor], average=None,
                      name=None, op=None, process_set=None):
    """Reduce a list of tensors in one collective per dtype."""
    del name
    return _grouped_start(tensors, average, op, process_set)[1]()


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            process_set=None) -> int:
    del name
    works, finish = _grouped_start(tensors, average, op, process_set)
    return _register(finish, *works)


# -- reducescatter ------------------------------------------------------------

# torch 2.13 renames reduce_scatter_tensor to reduce_scatter_single and
# deprecates the old name; torch 2.11 has only the old one. NCCL and
# gloo both run it, so no backend falls back to an allreduce followed by
# a slice
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _reduce_scatter_tiled(flat: torch.Tensor, n: int):
    """Start a SUM reduce-scatter of a flat contiguous tensor over the
    world's ``n`` ranks: rank r gets the sum over the ranks of chunk r
    (``numel / n`` elements). Returns ``(output, work)``."""
    out = flat.new_empty(flat.numel() // n)
    return out, _reduce_scatter_single(out, flat, op=dist.ReduceOp.SUM,
                                       async_op=True)


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
                         process_set, what):
    """Enqueue one reduce-scatter per dtype over ``tensors``, each split
    into ``n`` chunks along dim 0 and packed rank-major (chunk r of every
    tensor, in order), so that one collective hands rank r its chunk of
    each. Returns ``(works, finish)``; ``finish()`` gives this rank's
    chunks in the tensors' order."""
    st = _require_init()
    require_global(process_set)
    op = _reducescatter_op(op)
    n = st.size
    tensors = list(tensors)
    for t in tensors:
        _check_dim0(t, n, what)
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    pending = []
    for idxs in groups.values():
        packed = torch.cat([tensors[i].detach().reshape(n, -1)
                            for i in idxs], dim=1).reshape(-1)
        scale_(packed, prescale_factor)  # a new tensor: inputs stay
        out, work = _reduce_scatter_tiled(packed, n)
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


def reducescatter(tensor, op=None, name=None, prescale_factor=1.0,
                  postscale_factor=1.0, process_set=None):
    """Reduce ``tensor`` over every rank and scatter dim 0: rank r gets
    chunk r of ``size()`` equal chunks (dim 0 must divide evenly, as in
    the JAX package). ``op`` is Average (default) or Sum; returns a new
    tensor. ``name`` is accepted for parity and unused."""
    del name
    _, finish = _reducescatter_start([tensor], op, prescale_factor,
                                     postscale_factor, process_set,
                                     "reducescatter")
    return finish()[0]


def reducescatter_async(tensor, op=None, name=None, prescale_factor=1.0,
                        postscale_factor=1.0, process_set=None) -> int:
    del name
    works, finish = _reducescatter_start([tensor], op, prescale_factor,
                                         postscale_factor, process_set,
                                         "reducescatter")
    return _register(lambda: finish()[0], *works)


def grouped_reducescatter(tensors: Sequence[torch.Tensor], op=None,
                          name=None, prescale_factor=1.0,
                          postscale_factor=1.0, process_set=None):
    """Reduce-scatter a list of tensors in one collective per dtype."""
    del name
    tensors = list(tensors)
    if not tensors:
        return []
    return _reducescatter_start(tensors, op, prescale_factor,
                                postscale_factor, process_set,
                                "grouped_reducescatter")[1]()


def grouped_reducescatter_async(tensors, op=None, name=None,
                                prescale_factor=1.0, postscale_factor=1.0,
                                process_set=None) -> int:
    del name
    works, finish = _reducescatter_start(
        tensors, op, prescale_factor, postscale_factor, process_set,
        "grouped_reducescatter")
    return _register(finish, *works)


# -- the int8 wire's tiled exchanges -----------------------------------------

def _all_to_all_tiled(x: torch.Tensor):
    """Start an all-to-all of a flat contiguous tensor over the world: its
    chunk j (of ``size`` equal chunks) goes to rank j, and the output
    holds every rank's chunk for this rank, in rank order. Returns
    ``(output, work)``."""
    out = torch.empty_like(x)
    return out, dist.all_to_all_single(out, x, async_op=True)


# torch 2.13 renames all_gather_into_tensor to all_gather_single and
# deprecates the old name; torch 2.11 has only the old one
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _all_gather_tiled(x: torch.Tensor, n: int):
    """Start an all-gather of a flat contiguous tensor over the world's
    ``n`` ranks: the output is every rank's tensor, concatenated in rank
    order. Returns ``(output, work)``."""
    out = x.new_empty(n * x.numel())
    return out, _all_gather_single(out, x, async_op=True)


# -- allgather / broadcast / barrier ------------------------------------------

def allgather(tensor, name=None, process_set=None):
    """Concatenate every rank's ``tensor`` along dim 0, in rank order;
    the first dimension may differ between ranks."""
    del name
    st = _require_init()
    require_global(process_set)
    t = tensor.detach().contiguous()
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = [torch.empty_like(n) for _ in range(st.size)]
    dist.all_gather(sizes, n)
    sizes = [int(s.item()) for s in sizes]
    longest = max(sizes)
    if t.shape[0] < longest:
        pad = t.new_zeros((longest - t.shape[0],) + tuple(t.shape[1:]))
        t = torch.cat([t, pad])
    parts = [torch.empty_like(t) for _ in range(st.size)]
    dist.all_gather(parts, t)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def allgather_async(tensor, name=None, process_set=None) -> int:
    out = allgather(tensor, name=name, process_set=process_set)
    return _register(lambda: out)


def broadcast(tensor, root_rank: int = 0, name=None, process_set=None):
    """``root_rank``'s tensor on every rank; returns a new tensor."""
    del name
    return broadcast_(tensor.detach().clone(), root_rank,
                      process_set=process_set)


def broadcast_(tensor, root_rank: int = 0, name=None, process_set=None):
    """In-place :func:`broadcast`."""
    del name
    _require_init()
    require_global(process_set)
    dist.broadcast(tensor, src=root_rank)
    return tensor


def broadcast_async(tensor, root_rank: int = 0, name=None,
                    process_set=None) -> int:
    del name
    _require_init()
    require_global(process_set)
    buf = tensor.detach().clone()
    work = dist.broadcast(buf, src=root_rank, async_op=True)

    def finish():
        work.wait()
        return buf

    return _register(finish, work)


def broadcast_async_(tensor, root_rank: int = 0, name=None,
                     process_set=None) -> int:
    del name
    _require_init()
    require_global(process_set)
    work = dist.broadcast(tensor, src=root_rank, async_op=True)

    def finish():
        work.wait()
        return tensor

    return _register(finish, work)


def barrier(process_set=None) -> None:
    _require_init()
    require_global(process_set)
    dist.barrier()
