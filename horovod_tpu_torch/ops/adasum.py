"""Adasum: adaptive summation allreduce.

The counterpart of the JAX package's ``ops/adasum.py`` (reference
adasum.h:38): recursive doubling, where each combine of two partial
gradients a, b is

    adasum(a, b) = (1 - a.b / (2 |a|^2)) a + (1 - a.b / (2 |b|^2)) b

with the dot and the squared norms in float32 and the result in a's
dtype. Adasum needs no learning-rate scaling by the world size.

At distance d = 1, 2, 4, ... rank r exchanges its partial with rank
``r ^ d`` (one ``dist.batch_isend_irecv`` of a send and a receive a
level, on the world's group) and combines. Every rank issues the same
sequence of exchanges. ``adasum_combine(a, b)`` equals
``adasum_combine(b, a)`` bit for bit: the dot comes from the same
elementwise products on both sides, each norm from the same values,
and the two scaled terms are added, which commutes; so the two partners
of a level hold the same partial after it, and every rank ends with the
same bits. :func:`emulated_adasum` composes the same stages for ranks
emulated on one device, with indexing as the exchange.

:func:`hierarchical_adasum` mirrors the GPU variant of the reference
(adasum_gpu_operations.cc): reduce-scatter and average within a node,
Adasum across nodes, all-gather within the node. Nodes are ranks with
equal ``r // local_size``; the two families of process sets are made
with ``add_or_get_process_set``, so calling it is collective.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.basics import _require_init
from ..core.exceptions import HorovodInternalError


def adasum_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One Adasum combine in float32 accumulation (adasum.h:102
    DispatchComputeDotAndNormSqrds + ScaledAdd); a zero-norm operand
    keeps its coefficient at 1. Returns a new tensor in a's dtype."""
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    dot = (af * bf).sum()
    na = (af * af).sum()
    nb = (bf * bf).sum()
    one = torch.ones((), dtype=torch.float32, device=af.device)
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * torch.where(na > 0, na, one)),
                     one)
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * torch.where(nb > 0, nb, one)),
                     one)
    return ((ca * af) + (cb * bf)).to(a.dtype)


def adasum_distances(n: int) -> List[int]:
    """The levels' distances 1, 2, 4, ... < n of a power-of-two ``n``."""
    if n < 1 or n & (n - 1):
        raise HorovodInternalError(
            f"adasum requires a power-of-two world, got {n}; use "
            "op=Average or a power-of-two number of ranks")
    out, d = [], 1
    while d < n:
        out.append(d)
        d *= 2
    return out


def emulated_adasum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Adasum over ranks emulated on one device: ``parts[r]`` is rank
    r's tensor; at each level rank r combines its partial with rank
    ``r ^ d``'s, as :func:`adasum_allreduce` does over the world.
    Returns every rank's result."""
    parts = list(parts)
    for d in adasum_distances(len(parts)):
        parts = [adasum_combine(parts[r], parts[r ^ d])
                 for r in range(len(parts))]
    return parts


def _start_exchange(x: torch.Tensor, peer: int):
    """Send ``x`` to global rank ``peer`` and receive its tensor of the
    same shape, in one batch. Returns ``(received, works)``."""
    recv = torch.empty_like(x)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                    dist.P2POp(dist.irecv, recv, peer)])
    return recv, works


def start_adasum(x: torch.Tensor,
                 ranks: Optional[Sequence[int]] = None
                 ) -> Callable[[], torch.Tensor]:
    """Start this rank's Adasum of ``x`` over the global ``ranks``
    (default: the world; a power of two of them, this rank among them):
    the first level's exchange is issued now, and ``finish()`` waits
    for it, combines, and runs the remaining levels. Every rank of
    ``ranks`` must start and finish the same tensors in the same
    order."""
    st = _require_init()
    ranks = list(range(st.size)) if ranks is None else list(ranks)
    levels = adasum_distances(len(ranks))
    me = ranks.index(st.rank)
    a = x.detach().contiguous()
    if not levels:
        return lambda: a
    recv, works = _start_exchange(a, ranks[me ^ levels[0]])

    def finish():
        for w in works:
            w.wait()
        out = adasum_combine(a, recv)
        for d in levels[1:]:
            b, ws = _start_exchange(out, ranks[me ^ d])
            for w in ws:
                w.wait()
            out = adasum_combine(out, b)
        return out

    return finish


def require_world(process_set) -> None:
    """Raise unless ``process_set`` is the world (None or every rank)
    and the world is a power of two, as the JAX package's
    ``adasum_allreduce`` does."""
    from ..core.process_sets import set_context

    ctx = set_context(process_set)
    if ctx.group is not None:
        raise HorovodInternalError(
            "adasum over a process subset is not supported: Adasum runs "
            "over the whole world (hierarchical_adasum reduces within "
            "nodes first)")
    adasum_distances(ctx.size)


def adasum_allreduce(x: torch.Tensor, process_set=None) -> torch.Tensor:
    """Adasum-reduce ``x`` over every rank (a power-of-two world).
    Returns a new tensor in x's dtype, the same bits on every rank."""
    require_world(process_set)
    return start_adasum(x)()


def hierarchical_adasum(x: torch.Tensor,
                        local_size: Optional[int] = None) -> torch.Tensor:
    """Node-then-world Adasum (adasum_gpu_operations.cc analog):

      1. reduce-scatter dim 0 and average within the node;
      2. Adasum of the shard across the nodes (ranks with equal
         ``r % local_size``);
      3. all-gather the shards within the node.

    ``local_size`` (default: this process's ``local_size()``) ranks form
    a node, ranks ``r`` with equal ``r // local_size``; dim 0 must
    divide by it and the number of nodes must be a power of two.
    Collective: it registers (or finds) the nodes' and the cross-node
    process sets on every rank."""
    from .collectives import Sum, allgather, reducescatter
    from .hierarchical import block_sets

    st = _require_init()
    nloc = st.local_size if local_size is None else int(local_size)
    if nloc < 1 or st.size % nloc:
        raise HorovodInternalError(
            f"hierarchical_adasum: local size {nloc} does not divide the "
            f"world of {st.size}")
    if x.dim() == 0 or x.shape[0] % nloc:
        d0 = x.shape[0] if x.dim() else "(a scalar)"
        raise HorovodInternalError(
            f"hierarchical_adasum: dim0 {d0} % local size {nloc} != 0")
    adasum_distances(st.size // nloc)
    node, cross = block_sets(nloc)
    shard = reducescatter(x, op=Sum, process_set=node)
    shard = (shard / nloc).to(x.dtype)
    shard = start_adasum(shard, cross.ranks)()
    return allgather(shard, process_set=node)
