"""Ulysses (DeepSpeed-style) sequence parallelism via all-to-all.

The counterpart of the JAX package's ``parallel/ulysses.py``. The sp
ranks hold sequence spans ``[B, T/n, H, D]``; one all-to-all
re-partitions them to ``[B, T, H/n, D]`` (the whole sequence, a group
of heads), each rank attends its heads exactly, and the inverse
all-to-all restores the spans. Two all-to-alls an attention against
the ring's n hops. The local attention is the port's flash attention
(B1-B3) on the card and ``dot_product_attention`` on the CPU.

``padded_alltoall`` is the uneven-splits all-to-all with a static
per-peer budget, as the JAX package spells it.
"""

from __future__ import annotations

import torch

from ..core.exceptions import HorovodInternalError
from ..models.transformer import dot_product_attention
from ..ops.flash_attention import flash_attention


class _AllToAll(torch.autograd.Function):
    """Split ``x`` into ``comm.size`` chunks along ``split``, chunk j to
    rank j, and concatenate what arrives along ``cat`` in rank order
    (a tiled all-to-all); the backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, comm, split, cat):
        ctx.args = (comm, split, cat)
        return _all_to_all(x, comm, split, cat)

    @staticmethod
    def backward(ctx, g):
        comm, split, cat = ctx.args
        return _all_to_all(g, comm, cat, split), None, None, None


def _all_to_all(x, comm, split, cat):
    chunks = [c.contiguous() for c in x.chunk(comm.size, dim=split)]
    return torch.cat(comm.all_to_all(chunks), dim=cat)


def ulysses_attention(q, k, v, *, comm, causal: bool = True):
    """``[B, T/n, H, D]`` spans -> exact attention -> ``[B, T/n, H,
    D]``. ``comm``: the sp axis's communicator. The heads must divide
    by n; kv heads that do not are repeated to the query heads first
    (the only repeat factor that divides evenly)."""
    if comm is None:
        raise HorovodInternalError("ulysses_attention needs the sp axis's "
                                   "communicator")
    n = comm.size
    h = q.shape[2]
    if h % n:
        raise HorovodInternalError(
            f"ulysses requires heads ({h}) divisible by sp size ({n})")
    kh = k.shape[2]
    if kh % n:
        k = torch.repeat_interleave(k, h // kh, dim=2)
        v = torch.repeat_interleave(v, h // kh, dim=2)
    qg, kg, vg = (_AllToAll.apply(x, comm, 2, 1) for x in (q, k, v))
    if qg.is_cuda:
        out = flash_attention(qg, kg, vg, causal=causal)
    else:
        out = dot_product_attention(qg, kg, vg, causal=causal)
    return _AllToAll.apply(out, comm, 1, 2)


def make_ulysses_attention_fn(comm, causal: bool = True):
    """``attention_fn`` for ``models.transformer.Transformer``: Ulysses
    attention over ``comm`` (the sp axis's communicator)."""

    def fn(q, k, v):
        return ulysses_attention(q, k, v, comm=comm, causal=causal)

    return fn


def padded_alltoall(x, splits, max_split: int, *, comm):
    """Uneven all-to-all with a static per-peer budget: ``splits[j]``
    rows of ``x`` (in order) go to peer j, padded to ``max_split``;
    returns ``(received [n * max_split, ...], received_splits [n])``,
    rows past ``received_splits[j]`` in peer j's block being padding
    (zeros)."""
    n = comm.size
    splits = torch.as_tensor(splits, dtype=torch.int32, device=x.device)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32,
                                     device=x.device),
                         torch.cumsum(splits, 0)[:-1].to(torch.int32)])
    rest = tuple(x.shape[1:])
    arange = torch.arange(max_split, device=x.device)
    rows = offsets[:, None] + arange[None, :]
    valid = arange[None, :] < splits[:, None]
    safe = rows.clamp(0, x.shape[0] - 1).reshape(-1).long()
    gathered = x[safe].reshape((n, max_split) + rest)
    buf = torch.where(valid.reshape((n, max_split) + (1,) * len(rest)),
                      gathered, torch.zeros_like(gathered))
    received = comm.all_to_all([buf[j] for j in range(n)])
    got = comm.all_to_all([splits[j:j + 1] for j in range(n)])
    return (torch.cat(received).reshape((n * max_split,) + rest),
            torch.cat(got))
