"""Ring attention: sequence-parallel exact attention over the sp ring.

The counterpart of the JAX package's ``parallel/ring_attention.py``.
Each sp rank holds a sequence span ``[B, T/n, H, D]``; the key/value
spans rotate around the ring (``send_recv``: one neighbour hop a
step) while each rank attends its queries to the span it holds, and
the spans' results merge exactly by their float32 log-sum-exp: the
online softmax over blocks (Liu et al., Ring Attention).

Each block is the flash-attention forward at global positions:
``query_offset = rank * T/n``, ``key_offset = src * T/n`` for the span
that came from rank ``src``. On the card that is the hand-written
kernel B1 (``csrc/flash_fwd.cu``); on the CPU its plain version
(``ops/flash_attention.flash_attention_ref``), the online-softmax update
of one block in closed form. Under the causal mask a span from a later
rank is masked whole: the JAX loop computes it masked, which adds zero,
and the port skips its launch, so rank r runs r + 1 blocks.

The backward runs B2 (dQ) and B3 (dK, dV) per block, on the card, or
their plain version, against the merged lse and ``delta = rowsum(dO *
O)``: the flash backward split over key blocks. The spans rotate again
and each span's dK/dV accumulator travels with it, gathering every
rank's contribution in ring order, and one more hop hands it to its
owner. dQ and the accumulators sum the blocks' results in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.exceptions import HorovodInternalError
from ..ops.flash_attention import flash_bwd, flash_fwd


def _blocks(rank: int, n: int, causal: bool):
    """``(step, src)`` of the ring: at step s this rank holds the span
    of rank ``(rank - s) % n``; ``visible`` is False for a span the
    causal mask empties."""
    for s in range(n):
        src = (rank - s) % n
        yield s, src, not (causal and src > rank)


class _RingFn(torch.autograd.Function):
    """``[B, H, T/n, D]`` ring attention of one sp rank."""

    @staticmethod
    def forward(ctx, q, k, v, comm, causal, scale, q_start):
        t = q.shape[2]
        kv = torch.stack([k, v])
        out = lse = None
        for s, src, visible in _blocks(comm.rank, comm.size, causal):
            if s:
                kv = comm.send_recv(kv)
            if not visible:
                continue
            o_s, lse_s = flash_fwd(q, kv[0], kv[1], causal, scale, q_start,
                                   src * t)
            o_s = o_s.to(torch.float32)
            if out is None:
                out, lse = o_s, lse_s
                continue
            new = torch.logaddexp(lse, lse_s)
            out = (out * torch.exp(lse - new)[..., None]
                   + o_s * torch.exp(lse_s - new)[..., None])
            lse = new
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (comm, causal, scale, q_start)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        comm, causal, scale, q_start = ctx.args
        t = q.shape[2]
        dout = dout.to(q.dtype).contiguous()
        delta = torch.sum(dout.to(torch.float32) * out.to(torch.float32),
                          dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for s, src, visible in _blocks(comm.rank, comm.size, causal):
            if s:
                kv = comm.send_recv(kv)
                dkv = comm.send_recv(dkv)
            if not visible:
                continue
            dq_s, dk_s, dv_s = flash_bwd(q, kv[0], kv[1], dout, lse, delta,
                                         causal, scale, q_start, src * t)
            dq = dq + dq_s.to(torch.float32)
            dkv = dkv + torch.stack([dk_s, dv_s]).to(torch.float32)
        if comm.size > 1:
            dkv = comm.send_recv(dkv)  # to the span's owner
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, *, comm, causal: bool = True,
                   query_offset: Optional[int] = None):
    """Exact attention over sequence spans, rotating k/v on the ring.

    ``q``, ``k``, ``v``: ``[B, T/n, H, D]``, this rank's span (kv heads
    may be fewer: the GQA repeat applies locally, as in the JAX
    package). ``comm``: the sp axis's communicator
    (``Mesh.comm("sp")``). ``causal`` masks on global positions;
    ``query_offset`` is this span's first global position, default
    ``rank * T/n`` (contiguous spans; the keys' spans are taken
    contiguous too). Returns ``[B, T/n, H, D]``."""
    if comm is None:
        raise HorovodInternalError("ring_attention needs the sp axis's "
                                   "communicator")
    h, kh = q.shape[2], k.shape[2]
    if kh != h:
        k = torch.repeat_interleave(k, h // kh, dim=2)
        v = torch.repeat_interleave(v, h // kh, dim=2)
    t = q.shape[1]
    start = comm.rank * t if query_offset is None else int(query_offset)
    scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = _RingFn.apply(q, k, v, comm, bool(causal), scale, start)
    return out.transpose(1, 2)


def make_ring_attention_fn(comm, causal: bool = True):
    """``attention_fn`` for ``models.transformer.Transformer``: ring
    attention over ``comm`` (the sp axis's communicator)."""

    def fn(q, k, v):
        return ring_attention(q, k, v, comm=comm, causal=causal)

    return fn
