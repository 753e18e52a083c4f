"""Tensor parallelism: the exchanges of a tp group, as autograd functions.

In the JAX package XLA's SPMD partitioner reads the parameters'
shardings (``parallel/sharding.py``) and inserts these collectives
itself; the port has no partitioner, so this module stands in for it,
Megatron style. Each rank of a tp group holds its slice of every split
parameter; activations outside the parallel regions (the residual
stream, the norms, a replicated vocab) are whole and the same on every
rank. A region opens with :meth:`TensorParallel.copy_in` (identity
forward, all-reduce of the gradient backward) before a layer whose
output dimension is split (q/k/v, fc1/gate/up, a vocab-split head), and
closes with :meth:`TensorParallel.reduce_out` (all-reduce forward,
identity backward) after a layer whose contracted dimension is split
(``attn.out``, ``fc2``), before its bias. A parameter left whole then
gets the same gradient on every rank through this pair, with no
exchange of its own, except where it is read inside a region: a whole
bias of a split layer, and whole k/v kernels beside split query heads
(GQA with ``kv_heads`` not divisible by tp), enter the region through
``copy_in`` too, so their gradient is summed over the ranks.

The vocab-split embedding looks up the rows this rank holds (the others
masked to 0) and all-reduces, which is exact: one rank contributes each
row. The vocab-split head's logits are gathered along the vocab.

The all-reduce is the communicator's (``parallel/comm.py``): the ranks'
tensors summed in rank order, in float32, rounded once.
"""

from __future__ import annotations

import torch


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous()), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """Concatenate the ranks' tensors along the last dimension; the
    backward keeps this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm, ctx.width = comm, x.shape[-1]
        return torch.cat(comm.all_gather(x.contiguous()), dim=-1)

    @staticmethod
    def backward(ctx, g):
        w, r = ctx.width, ctx.comm.rank
        return g[..., r * w:(r + 1) * w], None


class TensorParallel:
    """The exchanges of this rank's tp group over ``comm`` (a
    communicator of ``parallel/comm.py``; ``rank`` and ``size`` are its
    own). The model's modules hold it as their ``tp``
    (:func:`parallelize`)."""

    def __init__(self, comm):
        self.comm = comm
        self.rank, self.size = comm.rank, comm.size

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.comm)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self.comm)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherLast.apply(x, self.comm)

    def local(self, full: torch.Tensor, shape) -> torch.Tensor:
        """This rank's chunk of ``full`` along the one dimension where
        ``shape`` (the local shape) is smaller."""
        dim = next(d for d, (a, b) in enumerate(zip(full.shape, shape))
                   if a != b)
        n = shape[dim]
        return full.narrow(dim, self.rank * n, n)

    def local_bias(self, bias: torch.Tensor, shape) -> torch.Tensor:
        """A whole bias read by a layer whose output is split: its chunk
        for this rank, entered through :meth:`copy_in`."""
        return self.local(self.copy_in(bias), tuple(shape))

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """Rows of a vocab-split ``table`` (``[V / tp, C]``, this rank's
        ``[rank * V/tp, (rank + 1) * V/tp)``) for ``tokens``: the rows
        held here, 0 elsewhere, all-reduced (exact: one rank holds each
        row)."""
        n = table.shape[0]
        # a negative id reads from the end of the vocab, as in the whole
        # table's lookup
        tokens = torch.where(tokens < 0, tokens + n * self.size, tokens)
        local = tokens - self.rank * n
        held = (local >= 0) & (local < n)
        rows = table[torch.where(held, local, torch.zeros_like(local))]
        rows = torch.where(held[..., None], rows, torch.zeros_like(rows))
        return self.reduce_out(rows)


def parallelize(model, tp: TensorParallel) -> None:
    """Hand ``tp`` to the transformer's modules that read split
    parameters: the model (embedding, head), each block's attention and
    MLP. Their forward derives the local heads and width from the
    parameters' shapes."""
    model.tp = tp
    for block in model.blocks:
        block.attn.tp = tp
        block.mlp.tp = tp
