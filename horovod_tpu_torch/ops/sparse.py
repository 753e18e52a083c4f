"""Sparse (IndexedSlices) gradient allreduce.

The counterpart of the JAX package's ``ops/sparse.py``: an allreduce of
sparse slices gathers every rank's values and indices (reference
tensorflow/__init__.py:56, torch/mpi_ops.py:556) and keeps duplicate
indices; it is a sparse SUM of the ranks' slices, and Average divides
the values by the set's size. Min and Max have no sparse meaning and
raise.

Torch's sparse COO tensors sparse on dim 0 (an ``nn.Embedding(...,
sparse=True)`` gradient) convert to and from :class:`IndexedSlices`
(:func:`from_sparse_coo`, :func:`to_sparse_coo`); ``sparse_allreduce``
takes either and returns the same kind.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch


class IndexedSlices(NamedTuple):
    """A sparse slab of a dense tensor: ``values[k]`` is the slice of the
    dense tensor at first-dim index ``indices[k]``."""

    values: Any           # [nnz, ...] slice values
    indices: Any          # [nnz] integer first-dim indices
    dense_shape: Tuple[int, ...]


def is_sparse(tensor) -> bool:
    """An IndexedSlices or a torch sparse COO tensor."""
    return isinstance(tensor, IndexedSlices) or (
        torch.is_tensor(tensor) and tensor.is_sparse)


def from_sparse_coo(t: torch.Tensor) -> IndexedSlices:
    """The coalesced dim-0 slices of a sparse COO tensor (trailing dims
    dense, the embedding-gradient layout)."""
    st = t.coalesce()
    idx = st.indices()
    if idx.shape[0] != 1:
        raise ValueError(
            "only dim-0 sparse tensors are supported (IndexedSlices "
            "layout); densify other sparsity patterns first")
    return IndexedSlices(st.values(), idx[0], tuple(st.shape))


def to_sparse_coo(slices: IndexedSlices) -> torch.Tensor:
    """A sparse COO tensor of the slices (duplicates kept: call
    ``.coalesce()`` to merge them)."""
    return torch.sparse_coo_tensor(
        slices.indices.to(torch.int64)[None], slices.values,
        size=tuple(slices.dense_shape))


def sparse_allreduce(slices, op=None, name: Optional[str] = None,
                     process_set=None):
    """All-reduce sparse slices (an IndexedSlices or a sparse COO
    tensor): gather every rank's values and indices in rank order and,
    for Average, divide the values by the set's size. Duplicate indices
    remain; :func:`sparse_to_dense` (or a sparse optimizer) sums them."""
    del name
    from ..core.process_sets import set_context
    from . import collectives

    op = collectives.ReduceOp.AVERAGE if op is None else \
        collectives.ReduceOp(op)
    if op not in (collectives.ReduceOp.AVERAGE, collectives.ReduceOp.SUM):
        raise ValueError(
            "sparse allreduce supports Average and Sum "
            "(reference tensorflow/__init__.py:56)")
    coo = torch.is_tensor(slices)
    sl = from_sparse_coo(slices) if coo else slices
    values = collectives.allgather(sl.values, process_set=process_set)
    indices = collectives.allgather(sl.indices, process_set=process_set)
    if op == collectives.ReduceOp.AVERAGE:
        n = set_context(process_set).size
        values = (values / n).to(sl.values.dtype)
    out = IndexedSlices(values, indices, tuple(sl.dense_shape))
    return to_sparse_coo(out) if coo else out


def sparse_to_dense(slices: IndexedSlices) -> torch.Tensor:
    """Densify by scatter-add (duplicate indices accumulate)."""
    z = torch.zeros(slices.dense_shape, dtype=slices.values.dtype,
                    device=slices.values.device)
    return z.index_add_(0, slices.indices.to(torch.int64), slices.values)


def dense_to_sparse(grad: torch.Tensor,
                    threshold: float = 0.0) -> IndexedSlices:
    """The rows of a dense gradient whose largest magnitude exceeds
    ``threshold``, as IndexedSlices (int32 indices, as the JAX
    package's)."""
    g = grad.detach()
    row_mass = g.abs().reshape(g.shape[0], -1).amax(dim=1)
    idx = torch.nonzero(row_mass > threshold).flatten()
    return IndexedSlices(g[idx], idx.to(torch.int32), tuple(g.shape))
