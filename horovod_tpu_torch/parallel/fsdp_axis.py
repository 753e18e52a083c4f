"""A live fsdp axis under a replicated optimizer: ZeRO-3 by the rules.

In the JAX package ``make_lm_train_step`` places the parameters by the
rules' fsdp entries (``parallel/sharding.py``), ``_opt_state_shardings``
gives the optimizer's moments the same split, and XLA gathers each
weight where it is used and reduce-scatters its gradient. The port has
no partitioner, so this module stands in for it, as
``tensor_parallel.py`` does for tp:

* each rank keeps its slice of every parameter whose pruned spec names
  fsdp (``sharding.local_slice``: under tp its fsdp slice of its tp
  slice), and the optimizer is built on those slices, so its state is
  1/fsdp of the whole;
* a block's split weights are all-gathered over the fsdp communicator
  when the block runs, one exchange a block (:class:`_Gather`, from a
  forward pre-hook), into the shapes the block's modules expect (under
  tp, the tp slice ``parallelize`` expects). A dense kernel is gathered
  in its layer's compute dtype, which is the cast the layer makes first
  (cast and gather commute bitwise); any other weight in its own dtype;
* after the block the gathered weights' storage is freed; the tensors
  its backward saved are views of it and are filled again by a gather
  just before the block's backward runs (:class:`_Regather`, on the
  block's output). So only the shards live between a block's forward
  and its backward; under ``cfg.remat`` the recompute gathers again
  itself and nothing is freed;
* the split weights outside the blocks (embedding, positions, an
  untied head) are gathered once a step (:meth:`FsdpAxis.outer`) and
  kept until the step's backward is done with them: the tied table is
  read first and last;
* the backward of a gather reduce-scatters the gradients of its weights
  over fsdp in one exchange (``comm.reduce_scatter``: float32, summed
  in rank order); the parameters that stay whole (norms, biases) get
  their gradient summed over fsdp by a hook on the leaf.

A spec that puts fsdp on one dimension together with another axis is
refused: the gather along fsdp would not give a contiguous slice.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .sharding import Spec, _axes

AXIS = "fsdp"


def fsdp_dim(spec: Spec) -> Optional[int]:
    """The dimension a pruned ``spec`` splits over fsdp (None: none)."""
    for dim, entry in enumerate(spec or ()):
        axes = _axes(entry)
        if AXIS in axes:
            if len(axes) > 1:
                raise ValueError(
                    f"spec {spec}: fsdp shares dimension {dim} with "
                    f"{[a for a in axes if a != AXIS]}; a live fsdp axis "
                    "gathers along a dimension of its own")
            return dim
    return None


class _Leaf:
    """One split parameter: its owner module and attribute, the shard,
    the fsdp dimension and the dtype it is gathered in."""

    __slots__ = ("module", "attr", "shard", "dim", "dtype")

    def __init__(self, module, attr, shard, dim, dtype):
        self.module, self.attr = module, attr
        self.shard, self.dim, self.dtype = shard, dim, dtype


def _gather_into(leaves: Sequence[_Leaf], comm) -> List[torch.Tensor]:
    """Every leaf's shards over ``comm``, concatenated along its fsdp
    dimension in rank order: one all-gather of the leaves' shards packed
    flat (one dtype)."""
    flat = torch.cat([leaf.shard.detach().to(leaf.dtype).reshape(-1)
                      for leaf in leaves])
    parts = comm.all_gather(flat)
    out, off = [], 0
    for leaf in leaves:
        k = leaf.shard.numel()
        shape = leaf.shard.shape
        out.append(torch.cat([p[off:off + k].view(shape) for p in parts],
                             dim=leaf.dim))
        off += k
    return out


def _scatter_grads(leaves: Sequence[_Leaf], grads, comm
                   ) -> List[torch.Tensor]:
    """The leaves' shard gradients: each whole gradient's chunk j of its
    fsdp dimension goes to rank j, every leaf's in one float32
    reduce-scatter summed in rank order."""
    rows = []
    for j in range(comm.size):
        row = []
        for leaf, g in zip(leaves, grads):
            c = leaf.shard.shape[leaf.dim]
            if g is None:
                row.append(torch.zeros(leaf.shard.numel(),
                                       dtype=torch.float32,
                                       device=leaf.shard.device))
            else:
                row.append(g.narrow(leaf.dim, j * c, c).to(
                    torch.float32).reshape(-1))
        rows.append(torch.cat(row))
    mine = comm.reduce_scatter(torch.cat(rows))
    out, off = [], 0
    for leaf in leaves:
        k = leaf.shard.numel()
        out.append(mine[off:off + k].view(leaf.shard.shape).to(
            leaf.shard.dtype))
        off += k
    return out


class _Gather(torch.autograd.Function):
    """A group's whole weights from their shards (one all-gather); the
    backward reduce-scatters their gradients (one exchange). Nothing is
    saved: the shards are the parameters themselves."""

    @staticmethod
    def forward(ctx, group, *shards):
        ctx.group = group
        return tuple(_gather_into(group.leaves, group.fsdp.comm))

    @staticmethod
    def backward(ctx, *grads):
        group = ctx.group
        # a remat recompute stops early, short of the block's post-hook
        group.restore()
        fsdp = group.fsdp
        fsdp.scattered_bytes += 4 * fsdp.comm.size * sum(
            leaf.shard.numel() for leaf in group.leaves)
        return (None,) + tuple(_scatter_grads(group.leaves, grads,
                                              fsdp.comm))


class _Regather(torch.autograd.Function):
    """The identity on a block's output; its backward, which runs before
    any of the block's, refills the freed storage of the block's
    gathered weights with a new gather."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group, ctx.fulls = group, group.fulls
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.group.refill(ctx.fulls)
        ctx.fulls = None
        return g, None


class _Group:
    """Split leaves gathered together (a block's, or the ones outside
    the blocks), of one dtype: one exchange."""

    def __init__(self, leaves: List[_Leaf], fsdp: "FsdpAxis"):
        self.leaves, self.fsdp = leaves, fsdp
        self.fulls: List[torch.Tensor] = []

    def swap_in(self) -> None:
        """Gather the whole weights and put them in their modules."""
        fulls = _Gather.apply(self, *[leaf.shard for leaf in self.leaves])
        self.fsdp.gathered_bytes += sum(f.numel() * f.element_size()
                                        for f in fulls)
        self.fulls = list(fulls)
        for leaf, f in zip(self.leaves, self.fulls):
            leaf.module._parameters[leaf.attr] = f

    def restore(self) -> None:
        """The shards back in their modules."""
        for leaf in self.leaves:
            leaf.module._parameters[leaf.attr] = leaf.shard

    def free(self) -> None:
        for f in self.fulls:
            f.untyped_storage().resize_(0)

    def refill(self, fulls: List[torch.Tensor]) -> None:
        """A new gather into the freed storage of a forward's ``fulls``
        (outside autograd: their version counters are untouched)."""
        with torch.no_grad():
            again = _gather_into(self.leaves, self.fsdp.comm)
        for f, a in zip(fulls, again):
            f.untyped_storage().resize_(a.numel() * a.element_size())
            f.data.copy_(a)
            self.fsdp.gathered_bytes += a.numel() * a.element_size()


def _gather_dtype(module, attr: str, param: torch.Tensor) -> torch.dtype:
    """A dense kernel gathers in the dtype its layer casts it to first;
    every other weight in its own."""
    from ..models.transformer import Dense

    if isinstance(module, Dense) and attr == "kernel":
        return module.dtype
    return param.dtype


class FsdpAxis:
    """The live fsdp axis of one rank's model: building it installs the
    blocks' hooks and the whole parameters' gradient sums; run each
    forward inside :meth:`outer`. ``specs`` are the pruned specs by
    parameter name (the model's parameters already this rank's slices),
    ``comm`` the fsdp communicator.

    ``gathered_bytes`` and ``scattered_bytes`` count the bytes this
    rank's gathers produce and its reduce-scatters take in (the whole
    tensors', float32), refills and recomputes included."""

    def __init__(self, model, specs: Dict[str, Spec], comm):
        self.comm = comm
        self.gathered_bytes = 0
        self.scattered_bytes = 0
        self.free_after_forward = not model.cfg.remat
        blocks = {f"block_{i}.": b for i, b in zip(model.layers,
                                                   model.blocks)}
        outer: List[_Leaf] = []
        self.whole: List[torch.Tensor] = []
        by_block: Dict[str, List[_Leaf]] = {p: [] for p in blocks}
        for name, p in model.named_parameters():
            dim = fsdp_dim(specs.get(name))
            if dim is None:
                self.whole.append(p)
                continue
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            leaf = _Leaf(mod, attr, p, dim, _gather_dtype(mod, attr, p))
            prefix = next((b for b in blocks if name.startswith(b)), None)
            (by_block[prefix] if prefix else outer).append(leaf)
        self.outer_groups = self._groups(outer)
        for prefix, block in blocks.items():
            groups = self._groups(by_block[prefix])
            if groups:
                block.register_forward_pre_hook(self._pre_hook(groups))
                block.register_forward_hook(self._post_hook(groups))
        # the whole parameters' gradients summed over fsdp as the
        # backward produces them (a hook on each leaf, before
        # accumulation)
        for p in self.whole:
            if p.requires_grad:
                p.register_hook(self._sum_whole)

    def _sum_whole(self, g: torch.Tensor) -> torch.Tensor:
        """A whole parameter's gradient summed over fsdp."""
        return self.comm.all_reduce(g)

    def _groups(self, leaves: List[_Leaf]) -> List[_Group]:
        by_dtype: Dict[torch.dtype, List[_Leaf]] = {}
        for leaf in leaves:
            by_dtype.setdefault(leaf.dtype, []).append(leaf)
        return [_Group(ls, self) for ls in by_dtype.values()]

    @staticmethod
    def _pre_hook(groups):
        def hook(module, args):
            for g in groups:
                g.swap_in()
        return hook

    def _post_hook(self, groups):
        def hook(module, args, output):
            for g in groups:
                g.restore()
            if self.free_after_forward:
                for g in groups:
                    g.free()
                if torch.is_grad_enabled() and output.requires_grad:
                    for g in groups:
                        output = _Regather.apply(output, g)
            for g in groups:
                g.fulls = []
            return output
        return hook

    @contextlib.contextmanager
    def outer(self):
        """The split weights outside the blocks gathered for one
        forward (and its backward, which holds them)."""
        groups = self.outer_groups
        for g in groups:
            g.swap_in()
        try:
            yield
        finally:
            for g in groups:
                g.restore()
                g.fulls = []


def param_counts(specs: Dict[str, Spec], shapes: Dict[str, Sequence[int]],
                 mesh) -> Tuple[int, int]:
    """``(elements a rank holds, elements of the whole model)`` under
    ``specs`` on ``mesh``: each split dimension divided by its axes'
    product (the reckoning the step's shards must meet)."""
    held = whole = 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        split = math.prod(mesh.axis_size(a) for e in specs[name]
                          for a in _axes(e))
        whole += n
        held += n // split
    return held, whole
