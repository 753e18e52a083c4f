"""ZeRO-1: optimizer states sharded over the data-parallel ranks.

The port of the JAX package's ``optim/zero.py`` ``ShardedOptimizer``.
Each rank keeps the whole model, but its inner optimizer (AdamW, SGD
with momentum, ... any optimizer that is elementwise in its state)
holds state for one shard of each fusion bucket only, so Adam's m and v
take 1/n of their replicated size (BERT-Large: 2.67 GB replicated, 0.67
GB per rank at n = 4). A step runs, bucket by bucket:

1. **pack** (:func:`stage_pack`): the bucket's gradients concatenated
   and laid out as ``(n, k)`` ring rows, ``k = ceil(L / n)``, zero
   padded, row r being rank r's shard (``ring_pack.maybe_pack_rows``:
   the hand-written kernel B6 on the card);
2. **reduce-scatter** (:func:`_start_scatter_bucket`): rank r gets the
   SUM over the ranks of row r, divided by n, on the configured wire
   (float32; a cast wire sums in its dtype; the int8 wire quantizes each
   rank's rows for the exchange and runs without error feedback, as in
   the JAX package);
3. **shard step** (:meth:`RankShards.step`): the inner optimizer steps
   on this rank's parameter shards with the averaged gradient shards;
4. **all-gather** of the updated shards, whose first L elements are
   written back into the parameters (:func:`stage_write`).

The gradient buckets are planned from the parameters' flax names with
``ops/fusion.pytree_bucket_plan``, so the plan is the JAX package's,
and each bucket's pack and reduce-scatter are issued from the
post-accumulate-grad hooks of ``optim/distributed.py``, in plan order on
every rank, as backward produces them: the counterpart of the JAX
package's chain of optimization barriers (``ordered_buckets``). With
``HOROVOD_ORDERED_BUCKETS=0`` the hooks only count, and
``synchronize()`` issues every bucket in plan order after the backward,
as the JAX package's unchained reduce-scatters run. ``step()`` waits
for the shards.

The JAX package all-gathers the inner optimizer's *updates* and adds
them to the replicated parameters (``p + all_gather(u)``); torch's
optimizers update their parameters in place, so this port gathers the
updated parameter shards instead. The two agree up to the inner
optimizer's own formula (``optax.adamw`` and ``torch.optim.AdamW``
round their steps at different points); with a torch inner optimizer
the sharded step is the replicated step of the same optimizer, element
for element.

In a world of one rank the inner optimizer steps on the full
parameters and nothing is packed or exchanged. ``params_sharded=True``
is ZeRO-3 (``optim/fsdp.py``); ``backward_passes_per_step`` is not
offered.

One card cannot hold an NCCL world of several ranks:
:func:`emulated_scatter_buckets` composes the same per-rank pieces with
rank-order sums and slicing in place of the reduce-scatter, and a
concatenation stands for the all-gather (``chip_smoke.py`` trains
BERT-Large that way in a world of four on one card).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..core.basics import _require_init
from ..core.process_sets import set_context
from ..ops import ring_pack
from ..ops.collectives import (ReduceOp, _all_gather_tiled,
                               _reduce_scatter_tiled, lost_peer)
from ..ops.fusion import (BucketPlan, pack_buckets_by_plan,
                          plan_bucket_lengths)
from .compression import (Compression, NoneCompressor, compressor_wire_spec,
                          quantized_reduce_scatter_rows, wire_applies)
from .distributed import _DistributedOptimizer


def _k(b: torch.Tensor, n: int) -> int:
    return -(-int(b.numel()) // n)


def _pad_rows(b: torch.Tensor, n: int) -> torch.Tensor:
    """1-D bucket -> (n, k) rows, zero-padded; row r is rank r's shard.
    The plain version of B6."""
    k = _k(b, n)
    out = torch.zeros(n * k, dtype=b.dtype, device=b.device)
    out[:b.numel()] = b
    return out.reshape(n, k)


def _int8(wire, dtype) -> bool:
    return wire_applies(wire, dtype) and wire.kind == "int8"


def _start_scatter_bucket(rows: torch.Tensor, n: int, wire,
                          residual: Optional[torch.Tensor] = None,
                          group=None):
    """Start the reduce-scatter of one padded ``(n, k)`` gradient bucket
    to this rank's AVERAGED ``(k,)`` shard on ``wire``; returns
    ``finish()``, which waits and gives the shard (``(shard,
    new_residual)`` with a residual). On the float32 wire the SUM is
    reduce-scattered (over ``group``, default the world) and divided by
    n; a cast wire does both in its
    dtype and casts back; the int8 wire runs
    ``compression.quantized_reduce_scatter_rows`` (its float32 SUM,
    divided by n), with this rank's error-feedback ``residual`` when
    given."""
    if _int8(wire, rows.dtype):
        out = quantized_reduce_scatter_rows(rows, wire.block,
                                            residual=residual)
        if residual is not None:
            shard, new_res = out
            return lambda: ((shard / n).to(rows.dtype), new_res)
        return lambda: (out / n).to(rows.dtype)
    if residual is not None:
        raise ValueError(
            "error-feedback residual passed for a non-int8 wire — only "
            "the quantized exchange produces an error to feed back")
    flat = rows.reshape(-1)
    if wire_applies(wire, rows.dtype):
        flat = flat.to(wire.wire_dtype)
    out, work = _reduce_scatter_tiled(flat.contiguous(), n, group)

    def finish():
        work.wait()
        return (out / n).to(rows.dtype)

    return finish


def _scatter_bucket(rows: torch.Tensor, n: int, wire,
                    residual: Optional[torch.Tensor] = None):
    """Reduce-scatter one padded ``(n, k)`` gradient bucket to this
    rank's averaged ``(k,)`` shard on ``wire`` (see
    :func:`_start_scatter_bucket`), and wait for it."""
    return _start_scatter_bucket(rows, n, wire, residual)()


def emulated_scatter_buckets(rows_by_rank: Sequence[torch.Tensor], n: int,
                             wire, residuals=None):
    """:func:`_scatter_bucket` of ``n`` ranks' ``(n, k)`` rows in one
    process: the SUM of row r over the ranks in rank order (the int8
    wire: the same quantize and dequantize-accumulate stages with the
    all-to-all as slicing), divided by n. Returns each rank's averaged
    shard; with ``residuals`` (each rank's ``(n, k2)`` error-feedback
    residual, the int8 wire only) ``(shards, new_residuals)``."""
    rows0 = rows_by_rank[0]
    dtype = rows0.dtype
    if _int8(wire, dtype):
        from ..ops import quantized_collectives as qc

        k = rows0.shape[1]
        k2 = -(-k // wire.block) * wire.block
        rows_f = [torch.nn.functional.pad(r.to(torch.float32), (0, k2 - k))
                  for r in rows_by_rank]
        out = qc.emulated_quantized_reduce_scatter_rows(
            [r.contiguous() for r in rows_f], n, wire.block, residuals)
        sums = out if residuals is None else out[0]
        shards = [(s[:k] / n).to(dtype) for s in sums]
        return shards if residuals is None else (shards, out[1])
    if residuals is not None:
        raise ValueError(
            "error-feedback residual passed for a non-int8 wire — only "
            "the quantized exchange produces an error to feed back")
    x = [r.to(wire.wire_dtype) if wire_applies(wire, dtype) else r
         for r in rows_by_rank]
    out = []
    for r in range(n):
        acc = x[0][r]
        for j in range(1, n):
            acc = acc + x[j][r]
        out.append((acc / n).to(dtype))
    return out


# -- the stages of one step -------------------------------------------------

def stage_pack(grads: Sequence[Optional[torch.Tensor]], plan: BucketPlan,
               n: int) -> torch.Tensor:
    """Stage 1 on one rank: the bucket ``plan`` of ``grads`` (the leaves
    in plan order), as ``(n, k)`` ring rows (B6 on the card)."""
    bucket, = pack_buckets_by_plan(grads, [plan])
    return ring_pack.maybe_pack_rows(bucket, n)


def state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of a torch optimizer's state tensors."""
    return sum(v.numel() * v.element_size()
               for st in optimizer.state.values()
               for v in st.values() if torch.is_tensor(v))


@torch.no_grad()
def stage_write(params: Sequence[torch.Tensor],
                plans: Sequence[BucketPlan],
                gathered: Sequence[torch.Tensor]) -> None:
    """Stage 4: write each bucket's gathered ``(n * k,)`` parameters (the
    ranks' updated shards in rank order) back into ``params``."""
    for plan, full in zip(plans, gathered):
        for (i, off, size, shape) in plan:
            params[i].copy_(full[off:off + size].view(shape))


class RankShards:
    """One rank's part of the ZeRO-1 state: a shard tensor per bucket
    (this rank's ``k_i`` elements of the bucket's padded parameters) and
    the inner optimizer, built by ``optimizer`` over those shards, whose
    state is therefore 1/n of the replicated one. ``params`` are the
    leaves in plan order."""

    def __init__(self, optimizer: Callable, params: Sequence[torch.Tensor],
                 plans: Sequence[BucketPlan], n: int, rank: int):
        self.params, self.plans, self.n, self.rank = (list(params), plans,
                                                      n, rank)
        self.lens = plan_bucket_lengths(plans)
        self.ks = [-(-L // n) for L in self.lens]
        self.tensors = []
        for plan, k in zip(plans, self.ks):
            first = self.params[plan[0][0]]
            self.tensors.append(torch.zeros(k, dtype=first.dtype,
                                            device=first.device))
        self.load_params()
        self.optimizer = optimizer(self.tensors)

    @torch.no_grad()
    def load_params(self) -> None:
        """Copy this rank's slice of each bucket of the parameters into its
        shard (JAX slices the shards from the parameters every step; so
        does this, so the shards follow any change made to the
        parameters). The padding past a bucket's end stays 0."""
        for b, plan in enumerate(self.plans):
            k = self.ks[b]
            lo, hi = self.rank * k, (self.rank + 1) * k
            shard = self.tensors[b]
            for (i, off, size, _) in plan:
                a, z = max(lo, off), min(hi, off + size)
                if a < z:
                    shard[a - lo:z - lo].copy_(
                        self.params[i].detach().reshape(-1)[a - off:z - off])

    def step(self, grad_shards: Sequence[torch.Tensor]):
        """Stage 3: the inner optimizer's step on this rank's shards, with
        the averaged gradient shards of the reduce-scatter."""
        self.load_params()
        for t, g in zip(self.tensors, grad_shards):
            t.grad = g.to(t.dtype)
        return self.optimizer.step()

    def state_bytes(self) -> int:
        """Bytes of the inner optimizer's state tensors on this rank."""
        return state_bytes(self.optimizer)


class _ShardedOptimizer(_DistributedOptimizer):
    """The hook and readiness machinery of ``_DistributedOptimizer``
    (each bucket issued in plan order as backward completes it) with the
    ZeRO-1 stages in place of the all-reduce."""

    _takes_sparse = False

    def __init__(self, optimizer: Callable, named_parameters,
                 compression=None, fusion_threshold_bytes=None,
                 bucket_backward_order=None, process_set=None):
        st = _require_init()
        live = () if st.mesh is None else st.mesh.live_axes()
        if process_set is None and len(live) > 1:
            raise ValueError(
                "ShardedOptimizer shards over exactly one data-parallel "
                f"axis; got live axes {live}")
        ctx = set_context(process_set)
        if compression is None:
            compression = Compression.from_knobs(st.knobs)
        if ctx.group is not None and _int8(compressor_wire_spec(compression),
                                           torch.float32):
            # the quantized exchange runs over the whole world: a proper
            # subset moves float32, as the DistributedOptimizer's does
            compression = NoneCompressor
        self._compression = compression
        #: the WireSpec of the gradient reduce-scatter (None: float32)
        self.wire = compressor_wire_spec(compression)
        self._op = ReduceOp.AVERAGE
        self._k = 1
        self._predivide = 1.0
        self._size = ctx.size
        self._member, self._group = ctx.member, ctx.group
        self._process_set = process_set
        self._int8_block = None
        self._residuals = {}
        self._plan(list(named_parameters), fusion_threshold_bytes,
                   bucket_backward_order)
        #: this rank's shards and inner optimizer (None at world 1)
        self.shards: Optional[RankShards] = None
        if self._size > 1:
            self.shards = RankShards(optimizer, self._params, self._plans,
                                     self._size, ctx.rank)
            self._opt = self.shards.optimizer
        else:
            self._opt = optimizer(self._params)
        self._install_hooks()

    def _issue(self, b: int) -> None:
        """Pack bucket ``b`` (B6) and start its reduce-scatter."""
        rows = stage_pack(self._grads(b), self._plans[b], self._size)
        self._pending.append(
            (b, _start_scatter_bucket(rows, self._size, self.wire,
                                      group=self._group)))

    def synchronize(self) -> None:
        """Issue the buckets not issued yet, wait for the reduce-scatters,
        and hand the averaged gradient shards to the shard tensors'
        ``.grad`` (the parameters' ``.grad`` keep this rank's own)."""
        if self._size <= 1:
            return
        self._check_attached()
        with self._lock:
            while self._next < len(self._plans):
                self._issue(self._next)
                self._next += 1
            pending, self._pending = self._pending, []
            self._reset()
        shards = [None] * len(self._plans)
        for b, finish in pending:
            with lost_peer():
                shards[b] = finish()
        for t, g in zip(self.shards.tensors, shards):
            t.grad = g

    def step(self, closure=None):
        if self._size <= 1:
            return self._opt.step(closure)
        self.synchronize()
        loss = self.shards.step([t.grad for t in self.shards.tensors])
        gathers = [_all_gather_tiled(t, self._size, self._group)
                   for t in self.shards.tensors]
        with lost_peer():
            for _, work in gathers:
                work.wait()
        stage_write(self._params, self._plans, [g for g, _ in gathers])
        return loss

    def zero_grad(self, set_to_none: bool = True):
        for p in self._params:
            if p.grad is None:
                continue
            if set_to_none:
                p.grad = None
            else:
                p.grad.zero_()
        return self._opt.zero_grad(set_to_none=set_to_none)

    def shard_state_bytes(self) -> int:
        """Bytes of the inner optimizer's state on this rank: 1/n of the
        replicated state (plus the padding of the last shards) in a
        world of n ranks."""
        return state_bytes(self._opt)


def ShardedOptimizer(optimizer: Callable, named_parameters=None,
                     compression=None,
                     fusion_threshold_bytes: Optional[int] = None,
                     bucket_backward_order: Optional[bool] = None,
                     params_sharded: bool = False):
    """ZeRO-1 over every rank (a world whose mesh has 2+ live axes
    raises ``ValueError``, as the JAX package's does; ``make_lm_train_step``
    binds it to its data axis instead). ``optimizer`` makes the inner torch
    optimizer from a list of tensors (e.g. ``functools.partial(
    torch.optim.AdamW, lr=1e-4, weight_decay=1e-4)``): it is built over
    this rank's shard of each bucket, so its state is 1/n. The buckets
    are planned from ``named_parameters`` (their flax names), with
    ``fusion_threshold_bytes`` and ``bucket_backward_order`` defaulting
    to the knobs. ``compression=None`` takes the wire the
    ``HOROVOD_COMPRESSION`` knob selects; the int8 wire runs without
    error feedback. Call ``step()`` after each backward;
    ``bucket_plan`` and ``shard_state_bytes()`` show the layout and the
    state's size on this rank.

    ``params_sharded=True`` escalates to ZeRO-3: it returns
    ``optim.fsdp.FullyShardedOptimizer`` over the same arguments (the two
    spellings are the same optimizer). Without ``named_parameters`` the
    result is an ``UnboundOptimizer`` that ``make_lm_train_step`` binds
    to the model it builds."""
    if params_sharded:
        from .fsdp import FullyShardedOptimizer

        return FullyShardedOptimizer(
            optimizer, named_parameters, compression=compression,
            fusion_threshold_bytes=fusion_threshold_bytes,
            bucket_backward_order=bucket_backward_order)
    if named_parameters is None:
        import functools

        from .fsdp import UnboundOptimizer

        comp = Compression.from_knobs() if compression is None \
            else compression
        return UnboundOptimizer(
            functools.partial(
                _ShardedOptimizer, optimizer, compression=comp,
                fusion_threshold_bytes=fusion_threshold_bytes,
                bucket_backward_order=bucket_backward_order),
            dict(kind="zero"))
    return _ShardedOptimizer(
        optimizer, named_parameters, compression=compression,
        fusion_threshold_bytes=fusion_threshold_bytes,
        bucket_backward_order=bucket_backward_order)


def reshard_state(rows: Sequence[torch.Tensor], lens: Sequence[int],
                  old_world: int, new_world: int) -> List[torch.Tensor]:
    """Re-shard ZeRO-1 state rows across a change of world size. ``rows``
    holds one ``(old_world, k_i)`` tensor per bucket: the ranks' state
    shards of one state variable (Adam's m, say) stacked in rank order,
    as a checkpoint gathers them; ``lens`` the buckets' lengths (the
    plan's). Returns the ``(new_world, k_i')`` rows the new world's
    ranks take theirs from, ``k_i' = ceil(L_i / new_world)``. The JAX
    package's ``sharded_state_specs`` has no counterpart: each rank
    already holds only its own rows."""
    if old_world == new_world:
        return list(rows)
    if old_world <= 1 or new_world <= 1:
        raise ValueError(
            "reshard_state converts between sharded layouts; a size-1 "
            "world uses the plain (unsharded) inner state — re-init "
            "the optimizer instead")
    if len(rows) != len(lens) or not any(
            s.dim() == 2 and s.shape[0] == old_world for s in rows):
        raise ValueError(
            f"no state leaf has the {old_world}-row bucketed layout "
            f"implied by old_world={old_world} and these params — "
            "wrong old_world, wrong params, or not a ShardedOptimizer "
            "state")
    out = []
    for idx, (s, L) in enumerate(zip(rows, lens)):
        k_old, k_new = -(-L // old_world), -(-L // new_world)
        if tuple(s.shape) != (old_world, k_old):
            raise ValueError(
                f"state rows of bucket {idx} have shape {tuple(s.shape)}, "
                f"which does not match bucket {idx} of the "
                f"({old_world}-world, threshold-derived) layout — wrong "
                "old_world, wrong params, or a different fusion "
                "threshold than the state was built with")
        flat = s.reshape(-1)[:L]
        new = torch.zeros(new_world * k_new, dtype=s.dtype, device=s.device)
        new[:L] = flat
        out.append(new.reshape(new_world, k_new))
    return out
