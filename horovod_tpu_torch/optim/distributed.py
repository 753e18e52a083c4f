"""DistributedOptimizer: a torch optimizer whose gradients are averaged
(or Adasum-combined) over the ranks of a process set before it steps.

The surface of the JAX package's ``horovod_tpu/torch``
``DistributedOptimizer`` (the reference Horovod's), with the JAX
package's fused-bucket reduction inside (``optim/distributed.py``):

* the gradients are planned into buckets bounded by the fusion
  threshold, in backward-availability order (ops/fusion.py); the plan
  is computed from the parameters' flax names, so every rank and the
  JAX package agree on it;
* a post-accumulate-grad hook marks each gradient ready as backward
  produces it; a bucket whose leaves are all ready is packed (one
  ``torch.cat``) and handed to an asynchronous ``all_reduce``. Buckets
  are issued strictly in plan order, on every rank: one that is ready
  early waits for the ones before it, since NCCL needs the same
  sequence of collectives on every rank. With ``HOROVOD_ORDERED_BUCKETS=0``
  (``Knobs.ordered_buckets``, read when the optimizer is built) the
  hooks only count, and ``synchronize()`` issues every bucket in plan
  order after the backward: the schedule the JAX package's step gets
  when XLA's combiner merges its unchained buckets;
* Average is a SUM scaled by ``1/n`` afterwards (with
  ``gradient_predivide_factor`` f: ``1/f`` before, ``f/n`` after), in
  the wire dtype of the compressor, as the JAX package does; n is the
  size of ``process_set`` (default: the world), whose group carries the
  reduction; a rank outside the set reduces nothing;
* ``op=Adasum`` combines each fused bucket as a whole
  (``ops/adasum.py``: the dot and norms run over the bucket, in the JAX
  plan's layout), between the compressor's compress and decompress and
  with no postscale, as ``horovod_tpu/optim/distributed.py:102-107``
  does: the hook issues the bucket's first level and ``synchronize()``
  runs the rest, bucket by bucket in plan order. It needs the world (a
  power of two of ranks), not a proper subset;
* under the int8 wire (``Compression.int8``, ``HOROVOD_COMPRESSION=int8``)
  a floating bucket of a SUM or Average takes the quantized SUM of
  ``ops/quantized_collectives.py`` instead, enqueued whole from the
  hook: quantize (with this rank's error-feedback residual), all-to-all,
  dequantize-accumulate and requantize, all-gather; ``synchronize()``
  dequantizes. Average divides the dequantized SUM by n. The residual is
  one float32 tensor per bucket, in the bucket's layout, zero at
  construction and private to the rank (``error_feedback_residual``);
  ``int8-raw`` keeps none. Other ops (Adasum too), a proper subset and
  integer buckets move uncompressed, as in the JAX package. On a world
  whose mesh has 2+ live axes, and with
  ``HOROVOD_HIERARCHICAL_ALLREDUCE`` on any world, the quantized SUM
  runs in two levels (``ops/hierarchical.py``: a float32 reduce-scatter
  within each domain of the mesh's last live axis, or of
  ``HOROVOD_HIERARCHICAL_LOCAL_SIZE`` ranks, the int8 leg across the
  domains, an all-gather within), and the bucket's residual holds this
  rank's shard residual at its head, as in the JAX package;
* a sparse gradient (``nn.Embedding(sparse=True)``) is reduced by
  ``ops/sparse.sparse_allreduce`` outside the buckets, in
  ``synchronize()`` after the buckets are issued, in leaf order; its
  slot in its bucket carries zeros;
* ``groups`` replaces the fusion plan by explicit buckets, as the JAX
  package's torch adapter has it: an int n chunks the parameters (in
  ``named_parameters`` order) into n groups, a list of lists names
  them; each group is one bucket of each of its dtypes, issued when all
  its members' hooks have fired; a parameter in no group is a bucket of
  its own. ``groups=None`` keeps the plan's buckets;
* ``synchronize()`` issues whatever is left (a parameter that got no
  gradient this step reduces as zeros), waits, and unpacks the results
  into ``.grad``; ``step()`` synchronizes and then steps the wrapped
  optimizer;
* ``backward_passes_per_step`` k: gradients accumulate over k backward
  passes and their mean (sum / k) is reduced on the k-th, as the JAX
  package's ``_AccumState`` does; call ``step()`` once every k passes;
* with the eager negotiation runtime live (``HVD_TPU_NATIVE=1``) and
  a world of more than one rank, the hooks only pack the buckets, and
  ``synchronize()`` submits the step's whole bucket set as one grouped
  ``grouped_allreduce_async`` into the runtime (``name="hvd.grad"``;
  Average as a SUM with a ``1/n`` postscale), whose executor owns the
  wire: under the int8 wire the buckets go uncompressed and the
  executor quantizes each fused batch with a residual of its own; a
  cast compressor whose kind differs from the executor's wire warns
  once and the executor's wire wins, as
  ``horovod_tpu/optim/distributed.py:255-310`` has it. Adasum keeps
  its own path;
* in a world of one rank nothing is packed or reduced (nor recorded,
  as in the JAX package);
* with the autotuner's ``ParameterManager`` running (``HOROVOD_AUTOTUNE``
  without the eager runtime), ``synchronize()`` reports the step's
  bucket bytes to it once a step (``observe``), in a world of one rank
  too, where the JAX package's step reduces, and reports, nothing; a
  ``fusion_threshold_bytes`` given while tuning is active masks the
  tuned threshold for this optimizer, which is said once;
* with metrics on, each executed step's reduction is recorded once
  after ``synchronize()`` has waited for it:
  ``metrics.record_grad_reduction`` (the buckets' bytes and count) and,
  unless the eager runtime's executor owns the wire,
  ``metrics.record_wire_bytes`` (those bytes against what the wire
  sends), as ``horovod_tpu/optim/distributed.py:309-313, 342-376``
  records them; no timeline span a bucket, as the JAX step has none;
* ``shutdown()`` detaches every optimizer of its world (its hooks go,
  and a step that would reduce raises): after an elastic re-init a
  ``train`` function wraps its optimizer anew, on the new world.
"""

from __future__ import annotations

import threading
import weakref
from collections import Counter
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..core.basics import _require_init
from ..core.process_sets import set_context
from ..ops import hierarchical
from ..ops import quantized_collectives as qc
from ..ops.adasum import require_world, start_adasum
from ..ops.collectives import (ReduceOp, dist_op, lost_peer, resolve_op,
                               scale_)
from ..ops.sparse import sparse_allreduce
from ..ops.fusion import (flatten_order, flax_path, pack_buckets_by_plan,
                          pytree_bucket_plan, unflatten_buckets_by_plan)
from ..utils import metrics
from .compression import (Compression, NoneCompressor,
                          compressor_wire_spec, wire_applies,
                          wire_sent_bytes)


#: the optimizers whose gradient hooks are live; shutdown() detaches them
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


def detach_all() -> None:
    """Detach every live optimizer (``core/basics.shutdown``)."""
    for opt in list(_LIVE):
        opt._detach()


class _DistributedOptimizer:

    #: whether this rank takes part in the reduction (not outside the
    #: optimizer's process set), and the set's group (None: the world's)
    _member = True
    _group = None
    _process_set = None
    #: whether sparse gradients may take the sparse path (ZeRO: no)
    _takes_sparse = True
    #: the eager runtime that carries the buckets (None: the hooks'
    #: direct collectives)
    _rt = None

    def __init__(self, optimizer, named_parameters=None, compression=None,
                 backward_passes_per_step: int = 1, op=ReduceOp.AVERAGE,
                 gradient_predivide_factor: float = 1.0,
                 fusion_threshold_bytes: Optional[int] = None,
                 process_set=None, groups=None):
        st = _require_init()
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        if fusion_threshold_bytes is not None:
            _warn_tuned_threshold_masked_once(fusion_threshold_bytes)
        op = resolve_op(None, op)
        if gradient_predivide_factor != 1.0 and op != ReduceOp.AVERAGE:
            raise ValueError("gradient_predivide_factor needs op=Average")
        ctx = set_context(process_set)
        if op == ReduceOp.ADASUM:
            require_world(process_set)
        if compression is None:
            compression = Compression.from_knobs(st.knobs)
        wire = compressor_wire_spec(compression)
        int8 = wire is not None and wire.kind == "int8"
        if int8 and (op not in (ReduceOp.SUM, ReduceOp.AVERAGE)
                     or ctx.group is not None):
            # the quantized collective has SUM semantics over the whole
            # world: other ops and proper subsets move uncompressed, as
            # in the JAX package
            compression, wire, int8 = NoneCompressor, None, False
        # the int8 buckets' two-level route (ops/hierarchical.py): inner
        # domains of this many ranks (the mesh's last live axis on a
        # world of 2+ live axes), 1 for the flat wire
        self._hier_block = hierarchical.int8_block() if int8 else 1
        if self._hier_block > 1:
            hierarchical.block_sets(self._hier_block)  # collective
        self._opt = optimizer
        self._compression = compression
        #: the WireSpec of the floating buckets' wire (None: uncompressed)
        self.wire = wire
        self._op = op
        self._k = backward_passes_per_step
        self._predivide = gradient_predivide_factor
        self._size = ctx.size
        self._member, self._group = ctx.member, ctx.group
        self._process_set = process_set
        # the eager runtime carries the buckets when it is live
        self._rt = (st.eager_runtime if self._reduces()
                    and op != ReduceOp.ADASUM else None)

        if named_parameters is not None:
            named = list(named_parameters)
        else:
            named = [(f"param.{gi}.{pi}", p)
                     for gi, group in enumerate(optimizer.param_groups)
                     for pi, p in enumerate(group["params"])]
        known = {id(p) for _, p in named}
        missing = [p for group in optimizer.param_groups
                   for p in group["params"] if id(p) not in known]
        if missing:
            raise ValueError(f"{len(missing)} parameters of the optimizer "
                             "are not in named_parameters")
        self._plan(named, fusion_threshold_bytes, groups=groups)
        # the int8 wire's block, and this rank's error-feedback residual
        # of each floating bucket (none under int8-raw or at world 1)
        self._int8_block = wire.block if int8 else None
        self._residuals: Dict[int, torch.Tensor] = {}
        if (int8 and wire.error_feedback and self._size > 1
                and self._rt is None):
            for b, plan in enumerate(self._plans):
                first = self._params[plan[0][0]]
                if wire_applies(wire, first.dtype):
                    self._residuals[b] = torch.zeros(
                        sum(size for (_, _, size, _) in plan),
                        dtype=torch.float32, device=first.device)
        self._install_hooks()

    def _plan(self, named, fusion_threshold_bytes,
              backward_order: Optional[bool] = None, groups=None) -> None:
        """Order the parameters that take gradients as the flax tree of
        their names flattens, plan their buckets (``groups``: the
        groups' buckets), and map each to its bucket."""
        dups = [n for n, c in Counter(n for n, _ in named).items() if c > 1]
        if dups:
            raise ValueError(f"duplicate parameter names: {sorted(dups)}")
        members = None if groups is None else _group_members(named, groups)
        named = [(n, p) for n, p in named if p.requires_grad]
        paths = [flax_path(n) for n, _ in named]
        order = flatten_order(paths)
        self._params = [named[i][1] for i in order]
        self._names = [named[i][0] for i in order]
        if members is None:
            self._plans = pytree_bucket_plan(
                [(paths[i], tuple(named[i][1].shape), named[i][1].dtype)
                 for i in order],
                threshold_bytes=fusion_threshold_bytes,
                backward_order=backward_order)
        else:
            self._plans = _group_plans(self._params, members)
        self._leaf_of = {id(p): i for i, p in enumerate(self._params)}
        self._bucket_of: Dict[int, int] = {}
        for b, plan in enumerate(self._plans):
            for (i, _, _, _) in plan:
                self._bucket_of[id(self._params[i])] = b

    def _install_hooks(self) -> None:
        """The per-step state, and a post-accumulate-grad hook on every
        parameter in a world of more than one rank; whether the hooks
        issue the buckets (``ordered_buckets``) and the parameter
        manager to report to are read now, with the plan."""
        st = _require_init()
        self._ordered = st.knobs.ordered_buckets
        self._tuner = st.parameter_manager
        self._lock = threading.Lock()
        self._reset()
        self._hooks = []
        self._detached = False
        if self._reduces():
            for p in self._params:
                self._hooks.append(
                    p.register_post_accumulate_grad_hook(self._hook))
            _LIVE.add(self)

    def _detach(self) -> None:
        """Remove the hooks: the world they reduce over has shut down."""
        for h in self._hooks:
            h.remove()
        self._hooks = []
        self._detached = True
        _LIVE.discard(self)

    def _check_attached(self) -> None:
        if self._detached:
            raise RuntimeError(
                "this DistributedOptimizer belongs to a world that was "
                "shut down; wrap the optimizer again after init()")

    # -- per-step state --------------------------------------------------

    def _reduces(self) -> bool:
        """Whether this rank reduces anything: a member of a set of more
        than one rank."""
        return self._size > 1 and self._member

    def _reset(self) -> None:
        self._passes = {id(p): 0 for p in self._params}
        self._missing = [len(plan) for plan in self._plans]
        self._next = 0      # next bucket to issue, in plan order
        self._pending: List = []
        self._sparse: List[int] = []  # leaves whose gradient is sparse
        # (bucket, packed gradients) for the eager runtime
        self._native: List = []

    def _hook(self, p: torch.Tensor) -> None:
        with self._lock:
            key = id(p)
            self._passes[key] += 1
            if self._passes[key] < self._k:
                return
            if self._passes[key] > self._k:
                raise RuntimeError(
                    f"gradients were computed more than "
                    f"backward_passes_per_step={self._k} times before "
                    "step() / synchronize()")
            if p.grad.is_sparse:
                if not self._takes_sparse or self._op == ReduceOp.ADASUM:
                    raise TypeError(
                        "sparse gradients reduce by gathering slices, with "
                        "op Average or Sum and the DistributedOptimizer "
                        f"only; {self._names[self._leaf_of[key]]} has one")
                self._sparse.append(self._leaf_of[key])
            self._missing[self._bucket_of[key]] -= 1
            while (self._ordered and self._next < len(self._plans)
                   and self._missing[self._next] == 0):
                self._issue(self._next)
                self._next += 1

    def _grads(self, b: int) -> List[torch.Tensor]:
        """The gradients of every leaf, after giving bucket ``b``'s leaves
        that got none this step zeros; a sparse gradient's slot holds
        zeros."""
        grads = [p.grad for p in self._params]
        for (i, _, _, _) in self._plans[b]:
            p = self._params[i]
            if p.grad is None:
                p.grad = grads[i] = torch.zeros_like(p)
            elif p.grad.is_sparse:
                grads[i] = torch.zeros(p.shape, dtype=p.dtype,
                                       device=p.device)
        return grads

    def _issue(self, b: int) -> None:
        """Pack bucket ``b`` and start its reduction."""
        bucket, = pack_buckets_by_plan(self._grads(b), [self._plans[b]])
        if self._k > 1:
            bucket.div_(self._k)
        if self._predivide != 1.0:
            scale_(bucket, 1.0 / self._predivide)
        if self._rt is not None:
            self._native.append((b, bucket))
            return
        if self._int8_block is not None and wire_applies(self.wire,
                                                         bucket.dtype):
            self._pending.append((b, self._start_int8(b, bucket)))
            return
        wire, ctx = self._compression.compress(bucket)
        if self._op == ReduceOp.ADASUM:
            finish_adasum = start_adasum(wire)
            self._pending.append((b, lambda: self._compression.decompress(
                finish_adasum(), ctx)))
            return
        work = dist.all_reduce(wire, op=dist_op(self._op),
                               group=self._group, async_op=True)

        def finish():
            work.wait()
            if self._op != ReduceOp.AVERAGE:
                return self._compression.decompress(wire, ctx)
            if self._predivide != 1.0:
                out = self._compression.decompress(wire, ctx)
                return scale_(out, self._predivide / self._size)
            scale_(wire, 1.0 / self._size)
            return self._compression.decompress(wire, ctx)

        self._pending.append((b, finish))

    def _start_int8(self, b: int, bucket: torch.Tensor):
        """Enqueue bucket ``b``'s quantized SUM up to its gathers, flat
        or in two levels (the quantized outer leg of
        ``ops/hierarchical.py``, whose residual is the shard's at the
        bucket residual's head); carry its new residual. Returns the
        bucket's finish."""
        if self._hier_block > 1:
            finish_sum, err = hierarchical.start_hierarchical_psum(
                bucket.to(torch.float32), self._hier_block, self.wire,
                self._residuals.get(b))
        else:
            finish_sum, err = qc.start_quantized_psum(
                bucket.to(torch.float32), self._size, self._int8_block,
                self._residuals.get(b))
        if err is not None:
            self._residuals[b] = err
        dtype = bucket.dtype

        def finish():
            red = finish_sum().to(dtype)
            if self._op != ReduceOp.AVERAGE:
                return red
            if self._predivide != 1.0:
                return scale_(red, self._predivide / self._size)
            # a true division, as the JAX package's `red / n`: where n is
            # not a power of two, a multiply by 1/n differs in the last bit
            return red / self._size

        return finish

    def _reduce_native(self, native) -> List:
        """Reduce the step's buckets through the eager runtime as one
        grouped allreduce and wait; returns each bucket's (b, finish)."""
        from ..ops.collectives import _grouped_start

        rt_wire = self._rt._executor_wire()
        wire = self.wire
        # whenever the executor carries a wire it owns compression for
        # these buckets (compressing here too would stack two wires);
        # a kind that differs from the optimizer's means the knob wins
        owns = wire is not None and rt_wire is not None
        if owns and rt_wire.kind != wire.kind:
            _warn_wire_mismatch_once(wire.kind, rt_wire.kind)
        if wire is not None and wire.kind == "int8" and rt_wire is None:
            # the int8 collective needs the executor's wire; without the
            # knob the executor reduces at full precision
            _warn_wire_mismatch_once(wire.kind, "none")
        raw = owns or (wire is not None and wire.kind == "int8")
        wires, ctxs = [], []
        for _, bucket in native:
            w, c = (bucket, None) if raw else \
                self._compression.compress(bucket)
            wires.append(w)
            ctxs.append(c)
        average = self._op == ReduceOp.AVERAGE
        post = self._predivide / self._size if average else 1.0
        reduced = _grouped_start(
            wires, None, ReduceOp.SUM if average else self._op, 1.0, post,
            self._process_set, name="hvd.grad")[1]()
        if not raw:
            reduced = [self._compression.decompress(r, c)
                       for r, c in zip(reduced, ctxs)]
        return [(b, (lambda r=r: r)) for (b, _), r in zip(native, reduced)]

    # -- public surface --------------------------------------------------

    def synchronize(self) -> None:
        """Finish this step's reduction: issue the buckets not issued
        yet, reduce the sparse gradients, wait for all, and write the
        results into ``.grad``."""
        if self._tuner is not None:
            self._tuner.observe(self._bucket_bytes())
        if not self._reduces():
            if self._k > 1:
                for p in self._params:
                    if p.grad is not None:
                        p.grad.div_(self._k)
            return
        self._check_attached()
        with self._lock:
            while self._next < len(self._plans):
                self._issue(self._next)
                self._next += 1
            pending, self._pending = self._pending, []
            native = self._native
            sparse = sorted(self._sparse)
            self._reset()
        if native:
            with lost_peer():
                pending += self._reduce_native(native)
        for i in sparse:
            p = self._params[i]
            g = p.grad / self._k if self._k > 1 else p.grad
            p.grad = sparse_allreduce(g, op=self._op,
                                      process_set=self._process_set)
        for b, finish in pending:
            with lost_peer():
                out = finish()
            leaves = unflatten_buckets_by_plan([out], [self._plans[b]],
                                               len(self._params))
            for (i, _, _, _) in self._plans[b]:
                g = self._params[i].grad
                if not g.is_sparse:
                    g.copy_(leaves[i].to(g.dtype))
        if metrics.enabled():
            self._record_reduction()

    def _bucket_sizes(self) -> List:
        """(elements, dtype) of each bucket of the plan."""
        return [(sum(n for (_, _, n, _) in plan),
                 self._params[plan[0][0]].dtype) for plan in self._plans]

    def _bucket_bytes(self) -> int:
        """The plan's buckets' bytes at their dtypes: what a step
        reduces."""
        return sum(n * dt.itemsize for n, dt in self._bucket_sizes())

    def _record_reduction(self) -> None:
        """One executed reduction: the buckets' bytes at their dtypes
        and, where this optimizer owns the wire, what the wire sent."""
        sizes = self._bucket_sizes()
        total = sum(n * dt.itemsize for n, dt in sizes)
        metrics.record_grad_reduction(total, len(sizes))
        if self._rt is None:
            metrics.record_wire_bytes(total, sum(
                wire_sent_bytes(n, dt.itemsize, self.wire
                                if wire_applies(self.wire, dt) else None)
                for n, dt in sizes))

    def step(self, closure=None):
        self.synchronize()
        return self._opt.step(closure)

    def zero_grad(self, set_to_none: bool = True):
        return self._opt.zero_grad(set_to_none=set_to_none)

    @property
    def param_groups(self):
        return self._opt.param_groups

    @property
    def state(self):
        return self._opt.state

    def state_dict(self):
        return self._opt.state_dict()

    def load_state_dict(self, sd):
        return self._opt.load_state_dict(sd)

    @property
    def bucket_plan(self):
        """The bucket plan (leaf order: flatten order of the names)."""
        return self._plans

    @property
    def error_feedback_residual(self) -> Dict[str, torch.Tensor]:
        """This rank's error-feedback residual of the int8 wire by
        parameter name: float32 views in each parameter's shape, to be
        read, not written. Empty when the wire carries no residual
        (another wire, ``int8-raw``, a world of one)."""
        out = {}
        for b, res in self._residuals.items():
            for (i, off, size, shape) in self._plans[b]:
                out[self._names[i]] = res[off:off + size].view(shape)
        return out

    def __getattr__(self, item):
        if item == "_opt":  # not set yet: __init__ raised
            raise AttributeError(item)
        return getattr(self._opt, item)


_TUNED_MASK_WARNED = [False]


def _warn_tuned_threshold_masked_once(explicit: int) -> None:
    """An explicit per-optimizer ``fusion_threshold_bytes`` outranks the
    global knob — which is exactly where the autotuner
    (``ops/autotune.py``) pins its winners. When tuning (or a
    warm-start cache) is active, the pinned bucket size would be
    silently masked by the constructor argument: say so once."""
    if _TUNED_MASK_WARNED[0]:
        return
    from ..core.state import global_state

    knobs = global_state().knobs
    if not (knobs.autotune or getattr(knobs, "autotune_cache", "")):
        return
    _TUNED_MASK_WARNED[0] = True
    from ..utils.logging import get_logger

    get_logger().warning(
        "DistributedOptimizer was built with an explicit "
        "fusion_threshold_bytes=%d while autotuning is active "
        "(HOROVOD_AUTOTUNE / HOROVOD_AUTOTUNE_CACHE): the explicit "
        "value masks the tuner's pinned bucket size for this "
        "optimizer. Drop the argument to let the tuned knob apply.",
        explicit)


_WIRE_MISMATCH_WARNED: set = set()


def _warn_wire_mismatch_once(optimizer_kind: str, executor_kind: str) -> None:
    """The optimizer's compressor and the eager executor's wire differ:
    the executor's wire carries the buckets. Said once per pair."""
    if (optimizer_kind, executor_kind) in _WIRE_MISMATCH_WARNED:
        return
    _WIRE_MISMATCH_WARNED.add((optimizer_kind, executor_kind))
    from ..utils.logging import get_logger

    get_logger().warning(
        "DistributedOptimizer compression %r differs from the eager "
        "runtime executor's wire %r; the executor's wire (the "
        "HOROVOD_COMPRESSION knob at init) carries the buckets",
        optimizer_kind, executor_kind)


def _group_members(named, groups) -> List[List[torch.Tensor]]:
    """The parameters of each group (the JAX package's torch adapter,
    ``horovod_tpu/torch/__init__.py:539-603``): an int n chunks the
    parameters that take gradients, in ``named`` order, into n groups;
    a list of lists names them, each a registered parameter at most
    once."""
    if not (isinstance(groups, list) or
            (isinstance(groups, int) and not isinstance(groups, bool)
             and groups > 0)):
        raise ValueError("groups should be a positive integer or a list of "
                         "lists of torch.Tensor (reference optimizer.py:89)")
    if isinstance(groups, int):
        grad_params = [p for _, p in named if p.requires_grad]
        n = min(groups, len(grad_params)) or 1
        size = (len(grad_params) + n - 1) // n
        return [grad_params[i * size:(i + 1) * size] for i in range(n)]
    registered = {id(p) for _, p in named}
    seen = set()
    for sub in groups:
        for p in sub:
            if not isinstance(p, torch.Tensor):
                raise ValueError("groups must consist of torch.Tensor")
            if id(p) not in registered:
                # an unregistered member has no hook and would hold its
                # whole group back
                raise ValueError("groups may only contain parameters "
                                 "registered with this optimizer "
                                 "(named_parameters / param_groups)")
            if id(p) in seen:
                raise ValueError("a parameter can only appear once in "
                                 "groups")
            seen.add(id(p))
    return [list(sub) for sub in groups]


def _group_plans(params: List[torch.Tensor],
                 members: List[List[torch.Tensor]]) -> List:
    """Bucket plans of the groups: each group's members that take
    gradients, in the group's order, one bucket per dtype; then each
    parameter in no group as a bucket of its own, in ``params`` order."""
    index = {id(p): i for i, p in enumerate(params)}
    grouped = [[p for p in sub if id(p) in index] for sub in members]
    seen = {id(p) for sub in grouped for p in sub}
    grouped += [[p] for p in params if id(p) not in seen]
    plans = []
    for sub in grouped:
        by_dtype: dict = {}
        for p in sub:
            by_dtype.setdefault(p.dtype, []).append(p)
        for ps in by_dtype.values():
            plan, off = [], 0
            for p in ps:
                plan.append((index[id(p)], off, p.numel(), tuple(p.shape)))
                off += p.numel()
            plans.append(plan)
    return plans


def DistributedOptimizer(optimizer, named_parameters=None, compression=None,
                         backward_passes_per_step: int = 1,
                         op=ReduceOp.AVERAGE,
                         gradient_predivide_factor: float = 1.0,
                         fusion_threshold_bytes: Optional[int] = None,
                         process_set=None, groups=None):
    """Wrap a torch optimizer so that ``step()`` applies gradients
    averaged (``op``: Average, Sum, Adasum, ...) over the ranks of
    ``process_set`` (default: every rank). ``named_parameters`` names the
    parameters (their flax names order the fusion buckets); without it
    they are named by position. ``compression=None`` takes the
    compressor the ``HOROVOD_COMPRESSION`` knob selects (default none).
    ``fusion_threshold_bytes`` overrides ``HOROVOD_FUSION_THRESHOLD``;
    ``groups`` (an int or a list of lists of parameters) replaces the
    fusion plan by explicit buckets."""
    return _DistributedOptimizer(
        optimizer, named_parameters=named_parameters,
        compression=compression,
        backward_passes_per_step=backward_passes_per_step, op=op,
        gradient_predivide_factor=gradient_predivide_factor,
        fusion_threshold_bytes=fusion_threshold_bytes,
        process_set=process_set, groups=groups)


# -- gradients of a function, all-reduced ------------------------------------

def _reduce_grads(grads, op, process_set):
    """Every tensor of the ``grads`` tree (a tensor, or lists, tuples
    and dicts of them) reduced over ``process_set``: one grouped
    allreduce a dtype."""
    from torch.utils import _pytree as pytree

    from ..ops.collectives import grouped_allreduce

    flat, spec = pytree.tree_flatten(grads)
    flat = grouped_allreduce(flat, op=op, process_set=process_set)
    return pytree.tree_unflatten(list(flat), spec)


class DistributedGradientTape:
    """Wrap a value-and-grad function so the gradients it returns arrive
    all-reduced (reference ``hvd.DistributedGradientTape``,
    tensorflow/__init__.py:873; the JAX package's wraps a
    ``jax.value_and_grad``)::

        vag = hvd.DistributedGradientTape(my_value_and_grad)
        loss, grads = vag(params, batch)

    ``op`` (default Average) and ``process_set`` are the collectives'.
    The JAX tape's ``compression``, ``axis_name`` and fusion threshold
    have no counterpart: the gradients go as one grouped allreduce a
    dtype."""

    def __init__(self, value_and_grad_fn, *, op=ReduceOp.AVERAGE,
                 process_set=None):
        self._fn = value_and_grad_fn
        self._op = op
        self._process_set = process_set

    def __call__(self, *args, **kwargs):
        out, grads = self._fn(*args, **kwargs)
        return out, _reduce_grads(grads, self._op, self._process_set)


def distributed_value_and_grad(fun, argnums=0, has_aux: bool = False,
                               op=ReduceOp.AVERAGE, process_set=None):
    """``jax.value_and_grad``'s torch twin whose gradients arrive
    all-reduced: ``wrapped(*args) -> (value, grads)``, the value of
    ``fun(*args)`` (``(value, aux)`` with ``has_aux``) and
    ``torch.autograd.grad`` of the value with respect to the arguments
    ``argnums`` (an int, or a tuple of ints for a tuple of gradients),
    each a tensor or a list, tuple or dict of them, reduced over
    ``process_set`` by ``op`` (default Average)."""
    from torch.utils import _pytree as pytree

    def wrapped(*args, **kwargs):
        nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)
        args = list(args)
        leaves = []
        for i in nums:
            flat, spec = pytree.tree_flatten(args[i])
            flat = [t.detach().requires_grad_() for t in flat]
            leaves.append((flat, spec))
            args[i] = pytree.tree_unflatten(flat, spec)
        with torch.enable_grad():
            out = fun(*args, **kwargs)
            value = out[0] if has_aux else out
            got = iter(torch.autograd.grad(
                value, [t for flat, _ in leaves for t in flat],
                allow_unused=True))
        grads = []
        for flat, spec in leaves:
            gs = [next(got) for _ in flat]
            gs = [torch.zeros_like(t) if g is None else g
                  for g, t in zip(gs, flat)]
            grads.append(pytree.tree_unflatten(gs, spec))
        grads = grads[0] if isinstance(argnums, int) else tuple(grads)
        grads = _reduce_grads(grads, op, process_set)
        if has_aux:
            return (value.detach(), out[1]), grads
        return value.detach(), grads

    return wrapped
