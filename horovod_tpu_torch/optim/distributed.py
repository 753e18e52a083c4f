"""DistributedOptimizer: a torch optimizer whose gradients are averaged
over every rank before it steps.

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
  sequence of collectives on every rank;
* Average is a SUM scaled by ``1/n`` afterwards (with
  ``gradient_predivide_factor`` f: ``1/f`` before, ``f/n`` after), in
  the wire dtype of the compressor, as the JAX package does;
* under the int8 wire (``Compression.int8``, ``HOROVOD_COMPRESSION=int8``)
  a floating bucket of a SUM or Average takes the quantized SUM of
  ``ops/quantized_collectives.py`` instead, enqueued whole from the
  hook: quantize (with this rank's error-feedback residual), all-to-all,
  dequantize-accumulate and requantize, all-gather; ``synchronize()``
  dequantizes. Average divides the dequantized SUM by n. The residual is
  one float32 tensor per bucket, in the bucket's layout, zero at
  construction and private to the rank (``error_feedback_residual``);
  ``int8-raw`` keeps none. Other ops and integer buckets move
  uncompressed, as in the JAX package;
* ``synchronize()`` issues whatever is left (a parameter that got no
  gradient this step reduces as zeros), waits, and unpacks the results
  into ``.grad``; ``step()`` synchronizes and then steps the wrapped
  optimizer;
* ``backward_passes_per_step`` k: gradients accumulate over k backward
  passes and their mean (sum / k) is reduced on the k-th, as the JAX
  package's ``_AccumState`` does; call ``step()`` once every k passes;
* in a world of one rank nothing is packed or reduced.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..core.basics import _require_init
from ..ops import quantized_collectives as qc
from ..ops.collectives import ReduceOp, dist_op, resolve_op, scale_
from ..ops.fusion import (flatten_order, flax_path, pack_buckets_by_plan,
                          pytree_bucket_plan, unflatten_buckets_by_plan)
from .compression import (Compression, NoneCompressor,
                          compressor_wire_spec, wire_applies)


class _DistributedOptimizer:

    def __init__(self, optimizer, named_parameters=None, compression=None,
                 backward_passes_per_step: int = 1, op=ReduceOp.AVERAGE,
                 gradient_predivide_factor: float = 1.0,
                 fusion_threshold_bytes: Optional[int] = None):
        st = _require_init()
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        op = resolve_op(None, op)
        if gradient_predivide_factor != 1.0 and op != ReduceOp.AVERAGE:
            raise ValueError("gradient_predivide_factor needs op=Average")
        if compression is None:
            compression = Compression.from_knobs(st.knobs)
        wire = compressor_wire_spec(compression)
        int8 = wire is not None and wire.kind == "int8"
        if int8 and op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            # the quantized collective has SUM semantics: other ops move
            # uncompressed, as in the JAX package
            compression, wire, int8 = NoneCompressor, None, False
        if int8 and st.knobs.hierarchical_allreduce:
            raise NotImplementedError(
                "HOROVOD_HIERARCHICAL_ALLREDUCE with the int8 wire: the "
                "two-level quantized allreduce (ops/hierarchical.py) is "
                "not ported yet (ROADMAP item 8's remainder; it needs "
                "item 10's process sets)")
        self._opt = optimizer
        self._compression = compression
        #: the WireSpec of the floating buckets' wire (None: uncompressed)
        self.wire = wire
        self._op = op
        self._k = backward_passes_per_step
        self._predivide = gradient_predivide_factor
        self._size = st.size

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
        self._plan(named, fusion_threshold_bytes)
        # the int8 wire's block, and this rank's error-feedback residual
        # of each floating bucket (none under int8-raw or at world 1)
        self._int8_block = wire.block if int8 else None
        self._residuals: Dict[int, torch.Tensor] = {}
        if int8 and wire.error_feedback and self._size > 1:
            for b, plan in enumerate(self._plans):
                first = self._params[plan[0][0]]
                if wire_applies(wire, first.dtype):
                    self._residuals[b] = torch.zeros(
                        sum(size for (_, _, size, _) in plan),
                        dtype=torch.float32, device=first.device)
        self._install_hooks()

    def _plan(self, named, fusion_threshold_bytes,
              backward_order: Optional[bool] = None) -> None:
        """Order the parameters that take gradients as the flax tree of
        their names flattens, plan their buckets, and map each to its
        bucket."""
        dups = [n for n, c in Counter(n for n, _ in named).items() if c > 1]
        if dups:
            raise ValueError(f"duplicate parameter names: {sorted(dups)}")
        named = [(n, p) for n, p in named if p.requires_grad]
        paths = [flax_path(n) for n, _ in named]
        order = flatten_order(paths)
        self._params = [named[i][1] for i in order]
        self._names = [named[i][0] for i in order]
        self._plans = pytree_bucket_plan(
            [(paths[i], tuple(named[i][1].shape), named[i][1].dtype)
             for i in order],
            threshold_bytes=fusion_threshold_bytes,
            backward_order=backward_order)
        self._bucket_of: Dict[int, int] = {}
        for b, plan in enumerate(self._plans):
            for (i, _, _, _) in plan:
                self._bucket_of[id(self._params[i])] = b

    def _install_hooks(self) -> None:
        """The per-step state, and a post-accumulate-grad hook on every
        parameter in a world of more than one rank."""
        self._lock = threading.Lock()
        self._reset()
        self._hooks = []
        if self._size > 1:
            for p in self._params:
                self._hooks.append(
                    p.register_post_accumulate_grad_hook(self._hook))

    # -- per-step state --------------------------------------------------

    def _reset(self) -> None:
        self._passes = {id(p): 0 for p in self._params}
        self._missing = [len(plan) for plan in self._plans]
        self._next = 0      # next bucket to issue, in plan order
        self._pending: List = []

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
            self._missing[self._bucket_of[key]] -= 1
            while (self._next < len(self._plans)
                   and self._missing[self._next] == 0):
                self._issue(self._next)
                self._next += 1

    def _grads(self, b: int) -> List[torch.Tensor]:
        """The gradients of every leaf, after giving bucket ``b``'s leaves
        that got none this step zeros."""
        for (i, _, _, _) in self._plans[b]:
            p = self._params[i]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self._params]

    def _issue(self, b: int) -> None:
        """Pack bucket ``b`` and start its reduction."""
        bucket, = pack_buckets_by_plan(self._grads(b), [self._plans[b]])
        if self._k > 1:
            bucket.div_(self._k)
        if self._predivide != 1.0:
            scale_(bucket, 1.0 / self._predivide)
        if self._int8_block is not None and wire_applies(self.wire,
                                                         bucket.dtype):
            self._pending.append((b, self._start_int8(b, bucket)))
            return
        wire, ctx = self._compression.compress(bucket)
        work = dist.all_reduce(wire, op=dist_op(self._op), async_op=True)

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
        """Enqueue bucket ``b``'s quantized SUM up to its gathers; carry
        its new residual. Returns the bucket's finish."""
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

    # -- public surface --------------------------------------------------

    def synchronize(self) -> None:
        """Finish this step's reduction: issue the buckets not issued
        yet, wait for all, and write the results into ``.grad``."""
        if self._size <= 1:
            if self._k > 1:
                for p in self._params:
                    if p.grad is not None:
                        p.grad.div_(self._k)
            return
        with self._lock:
            while self._next < len(self._plans):
                self._issue(self._next)
                self._next += 1
            pending, self._pending = self._pending, []
            self._reset()
        for b, finish in pending:
            out = finish()
            leaves = unflatten_buckets_by_plan([out], [self._plans[b]],
                                               len(self._params))
            for (i, _, _, _) in self._plans[b]:
                g = self._params[i].grad
                g.copy_(leaves[i].to(g.dtype))

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


def DistributedOptimizer(optimizer, named_parameters=None, compression=None,
                         backward_passes_per_step: int = 1,
                         op=ReduceOp.AVERAGE,
                         gradient_predivide_factor: float = 1.0,
                         fusion_threshold_bytes: Optional[int] = None):
    """Wrap a torch optimizer so that ``step()`` applies gradients
    averaged (``op``) over every rank. ``named_parameters`` names the
    parameters (their flax names order the fusion buckets); without it
    they are named by position. ``compression=None`` takes the
    compressor the ``HOROVOD_COMPRESSION`` knob selects (default none).
    ``fusion_threshold_bytes`` overrides ``HOROVOD_FUSION_THRESHOLD``."""
    return _DistributedOptimizer(
        optimizer, named_parameters=named_parameters,
        compression=compression,
        backward_passes_per_step=backward_passes_per_step, op=op,
        gradient_predivide_factor=gradient_predivide_factor,
        fusion_threshold_bytes=fusion_threshold_bytes)
