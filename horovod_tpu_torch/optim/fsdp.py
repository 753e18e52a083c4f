"""ZeRO-3 / FSDP: parameters fully sharded over the data-parallel ranks.

The port of the JAX package's ``optim/fsdp.py``. ZeRO-1
(``optim/zero.py``) shards the optimizer state but keeps every
parameter on every rank; here the parameters themselves live as the
same per-bucket padded row stacks the ZeRO state uses (``(n, k_i)``
rows, row r = rank r's shard, laid out by ``ops/fusion.py``'s
backward-availability bucket plan), and a rank holds only its rows:

* **forward**: each bucket's rows are all-gathered to the full bucket
  shortly before the first stage that reads it and dropped after the
  last (``ops/overlap.fsdp_staged_value_and_grad``; with the default
  regather policy the backward gathers them again);
* **backward**: each gradient bucket is packed (B6) and reduce-scattered
  at its availability boundary through ZeRO's chain
  (``zero._start_scatter_bucket``), on the int8 wire with error
  feedback on a residual private to the rank (:class:`FsdpEFState`);
* **update**: the inner torch optimizer, built over this rank's shards
  (so its state is 1/n, as ZeRO-1's), steps the shards in place: no
  update all-gather, the parameters never exist replicated.

Entry points: :func:`FullyShardedOptimizer` (or
``ShardedOptimizer(params_sharded=True)``), which
``parallel/train.make_lm_train_step`` routes to the FSDP step (the
HOROVOD_FSDP knob). Numerics: every staged mode is bitwise the gathered
reference (:func:`fsdp_value_and_grad` with ``mode="upfront"``) on the
float32 and int8 + error-feedback wires.

Where the port differs: a world of one rank is a layout too (rows of
``(1, L_i)``: the buckets themselves), so the FSDP step also runs on one
card; the JAX package's ``param_row_specs`` and ``param_row_shardings``
place the rows on a device mesh, which a world of one process per card
does not need: each rank already holds only its rows. (A live fsdp
axis under a replicated optimizer, the rules' ZeRO-3 on a mesh, is
``parallel/fsdp_axis.py``.) ``save_fsdp`` / ``load_fsdp`` come with the
checkpointer (entry 8).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch

from ..ops.fusion import (flatten_order, flax_path, pack_buckets_by_plan,
                          plan_bucket_lengths, pytree_bucket_plan,
                          unflatten_buckets_by_plan)
from ..ops.overlap import StagedShards, _reducer_info
from . import zero as zero_mod
from .compression import Compression, compressor_wire_spec


class FsdpLayout(NamedTuple):
    """The sharded-parameter layout, derived from the parameters' names,
    shapes and dtypes, the fusion threshold, the bucket order and the
    world size alone, so the optimizer, the staged runner and
    :func:`reshard_rows` agree on it. ``names`` are the leaves in flatten
    order (their flax paths, dotted), ``plans`` the per-bucket leaf
    layout of ``fusion.pytree_bucket_plan``, ``lens[i]`` bucket i's
    element count and ``ks[i] = ceil(lens[i] / world)`` a rank's shard
    width."""

    names: tuple
    shapes: tuple
    plans: tuple
    lens: tuple
    ks: tuple
    dtypes: tuple
    world: int
    nleaves: int

    @property
    def param_bytes(self) -> int:
        """Unsharded parameter bytes (the replicated footprint)."""
        return sum(int(L) * _itemsize(d)
                   for L, d in zip(self.lens, self.dtypes))

    @property
    def shard_bytes(self) -> int:
        """A rank's resident parameter bytes under this layout."""
        return sum(int(k) * _itemsize(d)
                   for k, d in zip(self.ks, self.dtypes))

    @property
    def max_bucket_bytes(self) -> int:
        """The largest gathered bucket."""
        return max((int(k) * self.world * _itemsize(d)
                    for k, d in zip(self.ks, self.dtypes)), default=0)

    @property
    def bucket_of(self) -> tuple:
        """The bucket of each leaf."""
        out = [0] * self.nleaves
        for bi, bp in enumerate(self.plans):
            for (i, _, _, _) in bp:
                out[i] = bi
        return tuple(out)

    def leaf_dtypes(self) -> List[torch.dtype]:
        return [self.dtypes[b] for b in self.bucket_of]


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def bucket_name(i: int) -> str:
    return f"bucket_{i:04d}"


def fsdp_layout(named_params, world: Optional[int] = None,
                fusion_threshold_bytes=None,
                bucket_backward_order=None) -> FsdpLayout:
    """The layout of ``named_params``, ``(name, tensor)`` pairs (meta
    tensors do: the plan reads shapes and dtypes only). ``world``
    defaults to the initialized world's size; the threshold and the
    order to the knobs."""
    if world is None:
        from ..core.basics import _require_init

        world = _require_init().size
    world = int(world)
    if world < 1:
        raise ValueError(f"fsdp_layout needs a world size >= 1, got {world}")
    leaves = [(name, tuple(t.shape), t.dtype) for name, t in named_params]
    paths = [flax_path(n) for n, _, _ in leaves]
    order = flatten_order(paths)
    leaves = [leaves[i] for i in order]
    plans = pytree_bucket_plan(
        [(flax_path(n), s, d) for n, s, d in leaves],
        threshold_bytes=fusion_threshold_bytes,
        backward_order=bucket_backward_order)
    lens = plan_bucket_lengths(plans)
    return FsdpLayout(
        names=tuple(n for n, _, _ in leaves),
        shapes=tuple(s for _, s, _ in leaves),
        plans=tuple(tuple(bp) for bp in plans),
        lens=tuple(int(L) for L in lens),
        ks=tuple(-(-int(L) // world) for L in lens),
        dtypes=tuple(leaves[bp[0][0]][2] for bp in plans),
        world=world,
        nleaves=len(leaves))


def abstract_params(layout: FsdpLayout) -> dict:
    """The full parameters as meta tensors, by name: their shapes and
    dtypes without their values."""
    dt = layout.leaf_dtypes()
    return {n: torch.empty(s, dtype=d, device="meta")
            for n, s, d in zip(layout.names, layout.shapes, dt)}


def _leaves_in_order(named, layout: FsdpLayout) -> List[torch.Tensor]:
    by_name = dict(named)
    missing = [n for n in layout.names if n not in by_name]
    if missing:
        raise ValueError(f"parameters missing for the layout: {missing}")
    return [by_name[n] for n in layout.names]


def shard_params(named_params, layout: FsdpLayout) -> dict:
    """Full parameters (``(name, tensor)`` pairs or a dict) to the row
    dict ``{bucket_NNNN: (world, k_i)}`` (zero-padded; row r is rank r's
    shard). It holds every rank's rows: tests, export and a rank picking
    its own row (:func:`local_shards`)."""
    named = named_params.items() if isinstance(named_params, dict) \
        else named_params
    leaves = [t.detach() for t in _leaves_in_order(named, layout)]
    buckets = pack_buckets_by_plan(leaves, layout.plans)
    return {bucket_name(i): zero_mod._pad_rows(b, layout.world)
            for i, b in enumerate(buckets)}


def unshard_params(rows, layout: FsdpLayout) -> dict:
    """Row dict back to the full parameters, by name. It materializes a
    replica: tests and small-model export only; training never calls
    it (the staged runner gathers bucket by bucket)."""
    buckets = [rows[bucket_name(i)].reshape(-1)[:L]
               for i, L in enumerate(layout.lens)]
    leaves = unflatten_buckets_by_plan(buckets, layout.plans,
                                       layout.nleaves)
    return dict(zip(layout.names, leaves))


def local_shards(rows, layout: FsdpLayout,
                 rank: Optional[int] = None) -> List[torch.Tensor]:
    """This rank's ``(k_i,)`` shards, in bucket order, from a row dict:
    a whole ``(world, k)`` stack gives up row ``rank`` (default: this
    process's rank), a ``(1, k)`` row or a ``(k,)`` shard itself."""
    out = []
    for i, k in enumerate(layout.ks):
        r = rows[bucket_name(i)]
        if r.dim() == 2 and r.shape[0] == 1:
            out.append(r.reshape(-1))
        elif r.dim() == 1:
            out.append(r)
        elif r.dim() == 2 and r.shape[0] == layout.world:
            if rank is None:
                from ..core.basics import _require_init

                rank = _require_init().rank
            out.append(r[rank])
        else:
            raise ValueError(
                f"{bucket_name(i)} arrived with shape {tuple(r.shape)} — "
                f"expected the ({layout.world}, {k}) stack, one (1, {k}) "
                f"row or a ({k},) shard")
    return out


def apply_shard_updates(rows, updates: Sequence[torch.Tensor],
                        layout: FsdpLayout) -> dict:
    """Add per-bucket update shards to the local parameter shards (the
    FSDP counterpart of applying an optimizer's updates; a torch
    optimizer steps its shards in place, so
    :class:`FullyShardedOptimizer` does not need it). Returns a row dict
    with each entry's incoming shape."""
    shards = local_shards(rows, layout)
    if len(updates) != len(shards):
        raise ValueError(f"{len(updates)} update shards for "
                         f"{len(shards)} buckets")
    return {bucket_name(i): (s + u.to(s.dtype)).reshape(
        rows[bucket_name(i)].shape)
        for i, (s, u) in enumerate(zip(shards, updates))}


def reshard_rows(rows, layout: FsdpLayout, new_world: int) -> dict:
    """Re-slice the parameter rows across a change of world size (the
    parameter twin of ``zero.reshard_state``): shapes only, no
    collectives; returns rows laid out for ``new_world``."""
    if new_world == layout.world:
        return dict(rows)
    if new_world < 1:
        raise ValueError(f"reshard_rows: new_world must be >= 1, got "
                         f"{new_world}")
    out = {}
    for i, L in enumerate(layout.lens):
        flat = rows[bucket_name(i)].reshape(-1)[:L]
        k2 = -(-L // new_world)
        padded = torch.zeros(new_world * k2, dtype=flat.dtype,
                             device=flat.device)
        padded[:L] = flat
        out[bucket_name(i)] = padded.reshape(new_world, k2)
    return out


class FsdpEFState(NamedTuple):
    """A FullyShardedOptimizer's state under the int8 error-feedback
    wire: the inner optimizer and one residual row per bucket, ``(1,
    world * k2_i)`` float32 (``k2_i``: the shard width padded to the
    block): this rank's private quantization error over the whole padded
    row stack it quantizes, compensating only its own contribution."""

    inner: Any
    residual: Any


def _residual_mats(state, layout: FsdpLayout, block: int):
    """The rank-private residual as per-bucket ``(world, k2)`` matrices,
    or None when the state carries none."""
    if not isinstance(state, FsdpEFState):
        return None
    n = layout.world
    mats = []
    for i, k in enumerate(layout.ks):
        k2 = -(-k // block) * block
        r = state.residual[i]
        if r.dim() == 2 and r.shape[0] == 1:
            r = r.reshape(-1)
        if tuple(r.shape) != (n * k2,):
            raise ValueError(
                f"error-feedback residual for {bucket_name(i)} has "
                f"shape {tuple(state.residual[i].shape)}, expected a "
                f"(1, {n * k2}) row — a compression-block knob change "
                "between construction and step")
        mats.append(r.reshape(n, k2))
    return mats


class _FullyShardedOptimizer:
    """See :func:`FullyShardedOptimizer`."""

    def __init__(self, optimizer: Callable, named_parameters,
                 compression=None, fusion_threshold_bytes=None,
                 bucket_backward_order=None, world: Optional[int] = None,
                 rank: Optional[int] = None, materialize=None):
        from ..core.basics import _require_init

        st = _require_init()
        self._size = st.size if world is None else int(world)
        self._rank = st.rank if rank is None else int(rank)
        comp = Compression.from_knobs(st.knobs) if compression is None \
            else compression
        self._compression = comp
        #: the WireSpec of the gradient reduce-scatter (None: float32)
        self.wire = compressor_wire_spec(comp)
        ef = (self.wire is not None and self.wire.kind == "int8"
              and self.wire.error_feedback)
        named = list(named_parameters)
        #: the sharded-parameter layout
        self.layout = fsdp_layout(
            named, world=self._size,
            fusion_threshold_bytes=fusion_threshold_bytes,
            bucket_backward_order=bucket_backward_order)
        leaves = _leaves_in_order(named, self.layout)
        if materialize is None and any(t.device.type == "meta"
                                       for t in leaves):
            raise ValueError("FullyShardedOptimizer takes the parameters' "
                             "values (it keeps this rank's rows of them) "
                             "or, for meta tensors, a materialize=")
        #: this rank's ``(k_i,)`` parameter rows, the tensors the inner
        #: optimizer steps
        if materialize is None:
            def materialize(sink):
                for name, t in zip(self.layout.names, leaves):
                    sink(name, t.detach())
        self.shards = _rank_rows(materialize, self.layout, self._rank)
        self._opt = optimizer(self.shards)
        #: this rank's error-feedback residual rows (None off the wire)
        self.residuals = None
        if ef:
            self.residuals = [
                torch.zeros(1, self._size * (-(-k // self.wire.block)
                                             * self.wire.block),
                            dtype=torch.float32, device=s.device)
                for k, s in zip(self.layout.ks, self.shards)]
        self._hvd_overlap_info = _fsdp_info(
            comp, self.wire, fusion_threshold_bytes, bucket_backward_order)

    @property
    def opt_state(self):
        """The state a staged step reads: :class:`FsdpEFState` under the
        int8 error-feedback wire, else the inner optimizer."""
        if self.residuals is None:
            return self._opt
        return FsdpEFState(inner=self._opt, residual=self.residuals)

    def step(self, grads=None):
        """Step the shards with the staged gradient shards of
        ``ops/overlap.fsdp_staged_value_and_grad`` (or the gathered
        reference)."""
        if not isinstance(grads, StagedShards):
            raise ValueError(
                "FullyShardedOptimizer.update consumes staged gradient "
                "shards (the reduce-scatters run inside the backward); "
                "build the step through overlap."
                "fsdp_staged_value_and_grad or fsdp.fsdp_value_and_grad "
                "— a full gradient pytree cannot drive it")
        g = grads.shards
        if len(g) != len(self.shards) or any(
                tuple(a.shape) != tuple(b.shape)
                for a, b in zip(g, self.shards)):
            raise ValueError(
                "staged gradient shards do not match the parameter "
                "shards' bucket layout — the staged value_and_grad must "
                "be built from the SAME layout")
        if self.residuals is not None:
            if grads.new_residuals is None:
                raise ValueError(
                    "this FullyShardedOptimizer carries error-feedback "
                    "state but the staged shards arrived without an "
                    "updated residual; pass opt_state= to the staged "
                    "value_and_grad")
        for t, gs in zip(self.shards, g):
            t.grad = gs.to(t.dtype)
        out = self._opt.step()
        if self.residuals is not None:
            self.residuals = [r.reshape(1, -1) for r in grads.new_residuals]
        return out

    def zero_grad(self, set_to_none: bool = True):
        return self._opt.zero_grad(set_to_none=set_to_none)

    def shard_state_bytes(self) -> int:
        """Bytes of the inner optimizer's state on this rank: 1/n of the
        replicated state, plus the padding of the last shards."""
        return zero_mod.state_bytes(self._opt)

    @property
    def param_groups(self):
        return self._opt.param_groups

    def state_dict(self):
        return self._opt.state_dict()

    def load_state_dict(self, sd):
        return self._opt.load_state_dict(sd)


def _rank_rows(materialize, layout: FsdpLayout,
               rank: int) -> List[torch.Tensor]:
    """Rank ``rank``'s row of each bucket, zero-padded, filled one
    parameter at a time without forming a bucket: ``materialize(sink)``
    hands each whole parameter to ``sink(name, tensor)`` (the given
    values, or ``Transformer.init_params(generator, sink=)``'s draws),
    which copies the ranges of the rank's rows the parameter covers.
    Drawn so, no two parameters are ever whole at once."""
    where = {layout.names[i]: (b, off, size)
             for b, plan in enumerate(layout.plans)
             for (i, off, size, _) in plan}
    rows: List[torch.Tensor] = []

    def sink(name: str, whole: torch.Tensor) -> None:
        if not rows:  # the first draw names the device
            rows.extend(torch.zeros(k, dtype=d, device=whole.device)
                        for k, d in zip(layout.ks, layout.dtypes))
        b, off, size = where.pop(name)
        k = layout.ks[b]
        lo, hi = rank * k, (rank + 1) * k
        a, z = max(lo, off), min(hi, off + size)
        if a < z:
            rows[b][a - lo:z - lo].copy_(whole.reshape(-1)[a - off:z - off])

    with torch.no_grad():
        materialize(sink)
    if where:
        raise ValueError(f"the materializer drew no {sorted(where)}")
    return rows


def _fsdp_info(comp, wire, threshold, order) -> dict:
    ef = wire is not None and wire.kind == "int8" and wire.error_feedback
    return dict(kind="fsdp", compression=comp,
                fusion_threshold_bytes=threshold,
                bucket_backward_order=order, process_set=None,
                backward_passes_per_step=1, error_feedback=ef, wire=wire)


class UnboundOptimizer:
    """An optimizer of this package waiting for its parameters: what
    ``ShardedOptimizer(factory)`` and ``FullyShardedOptimizer(factory)``
    return without ``named_parameters``. ``make_lm_train_step`` reads
    its kind from ``_hvd_overlap_info`` and binds it to the model it
    builds (:meth:`bind`)."""

    def __init__(self, build: Callable, info: dict):
        self._build = build
        self._hvd_overlap_info = info

    def bind(self, named_parameters, **kwargs):
        """The optimizer over ``named_parameters``; ``kwargs`` go to its
        constructor (``process_set=`` for a ZeRO-1 optimizer on a mesh's
        data axis)."""
        return self._build(named_parameters, **kwargs)


def FullyShardedOptimizer(optimizer: Callable, named_parameters=None,
                          compression=None,
                          fusion_threshold_bytes: Optional[int] = None,
                          bucket_backward_order: Optional[bool] = None,
                          world: Optional[int] = None,
                          rank: Optional[int] = None):
    """Fully-sharded (ZeRO-3) training: parameters and optimizer state
    live as per-bucket row shards, 1/n on each rank.

    ``optimizer`` makes the inner torch optimizer from a list of tensors
    (e.g. ``functools.partial(torch.optim.AdamW, lr=1e-4)``; any
    optimizer elementwise in its state); it is built over this rank's
    shards. ``named_parameters`` gives the full parameters' names and
    values, of which this rank keeps its rows (``shards``); without it
    the result is an :class:`UnboundOptimizer` for
    ``make_lm_train_step``, whose ``bind`` also takes meta parameters
    with ``materialize=``, a callable that draws each whole parameter
    into ``sink(name, tensor)`` one at a time
    (``Transformer.init_params(generator, sink=)``): the rows are then
    filled draw by draw, bitwise the same, and no rank holds the
    model. ``compression=None`` takes the
    HOROVOD_COMPRESSION knob's wire; the int8 wire runs with error
    feedback on the rank-private residual. ``world`` and ``rank`` default
    to the initialized world's (they differ only for a world emulated
    in one process).

    ``step(staged)`` consumes the :class:`~horovod_tpu_torch.ops.overlap.
    StagedShards` of ``overlap.fsdp_staged_value_and_grad`` or
    :func:`fsdp_value_and_grad` (pass them ``opt_state=opt.opt_state``)
    and steps the shards in place: there is no update all-gather. A
    plain ``step()`` raises."""
    if named_parameters is None:
        comp = Compression.from_knobs() if compression is None \
            else compression
        return UnboundOptimizer(
            functools.partial(
                _FullyShardedOptimizer, optimizer, compression=comp,
                fusion_threshold_bytes=fusion_threshold_bytes,
                bucket_backward_order=bucket_backward_order, world=world,
                rank=rank),
            _fsdp_info(comp, compressor_wire_spec(comp),
                       fusion_threshold_bytes, bucket_backward_order))
    return _FullyShardedOptimizer(
        optimizer, named_parameters, compression=compression,
        fusion_threshold_bytes=fusion_threshold_bytes,
        bucket_backward_order=bucket_backward_order, world=world,
        rank=rank)


def fsdp_value_and_grad(stages_fn, opt, layout: FsdpLayout,
                        mode: str = "prefetch", prefetch=None,
                        regather=None, offload=None):
    """Build ``vag(shards, *batch, opt_state=None, exchange=None,
    side=None) -> (loss, StagedShards)`` over fully-sharded parameter
    rows.

    ``mode="prefetch"`` (the real path) is
    ``ops/overlap.fsdp_staged_value_and_grad``. ``mode="upfront"`` is
    the gathered reference: every bucket all-gathered first, one
    backward over the whole composed forward, then each bucket's pack
    (B6) and reduce-scatter in bucket order. All modes share every
    reduce and update op, which is what makes them bitwise equal."""
    from ..ops import overlap as overlap_mod

    if mode == "prefetch":
        return overlap_mod.fsdp_staged_value_and_grad(
            stages_fn, opt, layout, prefetch=prefetch, regather=regather,
            offload=offload)
    if mode != "upfront":
        raise ValueError(f"unknown fsdp mode {mode!r} "
                         "(expected prefetch|upfront)")
    info = _reducer_info(opt)
    if info["kind"] != "fsdp":
        raise ValueError(
            "fsdp_value_and_grad needs a FullyShardedOptimizer "
            "(ShardedOptimizer(params_sharded=True)); got kind "
            f"{info['kind']!r}")

    def vag(shards, *batch, opt_state=None, exchange=None, side=None):
        from ..core.basics import _require_init
        from ..ops.ring_pack import maybe_pack_rows

        if exchange is None:
            exchange = overlap_mod.WorldExchange(_require_init().size)
        n = exchange.n
        if n != layout.world:
            raise ValueError(
                f"parameter rows were sharded for world {layout.world} "
                f"but the live group size is {n}")
        wire = info.get("wire")
        ef = bool(info.get("error_feedback"))
        res_mats = _residual_mats(opt_state, layout, wire.block) \
            if ef else None
        if ef and res_mats is None:
            raise ValueError(
                "this FullyShardedOptimizer carries error-feedback state; "
                "pass opt_state= so the residual rides the quantized "
                "reduce-scatters")
        device = shards[0].device
        side = overlap_mod.SideStream(device) if side is None else side
        # the naive order: every bucket gathered up front, a whole
        # replica of the parameters alive for the step
        finishes = []
        for bi, s in enumerate(shards):
            out = side.empty(n * s.numel(), s.dtype)
            finishes.append(side.issue(
                lambda _bi=bi, _s=s, _o=out: exchange.gather(_bi, _s, _o)))
        full = [side.consume(f, "gather", bi)[:L]
                for bi, (f, L) in enumerate(zip(finishes, layout.lens))]
        leaves = [v.detach().requires_grad_() for v in
                  unflatten_buckets_by_plan(full, layout.plans,
                                            layout.nleaves)]
        params = dict(zip(layout.names, leaves))
        stages = stages_fn(*batch)
        carry = torch.zeros((), dtype=torch.float32, device=device)
        for st in stages:
            sub = {k: v for k, v in params.items()
                   if k.split(".", 1)[0] in st.keys}
            carry = st.fwd(sub, carry)
        loss = carry
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g
                 for g, v in zip(grads, leaves)]
        reduced, new_res = [], []
        for bi, b in enumerate(pack_buckets_by_plan(grads, layout.plans)):
            res = None if res_mats is None else res_mats[bi]

            def go(_bi=bi, _b=b, _res=res):
                return exchange.scatter(_bi, maybe_pack_rows(_b, n), wire,
                                        _res)

            got = side.consume(side.issue(go), "scatter", bi)
            if ef:
                reduced.append(got[0])
                new_res.append(got[1].reshape(1, -1))
            else:
                reduced.append(got)
        return loss.detach(), StagedShards(
            reduced, new_residuals=new_res if ef else None)

    return vag
