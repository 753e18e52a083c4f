"""The causal-LM training step, data-, tensor- and sequence-parallel.

The JAX package's ``parallel/train.py`` ``make_lm_train_step`` jits one
step over a mesh, XLA partitioning it by the parameters' shardings.
The port runs one process a rank, so the step keeps this rank's shards
(``parallel/sharding.py``) and issues the exchanges itself:

* the rows of the global batch split over the data axes (dp, fsdp),
  each rank taking its own (``data.ShardedDataLoader(mesh=...)``
  hands them out);
* tp splits heads, MLP width and a vocab the axis divides; the
  exchanges are ``parallel/tensor_parallel.py``'s;
* sp splits the sequence: a rank takes its span of its rows (global
  positions; the targets run one token past the span) and attention
  runs over the ring (``ring_attention.py``) or by all-to-all
  (``ulysses.py``). The parameters are whole on every sp rank: their
  gradients are summed over the sp axis as the backward produces them;
* fsdp splits the rules' fsdp dimensions (ZeRO-3 by sharding): a rank
  keeps its slices and the optimizer its state of them; a block's
  weights are gathered when it runs and their gradients reduce-scattered
  over fsdp (``fsdp_axis.py``), the whole parameters' summed over it;
* the loss is the global batch's mean, ``Σ nll / Σ valid`` over every
  rank's targets, its two sums reduced over the sp and data axes (not
  over tp, whose ranks hold the same sums);
* the gradients reduce over the data axes: the ``DistributedOptimizer``
  or ZeRO-1 ``ShardedOptimizer`` runs on the data axis's process set,
  over dp only when fsdp is live (its sum is the reduce-scatter's). On
  an emulated mesh a live dp axis averages through its communicator.

Without a mesh the step takes ``hvd.mesh()`` (``HOROVOD_MESH``; unset,
one dp axis over the world: the data-parallel step of earlier slices,
bit for bit). A ``FullyShardedOptimizer`` (``fsdp``) takes the
fully-sharded step (:func:`_fsdp_step_fn`; HOROVOD_FSDP gates it)
over a mesh whose only live axis, if any, is one data axis: its
world. Every
other optimizer takes the hook-driven step, whatever
HOROVOD_OVERLAP_SCHEDULE says: its hooks already issue each bucket of
the backward-ordered plan at the boundary where the JAX package's
staged schedule issues it (``ops/overlap.py``).

A live pp or ep axis raises ``ValueError``: the JAX step's rules name
neither axis, so there it only repeats the same work. Pipelines train
through ``parallel/pipeline.py`` (``pipeline_lm_train_step_1f1b``) and
experts route over an ep axis in ``models/moe.MoeMlp``.

``fused_ce`` with a vocab split over tp raises ``ValueError``: the JAX
step has no fused loss, and the port's (``fused_ce``) computes its
vocab blocks whole.

The model is built on the meta device and each rank draws its own
slices into it, one parameter at a time
(``sharding.materialize_shards``; the FSDP step its bucket rows,
``FullyShardedOptimizer.bind(materialize=)``): every parameter is drawn
whole from the seed into a temporary and dropped once the rank has kept
its part, so no rank holds the whole model and every rank's slices are
bitwise those of the whole model, as the JAX package's ``init_fn``
initializes straight into the shardings. The optimizer's state is made
at its first step from the slices (``torch.optim``'s lazy state), where
the JAX ``init_fn`` also returns it in its shardings.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.basics import _require_init
from ..models.transformer import (Transformer, TransformerConfig,
                                  causal_lm_nll, lm_nll)
from ..ops.collectives import Sum, allreduce
from ..ops.fused_cross_entropy import fused_linear_cross_entropy
from ..ops.overlap import schedule_mode
from ..optim.distributed import DistributedOptimizer
from ..optim.functions import broadcast_parameters
from . import sharding as sharding_lib
from .comm import SelfComm, reduce_grads, sum_in_rank_order
from .fsdp_axis import FsdpAxis
from .mesh import AXIS_ORDER, DATA_AXES, Mesh, data_axes, mesh_from_spec
from .ring_attention import make_ring_attention_fn
from .tensor_parallel import TensorParallel, parallelize
from .ulysses import make_ulysses_attention_fn

#: the axes this step refuses, and where their work is done instead
_ELSEWHERE = {"pp": "pipelines train through "
                    "parallel.pipeline.pipeline_lm_train_step_1f1b",
              "ep": "experts route over an ep axis in models.moe.MoeMlp"}


def sp_attention_fn(mesh: Mesh, kind: str = "ring", causal: bool = True):
    """``attention_fn`` running over the mesh's sp axis: ring attention
    (``kind="ring"``) or Ulysses (``"ulysses"``); an sp axis of size 1
    is a ring of one."""
    comm = mesh.comm("sp") or SelfComm()
    if kind == "ring":
        return make_ring_attention_fn(comm, causal)
    if kind == "ulysses":
        return make_ulysses_attention_fn(comm, causal)
    raise ValueError(f"sequence_parallel={kind!r}: 'ring' or 'ulysses'")


def _resolve_mesh(mesh, st) -> Mesh:
    """The step's mesh: ``hvd.mesh()`` for None, a spec string parsed
    over the world, a :class:`Mesh` bound to it (collective)."""
    if mesh is None:
        from ..core.basics import mesh as global_mesh

        return global_mesh()
    if isinstance(mesh, str):
        mesh = mesh_from_spec(mesh, st.size, st.rank)
    return mesh.bind()


def _is_fsdp(optimizer) -> bool:
    info = getattr(optimizer, "_hvd_overlap_info", None)
    return info is not None and info.get("kind") == "fsdp"


def build_sharded(cfg: TransformerConfig, mesh: Mesh, device=None,
                  rules=None, attention_fn=None, seed: int = 0):
    """``(model, specs)``: ``cfg``'s model built on the meta device, then
    given this rank's slices of its seed-``seed`` weights on ``device``
    (default: the card) by ``rules``' pruned specs on ``mesh``, one
    parameter at a time (``sharding.materialize_shards``). ``specs`` is
    None, and every parameter whole, without a live tp or fsdp axis.
    ``mesh`` need not be bound: only its coordinates are read, so one
    rank of a mesh can be built without its peers."""
    device = sharding_lib.build_device(device, "build_sharded")
    with torch.device("meta"):
        model = Transformer(cfg, attention_fn=attention_fn)
    specs = None
    if mesh.axis_size("tp") > 1 or mesh.axis_size("fsdp") > 1:
        specs = sharding_lib.make_param_shardings(
            model.named_parameters(), mesh, rules)
    generator = torch.Generator(device=device).manual_seed(seed)
    sharding_lib.materialize_shards(model, generator, specs, mesh)
    return model, specs


def _sum_grads_over(model, comm) -> None:
    """Sum each parameter's gradient over ``comm``'s ranks as the
    backward produces it (a hook on the leaf, before accumulation)."""
    for p in model.parameters():
        if p.requires_grad:
            p.register_hook(comm.all_reduce)


def make_lm_train_step(cfg: TransformerConfig, optimizer, *,
                       attention_fn=None, device=None, mesh=None,
                       sequence_parallel: Optional[str] = None,
                       rules=None, fused_ce: bool = False):
    """Build ``(model, step)`` for causal-LM training on ``mesh``.

    ``optimizer`` is either a factory of the inner torch optimizer over
    the parameters (e.g. ``functools.partial(torch.optim.AdamW, lr=1e-4,
    weight_decay=1e-4)``), which the step wraps in
    ``DistributedOptimizer`` over the mesh's data axis after
    broadcasting its first rank's weights over it, or an optimizer of
    this package given no parameters (``ShardedOptimizer(factory)``,
    ``FullyShardedOptimizer(factory)``), which the step binds to the
    model. The model is built on the meta device and takes random
    weights from seed 0 on ``device`` (default: the device ``init()``
    chose), drawn one parameter at a time: on a mesh with a live tp or
    fsdp axis each rank keeps only its slices of them by ``rules``
    (default ``sharding.TRANSFORMER_RULES``), bitwise the whole model's
    (``sharding.materialize_shards``), so no rank ever holds the whole
    model.

    ``mesh``: a :class:`~horovod_tpu_torch.parallel.mesh.Mesh`, a spec
    (``"dp=2,tp=2"``) or None (``hvd.mesh()``). ``sequence_parallel``
    (``"ring"`` or ``"ulysses"``) runs attention over the sp axis; it
    replaces ``attention_fn``. ``step(tokens) -> loss`` runs the
    forward, the causal-LM loss, the backward and the optimizer step on
    this rank's ``[B, T]`` rows of the global batch (the rows of its
    data coordinate; ranks that differ only in tp or sp pass the same
    rows), of which it keeps its sequence span under sp. As in the JAX
    package's step, the loss is the global batch's mean, ``Σ nll / Σ
    valid`` over every target (``ignore_index`` -1 excluded), and the
    gradients are its gradients, however unevenly the targets are
    padded; the step returns that loss. ``step.optimizer`` is the
    optimizer, ``step.mesh`` the mesh, ``step.specs`` each parameter's
    spec (None without tp) and ``step.backward(tokens)`` the step
    without the optimizer's (the gradients left in ``.grad``; the
    loss returned).

    ``fused_ce`` computes the LM head and the loss together with
    :func:`~horovod_tpu_torch.ops.fused_cross_entropy.fused_linear_cross_entropy`
    (vocab blocks, the logits never whole in memory) from the model's
    pre-head activations: the same two sums, so the same denominator
    and backward; a vocab split over tp raises.

    Under a ``FullyShardedOptimizer`` the returned model's parameters
    stay on the meta device: each one is drawn whole and copied into
    the ranges of this rank's bucket rows it covers
    (``step.optimizer.shards``; ``step.state_dict()`` gathers a full
    copy). The optimizer's state (AdamW's moments) is made lazily at its
    first step, from the slices or rows."""
    st = _require_init()
    schedule_mode(st.knobs)  # an unknown HOROVOD_OVERLAP_SCHEDULE raises
    device = sharding_lib.build_device(
        st.device if device is None else device, "make_lm_train_step")
    if sequence_parallel not in (None, "ring", "ulysses"):
        raise ValueError(f"sequence_parallel={sequence_parallel!r}: None, "
                         "'ring' or 'ulysses'")
    mesh = _resolve_mesh(mesh, st)
    live = mesh.live_axes()
    unknown = [a for a in live if a not in AXIS_ORDER]
    if unknown:
        raise ValueError(f"mesh axes {unknown} are none of {AXIS_ORDER}")
    if _is_fsdp(optimizer):
        if sequence_parallel is not None:
            raise ValueError(
                "the FSDP step does not compose with manual sequence "
                "parallelism yet — use ShardedOptimizer or the "
                "DistributedOptimizer for sp meshes")
        axes = data_axes(mesh)
        extra = [a for a in live if a not in DATA_AXES]
        if extra or len(axes) > 1:
            raise ValueError(
                f"the FSDP step shards parameters over one live data axis "
                f"(the world); mesh has data axes {axes} and extra live "
                f"axes {extra}")
        with torch.device("meta"):
            model = Transformer(cfg, attention_fn=attention_fn)
        return model, _fsdp_step_fn(
            cfg, model, optimizer, fused_ce,
            torch.Generator(device=device).manual_seed(0))
    for axis, where in _ELSEWHERE.items():
        if mesh.axis_size(axis) > 1:
            raise ValueError(
                f"make_lm_train_step neither pipelines nor routes experts: "
                f"a live {axis} axis (mesh {mesh!r}) would only repeat its "
                f"work; {where}")
    if sequence_parallel is None and mesh.axis_size("sp") > 1:
        raise ValueError("a live sp axis needs sequence_parallel='ring' or "
                         "'ulysses'")
    if sequence_parallel is not None:
        if attention_fn is not None:
            raise ValueError("sequence_parallel chooses the attention; "
                             "pass no attention_fn with it")
        attention_fn = sp_attention_fn(mesh, sequence_parallel, cfg.causal)
    tp_comm, sp_comm = mesh.comm("tp"), mesh.comm("sp")
    fsdp_comm = mesh.comm("fsdp")
    model, specs = build_sharded(cfg, mesh, device, rules, attention_fn)
    fsdp = None
    if tp_comm is not None:
        parallelize(model, TensorParallel(tp_comm))
        head = (model.tok_emb.embedding.shape[0] if cfg.tie_embeddings
                else model.lm_head.kernel.shape[1])
        if fused_ce and head != cfg.vocab_size:
            raise ValueError(
                "fused_ce with a vocab split over tp: the JAX package's "
                "make_lm_train_step has no fused loss, and the port's "
                "computes its vocab blocks whole; train the split head "
                "without fused_ce")
    if fsdp_comm is not None:
        fsdp = FsdpAxis(model, specs, fsdp_comm)
    if sp_comm is not None:
        _sum_grads_over(model, sp_comm)
    data = [a for a in DATA_AXES if mesh.axis_size(a) > 1]
    # the optimizer reduces over the data axes but fsdp, whose sum the
    # gathers' reduce-scatters and the whole parameters' hooks take
    opt_axes = [a for a in data if fsdp is None or a != "fsdp"]
    n_avg = math.prod(mesh.axis_size(a) for a in opt_axes)
    emulated_dp = mesh.emulated and bool(opt_axes)
    if emulated_dp and getattr(optimizer, "_hvd_overlap_info",
                               None) is not None:
        raise ValueError(
            f"an emulated mesh has no process set over {tuple(opt_axes)} "
            "to bind the optimizer to; pass a plain optimizer factory "
            "(the step averages that axis through its communicator)")
    opt_set = None if emulated_dp else mesh.process_set(opt_axes)
    # the loss's sums reduce over each live data axis's communicator
    # where the optimizer's set does not span them all
    data_comms = ([mesh.comm(a) for a in data]
                  if fsdp is not None or mesh.emulated else [])
    data_set = None if data_comms else opt_set
    if not mesh.emulated:
        # the optimizer's axis starts from its first rank's weights (an
        # emulated rank's weights are every rank's, from the seed)
        root = 0 if opt_set is None else opt_set.ranks[0]
        broadcast_parameters(model.state_dict(), root_rank=root,
                             process_set=opt_set)
    if getattr(optimizer, "_hvd_overlap_info", None) is None:
        if emulated_dp:
            opt = _AxisAveraged(optimizer(model.parameters()),
                                mesh.comm(opt_axes[0]))
        else:
            opt = DistributedOptimizer(
                optimizer(model.parameters()),
                named_parameters=model.named_parameters(),
                process_set=opt_set)
    elif opt_set is None:
        opt = optimizer.bind(model.named_parameters())
    else:
        opt = optimizer.bind(model.named_parameters(), process_set=opt_set)

    sp_size = mesh.axis_size("sp")
    sp_rank = mesh.coord("sp")

    def local_inputs(tokens):
        """(inputs, positions, targets) of this rank's span; targets
        None when the span is the whole row (the usual shift)."""
        if sp_size == 1 and sequence_parallel is None:
            return tokens, None, None
        b, t = tokens.shape
        if t % sp_size:
            raise ValueError(f"sequence length {t} does not split over "
                             f"{sp_size} sp ranks")
        n = t // sp_size
        lo, hi = sp_rank * n, (sp_rank + 1) * n
        targets = tokens[:, lo + 1:hi + 1]
        if targets.shape[1] < n:  # the last span: no token follows
            targets = torch.cat([targets, targets.new_full(
                (b, n - targets.shape[1]), -1)], dim=1)
        positions = torch.arange(lo, hi, device=tokens.device).expand(b, n)
        return tokens[:, lo:hi], positions, targets

    def nll_sums(tokens):
        if fsdp is None:
            return _nll_sums(tokens)
        with fsdp.outer():
            return _nll_sums(tokens)

    def _nll_sums(tokens):
        inputs, positions, targets = local_inputs(tokens)
        if fused_ce:
            hidden = model(inputs, positions, return_hidden=True)
            if targets is None:
                hidden, targets = hidden[:, :-1], inputs[:, 1:]
            w = (model.tok_emb.embedding.t() if cfg.tie_embeddings
                 else model.lm_head.kernel)
            return fused_linear_cross_entropy(
                hidden, w, targets, valid=targets != -1, mean=False)
        logits = model(inputs, positions)
        if targets is None:
            return causal_lm_nll(logits, inputs)
        return lm_nll(logits, targets)

    def backward(tokens: torch.Tensor) -> torch.Tensor:
        nll, count = nll_sums(tokens)
        w, loss = _global_mean_weight(
            nll, count, n_avg, data_set, sp_comm,
            not mesh.emulated and not data_comms, data_comms)
        (nll * w).backward()
        return loss

    def step(tokens: torch.Tensor) -> torch.Tensor:
        loss = backward(tokens)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss

    step.optimizer, step.mesh, step.specs = opt, mesh, specs
    step.backward, step.fsdp = backward, fsdp
    return model, step


class _AxisAveraged:
    """The data-parallel average of an emulated mesh's live dp axis,
    through its communicator (an emulated mesh has no process set):
    :meth:`synchronize` sums every gradient over the axis in one
    exchange (rank order, float32) and divides by its size, as the
    ``DistributedOptimizer`` averages; :meth:`step` synchronizes first."""

    def __init__(self, optimizer, comm):
        self._opt, self.comm = optimizer, comm
        self._synced = False

    def synchronize(self) -> None:
        if self._synced:
            return
        reduce_grads([p for g in self._opt.param_groups
                      for p in g["params"]], self.comm, average=True)
        self._synced = True

    def step(self, closure=None):
        self.synchronize()
        return self._opt.step(closure)

    def zero_grad(self, set_to_none: bool = True):
        self._synced = False
        self._opt.zero_grad(set_to_none=set_to_none)

    def __getattr__(self, item):
        return getattr(self._opt, item)


def _global_mean_weight(nll, count, size, process_set=None, sp=None,
                        data: bool = True, data_comms=()):
    """One denominator for every rank, before the backward: the data
    axis's ``size`` ranks average ``Σ nll_r · size / n``, which is the
    gradient of the global mean ``Σ_r Σ nll_r / n``; the sums reduce
    over the sp ranks (``sp``, a communicator) and, with ``data``, the
    data ranks (``process_set``, None: the world), or over each of
    ``data_comms`` in turn (float64, rank order: a live fsdp axis or an
    emulated mesh), not over tp. Returns ``(size / n,
    the global mean)``."""
    sums = torch.stack([nll.detach().double(), count.double()])
    if sp is not None:
        sums = sp.all_reduce(sums)
    if data:
        sums = allreduce(sums, op=Sum, process_set=process_set)
    for c in data_comms:
        sums = sum_in_rank_order(c.all_gather(sums), torch.float64)
    n = sums[1].clamp(min=1)
    return (size / n).float(), sums[0].float() / n.float()


def _count_weighted_stages(model, fused_ce: bool, size: int):
    """``stages_for(tokens, out) -> stages`` for the FSDP step: embed ->
    blocks -> head, whose loss is this rank's ``Σ nll`` weighted by
    ``size / Σ valid`` over every rank, as the hook-driven step weights
    it (the all-reduce of the two sums runs inside the head, once a
    step); the global mean goes to ``out["loss"]``."""
    from ..ops import overlap as overlap_mod

    cfg = model.cfg

    def stages_for(tokens, out):
        def weighted(nll, count):
            w, out["loss"] = _global_mean_weight(nll, count, size)
            return nll * w

        if fused_ce:
            targets = tokens[:, 1:]

            def fused(hidden, weight):
                return weighted(*fused_linear_cross_entropy(
                    hidden[:, :-1], weight, targets, valid=targets != -1,
                    mean=False))

            return overlap_mod.transformer_lm_stages(
                model, tokens, fused_loss_fn=fused)
        return overlap_mod.transformer_lm_stages(
            model, tokens,
            lambda logits: weighted(*causal_lm_nll(logits, tokens)))

    return stages_for


def _fsdp_step_fn(cfg, model, optimizer, fused_ce, generator):
    """The fully-sharded step of a ``FullyShardedOptimizer`` (every
    other optimizer takes its path bit for bit whatever HOROVOD_FSDP
    says) over ``model``, built on the meta device. Every rank draws
    the same seed-0 weights from ``generator`` one parameter at a time
    and keeps the ranges of its rows of each bucket that each covers
    (``optimizer.bind(materialize=)``): the model's parameters stay on
    the meta device, and the step gathers them bucket by bucket
    (``ops/overlap.fsdp_staged_value_and_grad``, with the FSDP knobs'
    prefetch, regather and offload). There is no fallback: the
    optimizer's step consumes staged shards only."""
    from ..ops import overlap as overlap_mod
    from ..optim import fsdp as fsdp_mod

    st = _require_init()
    if not st.knobs.fsdp:
        raise ValueError(
            "HOROVOD_FSDP=0 but the optimizer is a "
            "FullyShardedOptimizer — its update consumes staged shards "
            "and cannot ride the monolithic paths; turn the knob on or "
            "use ShardedOptimizer/DistributedOptimizer")
    opt = optimizer.bind(
        model.named_parameters(),
        materialize=lambda sink: model.init_params(generator, sink=sink))
    layout = opt.layout
    stages_for = _count_weighted_stages(model, fused_ce, st.size)
    holder = {}
    vag = overlap_mod.fsdp_staged_value_and_grad(
        lambda tokens: stages_for(tokens, holder), opt, layout)

    def step(tokens: torch.Tensor) -> torch.Tensor:
        holder.clear()
        _, grads = vag(opt.shards, tokens, opt_state=opt.opt_state)
        opt.step(grads)
        opt.zero_grad(set_to_none=True)
        return holder["loss"]

    def state_dict():
        """The full parameters by name (an all-gather of every bucket:
        a replica, for tests and export)."""
        from ..ops.collectives import _all_gather_tiled

        rows = {}
        for i, s in enumerate(opt.shards):
            full, work = _all_gather_tiled(s.detach().contiguous(),
                                           layout.world)
            work.wait()
            rows[fsdp_mod.bucket_name(i)] = full.reshape(layout.world, -1)
        return fsdp_mod.unshard_params(rows, layout)

    step.optimizer, step.layout, step.vag = opt, layout, vag
    step.state_dict = state_dict
    return step
