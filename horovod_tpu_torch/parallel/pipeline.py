"""Pipeline parallelism: the GPipe and 1F1B schedules over a pp axis.

The counterpart of the JAX package's ``parallel/pipeline.py``. There the
pipeline is one traced program under ``shard_map``: every stage runs the
same body and the activations hop between stages by ``lax.ppermute``.
The port runs one rank a stage. A rank of stage s of S holds the blocks
``[s·L/S, (s+1)·L/S)`` under their global names (:func:`build_stage`,
``Transformer(cfg, layers=...)``) and the replicated rest: the
embedding, the position table, ``ln_final`` and the head. It issues the
hops itself over the pp axis's communicator (``parallel/comm.py``:
``hop_forward``, stage i to i + 1, and ``hop_backward``, i + 1 to i), so
the same code runs over NCCL, gloo and the emulated ``ThreadWorld``.
Every rank calls every hop of a tick or slot, an idle rank sending
zeros, as the JAX program calls both ``ppermute``s outside its conds:
otherwise the ranks' exchanges no longer pair up.

* **GPipe** (:func:`gpipe`, :func:`pipeline_lm_apply`): ``M + S - 1``
  ticks; at tick t stage s runs microbatch ``t - s`` and hands its
  output on. A tick with no microbatch for a stage runs nothing there
  (the JAX scan computes it on zeros and discards it). The last stage's
  outputs go to every rank (the JAX masked ``psum``; its backward hands
  the last stage one copy of the cotangent), and only stage 0 reads the
  embedding, whose gradient every rank then takes from stage 0. The
  backward replays the ticks in reverse, the gradients hopping back,
  as ``jax.grad`` replays the scan. Every microbatch's activations are
  held between the two.
* **1F1B** (:func:`one_f_one_b`, :func:`pipeline_lm_train_step_1f1b`):
  the JAX slot clock over ``2(M + S - 1)`` slots, forward of
  microbatch m at slot ``s + 2m``, backward at ``2S - 1 - s + 2m``. A
  forward stores the stage's input in a ring of S slots and sends its
  output without keeping a graph (the last stage skips it: its
  backward recomputes it); a backward recomputes the stage from the
  stored input with grad enabled and back-propagates the gradient that
  arrived, on the last stage through the head and loss fused. So at
  most S stage inputs are stored, whatever M is.
* **Data axes.** The step takes this rank's rows of the global batch
  (its data coordinate's, ``sharding.batch_slices``; ranks that differ
  only in pp take the same rows). The loss's sums, its valid count and
  the gradients reduce over the data axes in rank order through their
  communicator (``comm.sum_in_rank_order``), so an emulated data axis
  works too.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..models.transformer import (Transformer, TransformerConfig,
                                  causal_lm_nll)
from .comm import GroupComm, SelfComm, reduce_grads
from .mesh import DATA_AXES, Mesh
from .sharding import build_device, materialize_shards

#: the live axes a pipeline runs on; any other only repeats its work
PIPELINE_AXES = ("pp",) + DATA_AXES


def stack_block_params(params: Dict[str, torch.Tensor],
                       prefix: str = "block_"):
    """Split a transformer state dict into ``(stacked, rest)``:
    ``stacked`` maps each block-relative name (``attn.query.kernel``) to
    the blocks' tensors stacked on a new leading dimension, in block
    order; ``rest`` keeps the embedding, head and final norm. A stage's
    state dict stacks its own blocks (its local stack)."""
    blocks: Dict[int, Dict[str, torch.Tensor]] = {}
    rest = {}
    for name, t in params.items():
        if name.startswith(prefix):
            index, _, leaf = name[len(prefix):].partition(".")
            blocks.setdefault(int(index), {})[leaf] = t
        else:
            rest[name] = t
    order = [blocks[i] for i in sorted(blocks)]
    stacked = {leaf: torch.stack([b[leaf] for b in order])
               for leaf in order[0]} if order else {}
    return stacked, rest


def unstack_block_params(stacked: Dict[str, torch.Tensor], rest,
                         prefix: str = "block_", first: int = 0):
    """The inverse of :func:`stack_block_params` (checkpoint
    interchange): the stack's i-th entry becomes block ``first + i``."""
    out = dict(rest)
    n = next(iter(stacked.values())).shape[0] if stacked else 0
    for i in range(n):
        for leaf, t in stacked.items():
            out[f"{prefix}{first + i}.{leaf}"] = t[i]
    return out


def stage_layers(cfg: TransformerConfig, mesh: Mesh,
                 rank: Optional[int] = None) -> range:
    """The blocks of ``rank``'s (default: the mesh's own) pp stage."""
    S = mesh.axis_size("pp")
    per = cfg.num_layers // S
    s = (mesh.coords if rank is None else mesh.coords_of(rank)).get("pp", 0)
    return range(s * per, (s + 1) * per)


def _check_pp(cfg: TransformerConfig, mesh: Mesh, who: str,
              model: Optional[Transformer] = None) -> int:
    """The JAX ``_check_pp``: a pp axis, and layers the stages divide;
    then the port's own: no live axis beyond pp and the data axes, and
    ``model`` holding this rank's stage."""
    if "pp" not in mesh.axis_names:
        raise ValueError(f"{who} needs a 'pp' mesh axis; got "
                         f"{mesh.axis_names}")
    S = mesh.axis_size("pp")
    if cfg.num_layers % S:
        raise ValueError(f"{cfg.num_layers} layers not divisible by {S} "
                         "pipeline stages")
    extra = [a for a in mesh.live_axes() if a not in PIPELINE_AXES]
    if extra:
        raise ValueError(f"{who} runs over pp and the data axes; a live "
                         f"{extra} axis would only repeat its work")
    if model is not None and model.layers != stage_layers(cfg, mesh):
        raise ValueError(f"{who}: the model holds blocks {model.layers}, "
                         f"stage {mesh.coord('pp')} of {S} holds "
                         f"{stage_layers(cfg, mesh)} (build_stage)")
    return S


def build_stage(cfg: TransformerConfig, mesh: Mesh, attention_fn=None,
                device=None, seed: int = 0) -> Transformer:
    """This rank's stage of ``cfg`` on ``mesh``: its blocks and the
    replicated rest, with the whole model's weights from ``seed``, on
    ``device`` (default: the card; without one it raises). The stage is
    built on the meta device and its parameters drawn one at a time
    (``sharding.materialize_shards``): the blocks it does not hold are
    drawn into a temporary and dropped, so they are never resident and
    the stage's weights are bitwise the whole model's."""
    _check_pp(cfg, mesh, "build_stage")
    dev = build_device(device, "build_stage")
    with torch.device("meta"):
        model = Transformer(cfg, attention_fn,
                            layers=stage_layers(cfg, mesh))
    return materialize_shards(
        model, torch.Generator(device=dev).manual_seed(seed))


def _pp_comm(mesh: Mesh):
    """The pp axis's communicator (a ``SelfComm`` for one stage)."""
    return mesh.comm("pp") or SelfComm()


def _data_comm(mesh: Mesh):
    """The communicator over the live data axes (None: there is none)."""
    axes = [a for a in DATA_AXES if mesh.axis_size(a) > 1]
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.comm(axes[0])
    return GroupComm(mesh.process_set(axes))


def _microbatches(n: int, num_microbatches: int) -> int:
    if n % num_microbatches:
        raise ValueError(f"batch {n} not divisible by microbatches "
                         f"{num_microbatches}")
    return n // num_microbatches


def _last(comm, t: torch.Tensor) -> torch.Tensor:
    """The last rank's ``t`` on every rank (a copy: an emulated rank
    must not share another's tensor)."""
    return comm.all_gather(t.contiguous())[-1].clone()


def _first(comm, t: torch.Tensor) -> torch.Tensor:
    return comm.all_gather(t.contiguous())[0].clone()


class _HandBack(torch.autograd.Function):
    """The last stage's outputs on every stage (the JAX masked ``psum``).
    Every stage computes the same loss on them, so each holds the same
    cotangent: the backward hands the last stage one copy, the others
    zeros."""

    @staticmethod
    def forward(ctx, y, comm):
        ctx.comm = comm
        return _last(comm, y)

    @staticmethod
    def backward(ctx, g):
        return _hand_back_cotangent(g, ctx.comm), None


def _hand_back_cotangent(g: torch.Tensor, comm) -> torch.Tensor:
    """The cotangent of the last stage's outputs on this stage: the
    stage's own copy on the last stage (one copy, not the S identical
    ones the stages hold), zeros on the others."""
    return g if comm.rank == comm.size - 1 else torch.zeros_like(g)


class _FromFirst(torch.autograd.Function):
    """The identity, whose backward gives every stage stage 0's gradient:
    only stage 0 reads the embedding."""

    @staticmethod
    def forward(ctx, h, comm):
        ctx.comm = comm
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        return _first(ctx.comm, g), None


class _GPipeRun:
    """One GPipe pass of this stage: the forward ticks, keeping each
    live tick's graph, and the backward ticks in reverse."""

    def __init__(self, stage, params, comm, num_microbatches, grad):
        self.stage, self.params, self.comm = stage, list(params), comm
        self.M, self.grad = num_microbatches, grad
        self.ticks: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def forward(self, h):
        S, s, M = self.comm.size, self.comm.rank, self.M
        mb = _microbatches(h.shape[0], M)
        self.shape = h.shape
        xs = h.reshape((M, mb) + tuple(h.shape[1:]))
        zeros = h.new_zeros(xs.shape[1:])
        recv, outs = zeros, []
        for t in range(M + S - 1):
            m, send = t - s, zeros
            if 0 <= m < M:
                u = (xs[m] if s == 0 else recv).detach()
                with torch.set_grad_enabled(self.grad):
                    y = self.stage(u.requires_grad_(self.grad))
                if self.grad:
                    self.ticks[t] = (u, y)
                if s == S - 1:
                    outs.append(y.detach())
                else:
                    send = y.detach()
            recv = self.comm.hop_forward(send)
        return torch.cat(outs) if s == S - 1 else torch.zeros_like(h)

    def backward(self, g):
        S, s, M = self.comm.size, self.comm.rank, self.M
        g_mb = g.reshape((M, -1) + tuple(g.shape[1:]))
        zeros = g.new_zeros(g_mb.shape[1:])
        g_feed = torch.zeros_like(g_mb)
        grads: List[Optional[torch.Tensor]] = [None] * len(self.params)
        recv = zeros
        for t in reversed(range(M + S - 1)):
            m, send = t - s, zeros
            if 0 <= m < M:
                u, y = self.ticks.pop(t)
                g_y = g_mb[m] if s == S - 1 else recv
                got = torch.autograd.grad(y, [u] + self.params, g_y,
                                          allow_unused=True)
                for i, gp in enumerate(got[1:]):
                    if gp is not None:
                        grads[i] = gp if grads[i] is None else grads[i] + gp
                if s == 0:
                    g_feed[m] = got[0]
                else:
                    send = got[0]
            recv = self.comm.hop_backward(send)
        return g_feed.reshape(self.shape), grads


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, h, *params):
        ctx.run = run
        return run.forward(h)

    @staticmethod
    def backward(ctx, g):
        g_h, grads = ctx.run.backward(g)
        ctx.run = None
        return (None, g_h, *grads)


def gpipe(stage: Callable[[torch.Tensor], torch.Tensor],
          params: Sequence[torch.Tensor], h: torch.Tensor, comm,
          num_microbatches: int = 2) -> torch.Tensor:
    """The GPipe schedule over ``comm`` (the pp axis's communicator).

    ``stage(u) -> y`` applies this rank's layers to one microbatch;
    ``params`` are the tensors it trains (their gradients come back
    through this call's backward); ``h`` is the full ``[B, ...]`` input,
    the same on every stage. Returns the last stage's ``[B, ...]``
    output on every stage; differentiable, the schedule replayed in
    reverse."""
    grad = torch.is_grad_enabled()
    params = [p for p in params if p.requires_grad] if grad else []
    run = _GPipeRun(stage, params, comm, num_microbatches, grad)
    y = _GPipe.apply(run, h, *params)
    return _HandBack.apply(y, comm)


def _set_attention(model: Transformer, attention_fn) -> None:
    if attention_fn is not None:
        for block in model.blocks:
            block.attn.attention_fn = attention_fn


def _block_params(model: Transformer) -> List[torch.Tensor]:
    return [p for n, p in model.named_parameters()
            if n.startswith("block_")]


def _head_params(model: Transformer) -> List[torch.Tensor]:
    head = [model.tok_emb.embedding if model.cfg.tie_embeddings
            else model.lm_head.kernel]
    return list(model.ln_final.parameters()) + head


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, T = tokens.shape
    return torch.arange(T, device=tokens.device).expand(B, T)


def pipeline_lm_apply(cfg: TransformerConfig, model: Transformer,
                      tokens: torch.Tensor, mesh: Mesh,
                      num_microbatches: int = 2,
                      attention_fn=None) -> torch.Tensor:
    """The LM forward with the blocks pipelined over pp by GPipe.

    ``model`` is this rank's stage (:func:`build_stage`); ``tokens`` its
    ``[B, T]`` rows (see the module doc); ``attention_fn``, when given,
    becomes the blocks' attention. The embedding, final norm and head
    run on every rank, outside the pipelined region. Returns the logits
    ``[B, T, V]`` on every stage; their backward fills the stage's
    ``.grad``s (the data axes' reduction is the caller's)."""
    _check_pp(cfg, mesh, "pipeline_lm_apply", model)
    _set_attention(model, attention_fn)
    comm = _pp_comm(mesh)
    B = tokens.shape[0]
    mb = _microbatches(B, num_microbatches)
    positions = _positions(tokens)
    h = _FromFirst.apply(model.embed(tokens, positions), comm)
    pos_mb = positions[:mb]
    y = gpipe(lambda u: model.run_blocks(u, pos_mb), _block_params(model),
              h, comm, num_microbatches)
    return model.head(y)


def pipeline_lm_train_step_gpipe(cfg: TransformerConfig,
                                 model: Transformer, tokens: torch.Tensor,
                                 mesh: Mesh, num_microbatches: int = 2,
                                 attention_fn=None) -> torch.Tensor:
    """A causal-LM training step's forward and backward by GPipe:
    :func:`pipeline_lm_apply`, the loss (the global batch's mean, its
    sums reduced over the data axes) and its backward. Each parameter's
    ``.grad`` is replaced by its gradient, reduced over the data axes.
    Returns the loss; the optimizer's step is the caller's."""
    data = _data_comm(mesh)
    for p in model.parameters():
        p.grad = None
    logits = pipeline_lm_apply(cfg, model, tokens, mesh, num_microbatches,
                               attention_fn)
    nll, count = causal_lm_nll(logits, tokens)
    sums = torch.stack([nll.detach(), count.to(nll.dtype)])
    if data is not None:
        sums = data.all_reduce(sums)
    n = torch.clamp(sums[1], min=1)
    (nll / n).backward()
    if data is not None:
        reduce_grads(list(model.parameters()), data)
    return sums[0] / n


def one_f_one_b(stage: Callable[[torch.Tensor], torch.Tensor],
                loss_head: Callable[[torch.Tensor, int], torch.Tensor],
                xs: torch.Tensor, comm, num_microbatches: int = 2,
                head_params: Sequence[torch.Tensor] = (),
                weight=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 1F1B train schedule over ``comm`` (the pp axis's
    communicator), on the JAX slot clock (module doc).

    ``stage(u) -> y`` applies this rank's layers to one microbatch;
    ``loss_head(y, m) -> loss`` runs the head and loss of microbatch m
    on the last stage's output and returns its un-normalized sum, whose
    backward is seeded with ``weight``. ``xs``: the ``[B, ...]`` stage-0
    input, the same on every stage. The stage's parameters' gradients
    (of the weighted sum) accumulate in their ``.grad``; the head's,
    computed on the last stage, are given to every stage. Returns
    ``(loss sum, d_xs)`` on every stage: the sum of the microbatches'
    losses and the gradient of ``xs``."""
    S, s, M = comm.size, comm.rank, num_microbatches
    mb = _microbatches(xs.shape[0], M)
    x_mb = xs.reshape((M, mb) + tuple(xs.shape[1:])).detach()
    zeros = xs.new_zeros(x_mb.shape[1:])
    ring: List[Optional[torch.Tensor]] = [None] * S
    d_xs = torch.zeros_like(x_mb)
    loss = torch.zeros((), dtype=torch.float32, device=xs.device)
    fwd_recv = bwd_recv = zeros
    for t in range(2 * (M + S - 1)):
        f, b = _slot_ops(t, s, S, M)
        y_send = du_send = zeros
        if f is not None:
            u = x_mb[f] if s == 0 else fwd_recv.detach()
            ring[f % S] = u
            if s != S - 1:  # the last stage's backward recomputes it
                with torch.no_grad():
                    y_send = stage(u)
        if b is not None:
            u = ring[b % S].detach().requires_grad_()
            ring[b % S] = None
            with torch.enable_grad():
                y = stage(u)
                if s == S - 1:
                    lb = loss_head(y, b)
                    torch.autograd.backward(lb * weight)
                    loss = loss + lb.detach().to(torch.float32)
                else:
                    torch.autograd.backward(y, bwd_recv.to(y.dtype))
            if s == 0:
                d_xs[b] = u.grad
            du_send = u.grad
        fwd_recv = comm.hop_forward(y_send)
        bwd_recv = comm.hop_backward(du_send)
    for p in head_params:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = _last(comm, g)
    return _last(comm, loss), _first(comm, d_xs).reshape(xs.shape)


def _slot_ops(t: int, s: int, S: int, M: int):
    """``(f, b)`` of slot t on stage s: the microbatch whose forward
    runs there (at ``s + 2f``) and whose backward does (at ``2S - 1 - s
    + 2b``), each None when there is none. They sit on opposite
    parities, so a slot runs one op at most."""
    tf, tb = t - s, t - (2 * S - 1 - s)
    f = tf // 2 if tf >= 0 and tf % 2 == 0 and tf // 2 < M else None
    b = tb // 2 if tb >= 0 and tb % 2 == 0 and tb // 2 < M else None
    return f, b


def _microbatch_count(tokens_mb: torch.Tensor) -> torch.Tensor:
    """A microbatch's valid targets, unclamped (the JAX ``n_raw``): a
    microbatch whose targets are all padding counts 0."""
    return (tokens_mb[:, 1:] != -1).sum()


def pipeline_lm_train_step_1f1b(cfg: TransformerConfig, model: Transformer,
                                tokens: torch.Tensor, mesh: Mesh,
                                num_microbatches: int = 2,
                                attention_fn=None) -> torch.Tensor:
    """A causal-LM training step's forward and backward by 1F1B.

    ``model`` is this rank's stage (:func:`build_stage`); ``tokens`` its
    ``[B, T]`` rows of the global batch (module doc); ``attention_fn``,
    when given, becomes the blocks' attention. The embedding runs on
    every rank, its backward driven by stage 0's ``d_xs``; the head and
    loss run on the last stage, fused into each microbatch's backward.
    The loss is the global batch's mean, ``Σ nll`` over every
    microbatch and data rank divided by the total valid count (padding
    ``-1`` excluded, a fully padded microbatch adding 0), and each
    parameter's ``.grad`` is replaced by its gradient, the same on every
    pp rank for the replicated parameters and reduced over the data
    axes. Returns the loss; the optimizer's step is the caller's."""
    _check_pp(cfg, mesh, "pipeline_lm_train_step_1f1b", model)
    _set_attention(model, attention_fn)
    comm, data = _pp_comm(mesh), _data_comm(mesh)
    M = num_microbatches
    mb = _microbatches(tokens.shape[0], M)
    for p in model.parameters():
        p.grad = None
    toks = tokens.reshape(M, mb, -1)
    count = sum(_microbatch_count(toks[m]) for m in range(M)).to(
        torch.float64)
    if data is not None:
        count = data.all_reduce(count)
    n = torch.clamp(count, min=1)
    positions = _positions(tokens)
    h = model.embed(tokens, positions)
    pos_mb = positions[:mb]

    def loss_head(y, m):
        return causal_lm_nll(model.head(y), toks[m])[0]

    loss, d_xs = one_f_one_b(
        lambda u: model.run_blocks(u, pos_mb), loss_head, h.detach(), comm,
        M, _head_params(model), (1.0 / n).to(torch.float32))
    h.backward(d_xs)
    if data is not None:
        loss = data.all_reduce(loss)
        reduce_grads(list(model.parameters()), data)
    return loss / n.to(torch.float32)
