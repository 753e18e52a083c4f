"""The data-parallel causal-LM training step.

The data-parallel subset of the JAX package's ``parallel/train.py``
``make_lm_train_step``: every rank takes its own rows of the global
batch. The step routes by the optimizer's kind, as the JAX package's
does:

* a ``FullyShardedOptimizer`` (``fsdp``): the fully-sharded step
  (:func:`_maybe_fsdp_step_fn`; HOROVOD_FSDP gates it);
* otherwise (a ``DistributedOptimizer`` or a ZeRO-1
  ``ShardedOptimizer``) the hook-driven step, whatever
  HOROVOD_OVERLAP_SCHEDULE says: its hooks already issue each bucket of
  the backward-ordered plan at the boundary where the JAX package's
  staged schedule issues it (``ops/overlap.py``).

Tensor, sequence and pipeline parallel steps are not ported yet
(ROADMAP queue A entry 11, item 14).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.basics import _require_init
from ..models.transformer import Transformer, TransformerConfig, causal_lm_nll
from ..ops.collectives import Sum, allreduce
from ..ops.fused_cross_entropy import fused_linear_cross_entropy
from ..ops.overlap import schedule_mode
from ..optim.distributed import DistributedOptimizer
from ..optim.functions import broadcast_parameters


def make_lm_train_step(cfg: TransformerConfig, optimizer, *,
                       attention_fn=None, device=None, mesh=None,
                       sequence_parallel: Optional[str] = None,
                       fused_ce: bool = False):
    """Build ``(model, step)`` for data-parallel causal-LM training.

    ``optimizer`` is either a factory of the inner torch optimizer over
    the parameters (e.g. ``functools.partial(torch.optim.AdamW, lr=1e-4,
    weight_decay=1e-4)``), which the step wraps in
    ``DistributedOptimizer`` after broadcasting rank 0's weights, or an
    optimizer of this package given no parameters
    (``ShardedOptimizer(factory)``, ``FullyShardedOptimizer(factory)``),
    which the step binds to the model. The model is built on ``device``
    (default: the device ``init()`` chose) with random weights from
    seed 0. ``step(tokens) -> loss`` runs the forward, the causal-LM
    loss, the backward and the optimizer step on this rank's ``[B, T]``
    rows of the global batch. As in the JAX package's step, the loss is
    the global batch's mean, ``Σ nll / Σ valid`` over every rank's
    targets (``ignore_index`` -1 excluded), and the gradients are its
    gradients, however unevenly the ranks' targets are padded; the step
    returns that loss. ``step.optimizer`` is the optimizer.

    ``fused_ce`` computes the LM head and the loss together with
    :func:`~horovod_tpu_torch.ops.fused_cross_entropy.fused_linear_cross_entropy`
    (vocab blocks, the logits never whole in memory) from the model's
    pre-head activations: the same two sums, ``Σ nll`` and the valid
    count, so the same denominator and backward.

    Under a ``FullyShardedOptimizer`` the returned model's parameters
    live on the meta device (the rows are in ``step.optimizer.shards``;
    ``step.state_dict()`` gathers a full copy). ``mesh`` and
    ``sequence_parallel`` raise: ROADMAP queue A entry 11 (item 14)."""
    if mesh is not None:
        raise NotImplementedError(
            "tensor-, sequence- and pipeline-parallel meshes are not "
            "ported yet (ROADMAP queue A entry 11, item 14); the port "
            "trains data-parallel and fully-sharded only")
    if sequence_parallel is not None:
        raise NotImplementedError(
            "sequence-parallel (ring/Ulysses) steps are not ported yet "
            "(ROADMAP queue A entry 11, item 14)")
    st = _require_init()
    schedule_mode(st.knobs)  # an unknown HOROVOD_OVERLAP_SCHEDULE raises
    device = st.device if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_lm_train_step: no CUDA device; pass "
                           "device='cpu' to train on the CPU")
    with torch.device(device):
        model = Transformer(cfg, attention_fn=attention_fn)
    model.init_params(torch.Generator(device=device).manual_seed(0))

    fsdp = _maybe_fsdp_step_fn(cfg, model, optimizer, fused_ce)
    if fsdp is not None:
        return model, fsdp
    broadcast_parameters(model.state_dict(), root_rank=0)
    if getattr(optimizer, "_hvd_overlap_info", None) is None:
        opt = DistributedOptimizer(optimizer(model.parameters()),
                                   named_parameters=model.named_parameters())
    else:
        opt = optimizer.bind(model.named_parameters())

    def nll_sums(tokens):
        if fused_ce:
            hidden = model(tokens, return_hidden=True)
            targets = tokens[:, 1:]
            w = (model.tok_emb.embedding.t() if cfg.tie_embeddings
                 else model.lm_head.kernel)
            return fused_linear_cross_entropy(
                hidden[:, :-1], w, targets, valid=targets != -1,
                mean=False)
        return causal_lm_nll(model(tokens), tokens)

    def step(tokens: torch.Tensor) -> torch.Tensor:
        nll, count = nll_sums(tokens)
        w, loss = _global_mean_weight(nll, count, st.size)
        (nll * w).backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss

    step.optimizer = opt
    return model, step


def _global_mean_weight(nll, count, size):
    """One denominator for every rank, before the backward: the
    reduction averages ``Σ nll_r · size / n``, which is the gradient of
    the global mean ``Σ_r Σ nll_r / n``. Returns ``(size / n, the
    global mean)``."""
    sums = allreduce(torch.stack([nll.detach().double(), count.double()]),
                     op=Sum)
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


def _params_to_meta(model) -> None:
    """Replace every parameter of ``model`` by a meta tensor of its shape
    (buffers stay): the FSDP step's rows hold the values."""
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[name] = torch.nn.Parameter(
                    torch.empty_like(p, device="meta"),
                    requires_grad=p.requires_grad)


def _maybe_fsdp_step_fn(cfg, model, optimizer, fused_ce):
    """The fully-sharded step when ``optimizer`` is a
    ``FullyShardedOptimizer``, else None (every other optimizer takes
    its path bit for bit whatever HOROVOD_FSDP says). Every rank draws
    the same seed-0 weights, keeps its rows of each bucket
    (``optimizer.bind``) and frees the rest: the model's parameters move
    to the meta device, and the step gathers them bucket by bucket
    (``ops/overlap.fsdp_staged_value_and_grad``, with the FSDP knobs'
    prefetch, regather and offload). There is no fallback: the
    optimizer's step consumes staged shards only."""
    from ..ops import overlap as overlap_mod
    from ..optim import fsdp as fsdp_mod

    info = getattr(optimizer, "_hvd_overlap_info", None)
    if info is None or info.get("kind") != "fsdp":
        return None
    st = _require_init()
    if not st.knobs.fsdp:
        raise ValueError(
            "HOROVOD_FSDP=0 but the optimizer is a "
            "FullyShardedOptimizer — its update consumes staged shards "
            "and cannot ride the monolithic paths; turn the knob on or "
            "use ShardedOptimizer/DistributedOptimizer")
    opt = optimizer.bind(model.named_parameters())
    _params_to_meta(model)
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
