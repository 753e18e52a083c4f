"""The fully-sharded (FSDP) staged step, and the modes of the
backward-interleaved collective schedule (HOROVOD_OVERLAP_SCHEDULE).

The port of the JAX package's ``ops/overlap.py``. The JAX package traces
the backward as a chain of per-segment ``jax.vjp``s and pins each fusion
bucket's collective into it with optimization barriers. PyTorch runs
eagerly, so the segments are real: the forward is cut into stages
(embed, each block, head + loss, :func:`transformer_lm_stages`), a
stage's backward is that stage run on a detached carry that requires
grad, and ``torch.autograd.grad`` of its output gives the stage's
parameter gradients and the next cotangent (the carry's gradient).

The replicated optimizers need no staged path: the
``DistributedOptimizer``'s and ZeRO-1's post-accumulate-grad hooks
already issue each bucket of their backward-ordered plan at the
boundary ``fusion.bucket_issue_schedule`` names, and NCCL runs it on a
stream of its own. With the knob on, ``make_lm_train_step`` keeps that
step; ``double`` is ``stage`` there, since the hook-driven step
consumes every bucket after the backward. This module parses the
knob's modes for parity with the JAX package.

The FSDP runners (:func:`fsdp_staged_value_and_grad`) gather each
bucket of parameter rows ``prefetch`` stages ahead of its first forward
use (``fusion.bucket_prefetch_schedule``), run the stage through
``torch.func.functional_call`` on views into the gathered buffer (the
module's own parameters stay on the meta device) and drop the buffer
after its last forward use. By default (HOROVOD_FSDP_REGATHER) the
forward keeps only the stage-boundary carries, and the backward gathers
each bucket again at ``fusion.bucket_regather_schedule``'s boundary and
recomputes its stage with grad; the last stage runs once, at backward
step 0, so its output is the loss. HOROVOD_FSDP_OFFLOAD parks the
carries in pinned host memory, each fetched back one backward stage
ahead. Gradients leave through the same pack -> B6 -> reduce-scatter
chain in every mode, each bucket issued at the boundary
``fusion.bucket_issue_schedule`` names, so every mode is bitwise the
gathered reference (``optim.fsdp.fsdp_value_and_grad(mode="upfront")``).
On a CUDA device the gathers and reduce-scatters run on a side stream
ordered by events, and the compute stream waits only where it reads a
result (:class:`SideStream`); on the CPU they run in order.

The exchanges are pluggable (:class:`WorldExchange` over
``torch.distributed``; :class:`EmulatedWorld` for a world of several
ranks composed in one process, as ``chip_smoke.py`` runs one on a single
card). Each step's figures are left on the returned ``vag``
(``issue_log``, ``gather_log``, ``param_bytes``, ``gather_bytes``,
``regather_bytes``, ``offload_bytes``, ``peak_param_bytes``,
``pinned_frac``) and, with metrics on, recorded as the JAX package's
runners record them (:func:`_record_staged_step`,
:func:`_record_fsdp_step`): direct calls, where the JAX package's
compiled step needs an ``io_callback``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from .fusion import (bucket_issue_schedule, bucket_prefetch_schedule,
                     bucket_regather_schedule, pack_buckets_by_plan)

_MODES = ("off", "stage", "double")


def normalize_mode(value) -> str:
    """Map knob spellings onto ``off`` (default), ``stage`` and
    ``double``; 0/1/on/off aliases are accepted."""
    v = str(value or "off").strip().lower()
    if v in ("", "0", "false", "no", "off", "none"):
        return "off"
    if v in ("1", "true", "yes", "on", "stage"):
        return "stage"
    if v in ("2", "double", "double-buffer", "double_buffer"):
        return "double"
    raise ValueError(
        f"unknown overlap schedule {value!r} — expected one of "
        f"{_MODES} (HOROVOD_OVERLAP_SCHEDULE)")


def _knobs():
    from ..core.knobs import Knobs
    from ..core.state import global_state

    st = global_state()
    return st.knobs if st.initialized else Knobs.from_env()


def schedule_mode(knobs=None) -> str:
    """The process-wide schedule mode, from the knobs."""
    knobs = _knobs() if knobs is None else knobs
    return normalize_mode(getattr(knobs, "overlap_schedule", "off"))


class Stage(NamedTuple):
    """One forward segment: ``fwd(sub, carry) -> carry``, where ``sub``
    maps the names of this stage's parameters (every parameter under one
    of its top-level ``keys``) to tensors. The first stage closes over
    the batch (its carry is a dummy scalar); the last returns the scalar
    loss."""

    name: str
    keys: tuple
    fwd: Callable


class StagedShards:
    """Averaged gradient shards (one ``(k_i,)`` per bucket, already
    reduce-scattered) for ``FullyShardedOptimizer.step``;
    ``new_residuals`` the int8 wire's updated rank-private residual rows
    (None on other wires)."""

    __slots__ = ("shards", "new_residuals")

    def __init__(self, shards, new_residuals=None):
        self.shards = list(shards)
        self.new_residuals = (None if new_residuals is None
                              else list(new_residuals))


# ---------------------------------------------------------------------------
# reducer introspection
# ---------------------------------------------------------------------------

def _reducer_info(opt) -> dict:
    """The reduction recipe an optimizer of this package carries in
    ``_hvd_overlap_info`` (kind, wire, error feedback, ...)."""
    info = getattr(opt, "_hvd_overlap_info", None)
    if info is None:
        raise ValueError(
            "the staged FSDP step needs a FullyShardedOptimizer of this "
            "package; got an optimizer without overlap metadata")
    return dict(info)


# ---------------------------------------------------------------------------
# stage decompositions
# ---------------------------------------------------------------------------

class _Attend(torch.nn.Module):
    """The tied LM head, ``Embed.attend``, as a module's forward, so that
    ``functional_call`` can run it on a table it is given."""

    def __init__(self, emb):
        super().__init__()
        self.emb = emb

    def forward(self, x):
        return self.emb.attend(x)


def _relative(sub: Dict[str, torch.Tensor], key: str):
    """``sub``'s entries under ``key``, named relative to it."""
    cut = len(key) + 1
    return {name[cut:]: t for name, t in sub.items()
            if name.startswith(key + ".")}


def transformer_lm_stages(model, tokens, loss_fn=None, positions=None,
                          mask=None, fused_loss_fn=None) -> List[Stage]:
    """Cut a ``models.transformer.Transformer`` forward + loss into
    backward segments: embed -> block_0 .. block_N -> head (+ loss). Each
    stage runs the model's own submodules through
    ``torch.func.functional_call`` on the tensors it is given, with the
    arguments the model's ``forward`` passes them, so the stages composed
    are op for op the monolithic forward (the bitwise schedule on/off
    tests rest on it).

    ``loss_fn(logits) -> scalar`` closes over the targets; with
    ``fused_loss_fn(hidden, weight) -> scalar`` instead, the head hands
    the final norm's output and the LM head's ``[hidden, vocab]`` weight
    to it (the fused cross-entropy)."""
    from torch.func import functional_call

    if (loss_fn is None) == (fused_loss_fn is None):
        raise ValueError("pass exactly one of loss_fn and fused_loss_fn")
    cfg = model.cfg
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)
    rope = ((model.rope_cos, model.rope_sin) if cfg.position == "rope"
            else None)

    def embed_fwd(sub, carry):
        x = functional_call(model.tok_emb, _relative(sub, "tok_emb"),
                            (tokens,), tie_weights=False)
        if cfg.position == "learned":
            x = x + sub["pos_emb"][positions].to(cfg.dtype)
        return x

    embed_keys = ("tok_emb",) + (
        ("pos_emb",) if cfg.position == "learned" else ())
    stages = [Stage("embed", embed_keys, embed_fwd)]

    for i, block in enumerate(model.blocks):
        key = f"block_{i}"

        def blk_fwd(sub, carry, _block=block, _key=key, _i=i):
            params = _relative(sub, _key)
            if cfg.remat and torch.is_grad_enabled():
                names = list(params)

                def run(x, *ts):
                    return functional_call(
                        _block, dict(zip(names, ts)),
                        (x, positions, mask, None, _i, rope),
                        tie_weights=False)

                return torch.utils.checkpoint.checkpoint(
                    run, carry, *params.values(), use_reentrant=False)
            return functional_call(_block, params,
                                   (carry, positions, mask),
                                   {"layer": _i, "rope": rope},
                                   tie_weights=False)

        stages.append(Stage(key, (key,), blk_fwd))

    attend = _Attend(model.tok_emb) if cfg.tie_embeddings else None

    def head_fwd(sub, carry):
        x = functional_call(model.ln_final, _relative(sub, "ln_final"),
                            (carry,), tie_weights=False)
        if fused_loss_fn is not None:
            w = (sub["tok_emb.embedding"].t() if cfg.tie_embeddings
                 else sub["lm_head.kernel"])
            return fused_loss_fn(x, w)
        if cfg.tie_embeddings:
            logits = functional_call(
                attend, {"emb.embedding": sub["tok_emb.embedding"]}, (x,),
                tie_weights=False)
        else:
            logits = functional_call(model.lm_head,
                                     _relative(sub, "lm_head"), (x,),
                                     tie_weights=False)
        return loss_fn(logits)

    head_keys = ("ln_final",) + (
        ("tok_emb",) if cfg.tie_embeddings else ("lm_head",))
    stages.append(Stage("head", head_keys, head_fwd))
    return stages


def stack_stages(input_fn: Callable, layers: Sequence, head_fn: Callable,
                 head_keys: tuple = ()) -> List[Stage]:
    """Stages of a plain layer stack: ``input_fn() -> carry`` closes over
    the batch; ``layers`` is a sequence of ``(key, fwd)`` with
    ``fwd(layer_params, carry) -> carry`` given the parameter named
    ``key``, or the parameters under it (named relative to it);
    ``head_fn(sub, carry) -> scalar loss`` is given the parameters under
    ``head_keys``."""
    stages = [Stage("input", (), lambda sub, c: input_fn())]
    for key, fwd in layers:
        stages.append(Stage(
            key, (key,),
            lambda sub, c, _f=fwd, _k=key: _f(
                sub[_k] if _k in sub else _relative(sub, _k), c)))
    stages.append(Stage("head", tuple(head_keys), head_fn))
    return stages


# ---------------------------------------------------------------------------
# bookkeeping shared by the runners
# ---------------------------------------------------------------------------

def _top_key(name: str) -> str:
    return name.split(".", 1)[0]


def _leaf_index_maps(names: Sequence[str], stages: Sequence[Stage]):
    """``(name -> leaf index, the stages contributing to each leaf, the
    leaves of each stage)``. A leaf that several stages read (a tied
    embedding) takes a gradient contribution from each and is ready only
    after its last."""
    name_to_idx = {n: i for i, n in enumerate(names)}
    by_key: Dict[str, list] = {}
    for i, n in enumerate(names):
        by_key.setdefault(_top_key(n), []).append(i)
    leaf_stages: List[list] = [[] for _ in names]
    stage_leaves = []
    for si, st in enumerate(stages):
        idx = sorted(i for k in set(st.keys) for i in by_key.get(k, ()))
        for i in idx:
            leaf_stages[i].append(si)
        stage_leaves.append(idx)
    missing = sorted(set(by_key) - {k for st in stages for k in st.keys})
    if missing:
        raise ValueError(
            f"stage decomposition covers no gradients for top-level "
            f"param keys {missing} — the staged backward would drop "
            f"them; add them to a stage or turn the overlap schedule "
            f"off for this model")
    return name_to_idx, leaf_stages, stage_leaves


def _stage_cost_bytes(shapes, dtypes, stage_leaves) -> List[int]:
    """Bytes of the parameters each stage differentiates: the proxy for
    its backward's cost behind ``pinned_frac``."""
    sizes = [_numel(s) * _itemsize(d) for s, d in zip(shapes, dtypes)]
    return [sum(sizes[i] for i in idx) for idx in stage_leaves]


def _numel(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _pinned_frac(costs, backward_stage_order, first_issue_step) -> float:
    """The share of backward cost the schedule places after the first
    issued collective (what the JAX package gauges as
    hvd_overlap_window_frac)."""
    total = float(sum(costs)) or 1.0
    if first_issue_step is None:
        return 0.0
    return sum(costs[si] for step_i, si in enumerate(backward_stage_order)
               if step_i > first_issue_step) / total


def _pack_bucket(leaf_grads, bplan) -> torch.Tensor:
    bucket, = pack_buckets_by_plan(leaf_grads, [bplan])
    return bucket


class _Pending:
    """An issued exchange: ``finish()`` gives its result; ``event`` (CUDA)
    is recorded on the side stream once the result is written."""

    __slots__ = ("finish", "event")

    def __init__(self, finish, event):
        self.finish, self.event = finish, event


class SideStream:
    """Where a staged step's exchanges run. On a CUDA device: a side
    stream that waits for the compute stream's work so far, enqueues the
    exchange and its finish (NCCL's wait orders the side stream, not the
    host) and records an event, on which the compute stream waits only
    where it consumes the result; elsewhere nothing (gloo's wait blocks
    the host when the result is consumed). ``kind`` (``"gather"`` or
    ``"scatter"``) and ``bucket`` name what :meth:`consume` reads."""

    def __init__(self, device):
        device = torch.device(device)
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def issue(self, start: Callable) -> _Pending:
        """Run ``start()``, which enqueues an exchange and returns its
        ``finish``."""
        if self.stream is None:
            return _Pending(start(), None)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            out = start()()
            event = torch.cuda.Event()
            event.record(self.stream)
        return _Pending(lambda: out, event)

    def consume(self, pending: _Pending, kind: str, bucket: int):
        """The exchange's result, the compute stream ordered after it."""
        out = pending.finish()
        if pending.event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(pending.event)
            for t in _tensors(out):
                t.record_stream(compute)
        return out

    def release(self, leaf_grads, bplan) -> None:
        """Drop the runner's references to a bucket's leaf gradients once
        its pack is enqueued on the side stream (which then owns their
        memory until it has read them)."""
        for (i, _, _, _) in bplan:
            if self.stream is not None:
                leaf_grads[i].record_stream(self.stream)
            leaf_grads[i] = None

    def empty(self, n: int, dtype) -> torch.Tensor:
        """A gather's output, allocated on the compute stream before the
        gather is issued."""
        return torch.empty(n, dtype=dtype, device=self.device)


def _tensors(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


class WorldExchange:
    """The exchanges of a staged FSDP step over the ``torch.distributed``
    world of ``n`` ranks: a reduce-scatter is
    ``zero._start_scatter_bucket`` (on the optimizer's wire, with its
    error-feedback residual) and a gather the tiled all-gather. Each
    returns ``finish()``."""

    def __init__(self, n: int):
        self.n = int(n)

    def scatter(self, b: int, rows: torch.Tensor, wire, residual=None):
        from ..optim import zero

        return zero._start_scatter_bucket(rows, self.n, wire, residual)

    def gather(self, b: int, shard: torch.Tensor, out: torch.Tensor):
        from .collectives import _all_gather_single

        work = _all_gather_single(out, shard.contiguous(), async_op=True)

        def finish():
            work.wait()
            return out

        return finish


class EmulatedWorld:
    """A world of ``n`` ranks composed in one process (as on one card):
    each rank's runner gets ``rank(r)`` as its exchange. A gather is the
    concatenation of every rank's current shard of the bucket
    (``shards[r][b]``, set by the caller before the step); a
    reduce-scatter records this rank's rows and returns placeholders
    that :meth:`resolve`, called once every rank has run its backward,
    fills with the stage functions of the real exchange in rank order
    (``zero.emulated_scatter_buckets`` on ``wire``, with the
    residuals)."""

    def __init__(self, n: int, wire=None):
        self.n = int(n)
        self.wire = wire
        self.shards: List[List[torch.Tensor]] = [[] for _ in range(n)]
        self._pending: Dict[int, dict] = {}

    def rank(self, r: int) -> "_EmulatedRank":
        return _EmulatedRank(self, r)

    def resolve(self) -> None:
        """Run the recorded exchanges and fill every rank's placeholders
        (on the current stream)."""
        from ..optim import zero

        for b, got in sorted(self._pending.items()):
            if sorted(got) != list(range(self.n)):
                raise RuntimeError(f"the reduce-scatter of bucket {b} was "
                                   f"issued by ranks {sorted(got)} of "
                                   f"{self.n}")
            ins = [got[r][0] for r in range(self.n)]
            res = [got[r][2] for r in range(self.n)]
            if res[0] is None:
                outs = zero.emulated_scatter_buckets(ins, self.n, self.wire)
                new_res = [None] * self.n
            else:
                outs, new_res = zero.emulated_scatter_buckets(
                    ins, self.n, self.wire, residuals=res)
            for r in range(self.n):
                got[r][1].copy_(outs[r])
                if new_res[r] is not None:
                    got[r][3].copy_(new_res[r])
        self._pending.clear()


class _EmulatedRank:
    """Rank ``r``'s exchanges in an :class:`EmulatedWorld`."""

    def __init__(self, world: EmulatedWorld, r: int):
        self.world, self.r, self.n = world, r, world.n

    def scatter(self, b: int, rows: torch.Tensor, wire, residual=None):
        k = rows.shape[1]
        out = torch.empty(k, dtype=rows.dtype, device=rows.device)
        new_res = None if residual is None else torch.empty_like(residual)
        self.world._pending.setdefault(b, {})[self.r] = (rows, out,
                                                         residual, new_res)
        if residual is None:
            return lambda: out
        return lambda: (out, new_res)

    def gather(self, b: int, shard: torch.Tensor, out: torch.Tensor):
        torch.cat([self.world.shards[r][b] for r in range(self.n)],
                  out=out)
        return lambda: out


# ---------------------------------------------------------------------------
# the FSDP (fully-sharded parameter) staged value-and-grad
# ---------------------------------------------------------------------------

def _stage_backward(out, c_in, sub, ct, name_to_idx, leaf_grads):
    """One segment's backward: the gradients of ``out`` (seeded with
    ``ct``) with respect to the stage's parameters, added into
    ``leaf_grads``, and the carry's gradient (the next cotangent, None
    for the first stage)."""
    names = [n for n, t in sub.items() if t.requires_grad]
    inputs = [sub[n] for n in names]
    if c_in.requires_grad:
        inputs.append(c_in)
    grads = torch.autograd.grad(out, inputs, grad_outputs=ct,
                                allow_unused=True)
    for n, g in zip(names, grads):
        if g is None:
            continue
        i = name_to_idx[n]
        leaf_grads[i] = g if leaf_grads[i] is None else leaf_grads[i] + g
    return grads[-1] if c_in.requires_grad else None


def _fill_missing(leaf_grads, bplan, dtype, device) -> None:
    """A leaf of the bucket that no stage gave a gradient reduces as
    zeros (as the hook-driven optimizers do)."""
    for (i, _, _, shape) in bplan:
        if leaf_grads[i] is None:
            leaf_grads[i] = torch.zeros(shape, dtype=dtype, device=device)


def fsdp_staged_value_and_grad(stages_fn: Callable, opt, layout=None,
                               prefetch=None, regather=None, offload=None):
    """Build ``vag(shards, *batch, opt_state=None, exchange=None,
    side=None) -> (loss, StagedShards)`` over this rank's parameter rows
    (``shards``: one ``(k_i,)`` tensor per bucket of ``layout``, as
    ``FullyShardedOptimizer.shards`` holds them).

    Each bucket's rows are all-gathered ``prefetch`` stages (default the
    HOROVOD_FSDP_PREFETCH knob) ahead of the first forward stage that
    reads them and dropped after the last; the stages run on views into
    the gathered buffers. ``regather`` (default HOROVOD_FSDP_REGATHER,
    on) keeps only the stage-boundary carries from the forward and
    gathers each bucket again in the backward (see the module
    docstring); ``offload`` (default HOROVOD_FSDP_OFFLOAD, regather mode
    only) parks the carries in pinned host memory. The gradients go
    through the pack (B6), the reduce-scatter on ``opt``'s wire (with the
    rank-private residual under int8 error feedback: pass ``opt_state=
    opt.opt_state``) at their availability boundaries.

    ``opt`` must be a FullyShardedOptimizer; its ``step(staged)``
    consumes the result."""
    info = _reducer_info(opt)
    if info["kind"] != "fsdp":
        raise ValueError(
            "fsdp_staged_value_and_grad needs a FullyShardedOptimizer "
            "(ShardedOptimizer(params_sharded=True)); got kind "
            f"{info['kind']!r}")
    if layout is None:
        raise ValueError(
            "fsdp_staged_value_and_grad requires the FsdpLayout the "
            "parameter rows were sharded with (optim.fsdp.fsdp_layout)")

    def vag(shards, *batch, opt_state=None, exchange=None, side=None):
        stages = stages_fn(*batch)
        knobs = _knobs()
        re = knobs.fsdp_regather if regather is None else regather
        run = _FsdpRun(vag, stages, layout, shards, info, opt_state,
                       knobs.fsdp_prefetch if prefetch is None else prefetch,
                       exchange, side)
        if re:
            off = knobs.fsdp_offload if offload is None else offload
            return run.regather(bool(off), float(knobs.fsdp_offload_duty))
        return run.saved()

    return vag


def _offload_stage_set(n_stages: int, duty: float):
    """The stages whose entering carry is parked on the host: not stage
    0 (its carry is the dummy seed) nor the last (the first backward
    segment consumes it at once); of the rest the earliest first (they
    wait longest for the backward), up to ``duty`` of them."""
    import math

    eligible = list(range(1, n_stages - 1))
    if not eligible or duty <= 0.0:
        return set()
    k = int(math.ceil(min(duty, 1.0) * len(eligible)))
    return set(eligible[:k])


class _Parking:
    """Stage-boundary carries parked in host memory (pinned, copied on
    the side stream, under HOROVOD_FSDP_OFFLOAD). On the CPU a park is a
    copy into another tensor."""

    def __init__(self, side: SideStream):
        self.side = side

    def park(self, t: torch.Tensor):
        stream = self.side.stream
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        if stream is None:
            host.copy_(t)
            return host, t.device
        stream.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(stream):
            host.copy_(t, non_blocking=True)
        t.record_stream(stream)
        return host, t.device

    def fetch(self, parked):
        """Start the copy back to the device; :meth:`wait` for it."""
        host, device = parked
        stream = self.side.stream
        if stream is None:
            return host.clone(), None
        with torch.cuda.stream(stream):
            dev = torch.empty(host.shape, dtype=host.dtype, device=device)
            dev.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return dev, event

    @staticmethod
    def wait(fetched) -> torch.Tensor:
        dev, event = fetched
        if event is not None:
            compute = torch.cuda.current_stream(dev.device)
            compute.wait_event(event)
            dev.record_stream(compute)
        return dev


@functools.lru_cache(maxsize=8)
def _fsdp_bookkeeping(layout, keys: tuple):
    """What an FSDP step derives from the layout and the stages' keys
    alone (the same every step): the leaf maps, each leaf's place in its
    bucket, the forward need and backward issue schedules, each gathered
    bucket's bytes."""
    stages = [Stage(str(si), k, None) for si, k in enumerate(keys)]
    name_to_idx, leaf_stages, stage_leaves = _leaf_index_maps(layout.names,
                                                              stages)
    plans = list(layout.plans)
    leaf_loc = {}
    for bi, bp in enumerate(plans):
        for (i, off, sz, shp) in bp:
            leaf_loc[i] = (bi, off, sz, shp)
    S = len(keys)
    need = bucket_prefetch_schedule(plans, [min(s) for s in leaf_stages], S)
    schedule = bucket_issue_schedule(plans, leaf_stages,
                                     list(reversed(range(S))))
    bkt_bytes = [layout.world * k * _itemsize(d)
                 for k, d in zip(layout.ks, layout.dtypes)]
    return (name_to_idx, leaf_stages, stage_leaves, leaf_loc, need,
            schedule, bkt_bytes)


class _FsdpRun:
    """One FSDP step's state: the gathered buffers and their liveness,
    the pending exchanges, the figures left on ``vag``."""

    def __init__(self, vag, stages, layout, shards, info, opt_state,
                 prefetch, exchange, side):
        from ..core.basics import _require_init
        from ..optim import fsdp as fsdp_mod

        self.vag, self.stages, self.layout = vag, list(stages), layout
        self.shards = list(shards)
        if exchange is None:
            exchange = WorldExchange(_require_init().size)
        n = exchange.n
        if n != layout.world:
            raise ValueError(
                f"parameter rows were sharded for world {layout.world} "
                f"but the live group size is {n} — reshard with "
                "fsdp.reshard_rows before re-entering the train loop")
        if len(self.shards) != len(layout.plans) or any(
                tuple(s.shape) != (k,)
                for s, k in zip(self.shards, layout.ks)):
            raise ValueError(
                "the parameter shards do not match the layout's buckets "
                f"({len(layout.plans)} of widths {list(layout.ks)})")
        self.exchange, self.n = exchange, n
        self.device = self.shards[0].device
        self.side = SideStream(self.device) if side is None else side
        self.wire = info.get("wire")
        self.ef = bool(info.get("error_feedback"))
        self.depth = max(int(prefetch), 0)
        self.res_mats = None
        if self.ef:
            if opt_state is None:
                raise ValueError(
                    "this FullyShardedOptimizer carries error-feedback "
                    "state; pass opt_state= to the staged value_and_grad "
                    "so the residual rides the staged quantized "
                    "reduce-scatters")
            self.res_mats = fsdp_mod._residual_mats(opt_state, layout,
                                                    self.wire.block)
            if self.res_mats is None:
                raise ValueError(
                    "opt_state carries no FsdpEFState residual but the "
                    "optimizer was built on the int8 error-feedback wire")
        self.S = len(self.stages)
        self.plans = list(layout.plans)
        (self.name_to_idx, self.leaf_stages, self.stage_leaves,
         self.leaf_loc, self.need, self.schedule, self.bkt_bytes) = \
            _fsdp_bookkeeping(layout, tuple(st.keys for st in self.stages))
        self.gathered: Dict[int, Any] = {}
        self.live = self.peak = 0
        self.gather_log: List[tuple] = []
        self.leaf_grads: List[Optional[torch.Tensor]] = \
            [None] * layout.nleaves
        self.issued: List[Any] = [None] * len(self.plans)
        self.issue_log: List[tuple] = []
        self.backward_stage_order = list(reversed(range(self.S)))

    # -- gathers ----------------------------------------------------------

    def gather(self, bi: int, phase: str, at: int) -> bool:
        """Issue bucket ``bi``'s all-gather unless it is held; returns
        whether it was issued."""
        if bi in self.gathered:
            return False
        shard = self.shards[bi]
        out = self.side.empty(self.n * shard.numel(), shard.dtype)
        self.gathered[bi] = self.side.issue(
            lambda: self.exchange.gather(bi, shard, out))
        self.gather_log.append((phase, at, bi))
        self.live += self.bkt_bytes[bi]
        self.peak = max(self.peak, self.live)
        return True

    def drop(self, bi: int) -> None:
        got = self.gathered.pop(bi)
        if isinstance(got, _Pending):  # never read: order its reuse
            self.side.consume(got, "gather", bi)
        self.live -= self.bkt_bytes[bi]

    def full(self, bi: int) -> torch.Tensor:
        got = self.gathered[bi]
        if isinstance(got, _Pending):
            got = self.side.consume(got, "gather", bi)[:self.layout.lens[bi]]
            self.gathered[bi] = got
        return got

    def sub_for(self, si: int, grad: bool) -> Dict[str, torch.Tensor]:
        """Stage ``si``'s parameters as views into the gathered buffers
        (autograd leaves when ``grad``)."""
        sub = {}
        for i in self.stage_leaves[si]:
            name = self.layout.names[i]
            bi, off, sz, shp = self.leaf_loc[i]
            v = self.full(bi)[off:off + sz].view(shp)
            sub[name] = v.detach().requires_grad_() if grad else v
        return sub

    def prefetch(self, need, at: int, phase: str) -> int:
        """Gather the buckets ``need[at]`` and, ``depth`` ahead, those of
        the next boundaries; returns the bytes issued ahead."""
        for bi in need[at]:
            self.gather(bi, phase, at)
        ahead = 0
        for d in range(1, self.depth + 1):
            if at + d >= self.S:
                break
            for bi in need[at + d]:
                if self.gather(bi, phase, at):
                    ahead += self.bkt_bytes[bi]
        return ahead

    # -- the reduce-scatter chain ---------------------------------------

    def backward_stage(self, step_i, out, c_in, sub, ct):
        from .ring_pack import maybe_pack_rows

        ct_next = _stage_backward(out, c_in, sub, ct, self.name_to_idx,
                                  self.leaf_grads)
        for bi in self.schedule[step_i]:
            _fill_missing(self.leaf_grads, self.plans[bi],
                          self.layout.dtypes[bi], self.device)
            res = None if self.res_mats is None else self.res_mats[bi]

            def go(_bi=bi, _res=res):
                bucket = _pack_bucket(self.leaf_grads, self.plans[_bi])
                rows = maybe_pack_rows(bucket, self.n)
                return self.exchange.scatter(_bi, rows, self.wire, _res)

            self.issued[bi] = self.side.issue(go)
            self.side.release(self.leaf_grads, self.plans[bi])
            self.issue_log.append((step_i, bi))
        return ct_next

    def result(self, loss, regather_bytes=0, offload_bytes=0):
        missing = [bi for bi, r in enumerate(self.issued) if r is None]
        if missing:
            raise AssertionError(
                f"buckets {missing} never became available — stage "
                f"decomposition does not cover their leaves")
        reduced = [None] * len(self.plans)
        new_res = [None] * len(self.plans) if self.ef else None
        for _, bi in self.issue_log:
            got = self.side.consume(self.issued[bi], "scatter", bi)
            if self.ef:
                reduced[bi], res = got
                new_res[bi] = res.reshape(1, -1)
            else:
                reduced[bi] = got
        for shard, k in zip(reduced, self.layout.ks):
            if tuple(shard.shape) != (k,):
                raise AssertionError((tuple(shard.shape), k))
        layout, v = self.layout, self.vag
        first = self.issue_log[0][0] if self.issue_log else None
        v.issue_log = list(self.issue_log)
        v.gather_log = list(self.gather_log)
        v.param_bytes = layout.shard_bytes
        v.gather_bytes = sum(self.bkt_bytes)
        v.regather_bytes = regather_bytes
        v.offload_bytes = offload_bytes
        v.peak_param_bytes = layout.shard_bytes + self.peak
        v.pinned_frac = _pinned_frac(
            _stage_cost_bytes(layout.shapes, layout.leaf_dtypes(),
                              self.stage_leaves),
            self.backward_stage_order, first)
        _record_staged_step(
            [(int(L), _itemsize(d), d.is_floating_point)
             for L, d in zip(layout.lens, layout.dtypes)],
            self.wire, v.pinned_frac)
        _record_fsdp_step(v.param_bytes, v.gather_bytes, regather_bytes,
                          offload_bytes)
        return loss.detach(), StagedShards(reduced, new_residuals=new_res)

    # -- saved-gather mode (HOROVOD_FSDP_REGATHER=0) ----------------------

    def saved(self):
        last_use = [max(max(self.leaf_stages[i]) for (i, _, _, _) in bp)
                    for bp in self.plans]
        carry = torch.zeros((), dtype=torch.float32, device=self.device)
        saved = []
        for s, st in enumerate(self.stages):
            self.prefetch(self.need, s, "fwd")
            sub = self.sub_for(s, grad=True)
            c_in = carry.detach().requires_grad_(s > 0)
            carry = st.fwd(sub, c_in)
            saved.append((carry, c_in, sub))
            for bi in [b for b in list(self.gathered) if last_use[b] == s]:
                self.drop(bi)
        loss = carry
        _require_scalar(loss)
        ct = torch.ones((), dtype=loss.dtype, device=self.device)
        for step_i, si in enumerate(self.backward_stage_order):
            out, c_in, sub = saved[si]
            saved[si] = None
            ct = self.backward_stage(step_i, out, c_in, sub, ct)
        return self.result(loss)

    # -- regather mode (the default) -------------------------------------

    def regather(self, offload: bool, duty: float):
        S = self.S
        # the forward drops a bucket after the last primal stage (<= S-2)
        # that reads it (None: only the last stage does); the backward
        # after the first forward stage that reads it
        fwd_last = []
        for bp in self.plans:
            uses = [s for (i, _, _, _) in bp for s in self.leaf_stages[i]
                    if s < S - 1]
            fwd_last.append(max(uses) if uses else None)
        first_use = [min(min(self.leaf_stages[i]) for (i, _, _, _) in bp)
                     for bp in self.plans]
        offload_set = _offload_stage_set(S, duty) if offload else set()
        parking = _Parking(self.side)
        offload_bytes = 0

        # forward: stages 0..S-2 without grad; only the carries survive
        carries: List[Any] = [None] * S
        carry = torch.zeros((), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            for s in range(S - 1):
                self.prefetch(self.need, s, "fwd")
                if s in offload_set:
                    carries[s] = parking.park(carry)
                    offload_bytes += carry.numel() * carry.element_size()
                else:
                    carries[s] = carry
                carry = self.stages[s].fwd(self.sub_for(s, grad=False),
                                           carry)
                for bi in [b for b in list(self.gathered)
                           if fwd_last[b] == s]:
                    self.drop(bi)
        carries[S - 1] = carry
        del carry

        # backward: gather again at the first backward use, recompute the
        # stage with grad (the last stage runs here once: its output is
        # the loss), reduce-scatter as in the saved mode
        regather_need = bucket_regather_schedule(
            self.plans, [max(s) for s in self.leaf_stages], S)
        regather_bytes = 0
        loss = ct = None
        fetched: Dict[int, Any] = {}
        for step_i, si in enumerate(self.backward_stage_order):
            for bi in regather_need[step_i]:
                if self.gather(bi, "bwd", step_i) and (
                        step_i or fwd_last[bi] is not None):
                    regather_bytes += self.bkt_bytes[bi]
            regather_bytes += self.prefetch(regather_need, step_i, "bwd") \
                if self.depth else 0
            if si in fetched:
                carry_in = parking.wait(fetched.pop(si))
            elif si in offload_set:
                carry_in = parking.wait(parking.fetch(carries[si]))
            else:
                carry_in = carries[si]
            carries[si] = None
            # the next segment's carry comes back while this one computes
            if step_i + 1 < S:
                nxt = self.backward_stage_order[step_i + 1]
                if nxt in offload_set:
                    fetched[nxt] = parking.fetch(carries[nxt])
            sub = self.sub_for(si, grad=True)
            c_in = carry_in.detach().requires_grad_(si > 0)
            del carry_in
            out = self.stages[si].fwd(sub, c_in)
            if step_i == 0:
                loss = out
                _require_scalar(loss)
                ct = torch.ones((), dtype=loss.dtype, device=self.device)
            ct = self.backward_stage(step_i, out, c_in, sub, ct)
            del out, sub, c_in
            for bi in [b for b in list(self.gathered)
                       if first_use[b] == si]:
                self.drop(bi)
        return self.result(loss, regather_bytes, offload_bytes)


def _record_fsdp_step(param_bytes: int, gather_bytes: int,
                      regather_bytes: int = 0, offload_bytes: int = 0):
    """A step's FSDP figures into the metrics: a rank's resident
    parameter bytes, the bytes its forward gathers materialized, the
    backward's re-gathers and the carries parked on the host
    (``hvd_hbm_param_bytes``, ``hvd_fsdp_*_bytes_total`` and the step
    record's ``fsdp``)."""
    from ..utils import metrics as _metrics

    if not _metrics.enabled():
        return
    _metrics.record_fsdp_step(int(param_bytes), int(gather_bytes),
                              int(regather_bytes), int(offload_bytes))


def _record_staged_step(bucket_meta, wire, pinned_frac):
    """A staged step's reduction into the autotuner's parameter manager
    (its bucket bytes, once a step) and the metrics, as the monolithic
    paths record theirs: the gradient bytes, the bytes at logical
    precision against those on ``wire`` (the WireSpec the reduce-scatters
    move, None uncompressed) and the overlap pin. ``bucket_meta`` is
    ``(elements, itemsize, is_floating)`` a bucket."""
    from ..core.state import global_state
    from ..utils import metrics as _metrics

    pm = global_state().parameter_manager
    if pm is None and not _metrics.enabled():
        return
    total = sum(e * it for e, it, _ in bucket_meta)
    if pm is not None:
        pm.observe(total)
    if not _metrics.enabled():
        return
    from ..optim.compression import wire_sent_bytes

    _metrics.record_grad_reduction(total, len(bucket_meta))
    sent = sum(wire_sent_bytes(e, it, wire if fl else None)
               for e, it, fl in bucket_meta)
    _metrics.record_wire_bytes(total, sent)
    _metrics.record_overlap_window(float(pinned_frac))


def _require_scalar(loss):
    if loss.dim() != 0:
        raise ValueError(f"the last stage must return a scalar loss; got "
                         f"shape {tuple(loss.shape)}")
