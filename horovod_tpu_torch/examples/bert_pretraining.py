"""BERT-Large masked-LM pretraining benchmark (tokens/sec/card + MFU).

The port of the JAX package's ``examples/bert_pretraining.py``, with
its flags, output lines and ``main(argv, stats)`` return: bf16 BERT-Large
(24 layers, hidden 1024, 16 heads, vocab 30522, seq 512; 334M
parameters) on a synthetic masked-LM batch, AdamW (weight decay 1e-4,
optax's default) under the DistributedOptimizer's fused all-reduce, or
with ``--zero`` under the ZeRO-1 ``ShardedOptimizer`` (Adam's m and v
sharded 1/n over the ranks); optionally the non-causal flash-attention
kernels (``--flash``), the fused LayerNorm kernels (``--fused-ln``) and
the vocab-blocked fused LM head and cross-entropy (``--fused-ce``,
``ops/fused_cross_entropy.py``).

Run on the card, one process per card (the launcher,
``horovod_tpu_torch.runner``, exports the rank environment for
several):

    python -m horovod_tpu_torch.examples.bert_pretraining --zero --flash \\
        --fused-ln --fused-ce
    python -m horovod_tpu_torch.examples.bert_pretraining --zero \\
        --layers 2 --hidden 64 --device cpu   # a smoke on the CPU

The gradient wire follows ``HOROVOD_COMPRESSION``; the first line names
it. ``--autotune-spmd`` (the SPMD step tuner) is not ported yet and
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time

import numpy as np
import torch

from ..core import basics
from ..core.basics import _require_init
from ..models.transformer import BERT_LARGE, Transformer, mlm_loss
from ..ops.collectives import allreduce
from ..ops.flash_attention import make_flash_attention_fn
from ..ops.fused_cross_entropy import fused_linear_cross_entropy
from ..optim.distributed import DistributedOptimizer
from ..optim.functions import broadcast_parameters
from ..optim.zero import ShardedOptimizer, state_bytes
from ..utils.mfu import count_params, peak_flops_per_chip, \
    transformer_train_flops


def synthetic_mlm_batch(vocab, batch, seq, mask_frac, rank, size,
                        cross_size=1):
    """This rank's ``(tokens, labels, mask)`` rows of the JAX example's
    synthetic batch: ``batch * size`` rows of tokens, then labels, then
    the mask (``rand < mask_frac``) drawn in that order from seed 0 (each
    host's rank when there are several hosts), rank r taking rows
    ``[r * batch, (r + 1) * batch)``."""
    rng = np.random.RandomState(rank if cross_size > 1 else 0)
    rows = batch * size
    tokens = rng.randint(0, vocab, (rows, seq)).astype(np.int64)
    labels = rng.randint(0, vocab, (rows, seq)).astype(np.int64)
    mask = rng.rand(rows, seq) < mask_frac
    mine = slice(rank * batch, (rank + 1) * batch)
    return tokens[mine], labels[mine], mask[mine]


def make_mlm_train_step(cfg, optimizer, *, zero=False, attention_fn=None,
                        device=None, fused_ce=False):
    """Build ``(model, step)`` for data-parallel masked-LM training.

    ``optimizer`` makes the inner torch optimizer from a list of tensors
    (e.g. ``functools.partial(torch.optim.AdamW, lr=1e-4,
    weight_decay=1e-4)``). The model is built on ``device`` (default:
    the device ``init()`` chose) with random weights from seed 0, and
    rank 0's weights are broadcast; then ``zero`` wraps the optimizer in
    the ZeRO-1 ``ShardedOptimizer``, else in the
    ``DistributedOptimizer``. ``step(tokens, labels, mask) -> loss``
    runs the forward, ``mlm_loss``, the backward and the optimizer step
    and returns the local loss; ``step.optimizer`` is the wrapper.
    ``fused_ce`` takes the loss from the pre-head activations through
    ``fused_linear_cross_entropy`` with the tied embedding as the head,
    as the JAX example's ``--fused-ce`` does."""
    st = _require_init()
    device = st.device if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mlm_train_step: no CUDA device; pass "
                           "device='cpu' to train on the CPU")
    with torch.device(device):
        model = Transformer(cfg, attention_fn=attention_fn)
    model.init_params(torch.Generator(device=device).manual_seed(0))
    broadcast_parameters(model.state_dict(), root_rank=0)
    if zero:
        opt = ShardedOptimizer(optimizer, model.named_parameters())
    else:
        opt = DistributedOptimizer(optimizer(list(model.parameters())),
                                   named_parameters=model.named_parameters())

    def loss_of(tokens, labels, mask):
        if fused_ce:
            hidden = model(tokens, return_hidden=True)
            return fused_linear_cross_entropy(
                hidden, model.tok_emb.embedding.t(), labels, valid=mask)[0]
        return mlm_loss(model(tokens), labels, mask)[0]

    def step(tokens, labels, mask):
        loss = loss_of(tokens, labels, mask)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    step.optimizer = opt
    return model, step


def main(argv=None, stats=None):
    p = argparse.ArgumentParser(
        description="horovod_tpu_torch BERT-Large pretraining benchmark")
    p.add_argument("--batch-size", type=int, default=8,
                   help="per-rank batch size")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--mask-frac", type=float, default=0.15)
    p.add_argument("--num-warmup-batches", type=int, default=2)
    p.add_argument("--num-batches-per-iter", type=int, default=5)
    p.add_argument("--num-iters", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--layers", type=int, default=0,
                   help="override depth (0 = BERT-Large's 24)")
    p.add_argument("--hidden", type=int, default=0,
                   help="override width (0 = BERT-Large's 1024)")
    p.add_argument("--remat", action="store_true",
                   help="per-block rematerialization")
    p.add_argument("--flash", action="store_true",
                   help="non-causal flash-attention kernels (fwd + bwd)")
    p.add_argument("--fused-ce", action="store_true",
                   help="vocab-blocked fused LM-head cross-entropy")
    p.add_argument("--fused-ln", action="store_true",
                   help="fused LayerNorm kernels (fwd + bwd)")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1 sharded optimizer states "
                        "(ShardedOptimizer): Adam m/v split 1/N across "
                        "ranks")
    p.add_argument("--autotune-spmd", action="store_true",
                   help="SPMD step-tuner sweep before the timed run")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the card)")
    args = p.parse_args(argv)
    if args.autotune_spmd:
        raise NotImplementedError(
            "--autotune-spmd: the SPMD step tuner is not ported yet "
            "(ROADMAP item 15)")

    basics.init(device=args.device)
    n = basics.size()
    dev = basics.device()

    cfg = BERT_LARGE
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.hidden:
        heads = max(1, args.hidden // 64)
        cfg = dataclasses.replace(cfg, hidden_size=args.hidden,
                                  num_heads=heads)
    cfg = dataclasses.replace(cfg, max_seq_len=args.seq_len,
                              remat=args.remat, fused_norm=args.fused_ln)
    attention_fn = make_flash_attention_fn(causal=False) if args.flash \
        else None

    B, T = args.batch_size, args.seq_len
    batch = [torch.from_numpy(a).to(dev) for a in synthetic_mlm_batch(
        cfg.vocab_size, B, T, args.mask_frac, basics.rank(), n,
        basics.cross_size())]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model, step = make_mlm_train_step(
        cfg, functools.partial(torch.optim.AdamW, lr=args.lr,
                               weight_decay=1e-4),
        zero=args.zero, attention_fn=attention_fn, fused_ce=args.fused_ce)
    n_params = count_params(model.parameters())

    def sync_loss(loss):
        # the mean loss over the ranks; the host read closes a window
        return float(allreduce(loss.reshape(1)).item())

    wire = step.optimizer.wire
    if basics.rank() == 0:
        print(f"BERT {cfg.num_layers}L/{cfg.hidden_size}H "
              f"({n_params / 1e6:.0f}M params), batch {args.batch_size} x "
              f"{n} ranks, seq {T}, wire "
              f"{wire.describe() if wire else 'none'}"
              f"{', ZeRO-1' if args.zero else ''}", flush=True)
    losses = []  # every step's local loss, read at the end
    for _ in range(args.num_warmup_batches):
        losses.append(step(*batch))
    if losses:
        sync_loss(losses[-1])

    rates, step_ms = [], []
    for it in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            losses.append(step(*batch))
        last = sync_loss(losses[-1])
        dt = time.perf_counter() - t0
        rate = B * n * T * args.num_batches_per_iter / dt
        rates.append(rate)
        step_ms.append(dt * 1e3 / args.num_batches_per_iter)
        if basics.rank() == 0:
            print(f"iter {it}: {rate:.0f} tokens/sec total "
                  f"(loss {last:.3f})", flush=True)

    total = float(np.median(rates))
    per_chip = total / max(n, 1)
    peak = peak_flops_per_chip() if dev.type == "cuda" else None
    mfu = (transformer_train_flops(n_params, per_chip) / peak
           if peak else None)
    peak_mem = (torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else None)
    opt_bytes = state_bytes(step.optimizer)
    if basics.rank() == 0:
        mfu_s = f"MFU {mfu:.1%}" if mfu is not None else \
            "MFU n/a: no peak for this device"
        print(f"tokens/sec on {n} rank(s): {total:.0f} "
              f"({per_chip:.0f}/chip, {mfu_s})", flush=True)
        if dev.type == "cuda":
            print(f"step {float(np.median(step_ms)):.1f} ms, peak device "
                  f"memory {peak_mem:.2f} GB, optimizer state "
                  f"{opt_bytes / 1e9:.2f} GB a rank", flush=True)
    if stats is not None:
        stats["rates_per_chip"] = [r / max(n, 1) for r in rates]
        stats["step_ms"] = step_ms
        stats["losses"] = [float(x) for x in losses]
        stats["n_params"] = n_params
        stats["wire"] = wire.describe() if wire else "none"
        stats["peak_mem_gb"] = peak_mem
        stats["optimizer_state_bytes"] = opt_bytes
        stats["buckets"] = len(step.optimizer.bucket_plan)
        stats["step"], stats["batch"] = step, batch
    return per_chip, mfu


if __name__ == "__main__":
    main()
