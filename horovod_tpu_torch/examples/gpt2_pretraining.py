"""GPT-2 causal-LM pretraining benchmark (tokens/sec/card + MFU).

The port of the JAX package's ``examples/gpt2_pretraining.py``, with
its flags, output lines and ``main(argv, stats)`` return: bf16 GPT-2
medium (24 layers, hidden 1024, 355M parameters) on a synthetic token
batch, AdamW under the DistributedOptimizer's fused gradient buckets,
optionally the flash-attention kernels (``--flash``) and the fused
LayerNorm kernels (``--fused-norm``).

Run on the card, one process per card (``horovod_tpu.runner`` exports
the rank environment for several):

    python -m horovod_tpu_torch.examples.gpt2_pretraining --flash --fused-norm
    python -m horovod_tpu_torch.examples.gpt2_pretraining --layers 2 \\
        --hidden 256 --device cpu   # a smoke on the CPU

The gradient wire follows ``HOROVOD_COMPRESSION`` (``int8``: the
block-quantized wire with error feedback, whose quantize, dequantize-
accumulate and dequantize stages are kernels too); the first line names
it. ``--fused-ce`` (the vocab-blocked fused cross-entropy) is not ported
yet and raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time

import numpy as np
import torch

from ..core import basics
from ..models.transformer import GPT2_MEDIUM
from ..ops.collectives import allreduce
from ..ops.flash_attention import make_flash_attention_fn
from ..parallel.train import make_lm_train_step
from ..utils.mfu import count_params, peak_flops_per_chip, \
    transformer_train_flops


def synthetic_tokens(vocab, batch, seq, rank, size, cross_size=1):
    """This rank's ``[batch, seq]`` int64 rows of the synthetic batch, as
    the JAX example shards its global batch over the ranks: ``batch *
    size`` rows drawn from seed 0 (each host's rank when there are
    several hosts), rank r taking rows ``[r * batch, (r + 1) * batch)``,
    so each rank trains on its own data."""
    rng = np.random.RandomState(rank if cross_size > 1 else 0)
    rows = rng.randint(0, vocab, (batch * size, seq)).astype(np.int64)
    return rows[rank * batch:(rank + 1) * batch]


def main(argv=None, stats=None):
    p = argparse.ArgumentParser(
        description="horovod_tpu_torch GPT-2 causal pretraining benchmark")
    p.add_argument("--batch-size", type=int, default=16,
                   help="per-rank batch size")
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--num-warmup-batches", type=int, default=2)
    p.add_argument("--num-batches-per-iter", type=int, default=5)
    p.add_argument("--num-iters", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--layers", type=int, default=0,
                   help="override depth (0 = GPT-2-medium's 24)")
    p.add_argument("--hidden", type=int, default=0,
                   help="override width (0 = GPT-2-medium's 1024)")
    p.add_argument("--remat", action="store_true",
                   help="per-block rematerialization")
    p.add_argument("--flash", action="store_true",
                   help="causal flash-attention kernels (fwd+bwd)")
    p.add_argument("--fused-norm", action="store_true",
                   help="fused LayerNorm kernels (fwd+bwd)")
    p.add_argument("--fused-ce", action="store_true",
                   help="vocab-blocked fused LM-head cross-entropy")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the card)")
    args = p.parse_args(argv)
    if args.fused_ce:
        raise NotImplementedError(
            "--fused-ce: the fused LM-head cross-entropy is not ported yet "
            "(ROADMAP item 1)")

    basics.init(device=args.device)
    n = basics.size()
    dev = basics.device()

    cfg = GPT2_MEDIUM
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.hidden:
        heads = max(1, args.hidden // 64)
        cfg = dataclasses.replace(cfg, hidden_size=args.hidden,
                                  num_heads=heads)
    cfg = dataclasses.replace(cfg, max_seq_len=args.seq_len,
                              remat=args.remat, fused_norm=args.fused_norm)
    attention_fn = make_flash_attention_fn(causal=True) if args.flash \
        else None

    B, T = args.batch_size, args.seq_len
    tokens = torch.from_numpy(synthetic_tokens(
        cfg.vocab_size, B, T, basics.rank(), n, basics.cross_size())).to(dev)

    model, step = make_lm_train_step(
        cfg, functools.partial(torch.optim.AdamW, lr=args.lr,
                               weight_decay=1e-4),
        attention_fn=attention_fn)
    n_params = count_params(model.parameters())

    def sync_loss(loss):
        # the mean loss over the ranks; the host read closes a window
        return float(allreduce(loss.reshape(1)).item())

    wire = step.optimizer.wire
    if basics.rank() == 0:
        print(f"GPT-2 {cfg.num_layers}L/{cfg.hidden_size}H "
              f"({n_params / 1e6:.0f}M params), batch {args.batch_size} x "
              f"{n} ranks, seq {T}, wire "
              f"{wire.describe() if wire else 'none'}", flush=True)
    losses = []  # every step's local loss, read at the end
    for _ in range(args.num_warmup_batches):
        losses.append(step(tokens))
    if losses:
        sync_loss(losses[-1])

    rates, step_ms = [], []
    for it in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            losses.append(step(tokens))
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
    if basics.rank() == 0:
        mfu_s = f"MFU {mfu:.1%}" if mfu is not None else \
            "MFU n/a: no peak for this device"
        print(f"tokens/sec on {n} rank(s): {total:.0f} "
              f"({per_chip:.0f}/chip, {mfu_s})", flush=True)
        if dev.type == "cuda":
            print(f"step {float(np.median(step_ms)):.1f} ms, peak device "
                  f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
                  " GB", flush=True)
    if stats is not None:
        stats["rates_per_chip"] = [r / max(n, 1) for r in rates]
        stats["step_ms"] = step_ms
        stats["losses"] = [float(x) for x in losses]
        stats["n_params"] = n_params
        stats["wire"] = wire.describe() if wire else "none"
        stats["step"], stats["tokens"] = step, tokens
    return per_chip, mfu


if __name__ == "__main__":
    main()
