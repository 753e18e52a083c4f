"""Llama-2 training with Adasum gradient combining.

The port of the JAX package's ``examples/llama_adasum.py``, with its
flags, synthetic data and output lines: the Llama-2 architecture
(``LLAMA2_7B``: RMSNorm, rotary positions, SwiGLU, an untied head) with
depth, width and vocabulary from the flags (heads = hidden // 128, so
head_dim 128, full multi-head attention) learns a fixed random bigram
language under ``torch.optim.Adam`` wrapped in the
``DistributedOptimizer`` with ``op=Adasum``. Adasum needs no
learning-rate scaling by the world size, so the learning rate is not
multiplied by ``size()``. ``--flash`` runs the flash-attention kernels
(B1-B3 at head_dim 128), ``--remat`` recomputes each block in the
backward (``torch.utils.checkpoint``, so B1 runs twice a layer),
``--bf16-allreduce`` moves the gradients as bf16. The global batch is
``--batch-size`` rows a rank, each rank training on its own rows.

Run on the card, one process per card (the launcher,
``horovod_tpu_torch.runner``, exports the rank environment for several;
Adasum needs a power-of-two number of ranks):

    python -m horovod_tpu_torch.examples.llama_adasum --steps 20
    python -m horovod_tpu_torch.examples.llama_adasum --layers 12 \\
        --hidden 4096 --vocab 32000 --seq-len 4096 --batch-size 2 \\
        --flash --remat
    python -m horovod_tpu_torch.examples.llama_adasum --device cpu \\
        --layers 2 --hidden 256 --vocab 256 --seq-len 64 --batch-size 1
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..core import basics
from ..models.transformer import LLAMA2_7B, Transformer, causal_lm_loss
from ..ops.collectives import Adasum, allreduce
from ..ops.flash_attention import make_flash_attention_fn
from ..optim.compression import Compression
from ..optim.distributed import DistributedOptimizer
from ..optim.functions import broadcast_parameters
from ..utils.mfu import count_params
from .adasum_gpt2 import bigram_tokens


def config(args):
    """The JAX example's config from its flags."""
    return dataclasses.replace(
        LLAMA2_7B, num_layers=args.layers, hidden_size=args.hidden,
        num_heads=max(1, args.hidden // 128), num_kv_heads=None,
        mlp_ratio=LLAMA2_7B.mlp_ratio, vocab_size=args.vocab,
        max_seq_len=args.seq_len, remat=args.remat)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Llama-2 + Adasum")
    p.add_argument("--batch-size", type=int, default=2,
                   help="per-rank batch size")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--layers", type=int, default=4,
                   help="depth (LLAMA2_7B has 32)")
    p.add_argument("--hidden", type=int, default=1024,
                   help="width (LLAMA2_7B has 4096)")
    p.add_argument("--vocab", type=int, default=2048,
                   help="vocab (LLAMA2_7B has 32000)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--flash", action="store_true",
                   help="flash-attention kernels (fwd + bwd)")
    p.add_argument("--bf16-allreduce", action="store_true",
                   help="bfloat16 wire compression for the adasum path")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the card)")
    return p


def main(argv=None, stats=None, init=None):
    """Train and print the JAX example's lines; returns ``(first loss,
    last loss)``, each the mean over the ranks. ``init``: a state dict to
    start from (default: random weights from seed 0). ``stats``, when
    given, receives every step's loss and wall ms, tokens/s, the
    parameter count, the model, this rank's tokens and the step (a
    function that trains one more step and returns its loss)."""
    args = parser().parse_args(argv)

    basics.init(device=args.device)
    n, rank, dev = basics.size(), basics.rank(), basics.device()

    cfg = config(args)
    attention_fn = make_flash_attention_fn(causal=True) if args.flash \
        else None
    with torch.device(dev):
        model = Transformer(cfg, attention_fn=attention_fn)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    if init is not None:
        model.load_state_dict(init)

    B, T = args.batch_size, args.seq_len
    # learnable synthetic language (fixed random bigram table)
    toks = bigram_tokens(args.vocab, B * n, T)
    tok = torch.from_numpy(toks[rank * B:(rank + 1) * B]).to(dev)

    compression = Compression.bf16 if args.bf16_allreduce else \
        Compression.none
    # Adasum: NO lr scaling by world size
    opt = DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=args.lr),
        named_parameters=model.named_parameters(), op=Adasum,
        compression=compression)
    broadcast_parameters(model.state_dict(), root_rank=0)
    n_params = count_params(model.parameters())

    if rank == 0:
        print(f"Llama {cfg.num_layers}L/{cfg.hidden_size}H "
              f"({n_params / 1e6:.0f}M params), batch {B} x {n} ranks, "
              f"seq {T}, adasum", flush=True)

    def step() -> float:
        loss = causal_lm_loss(model(tok), tok)[0]
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return float(allreduce(loss.detach().reshape(1)).item())

    losses, step_ms = [], []
    t0 = time.time()
    for i in range(args.steps):
        if i == 1:  # the first step builds the kernels; time the rest
            t0 = time.time()
        t1 = time.perf_counter()
        lv = step()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(lv)
        if i and rank == 0 and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i}: loss {lv:.4f}", flush=True)
    dt = time.time() - t0
    tput = B * n * T * (args.steps - 1) / dt if args.steps > 1 else 0.0
    first, last = losses[0], losses[-1]
    if rank == 0:
        print(f"loss {first:.4f} -> {last:.4f} in {args.steps} steps; "
              f"{tput:.0f} tokens/sec total over {n} rank(s)", flush=True)
    if stats is not None:
        stats["losses"], stats["step_ms"] = losses, step_ms
        stats["tokens_per_s"] = [B * n * T / (ms / 1e3) for ms in step_ms]
        stats["n_params"] = n_params
        stats["model"], stats["tokens"] = model, tok
        stats["step"] = step
    return first, last


if __name__ == "__main__":
    main()
