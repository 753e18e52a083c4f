"""GPT-2 training with Adasum gradient combining: a convergence smoke.

The port of the JAX package's ``examples/adasum_gpt2.py``, with its
flags, synthetic data and output lines: a GPT-2 (``--layers``,
``--hidden``, heads = hidden // 64, ``--vocab``, ``--seq-len``) learns a
fixed random bigram language under ``torch.optim.Adam`` wrapped in the
``DistributedOptimizer`` with ``op=Adasum``, which combines each fused
gradient bucket by Adasum (``ops/adasum.py``) and needs no learning-rate
scaling by the world size, so the learning rate is not multiplied by
``size()``. ``--flash`` runs the flash-attention kernels, ``--fused-ce``
the vocab-blocked fused LM head and cross-entropy (``block_vocab`` 512
on the tied embedding). The global batch is ``--batch-size`` rows a
rank, each rank training on its own rows.

Run on the card, one process per card (the launcher,
``horovod_tpu_torch.runner``, exports the rank environment for several;
Adasum needs a power-of-two number of ranks):

    python -m horovod_tpu_torch.examples.adasum_gpt2 --steps 30
    python -m horovod_tpu_torch.examples.adasum_gpt2 --layers 24 \\
        --hidden 1024 --vocab 50257 --seq-len 1024 --batch-size 8 --flash
    python -m horovod_tpu_torch.examples.adasum_gpt2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..core import basics
from ..models.transformer import GPT2_SMALL, Transformer, causal_lm_loss
from ..ops.collectives import Adasum, allreduce
from ..ops.flash_attention import make_flash_attention_fn
from ..ops.fused_cross_entropy import fused_causal_lm_loss
from ..optim.distributed import DistributedOptimizer
from ..optim.functions import broadcast_parameters


def bigram_tokens(vocab: int, batch: int, seq: int,
                  seed: int = 0) -> np.ndarray:
    """The JAX example's global ``[batch, seq]`` int64 batch: tokens
    follow a fixed random bigram table (4 successors a token) drawn from
    ``RandomState(seed)`` (the example's: 0), so the model has real
    structure to fit."""
    r = np.random.RandomState(seed)
    table = r.randint(0, vocab, (vocab, 4))
    toks = np.zeros((batch, seq), dtype=np.int64)
    toks[:, 0] = r.randint(0, vocab, batch)
    choice = r.randint(0, 4, (batch, seq))
    for t in range(1, seq):
        toks[:, t] = table[toks[:, t - 1], choice[:, t]]
    return toks


def main(argv=None, stats=None, init=None):
    """Train and print the JAX example's lines; returns ``(first loss,
    last loss)``, each the mean over the ranks. ``init``: a state dict to
    start from (default: random weights from seed 0). ``stats``, when
    given, receives every step's loss and wall ms, tokens/s and the
    model."""
    p = argparse.ArgumentParser(description="GPT-2 + Adasum smoke")
    p.add_argument("--batch-size", type=int, default=4,
                   help="per-rank batch size")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--flash", action="store_true",
                   help="flash-attention kernels (fwd + bwd)")
    p.add_argument("--fused-ce", action="store_true",
                   help="vocab-blocked fused LM-head cross-entropy")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the card)")
    args = p.parse_args(argv)

    basics.init(device=args.device)
    n, rank, dev = basics.size(), basics.rank(), basics.device()

    cfg = dataclasses.replace(
        GPT2_SMALL, num_layers=args.layers, hidden_size=args.hidden,
        num_heads=max(1, args.hidden // 64), vocab_size=args.vocab,
        max_seq_len=args.seq_len)
    attention_fn = make_flash_attention_fn(causal=True) if args.flash \
        else None
    with torch.device(dev):
        model = Transformer(cfg, attention_fn=attention_fn)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    if init is not None:
        model.load_state_dict(init)

    B, T = args.batch_size, args.seq_len
    toks = bigram_tokens(args.vocab, B * n, T)
    tok = torch.from_numpy(toks[rank * B:(rank + 1) * B]).to(dev)

    # Adasum: NO lr scaling by world size
    opt = DistributedOptimizer(torch.optim.Adam(model.parameters(),
                                                lr=args.lr),
                               named_parameters=model.named_parameters(),
                               op=Adasum)
    broadcast_parameters(model.state_dict(), root_rank=0)

    def loss_fn(tokens):
        if args.fused_ce:
            hidden = model(tokens, return_hidden=True)
            return fused_causal_lm_loss(
                hidden, model.tok_emb.embedding.t(), tokens,
                block_vocab=512)[0]
        return causal_lm_loss(model(tokens), tokens)[0]

    losses, step_ms = [], []
    first = lv = None
    t0 = time.time()
    for i in range(args.steps):
        t1 = time.perf_counter()
        loss = loss_fn(tok)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        lv = float(allreduce(loss.detach().reshape(1)).item())
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(lv)
        if first is None:
            first = lv
        if rank == 0 and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i}: loss {lv:.4f}", flush=True)
    if rank == 0:
        print(f"loss {first:.4f} -> {lv:.4f} in {args.steps} steps "
              f"({time.time() - t0:.1f}s, adasum over {n} ranks)",
              flush=True)
    if stats is not None:
        stats["losses"], stats["step_ms"] = losses, step_ms
        stats["tokens_per_s"] = [B * n * T / (ms / 1e3) for ms in step_ms]
        stats["model"], stats["tokens"] = model, tok
    return first, lv


if __name__ == "__main__":
    main()
