"""Pipeline-parallel causal-LM pretraining over a pp x dp mesh.

The port of the JAX package's ``examples/pipeline_pretraining.py``,
with its flags, data and output lines, one process a rank: the world
is a ``pp x dp`` mesh (``parallel.make_mesh``), each rank holding its
stage's blocks (``parallel.build_stage``) and training its data rows of
the global batch. Two schedules:

  * ``--schedule gpipe``: the forward pipelined
    (``pipeline_lm_apply``), the backward through it, the schedule's
    ticks in reverse (``pipeline_lm_train_step_gpipe``);
  * ``--schedule 1f1b`` (default): the fused, memory-bounded train step
    (``pipeline_lm_train_step_1f1b``): a microbatch's backward starts as
    soon as its gradient arrives, at most ``pp`` stage inputs stored.

Run on the cards, one process a card (the launcher,
``horovod_tpu_torch.runner``, or ``examples/local_world.py`` exports the
rank environment), or on the CPU with ``--device cpu``:

    python -m horovod_tpu_torch.examples.local_world -np 2 -- \\
        python -m horovod_tpu_torch.examples.pipeline_pretraining --pp 2
    python -m horovod_tpu_torch.examples.local_world -np 2 -- \\
        python -m horovod_tpu_torch.examples.pipeline_pretraining \\
        --schedule gpipe --pp 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..core import basics
from ..models.transformer import GPT2_SMALL
from ..parallel.mesh import make_mesh
from ..parallel.pipeline import (build_stage, pipeline_lm_train_step_1f1b,
                                 pipeline_lm_train_step_gpipe)
from ..parallel.sharding import batch_slices


def main(argv=None, stats=None):
    """Train and print the JAX example's lines; returns ``(first loss,
    last loss)``. ``stats``, when given, receives every step's loss and
    wall seconds."""
    p = argparse.ArgumentParser(
        description="pipeline-parallel GPT-2 pretraining")
    p.add_argument("--schedule", choices=("1f1b", "gpipe"),
                   default="1f1b")
    p.add_argument("--pp", type=int, default=2, help="pipeline stages")
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8,
                   help="global batch size")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the card)")
    args = p.parse_args(argv)
    if args.steps < 2:
        p.error("--steps must be >= 2 (step 0 is the warm-up step and "
                "is excluded from the timed window)")

    basics.init(device=args.device)
    n = basics.size()
    if n % args.pp:
        p.error(f"{n} ranks do not split into {args.pp} pipeline stages")
    dp = n // args.pp
    mesh = make_mesh(pp=args.pp, dp=dp)

    heads = max(2, args.hidden // 64)
    cfg = dataclasses.replace(
        GPT2_SMALL, num_layers=args.layers, hidden_size=args.hidden,
        num_heads=heads, max_seq_len=args.seq_len, vocab_size=512,
        dtype=torch.float32)
    dev = basics.device()
    model = build_stage(cfg, mesh, device=dev)
    B, T = args.batch_size, args.seq_len
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, T))
    rows, _ = batch_slices(mesh, B, T)
    tok = torch.from_numpy(toks[rows]).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    M = args.microbatches

    first = t0 = None
    losses, secs = [], []
    for i in range(args.steps):
        t1 = time.perf_counter()
        if args.schedule == "1f1b":
            loss = pipeline_lm_train_step_1f1b(cfg, model, tok, mesh, M)
        else:
            loss = pipeline_lm_train_step_gpipe(cfg, model, tok, mesh, M)
        opt.step()
        opt.zero_grad(set_to_none=True)
        lv = float(loss)
        secs.append(time.perf_counter() - t1)
        losses.append(lv)
        if first is None:
            first = lv
            t0 = time.perf_counter()  # the warm-up step is not timed
        if basics.rank() == 0:
            print(f"step {i}: loss {lv:.4f}", flush=True)
    dt = max(time.perf_counter() - t0, 1e-9)
    tok_s = B * T * max(args.steps - 1, 1) / dt
    if basics.rank() == 0:
        print(f"{args.schedule} pp={args.pp} dp={dp} M={M}: "
              f"{tok_s:,.0f} tokens/sec, loss {first:.3f} -> "
              f"{lv:.3f}", flush=True)
    if stats is not None:
        stats["losses"], stats["secs"] = losses, secs
    return first, lv


if __name__ == "__main__":
    main()
