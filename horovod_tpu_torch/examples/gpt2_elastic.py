"""Elastic GPT-2 training: survive hosts joining and leaving.

The port of the JAX package's ``examples/gpt2_elastic.py`` (reference
examples/elastic/pytorch/pytorch_synthetic_benchmark_elastic.py), with
its flags, defaults, synthetic tokens and printed lines: the model,
Adam's state, the step and the last loss live in a
:class:`~horovod_tpu_torch.elastic.TorchState`, the loop is wrapped in
``@hvd.elastic.run``, and ``state.commit()`` snapshots every
``--commit-every`` steps, so a world change replays at most one commit
interval. Each entry into ``train`` (the first, and every one after a
reset) builds for the current world: the learning rate
``--lr x size()``, the ``DistributedOptimizer`` around the one
``torch.optim.Adam`` and this rank's rows of the ``RandomState(0)``
token batch (``--batch-size`` rows a rank). The config is GPT-2 small's
with depth, width (heads of 64), vocabulary and context from the flags;
``--flash`` runs the flash-attention kernels (B1-B3).

Under the elastic launcher a preempted worker (SIGTERM) writes its last
commit as the emergency snapshot and exits 83; the next round's worker
resumes from it (the recovery ladder), and a worker that dies
(``HOROVOD_TPU_FAULT_SPEC=worker:kill:rank=0:step=2``) has its host
blacklisted and the job restarted on the others.

Run (static, on the card, or ``--device cpu``):

    python -m horovod_tpu_torch.examples.gpt2_elastic --steps 50
Run (elastic):

    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 \\
        --max-np 4 --host-discovery-script ./discover.sh \\
        --emergency-checkpoint /ckpt/emergency.pkl \\
        python -m horovod_tpu_torch.examples.gpt2_elastic
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import elastic
from ..core import basics
from ..models.transformer import GPT2_SMALL, Transformer, causal_lm_loss
from ..ops.collectives import allreduce
from ..ops.flash_attention import make_flash_attention_fn
from ..optim.distributed import DistributedOptimizer


def config(args):
    """The JAX example's config from its flags."""
    return dataclasses.replace(
        GPT2_SMALL, num_layers=args.layers, hidden_size=args.hidden,
        num_heads=max(1, args.hidden // 64), vocab_size=args.vocab,
        max_seq_len=args.seq_len)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="elastic GPT-2 example")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--commit-every", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--flash", action="store_true",
                   help="flash-attention kernels (fwd + bwd)")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the card)")
    return p


def tokens(vocab: int, batch: int, seq: int, rank: int, size: int):
    """This rank's rows of the JAX example's batch: ``batch * size``
    rows from ``RandomState(0)``, rank r taking ``[r * batch, (r + 1) *
    batch)`` (the ``P("hvd")`` sharding of its global batch)."""
    rows = np.random.RandomState(0).randint(0, vocab, (batch * size, seq))
    return rows[rank * batch:(rank + 1) * batch].astype(np.int64)


def main(argv=None, stats=None, init=None):
    """Train and print the JAX example's lines; returns the final loss
    (the mean over the ranks). ``init``: a state dict to start from
    (default: random weights from seed 0). ``stats``, when given,
    receives every step's loss (by step, the last run of each), the
    wall seconds of each ``commit()``, each commit interval's ms a step
    and tokens/s, the resets, the model, the Adam optimizer and the
    elastic state."""
    args = parser().parse_args(argv)

    basics.init(device=args.device)
    dev = basics.device()

    cfg = config(args)
    attention_fn = make_flash_attention_fn(causal=True) if args.flash \
        else None
    with torch.device(dev):
        model = Transformer(cfg, attention_fn=attention_fn)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    if init is not None:
        model.load_state_dict(init)
    # Adam's state is created by its first step; train() sets the
    # learning rate of each world
    adam = torch.optim.Adam(model.parameters(), lr=args.lr * basics.size())
    state = elastic.TorchState(model=model, optimizer=adam, step=0,
                               last_loss=float("nan"))

    losses, commit_s, interval_ms, rates = {}, [], [], []
    entries = []

    @elastic.run
    def train(state):
        # (re)build for the CURRENT world: its size, the LR scale, the
        # optimizer wrapper's hooks and this rank's rows
        n, rank, dev = basics.size(), basics.rank(), basics.device()
        entries.append(n)
        for group in adam.param_groups:
            group["lr"] = args.lr * n
        opt = DistributedOptimizer(
            adam, named_parameters=model.named_parameters())
        B, T = args.batch_size, args.seq_len
        tok = torch.from_numpy(tokens(args.vocab, B, T, rank, n)).to(dev)
        loss = None
        t0, first = time.perf_counter(), state.step
        while state.step < args.steps:
            local = causal_lm_loss(model(tok), tok)[0]
            local.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            loss = allreduce(local.detach().reshape(1))
            state.step += 1
            losses[state.step] = loss
            if state.step % args.commit_every == 0:
                # host read only at commit boundaries: a read every step
                # would serialize the card's queue
                state.last_loss = float(loss[0])
                dt = time.perf_counter() - t0
                done = state.step - first
                interval_ms.append(dt * 1e3 / done)
                rates.append(B * n * T * done / dt)
                t1 = time.perf_counter()
                # snapshot + surface pending host updates
                # (reference common/elastic.py:60)
                state.commit()
                commit_s.append(time.perf_counter() - t1)
                if rank == 0:
                    print(f"step {state.step}: loss {state.last_loss:.4f} "
                          f"(world {n})", flush=True)
                t0, first = time.perf_counter(), state.step
        if loss is not None:
            state.last_loss = float(loss[0])
        # state, not a local: an entry after the last commit's interrupt
        # skips the loop
        return state.last_loss

    t0 = time.time()
    final = train(state)
    if basics.rank() == 0:
        print(f"done: {args.steps} steps, final loss {final:.4f} "
              f"({time.time() - t0:.1f}s)", flush=True)
    if stats is not None:
        stats["losses"] = [float(losses[s][0]) for s in sorted(losses)]
        stats["commit_s"] = commit_s
        stats["interval_step_ms"] = interval_ms
        stats["tokens_per_s"] = rates
        stats["resets"] = len(entries) - 1
        stats["model"], stats["optimizer"], stats["state"] = \
            model, adam, state
    return final


if __name__ == "__main__":
    main()
