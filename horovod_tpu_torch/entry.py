"""The port's entry points: a one-card forward and loss check, and a
multi-rank dry run of the parallel training steps.

The port of the JAX package's ``__graft_entry__``. :func:`entry` is
GPT-2 small (``max_seq_len`` 512) on a ``[4, 512]`` batch of tokens from
``RandomState(0)``, and ``fn(model, tokens)`` the forward plus
``causal_lm_loss``. The weights are ``init_params`` drawn from seed 0,
on the card unless ``device="cpu"`` is asked for.

    from horovod_tpu_torch.entry import entry
    fn, args = entry()
    print(fn(*args))

:func:`dryrun_multichip` runs one training step of each parallel path
over ``n_devices`` ranks on a tiny model: the dp x tp x sp step with
ring attention, then GPipe's forward and backward on a pp = 2 mesh, then
the 1F1B step, each printing its ``OK`` line with a finite loss. On the
CPU the ranks are a gloo world of as many processes; on the card they
are emulated in this process (threads over ``parallel.comm``'s
``ThreadWorld``), since one card holds no NCCL world of several ranks.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .models.transformer import (GPT2_SMALL, Transformer, TransformerConfig,
                                 causal_lm_loss)


def entry(device: Optional[str] = None
          ) -> Tuple[Callable[..., torch.Tensor],
                     Tuple[Transformer, torch.Tensor]]:
    """``(fn, (model, tokens))``: GPT-2 small's forward and causal-LM
    loss, ``fn(model, tokens) -> loss``, on ``device`` (default: the
    card; without one it raises)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry(): no CUDA device; pass device='cpu' to "
                           "run on the CPU")
    cfg = dataclasses.replace(GPT2_SMALL, max_seq_len=512)
    with torch.device(dev):
        model = Transformer(cfg)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 512))).to(dev)

    def fwd(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
        loss, _ = causal_lm_loss(model(tokens), tokens)
        return loss

    return fwd, (model, tokens)


#: the dry run's model, the JAX dry run's
DRYRUN_CFG = TransformerConfig(vocab_size=256, num_layers=2, num_heads=4,
                               hidden_size=64, max_seq_len=64,
                               dtype=torch.float32)


def dryrun_factors(n: int) -> Tuple[int, int, int]:
    """``(dp, tp, sp)`` of ``n`` ranks, as the JAX dry run factors them:
    sp = 2 and tp = 2 where they divide."""
    sp = 2 if n % 2 == 0 else 1
    tp = 2 if n % (sp * 2) == 0 else 1
    return n // (sp * tp), tp, sp


def _finite(model, loss: float, what: str) -> None:
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite {what} loss {loss}")
    if not all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None):
        raise RuntimeError(f"non-finite {what} gradients")


def _dryrun_rank(n: int, device, mesh_of) -> List[str]:
    """One rank's dry run; ``mesh_of(**axes)`` is its mesh of those
    axes over the ``n`` ranks. Returns its ``OK`` lines."""
    from .parallel.pipeline import (build_stage, pipeline_lm_train_step_1f1b,
                                    pipeline_lm_train_step_gpipe)
    from .parallel.sharding import batch_slices
    from .parallel.train import make_lm_train_step

    cfg, T = DRYRUN_CFG, DRYRUN_CFG.max_seq_len
    dp, tp, sp = dryrun_factors(n)
    mesh = mesh_of(dp=dp, tp=tp, sp=sp)
    model, step = make_lm_train_step(
        cfg, functools.partial(torch.optim.Adam, lr=1e-3), device=device,
        mesh=mesh, sequence_parallel="ring" if sp > 1 else None)
    batch = max(dp * 2, 2)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (batch, T))
    rows, _ = batch_slices(mesh, batch, T)
    loss = float(step(torch.from_numpy(tokens[rows]).to(device)))
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    lines = [f"dryrun_multichip OK: mesh dp={dp} tp={tp} sp={sp} "
             f"({n} devices), loss={loss:.4f}"]
    if n % 2:
        return lines
    # the pipeline: GPipe's forward and backward, then the 1F1B step
    pp, pdp = 2, n // 2
    pmesh = mesh_of(pp=pp, dp=pdp)
    stage = build_stage(cfg, pmesh, device=device, seed=1)
    batch = max(4, 2 * pdp)
    plain = np.random.RandomState(1).randint(0, cfg.vocab_size, (batch, T))
    rows, _ = batch_slices(pmesh, batch, T)
    plain = torch.from_numpy(plain[rows]).to(device)
    for name, fn in (("pipeline", pipeline_lm_train_step_gpipe),
                     ("1f1b", pipeline_lm_train_step_1f1b)):
        loss = float(fn(cfg, stage, plain, pmesh, num_microbatches=2))
        _finite(stage, loss, name)
        lines.append(f"dryrun {name} OK: pp={pp} dp={pdp}, loss={loss:.4f}")
    return lines


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """One training step of each parallel path over ``n_devices`` ranks
    (module doc), on ``device``: the card (default; its ranks emulated
    here) or ``"cpu"`` (a gloo world of ``n_devices`` processes). Prints
    the ``OK`` lines; raises if a step fails or is not finite."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        print("\n".join(_dryrun_processes(n_devices)), flush=True)
        return
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(): no CUDA device; pass "
                           "device='cpu' to run a gloo world on the CPU")
    _dryrun_emulated(n_devices, dev)


def _dryrun_emulated(n: int, dev: torch.device) -> None:
    """The dry run's ``n`` ranks as threads of this process over
    ``parallel.comm``'s ``ThreadWorld``s (the card's route; on a CPU
    device the same code, for its tests)."""
    from .core import basics
    from .parallel.comm import run_ranks
    from .parallel.mesh import emulated_meshes, make_mesh

    dp, tp, sp = dryrun_factors(n)
    if dp > 1:
        raise ValueError(
            f"dryrun_multichip({n}) on the card: its ranks are emulated, "
            f"and the dp x tp x sp step's data axis ({dp}) needs process "
            "sets; use 1, 2 or 4 ranks, or device='cpu'")
    layouts, worlds = {}, []
    for axes in (dict(dp=dp, tp=tp, sp=sp), dict(pp=2, dp=n // 2)):
        if axes.get("pp") and n % 2:
            continue
        meshes, w = emulated_meshes(make_mesh(world=n, **axes))
        layouts[tuple(sorted(axes.items()))] = meshes
        worlds += w

    def rank(r):
        return _dryrun_rank(n, dev, lambda **axes: layouts[
            tuple(sorted(axes.items()))][r])

    ours = not basics.is_initialized()
    if ours:
        basics.init(device="cpu" if dev.type == "cpu" else None)
    try:
        out = run_ranks(worlds, rank, n)
    finally:
        if ours:
            basics.shutdown()
    print("\n".join(out[0]), flush=True)


def _dryrun_processes(n: int) -> List[str]:
    """The dry run as a gloo world of ``n`` processes on the CPU, started
    by the port's launcher (``runner.run``); rank 0's ``OK`` lines."""
    from .runner import run

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join([root] + [p for p in [os.environ.get(
        "PYTHONPATH")] if p])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=path)
    return run(_dryrun_worker, args=(n,), np=n, env=env)[0]


def _dryrun_worker(n: int) -> List[str]:
    """One rank of :func:`_dryrun_processes`' world: its ``OK`` lines."""
    from .core import basics
    from .parallel.mesh import make_mesh

    torch.set_num_threads(1)
    basics.init(device="cpu")
    try:
        return _dryrun_rank(n, torch.device("cpu"),
                            lambda **axes: make_mesh(**axes))
    finally:
        basics.shutdown()


if __name__ == "__main__":
    fn, args = entry()
    print("entry loss:", float(fn(*args)))
    dryrun_multichip(torch.cuda.device_count() or 1)
