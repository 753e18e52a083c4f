"""The port's entry point: a one-card forward and loss check.

The port of the JAX package's ``__graft_entry__.entry``: GPT-2 small
(``max_seq_len`` 512) on a ``[4, 512]`` batch of tokens from
``RandomState(0)``, and ``fn(model, tokens)`` the forward plus
``causal_lm_loss``. The weights are ``init_params`` drawn from seed 0,
on the card unless ``device="cpu"`` is asked for.

    from horovod_tpu_torch.entry import entry
    fn, args = entry()
    print(fn(*args))

The JAX module's multi-device dry run (``dryrun_multichip``) needs the
tensor, sequence and pipeline parallel steps, which the port does not
have yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .models.transformer import GPT2_SMALL, Transformer, causal_lm_loss


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
