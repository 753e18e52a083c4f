"""The data-parallel causal-LM training step.

The pure data-parallel subset of the JAX package's
``parallel/train.py`` ``make_lm_train_step``: every rank holds the whole
model, takes its own batch, and averages gradients through the
:func:`~horovod_tpu_torch.optim.distributed.DistributedOptimizer`.
Tensor, sequence and fully-sharded parallel steps are not ported yet
(ROADMAP items 9 and 14).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.basics import _require_init
from ..models.transformer import Transformer, TransformerConfig, causal_lm_loss
from ..optim.distributed import DistributedOptimizer
from ..optim.functions import broadcast_parameters


def make_lm_train_step(cfg: TransformerConfig,
                       optimizer: Callable[..., torch.optim.Optimizer], *,
                       attention_fn=None, device=None, mesh=None,
                       sequence_parallel: Optional[str] = None):
    """Build ``(model, step)`` for data-parallel causal-LM training.

    ``optimizer`` makes the inner torch optimizer from the parameters
    (e.g. ``functools.partial(torch.optim.AdamW, lr=1e-4,
    weight_decay=1e-4)``); the step wraps it in ``DistributedOptimizer``
    after broadcasting rank 0's weights. The model is built on
    ``device`` (default: the device ``init()`` chose) with random
    weights from seed 0. ``step(tokens) -> loss``
    runs the forward, ``causal_lm_loss``, the backward and the
    optimizer step on a ``[B, T]`` batch, and returns the local loss;
    ``step.optimizer`` is the DistributedOptimizer.

    ``mesh`` (tensor / fully-sharded parallelism) and
    ``sequence_parallel`` raise: ROADMAP items 9 and 14."""
    if mesh is not None:
        raise NotImplementedError(
            "tensor-parallel and fully-sharded (FSDP/ZeRO) steps are not "
            "ported yet (ROADMAP item 9); the port trains data-parallel "
            "only")
    if sequence_parallel is not None:
        raise NotImplementedError(
            "sequence-parallel (ring/Ulysses) steps are not ported yet "
            "(ROADMAP item 14)")
    st = _require_init()
    device = st.device if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_lm_train_step: no CUDA device; pass "
                           "device='cpu' to train on the CPU")
    with torch.device(device):
        model = Transformer(cfg, attention_fn=attention_fn)
    model.init_params(torch.Generator(device=device).manual_seed(0))
    broadcast_parameters(model.state_dict(), root_rank=0)
    opt = DistributedOptimizer(optimizer(model.parameters()),
                               named_parameters=model.named_parameters())

    def step(tokens: torch.Tensor) -> torch.Tensor:
        logits = model(tokens)
        loss, _ = causal_lm_loss(logits, tokens)
        del logits
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    step.optimizer = opt
    return model, step
