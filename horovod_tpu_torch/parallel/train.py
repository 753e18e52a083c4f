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
from ..models.transformer import Transformer, TransformerConfig, causal_lm_nll
from ..ops.collectives import Sum, allreduce
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
    runs the forward, the causal-LM loss, the backward and the
    optimizer step on this rank's ``[B, T]`` rows of the global batch.
    As in the JAX package's step, the loss is the global batch's mean,
    ``Σ nll / Σ valid`` over every rank's targets (``ignore_index`` -1
    excluded), and the gradients are its gradients, however unevenly
    the ranks' targets are padded; the step returns that loss.
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
        nll, count = causal_lm_nll(logits, tokens)
        del logits
        # one denominator for every rank, before the backward: the
        # DistributedOptimizer averages Σ nll_r · size / n, which is the
        # gradient of the global mean Σ_r Σ nll_r / n
        sums = allreduce(torch.stack([nll.detach().double(),
                                      count.double()]), op=Sum)
        n = sums[1].clamp(min=1)
        (nll * (st.size / n).float()).backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return sums[0].float() / n.float()

    step.optimizer = opt
    return model, step
