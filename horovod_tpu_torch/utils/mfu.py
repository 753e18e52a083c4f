"""Model-FLOPs-utilization accounting.

MFU = achieved model FLOP/s over the card's peak dense bf16 FLOP/s, the
JAX package's ``utils/mfu.py`` convention (training FLOPs 6 N D), with
the peak of the card this process runs on.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

# dense bf16 tensor-core peak, FLOP/s (NVIDIA H100 SXM data sheet)
_PEAK_FLOPS = {
    "H100": 989e12,
}


def peak_flops_per_chip(device_name: Optional[str] = None
                        ) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the card named ``device_name`` (default:
    ``torch.cuda.get_device_name()`` of the current card), or None for a
    card (or a CPU) the table does not know: an MFU against a guessed
    peak would be a number of nothing."""
    if device_name is None:
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name()
    for key, peak in _PEAK_FLOPS.items():
        if key in device_name:
            return peak
    return None


def transformer_train_flops(n_params: int, tokens: float) -> float:
    """Training FLOPs of a dense transformer: 6 N D (forward 2 N D,
    backward 4 N D)."""
    return 6.0 * float(n_params) * float(tokens)


def count_params(params: Iterable[torch.Tensor]) -> int:
    """Number of values in ``params`` (e.g. ``model.parameters()``)."""
    return sum(p.numel() for p in params)
