"""Model-FLOPs-utilization accounting.

MFU = achieved model FLOP/s over the card's peak dense bf16 FLOP/s, the
JAX package's ``utils/mfu.py`` convention (training FLOPs 6 N D for a
transformer; for the synthetic-benchmark CNNs, each model's published
forward multiply-accumulates x 2 FLOPs x 3 for forward and backward),
with the peak of the card this process runs on.
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


# per-image forward multiply-accumulates at each model's native
# resolution (published GMAC counts: torchvision/ptflops tables), as the
# JAX package's table has them
_CNN_FWD_MACS = {
    "resnet50": (4.1e9, 224),
    "resnet101": (7.8e9, 224),
    "resnet152": (11.5e9, 224),
    "inception3": (5.7e9, 299),
    "vgg16": (15.5e9, 224),
}


def cnn_train_flops(model: str, images: float, image_size: int) -> float:
    """Training FLOPs of ``images`` images of ``image_size`` px through
    ``model`` (forward MACs x 2 FLOPs/MAC x 3 for forward + backward),
    scaled from the model's native resolution."""
    macs, native = _CNN_FWD_MACS[model]
    return 3.0 * 2.0 * macs * (image_size / native) ** 2 * float(images)


def count_params(params: Iterable[torch.Tensor]) -> int:
    """Number of values in ``params`` (e.g. ``model.parameters()``)."""
    return sum(p.numel() for p in params)
