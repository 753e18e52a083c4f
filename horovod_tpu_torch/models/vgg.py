"""VGG-16, the reference's bandwidth-bound scaling model.

The port of the JAX package's ``models/vgg.py``: NHWC at the module
boundary, bfloat16 compute with float32 parameters, the 13 3x3 "SAME"
convolutions with biases (``Conv_0`` ... ``Conv_12``), 2x2 max pools,
and the 4096-wide classifier (``Dense_0``, ``Dense_1`` in ``dtype``,
``Dense_2`` in float32), whose 124M parameters make it the gradient
all-reduce stress test. The flatten before ``Dense_0`` runs in NHWC
order (7 x 7 x 512 = 25088 at 224 px), as flax's ``reshape`` does, so a
kernel converted from flax (``models/convert.resnet_from_flax``)
multiplies the features it was trained on.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .mlp import max_pool
from .resnet import Conv, Dense, init_flax_params

#: channels per conv, "M" = 2x2 max pool (the 13-conv "D" configuration)
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


class VGG16(nn.Module):
    """VGG-16 on NHWC images of ``image_size`` px (a multiple of 32),
    returning float32 logits. With a nonzero ``dropout``, training calls
    must pass the ``generator`` that draws the masks (flax raises without
    its ``dropout`` rng); the synthetic benchmark trains with
    ``dropout=0``."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, dropout: float = 0.0,
                 image_size: int = 224):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.layers = []
        c, convs = 3, 0
        for spec in VGG16_CFG:
            if spec == "M":
                self.layers.append("M")
                continue
            name = f"Conv_{convs}"
            self.add_module(name, Conv(c, spec, (3, 3), dtype=dtype,
                                       use_bias=True))
            self.layers.append(name)
            c, convs = spec, convs + 1
        side = image_size // 32
        self.Dense_0 = Dense(side * side * c, 4096, dtype)
        self.Dense_1 = Dense(4096, 4096, dtype)
        self.Dense_2 = Dense(4096, num_classes)

    def init_params(self, generator: torch.Generator) -> "VGG16":
        """flax's default initializers (``resnet.init_flax_params``)."""
        return init_flax_params(self, generator)

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        """flax ``nn.Dropout``: keep with probability ``1 - rate`` and
        scale the kept values by ``1 / (1 - rate)``."""
        if generator is None:
            raise ValueError("VGG16 with dropout > 0 trains only with an "
                             "explicit generator for its masks")
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) >= self.dropout
        return torch.where(keep, x / (1.0 - self.dropout),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x.to(self.dtype)
        for name in self.layers:
            x = max_pool(x, 2, 2) if name == "M" else torch.relu(
                getattr(self, name)(x))
        x = x.reshape(x.shape[0], -1)  # NHWC order, as flax's
        for dense in (self.Dense_0, self.Dense_1):
            x = torch.relu(dense(x))
            if self.dropout and self.training:
                x = self._dropout(x, generator)
        return self.Dense_2(x)
