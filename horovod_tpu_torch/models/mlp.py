"""MNIST MLP / ConvNet, the smoke-test model family.

The port of the JAX package's ``models/mlp.py``: the same modules,
parameter names and layouts (``dense_i`` in :class:`MLP`; ``Conv_0``,
``Conv_1``, ``Dense_0``, ``Dense_1`` in :class:`MnistNet`), so
``models/convert.resnet_from_flax`` loads a flax tree of either. Images
are NHWC, and the flatten before a Dense runs in NHWC order, as
flax's ``reshape`` does. flax infers a Dense's input width from its
first call; here it is a constructor argument.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv, Dense, _nchw, _nhwc, init_flax_params


def max_pool(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), strides=(stride, stride))`` (VALID)
    on NHWC."""
    return _nhwc(F.max_pool2d(_nchw(x), k, stride))


class MLP(nn.Module):
    """Plain MLP for quick numerics tests: ``in_features`` (the flattened
    input width), then ``features`` wide Dense layers with ReLU between
    them."""

    def __init__(self, in_features: int,
                 features: Sequence[int] = (128, 64, 10),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", Dense(in_features, f, dtype))
            in_features = f

    def init_params(self, generator: torch.Generator) -> "MLP":
        """flax's default initializers (``resnet.init_flax_params``)."""
        return init_flax_params(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


class MnistNet(nn.Module):
    """The reference MNIST model shape (conv 10 / 20 + fc 50 / 10) on
    ``[B, 28, 28, 1]`` NHWC images."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(1, 10, (5, 5), dtype=dtype, padding="VALID",
                           use_bias=True)
        self.Conv_1 = Conv(10, 20, (5, 5), dtype=dtype, padding="VALID",
                           use_bias=True)
        self.Dense_0 = Dense(4 * 4 * 20, 50, dtype)
        self.Dense_1 = Dense(50, 10, dtype)

    def init_params(self, generator: torch.Generator) -> "MnistNet":
        """flax's default initializers (``resnet.init_flax_params``)."""
        return init_flax_params(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = torch.relu(max_pool(self.Conv_0(x), 2, 2))
        x = torch.relu(max_pool(self.Conv_1(x), 2, 2))
        x = x.reshape(x.shape[0], -1)
        return self.Dense_1(torch.relu(self.Dense_0(x)))
