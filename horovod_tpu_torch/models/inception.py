"""Inception V3, the reference's headline scaling-efficiency model.

The port of the JAX package's ``models/inception.py``: NHWC at the
module boundary, bfloat16 compute with float32 BatchNorm statistics and
parameters; the 299 px stem, 3 x A (35 x 35), the B reduction, 4 x C
(17 x 17), the D reduction, 2 x E (8 x 8), a global average pool and a
float32 fc; no aux head, as in the JAX model. It reuses ``resnet.py``'s
``Conv`` ("SAME"/"VALID" pads), ``BatchNorm`` (the plain norm, as the
JAX model runs flax's ``nn.BatchNorm``, not the Pallas one) and
``Dense``. What it keeps of flax:

* ``ConvBN``'s norm has momentum 0.9 and epsilon 1e-3 (not the
  ResNet's 1e-5);
* the "SAME" 3x3 stride-1 average pools count the padding (flax's
  ``avg_pool`` default, ``count_include_pad=True``); the max pools are
  "VALID";
* the branches concatenate on the channel axis in the JAX order;
* modules are named as flax auto-names them (``ConvBN_0``, ...,
  ``InceptionA_0``, ..., ``Conv_0``, ``BatchNorm_0``, ``Dense_0``), in
  call order, so ``models/convert.resnet_from_flax`` maps a flax tree
  (``params`` and ``batch_stats``) by name.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .mlp import max_pool
from .resnet import BatchNorm, Conv, Dense, _nchw, _nhwc, init_flax_params


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")`` on
    NHWC: the zero padding counts in every window's mean."""
    return _nhwc(F.avg_pool2d(_nchw(x), 3, 1, padding=1,
                              count_include_pad=True))


class ConvBN(nn.Module):
    """conv -> BatchNorm -> relu, the Inception building block."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides=(1, 1),
                 padding: str = "SAME", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, strides, dtype,
                           padding=padding)
        self.BatchNorm_0 = BatchNorm(features, momentum=0.9, epsilon=1e-3,
                                     dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class _Block(nn.Module):
    """An Inception block: its ``ConvBN_i`` children in flax's call
    order; ``out_features`` is the width of its concatenated output."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.cbn = functools.partial(ConvBN, dtype=dtype)
        self.n = 0

    def add(self, in_features: int, features: int, kernel, strides=(1, 1),
            padding: str = "SAME") -> int:
        self.add_module(f"ConvBN_{self.n}", self.cbn(
            in_features, features, kernel, strides, padding))
        self.n += 1
        return features

    def c(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"ConvBN_{i}")(x)


class InceptionA(_Block):
    def __init__(self, in_features: int, pool_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        c = in_features
        self.add(c, 64, (1, 1))                                   # b1
        self.add(self.add(c, 48, (1, 1)), 64, (5, 5))            # b5
        self.add(self.add(self.add(c, 64, (1, 1)), 96, (3, 3)),
                 96, (3, 3))                                     # b3
        self.add(c, pool_features, (1, 1))                       # bp
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b1 = self.c(0, x)
        b5 = self.c(2, self.c(1, x))
        b3 = self.c(5, self.c(4, self.c(3, x)))
        bp = self.c(6, avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], dim=-1)


class InceptionB(_Block):
    """35x35 -> 17x17 grid reduction."""

    def __init__(self, in_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        c = in_features
        self.add(c, 384, (3, 3), (2, 2), "VALID")                # b3
        self.add(self.add(self.add(c, 64, (1, 1)), 96, (3, 3)),
                 96, (3, 3), (2, 2), "VALID")                    # bd
        self.out_features = 384 + 96 + c

    def forward(self, x):
        b3 = self.c(0, x)
        bd = self.c(3, self.c(2, self.c(1, x)))
        bp = max_pool(x, 3, 2)
        return torch.cat([b3, bd, bp], dim=-1)


class InceptionC(_Block):
    """17x17 blocks with factorized 7x7 (1x7 then 7x1) branches."""

    def __init__(self, in_features: int, channels_7x7: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        c, c7 = in_features, channels_7x7
        self.add(c, 192, (1, 1))                                  # b1
        self.add(self.add(self.add(c, c7, (1, 1)), c7, (1, 7)),
                 192, (7, 1))                                    # b7
        d = self.add(self.add(self.add(c, c7, (1, 1)), c7, (7, 1)),
                     c7, (1, 7))
        self.add(self.add(d, c7, (7, 1)), 192, (1, 7))           # bd
        self.add(c, 192, (1, 1))                                 # bp
        self.out_features = 4 * 192

    def forward(self, x):
        b1 = self.c(0, x)
        b7 = self.c(3, self.c(2, self.c(1, x)))
        bd = x
        for i in range(4, 9):
            bd = self.c(i, bd)
        bp = self.c(9, avg_pool_same(x))
        return torch.cat([b1, b7, bd, bp], dim=-1)


class InceptionD(_Block):
    """17x17 -> 8x8 grid reduction."""

    def __init__(self, in_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        c = in_features
        self.add(self.add(c, 192, (1, 1)), 320, (3, 3), (2, 2),
                 "VALID")                                        # b3
        b7 = self.add(self.add(self.add(c, 192, (1, 1)), 192, (1, 7)),
                      192, (7, 1))
        self.add(b7, 192, (3, 3), (2, 2), "VALID")               # b7
        self.out_features = 320 + 192 + c

    def forward(self, x):
        b3 = self.c(1, self.c(0, x))
        b7 = x
        for i in range(2, 6):
            b7 = self.c(i, b7)
        bp = max_pool(x, 3, 2)
        return torch.cat([b3, b7, bp], dim=-1)


class InceptionE(_Block):
    """8x8 blocks with split 1x3 / 3x1 branches."""

    def __init__(self, in_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        c = in_features
        self.add(c, 320, (1, 1))                                  # b1
        b3 = self.add(c, 384, (1, 1))
        self.add(b3, 384, (1, 3))
        self.add(b3, 384, (3, 1))                                 # b3
        bd = self.add(self.add(c, 448, (1, 1)), 384, (3, 3))
        self.add(bd, 384, (1, 3))
        self.add(bd, 384, (3, 1))                                 # bd
        self.add(c, 192, (1, 1))                                  # bp
        self.out_features = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        b1 = self.c(0, x)
        b3 = self.c(1, x)
        b3 = torch.cat([self.c(2, b3), self.c(3, b3)], dim=-1)
        bd = self.c(5, self.c(4, x))
        bd = torch.cat([self.c(6, bd), self.c(7, bd)], dim=-1)
        bp = self.c(8, avg_pool_same(x))
        return torch.cat([b1, b3, bd, bp], dim=-1)


class InceptionV3(nn.Module):
    """Inception V3 on NHWC images (299 px native), returning float32
    logits. ``.train()`` (the default) normalizes with the batch
    statistics and updates the running ones; ``.eval()`` uses the
    running ones. Build the weights with :meth:`init_params`."""

    STEM = (  # (features, kernel, strides, padding); "M": 3x3/s2 max pool
        (32, (3, 3), (2, 2), "VALID"), (32, (3, 3), (1, 1), "VALID"),
        (64, (3, 3), (1, 1), "SAME"), "M",
        (80, (1, 1), (1, 1), "VALID"), (192, (3, 3), (1, 1), "VALID"), "M")

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem = []
        c, n = 3, 0
        for spec in self.STEM:
            if spec == "M":
                self.stem.append("M")
                continue
            features, kernel, strides, padding = spec
            self.add_module(f"ConvBN_{n}", ConvBN(c, features, kernel,
                                                  strides, padding, dtype))
            self.stem.append(f"ConvBN_{n}")
            c, n = features, n + 1
        self.blocks = []

        def block(name, module):
            self.add_module(name, module)
            self.blocks.append(module)
            return module.out_features

        for i, pool_features in enumerate((32, 64, 64)):
            c = block(f"InceptionA_{i}", InceptionA(c, pool_features, dtype))
        c = block("InceptionB_0", InceptionB(c, dtype))
        for i, c7 in enumerate((128, 160, 160, 192)):
            c = block(f"InceptionC_{i}", InceptionC(c, c7, dtype))
        c = block("InceptionD_0", InceptionD(c, dtype))
        for i in range(2):
            c = block(f"InceptionE_{i}", InceptionE(c, dtype))
        self.Dense_0 = Dense(c, num_classes)

    def init_params(self, generator: torch.Generator) -> "InceptionV3":
        """flax's default initializers (``resnet.init_flax_params``):
        lecun-normal kernels, zero biases, unit norm scales."""
        return init_flax_params(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for name in self.stem:
            x = max_pool(x, 3, 2) if name == "M" else getattr(self, name)(x)
        for block in self.blocks:
            x = block(x)
        # a bf16 mean accumulates in float32 and returns bf16, as jnp's
        x = x.mean(dim=(1, 2))
        return self.Dense_0(x)
