"""ResNet v1.5 family (ResNet-50/101/152), the synthetic-benchmark CNN.

The port of the JAX package's ``models/resnet.py``: the same modules,
options and parameter tree, in the JAX layout. Activations are NHWC
(channels last and contiguous), bfloat16 by default, with float32
BatchNorm statistics and parameters; v1.5 puts the stride on the 3x3
convolution. ``ResNet.forward`` takes NHWC images, as the flax model
does. A convolution runs on the NCHW view of its NHWC input, which is
an NCHW tensor in ``torch.channels_last`` memory format: cuDNN's bf16
kernels prefer it, and the BatchNorm kernels read its ``[N*H*W, C]``
rows without a copy.

Parameters and buffers are named after the flax tree (``conv_init``,
``bn_init``, ``BottleneckBlock_i.Conv_j``, ``...BatchNorm_j`` or
``...FusedBatchNorm_j``, ``conv_proj``, ``norm_proj``, ``Dense_0``), so
``models/convert.resnet_from_flax`` loads a flax tree by name.
Convolution kernels are OIHW here and HWIO in flax; the converter
transposes them. Dense kernels are ``[in, out]`` in both.

Traps the port keeps to flax's behaviour:

* "SAME" padding puts ``total // 2`` before the data and the rest after
  it, so the 7x7/s2 stem on 224 px pads (2, 3) and every 3x3/s2
  convolution and the 3x3/s2 max pool on an even size pad (0, 1); the
  asymmetric cases pad explicitly (``F.pad``, with -inf for the pool);
* BatchNorm's running variance is the biased one, updated as ``ra =
  0.9 ra + 0.1 batch`` (``nn.BatchNorm2d`` keeps the unbiased one, so
  its buffers are not used);
* the last BatchNorm scale of every block starts at 0.

``fused_bn=True`` runs every BatchNorm through the fused kernels
(``ops/batchnorm.py``, B7-B10) with the ReLU and the residual add folded
in; ``fused_bn=False`` runs :class:`BatchNorm`, what
``flax.linen.BatchNorm`` computes, in plain PyTorch.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batchnorm import FusedBatchNorm


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class Conv(nn.Module):
    """flax's ``nn.Conv`` on NHWC inputs, ``padding`` "SAME" or "VALID",
    without a bias (the ResNet's and Inception's) or with one
    (``use_bias``: VGG's and MNIST's); ``kernel`` is a float32 OIHW
    parameter, cast to ``dtype`` (in channels-last memory) on every
    call, and the bias is added in the convolution."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int], strides=(1, 1),
                 dtype: torch.dtype = torch.bfloat16,
                 padding: str = "SAME", use_bias: bool = False):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}: expected "
                             "'SAME' or 'VALID'")
        self.kernel_size, self.strides, self.dtype = (
            tuple(kernel_size), tuple(strides), dtype)
        self.padding = padding
        self.kernel = nn.Parameter(torch.empty(features, in_features,
                                               *self.kernel_size))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    @property
    def fan_in(self) -> int:
        return math.prod(self.kernel.shape[1:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(self.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        x = x.to(self.dtype)
        if self.padding == "VALID":
            (ht, hb), (wl, wr) = (0, 0), (0, 0)
        else:
            (ht, hb), (wl, wr) = (
                _same_pads(x.shape[1 + i], self.kernel_size[i],
                           self.strides[i]) for i in range(2))
        if ht == hb and wl == wr:
            y = F.conv2d(_nchw(x), w, b, stride=self.strides,
                         padding=(ht, wl))
        else:
            x = F.pad(x, (0, 0, wl, wr, ht, hb))
            y = F.conv2d(_nchw(x), w, b, stride=self.strides)
        return _nhwc(y)


class ChannelDot(nn.Module):
    """A 1x1 convolution as a matmul over the channel axis (the JAX
    package's ``ChannelDot``, selected by ``one_by_one="dot"``): the
    same function as a 1x1 :class:`Conv`, with its stride taken by
    slicing."""

    def __init__(self, in_features: int, features: int, strides=(1, 1),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.strides, self.dtype = tuple(strides), dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features, 1, 1))

    @property
    def fan_in(self) -> int:
        return self.kernel.shape[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.strides != (1, 1):
            x = x[:, ::self.strides[0], ::self.strides[1], :]
        w = self.kernel.reshape(self.kernel.shape[0], -1).to(self.dtype)
        return torch.matmul(x.to(self.dtype), w.t())


class Dense(nn.Module):
    """flax ``nn.Dense`` with float32 parameters: ``x @ kernel + bias``,
    kernel ``[in, out]``, input, kernel and bias cast to ``dtype``
    (float32 by default)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    @property
    def fan_in(self) -> int:
        return self.kernel.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.to(self.dtype) @ self.kernel.to(self.dtype)
                + self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """What ``flax.linen.BatchNorm`` computes, over the last axis:
    float32 statistics ``mean = E[x]``, ``var = max(E[x^2] - mean^2,
    0)``, ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in
    float32, cast to ``dtype`` (default: x's dtype promoted with
    float32). Running statistics (buffers ``mean``, ``var``) as in
    :class:`~horovod_tpu_torch.ops.batchnorm.FusedBatchNorm`."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 scale_init: str = "ones"):
        super().__init__()
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.scale_init = scale_init
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale)
        y = y + self.bias
        return y.to(self.dtype or torch.promote_types(x.dtype,
                                                      torch.float32))


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/b, W/b, C*b*b] (pixel-shuffle inverse)."""
    b, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(
            f"space_to_depth needs H and W divisible by {block}; got "
            f"{h}x{w} (pad or resize the input)")
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block,
                                               c * block * block)


def max_pool_same(x: torch.Tensor, k: int = 3, stride: int = 2):
    """flax ``nn.max_pool(x, (k, k), (s, s), "SAME")`` on NHWC: -inf
    padding, ``total // 2`` before."""
    (ht, hb), (wl, wr) = (_same_pads(x.shape[1 + i], k, stride)
                          for i in range(2))
    x = F.pad(x, (0, 0, wl, wr, ht, hb), value=float("-inf"))
    return _nhwc(F.max_pool2d(_nchw(x), k, stride))


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride here, v1.5) -> 1x1 (x4 features), BatchNorm
    after each, a projection of the input where the shape changes, and
    ``relu(residual + y)``. With ``fused_bn`` the norms are
    ``FusedBatchNorm``s that fold the ReLUs and the residual add in."""

    def __init__(self, in_features: int, filters: int, strides, *,
                 norm: Callable[..., nn.Module], norm_name: str,
                 fused_bn: bool, one_by_one: str, dtype: torch.dtype):
        super().__init__()
        self.fused_bn = fused_bn
        #: role in the block -> the child's flax name
        self.names = {}
        counts = {}

        def add(role, prefix, module):
            name = role  # the projection's modules are named in flax
            if role not in ("conv_proj", "norm_proj"):
                name = f"{prefix}_{counts.get(prefix, 0)}"
                counts[prefix] = counts.get(prefix, 0) + 1
            self.add_module(name, module)
            self.names[role] = name

        def c1(role, fin, fout, st=(1, 1)):
            if one_by_one == "dot":
                add(role, "ChannelDot", ChannelDot(fin, fout, st, dtype))
            else:
                add(role, "Conv", Conv(fin, fout, (1, 1), st, dtype))

        act = {"activation": "relu"} if fused_bn else {}
        out = filters * 4
        c1("c0", in_features, filters)
        add("n0", norm_name, norm(filters, **act))
        add("c1", "Conv", Conv(filters, filters, (3, 3), strides, dtype))
        add("n1", norm_name, norm(filters, **act))
        c1("c2", filters, out)
        add("n2", norm_name, norm(out, scale_init="zeros", **act))
        self.proj = in_features != out or tuple(strides) != (1, 1)
        if self.proj:
            c1("conv_proj", in_features, out, strides)
            add("norm_proj", norm_name, norm(out))

    def _run(self, role: str, x: torch.Tensor, **kw) -> torch.Tensor:
        return self._modules[self.names[role]](x, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._run("n0", self._run("c0", x))
        if not self.fused_bn:
            y = torch.relu(y)
        y = self._run("n1", self._run("c1", y))
        if not self.fused_bn:
            y = torch.relu(y)
        y = self._run("c2", y)
        residual = x
        if self.proj:
            residual = self._run("norm_proj", self._run("conv_proj", x))
        if self.fused_bn:
            return self._run("n2", y, residual=residual)
        return torch.relu(residual + self._run("n2", y))


class ResNet(nn.Module):
    """ResNet v1.5 on NHWC images, returning float32 logits.

    Options as in the JAX package: ``stem`` "conv" (7x7/s2) or
    "space_to_depth" (2x2 pixel unshuffle + 4x4/s1 on 12 channels),
    ``fused_bn`` (the fused BatchNorm kernels), ``one_by_one`` "conv" or
    "dot" (:class:`ChannelDot`), and ``norm_cls``, a norm factory called
    as ``norm_cls(features, **kw)`` in place of BatchNorm (it conflicts
    with ``fused_bn``). ``.train()`` (the default) normalizes with the
    batch statistics and updates the running ones; ``.eval()`` uses the
    running ones. Build the weights with :meth:`init_params`."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 norm_cls: Optional[Callable[..., nn.Module]] = None,
                 stem: str = "conv", fused_bn: bool = False,
                 one_by_one: str = "conv"):
        super().__init__()
        if fused_bn and norm_cls is not None:
            raise ValueError(
                "fused_bn=True conflicts with norm_cls: the fused "
                "epilogues replace the norm layer entirely")
        if stem not in ("conv", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}: expected 'conv' or "
                             "'space_to_depth'")
        if one_by_one not in ("conv", "dot"):
            raise ValueError(f"unknown one_by_one {one_by_one!r}: expected "
                             "'conv' or 'dot'")
        self.dtype, self.stem, self.fused_bn = dtype, stem, fused_bn
        if norm_cls is not None:
            norm = norm_cls
            norm_name = getattr(norm_cls, "__name__", "Norm")
        else:
            cls = FusedBatchNorm if fused_bn else BatchNorm
            norm = functools.partial(cls, momentum=0.9, epsilon=1e-5,
                                     dtype=dtype)
            norm_name = cls.__name__
        if stem == "space_to_depth":  # RGB images, 2x2 blocks
            self.conv_init = Conv(12, num_filters, (4, 4), (1, 1), dtype)
        else:
            self.conv_init = Conv(3, num_filters, (7, 7), (2, 2), dtype)
        self.bn_init = (norm(num_filters, activation="relu") if fused_bn
                        else norm(num_filters))
        features = num_filters
        self.blocks = []
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                block = BottleneckBlock(
                    features, num_filters * 2 ** i, strides, norm=norm,
                    norm_name=norm_name, fused_bn=fused_bn,
                    one_by_one=one_by_one, dtype=dtype)
                self.add_module(f"BottleneckBlock_{len(self.blocks)}",
                                block)
                self.blocks.append(block)
                features = num_filters * 2 ** i * 4
        self.Dense_0 = Dense(features, num_classes)

    def init_params(self, generator: torch.Generator) -> "ResNet":
        """Random weights distributed as flax initializes them
        (:func:`init_flax_params`); the last BatchNorm scale of each
        block starts at 0. ``generator`` must live on the parameters'
        device."""
        return init_flax_params(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            x = space_to_depth(x, 2)
        x = self.conv_init(x)
        x = self.bn_init(x)
        if not self.fused_bn:
            x = torch.relu(x)
        x = max_pool_same(x, 3, 2)
        for block in self.blocks:
            x = block(x)
        # a bf16 mean accumulates in float32 and returns bf16, as jnp's
        x = x.mean(dim=(1, 2))
        return self.Dense_0(x)


@torch.no_grad()
def init_flax_params(model: nn.Module, generator: torch.Generator):
    """Draw ``model``'s weights as flax initializes the same modules,
    module by module in ``model.modules()`` order: every Conv,
    ChannelDot and Dense kernel lecun-normal (a normal of variance
    1 / fan_in truncated at two standard deviations), zero biases, unit
    BatchNorm scales (zero where a norm's ``scale_init`` says so), and
    running statistics mean 0, var 1. Returns ``model``."""
    for module in model.modules():
        if isinstance(module, (Conv, ChannelDot, Dense)):
            _trunc_normal_(module.kernel, 1.0 / math.sqrt(module.fan_in),
                           generator)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
        elif hasattr(module, "scale_init"):
            module.scale.fill_(0.0 if module.scale_init == "zeros"
                               else 1.0)
            module.bias.zero_()
            module.mean.zero_()
            module.var.fill_(1.0)
    return model


def _trunc_normal_(p: torch.Tensor, std: float, generator) -> None:
    """flax's truncated normal: a unit normal cut at +-2, scaled so the
    cut distribution has standard deviation ``std`` (inverse CDF of a
    uniform draw)."""
    std = std / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    p.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    p.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3])
