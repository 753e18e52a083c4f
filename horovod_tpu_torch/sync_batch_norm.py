"""SyncBatchNorm: batch normalization with statistics over the ranks.

The port of the JAX package's ``sync_batch_norm.py`` (itself after the
reference Horovod's ``torch/sync_batch_norm.py``): each rank takes the
float32 mean of x and of x^2 over its own batch, and the ranks of
``process_set`` (default: the world) average them with one
``all_reduce`` of the stacked ``[2, C]`` tensor on the set's group (the
JAX module's ``lax.pmean`` over the set's replica groups; equal batches
on every rank make that the set's batch's statistics). The backward
averages the gradients of the two statistics over the same ranks: the
transpose of a mean over the ranks is a mean over the ranks, as in
``lax.pmean``'s transpose and the reference's backward. In a world of
one, before ``init()``, and on a rank outside the set (a singleton
group in the JAX module) it is plain local BatchNorm.

What the JAX module computes, kept as it is: momentum 0.99, variance
``E[x^2] - mean^2`` with no clamp, and the normalization in x's dtype
(``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` with each of
mean, rsqrt, scale and bias cast to x's dtype first), which is not
``FusedBatchNorm``'s rounding.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from .core.process_sets import set_context
from .core.state import global_state


class _SetMean(torch.autograd.Function):
    """The mean over a group's ranks of a tensor, with the mean over the
    ranks of its gradient as the backward."""

    @staticmethod
    def forward(ctx, t, size, group):
        ctx.size, ctx.group = size, group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out / size

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out / ctx.size, None, None


class SyncBatchNorm(nn.Module):
    """BatchNorm whose training statistics are averaged over the ranks.

    ``features`` channels on the last axis (the JAX layout);
    ``scale``/``bias`` parameters and ``mean``/``var`` running buffers
    (float32) named as flax names them. ``.eval()`` normalizes with the
    running statistics. ``process_set`` (a registered set; default the
    world) is the ranks whose statistics are averaged."""

    def __init__(self, features: int, *, momentum: float = 0.99,
                 epsilon: float = 1e-5, process_set=None):
        super().__init__()
        self.process_set = process_set
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.to(torch.float32)
            axes = tuple(range(x.dim() - 1))
            stats = torch.stack([xf.mean(axes), (xf * xf).mean(axes)])
            if global_state().initialized:
                ctx = set_context(self.process_set)
                if ctx.member and ctx.size > 1:
                    stats = _SetMean.apply(stats, ctx.size, ctx.group)
            mean, mean2 = stats[0], stats[1]
            var = mean2 - mean * mean
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = x - mean.to(x.dtype)
        mul = torch.rsqrt(var + self.epsilon).to(x.dtype) * self.scale.to(
            x.dtype)
        return y * mul + self.bias.to(x.dtype)
