"""Fused LayerNorm / RMSNorm forward: the hand-written CUDA kernel and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas_layernorm.py``. The
forward is one pass: read x, write ``(x - mean) * rstd * gamma (+
beta)`` with float32 statistics and ``var = E[x^2] - mean^2`` clamped
at 0 (the TPU kernel's formula, not Welford). RMSNorm is the ``mean =
0``, no-beta case.

Dispatch is by the device of ``x``: a CUDA tensor launches the kernel
``csrc/layernorm_fwd.cu`` (or raises), a CPU tensor runs
:func:`layer_norm_ref`. Only the forward exists so far: the backward
kernel comes with the training path, and its absence raises rather
than differentiating the plain version behind the kernel's back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import nn

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_ref(x2: torch.Tensor, gamma: torch.Tensor,
                   beta: Optional[torch.Tensor], eps: float,
                   rms: bool) -> torch.Tensor:
    """Plain version of the kernel on ``[N, C]`` rows (any device):
    float32 statistics, output in ``x2``'s dtype."""
    c = x2.shape[-1]
    xf = x2.to(torch.float32)
    if rms:
        mean = torch.zeros((), dtype=torch.float32, device=x2.device)
        var = torch.sum(xf * xf, dim=-1, keepdim=True) / c
    else:
        mean = torch.sum(xf, dim=-1, keepdim=True) / c
        var = torch.sum(xf * xf, dim=-1, keepdim=True) / c - mean * mean
        var = torch.clamp(var, min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * gamma.to(torch.float32)
    if beta is not None:
        y = y + beta.to(torch.float32)
    return y.to(x2.dtype)


def _lib():
    lib = _build.library("layernorm_fwd")
    fn = lib.hvd_layernorm_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def layer_norm_cuda(x2: torch.Tensor, gamma: torch.Tensor,
                    beta: Optional[torch.Tensor], eps: float,
                    rms: bool) -> torch.Tensor:
    """Launch ``csrc/layernorm_fwd.cu`` on ``[N, C]`` CUDA rows; gamma
    and beta are float32 ``[C]`` on the same device."""
    if not x2.is_cuda:
        raise ValueError("layer_norm_cuda takes CUDA tensors")
    if x2.dim() != 2 or x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"layer_norm_cuda takes [N, C] float32/bfloat16 "
                         f"rows, got {tuple(x2.shape)} {x2.dtype}")
    n, c = x2.shape
    for name, v in (("gamma", gamma), ("beta", beta)):
        if v is None:
            continue
        if (v.dtype != torch.float32 or v.shape != (c,)
                or v.device != x2.device or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [{c}] "
                             f"tensor on {x2.device}")
    x2 = x2.contiguous()
    y = torch.empty_like(x2)
    if n == 0:
        return y
    lib = _lib()
    err = lib.hvd_layernorm_fwd(
        x2.data_ptr(), gamma.data_ptr(),
        beta.data_ptr() if beta is not None else None, y.data_ptr(),
        n, c, float(eps), int(rms), _DTYPE_CODES[x2.dtype],
        x2.device.index, _build.stream_handle(x2.device))
    _build.check(lib, err, "layernorm_fwd")
    _build.LAUNCHES["layernorm_fwd"] += 1
    return y


class _FusedLayerNormFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, rms):
        if x2.is_cuda:
            return layer_norm_cuda(x2, gamma, beta, eps, rms)
        if x2.device.type != "cpu":
            raise ValueError(f"no LayerNorm kernel for device {x2.device}")
        return layer_norm_ref(x2, gamma, beta, eps, rms)

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError(
            "LayerNorm backward kernel (B5) lands with the training slice")


def fused_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                     beta: Optional[torch.Tensor] = None, *,
                     eps: float = 1e-5,
                     kind: str = "layernorm") -> torch.Tensor:
    """LayerNorm (or RMSNorm) over the trailing axis through the fused
    kernel. ``beta=None`` omits the shift (RMSNorm never has one).
    Output dtype follows ``x``; statistics are float32."""
    if kind not in ("layernorm", "rmsnorm"):
        raise ValueError(f"unknown kind {kind!r}")
    rms = kind == "rmsnorm"
    if rms and beta is not None:
        raise ValueError("rmsnorm has no beta/shift parameter")
    shape = x.shape
    c = shape[-1]
    g = gamma.reshape(c).to(torch.float32).contiguous()
    b = None if beta is None else beta.reshape(c).to(
        torch.float32).contiguous()
    y2 = _FusedLayerNormFn.apply(x.reshape(-1, c), g, b, float(eps), rms)
    return y2.reshape(shape)


class FusedLayerNorm(nn.Module):
    """LayerNorm / RMSNorm module backed by the fused kernel; params
    ``scale`` and ``bias`` (float32) as in flax, so converted
    checkpoints load unchanged."""

    def __init__(self, features: int, *, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16,
                 kind: str = "layernorm", use_bias: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(features))
        if kind == "layernorm" and use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = fused_layer_norm(x, self.scale, self.bias, eps=self.epsilon,
                             kind=self.kind)
        return y.to(self.dtype)
