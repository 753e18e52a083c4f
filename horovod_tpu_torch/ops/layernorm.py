"""Fused LayerNorm / RMSNorm, forward and backward: the hand-written
CUDA kernels and their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas_layernorm.py``. The
forward is one pass: read x, write ``(x - mean) * rstd * gamma (+
beta)`` with float32 statistics and ``var = E[x^2] - mean^2`` clamped
at 0 (the TPU kernel's formula, not Welford). RMSNorm is the ``mean =
0``, no-beta case.

The backward saves no statistics: it reads x and dy, recomputes mean
and rstd per row and writes ``dx = rstd * (gamma*dy - mean(gamma*dy) -
xhat * mean(gamma*dy*xhat))`` (no mean term for RMSNorm), with the
column sums dgamma and dbeta in float32.

Dispatch is by the device of ``x``: a CUDA tensor launches the kernels
``csrc/layernorm_fwd.cu`` and ``csrc/layernorm_bwd.cu`` (or raises), a
CPU tensor runs :func:`layer_norm_ref` and :func:`layer_norm_bwd_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import nn

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# The backward kernel's partition (csrc/layernorm_bwd.cu; held to its
# ``constexpr``s by tests/test_torch_kernels.py): a warp per row, warp w
# of block k taking rows k * BWD_WARPS + w, + blocks * BWD_WARPS, ...
#: warps of a block (csrc/layernorm_bwd.cu kWarps)
BWD_WARPS = 8
#: blocks per SM (csrc/layernorm_bwd.cu kBlocksPerSm): the grid is this
#: multiple of the SM count, or fewer blocks where the rows run out
BWD_BLOCKS_PER_SM = 1
#: a lane keeps at most 128 columns (kMaxCols) in registers
_BWD_MAX_C = 4096

_SM_COUNT = {}
_TICKETS = {}


def bwd_blocks(n: int, sm_count: int) -> int:
    """Blocks of the backward kernel for ``n`` rows on a card of
    ``sm_count`` SMs; block k writes row k of the ``[blocks, C]``
    column-sum scratch."""
    return max(1, min(BWD_BLOCKS_PER_SM * sm_count, -(-n // BWD_WARPS)))


def bwd_block_of_rows(n: int, blocks: int) -> torch.Tensor:
    """The block of the backward kernel that sums each of ``n`` rows
    into dgamma and dbeta (int64 ``[n]``)."""
    r = torch.arange(n)
    return (r % (blocks * BWD_WARPS)) // BWD_WARPS


def _sm_count(device: torch.device) -> int:
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def _ticket(device: torch.device) -> torch.Tensor:
    """The zeroed counter of the backward's last block, one per device
    and stream (the kernel leaves it zeroed; launches on one stream run
    in order)."""
    key = (device.index, _build.stream_handle(device))
    t = _TICKETS.get(key)
    if t is None:
        t = torch.zeros(1, dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _stats(xf: torch.Tensor, c: int, eps: float, rms: bool):
    """float32 ``(mean, rstd)`` per row, ``var = E[x^2] - mean^2``
    clamped at 0 (the TPU kernel's formula, not Welford)."""
    if rms:
        mean = torch.zeros((), dtype=torch.float32, device=xf.device)
        var = torch.sum(xf * xf, dim=-1, keepdim=True) / c
    else:
        mean = torch.sum(xf, dim=-1, keepdim=True) / c
        var = torch.sum(xf * xf, dim=-1, keepdim=True) / c - mean * mean
        var = torch.clamp(var, min=0.0)
    return mean, torch.rsqrt(var + eps)


def layer_norm_ref(x2: torch.Tensor, gamma: torch.Tensor,
                   beta: Optional[torch.Tensor], eps: float,
                   rms: bool) -> torch.Tensor:
    """Plain version of the kernel on ``[N, C]`` rows (any device):
    float32 statistics, output in ``x2``'s dtype."""
    xf = x2.to(torch.float32)
    mean, rstd = _stats(xf, x2.shape[-1], eps, rms)
    y = (xf - mean) * rstd * gamma.to(torch.float32)
    if beta is not None:
        y = y + beta.to(torch.float32)
    return y.to(x2.dtype)


def layer_norm_bwd_ref(x2: torch.Tensor, dy2: torch.Tensor,
                       gamma: torch.Tensor, eps: float, rms: bool,
                       with_beta: bool):
    """Plain version of the backward kernel on ``[N, C]`` rows (any
    device): ``(dx in x2's dtype, dgamma float32 [C], dbeta float32
    [C] or None)``, statistics recomputed from x."""
    c = x2.shape[-1]
    xf = x2.to(torch.float32)
    dyf = dy2.to(torch.float32)
    mean, rstd = _stats(xf, c, eps, rms)
    xhat = (xf - mean) * rstd
    gdy = dyf * gamma.to(torch.float32)
    s2 = torch.sum(gdy * xhat, dim=-1, keepdim=True) / c
    if rms:
        dx = rstd * (gdy - xhat * s2)
    else:
        s1 = torch.sum(gdy, dim=-1, keepdim=True) / c
        dx = rstd * (gdy - s1 - xhat * s2)
    dg = torch.sum(dyf * xhat, dim=0)
    db = torch.sum(dyf, dim=0) if with_beta else None
    return dx.to(x2.dtype), dg, db


def _lib(name: str, argtypes):
    lib = _build.library(name)
    fn = getattr(lib, f"hvd_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I,
             _P]


def _check_params(x2, gamma, beta, what):
    if not x2.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors")
    if x2.dim() != 2 or x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} takes [N, C] float32/bfloat16 rows, got "
                         f"{tuple(x2.shape)} {x2.dtype}")
    c = x2.shape[1]
    for name, v in (("gamma", gamma), ("beta", beta)):
        if v is None:
            continue
        if (v.dtype != torch.float32 or v.shape != (c,)
                or v.device != x2.device or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [{c}] "
                             f"tensor on {x2.device}")


def layer_norm_cuda(x2: torch.Tensor, gamma: torch.Tensor,
                    beta: Optional[torch.Tensor], eps: float,
                    rms: bool) -> torch.Tensor:
    """Launch ``csrc/layernorm_fwd.cu`` on ``[N, C]`` CUDA rows; gamma
    and beta are float32 ``[C]`` on the same device."""
    _check_params(x2, gamma, beta, "layer_norm_cuda")
    n, c = x2.shape
    x2 = x2.contiguous()
    y = torch.empty_like(x2)
    if n == 0:
        return y
    lib = _lib("layernorm_fwd", _FWD_ARGS)
    err = lib.hvd_layernorm_fwd(
        x2.data_ptr(), gamma.data_ptr(),
        beta.data_ptr() if beta is not None else None, y.data_ptr(),
        n, c, float(eps), int(rms), _DTYPE_CODES[x2.dtype],
        x2.device.index, _build.stream_handle(x2.device))
    _build.check(lib, err, "layernorm_fwd")
    _build.LAUNCHES["layernorm_fwd"] += 1
    return y


def layer_norm_bwd_cuda(x2: torch.Tensor, dy2: torch.Tensor,
                        gamma: torch.Tensor, eps: float, rms: bool,
                        with_beta: bool):
    """Launch ``csrc/layernorm_bwd.cu`` on ``[N, C]`` CUDA rows (C at
    most 4096): ``(dx, dgamma, dbeta or None)`` as
    :func:`layer_norm_bwd_ref` returns them."""
    _check_params(x2, gamma, None, "layer_norm_bwd_cuda")
    n, c = x2.shape
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype \
            or dy2.device != x2.device:
        raise ValueError(f"dy must match x ({tuple(x2.shape)} {x2.dtype}), "
                         f"got {tuple(dy2.shape)} {dy2.dtype}")
    if c > _BWD_MAX_C:
        raise ValueError(f"layer_norm_bwd_cuda takes C <= {_BWD_MAX_C}, "
                         f"got {c}")
    x2, dy2 = x2.contiguous(), dy2.contiguous()
    dx = torch.empty_like(x2)
    dg = torch.empty(c, dtype=torch.float32, device=x2.device)
    db = torch.empty_like(dg) if with_beta else None
    if n == 0:
        return dx, dg.zero_(), None if db is None else db.zero_()
    blocks = bwd_blocks(n, _sm_count(x2.device))
    dg_part = torch.empty(blocks, c, dtype=torch.float32, device=x2.device)
    db_part = torch.empty_like(dg_part) if with_beta else None
    lib = _lib("layernorm_bwd", _BWD_ARGS)
    err = lib.hvd_layernorm_bwd(
        x2.data_ptr(), dy2.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
        dg.data_ptr(), db.data_ptr() if with_beta else None,
        dg_part.data_ptr(), db_part.data_ptr() if with_beta else None,
        _ticket(x2.device).data_ptr(), n, c, blocks, float(eps), int(rms),
        _DTYPE_CODES[x2.dtype], x2.device.index,
        _build.stream_handle(x2.device))
    _build.check(lib, err, "layernorm_bwd")
    _build.LAUNCHES["layernorm_bwd"] += 1
    return dx, dg, db


class _FusedLayerNormFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, rms):
        ctx.save_for_backward(x2, gamma)
        ctx.eps, ctx.rms, ctx.with_beta = eps, rms, beta is not None
        if x2.is_cuda:
            return layer_norm_cuda(x2, gamma, beta, eps, rms)
        if x2.device.type != "cpu":
            raise ValueError(f"no LayerNorm kernel for device {x2.device}")
        return layer_norm_ref(x2, gamma, beta, eps, rms)

    @staticmethod
    def backward(ctx, dy):
        x2, gamma = ctx.saved_tensors
        bwd = layer_norm_bwd_cuda if x2.is_cuda else layer_norm_bwd_ref
        dx, dg, db = bwd(x2, dy, gamma, ctx.eps, ctx.rms, ctx.with_beta)
        return dx, dg, db, None, None


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
