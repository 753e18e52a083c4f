"""Fused BatchNorm, training forward and backward, with ReLU and
residual epilogues: the hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of the JAX package's ``ops/pallas_batchnorm.py``, in its
pass structure::

    forward:   stats (read x)  ->  y = act(x * s + t [+ res])
    backward:  dgamma, dbeta (read x, dy [, res])  ->
               dx = dy_eff * A + x * B + C [, dres = dy_eff]

Every kernel works on the ``[R, C]`` view of a channels-last activation:
the channel axis is the last and contiguous (NHWC, the JAX layout; an
NCHW tensor in ``torch.channels_last`` memory format has the same
bytes). The per-channel constants between the passes (mean, var, rstd,
s, t, u, w) are plain PyTorch ``[C]`` vector operations in the order of
``_fbn_fwd_impl`` and ``_fbn_bwd_impl``; the backward's A, B and C are
folded from the statistics inside the dx kernel on the card
(:func:`bn_bwd_constants_ref` is the same arithmetic); the ReLU mask is
recomputed from x (and the residual) in the backward, which never reads
y. Statistics are float32; the variance is the biased ``E[x^2] -
mean^2`` clamped at 0, as ``flax.linen.BatchNorm`` computes it.

The four kernels, one ``csrc/*.cu`` source each, and what they replace:

* ``bn_stats`` (B7, ``_stats_kernel``): per-channel sum and sum of
  squares;
* ``bn_apply`` (B8, ``_apply_kernel`` / ``_apply_res_kernel``);
* ``bn_bwd_reduce`` (B9, ``_bwd_reduce_kernel``): dgamma and dbeta;
* ``bn_bwd_dx`` (B10, ``_bwd_dx_kernel``): A, B and C, then dx and
  dres.

All four are bound by bytes on an H100 (a few flops per element). B8
and B10 round each float32 step on its own, as eager PyTorch does, so
they are bitwise equal to their plain versions; B7 and B9 add per-block
partial sums in block order (no atomics, deterministic) and differ from
the plain sums only in the order of the additions.

Dispatch is by the device of x: a CUDA tensor launches the kernel (or
the call raises), a CPU tensor runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch import nn

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: threads of every BatchNorm kernel's block (csrc/batchnorm.cuh)
THREADS = 256
#: blocks a reduction aims for: 8 blocks of 256 threads on each of the
#: H100's 132 SMs, so every shape of the path fills the card
TARGET_BLOCKS = 8 * 132


def vector_width(c: int, dtype: torch.dtype, *tensors) -> int:
    """Elements a kernel thread moves at once: a 16-byte vector when
    ``c`` is a multiple of it and every tensor is 16-byte aligned, else
    1."""
    vec = 16 * 8 // torch.finfo(dtype).bits
    ok = c % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors
                              if t is not None)
    return vec if ok else 1


def reduce_geometry(n: int, c: int, vec: int) -> Tuple[int, int]:
    """``(rows_per_block, blocks)`` of the reduction kernels (B7, B9) on
    ``n`` rows of ``c`` channels: block b sums rows ``[b *
    rows_per_block, (b + 1) * rows_per_block)`` of its column tile."""
    cv = c // vec
    rows_par = THREADS // min(cv, THREADS)
    col_tiles = -(-cv // THREADS)
    blocks = max(1, min(-(-n // rows_par), TARGET_BLOCKS // col_tiles))
    rows_per_block = -(-n // blocks)
    return rows_per_block, -(-n // rows_per_block)


# -- plain versions ---------------------------------------------------------

def _relu_mask(xf, s, t, res2):
    pre = xf * s + t
    if res2 is not None:
        pre = pre + res2.to(torch.float32)
    return pre > 0


def bn_stats_ref(x2: torch.Tensor):
    """Plain version of B7 on ``[R, C]`` rows (any device): float32
    ``(sum, sum of squares)`` per channel."""
    xf = x2.to(torch.float32)
    return xf.sum(0), (xf * xf).sum(0)


def bn_apply_ref(x2, s, t, res2, relu: bool) -> torch.Tensor:
    """Plain version of B8: ``act(x * s + t [+ res])`` in float32, each
    step rounded on its own, cast to x's dtype."""
    y = x2.to(torch.float32) * s + t
    if res2 is not None:
        y = y + res2.to(torch.float32)
    if relu:
        y = torch.relu(y)
    return y.to(x2.dtype)


def _dy_eff(x2, dy2, res2, s, t, relu):
    dyf = dy2.to(torch.float32)
    if not relu:
        return dyf
    return torch.where(_relu_mask(x2.to(torch.float32), s, t, res2), dyf,
                       0.0)


def bn_bwd_reduce_ref(x2, dy2, res2, s, t, u, w, relu: bool):
    """Plain version of B9: float32 ``(dgamma, dbeta)`` = ``(sum(dy_eff *
    (x * u + w)), sum(dy_eff))`` per channel, the ReLU mask recomputed
    from x (and res)."""
    dye = _dy_eff(x2, dy2, res2, s, t, relu)
    xhat = x2.to(torch.float32) * u + w
    return (dye * xhat).sum(0), dye.sum(0)


def bn_bwd_dx_ref(x2, dy2, res2, s, t, a, b, c, relu: bool):
    """Plain version of B10's elementwise pass: ``(dx, dres)`` with ``dx
    = dy_eff * a + x * b + c`` in float32, each step rounded on its own,
    and ``dres = dy_eff`` (None without a residual), both in x's
    dtype."""
    dye = _dy_eff(x2, dy2, res2, s, t, relu)
    dx = dye * a + x2.to(torch.float32) * b + c
    dres = None if res2 is None else dye.to(x2.dtype)
    return dx.to(x2.dtype), dres


def bn_bwd_constants_ref(gamma, mean, rstd, dgamma, dbeta, n: float):
    """Plain version of B10's fold: the per-channel float32 ``(a, b, c)``
    of dx from the statistics and ``(dgamma, dbeta)`` over ``n`` rows, in
    the order of ``_fbn_bwd_impl``. On the card PyTorch divides by the
    Python float ``n`` as a product with ``1 / float32(n)``; the kernel
    folds the same way."""
    a = gamma * rstd
    b = rstd * (-a * dgamma / n)
    c = -a * dbeta / n - (-mean * rstd) * a * dgamma / n
    return a, b, c


def bn_bwd_dx_folded_ref(x2, dy2, res2, s, t, gamma, mean, rstd, dgamma,
                         dbeta, relu: bool):
    """Plain version of B10 as the kernel runs it: the fold of
    :func:`bn_bwd_constants_ref` over ``x2``'s rows, then
    :func:`bn_bwd_dx_ref`."""
    a, b, c = bn_bwd_constants_ref(gamma, mean, rstd, dgamma, dbeta,
                                   float(x2.shape[0]))
    return bn_bwd_dx_ref(x2, dy2, res2, s, t, a, b, c, relu)


# -- kernel wrappers --------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "bn_stats": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "bn_apply": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    "bn_bwd_reduce": [_P] * 11 + [_I] * 8 + [_P],
    "bn_bwd_dx": [_P] * 12 + [_L, _I, _I, _I, _I, _I, _P],
}


def _launch(name: str, x2: torch.Tensor, *args) -> None:
    lib = _build.library(name)
    fn = getattr(lib, f"hvd_{name}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    err = fn(*args, _DTYPE_CODES[x2.dtype], x2.device.index,
             _build.stream_handle(x2.device))
    _build.check(lib, err, name)
    _build.LAUNCHES[name] += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_rows(what, x2, *others):
    """x2 and each non-None ``(name, tensor)`` of ``others``: [R, C]
    rows of one float32/bfloat16 dtype, contiguous, on one device."""
    if x2.dim() != 2 or x2.dtype not in _DTYPE_CODES \
            or not x2.is_contiguous():
        raise ValueError(f"{what} takes contiguous [R, C] float32/bfloat16 "
                         f"rows, got {tuple(x2.shape)} {x2.dtype}")
    for name, t in others:
        if t is None:
            continue
        if (t.shape != x2.shape or t.dtype != x2.dtype
                or t.device != x2.device or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous "
                             f"{tuple(x2.shape)} {x2.dtype} on {x2.device}")


def _check_vecs(what, x2, **vecs):
    c = x2.shape[1]
    for name, v in vecs.items():
        if (v.dtype != torch.float32 or v.shape != (c,)
                or v.device != x2.device or not v.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"[{c}] tensor on {x2.device}")


def _check_cuda(what, x2):
    """Checked after the shapes, so that a CPU call reports a bad shape
    before the device."""
    if not x2.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors")


def _reduce_scratch(x2, vec):
    n, c = x2.shape
    rows_per_block, blocks = reduce_geometry(n, c, vec)
    part = torch.empty(2, blocks, c, dtype=torch.float32, device=x2.device)
    return rows_per_block, blocks, part[0], part[1]


def bn_stats_cuda(x2: torch.Tensor):
    """Launch ``csrc/bn_stats.cu`` (B7) on ``[R, C]`` CUDA rows:
    ``(sum, sum of squares)`` as :func:`bn_stats_ref` returns them."""
    _check_rows("bn_stats_cuda", x2)
    _check_cuda("bn_stats_cuda", x2)
    n, c = x2.shape
    out = torch.zeros(2, c, dtype=torch.float32, device=x2.device)
    if n == 0:
        return out[0], out[1]
    vec = vector_width(c, x2.dtype, x2)
    rows, blocks, sp, qp = _reduce_scratch(x2, vec)
    _launch("bn_stats", x2, x2.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), sp.data_ptr(), qp.data_ptr(), n, c, vec, rows,
            blocks)
    return out[0], out[1]


def bn_apply_cuda(x2, s, t, res2, relu: bool) -> torch.Tensor:
    """Launch ``csrc/bn_apply.cu`` (B8): :func:`bn_apply_ref`'s output,
    bitwise."""
    _check_rows("bn_apply_cuda", x2, ("residual", res2))
    _check_vecs("bn_apply_cuda", x2, s=s, t=t)
    _check_cuda("bn_apply_cuda", x2)
    n, c = x2.shape
    y = torch.empty_like(x2)
    if n == 0:
        return y
    vec = vector_width(c, x2.dtype, x2, res2, y)
    _launch("bn_apply", x2, x2.data_ptr(), s.data_ptr(), t.data_ptr(),
            _ptr(res2), y.data_ptr(), n, c, vec, int(relu))
    return y


def bn_bwd_reduce_cuda(x2, dy2, res2, s, t, u, w, relu: bool):
    """Launch ``csrc/bn_bwd_reduce.cu`` (B9): ``(dgamma, dbeta)`` as
    :func:`bn_bwd_reduce_ref` returns them."""
    _check_rows("bn_bwd_reduce_cuda", x2, ("dy", dy2), ("residual", res2))
    _check_vecs("bn_bwd_reduce_cuda", x2, s=s, t=t, u=u, w=w)
    _check_cuda("bn_bwd_reduce_cuda", x2)
    n, c = x2.shape
    out = torch.zeros(2, c, dtype=torch.float32, device=x2.device)
    if n == 0:
        return out[0], out[1]
    vec = vector_width(c, x2.dtype, x2, dy2, res2)
    rows, blocks, gp, bp = _reduce_scratch(x2, vec)
    _launch("bn_bwd_reduce", x2, x2.data_ptr(), dy2.data_ptr(), _ptr(res2),
            s.data_ptr(), t.data_ptr(), u.data_ptr(), w.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), gp.data_ptr(),
            bp.data_ptr(), n, c, vec, rows, blocks, int(relu))
    return out[0], out[1]


def bn_bwd_dx_cuda(x2, dy2, res2, s, t, gamma, mean, rstd, dgamma, dbeta,
                   relu: bool):
    """Launch ``csrc/bn_bwd_dx.cu`` (B10), which folds A, B and C from
    the statistics and the column sums itself:
    :func:`bn_bwd_dx_folded_ref`'s ``(dx, dres)``, bitwise."""
    _check_rows("bn_bwd_dx_cuda", x2, ("dy", dy2), ("residual", res2))
    _check_vecs("bn_bwd_dx_cuda", x2, s=s, t=t, gamma=gamma, mean=mean,
                rstd=rstd, dgamma=dgamma, dbeta=dbeta)
    _check_cuda("bn_bwd_dx_cuda", x2)
    n, ch = x2.shape
    dx = torch.empty_like(x2)
    dres = None if res2 is None else torch.empty_like(x2)
    if n == 0:
        return dx, dres
    vec = vector_width(ch, x2.dtype, x2, dy2, res2, dx, dres)
    _launch("bn_bwd_dx", x2, x2.data_ptr(), dy2.data_ptr(), _ptr(res2),
            s.data_ptr(), t.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            dx.data_ptr(), _ptr(dres), n, ch, vec, int(relu))
    return dx, dres


def _pick(x2: torch.Tensor, cuda_fn, ref_fn):
    if x2.is_cuda:
        return cuda_fn
    if x2.device.type != "cpu":
        raise ValueError(f"no BatchNorm kernel for device {x2.device}")
    return ref_fn


# -- the op -----------------------------------------------------------------

class _FusedBatchNormFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, gamma, beta, res2, eps, relu):
        n = float(x2.shape[0])
        xsum, xsq = _pick(x2, bn_stats_cuda, bn_stats_ref)(x2)
        mean = xsum / n
        var = torch.clamp(xsq / n - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        s = gamma * rstd
        t = beta - mean * s
        y2 = _pick(x2, bn_apply_cuda, bn_apply_ref)(x2, s, t, res2, relu)
        ctx.save_for_backward(x2, gamma, res2, mean, rstd, s, t)
        ctx.relu = relu
        ctx.mark_non_differentiable(mean, var)
        return y2, mean, var

    @staticmethod
    def backward(ctx, dy2, _dmean, _dvar):
        # the statistics' cotangents are dropped: they feed only the
        # running averages (the JAX op's `_fbn_b` does the same)
        x2, gamma, res2, mean, rstd, s, t = ctx.saved_tensors
        dy2 = dy2.contiguous()
        u, w = rstd, -mean * rstd
        dgamma, dbeta = _pick(x2, bn_bwd_reduce_cuda, bn_bwd_reduce_ref)(
            x2, dy2, res2, s, t, u, w, ctx.relu)
        dx2, dres2 = _pick(x2, bn_bwd_dx_cuda, bn_bwd_dx_folded_ref)(
            x2, dy2, res2, s, t, gamma, mean, rstd, dgamma, dbeta, ctx.relu)
        return dx2, dgamma, dbeta, dres2, None, None


def fused_batch_norm(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, *, eps: float = 1e-5,
                     activation: Optional[str] = None,
                     residual: Optional[torch.Tensor] = None):
    """Training-mode BatchNorm over the last axis with optional fused
    ReLU and residual add: ``y = act(xhat * gamma + beta [+ residual])``.

    Returns ``(y, batch_mean, batch_var)``: y in x's dtype, the
    statistics float32 with the biased variance, as
    ``flax.linen.BatchNorm``. Gradients flow to x, gamma, beta and the
    residual; the statistics are not differentiable (they are for the
    running averages)."""
    if activation not in (None, "relu"):
        raise ValueError(f"unsupported activation {activation!r}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != x shape "
                         f"{tuple(x.shape)}")
    shape, c = x.shape, x.shape[-1]
    x2 = x.reshape(-1, c).contiguous()
    res2 = None if residual is None else residual.reshape(-1, c).contiguous()
    y2, mean, var = _FusedBatchNormFn.apply(
        x2, gamma.to(torch.float32), beta.to(torch.float32), res2,
        float(eps), activation == "relu")
    return y2.reshape(shape), mean, var


class FusedBatchNorm(nn.Module):
    """BatchNorm over the last axis backed by the fused kernels, with an
    optional ReLU and residual epilogue; the port of the JAX package's
    ``FusedBatchNorm``.

    Parameters ``scale`` and ``bias`` and buffers ``mean`` and ``var``
    (float32) are named as flax names them, so converted trees load
    unchanged. In training the kernels run and the running statistics
    follow flax's rule ``ra = momentum * ra + (1 - momentum) * batch``
    with the biased batch variance; in eval (``.eval()``) the layer is a
    plain per-channel affine of the running statistics, as in JAX.
    ``scale_init`` ("ones" or "zeros") is what ``init_params`` of the
    model fills the scale with."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 activation: Optional[str] = None,
                 scale_init: str = "ones"):
        super().__init__()
        if activation not in (None, "relu"):
            raise ValueError(f"unsupported activation {activation!r}")
        self.momentum, self.epsilon = momentum, epsilon
        self.dtype, self.activation = dtype, activation
        self.scale_init = scale_init
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            rstd = torch.rsqrt(self.var + self.epsilon)
            s = self.scale * rstd
            t = self.bias - self.mean * s
            y = x.to(torch.float32) * s + t
            if residual is not None:
                y = y + residual.to(torch.float32)
            if self.activation == "relu":
                y = torch.relu(y)
            return y.to(self.dtype or x.dtype)
        y, mean, var = fused_batch_norm(
            x, self.scale, self.bias, eps=self.epsilon,
            activation=self.activation, residual=residual)
        m = self.momentum
        with torch.no_grad():
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return y
