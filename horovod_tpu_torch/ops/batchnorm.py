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
bytes). The per-channel constants between the passes are folded inside
the kernels on the card, in the order of ``_fbn_fwd_impl`` and
``_fbn_bwd_impl``: the forward's mean, var, rstd, s and t in the stats
kernel's finish (:func:`bn_fwd_constants_ref` is the same arithmetic),
the backward's u and w in the reduce kernel's prologue, its A, B and C
in the dx kernel's (:func:`bn_bwd_constants_ref`); so the op runs no
``[C]`` arithmetic of its own. The ReLU mask is recomputed from x (and
the residual) in the backward, which never reads y. Statistics are
float32; the variance is the biased ``E[x^2] - mean^2`` clamped at 0, as
``flax.linen.BatchNorm`` computes it.

The four kernels, one ``csrc/*.cu`` source each, and what they replace:

* ``bn_stats`` (B7, ``_stats_kernel``): per-channel sum and sum of
  squares, then mean, var, rstd, s and t;
* ``bn_apply`` (B8, ``_apply_kernel`` / ``_apply_res_kernel``);
* ``bn_bwd_reduce`` (B9, ``_bwd_reduce_kernel``): u and w, then dgamma
  and dbeta;
* ``bn_bwd_dx`` (B10, ``_bwd_dx_kernel``): A, B and C, then dx and
  dres.

All four are bound by bytes on an H100 (a few flops per element). B8
and B10 round each float32 step on its own, as eager PyTorch does, so
they are bitwise equal to their plain versions; B8 gives each block a
tile of contiguous rows (:func:`apply_geometry`,
:func:`apply_block_of_rows`). B7 and B9 are one launch each: blocks of
strided rows write partial sums and the last block of each column tile
adds them in a fixed order (no atomics, deterministic;
:func:`reduce_geometry`, :func:`reduce_block_of_rows`); their sums
differ from the plain sums only in the order of the additions, and B7's
constants are bitwise the plain fold of its own sums.

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
# The reductions' partition (csrc/batchnorm.cuh; held to its
# ``constexpr``s by tests/test_torch_kernels.py): a 2-D grid of row
# blocks x column tiles, a block's threads across a tile of up to
# REDUCE_TILE vectors of a row and over THREADS / tile row groups.
#: threads of every BatchNorm kernel's block (kThreads)
THREADS = 256
#: rows a thread has loads in flight for, in every BatchNorm kernel (kRows)
ROWS_IN_FLIGHT = 4
#: vectors a reduction block spans in a row (kTileVecs)
REDUCE_TILE = 64
#: reduction blocks an SM holds at once (kBlocksPerSm): the grid aims at
#: this multiple of the SM count
REDUCE_BLOCKS_PER_SM = 2
#: the two float32 partial arrays together hold at most 1 / this of x's
#: bytes: fewer row blocks where the rows are few
REDUCE_PARTIAL_SHARE = 32


def vector_width(c: int, dtype: torch.dtype, *tensors) -> int:
    """Elements a kernel thread moves at once: a 16-byte vector when
    ``c`` is a multiple of it and every tensor is 16-byte aligned, else
    1."""
    vec = 16 * 8 // torch.finfo(dtype).bits
    ok = c % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors
                              if t is not None)
    return vec if ok else 1


def reduce_geometry(n: int, c: int, vec: int, itemsize: int,
                    sm_count: int) -> Tuple[int, int]:
    """``(row_blocks, col_tiles)`` of the reduction kernels (B7, B9) on
    ``n`` rows of ``c`` channels of ``itemsize`` bytes, moved ``vec`` at
    a time, on a card of ``sm_count`` SMs: about REDUCE_BLOCKS_PER_SM
    blocks an SM in all, and few enough row blocks that the ``[2,
    row_blocks, c]`` float32 partials are at most 1 /
    REDUCE_PARTIAL_SHARE of x's bytes (at least one row block)."""
    col_tiles = -(-(c // vec) // REDUCE_TILE)
    fill = REDUCE_BLOCKS_PER_SM * sm_count // col_tiles
    few = n * itemsize // (2 * 4 * REDUCE_PARTIAL_SHARE)
    return max(1, min(fill, few)), col_tiles


def reduce_block_of_rows(n: int, c: int, vec: int,
                         row_blocks: int) -> torch.Tensor:
    """The row block of B7 and B9 that sums each of ``n`` rows (int64
    ``[n]``): row group g of block b takes rows ``b * groups + g``, ``+
    row_blocks * groups``, ... (every column tile alike)."""
    groups = THREADS // min(c // vec, REDUCE_TILE)
    return (torch.arange(n) % (row_blocks * groups)) // groups


def apply_geometry(n: int, c: int, vec: int) -> Tuple[int, int]:
    """``(row_blocks, col_tiles)`` of B8 on ``n`` rows of ``c`` channels
    moved ``vec`` at a time: column tiles of up to THREADS vectors, and
    a row block for each tile of ``THREADS / tile * ROWS_IN_FLIGHT``
    contiguous rows (at most 2^31 - 1 blocks; past that they loop)."""
    cv = c // vec
    per_tile = THREADS // min(cv, THREADS) * ROWS_IN_FLIGHT
    return min(-(-n // per_tile), 2 ** 31 - 1), -(-cv // THREADS)


def apply_block_of_rows(n: int, c: int, vec: int,
                        row_blocks: int) -> torch.Tensor:
    """The row block of B8 that writes each of ``n`` rows (int64
    ``[n]``), by walking the kernel's loop on ``row_blocks`` blocks:
    block b takes row tiles b, b + row_blocks, ...; in tile i, row group
    g writes rows ``i * groups * ROWS_IN_FLIGHT + g + k * groups`` for k
    below ROWS_IN_FLIGHT (every column tile alike). -1 marks a row that
    no block, or more than one, writes."""
    groups = THREADS // min(c // vec, THREADS)
    per_tile = groups * ROWS_IN_FLIGHT
    tile = torch.arange(-(-n // per_tile))
    rows = (tile[:, None, None] * per_tile
            + torch.arange(groups)[None, :, None]
            + groups * torch.arange(ROWS_IN_FLIGHT)[None, None, :])
    block = (tile % row_blocks)[:, None, None].expand_as(rows)
    keep = rows < n
    rows, block = rows[keep], block[keep]
    out = torch.full((n,), -1, dtype=torch.int64)
    out[rows] = block
    out[torch.bincount(rows, minlength=n) != 1] = -1
    return out


# -- plain versions ---------------------------------------------------------

def _relu_mask(xf, s, t, res2):
    pre = xf * s + t
    if res2 is not None:
        pre = pre + res2.to(torch.float32)
    return pre > 0


def bn_stats_ref(x2: torch.Tensor):
    """Plain version of B7's sums on ``[R, C]`` rows (any device):
    float32 ``(sum, sum of squares)`` per channel."""
    xf = x2.to(torch.float32)
    return xf.sum(0), (xf * xf).sum(0)


def bn_fwd_constants_ref(xsum, xsq, gamma, beta, eps: float, n: float):
    """Plain version of B7's fold: the per-channel float32 ``(mean, var,
    rstd, s, t)`` of the forward from the sums over ``n`` rows, in the
    order of ``_fbn_fwd_impl`` (the biased variance clamped at 0; ``y =
    x * s + t``). On the card PyTorch divides by the Python float ``n``
    as a product with ``1 / float32(n)`` and ``torch.rsqrt`` is
    ``rsqrtf``; the kernel folds the same way."""
    mean = xsum / n
    var = torch.clamp(xsq / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    s = gamma * rstd
    t = beta - mean * s
    return mean, var, rstd, s, t


def bn_stats_folded_ref(x2, gamma, beta, eps: float):
    """Plain version of B7 as the kernel runs it: :func:`bn_stats_ref`,
    then :func:`bn_fwd_constants_ref` over ``x2``'s rows: ``(sum, sum of
    squares, mean, var, rstd, s, t)``."""
    xsum, xsq = bn_stats_ref(x2)
    return (xsum, xsq, *bn_fwd_constants_ref(xsum, xsq, gamma, beta, eps,
                                             float(x2.shape[0])))


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


def bn_bwd_reduce_ref(x2, dy2, res2, s, t, mean, rstd, relu: bool):
    """Plain version of B9: float32 ``(dgamma, dbeta)`` = ``(sum(dy_eff *
    (x * u + w)), sum(dy_eff))`` per channel with ``u, w = rstd, -mean *
    rstd``, the ReLU mask recomputed from x (and res)."""
    u, w = rstd, -mean * rstd
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
    "bn_stats": [_P, _P, _P, ctypes.c_float, _P, _P, _P, _L, _I, _I, _I,
                 _I, _I, _P],
    "bn_apply": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    "bn_bwd_reduce": [_P] * 11 + [_L] + [_I] * 6 + [_P],
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
    _build.count_launch(name)


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


def _reduce_scratch(name, x2, vec):
    """``(row_blocks, partials, tickets)`` of a reduction launch."""
    n, c = x2.shape
    row_blocks, col_tiles = reduce_geometry(n, c, vec, x2.element_size(),
                                            _build.sm_count(x2.device))
    part = torch.empty(2, row_blocks, c, dtype=torch.float32,
                       device=x2.device)
    return row_blocks, part, _build.tickets(name, x2.device, col_tiles)


def bn_stats_cuda(x2: torch.Tensor, gamma, beta, eps: float):
    """Launch ``csrc/bn_stats.cu`` (B7) on ``[R, C]`` CUDA rows, which
    folds the forward's constants from its sums itself: ``(sum, sum of
    squares, mean, var, rstd, s, t)`` as :func:`bn_stats_folded_ref`
    returns them (the constants bitwise the plain fold of the kernel's
    own sums)."""
    _check_rows("bn_stats_cuda", x2)
    _check_vecs("bn_stats_cuda", x2, gamma=gamma, beta=beta)
    _check_cuda("bn_stats_cuda", x2)
    n, c = x2.shape
    out = torch.empty(7, c, dtype=torch.float32, device=x2.device)
    vec = vector_width(c, x2.dtype, x2)
    row_blocks, part, tickets = _reduce_scratch("bn_stats", x2, vec)
    _launch("bn_stats", x2, x2.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), float(eps), out.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), n, c, vec, row_blocks)
    return tuple(out)


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


def bn_bwd_reduce_cuda(x2, dy2, res2, s, t, mean, rstd, relu: bool):
    """Launch ``csrc/bn_bwd_reduce.cu`` (B9), which forms u and w from
    the statistics itself: ``(dgamma, dbeta)`` as
    :func:`bn_bwd_reduce_ref` returns them (zeros for no rows)."""
    _check_rows("bn_bwd_reduce_cuda", x2, ("dy", dy2), ("residual", res2))
    _check_vecs("bn_bwd_reduce_cuda", x2, s=s, t=t, mean=mean, rstd=rstd)
    _check_cuda("bn_bwd_reduce_cuda", x2)
    n, c = x2.shape
    out = torch.empty(2, c, dtype=torch.float32, device=x2.device)
    vec = vector_width(c, x2.dtype, x2, dy2, res2)
    row_blocks, part, tickets = _reduce_scratch("bn_bwd_reduce", x2, vec)
    _launch("bn_bwd_reduce", x2, x2.data_ptr(), dy2.data_ptr(), _ptr(res2),
            s.data_ptr(), t.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), part.data_ptr(),
            tickets.data_ptr(), n, c, vec, row_blocks, int(relu))
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
        _, _, mean, var, rstd, s, t = _pick(
            x2, bn_stats_cuda, bn_stats_folded_ref)(x2, gamma, beta, eps)
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
        dgamma, dbeta = _pick(x2, bn_bwd_reduce_cuda, bn_bwd_reduce_ref)(
            x2, dy2, res2, s, t, mean, rstd, ctx.relu)
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
