"""Flash attention, forward and backward: the hand-written CUDA kernels
and their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas_attention.py``: the
forward streams K/V tiles under an online softmax and returns O and the
float32 row logsumexp; the backward rebuilds each probability tile from
(q, k, lse) in two kernels, dQ over kv tiles and dK/dV over q tiles, so
the ``[T, T]`` attention matrix is never stored in either direction.
``delta = rowsum(dO * O)`` between them stays plain PyTorch, as it is
plain XLA in the JAX package.

Rounding points (kept from the TPU kernels): q is scaled and rounded to
the input dtype before ``Q.K^T``; logits, running max and sums are
float32; probabilities are rounded to the input dtype before each
product that consumes them; masked entries are exactly 0, so a row that
sees no key outputs 0 with ``lse = -1e30``. The causal mask is on global
positions: ``query_offset`` / ``key_offset`` shift them for blocks of a
longer sequence.

Dispatch is by the device of ``q``: a CUDA tensor launches
``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu`` and
``csrc/flash_bwd_dkv.cu`` (head_dim 16, 32, 64 or 128; anything else
raises), a CPU tensor runs :func:`flash_attention_ref` and
:func:`flash_bwd_ref`. In bf16 the forward, dQ and dK/dV run on the
tensor cores (``mma.sync``, ``csrc/flash_mma.cuh``); float32 runs on the
CUDA cores (``csrc/flash.cuh``). The kernels choose
their own tiles (the constants below); the TPU kernels'
``block_q``/``block_k`` and ``HOROVOD_FLASH_BLOCK_Q/K`` are Mosaic
tiling devices and have no counterpart here.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The kernels' tiling, for callers that emulate a kernel skipping one
# tile (chip_smoke.py); tests/test_torch_flash_attention.py holds each
# to its ``constexpr`` in csrc/.
#: bf16 forward (B1): query rows a block holds (flash_mma.cuh
#: kBlockRows) and key rows of a streamed K/V tile (flash_fwd.cu kKvTile)
FWD_Q_ROWS = 64
FWD_KV_TILE = 64
#: bf16 dQ (B2): query rows a block holds (flash_mma.cuh kBlockRows)
DQ_Q_ROWS = 64
#: bf16 dK/dV (B3): key rows a block holds (flash_mma.cuh kBlockRows)
DKV_K_ROWS = 64
#: the float32 kernels of B1, B2 and B3, on the CUDA cores: rows a block
#: holds (flash.cuh kRows)
CUDA_CORE_ROWS = 64


def dq_kv_tile(head_dim: int) -> int:
    """Key rows of a streamed K/V tile of the bf16 dQ kernel
    (flash_bwd_dq.cu ``kv_tile<D>``)."""
    return 64 if head_dim <= 64 else 32


def dkv_q_tile(head_dim: int) -> int:
    """Query rows of a streamed Q/dO tile of the bf16 dK/dV kernel
    (flash_bwd_dkv.cu ``q_tile<D>``)."""
    return 64 if head_dim <= 64 else 32


def cuda_core_tile(head_dim: int) -> int:
    """Rows of a streamed tile of the float32 kernels (flash.cuh
    ``Shape<D>::kTile``)."""
    return 32 if head_dim <= 64 else 16


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the card's kernels are held to)
# ---------------------------------------------------------------------------

def _mask(tq: int, tk: int, causal: bool, q_off: int, k_off: int,
          device) -> Optional[torch.Tensor]:
    """``[Tq, Tk]`` visibility on global positions, or None (all)."""
    if not causal:
        return None
    qpos = q_off + torch.arange(tq, device=device)[:, None]
    kpos = k_off + torch.arange(tk, device=device)[None, :]
    return qpos >= kpos


def _logits(q, k, scale):
    """float32 ``qs . k^T`` with qs = q scaled and rounded to q's dtype."""
    qs = (q.to(torch.float32) * scale).to(q.dtype)
    return torch.matmul(qs.to(torch.float32),
                        k.to(torch.float32).transpose(-1, -2))


def flash_attention_ref(q, k, v, causal: bool, scale: float,
                        query_offset: int = 0, key_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward on ``[B, H, T, D]``: ``(O in q's dtype, lse
    float32 [B, H, Tq])`` with the kernel's rounding points, in one
    pass over the whole row instead of tiles."""
    s = _logits(q, k, scale)
    mask = _mask(q.shape[2], k.shape[2], causal, query_offset, key_offset,
                 q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(q.dtype).to(torch.float32), v.to(torch.float32))
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    out = (acc / safe_l).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(safe_l),
                      torch.full_like(l, NEG_INF))
    return out, lse[..., 0]


def flash_bwd_ref(q, k, v, dout, lse, delta, causal: bool, scale: float,
                  query_offset: int = 0, key_offset: int = 0):
    """Plain backward on ``[B, H, T, D]`` from the saved ``lse`` and
    ``delta = rowsum(dO * O)`` (float32 ``[B, H, Tq]``), with the
    kernels' rounding points: ``(dq, dk, dv)`` in the inputs' dtype.
    Masked probabilities are selected to 0 before anything multiplies
    them (their exp overflows on rows with ``lse = -1e30``)."""
    dt = q.dtype
    f32 = torch.float32
    s = _logits(q, k, scale)
    p = torch.exp(s - lse[..., None])
    mask = _mask(q.shape[2], k.shape[2], causal, query_offset, key_offset,
                 q.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.matmul(dout.to(f32), v.to(f32).transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(dt).to(f32)
    dq = (torch.matmul(ds, k.to(f32)) * scale).to(dt)
    dk = (torch.matmul(ds.transpose(-1, -2), q.to(f32)) * scale).to(dt)
    dv = torch.matmul(p.to(dt).to(f32).transpose(-1, -2),
                      dout.to(f32)).to(dt)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                  _I, _P],
    "flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                     _I, _I, _I, _P],
    "flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                      _I, _I, _I, _I, _P],
}


def _lib(name: str):
    lib = _build.library(name)
    fn = getattr(lib, f"hvd_{name}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, what):
    """Validate ``[B, H, T, D]`` CUDA operands; returns (B*H, Tq, Tk, D)."""
    if not q.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} takes float32/bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"{what} takes [B, H, T, D], got {tuple(q.shape)}")
    b, h, tq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not in {HEAD_DIMS}")
    for name, t in (("k", k), ("v", v)):
        if (t.dim() != 4 or t.shape[:2] != (b, h) or t.shape[3] != d
                or t.dtype != q.dtype or t.device != q.device):
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} "
                             f"does not match q {tuple(q.shape)} {q.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"{what}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    return b * h, tq, k.shape[2], d


def _aligned(*ts):
    """``ts`` contiguous, each starting on a 16-byte boundary: the bf16
    kernels copy rows 16 bytes at a time (``cp.async``), so a view that
    starts off the boundary is cloned."""
    ts = (t.contiguous() for t in ts)
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def flash_fwd_cuda(q, k, v, causal: bool, scale: float,
                   query_offset: int = 0, key_offset: int = 0):
    """Launch ``csrc/flash_fwd.cu``: ``(O, lse float32 [B, H, Tq])``."""
    bh, tq, tk, d = _check(q, k, v, "flash_fwd_cuda")
    q, k, v = _aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if bh == 0 or tq == 0:
        return out, lse
    lib = _lib("flash_fwd")
    err = lib.hvd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, tq, tk, d, float(scale), int(causal),
        int(query_offset), int(key_offset), _DTYPE_CODES[q.dtype],
        q.device.index, _build.stream_handle(q.device))
    _build.check(lib, err, "flash_fwd")
    _build.LAUNCHES["flash_fwd"] += 1
    return out, lse


def _check_rows(what, dout, lse, delta, q):
    if (dout.shape != q.shape or dout.dtype != q.dtype
            or dout.device != q.device):
        raise ValueError(f"{what}: dout {tuple(dout.shape)} {dout.dtype} "
                         f"does not match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != q.shape[:3]
                or t.device != q.device):
            raise ValueError(f"{what}: {name} must be float32 "
                             f"{tuple(q.shape[:3])} on {q.device}")


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal: bool,
                      scale: float, query_offset: int = 0,
                      key_offset: int = 0):
    """Launch ``csrc/flash_bwd_dq.cu``: dQ in q's dtype."""
    bh, tq, tk, d = _check(q, k, v, "flash_bwd_dq_cuda")
    _check_rows("flash_bwd_dq_cuda", dout, lse, delta, q)
    q, k, v, dout = _aligned(q, k, v, dout)
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = torch.empty_like(q)
    if bh == 0 or tq == 0:
        return dq
    lib = _lib("flash_bwd_dq")
    err = lib.hvd_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, tq, tk, d,
        float(scale), int(causal), int(query_offset), int(key_offset),
        _DTYPE_CODES[q.dtype], q.device.index,
        _build.stream_handle(q.device))
    _build.check(lib, err, "flash_bwd_dq")
    _build.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal: bool,
                       scale: float, query_offset: int = 0,
                       key_offset: int = 0):
    """Launch ``csrc/flash_bwd_dkv.cu``: ``(dK, dV)`` in k's dtype."""
    bh, tq, tk, d = _check(q, k, v, "flash_bwd_dkv_cuda")
    _check_rows("flash_bwd_dkv_cuda", dout, lse, delta, q)
    q, k, v, dout = _aligned(q, k, v, dout)
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if bh == 0 or tk == 0:
        return dk, dv
    lib = _lib("flash_bwd_dkv")
    err = lib.hvd_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, tq, tk, d, float(scale), int(causal), int(query_offset),
        int(key_offset), _DTYPE_CODES[q.dtype], q.device.index,
        _build.stream_handle(q.device))
    _build.check(lib, err, "flash_bwd_dkv")
    _build.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# autograd and the public functions
# ---------------------------------------------------------------------------

class _FlashFn(torch.autograd.Function):
    """[B, H, T, D] flash attention core; backward through B2 and B3."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_off, k_off):
        if q.is_cuda:
            out, lse = flash_fwd_cuda(q, k, v, causal, scale, q_off, k_off)
        elif q.device.type == "cpu":
            out, lse = flash_attention_ref(q, k, v, causal, scale, q_off,
                                           k_off)
        else:
            raise ValueError(f"no flash-attention kernel for {q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_off, k_off)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype)
        delta = torch.sum(dout.to(torch.float32) * out.to(torch.float32),
                          dim=-1)
        if q.is_cuda:
            dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, *ctx.args)
            dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                        *ctx.args)
        else:
            dq, dk, dv = flash_bwd_ref(q, k, v, dout, lse, delta,
                                       *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_bhtd(q, k, v, *, causal: bool = True,
                         scale: Optional[float] = None,
                         query_offset: int = 0, key_offset: int = 0):
    """Flash attention over ``[B, H, T, D]`` tensors. GQA kv heads
    (fewer than q heads, on axis 1) are repeated to the full head count;
    the repeat's own backward sums the copies' dK/dV back onto the
    shared heads."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    return _FlashFn.apply(q, k, v, bool(causal), float(scale),
                          int(query_offset), int(key_offset))


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, query_offset: int = 0,
                    key_offset: int = 0):
    """Flash attention over ``[B, T, H, D]`` tensors (the model layout);
    see :func:`flash_attention_bhtd`."""
    out = flash_attention_bhtd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, scale=scale, query_offset=query_offset,
        key_offset=key_offset)
    return out.transpose(1, 2)


def make_flash_attention_fn(causal: bool = True):
    """``attention_fn`` for ``models.transformer.Transformer``:
    ``fn(q, k, v) -> out`` on ``[B, T, H, D]``."""

    def fn(q, k, v):
        return flash_attention(q, k, v, causal=causal)

    return fn
