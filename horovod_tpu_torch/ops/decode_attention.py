"""Decode append + attend: the hand-written CUDA kernels and their
plain PyTorch versions.

Counterpart of section (c) of the JAX package's
``ops/pallas_collectives.py`` (``decode_append_attend``). One call
merges the new K/V rows of one layer into the slotted cache at their
positions (quantizing them on write for an int8 cache) and returns the
attention of the new queries over the merged cache slice.

The plain version is the cache update followed by the cached attention
(:func:`append_rows_ref` / :func:`append_rows_int8_ref`, then
``models.transformer.cached_attention``): serving/decode.py's
``SlottedKVCache.update`` runs exactly these merges. Dispatch is by the
device of ``q``: a CUDA tensor launches ``csrc/append_attend.cu`` (float
cache) or ``csrc/append_attend_int8.cu`` (int8 cache), or raises; a CPU
tensor runs the plain version.

The port reads no ``HOROVOD_FUSED_COLLECTIVES``: the card always runs
the kernel.

The cache is updated in place: the kernels write the replaced rows
into the layer's strided view of the cache buffer (the JAX package
rebinds functionally and relies on buffer donation instead).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..models.transformer import cached_attention
from ..optim.compression import dequantize_blocks, quantize_blocks
from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _quantize_rows(x: torch.Tensor, block: int) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Per-block symmetric int8 quantization along the LAST axis of
    ``x`` (block divides it). Returns (codes int8 same shape, scales
    float32 with last axis D/block)."""
    q, s = quantize_blocks(x.to(torch.float32).reshape(-1), block)
    return (q.reshape(x.shape),
            s.reshape(x.shape[:-1] + (x.shape[-1] // block,)))


def _dequantize_rows(q: torch.Tensor, s: torch.Tensor,
                     block: int) -> torch.Tensor:
    """Inverse of :func:`_quantize_rows` (float32)."""
    return dequantize_blocks(q.reshape(-1), s.reshape(-1),
                             block).reshape(q.shape)


def _one_hot(positions: torch.Tensor, m: int):
    """One-hot ``[B, T, M]`` float32 rows of the positions (all zero
    for a position outside [0, M)) and the keep mask ``[B, 1, M, 1]``
    of the rows no position replaces."""
    idx = torch.arange(m, dtype=positions.dtype, device=positions.device)
    oh = (positions[..., None] == idx).to(torch.float32)
    cov = torch.clamp(oh.sum(dim=1), 0.0, 1.0)
    return oh, (1.0 - cov)[:, None, :, None]


def _merge(cache_slice, new, oh, keep):
    # [B,KH,M,*] * keep + one-hot-scattered new rows, in float32
    delta = torch.einsum("btm,btkd->bkmd", oh, new.to(torch.float32))
    return cache_slice.to(torch.float32) * keep + delta


def _valid(positions: torch.Tensor, m: int) -> torch.Tensor:
    idx = torch.arange(m, dtype=positions.dtype, device=positions.device)
    return idx[None, None, :] <= positions[:, :, None]  # [B, T, M]


def append_rows_ref(k_buf, v_buf, k_new, v_new, positions,
                    compute_dtype: torch.dtype):
    """Merge ``k_new``/``v_new`` ``[B, T, KH, D]`` at ``positions``
    ``[B, T]`` into the float cache slices ``k_buf``/``v_buf`` ``[B, KH,
    M, D]`` (in place) and return ``(k_full, v_full, valid)``: the
    merged slices in ``compute_dtype`` and the ``[B, T, M]`` mask
    ``j <= position``."""
    m = k_buf.shape[2]
    oh, keep = _one_hot(positions, m)
    outs = []
    for buf, new in ((k_buf, k_new), (v_buf, v_new)):
        merged = _merge(buf, new, oh, keep).to(buf.dtype)
        buf.copy_(merged)
        outs.append(merged.to(compute_dtype))
    return outs[0], outs[1], _valid(positions, m)


def append_rows_int8_ref(k_codes, k_scales, v_codes, v_scales, k_new,
                         v_new, positions, block: int,
                         compute_dtype: torch.dtype):
    """:func:`append_rows_ref` for an int8 cache: the new rows are
    quantized in blocks of ``block`` along head_dim, codes and scales
    are merged (codes in float32, rounded, cast to int8 with
    saturation) and the merged slices are dequantized."""
    m = k_codes.shape[2]
    oh, keep = _one_hot(positions, m)
    outs = []
    for codes_buf, scales_buf, new in ((k_codes, k_scales, k_new),
                                       (v_codes, v_scales, v_new)):
        codes, scales = _quantize_rows(new, block)  # [B,T,KH,*]
        merged_codes = torch.clamp(
            torch.round(_merge(codes_buf, codes, oh, keep)), -128, 127
        ).to(torch.int8)
        merged_scales = _merge(scales_buf, scales, oh, keep)
        codes_buf.copy_(merged_codes)
        scales_buf.copy_(merged_scales)
        full = _dequantize_rows(merged_codes, merged_scales, block)
        outs.append(full.to(compute_dtype))
    return outs[0], outs[1], _valid(positions, m)


def append_attend_ref(q, k_buf, v_buf, k_new, v_new, positions):
    """Plain version of ``csrc/append_attend.cu``: merge in place, then
    attend (compute dtype = ``q``'s). Returns ``[B, T, H, D]``."""
    k_full, v_full, valid = append_rows_ref(k_buf, v_buf, k_new, v_new,
                                            positions, q.dtype)
    return cached_attention(q, k_full, v_full, valid)


def append_attend_int8_ref(q, k_codes, k_scales, v_codes, v_scales, k_new,
                           v_new, positions, block: int):
    """Plain version of ``csrc/append_attend_int8.cu``."""
    k_full, v_full, valid = append_rows_int8_ref(
        k_codes, k_scales, v_codes, v_scales, k_new, v_new, positions,
        block, q.dtype)
    return cached_attention(q, k_full, v_full, valid)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _lib_fp():
    lib = _build.library("append_attend")
    fn = lib.hvd_append_attend
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, p, p, p, p,
                       i, i, i, i, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = i
    return lib


def _lib_int8():
    lib = _build.library("append_attend_int8")
    fn = lib.hvd_append_attend_int8
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                       p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i,
                       i, p]
        fn.restype = i
    return lib


def _check_inputs(q, k_new, v_new, positions, slices, m: int, d: int):
    """Shared argument checks of the two kernels; returns (B, T, H, KH,
    int32 positions). A head_dim or cache length the kernels cannot
    take (too much shared memory) is refused by the C entry point, and
    :func:`_build.check` raises on its error code."""
    if not q.is_cuda:
        raise ValueError("the append+attend kernels take CUDA tensors")
    if q.dim() != 4 or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q must be [B, T, H, D] float32/bfloat16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    b, t, h, dq = q.shape
    kh = k_new.shape[2] if k_new.dim() == 4 else -1
    for name, v in (("k_new", k_new), ("v_new", v_new)):
        if (v.shape != (b, t, kh, d) or v.dtype != q.dtype
                or v.device != q.device):
            raise ValueError(f"{name} must be [B, T, KH, D] = "
                             f"{(b, t, kh, d)} {q.dtype} on {q.device}, "
                             f"got {tuple(v.shape)} {v.dtype}")
    if dq != d or kh < 1 or h % kh:
        raise ValueError(f"q heads/head_dim {h}/{dq} do not fit the cache's "
                         f"kv heads/head_dim {kh}/{d}")
    if positions.shape != (b, t) or positions.device != q.device:
        raise ValueError(f"positions must be [B, T] = {(b, t)} on "
                         f"{q.device}, got {tuple(positions.shape)}")
    for name, v, inner in slices:
        if (v.device != q.device or v.shape[:3] != (b, kh, m)
                or v.stride()[1:] != (m * inner, inner, 1)):
            raise ValueError(
                f"{name} must be a [B, KH, M, {inner}] view whose inner "
                f"[KH, M, {inner}] block is contiguous, got "
                f"{tuple(v.shape)} strides {v.stride()}")
    return b, t, h, kh, positions.to(torch.int32).contiguous()


def append_attend_cuda(q, k_buf, v_buf, k_new, v_new, positions):
    """Launch ``csrc/append_attend.cu``: merge the new rows into the
    float32/bfloat16 cache slices ``k_buf``/``v_buf`` ``[B, KH, M, D]``
    in place and return the attention output ``[B, T, H, D]`` in
    ``q``'s dtype (the compute dtype)."""
    m, d = k_buf.shape[2], k_buf.shape[3]
    b, t, h, kh, pos = _check_inputs(
        q, k_new, v_new, positions,
        (("k_buf", k_buf, d), ("v_buf", v_buf, d)), m, d)
    if (k_buf.dtype not in _DTYPE_CODES or v_buf.dtype != k_buf.dtype
            or v_buf.stride(0) != k_buf.stride(0)):
        raise ValueError("k_buf/v_buf must share a float32/bfloat16 dtype "
                         "and slot stride")
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    out = torch.empty_like(q)
    lib = _lib_fp()
    err = lib.hvd_append_attend(
        q.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(), k_buf.stride(0),
        k_new.data_ptr(), v_new.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, t, h, kh, m, d, float(1.0 / np.sqrt(d)), _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_buf.dtype], q.device.index,
        _build.stream_handle(q.device))
    _build.check(lib, err, "append_attend")
    _build.LAUNCHES["append_attend"] += 1
    return out


def append_attend_int8_cuda(q, k_codes, k_scales, v_codes, v_scales, k_new,
                            v_new, positions, block: int):
    """Launch ``csrc/append_attend_int8.cu``: quantize the new rows on
    write, merge codes ``[B, KH, M, D]`` int8 and scales ``[B, KH, M,
    D/block]`` float32 in place, and return the attention output."""
    m, d = k_codes.shape[2], k_codes.shape[3]
    if block < 1 or d % block:
        raise ValueError(f"block {block} does not divide head_dim {d}")
    nb = d // block
    b, t, h, kh, pos = _check_inputs(
        q, k_new, v_new, positions,
        (("k_codes", k_codes, d), ("v_codes", v_codes, d),
         ("k_scales", k_scales, nb), ("v_scales", v_scales, nb)), m, d)
    if (k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8
            or k_scales.dtype != torch.float32
            or v_scales.dtype != torch.float32
            or v_codes.stride(0) != k_codes.stride(0)
            or v_scales.stride(0) != k_scales.stride(0)):
        raise ValueError("codes must be int8 and scales float32, each pair "
                         "with one slot stride")
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    out = torch.empty_like(q)
    lib = _lib_int8()
    err = lib.hvd_append_attend_int8(
        q.data_ptr(), k_codes.data_ptr(), k_scales.data_ptr(),
        v_codes.data_ptr(), v_scales.data_ptr(), k_codes.stride(0),
        k_scales.stride(0), k_new.data_ptr(), v_new.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, t, h, kh, m, d, int(block),
        float(1.0 / np.sqrt(d)), _DTYPE_CODES[q.dtype], q.device.index,
        _build.stream_handle(q.device))
    _build.check(lib, err, "append_attend_int8")
    _build.LAUNCHES["append_attend_int8"] += 1
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def decode_append_attend(cache, layer: int, q, k_new, v_new, positions):
    """Append + attend over a ``serving.decode.SlottedKVCache``: merge
    the new K/V rows ``[B, T, KH, D]`` into layer ``layer`` at
    ``positions`` ``[B, T]`` (in place) and return the attention output
    ``[B, T, H, D]``. A CUDA ``q`` runs the kernel for the cache's
    dtype; a CPU ``q`` runs exactly ``cache.update`` +
    ``cached_attention``."""
    spec = cache.spec
    if q.device.type == "cpu":
        k_full, v_full, valid = cache.update(layer, k_new, v_new,
                                             positions)
        return cached_attention(q, k_full, v_full, valid)
    if not q.is_cuda:
        raise ValueError(f"no append+attend kernel for device {q.device}")
    compute = spec.compute_dtype or torch.float32
    if q.dtype != compute:
        raise ValueError(f"q dtype {q.dtype} differs from the cache's "
                         f"compute dtype {compute}")
    bufs = cache.buffers
    if spec.dtype == "int8":
        return append_attend_int8_cuda(
            q, bufs["k"][:, layer], bufs["k_scale"][:, layer],
            bufs["v"][:, layer], bufs["v_scale"][:, layer], k_new, v_new,
            positions, spec.resolved_block)
    return append_attend_cuda(q, bufs["k"][:, layer], bufs["v"][:, layer],
                              k_new, v_new, positions)
