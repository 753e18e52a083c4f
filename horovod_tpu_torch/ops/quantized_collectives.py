"""The int8 wire's collectives: quantize, exchange, dequantize-accumulate,
requantize, gather, dequantize, with the four stages as hand-written
CUDA kernels and their plain PyTorch versions.

The counterpart of the quantize-in-collective third of the JAX
package's ``ops/pallas_collectives.py`` (``fused_quantized_psum``,
``fused_quantized_reduce_scatter_rows``). Its decode third is
``ops/decode_attention.py``, and the bucket pack and the matmul
epilogue of the ZeRO reduce-scatter (B6, B15) are ``ops/ring_pack.py``.

The four kernels, one ``csrc/*.cu`` source each (shared math in
``csrc/quant.cuh``), and what they replace:

* ``quant_rows`` (B11, ``_quant_kernel``): per-block symmetric int8
  quantize, ``scale = amax * (1/127)`` (1 for an all-zero block),
  ``code = clip(round(x / scale), -127, 127)``. It also zero-pads the
  payload to the row layout, which the JAX package does before its
  kernel;
* ``quant_ef_rows`` (B12, ``_quant_ef_kernel``): B11 on ``x + residual``
  (the error-feedback add, also done before the JAX kernel), and the new
  residual ``x + residual - code * scale``;
* ``accum_rows`` (B13, ``_accum_kernel``): dequantize the n ranks'
  shards and sum them in float32, in rank order; 16 codes a thread
  with 16-byte loads where :func:`accum_route` allows it, else one;
* ``dequant_flat`` (B14, ``_dequant_kernel``): ``code * scale``, the
  first ``length`` elements.

Rounding, and why two steps are fused multiply-adds: the JAX package
runs these kernels on the CPU (its reference) through XLA, which
contracts the dequantize multiply into the subtraction of the residual
and into the running sum over ranks: ``e = fma(-code, scale, x)`` and
``acc = fma(code_r, scale_r, acc)``, each rounded once. The kernels use
``__fmaf_rn`` at exactly those two points and separate IEEE roundings
everywhere else, and the plain versions compute the same fused steps
exactly (:func:`_fma`), so kernel, plain version and the JAX package
agree bit for bit (tests/test_torch_quantized_collectives.py). Rounding
the product first would change the last bit of most residuals.

:func:`fused_quantized_psum` is three stage functions around two
exchanges. The exchanges run on ``torch.distributed``; a world emulated
on one card (``chip_smoke.py``) composes the same stage functions with
slicing in place of the exchanges:

1. :func:`stage_quantize` ``(flat, residual) -> (q, s, err)``: pad,
   error-feedback add, B12 (or B11 without a residual);
2. all-to-all of codes and scales: rank r receives every rank's chunk
   r, in rank order;
3. :func:`stage_reduce` ``(qg, sg) -> (q3, s3)``: B13, then B11 on the
   reduced shard;
4. all-gather of codes and scales;
5. :func:`stage_dequantize` ``(qa, sa, L) -> y``: B14 on the first L
   elements.

Dispatch is by device: a CUDA tensor launches the kernel (or the call
raises), a CPU tensor runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ..optim.compression import (_positive_block, block_dequantize,
                                 block_quantize)
from . import _build
from .collectives import _all_gather_tiled, _all_to_all_tiled

# -- plain versions ---------------------------------------------------------


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, for float32 ``a``, ``b``,
    ``c`` where ``a`` holds int8 codes (so ``a * b`` is exact in
    float64). The float64 sum is made round-to-odd (TwoSum gives its
    error exactly), and rounding that to float32 is the correctly
    rounded result, since float64 keeps more than 2 x 24 + 2 bits."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    pv = s - cd
    cv = s - pv
    err = (p - pv) + (cd - cv)
    bits = s.view(torch.int64)
    inexact = err != 0
    # the neighbour toward zero when the exact sum is smaller in
    # magnitude than s, then the odd one of the two neighbours
    bits = torch.where(inexact & ((err < 0) != (s < 0)), bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(torch.float64).to(torch.float32)


def _padded(n: int, length: int, block: int) -> int:
    """Row length C of ``length`` elements laid out as ``n`` rows of
    whole blocks: the payload zero-padded to a multiple of n * block."""
    return -(-length // (n * block)) * block


def _payload(x: torch.Tensor, residual: Optional[torch.Tensor], n: int,
             block: int) -> torch.Tensor:
    v = x if residual is None else x + residual
    pad = n * _padded(n, v.numel(), block) - v.numel()
    return torch.cat([v, v.new_zeros(pad)]) if pad else v


def quantize_rows_ref(x: torch.Tensor, n: int, block: int):
    """Plain version of B11: the float32 payload ``x`` (1-D) zero-padded
    and laid out as ``n`` rows of C elements, quantized per block:
    ``(q int8 (n, C), scales float32 (n, C / block))``."""
    rows = _payload(x, None, n, block).reshape(n, -1, block)
    q, s = block_quantize(rows)
    return q.reshape(n, -1), s


def quantize_ef_rows_ref(x: torch.Tensor, residual: torch.Tensor, n: int,
                         block: int):
    """Plain version of B12: B11 on ``x + residual``, and the new
    residual ``(x + residual) - q * scale`` (one rounding) of the first
    ``x.numel()`` elements: ``(q, scales, err (L,))``."""
    v = _payload(x, residual, n, block).reshape(n, -1, block)
    q, s = block_quantize(v)
    err = _fma(-q.to(torch.float32), s[..., None].expand(v.shape), v)
    return q.reshape(n, -1), s, err.reshape(-1)[:x.numel()]


def accum_rows_ref(q: torch.Tensor, s: torch.Tensor,
                   block: int) -> torch.Tensor:
    """Plain version of B13: ``(n, C)`` codes and ``(n, C / block)``
    scales to the float32 ``(C,)`` sum over the rows, in row order,
    each step ``acc = code * scale + acc`` rounded once."""
    n, c = q.shape
    acc = torch.zeros(c, dtype=torch.float32, device=q.device)
    for r in range(n):
        scale = s[r].repeat_interleave(block)
        acc = _fma(q[r].to(torch.float32), scale, acc)
    return acc


def dequantize_flat_ref(q: torch.Tensor, s: torch.Tensor, block: int,
                        length: Optional[int] = None) -> torch.Tensor:
    """Plain version of B14: the first ``length`` (default all) of the
    float32 values ``code * scale``."""
    y = block_dequantize(q.reshape(-1, block), s).reshape(-1)
    return y if length is None else y[:length]


# -- kernel wrappers --------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "quant_rows": [_P, _L, _P, _P, _L, _I, _I, _P],
    "quant_ef_rows": [_P, _P, _L, _P, _P, _P, _L, _I, _I, _P],
    "accum_rows": [_P, _P, _P, _I, _L, _I, _I, _I, _P],
    "dequant_flat": [_P, _P, _P, _L, _I, _I, _P],
}


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _build.library(name)
    fn = getattr(lib, f"hvd_{name}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    err = fn(*args, device.index, _build.stream_handle(device))
    _build.check(lib, err, name)
    _build.count_launch(name)


def _check(what: str, t: torch.Tensor, dtype: torch.dtype,
           numel: Optional[int] = None, device=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what} takes a contiguous {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{what}: expected {numel} elements, got "
                         f"{t.numel()}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: tensor on {t.device}, expected {device}")


#: codes a thread of B13's vector route sums with one 16-byte load a rank
#: (``kCodes`` in csrc/accum_rows.cu)
ACCUM_CODES = 16


def accum_route(q: torch.Tensor, s: torch.Tensor, out: torch.Tensor,
                block: int) -> int:
    """Codes a thread of B13 sums for codes ``q`` ``(n, C)``, scales
    ``s`` and output ``out``: ACCUM_CODES (the vector route: 16-byte
    loads of a rank's codes, one scale load a rank, 16-byte stores) when
    C and ``block`` are multiples of it and ``q`` and ``out`` start
    16-byte aligned, else 1 (one element a thread). The scales are read
    one at a time on either route."""
    c = q.shape[-1]
    ok = (c % ACCUM_CODES == 0 and block % ACCUM_CODES == 0
          and q.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    return ACCUM_CODES if ok else 1


def quantize_rows_cuda(x: torch.Tensor, n: int, block: int):
    """Launch ``csrc/quant_rows.cu`` (B11): :func:`quantize_rows_ref`'s
    output, bitwise."""
    block = _positive_block(block, "quantize_rows_cuda")
    _check("quantize_rows_cuda", x, torch.float32)
    c = _padded(n, x.numel(), block)
    q = torch.empty(n, c, dtype=torch.int8, device=x.device)
    s = torch.empty(n, c // block, dtype=torch.float32, device=x.device)
    if q.numel():
        _launch("quant_rows", x.device, x.data_ptr(), x.numel(),
                q.data_ptr(), s.data_ptr(), q.numel(), block)
    return q, s


def quantize_ef_rows_cuda(x: torch.Tensor, residual: torch.Tensor, n: int,
                          block: int):
    """Launch ``csrc/quant_ef_rows.cu`` (B12): :func:`quantize_ef_rows_ref`'s
    output, bitwise."""
    block = _positive_block(block, "quantize_ef_rows_cuda")
    _check("quantize_ef_rows_cuda", x, torch.float32)
    _check("quantize_ef_rows_cuda (residual)", residual, torch.float32,
           x.numel(), x.device)
    c = _padded(n, x.numel(), block)
    q = torch.empty(n, c, dtype=torch.int8, device=x.device)
    s = torch.empty(n, c // block, dtype=torch.float32, device=x.device)
    err = torch.empty(x.numel(), dtype=torch.float32, device=x.device)
    if q.numel():
        _launch("quant_ef_rows", x.device, x.data_ptr(), residual.data_ptr(),
                x.numel(), q.data_ptr(), s.data_ptr(), err.data_ptr(),
                q.numel(), block)
    return q, s, err


def accum_rows_cuda(q: torch.Tensor, s: torch.Tensor,
                    block: int) -> torch.Tensor:
    """Launch ``csrc/accum_rows.cu`` (B13): :func:`accum_rows_ref`'s
    output, bitwise."""
    block = _positive_block(block, "accum_rows_cuda")
    _check("accum_rows_cuda", q, torch.int8)
    n, c = q.shape
    if c % block:
        raise ValueError(f"accum_rows_cuda: block {block} does not divide "
                         f"the row length {c}")
    _check("accum_rows_cuda (scales)", s, torch.float32, n * (c // block),
           q.device)
    out = torch.empty(c, dtype=torch.float32, device=q.device)
    if c:
        _launch("accum_rows", q.device, q.data_ptr(), s.data_ptr(),
                out.data_ptr(), n, c, block, accum_route(q, s, out, block))
    return out


def dequantize_flat_cuda(q: torch.Tensor, s: torch.Tensor, block: int,
                         length: Optional[int] = None) -> torch.Tensor:
    """Launch ``csrc/dequant_flat.cu`` (B14): :func:`dequantize_flat_ref`'s
    output, bitwise."""
    block = _positive_block(block, "dequantize_flat_cuda")
    _check("dequantize_flat_cuda", q, torch.int8)
    m = q.numel()
    if m % block:
        raise ValueError(f"dequantize_flat_cuda: block {block} does not "
                         f"divide {m}")
    _check("dequantize_flat_cuda (scales)", s, torch.float32, m // block,
           q.device)
    length = m if length is None else int(length)
    if not 0 <= length <= m:
        raise ValueError(f"dequantize_flat_cuda: length {length} outside "
                         f"[0, {m}]")
    out = torch.empty(length, dtype=torch.float32, device=q.device)
    if length:
        _launch("dequant_flat", q.device, q.data_ptr(), s.data_ptr(),
                out.data_ptr(), length, block)
    return out


def _pick(t: torch.Tensor, cuda_fn: Callable, ref_fn: Callable) -> Callable:
    if t.is_cuda:
        return cuda_fn
    if t.device.type != "cpu":
        raise ValueError(f"no int8-wire kernel for device {t.device}")
    return ref_fn


def quantize_rows(x, n, block):
    """B11 on a CUDA tensor, its plain version on a CPU tensor."""
    return _pick(x, quantize_rows_cuda, quantize_rows_ref)(x, n, block)


def quantize_ef_rows(x, residual, n, block):
    """B12 on a CUDA tensor, its plain version on a CPU tensor."""
    return _pick(x, quantize_ef_rows_cuda, quantize_ef_rows_ref)(
        x, residual, n, block)


def accum_rows(q, s, block):
    """B13 on a CUDA tensor, its plain version on a CPU tensor."""
    return _pick(q, accum_rows_cuda, accum_rows_ref)(q, s, block)


def dequantize_flat(q, s, block, length=None):
    """B14 on a CUDA tensor, its plain version on a CPU tensor."""
    return _pick(q, dequantize_flat_cuda, dequantize_flat_ref)(
        q, s, block, length)


# -- the stages -------------------------------------------------------------

def stage_quantize(flat: torch.Tensor, residual: Optional[torch.Tensor],
                   n: int, block: int):
    """Stage 1 of :func:`fused_quantized_psum` on one rank: the float32
    payload ``flat`` (1-D, L elements), plus ``residual`` when given,
    zero-padded to ``n`` rows of whole blocks and quantized. Returns
    ``(q int8 (m,), scales (m / block,), err)``: the flat row-major
    codes and scales (chunk r of each goes to rank r) and the new
    residual ``(L,)``, or None without a residual."""
    if residual is None:
        q, s = quantize_rows(flat, n, block)
        err = None
    else:
        q, s, err = quantize_ef_rows(flat, residual.reshape(-1), n, block)
    return q.reshape(-1), s.reshape(-1), err


def stage_reduce(qg: torch.Tensor, sg: torch.Tensor, n: int, block: int):
    """Stage 2 on one rank: ``qg``, ``sg`` hold every rank's chunk of
    this rank's shard, in rank order (the all-to-all's output).
    Dequantize-accumulate them (B13) and requantize the float32 shard
    (B11). Returns the shard's flat ``(q, scales)``."""
    c = qg.numel() // n
    shard = accum_rows(qg.reshape(n, c), sg.reshape(n, c // block), block)
    q, s = quantize_rows(shard, 1, block)
    return q.reshape(-1), s.reshape(-1)


def stage_dequantize(qa: torch.Tensor, sa: torch.Tensor, length: int,
                     block: int) -> torch.Tensor:
    """Stage 3: the gathered codes and scales of every shard, in rank
    order, to the float32 sum's first ``length`` elements (B14)."""
    return dequantize_flat(qa, sa, block, length)


def start_quantized_psum(flat: torch.Tensor, n: int, block: int,
                         residual: Optional[torch.Tensor] = None,
                         group=None):
    """Enqueue :func:`fused_quantized_psum` on a flat float32 payload up
    to its gathers: stage 1, the all-to-alls, stage 2, the all-gathers,
    over the ``n`` ranks of ``group`` (default: the world). Returns
    ``(finish, err)``: ``finish()`` waits for the gathers and returns
    the float32 sum ``(L,)`` (stage 3); ``err`` is the new residual
    (None without one). With NCCL nothing here blocks the host: a wait
    only orders the current stream after the exchange."""
    q, s, err = stage_quantize(flat, residual, n, block)
    if flat.is_cuda:
        _build.note_surface("quantized_psum")
    (qg, wq), (sg, ws) = (_all_to_all_tiled(q, group),
                          _all_to_all_tiled(s, group))
    wq.wait()
    ws.wait()
    q3, s3 = stage_reduce(qg, sg, n, block)
    (qa, wq), (sa, ws) = (_all_gather_tiled(q3, n, group),
                          _all_gather_tiled(s3, n, group))
    length = flat.numel()

    def finish() -> torch.Tensor:
        wq.wait()
        ws.wait()
        return stage_dequantize(qa, sa, length, block)

    return finish, err


def fused_quantized_psum(x: torch.Tensor, n: int, block: int,
                         residual: Optional[torch.Tensor] = None):
    """The int8 SUM of ``x`` over the world's ``n`` ranks (validated by
    ``optim.compression.quantized_psum``, which calls this). Returns
    ``y`` in ``x``'s shape and dtype, or ``(y, new_residual)`` with a
    residual."""
    flat = x.reshape(-1).to(torch.float32).contiguous()
    res = None if residual is None else \
        residual.reshape(-1).to(torch.float32).contiguous()
    finish, err = start_quantized_psum(flat, n, block, res)
    y = finish().reshape(x.shape).to(x.dtype)
    if residual is None:
        return y
    return y, err.reshape(x.shape)


def fused_quantized_reduce_scatter_rows(
        rows_f: torch.Tensor, n: int, k: int, block: int,
        residual: Optional[torch.Tensor] = None):
    """The int8 reduce-scatter of a float32 ``(n, k2)`` row stack, padded
    to whole blocks by the caller (``optim.compression.
    quantized_reduce_scatter_rows``). Returns this rank's shard ``[:k]``,
    or ``(shard, new_residual (n, k2))`` with a residual."""
    k2 = rows_f.shape[1]
    q, s, err = stage_quantize(rows_f.reshape(-1), residual, n, block)
    if rows_f.is_cuda:
        _build.note_surface("reduce_scatter_rows")
    (qg, wq), (sg, ws) = _all_to_all_tiled(q), _all_to_all_tiled(s)
    wq.wait()
    ws.wait()
    shard = accum_rows(qg.reshape(n, k2), sg.reshape(n, k2 // block), block)
    if residual is None:
        return shard[:k]
    return shard[:k], err.reshape(n, k2)


def emulated_quantized_psum(flats, n: int, block: int, residuals=None):
    """:func:`fused_quantized_psum` of ``n`` ranks' flat float32 payloads
    in one process: the same stage functions, with the all-to-all as
    slicing (rank r receives chunk r of every rank, in rank order) and
    the all-gather as a concatenation. Returns ``(sums, errs)``: each
    rank's float32 sum (L,) and new residual (None without residuals)."""
    residuals = residuals or [None] * n
    outs = [stage_quantize(f, r, n, block)
            for f, r in zip(flats, residuals)]
    if flats[0].is_cuda:
        _build.note_surface("quantized_psum")
    c = outs[0][0].numel() // n
    cs = c // block
    shards = [stage_reduce(
        torch.cat([q[r * c:(r + 1) * c] for q, _, _ in outs]),
        torch.cat([s[r * cs:(r + 1) * cs] for _, s, _ in outs]), n, block)
        for r in range(n)]
    qa = torch.cat([q for q, _ in shards])
    sa = torch.cat([s for _, s in shards])
    length = flats[0].numel()
    return ([stage_dequantize(qa, sa, length, block) for _ in range(n)],
            [e for _, _, e in outs])



def emulated_quantized_reduce_scatter_rows(rows_fs, n: int, block: int,
                                           residuals=None):
    """:func:`fused_quantized_reduce_scatter_rows` of ``n`` ranks' float32
    ``(n, k2)`` row stacks (padded to whole blocks) in one process: stage
    1 per rank (B11, or B12 with that rank's ``(n, k2)`` residual), the
    all-to-all as slicing (rank r receives row r of every rank, in rank
    order), B13 per rank. Returns each rank's float32 SUM shard
    ``(k2,)``, and with ``residuals`` ``(sums, new_residuals)``."""
    k2 = rows_fs[0].shape[1]
    cs = k2 // block
    res = residuals or [None] * n
    outs = [stage_quantize(r.reshape(-1), e, n, block)
            for r, e in zip(rows_fs, res)]
    if rows_fs[0].is_cuda:
        _build.note_surface("reduce_scatter_rows")
    sums = []
    for r in range(n):
        qg = torch.cat([q[r * k2:(r + 1) * k2] for q, _, _ in outs])
        sg = torch.cat([s[r * cs:(r + 1) * cs] for _, s, _ in outs])
        sums.append(accum_rows(qg.reshape(n, k2), sg.reshape(n, cs), block))
    if residuals is None:
        return sums
    return sums, [e.reshape(n, k2) for _, _, e in outs]
