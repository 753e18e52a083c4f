"""Producer-side pack epilogues of the reduce-scatter: the bucket pack
(B6) and the matmul whose output lands in the ring rows (B15), as
hand-written CUDA kernels beside their plain PyTorch versions.

The counterpart of section (b) of the JAX package's
``ops/pallas_collectives.py`` (``pack_rows_fused``, ``maybe_pack_rows``,
``_matmul_pack``, ``matmul_reduce_scatter``). Its other two sections
are ``ops/quantized_collectives.py`` (B11-B14) and
``ops/decode_attention.py`` (B16, B17).

* ``pack_rows`` (B6, ``_pack_kernel``): a flat bucket of L elements to
  the ``(n, k)`` rows of the reduce-scatter, ``k = ceil(L / n)``, row r
  being rank r's shard: the bucket followed by ``n * k - L`` zeros,
  bitwise. Plain version: ``optim.zero._pad_rows``.
* ``matmul_pack`` (B15, ``_matmul_pack_kernel``): ``a @ b`` with
  float32 accumulation written straight into the ``(n, k)`` rows of the
  ``[M, N]`` product, ``k = ceil(M * N / n)``, the tail zero; bf16 on
  the tensor cores (``wgmma`` fed by TMA), float32 on the CUDA cores.
  Plain version: ``torch.matmul`` of the float32 operands, then
  ``_pad_rows``.

``knobs.fused_collectives`` is read by the JAX package to choose
between its Pallas kernels and plain XLA; in the port it chooses
nothing. A CUDA tensor launches the kernel (or the call raises), a CPU
tensor runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "pack_rows": [_P, _P, _L, _L, _I, _I, _P],
    "matmul_pack": [_P, _P, _P, _I, _I, _I, _L, _I, _I, _P],
}
#: dtype codes of csrc/common.cuh
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# B6's tiling of the aligned copy (csrc/pack_rows.cu): a block copies
# PACK_TILE_UNROLL x PACK_THREADS 16-byte vectors, for callers that
# place cases at its tile boundaries (chip_smoke.py);
# tests/test_torch_zero.py holds each to its ``constexpr``.
PACK_THREADS = 256
PACK_TILE_UNROLL = 2

# B15's tiling, for callers that emulate a kernel skipping one K tile
# (chip_smoke.py); tests/test_torch_matmul_pack.py holds each to its
# ``constexpr`` in csrc/matmul_pack.cu.
#: bf16 (wgmma): output rows and columns of a block (kTileM, kTileN) and
#: the K depth of a stage of its ring (kTileK)
MATMUL_TILE_M = 128
MATMUL_TILE_N = 128
MATMUL_TILE_K = 64
#: float32 (CUDA cores): the K depth of a shared-memory tile (kBK)
MATMUL_F32_TILE_K = 16


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _build.library(name)
    fn = getattr(lib, f"hvd_{name}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    err = fn(*args, device.index, _build.stream_handle(device))
    _build.check(lib, err, name)
    _build.LAUNCHES[name] += 1


def _rows_k(length: int, n: int) -> int:
    n = int(n)
    if n < 1:
        raise ValueError(f"the world size must be >= 1, got {n}")
    return -(-int(length) // n)


# -- B6: the bucket pack ----------------------------------------------------

def pack_rows_ref(bucket: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of B6: ``zero._pad_rows`` of the flattened bucket."""
    from ..optim import zero

    return zero._pad_rows(bucket.reshape(-1), n)


def pack_rows_cuda(bucket: torch.Tensor, n: int) -> torch.Tensor:
    """Launch ``csrc/pack_rows.cu`` (B6): :func:`pack_rows_ref`'s output,
    bitwise, in the bucket's dtype."""
    if not bucket.is_cuda:
        raise ValueError("pack_rows_cuda takes CUDA tensors")
    if not bucket.is_contiguous():
        raise ValueError("pack_rows_cuda takes a contiguous bucket, got "
                         f"strides {bucket.stride()}")
    if bucket.element_size() not in (2, 4) or bucket.is_complex():
        raise ValueError(f"pack_rows_cuda: no kernel for {bucket.dtype}")
    length = bucket.numel()
    k = _rows_k(length, n)
    out = torch.empty(int(n), k, dtype=bucket.dtype, device=bucket.device)
    if out.numel():
        _launch("pack_rows", bucket.device, bucket.data_ptr(),
                out.data_ptr(), length, out.numel(), bucket.element_size())
    return out


def pack_rows_fused(bucket: torch.Tensor, n: int) -> torch.Tensor:
    """Flatten, zero-pad and lay a bucket out as the ``(n, k)`` rows the
    reduce-scatter consumes, in the bucket's dtype: B6 on a CUDA tensor,
    its plain version on a CPU tensor."""
    if bucket.is_cuda:
        return pack_rows_cuda(bucket, n)
    if bucket.device.type != "cpu":
        raise ValueError(f"no pack kernel for device {bucket.device}")
    return pack_rows_ref(bucket, n)


def maybe_pack_rows(bucket: torch.Tensor, n: int) -> torch.Tensor:
    """The pack of the ZeRO optimizer's gradient buckets. The JAX
    package picks its Pallas kernel or ``_pad_rows`` by
    ``knobs.fused_collectives``; here the device picks, and every CUDA
    bucket runs B6."""
    return pack_rows_fused(bucket, n)


# -- B15: the matmul with the ring-row epilogue -----------------------------

def _matmul_operands(a: torch.Tensor, b: torch.Tensor):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(
            "matmul_reduce_scatter takes 2-D operands, got "
            f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_pack: inner dimensions differ, "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")


def matmul_pack_ref(a: torch.Tensor, b: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Plain version of B15: the float32 product of the float32
    operands, laid out by ``_pad_rows``."""
    from ..optim import zero

    _matmul_operands(a, b)
    g = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return zero._pad_rows(g.reshape(-1), n)


def matmul_pack_cuda(a: torch.Tensor, b: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Launch ``csrc/matmul_pack.cu`` (B15): ``a @ b`` accumulated in
    float32, as the float32 ``(n, k)`` ring rows; bf16 operands on the
    tensor cores, float32 on the CUDA cores. Operands of any alignment
    are read in place (TMA where rows are 16-byte aligned, narrower
    copies elsewhere): none is copied to pad it."""
    _matmul_operands(a, b)
    for what, t in (("a", a), ("b", b)):
        if not t.is_cuda:
            raise ValueError("matmul_pack_cuda takes CUDA tensors")
        if t.dtype not in _DTYPE_CODE or not t.is_contiguous():
            raise ValueError(f"matmul_pack_cuda: {what} must be a "
                             "contiguous float32 or bf16 tensor, got "
                             f"{t.dtype} strides {t.stride()}")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"matmul_pack_cuda: operands {a.dtype} on "
                         f"{a.device} and {b.dtype} on {b.device}")
    m, kdim = a.shape
    ncols = b.shape[1]
    size = m * ncols
    k = _rows_k(size, n)
    out = torch.empty(int(n), k, dtype=torch.float32, device=a.device)
    if size:
        if max(m, ncols, kdim) >= 2 ** 31:
            raise ValueError("matmul_pack_cuda: a dimension >= 2^31")
        _launch("matmul_pack", a.device, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, ncols, kdim, out.numel(),
                _DTYPE_CODE[a.dtype])
    else:
        out.zero_()
    return out


def matmul_pack(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """``a @ b`` (float32 accumulation) packed into the ``(n, k)`` ring
    rows: B15 on CUDA tensors, its plain version on CPU tensors."""
    if a.is_cuda:
        return matmul_pack_cuda(a, b, n)
    if a.device.type != "cpu":
        raise ValueError(f"no matmul-pack kernel for device {a.device}")
    return matmul_pack_ref(a, b, n)


def matmul_reduce_scatter(a: torch.Tensor, b: torch.Tensor, n: int,
                          wire=None, residual=None):
    """A gradient matmul into the ZeRO reduce-scatter: ``a @ b`` lands in
    the ``(n, k)`` ring rows (B15) and the rows go to
    ``zero._scatter_bucket`` on ``wire`` (None: float32; a cast wire; the
    int8 wire, with this rank's ``residual`` when given), which returns
    this rank's averaged ``(k,)`` shard, or ``(shard, new_residual)``
    with a residual. ``n`` is the world size."""
    from ..optim import zero

    _matmul_operands(a, b)
    rows = matmul_pack(a, b, n)
    return zero._scatter_bucket(rows, n, wire, residual=residual)
