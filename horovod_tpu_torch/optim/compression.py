"""Wire compression of the gradient reduction, and the per-block int8
quantization math.

``Compression`` mirrors the JAX package's namespace: ``none`` (the
identity), ``fp16`` and ``bf16`` (cast floating tensors for the wire and
back). The int8 wire with error feedback (``Compression.int8``,
``HOROVOD_COMPRESSION=int8``) is not ported yet and raises
``NotImplementedError`` rather than running uncompressed.

The block math below is the PyTorch twin of the shape-polymorphic helpers in the JAX package's
``optim/compression.py``: the int8 KV cache stores exactly these codes
and scales, and they are bitwise equal to the JAX package's for the
same float32 input (tests/test_torch_kernels.py).

Two details carry that parity:

* the scale is ``amax * (1.0 / 127.0)``, a multiply by the float32
  reciprocal constant and not a division by 127 (the JAX package pins
  this form because XLA rewrites constant divisions inside compiled
  programs);
* the codes are ``round(x / scale)`` with a true, correctly rounded
  division and round-half-to-even (``torch.round`` like ``jnp.round``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_RECIP_127 = 1.0 / 127.0

_INT8_NOT_PORTED = ("the int8 wire with error feedback is not ported yet "
              "(ROADMAP item 8)")


class NoneCompressor:
    """Identity."""

    kind = "none"

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor:
    """Cast floating tensors to float16 on the wire."""

    kind = "fp16"
    wire_dtype = torch.float16

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class BF16Compressor(FP16Compressor):
    """Cast floating tensors to bfloat16 on the wire."""

    kind = "bf16"
    wire_dtype = torch.bfloat16


class Int8Compressor:
    """Placeholder of the int8 wire: using it raises."""

    kind = "int8"

    @staticmethod
    def compress(tensor):
        raise NotImplementedError(_INT8_NOT_PORTED)

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError(_INT8_NOT_PORTED)


_BY_NAME = {"": NoneCompressor, "none": NoneCompressor,
            "off": NoneCompressor, "0": NoneCompressor,
            "fp16": FP16Compressor, "float16": FP16Compressor,
            "bf16": BF16Compressor, "bfloat16": BF16Compressor}


class Compression:
    """``hvd.Compression``: ``none``, ``fp16``, ``bf16`` (and ``int8``,
    which raises until it is ported)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor

    @staticmethod
    def lookup(name: Optional[str]):
        """The compressor of a ``HOROVOD_COMPRESSION`` value; raises on
        the int8 kinds (not ported) and on unknown names."""
        key = (name or "").strip().lower()
        if key in ("int8", "int8-raw", "int8_raw"):
            raise NotImplementedError(f"HOROVOD_COMPRESSION={name}: "
                                      f"{_INT8_NOT_PORTED}")
        try:
            return _BY_NAME[key]
        except KeyError:
            raise ValueError(f"unknown HOROVOD_COMPRESSION value {name!r}; "
                             "expected one of none, fp16, bf16") from None

    @classmethod
    def from_knobs(cls, knobs=None):
        """The compressor the ``compression`` knob selects."""
        if knobs is None:
            from ..core.knobs import Knobs
            knobs = Knobs.from_env()
        return cls.lookup(knobs.compression)


def check_compressor(compression) -> None:
    """Raise if ``compression`` is the int8 wire (not ported)."""
    if getattr(compression, "kind", "none") == "int8":
        raise NotImplementedError(_INT8_NOT_PORTED)


def _pad_flat(flat: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad a 1-D tensor so ``multiple`` divides its length."""
    rem = flat.shape[0] % multiple
    if rem:
        flat = torch.cat([flat, flat.new_zeros(multiple - rem)])
    return flat


def block_scales(blocks: torch.Tensor) -> torch.Tensor:
    """Per-block scales for a ``(..., block)`` float32 tensor:
    ``amax/127`` as a reciprocal multiply, all-zero blocks pinned to 1
    so the divide is always defined. Returns shape ``(...,)``."""
    amax = blocks.abs().amax(dim=-1)
    one = torch.ones((), dtype=amax.dtype, device=amax.device)
    return torch.where(amax > 0, amax * _RECIP_127, one)


def block_quantize(blocks: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Quantize a ``(..., block)`` float32 tensor to ``(q int8 (...,
    block), scales float32 (...))`` with ``x ≈ q * scale`` per block."""
    scale = block_scales(blocks)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def block_dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`block_quantize` (float32, same shape as ``q``)."""
    return q.to(torch.float32) * scales.to(torch.float32)[..., None]


def quantize_blocks(flat: torch.Tensor, block: int) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """Quantize a 1-D tensor whose length is a multiple of ``block``.
    Returns ``(q int8 [m], scales float32 [m/block])``."""
    q, scale = block_quantize(flat.to(torch.float32).reshape(-1, block))
    return q.reshape(-1), scale


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      block: int) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks` (float32 output)."""
    return block_dequantize(q.reshape(-1, block), scales).reshape(-1)
