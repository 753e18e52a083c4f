"""Per-block symmetric int8 quantization (the block math only).

The PyTorch twin of the shape-polymorphic helpers in the JAX package's
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

from typing import Tuple

import torch

_RECIP_127 = 1.0 / 127.0


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
