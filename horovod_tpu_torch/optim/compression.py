"""Wire compression of the gradient reduction, and the per-block int8
quantization math.

The counterpart of the JAX package's ``optim/compression.py``:

* **cast compressors** (``Compression.fp16``, ``.bf16``): the payload
  is cast for the wire and back;
* **the int8 wire** (``Compression.int8``, ``HOROVOD_COMPRESSION=int8``):
  block-quantized int8 with one float32 scale per block of
  ``HOROVOD_COMPRESSION_BLOCK`` elements (256). An int8 payload cannot
  be summed on the wire, so the collective changes shape
  (:func:`quantized_psum`, the EQuARX structure): quantize, exchange
  shards (all-to-all), dequantize and accumulate the shard locally,
  requantize it, all-gather, dequantize. About a quarter of the float32
  bytes move on each leg. With **error feedback** each rank adds the
  quantization error of its last contribution to the next one, so the
  compressed SUM stays unbiased over steps; ``int8-raw``
  (``Compression.int8_raw``) drops the residual;
* :class:`WireSpec`, the description of the active wire, parsed from the
  knobs, and the wire's byte accounting (:func:`wire_sent_bytes`).

The quantize, quantize + error feedback, dequantize-accumulate and
dequantize stages of the collectives are hand-written CUDA kernels
(``ops/quantized_collectives.py``); the block math below is their plain
definition, the PyTorch twin of the JAX package's shape-polymorphic
helpers. The int8 KV cache stores exactly these codes and scales, and
they are bitwise equal to the JAX package's for the same float32 input
(tests/test_torch_kernels.py, tests/test_torch_quantized_collectives.py).

Two details carry that parity:

* the scale is ``amax * (1.0 / 127.0)``, a multiply by the float32
  reciprocal constant and not a division by 127 (the JAX package pins
  this form because XLA rewrites constant divisions inside compiled
  programs);
* the codes are ``round(x / scale)`` with a true, correctly rounded
  division and round-half-to-even (``torch.round`` like ``jnp.round``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_RECIP_127 = 1.0 / 127.0

DEFAULT_BLOCK = 256
_SCALE_BYTES = 4  # one float32 scale per block


def _knobs():
    from ..core.knobs import Knobs
    from ..core.state import global_state

    st = global_state()
    return st.knobs if st.initialized else Knobs.from_env()


class NoneCompressor:
    """Identity."""

    kind = "none"
    error_feedback = False

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
    error_feedback = False

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


class Int8BlockCompressor:
    """Block-quantized int8 payload with per-block float32 scales.

    ``compress``/``decompress`` are the point-to-point form (a round
    trip). A SUM must not add int8 payloads: the optimizer and
    :func:`quantized_psum` quantize, reduce in float32 and requantize."""

    kind = "int8"
    error_feedback = True
    # 0: HOROVOD_COMPRESSION_BLOCK at use; a subclass may pin a block
    block = 0

    @classmethod
    def resolved_block(cls) -> int:
        if cls.block and cls.block > 0:
            return int(cls.block)
        return int(_knobs().compression_block or DEFAULT_BLOCK)

    @classmethod
    def compress(cls, tensor):
        if not tensor.is_floating_point():
            return tensor, None
        block = cls.resolved_block()
        flat = tensor.to(torch.float32).reshape(-1)
        q, s = quantize_blocks(_pad_flat(flat, block), block)
        return q, (s, tensor.dtype, tuple(tensor.shape), flat.shape[0],
                   block)

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is None:
            return tensor
        # the block rides the ctx, so a knob change between compress and
        # decompress cannot move the grid
        scales, dtype, shape, n, block = ctx
        out = dequantize_blocks(tensor, scales, block)[:n]
        return out.reshape(shape).to(dtype)


class Int8BlockRawCompressor(Int8BlockCompressor):
    """The int8 wire without error feedback (its quantization bias
    accumulates over steps): for A/B runs and debugging."""

    error_feedback = False


# -- the wire spec -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WireSpec:
    """What moves on the wire for floating SUM/AVERAGE reductions:
    ``kind`` in {"fp16", "bf16", "int8"}, ``block`` the int8 scale
    granularity, ``error_feedback`` whether residuals carry across
    steps. ``None`` stands for the uncompressed wire."""

    kind: str
    block: int = DEFAULT_BLOCK
    error_feedback: bool = False

    @property
    def key(self) -> tuple:
        return (self.kind, self.block, self.error_feedback)

    @property
    def wire_dtype(self) -> torch.dtype:
        return {"fp16": torch.float16, "bf16": torch.bfloat16,
                "int8": torch.int8}[self.kind]

    def describe(self) -> str:
        """``bf16``, ``int8 block 256 ef``, ``int8 block 256 raw``."""
        if self.kind != "int8":
            return self.kind
        return (f"int8 block {self.block} "
                f"{'ef' if self.error_feedback else 'raw'}")


_LEGACY_WIRE_NAMES = {"bfloat16": "bf16", "float16": "fp16",
                      "bf16": "bf16", "fp16": "fp16"}


def parse_wire(name: Optional[str], block: int = 0) -> Optional[WireSpec]:
    """A ``HOROVOD_COMPRESSION`` value as a :class:`WireSpec` (None for
    the uncompressed wire); raises on unknown names, so a misspelt knob
    fails instead of training uncompressed."""
    name = (name or "").strip().lower()
    block = int(block) if block and int(block) > 0 else DEFAULT_BLOCK
    if name in ("", "none", "off", "0"):
        return None
    if name in _LEGACY_WIRE_NAMES:
        return WireSpec(_LEGACY_WIRE_NAMES[name], block)
    if name == "int8":
        return WireSpec("int8", block, error_feedback=True)
    if name in ("int8-raw", "int8_raw"):
        return WireSpec("int8", block, error_feedback=False)
    raise ValueError(
        f"unknown HOROVOD_COMPRESSION value {name!r}; expected one of "
        "none, fp16, bf16, int8, int8-raw")


def resolve_wire(knobs=None) -> Optional[WireSpec]:
    """The active wire: ``knobs``, else the initialized knobs, else the
    environment. The legacy ``HOROVOD_COMPRESSION_WIRE_DTYPE`` names a
    cast wire when ``HOROVOD_COMPRESSION`` is unset."""
    knobs = _knobs() if knobs is None else knobs
    name = knobs.compression
    if name in ("", "none") and knobs.compression_wire_dtype:
        name = knobs.compression_wire_dtype
    return parse_wire(name, knobs.compression_block)


def wire_applies(spec: Optional[WireSpec], dtype: torch.dtype) -> bool:
    """True when ``spec`` transforms payloads of ``dtype``: only floating
    payloads are compressed; integer buckets move as they are."""
    return spec is not None and dtype.is_floating_point


def wire_sent_bytes(n_elements: int, logical_itemsize: int,
                    spec: Optional[WireSpec]) -> int:
    """Bytes one contribution of ``n_elements`` takes on the wire under
    ``spec`` (payload and scales), against ``n_elements *
    logical_itemsize`` uncompressed."""
    if spec is None:
        return int(n_elements) * int(logical_itemsize)
    if spec.kind in ("fp16", "bf16"):
        return int(n_elements) * 2
    padded = -(-int(n_elements) // spec.block) * spec.block
    return padded + (padded // spec.block) * _SCALE_BYTES


def compressor_wire_spec(compression) -> Optional[WireSpec]:
    """The :class:`WireSpec` of a compressor class (None for the
    identity)."""
    kind = getattr(compression, "kind", "none")
    if kind == "none":
        return None
    block = int(getattr(compression, "block", 0) or 0)
    if block <= 0:
        block = int(_knobs().compression_block or DEFAULT_BLOCK)
    return WireSpec(kind, block,
                    bool(getattr(compression, "error_feedback", False)))


class Compression:
    """``hvd.Compression``: ``none``, ``fp16``, ``bf16``, ``int8`` (with
    error feedback) and ``int8_raw``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8BlockCompressor
    int8_raw = Int8BlockRawCompressor

    _BY_KIND = {"none": NoneCompressor, "fp16": FP16Compressor,
                "bf16": BF16Compressor, "int8": Int8BlockCompressor}

    @classmethod
    def _of(cls, spec: Optional[WireSpec]):
        if spec is None:
            return NoneCompressor
        if spec.kind == "int8" and not spec.error_feedback:
            return Int8BlockRawCompressor
        return cls._BY_KIND[spec.kind]

    @classmethod
    def lookup(cls, name: Optional[str]):
        """The compressor of a ``HOROVOD_COMPRESSION`` value; raises on
        unknown names."""
        return cls._of(parse_wire(name))

    @classmethod
    def from_knobs(cls, knobs=None):
        """The compressor the knobs select (``HOROVOD_COMPRESSION``, or
        the legacy ``HOROVOD_COMPRESSION_WIRE_DTYPE``): what a
        ``compression=None`` DistributedOptimizer takes."""
        return cls._of(resolve_wire(knobs))


# -- the quantized collectives ------------------------------------------------

def _positive_block(block, what: str) -> int:
    block = int(block)
    if block <= 0:
        raise ValueError(f"{what}: quantization block must be a positive "
                         f"int, got {block}")
    return block


def _check_block(block, length: int, what: str) -> int:
    """A quantization block: a positive int that divides ``length`` (the
    padded payload). A block that does not divide it would pad a payload
    the caller already padded to its own layout, moving the block grid
    away from the residual's, so it is refused."""
    block = _positive_block(block, what)
    if length % block:
        raise ValueError(
            f"{what}: block {block} does not divide the padded payload "
            f"length {length} — the caller's row/residual layout and "
            f"the wire's block grid would disagree (silently padding "
            f"again would double-pad; fix the block or the layout)")
    return block


def _check_world(n: int, what: str, process_set) -> None:
    from ..core.basics import _require_init
    from ..core.process_sets import require_global

    require_global(process_set)
    size = _require_init().size
    if int(n) != size:
        raise ValueError(f"{what}: n={n} but the world has {size} ranks")


def quantized_psum(x: torch.Tensor, n: int, block: int = DEFAULT_BLOCK,
                   residual: Optional[torch.Tensor] = None,
                   process_set=None):
    """SUM of ``x`` over the ``n`` ranks of the world with the int8 wire:

      1. quantize the zero-padded payload per block (with ``residual``,
         after adding it: error feedback);
      2. all-to-all the codes and the scales, so rank r holds every
         rank's shard r;
      3. dequantize and accumulate the shard in float32, in rank order,
         and requantize it;
      4. all-gather the codes and scales;
      5. dequantize.

    The value equals the float32 SUM up to two block-quantization steps.
    With ``residual`` (float32, ``x``'s number of elements: this rank's
    quantization error of its previous contribution) it returns ``(y,
    new_residual)``, to be carried to the next call. ``y`` has ``x``'s
    shape and dtype; every rank gets the same bits."""
    _check_world(n, "quantized_psum", process_set)
    L = x.numel()
    if residual is not None and residual.numel() != L:
        # a residual sized for another padding would be cut short, and
        # the error feedback would compensate the wrong elements
        raise ValueError(
            f"quantized_psum: residual has {residual.numel()} "
            f"elements but the payload has {L}; the residual must "
            "carry exactly the unpadded payload's error")
    block = _positive_block(block, "quantized_psum")
    m = -(-L // (n * block)) * n * block
    block = _check_block(block, m, "quantized_psum")
    from ..ops import quantized_collectives as qc

    return qc.fused_quantized_psum(x, n, block, residual=residual)


def quantized_reduce_scatter_rows(rows: torch.Tensor,
                                  block: int = DEFAULT_BLOCK,
                                  residual: Optional[torch.Tensor] = None,
                                  process_set=None):
    """SUM-reduce-scatter of an ``(n, k)`` row stack over the ``n`` ranks:
    rank r gets ``sum over ranks of rows[r]`` as a float32 ``(k,)``
    shard, each row block-quantized for the exchange. Rows are padded to
    the block inside, so ``k`` is unchanged by compression.

    With ``residual`` (float32 ``(n, ceil(k / block) * block)``, this
    rank's error over its whole padded row stack) the payload is
    compensated before it is quantized and the call returns ``(shard,
    new_residual)``. The residual is rank-private: each rank compensates
    only its own contribution."""
    n, k = rows.shape
    _check_world(n, "quantized_reduce_scatter_rows", process_set)
    block = _positive_block(block, "quantized_reduce_scatter_rows")
    k2 = -(-k // block) * block
    _check_block(block, k2, "quantized_reduce_scatter_rows")
    if residual is not None and tuple(residual.shape) != (n, k2):
        # the residual's layout is the padded row stack; a reshape of
        # any other would feed the error back onto the wrong blocks
        raise ValueError(
            "quantized_reduce_scatter_rows: residual shape "
            f"{tuple(residual.shape)} does not match the padded row "
            f"stack ({n}, {k2}) for block {block}")
    rows_f = rows.to(torch.float32)
    if k2 != k:
        rows_f = torch.nn.functional.pad(rows_f, (0, k2 - k))
    from ..ops import quantized_collectives as qc

    return qc.fused_quantized_reduce_scatter_rows(
        rows_f.contiguous(), n, k, block, residual=residual)


# -- block math ---------------------------------------------------------------

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


def quantize_dequantize(x: torch.Tensor,
                        block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """One quantization round trip (float32, ``x``'s shape): the value a
    peer reconstructs from this payload."""
    flat = x.to(torch.float32).reshape(-1)
    n = flat.shape[0]
    q, s = quantize_blocks(_pad_flat(flat, block), block)
    return dequantize_blocks(q, s, block)[:n].reshape(x.shape)
