"""Autoregressive generation engine: prefill/decode over a slotted KV
cache.

The PyTorch counterpart of the JAX package's ``serving/decode.py``:

* **Slotted KV cache** (:class:`SlottedKVCache`): one pair of
  ``(slots, layers, kv_heads, max_len, head_dim)`` buffers. A slot is a
  resident sequence's cache lane, claimed at prefill, written every
  decode iteration and recycled the moment its sequence finishes. Rows
  above a slot's length hold the previous occupant's stale values; the
  validity mask (``position <= query position``) makes them
  unreachable, so recycling is free.
* **int8 block-quantized cache** (``HOROVOD_SERVING_KV_DTYPE=int8``):
  rows are quantized once, on write, with optim/compression.py's block
  math; decode iterations dequantize for the read and never
  re-quantize old rows.
* **Programs**: PyTorch runs eagerly, so there is nothing to compile
  ahead of time: ``warmup`` runs each prefill bucket and the decode
  step once, which builds the CUDA kernels. Prompts are padded to a
  power-of-two prefill bucket as in the JAX package, so a sequence's
  arithmetic does not depend on its neighbours or on its slot.
* **In place**: the cache buffers are updated in place (the kernels
  write the replaced rows into the buffer), where the JAX package
  rebinds them functionally and donates the old ones.

The model side is models/transformer.py's ``kv_cache`` path; each
layer's append+attend runs ops/decode_attention.py's kernel on the card.
The engine runs on the card unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# the cache-row int8 codec lives beside the kernels that also apply it;
# _dequantize_rows is re-exported as part of this module's cache format
from ..ops.decode_attention import (_dequantize_rows,  # noqa: F401
                                    _quantize_rows, append_rows_int8_ref,
                                    append_rows_ref, decode_append_attend)
from .engine import serving_knobs

KV_DTYPES = ("fp32", "bf16", "int8")


def parse_kv_dtype(name: Optional[str] = None) -> str:
    """``HOROVOD_SERVING_KV_DTYPE`` -> one of :data:`KV_DTYPES`."""
    if name is None:
        name = serving_knobs().serving_kv_dtype or "fp32"
    name = str(name).strip().lower()
    aliases = {"float32": "fp32", "f32": "fp32", "bfloat16": "bf16",
               "": "fp32"}
    name = aliases.get(name, name)
    if name not in KV_DTYPES:
        raise ValueError(
            f"unknown KV cache dtype {name!r}; expected one of "
            f"{KV_DTYPES} (HOROVOD_SERVING_KV_DTYPE)")
    return name


def parse_decode_buckets(
        spec: Optional[str] = None) -> Tuple[Tuple[int, int], ...]:
    """``HOROVOD_SERVING_DECODE_BUCKETS`` ("4x128,8x256") -> sorted
    unique ``(slots, max_len)`` pairs."""
    if spec is None:
        spec = serving_knobs().serving_decode_buckets or "4x128"
    out = set()
    for part in str(spec).replace(";", ",").split(","):
        part = part.strip().lower()
        if not part:
            continue
        s, _, m = part.partition("x")
        try:
            pair = (int(s), int(m))
        except ValueError:
            raise ValueError(
                f"invalid decode bucket {part!r} in {spec!r}; expected "
                "SLOTSxMAXLEN, e.g. 4x128")
        if pair[0] < 1 or pair[1] < 2:
            raise ValueError(f"invalid decode bucket {part!r} in {spec!r}")
        out.add(pair)
    if not out:
        raise ValueError(f"empty decode bucket spec {spec!r}")
    return tuple(sorted(out))


def default_prefill_buckets(max_len: int) -> Tuple[int, ...]:
    """Power-of-two prompt-length ladder up to ``max_len``."""
    out = []
    b = 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(sorted(set(out)))


# ---------------------------------------------------------------------------
# slotted KV cache
# ---------------------------------------------------------------------------

_TORCH_KV = {"fp32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Static shape/dtype contract of one slotted cache: buffers are
    ``(slots, layers, kv_heads, max_len, head_dim)``; ``dtype`` in
    {fp32, bf16, int8}; ``block`` the int8 quantization granularity
    along head_dim (0 = one scale per row, i.e. block = head_dim);
    ``compute_dtype`` the torch dtype the model computes in."""

    slots: int
    layers: int
    kv_heads: int
    max_len: int
    head_dim: int
    dtype: str = "fp32"
    block: int = 0
    compute_dtype: Any = None

    @property
    def resolved_block(self) -> int:
        b = int(self.block) if self.block else self.head_dim
        if b <= 0 or self.head_dim % b:
            # a block that does not divide head_dim cannot tile the
            # row; fall back to per-row scales rather than mis-scale
            b = self.head_dim
        return b

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.slots, self.layers, self.kv_heads, self.max_len,
                self.head_dim)

    @property
    def scale_shape(self) -> Tuple[int, ...]:
        return (self.slots, self.layers, self.kv_heads, self.max_len,
                self.head_dim // self.resolved_block)

    def buffer_shapes(self) -> Dict[str, Tuple[Tuple[int, ...],
                                               torch.dtype]]:
        """``name -> (shape, dtype)`` of every buffer."""
        out = {"k": (self.shape, _TORCH_KV[self.dtype]),
               "v": (self.shape, _TORCH_KV[self.dtype])}
        if self.dtype == "int8":
            out["k_scale"] = (self.scale_shape, torch.float32)
            out["v_scale"] = (self.scale_shape, torch.float32)
        return out

    def allocate(self, device) -> Dict[str, torch.Tensor]:
        """Zero-initialized buffers on ``device`` (stale rows are
        masked, so zeros are merely a defined starting point)."""
        return {name: torch.zeros(shape, dtype=dt, device=device)
                for name, (shape, dt) in self.buffer_shapes().items()}

    def nbytes(self) -> int:
        return sum(int(np.prod(shape)) * torch.empty((), dtype=dt)
                   .element_size()
                   for shape, dt in self.buffer_shapes().values())


class SlottedKVCache:
    """Cache carrier for the model's ``kv_cache`` path: the buffers of
    one :class:`KVCacheSpec`, updated in place."""

    def __init__(self, spec: KVCacheSpec, buffers: Dict[str, torch.Tensor]):
        self.spec = spec
        self.buffers = dict(buffers)

    def update(self, layer: int, k_new, v_new, positions):
        """Append ``k_new``/``v_new`` ``[B, T, KH, D]`` at absolute
        ``positions`` ``[B, T]`` in layer ``layer``'s slice (in place),
        returning ``(k_full, v_full, valid)``: the whole dequantized
        layer slice ``[B, KH, M, D]`` in the compute dtype and the
        validity mask ``[B, T, M]``.

        The write is a one-hot merge: a position >= max_len writes
        nothing (a saturated slot cannot corrupt row 0), and the merge
        runs in float32, where int8 codes are exact, so untouched rows
        round-trip bit for bit. This is the plain version of the
        append+attend kernels (ops/decode_attention.py).
        """
        spec = self.spec
        compute = spec.compute_dtype or torch.float32
        b = self.buffers
        if spec.dtype == "int8":
            return append_rows_int8_ref(
                b["k"][:, layer], b["k_scale"][:, layer], b["v"][:, layer],
                b["v_scale"][:, layer], k_new, v_new, positions,
                spec.resolved_block, compute)
        return append_rows_ref(b["k"][:, layer], b["v"][:, layer], k_new,
                               v_new, positions, compute)

    def append_attend(self, layer: int, q, k_new, v_new, positions):
        """Append + attention in one step (the model's kv_cache path):
        the kernel on the card, :meth:`update` + ``cached_attention``
        on the host. Returns ``[B, T, H, D]``."""
        return decode_append_attend(self, layer, q, k_new, v_new,
                                    positions)


# ---------------------------------------------------------------------------
# checkpoint metadata <-> TransformerConfig
# ---------------------------------------------------------------------------

#: serving-metadata model name for a generation-capable transformer LM
TRANSFORMER_LM = "transformer_lm"

_CFG_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
               "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def config_to_meta(cfg) -> Dict[str, Any]:
    """TransformerConfig -> a JSON-safe dict for checkpoint metadata
    (the same dict the JAX package writes)."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = "bfloat16" if cfg.dtype == torch.bfloat16 else "float32"
    return d


def config_from_meta(d: Dict[str, Any]):
    """Inverse of :func:`config_to_meta`."""
    from ..models.transformer import TransformerConfig

    d = dict(d)
    d["dtype"] = _CFG_DTYPES.get(str(d.get("dtype", "bfloat16")).lower(),
                                 torch.bfloat16)
    fields = {f.name for f in dataclasses.fields(TransformerConfig)}
    return TransformerConfig(**{k: v for k, v in d.items()
                                if k in fields})


# ---------------------------------------------------------------------------
# generation engine
# ---------------------------------------------------------------------------

def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "GenerationEngine runs on a CUDA device by default and "
                "found none; pass device='cpu' to serve on the host "
                "through the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class GenerationEngine:
    """Prefill + single-token greedy decode over a slotted cache.

    Mechanism only: ``claim_slot``/``release_slot`` hand out cache
    lanes, ``prefill`` runs a prompt into a claimed slot and returns the
    first generated token, ``decode`` advances EVERY slot one token
    (callers ignore the outputs of inactive slots). The scheduler
    (serving/scheduler.py) owns which sequence occupies which slot and
    when; this class owns shapes and the cache.

    ``model`` is a ``models.transformer.Transformer``; ``params``, when
    given, is a state dict loaded into it (e.g. from
    ``models.convert.params_from_flax``). Thread-safety: one lock around
    execution (one device per replica).
    """

    def __init__(
        self,
        model,
        params: Optional[Dict[str, torch.Tensor]] = None,
        *,
        slots: Optional[int] = None,
        max_len: Optional[int] = None,
        prefill_buckets: Optional[Sequence[int]] = None,
        kv_dtype: Optional[str] = None,
        kv_block: Optional[int] = None,
        eos_id: Optional[int] = None,
        device=None,
    ):
        self.device = _resolve_device(device)
        cfg = model.cfg
        if not cfg.causal:
            raise ValueError(
                "autoregressive generation needs a causal LM "
                "(TransformerConfig.causal=True)")
        sk = serving_knobs()
        if slots is None or max_len is None:
            # largest configured (slots, max_len) bucket
            pick = parse_decode_buckets()[-1]
            slots = slots if slots is not None else pick[0]
            max_len = max_len if max_len is not None else pick[1]
        if max_len > cfg.max_seq_len:
            raise ValueError(
                f"cache max_len {max_len} exceeds the model's "
                f"max_seq_len {cfg.max_seq_len} (rope/pos tables)")
        if kv_dtype is None:
            kv_dtype = parse_kv_dtype()
        if kv_block is None:
            kv_block = int(sk.serving_kv_block or 0)
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.eos_id = eos_id
        self.spec = KVCacheSpec(
            slots=int(slots), layers=cfg.num_layers,
            kv_heads=cfg.kv_heads, max_len=int(max_len),
            head_dim=cfg.head_dim, dtype=parse_kv_dtype(kv_dtype),
            block=int(kv_block), compute_dtype=cfg.dtype,
        )
        self._cache = self.spec.allocate(self.device)
        if prefill_buckets is None:
            knob = sk.serving_prefill_buckets or ""
            prefill_buckets = ([int(b) for b in
                                knob.replace(";", ",").split(",")
                                if b.strip()] if knob
                               else default_prefill_buckets(
                                   self.spec.max_len))
        self._prefill_buckets = tuple(sorted(set(
            int(b) for b in prefill_buckets
            if int(b) <= self.spec.max_len)))
        if not self._prefill_buckets:
            raise ValueError("no prefill bucket fits under max_len")
        self._lock = threading.Lock()
        self._free = list(range(self.spec.slots))
        self._slot_lock = threading.Lock()

    # -- shape bookkeeping ---------------------------------------------------

    @property
    def slots(self) -> int:
        return self.spec.slots

    @property
    def max_len(self) -> int:
        return self.spec.max_len

    @property
    def prefill_buckets(self) -> Tuple[int, ...]:
        return self._prefill_buckets

    @property
    def free_slots(self) -> int:
        with self._slot_lock:
            return len(self._free)

    def claim_slot(self) -> Optional[int]:
        """Take a free cache lane (None when full); the lane's stale
        rows are masked until the prefill overwrites them."""
        with self._slot_lock:
            return self._free.pop(0) if self._free else None

    def release_slot(self, slot: int) -> None:
        with self._slot_lock:
            if slot in self._free:
                raise ValueError(f"slot {slot} already free")
            self._free.append(int(slot))
            self._free.sort()

    def prefill_bucket_for(self, n: int) -> int:
        for b in self._prefill_buckets:
            if b >= n:
                return b
        raise ValueError(
            f"prompt of {n} tokens exceeds the top prefill bucket "
            f"{self._prefill_buckets[-1]} (cache max_len "
            f"{self.spec.max_len})")

    def warmup(self) -> None:
        """Run every prefill bucket and the decode step once, so the
        first request of each shape pays no kernel build. Writes only
        stale rows, so it needs every slot free."""
        with self._slot_lock:
            if len(self._free) != self.spec.slots:
                raise RuntimeError("warmup needs every cache slot free")
        for b in self._prefill_buckets:
            self._prefill(0, np.zeros((1, b), np.int32), 1)
        zeros = np.zeros(self.spec.slots, np.int32)
        self.decode(zeros, zeros)

    # -- execution -----------------------------------------------------------

    def prefill(self, slot: int, tokens: Sequence[int]) -> Tuple[int,
                                                                 np.ndarray]:
        """Run ``tokens`` into slot ``slot``; returns ``(first_token,
        last_logits)`` — the greedy continuation and its float32
        logits."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = tokens.shape[0]
        if n < 1:
            raise ValueError("prefill needs at least one prompt token")
        if n >= self.spec.max_len:
            raise ValueError(
                f"prompt of {n} tokens leaves no room to generate "
                f"under max_len {self.spec.max_len}")
        bucket = self.prefill_bucket_for(n)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = tokens
        return self._prefill(slot, padded, n)

    def _prefill(self, slot: int, padded: np.ndarray, n: int):
        spec = self.spec
        bucket = padded.shape[1]
        # the prompt runs through a LOCAL float32 cache (M = the bucket):
        # prefill attention is the causal forward through the same cache
        # path; the rows are then converted to the slotted cache's
        # storage (cast, or int8-quantized once) and inserted at the slot
        local_spec = dataclasses.replace(spec, slots=1, max_len=bucket,
                                         dtype="fp32")
        with self._lock, torch.inference_mode():
            local = SlottedKVCache(local_spec,
                                   local_spec.allocate(self.device))
            tok = torch.from_numpy(padded).to(self.device)
            pos = torch.arange(bucket, dtype=torch.int32,
                               device=self.device)[None]
            logits = self.model(tok, positions=pos, kv_cache=local)
            last = logits[0, n - 1].to(torch.float32)
            first = torch.argmax(last)
            for name in ("k", "v"):
                rows = local.buffers[name]  # [1, L, KH, bucket, D] f32
                dst = slice(slot, slot + 1)
                if spec.dtype == "int8":
                    codes, scales = _quantize_rows(rows, spec.resolved_block)
                    self._cache[name][dst, :, :, :bucket] = codes
                    self._cache[name + "_scale"][dst, :, :, :bucket] = scales
                else:
                    self._cache[name][dst, :, :, :bucket] = rows.to(
                        self._cache[name].dtype)
            return int(first), last.cpu().numpy()

    def decode(self, tokens: np.ndarray, lengths: np.ndarray,
               return_logits: bool = False,
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """One iteration: append ``tokens[i]`` at position ``lengths[i]``
        in every slot i and return ``(next_tokens, last_logits)``
        (``[slots]``, and ``[slots, vocab]`` only under
        ``return_logits``). Inactive slots ride along (pass length 0 so
        their write lands in a row the next prefill overwrites)."""
        spec = self.spec
        tokens = np.asarray(tokens, np.int32).reshape(spec.slots)
        lengths = np.asarray(lengths, np.int32).reshape(spec.slots)
        if lengths.min() < 0 or lengths.max() >= self.cfg.max_seq_len:
            raise ValueError(
                f"decode positions must lie in [0, max_seq_len "
                f"{self.cfg.max_seq_len}), got {lengths.tolist()}")
        with self._lock, torch.inference_mode():
            cache = SlottedKVCache(spec, self._cache)
            tok = torch.from_numpy(tokens).to(self.device)[:, None]
            pos = torch.from_numpy(lengths).to(self.device)[:, None]
            logits = self.model(tok, positions=pos, kv_cache=cache)
            last = logits[:, -1].to(torch.float32)
            nxt = torch.argmax(last, dim=-1).to(torch.int32).cpu().numpy()
            if return_logits:
                return nxt, last.cpu().numpy()
            return nxt, None

    def cache_nbytes(self) -> int:
        return self.spec.nbytes()
