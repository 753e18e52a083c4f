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
* **A CUDA graph per program**: where the JAX package compiles an
  AOT executable per shape, the engine captures one CUDA graph per
  executable key, ``("decode", slots, max_len, return_logits)`` and
  ``("prefill", bucket)``, and replays it. Each graph reads static
  input buffers on the card (filled with ``copy_`` from pinned host
  buffers before the replay) and writes static outputs that are copied
  back after it. ``warmup`` builds every graph the scheduler uses:
  each step runs once uncaptured on the capture's side stream (the
  kernels' modules load and the decode route's one-time occupancy
  query is answered there), then is captured. On the CPU, which has no
  graphs, the same step functions run directly. Prompts are padded to
  a power-of-two prefill bucket as in the JAX package, so a sequence's
  arithmetic does not depend on its neighbours or on its slot.
* **In place**: the cache buffers are updated in place (the kernels
  write the replaced rows into the buffer) and never rebound, since a
  graph holds their addresses; the JAX package rebinds them
  functionally and donates the old ones.

The model side is models/transformer.py's ``kv_cache`` path; each
layer's append+attend runs ops/decode_attention.py's kernel on the card.
The engine runs on the card unless the caller asks for ``device="cpu"``.

Metrics, as in the JAX package: each graph built
(``record_serving_compile``, by decode slots or prefill bucket), each
prefill (``record_decode_prefill``) and each decode iteration
(``record_decode_iteration``, and ``record_serving_tpot`` for every live
sequence it advanced, by the SLO class ``decode(slos=)`` names). A
replay returns before the card is done, so an iteration's time runs up
to its next tokens on the host (``to_host``), not to the replay's
return. Every record is made around the replay, never inside a graph.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# the cache-row int8 codec lives beside the kernels that also apply it;
# _dequantize_rows is re-exported as part of this module's cache format
from ..ops.decode_attention import (_dequantize_rows,  # noqa: F401
                                    _quantize_rows, append_rows_int8_ref,
                                    append_rows_ref, decode_append_attend)
from ..utils import faults, metrics
from .engine import (GraphStep, resolve_device, run_step, serving_knobs,
                     to_device, to_host)

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

class GenerationEngine:
    """Prefill + single-token greedy decode over a slotted cache.

    Mechanism only: ``claim_slot``/``release_slot`` hand out cache
    lanes, ``prefill`` runs a prompt into a claimed slot and returns the
    first generated token, ``decode`` advances EVERY slot one token
    (callers ignore the outputs of inactive slots). The scheduler
    (serving/scheduler.py) owns which sequence occupies which slot and
    when; this class owns shapes, the graphs and the cache.

    ``model`` is a ``models.transformer.Transformer``; ``params``, when
    given, is a state dict loaded into it (e.g. from
    ``models.convert.params_from_flax``). On the card every decode and
    prefill step replays a CUDA graph (one per executable key, captured
    by :meth:`warmup` or on first use); the graphs replay one at a time
    and share one memory pool. Thread-safety: one lock around the graph
    cache, execution and capture (one device per replica; a capture
    must not overlap other work on the card).
    """

    MAX_CACHED_EXECUTABLES = 16

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
        self.device = resolve_device(device, "GenerationEngine")
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
        # written in place by every step and never rebound: the graphs
        # hold these addresses
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
        # the steps' static inputs: decode's tokens and lengths, and the
        # prefill's slot and prompt length as device scalars (each
        # bucket has its own token buffer and local cache)
        dev = self.device
        self._tokens = torch.zeros(self.spec.slots, dtype=torch.int32,
                                   device=dev)
        self._lengths = torch.zeros(self.spec.slots, dtype=torch.int32,
                                    device=dev)
        self._slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self._length = torch.ones(1, dtype=torch.int64, device=dev)
        self._pinned: Dict[str, torch.Tensor] = {}
        self._graphs: "OrderedDict[Tuple, GraphStep]" = OrderedDict()
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(dev) if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        #: the same steps without their graphs (a private check that a
        #: replay gives the uncaptured step's bits; no public switch)
        self._uncaptured = False
        self._lock = threading.Lock()
        self._free = list(range(self.spec.slots))
        self._slot_lock = threading.Lock()

    # -- construction from a checkpoint -------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "GenerationEngine":
        """Restore a generation-capable LM checkpoint
        (``checkpoint.save_model``) with metadata ``{"serving":
        {"model": "transformer_lm", "config": {...}, "eos": id}}``
        (save side: :func:`config_to_meta`)."""
        from ..checkpoint import load_params
        from ..models.transformer import Transformer
        from .engine import SERVING_META_KEY

        params, metadata = load_params(path, device="cpu")
        meta = dict(metadata.get(SERVING_META_KEY, {}))
        if meta.get("model") != TRANSFORMER_LM:
            raise ValueError(
                f"checkpoint is not a generation LM (metadata model = "
                f"{meta.get('model')!r}; expected {TRANSFORMER_LM!r})")
        cfg = config_from_meta(meta.get("config", {}))
        kwargs.setdefault("eos_id", meta.get("eos"))
        eng = cls(Transformer(cfg), params, **kwargs)
        eng.metadata = metadata
        return eng

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
    def cached_executables(self) -> int:
        """Graphs (on the CPU: steps) currently cached."""
        return len(self._graphs)

    @property
    def graphs(self) -> Dict[Tuple, GraphStep]:
        """The cached steps by executable key (a copy): each one's
        capture launches, replays and capture seconds."""
        with self._lock:
            return dict(self._graphs)

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

    # -- the steps and their graphs -----------------------------------------

    def _step(self, key: Tuple, build: Callable[[], GraphStep]) -> GraphStep:
        """The cached step of ``key`` (under the lock); a new one is
        captured by its first run."""
        step = self._graphs.get(key)
        if step is not None:
            self._graphs.move_to_end(key)
            return step
        step = build()
        self._graphs[key] = step
        while len(self._graphs) > self.MAX_CACHED_EXECUTABLES:
            self._graphs.popitem(last=False)[1].free()
        return step

    def _decode_step(self, return_logits: bool = False) -> GraphStep:
        spec = self.spec

        def build():
            def decode_fn():
                with torch.inference_mode():
                    cache = SlottedKVCache(spec, self._cache)
                    logits = self.model(self._tokens[:, None],
                                        positions=self._lengths[:, None],
                                        kv_cache=cache)
                    last = logits[:, -1].to(torch.float32)
                    nxt = torch.argmax(last, dim=-1).to(torch.int32)
                    # without return_logits the [slots, vocab] logits
                    # never leave the card
                    return (nxt, last) if return_logits else (nxt,)

            return GraphStep(key, decode_fn, bucket=spec.slots)

        key = ("decode", spec.slots, spec.max_len, bool(return_logits))
        return self._step(key, build)

    def _prefill_step(self, bucket: int) -> GraphStep:
        spec = self.spec
        local_spec = dataclasses.replace(spec, slots=1, max_len=bucket,
                                         dtype="fp32")

        def build():
            # the prompt runs through a LOCAL float32 cache (M = the
            # bucket), a static buffer of this step: prefill attention
            # is the causal forward through the same cache path; the
            # rows are then converted to the slotted cache's storage
            # (cast, or int8-quantized once) and copied into the slot
            local = local_spec.allocate(self.device)
            tokens = torch.zeros((1, bucket), dtype=torch.int32,
                                 device=self.device)
            pos = torch.arange(bucket, dtype=torch.int32,
                               device=self.device)[None]

            def prefill_fn():
                with torch.inference_mode():
                    for buf in local.values():
                        buf.zero_()
                    logits = self.model(
                        tokens, positions=pos,
                        kv_cache=SlottedKVCache(local_spec, local))
                    last = logits[0].index_select(
                        0, self._length - 1)[0].to(torch.float32)
                    first = torch.argmax(last)
                    for name in ("k", "v"):
                        rows = local[name]  # [1, L, KH, bucket, D] f32
                        if spec.dtype == "int8":
                            codes, scales = _quantize_rows(
                                rows, spec.resolved_block)
                            self._cache[name][..., :bucket, :].index_copy_(
                                0, self._slot, codes)
                            self._cache[name + "_scale"][
                                ..., :bucket, :].index_copy_(
                                    0, self._slot, scales)
                        else:
                            dst = self._cache[name]
                            dst[..., :bucket, :].index_copy_(
                                0, self._slot, rows.to(dst.dtype))
                    return first, last

            return GraphStep(key, prefill_fn, {"tokens": tokens},
                             bucket=bucket)

        key = ("prefill", bucket)
        return self._step(key, build)

    def _run(self, step: GraphStep) -> Tuple[torch.Tensor, ...]:
        """The step's outputs: its graph's replay on the card (captured
        here on first use), the step itself on the CPU. Call under the
        execution lock, with the static inputs filled."""
        return run_step(step, self._stream, self._pool,
                        uncaptured=self._uncaptured)

    def warmup(self) -> None:
        """Build the decode graph and every prefill bucket's graph, so no
        request pays a capture. Writes only stale rows, so it needs
        every slot free."""
        with self._slot_lock:
            if len(self._free) != self.spec.slots:
                raise RuntimeError("warmup needs every cache slot free")
        zeros = np.zeros(self.spec.slots, np.int32)
        with self._lock:
            for b in self._prefill_buckets:
                self._run_prefill(self._prefill_step(b), 0,
                                  np.zeros((1, b), np.int32), 1)
            self._run_decode(self._decode_step(), zeros, zeros)

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
        bucket = padded.shape[1]
        t0 = time.perf_counter()
        with self._lock:
            step = self._prefill_step(bucket)
            faults.inject("serving.decode_prefill", bucket=bucket)
            first, last = self._run_prefill(step, slot, padded, n)
        metrics.record_decode_prefill(bucket, time.perf_counter() - t0)
        return int(first), last

    def _run_prefill(self, step: GraphStep, slot: int, padded: np.ndarray,
                     n: int) -> Tuple[np.ndarray, ...]:
        """Fill the prefill's static inputs and run it (under the
        lock); the first token and the float32 logits, on the host."""
        to_device(step.inputs["tokens"], padded, self._pinned,
                  f"prefill{padded.shape[1]}")
        to_device(self._slot, np.array([slot], np.int64), self._pinned,
                  "slot")
        to_device(self._length, np.array([n], np.int64), self._pinned,
                  "length")
        return to_host(self._run(step), self._pinned)

    def _run_decode(self, step: GraphStep, tokens: np.ndarray,
                    lengths: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Fill the decode step's static inputs and run it (under the
        lock); its outputs on the host."""
        to_device(self._tokens, tokens, self._pinned, "tokens")
        to_device(self._lengths, lengths, self._pinned, "lengths")
        return to_host(self._run(step), self._pinned)

    def decode(self, tokens: np.ndarray, lengths: np.ndarray,
               return_logits: bool = False,
               slos: Optional[Sequence[str]] = None,
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """One iteration: append ``tokens[i]`` at position ``lengths[i]``
        in every slot i and return ``(next_tokens, last_logits)``
        (``[slots]``, and ``[slots, vocab]`` only under
        ``return_logits``). Inactive slots ride along (pass length 0 so
        their write lands in a row the next prefill overwrites).

        ``slos`` names the SLO class of each live sequence the iteration
        advances (the scheduler passes one entry an occupied slot): the
        iteration's time, up to its tokens on the host, is each one's
        time per output token (``hvd_serving_tpot_seconds{slo=...}``)."""
        spec = self.spec
        tokens = np.asarray(tokens, np.int32).reshape(spec.slots)
        lengths = np.asarray(lengths, np.int32).reshape(spec.slots)
        if lengths.min() < 0 or lengths.max() >= self.cfg.max_seq_len:
            raise ValueError(
                f"decode positions must lie in [0, max_seq_len "
                f"{self.cfg.max_seq_len}), got {lengths.tolist()}")
        t0 = time.perf_counter()
        with self._lock:
            step = self._decode_step(return_logits)
            faults.inject("serving.decode_step")
            out = self._run_decode(step, tokens, lengths)
        dt = time.perf_counter() - t0
        metrics.record_decode_iteration(int(spec.slots), dt)
        if slos:
            # each live sequence got one token from this iteration, so
            # its time is each one's time per output token
            for slo in slos:
                metrics.record_serving_tpot(dt, slo=slo)
        return out[0], (out[1] if return_logits else None)

    def cache_nbytes(self) -> int:
        return self.spec.nbytes()
