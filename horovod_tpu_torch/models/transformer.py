"""Transformer model family (GPT-2, BERT, Llama) in PyTorch.

The counterpart of the JAX package's ``models/transformer.py``, with
the same parameter layout (so converted flax checkpoints load, see
convert.py) and the same rounding points:

* parameters are float32; activations, dense products and the LM head
  run in ``cfg.dtype`` (bfloat16 by default), norms' statistics and
  the softmax in float32;
* dense kernels are ``[in, out]``; the q/k/v kernels ``[hidden, H, D]``
  and the output kernel ``[H, D, hidden]``, as flax's ``DenseGeneral``
  stores them;
* GELU is the tanh approximation (flax's ``nn.gelu``); GQA repeats
  each kv head for its ``H / KH`` query heads (head h reads kv head
  ``h // rep``);
* attention logits are rounded to the compute dtype by the product
  before the scale, and probabilities are cast to the compute dtype
  before the PV product.

``fused_norm=True`` routes every norm through the fused LayerNorm
kernels (ops/layernorm.py), forward and backward. ``attention_fn``
(e.g. ``ops.flash_attention.make_flash_attention_fn()``) replaces the
default attention on the training / one-shot path. With ``kv_cache``
the attention appends the new K/V rows into a slotted cache and
attends over it (serving/decode.py, ops/decode_attention.py).

``remat=True`` recomputes each block's forward during the backward
(``torch.utils.checkpoint``, non-reentrant) instead of keeping its
activations, as the JAX package's ``nn.remat`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.layernorm import FusedLayerNorm


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # GQA; None = MHA
    hidden_size: int = 768
    mlp_ratio: float = 4.0
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16
    # architecture switches
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    position: str = "learned"  # "learned" | "rope" | "none"
    activation: str = "gelu"  # "gelu" | "swiglu"
    causal: bool = True
    tie_embeddings: bool = True
    remat: bool = False
    rope_theta: float = 10000.0
    layernorm_epsilon: float = 1e-5
    # fused single-pass norm kernel (ops/layernorm.py)
    fused_norm: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


# -- named configs ----------------------------------------------------------

GPT2_SMALL = TransformerConfig(
    vocab_size=50257, num_layers=12, num_heads=12, hidden_size=768,
    max_seq_len=1024,
)
GPT2_MEDIUM = dataclasses.replace(
    GPT2_SMALL, num_layers=24, num_heads=16, hidden_size=1024
)
GPT2_LARGE = dataclasses.replace(
    GPT2_SMALL, num_layers=36, num_heads=20, hidden_size=1280
)
BERT_BASE = TransformerConfig(
    vocab_size=30522, num_layers=12, num_heads=12, hidden_size=768,
    max_seq_len=512, causal=False,
)
BERT_LARGE = dataclasses.replace(
    BERT_BASE, num_layers=24, num_heads=16, hidden_size=1024
)
LLAMA2_7B = TransformerConfig(
    vocab_size=32000, num_layers=32, num_heads=32, hidden_size=4096,
    mlp_ratio=11008 / 4096, max_seq_len=4096, norm="rmsnorm",
    position="rope", activation="swiglu", tie_embeddings=False,
)
LLAMA3_8B = TransformerConfig(
    vocab_size=128256, num_layers=32, num_heads=32, num_kv_heads=8,
    hidden_size=4096, mlp_ratio=14336 / 4096, max_seq_len=8192,
    norm="rmsnorm", position="rope", activation="swiglu",
    tie_embeddings=False, rope_theta=500000.0,
)


# -- building blocks --------------------------------------------------------

def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral``: contracts the trailing
    ``len(in_shape)`` axes of x with a ``[*in_shape, *out_shape]``
    kernel; input, kernel and bias are cast to ``dtype`` first."""

    def __init__(self, in_shape, out_shape, dtype: torch.dtype,
                 use_bias: bool = True):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(*self.in_shape,
                                               *self.out_shape))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(*self.out_shape))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        kernel = self.kernel.to(self.dtype).reshape(n_in, n_out)
        y = torch.matmul(x.to(self.dtype).reshape(*lead, n_in), kernel)
        y = y.reshape(*lead, *self.out_shape)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Embed(nn.Module):
    """flax ``Embed``: a float32 ``[vocab, hidden]`` table read in
    ``dtype``; :meth:`attend` is the tied LM head."""

    def __init__(self, vocab: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.zeros(vocab, features))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding[tokens].to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.dtype),
                            self.embedding.to(self.dtype).t())


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: float32 ``mean`` and ``var = E[x^2] -
    mean^2`` clamped at 0, ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``, output in ``dtype``."""

    def __init__(self, features: int, *, epsilon: float,
                 dtype: torch.dtype):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class RMSNorm(nn.Module):
    def __init__(self, features: int, *, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt(
            (xf * xf).mean(dim=-1, keepdim=True) + self.epsilon)
        return (y * self.scale).to(self.dtype)


def _norm(cfg: TransformerConfig) -> nn.Module:
    c = cfg.hidden_size
    if cfg.fused_norm:
        return FusedLayerNorm(c, epsilon=cfg.layernorm_epsilon,
                              dtype=cfg.dtype, kind=cfg.norm)
    if cfg.norm == "rmsnorm":
        return RMSNorm(c, epsilon=cfg.layernorm_epsilon, dtype=cfg.dtype)
    return LayerNorm(c, epsilon=cfg.layernorm_epsilon, dtype=cfg.dtype)


def rope_frequencies(head_dim: int, max_len: int, theta: float):
    """float32 ``(cos, sin)`` tables ``[max_len, head_dim / 2]``."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_len), inv)
    return (torch.from_numpy(np.cos(freqs)).to(torch.float32),
            torch.from_numpy(np.sin(freqs)).to(torch.float32))


def apply_rope(x, cos, sin, positions):
    """x: [B, T, H, D]; positions: [B, T] absolute positions."""
    c = cos[positions][:, :, None, :]  # [B, T, 1, D/2]
    s = sin[positions][:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def cached_attention(q, k, v, valid):
    """Attention of new-token queries over a KV cache slice.

    q ``[B, T, H, D]`` (the tokens appended this call); k/v ``[B, KH,
    M, D]`` (the cache layer's slice, new rows included); ``valid``
    ``[B, T, M]`` bool — cache row j is attendable by query t iff
    ``j <= position(t)``, both the causal and the "written yet" mask.
    float32 softmax; masked rows get -1e30, so stale but finite rows
    contribute exactly zero probability.
    """
    B, T, H, D = q.shape
    KH = k.shape[1]
    if KH != H:  # GQA: repeat kv heads
        rep = H // KH
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    scale = float(1.0 / np.sqrt(D))
    logits = torch.einsum("bthd,bhmd->bhtm", q, k).to(torch.float32) * scale
    logits = torch.where(valid[:, None], logits,
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=logits.device))
    probs = _softmax(logits).to(q.dtype)
    return torch.einsum("bhtm,bhmd->bthd", probs, v)


def dot_product_attention(q, k, v, *, causal: bool, mask=None):
    """Default attention: q,k,v [B, T, H, D] -> [B, T, H, D], float32
    softmax; ``mask`` ``[B, Tk]`` marks the keys that may be read."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if k.shape[2] != H:  # GQA: repeat kv heads
        rep = H // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scale = float(1.0 / np.sqrt(D))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    neg = torch.tensor(-1e30, dtype=torch.float32, device=logits.device)
    if causal:
        cm = torch.tril(torch.ones((Tq, Tk), dtype=torch.bool,
                                   device=logits.device))
        logits = torch.where(cm[None, None], logits, neg)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :], logits, neg)
    probs = _softmax(logits).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, attention_fn=None):
        super().__init__()
        self.cfg = cfg
        self.attention_fn = attention_fn
        H, KH, D, S = cfg.num_heads, cfg.kv_heads, cfg.head_dim, \
            cfg.hidden_size
        bias = cfg.norm == "layernorm"
        self.query = Dense((S,), (H, D), cfg.dtype, bias)
        self.key = Dense((S,), (KH, D), cfg.dtype, bias)
        self.value = Dense((S,), (KH, D), cfg.dtype, bias)
        self.out = Dense((H, D), (S,), cfg.dtype, bias)

    def forward(self, x, positions, mask=None, kv_cache=None, layer=0,
                rope=None):
        cfg = self.cfg
        q = self.query(x)
        k = self.key(x)
        v = self.value(x)
        if cfg.position == "rope":
            cos, sin = rope
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
        if kv_cache is not None:
            # serving path: the new tokens' K/V append into the slotted
            # cache and attention runs over the whole cache slice under
            # the position-validity mask (one kernel on the card)
            if mask is not None:
                raise ValueError(
                    "kv_cache decoding derives its own validity mask "
                    "from positions; an explicit padding mask is not "
                    "composable with it")
            out = kv_cache.append_attend(layer, q, k, v, positions)
        elif self.attention_fn is None:
            out = dot_product_attention(q, k, v, causal=cfg.causal,
                                        mask=mask)
        else:
            if mask is not None:
                raise ValueError(
                    "a custom attention_fn (flash/ring/Ulysses) takes only "
                    "(q, k, v) and would silently drop the padding mask; "
                    "pre-mask the inputs or use the default attention")
            out = self.attention_fn(q, k, v)
        return self.out(out)


class Mlp(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        S, F_ = cfg.hidden_size, cfg.mlp_dim
        bias = cfg.norm == "layernorm"
        if cfg.activation == "swiglu":
            self.gate = Dense((S,), (F_,), cfg.dtype, bias)
            self.up = Dense((S,), (F_,), cfg.dtype, bias)
        else:
            self.fc1 = Dense((S,), (F_,), cfg.dtype, bias)
        self.fc2 = Dense((F_,), (S,), cfg.dtype, bias)

    def forward(self, x):
        if self.cfg.activation == "swiglu":
            h = F.silu(self.gate(x)) * self.up(x)
        else:
            h = F.gelu(self.fc1(x), approximate="tanh")
        return self.fc2(h)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, attention_fn=None):
        super().__init__()
        self.ln_attn = _norm(cfg)
        self.attn = Attention(cfg, attention_fn)
        self.ln_mlp = _norm(cfg)
        self.mlp = Mlp(cfg)

    def forward(self, x, positions, mask=None, kv_cache=None, layer=0,
                rope=None):
        x = x + self.attn(self.ln_attn(x), positions, mask,
                          kv_cache=kv_cache, layer=layer, rope=rope)
        return x + self.mlp(self.ln_mlp(x))


class Transformer(nn.Module):
    """Decoder/encoder stack with LM head; covers GPT-2 (causal +
    learned positions), BERT (bidirectional) and Llama (causal +
    rope/RMS/swiglu). Parameter names follow the flax tree
    (``block_0.attn.query.kernel``, ...). ``attention_fn(q, k, v)``
    replaces the default attention on ``[B, T, H, D]`` tensors."""

    def __init__(self, cfg: TransformerConfig, attention_fn=None):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype)
        if cfg.position == "learned":
            self.pos_emb = nn.Parameter(
                torch.zeros(cfg.max_seq_len, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", Block(cfg, attention_fn))
        self.ln_final = _norm(cfg)
        if not cfg.tie_embeddings:
            self.lm_head = Dense((cfg.hidden_size,), (cfg.vocab_size,),
                                 cfg.dtype, use_bias=False)
        if cfg.position == "rope":
            cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                        cfg.rope_theta)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def blocks(self):
        return [getattr(self, f"block_{i}")
                for i in range(self.cfg.num_layers)]

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Transformer":
        """Random weights distributed as flax initializes them: normal
        (std 0.02) embeddings, ``pos_emb`` and untied LM head,
        xavier-uniform dense kernels (fans of the kernel flattened to
        ``[in, out]``), zero biases and unit norm scales. ``generator``
        must live on the parameters' device."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("tok_emb.embedding", "pos_emb",
                        "lm_head.kernel"):
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf == "kernel":
                mod = self.get_submodule(name.rsplit(".", 1)[0])
                fan_in = math.prod(mod.in_shape)
                fan_out = math.prod(mod.out_shape)
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                p.uniform_(-bound, bound, generator=generator)
            elif leaf == "scale":
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def forward(self, tokens, positions=None, mask=None,
                return_hidden=False, kv_cache=None):
        """``kv_cache`` opens the serving path: a cache carrier with
        ``append_attend(layer, q, k, v, positions)``
        (serving/decode.SlottedKVCache). With it, ``tokens`` are the NEW
        tokens only (the whole prompt at prefill, one per sequence at
        decode) and ``positions`` their absolute positions, which must
        stay below ``max_seq_len`` (the positional tables are not
        clamped)."""
        cfg = self.cfg
        B, T = tokens.shape
        if positions is None:
            positions = torch.arange(T, device=tokens.device).expand(B, T)
        x = self.tok_emb(tokens)
        if cfg.position == "learned":
            x = x + self.pos_emb[positions].to(cfg.dtype)
        rope = ((self.rope_cos, self.rope_sin) if cfg.position == "rope"
                else None)
        remat = cfg.remat and kv_cache is None and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            if remat:
                x = checkpoint(block, x, positions, mask, None, i, rope,
                               use_reentrant=False)
            else:
                x = block(x, positions, mask, kv_cache=kv_cache, layer=i,
                          rope=rope)
        x = self.ln_final(x)
        if return_hidden:
            return x
        if cfg.tie_embeddings:
            return self.tok_emb.attend(x)
        return self.lm_head(x)


# -- task heads / losses ----------------------------------------------------

def _gather_nll(lg, targets):
    """Per-position cross-entropy via gather: logsumexp(lg) -
    lg[target]."""
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, targets[..., None])[..., 0]
    return lse - tgt


def causal_lm_nll(logits, tokens, ignore_index: int = -1):
    """The two sums of :func:`causal_lm_loss`: ``(Σ nll, n_valid)``,
    the float32 next-token cross-entropy summed over valid, in-range
    targets and the count of targets that are not ``ignore_index``
    (not clamped), so several ranks' batches can share one mean."""
    targets = tokens[:, 1:]
    lg = logits[:, :-1].to(torch.float32)
    valid = targets != ignore_index
    # out-of-range ids (sentinels, padding artifacts) contribute zero
    in_range = (targets >= 0) & (targets < lg.shape[-1])
    nll = _gather_nll(lg, torch.where(in_range, targets,
                                      torch.zeros_like(targets)))
    nll = torch.where(valid & in_range, nll, torch.zeros_like(nll))
    return nll.sum(), valid.sum()


def causal_lm_loss(logits, tokens, ignore_index: int = -1):
    """Next-token cross-entropy; returns (loss, n_tokens). float32."""
    nll, n = causal_lm_nll(logits, tokens, ignore_index)
    n = torch.clamp(n, min=1)
    return nll / n, n


def mlm_loss(logits, labels, mask_positions):
    """BERT masked-LM loss: ``labels`` at ``mask_positions`` (bool
    [B, T])."""
    lg = logits.to(torch.float32)
    in_range = (labels >= 0) & (labels < lg.shape[-1])
    nll = _gather_nll(lg, torch.where(in_range, labels,
                                      torch.zeros_like(labels)))
    nll = torch.where(mask_positions & in_range, nll, torch.zeros_like(nll))
    n = torch.clamp(mask_positions.sum(), min=1)
    return nll.sum() / n, n


def GPT2(cfg: TransformerConfig = GPT2_SMALL, **kw) -> Transformer:
    return Transformer(cfg, **kw)


def Bert(cfg: TransformerConfig = BERT_LARGE, **kw) -> Transformer:
    return Transformer(cfg, **kw)


def Llama(cfg: TransformerConfig = LLAMA2_7B, **kw) -> Transformer:
    return Transformer(cfg, **kw)
