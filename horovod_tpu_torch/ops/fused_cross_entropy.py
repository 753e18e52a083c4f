"""Fused LM-head + cross-entropy: vocab-blocked, the [N, V] logits are
never written to device memory whole.

The port of the JAX package's ``ops/fused_cross_entropy.py``: the same
blocks, the same online logsumexp and the same recompute in the
backward, as a ``torch.autograd.Function``. The forward walks the vocab
in blocks of ``block_vocab`` columns: each block's float32 logits
``x @ w_blk`` (operands in the model dtype, products accumulated in
float32, as the JAX function's ``preferred_element_type=jnp.float32``)
fold into a running row max ``m``, a running sum ``l`` of ``exp(logit -
m)`` and the target's logit, and are dropped; ``lse = m + log(l)``. The
backward recomputes each block from the saved ``lse``: ``ds = (softmax
- onehot) * row`` in float32, cast once to the model dtype, then ``dX
+= ds @ w_blk^T`` in a float32 accumulator and ``dW_blk = x^T @ ds``
written a block at a time. Live memory is O(N * block_vocab), not
O(N * V). No Pallas kernel stands behind the JAX function (its products
are plain dots and XLA fuses its epilogues), so none stands behind this
one: the products are ``torch.mm``.

Passes over a block's [N, block_vocab] float32 tensor (eager PyTorch runs
each elementwise op as its own pass; the JAX function's epilogues are
fused by XLA):

* forward, per block: the product writes it (1 write), the row max
  reads it (1 read), ``sub_`` and ``exp_`` in place (2 reads, 2 writes),
  the row sum (1 read): 4 reads, 3 writes. Only the ragged last block
  masks, and only its pad columns; the target pick reads N values;
* backward, per block: the product (1 write), ``sub_`` and ``exp_`` in
  place (2 reads, 2 writes), the pad columns of the ragged block zeroed,
  the onehot subtracted at N indexed positions (no [N, Vb] onehot), the
  row scale fused with the one cast to the model dtype (1 read of the
  float32 block, 1 write of a half-size block): 3 reads, 3 writes and a
  half; the two products then read the model-dtype block once each.

Layouts. ``w`` is the ``[h, V]`` head kernel, as the JAX function takes
it. The tied embedding is passed as ``embedding.t()``, the transpose of
the ``[V, h]`` table: its vocab blocks are contiguous row slices of the
table, read in place, and only the ragged last block is copied, padded
with zero rows (:func:`_pad_rows`). Any other ``w`` (an untied
``lm_head.kernel``) is padded whole on V by :func:`_pad_w`, as the JAX
function pads it. dW is written into ``[V, h]`` vocab rows, a block at a
time, and returned as their transpose, ``w``'s shape.

Float32 products of bf16 operands: on the card ``torch.mm(a, b,
out_dtype=torch.float32)``; the CPU has no such kernel, so there both
operands are upcast to float32 first (a product of two bf16 values is
exact in float32: only the order of summation differs). The route is
chosen by the operands' device (:func:`_mm_f32`).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _pad_w(w: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """Pad an ``[h, V]`` head kernel on V with zero columns to a multiple
    of ``block``; returns the padded kernel and V."""
    v = w.shape[1]
    pad = (-v) % block
    if pad:
        w = F.pad(w, (0, pad))
    return w, v


def _pad_rows(rows: torch.Tensor, block: int) -> torch.Tensor:
    """The ragged last block of vocab rows ``[width, h]``, padded with
    zero rows to ``[block, h]`` (a copy of ``width`` rows, not of the
    table)."""
    return F.pad(rows, (0, 0, 0, block - rows.shape[0]))


def _vocab_blocks(v: int, block: int) -> List[Tuple[int, int]]:
    """``(base, width)`` of each vocab block; ``width < block`` only for
    the last, ragged one."""
    return [(base, min(block, v - base)) for base in range(0, v, block)]


def _mask_pad_(t: torch.Tensor, width: int, value: float) -> None:
    """Fill the pad columns ``[:, width:]`` of a ragged block with
    ``value`` (``NEG_INF`` in the forward, 0 in the backward)."""
    t[:, width:].fill_(value)


def _write_dw(dwt: torch.Tensor, base: int, width: int,
              blk: torch.Tensor) -> None:
    """Write a block's ``[block, h]`` weight gradient into the vocab rows
    ``[base, base + width)`` of ``dwt``."""
    dwt[base:base + width].copy_(blk[:width])


def _head_rows(w: torch.Tensor, block: int
               ) -> Callable[[int], torch.Tensor]:
    """``base -> [block, h]``: the vocab rows ``[base, base + block)`` of
    the ``[h, V]`` head ``w``, zero rows past V."""
    if w.t().is_contiguous():  # the tied embedding's transpose
        table = w.t()

        def rows(base):
            blk = table[base:base + block]
            return blk if blk.shape[0] == block else _pad_rows(blk, block)
    else:
        wp, _ = _pad_w(w, block)

        def rows(base):
            return wp[:, base:base + block].t()
    return rows


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result from operands of one dtype: on the
    card through ``torch.mm``'s ``out_dtype``, on the CPU by upcasting
    the operands (see the module docstring)."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _FusedCE(torch.autograd.Function):
    """``Σ_valid (lse - logit[target]) * gscale`` of ``x @ w``, where
    ``targets`` are in range and ``valid`` marks the rows that count.
    ``gscale`` is differentiable: its gradient is ``g * Σ nll``, saved in
    the forward."""

    @staticmethod
    def forward(ctx, x, w, targets, valid, gscale, block_vocab):
        n = x.shape[0]
        f32 = dict(dtype=torch.float32, device=x.device)
        rows = _head_rows(w, block_vocab)
        m = torch.full((n,), NEG_INF, **f32)
        l = torch.zeros(n, **f32)
        tgt = torch.full((n,), NEG_INF, **f32)
        ar = torch.arange(n, device=x.device)
        for base, width in _vocab_blocks(w.shape[1], block_vocab):
            logits = _mm_f32(x, rows(base).to(x.dtype).t())  # [N, Vb]
            if width < block_vocab:
                _mask_pad_(logits, width, NEG_INF)  # vocab padding
            # the target's logit, where it falls in this block
            in_blk = (targets >= base) & (targets < base + block_vocab)
            local = (targets - base).clamp_(0, block_vocab - 1)
            tgt = torch.where(in_blk, logits[ar, local], tgt)
            m_new = torch.maximum(m, logits.amax(dim=1))
            l = l * torch.exp(m - m_new) + logits.sub_(
                m_new[:, None]).exp_().sum(dim=1)
            m = m_new
            del logits
        lse = m + torch.log(l.clamp(min=1e-30))
        nll_sum = torch.where(valid, lse - tgt, 0.0).sum()
        ctx.save_for_backward(x, w, targets, valid, lse, gscale, nll_sum)
        ctx.block_vocab = block_vocab
        return nll_sum * gscale

    @staticmethod
    def backward(ctx, g):
        x, w, targets, valid, lse, gscale, nll_sum = ctx.saved_tensors
        block = ctx.block_vocab
        n, h = x.shape
        f32 = dict(dtype=torch.float32, device=x.device)
        rows = _head_rows(w, block)
        # d loss / d logit = gscale * (softmax - onehot) per valid row,
        # times the incoming cotangent
        row = (g * gscale * valid).to(torch.float32)[:, None]
        dx = torch.zeros(n, h, **f32)
        dwt = torch.empty(w.shape[1], h, **f32)  # dW as vocab rows
        ar = torch.arange(n, device=x.device)
        ds = (torch.empty(n, block, dtype=x.dtype, device=x.device)
              if x.dtype != torch.float32 else None)
        for base, width in _vocab_blocks(w.shape[1], block):
            wb = rows(base).to(x.dtype)  # [Vb, h]
            p = _mm_f32(x, wb.t())
            p.sub_(lse[:, None]).exp_()
            if width < block:
                _mask_pad_(p, width, 0.0)
            in_blk = (targets >= base) & (targets < base + block)
            local = (targets - base).clamp_(0, block - 1)
            p.index_put_((ar, local), -in_blk.to(torch.float32),
                         accumulate=True)
            if ds is None:
                d = p.mul_(row)
            else:  # the row scale and the one cast, in one pass
                d = torch.mul(p, row, out=ds)
            del p
            dx += _mm_f32(d, wb)
            _write_dw(dwt, base, width, _mm_f32(d.t(), x))
        dgscale = g * nll_sum if ctx.needs_input_grad[4] else None
        return (dx.to(x.dtype), dwt.to(w.dtype).t(), None, None, dgscale,
                None)


def fused_linear_cross_entropy(
        hidden: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, *,
        valid: Optional[torch.Tensor] = None, block_vocab: int = 8192,
        mean: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy of ``hidden @ w`` against ``targets`` without ever
    materializing the [N, V] logits.

    Args:
      hidden: ``[..., h]`` pre-head activations (any leading shape).
      w: ``[h, V]`` head kernel; for tied embeddings pass
        ``model.tok_emb.embedding.t()`` (read in place, see the module
        docstring).
      targets: ``[...]`` integer class ids (``hidden``'s leading shape).
      valid: ``[...]`` bool; False rows contribute zero (padding,
        unmasked MLM positions). Default: all valid.
      block_vocab: vocab block width (the live-memory knob).
      mean: divide by the number of valid rows (like the model losses).

    Returns ``(loss, n_valid)``. As in the model losses, an out-of-range
    id that is not masked out adds zero loss but still counts in
    ``n_valid`` and the mean's denominator."""
    h = hidden.shape[-1]
    x = hidden.reshape(-1, h)
    t = targets.reshape(-1).long()
    va = (torch.ones(t.shape, dtype=torch.bool, device=t.device)
          if valid is None else valid.reshape(-1))
    in_range = (t >= 0) & (t < w.shape[1])
    contrib = va & in_range
    t = torch.where(in_range, t, 0)
    n_valid = va.sum()
    denom = n_valid.clamp(min=1).to(torch.float32)
    gscale = (1.0 / denom if mean
              else torch.ones((), dtype=torch.float32, device=x.device))
    loss = _FusedCE.apply(x, w, t, contrib, gscale, int(block_vocab))
    return loss, n_valid


def fused_causal_lm_loss(
        hidden: torch.Tensor, w: torch.Tensor, tokens: torch.Tensor, *,
        ignore_index: int = -1, block_vocab: int = 8192
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token LM loss from pre-head activations, the fused
    counterpart of ``models.transformer.causal_lm_loss(logits,
    tokens)``: positions predict ``tokens[:, 1:]``, ``ignore_index``
    targets drop out, and the result is averaged over valid positions.

    ``hidden``: ``[B, T, h]`` (the model called with
    ``return_hidden=True``); ``w``: ``[h, V]`` head kernel (tied:
    ``model.tok_emb.embedding.t()``). Returns ``(loss, n_tokens)``."""
    targets = tokens[:, 1:]
    return fused_linear_cross_entropy(
        hidden[:, :-1], w, targets, valid=targets != ignore_index,
        block_vocab=block_vocab)
