"""Mixture-of-Experts layer with expert parallelism over an ep axis.

The counterpart of the JAX package's ``models/moe.py``: top-k token
routing with the Switch load-balancing aux loss, SwiGLU experts, and
two paths:

* **dense** (no ep communicator): every rank computes every expert for
  every token, four einsums over the expert dimension;
* **expert parallel** (``ep``, the ep axis's communicator,
  ``Mesh.comm("ep")``): the experts split over the ep ranks, each rank
  routing its own tokens into ``[experts, capacity, hidden]`` buckets
  (a (token, k) pair past its expert's capacity is dropped), one
  all-to-all carrying each bucket to its expert's rank and one carrying
  the results back (``parallel/ulysses._AllToAll``: the backward is the
  reverse exchange).

The JAX layer reads the bound mesh axes to choose; the port takes the
communicator explicitly. Both paths hold the same full ``[e, ...]``
parameters; an ep rank uses its slice of them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import Dense, _softmax

#: flax's truncated normal divides the standard deviation by the std of
#: a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, variance 1 / fan_in, the fans reckoned as flax's
    ``_compute_fans`` does (in axis -2, out axis -1, the leading axes a
    receptive field)."""
    receptive = math.prod(t.shape[:-2])
    fan_in = t.shape[-2] * receptive
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, descending, ties
    to the lower index. ``torch.topk`` makes no promise on the order of
    equal values, so this takes the first k of a stable descending
    sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def bucket_positions(flat_idx: torch.Tensor, num_experts: int,
                     capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, k) pair's position in its expert's bucket, counted in
    token-major ``(t, k)`` order, and whether it fits the capacity."""
    onehot = F.one_hot(flat_idx, num_experts)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    return pos, pos < capacity


def _dispatch(buckets: torch.Tensor, comm) -> torch.Tensor:
    """``[e, c, h]`` buckets -> the ``[ep · e/ep, c, h]`` rows of this
    rank's experts, from every rank in rank order."""
    from ..parallel.ulysses import _AllToAll

    return _AllToAll.apply(buckets, comm, 0, 0)


def _combine(out: torch.Tensor, comm) -> torch.Tensor:
    """The experts' results back to the ranks whose tokens they are:
    ``[e, c, h]``, expert-major."""
    from ..parallel.ulysses import _AllToAll

    return _AllToAll.apply(out, comm, 0, 0)


class MoeMlp(nn.Module):
    """Top-k routed expert MLP (SwiGLU experts); the JAX fields, and
    ``ep``, the ep axis's communicator (None: the dense path). Takes
    ``[tokens, hidden]`` and returns ``([tokens, hidden], aux_loss)``;
    ``num_experts`` must divide by the ep ranks."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_experts: int = 8,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 router_aux_weight: float = 0.01, ep=None):
        super().__init__()
        self.hidden_size, self.mlp_dim = hidden_size, mlp_dim
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.dtype, self.router_aux_weight = dtype, router_aux_weight
        self.ep = ep
        e = num_experts
        self.router = Dense((hidden_size,), (e,), torch.float32)
        self.w_in = nn.Parameter(torch.zeros(e, hidden_size, 2 * mlp_dim))
        self.w_out = nn.Parameter(torch.zeros(e, mlp_dim, hidden_size))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "MoeMlp":
        """flax's initializers, in flax's order: ``lecun_normal`` for the
        router's kernel, ``w_in`` and ``w_out``, a zero router bias.
        ``generator`` must live on the parameters' device."""
        for p in (self.router.kernel, self.w_in, self.w_out):
            _lecun_normal_(p, generator)
        self.router.bias.zero_()
        return self

    def route(self, x: torch.Tensor):
        """``(probs, gate_idx, gate_vals, aux)``: the float32 router's
        softmax, its top k (gates renormalized over the k) and the
        load-balancing aux loss (Switch Transformer eq. 4, on each
        token's first choice)."""
        e, k = self.num_experts, self.top_k
        probs = _softmax(self.router(x.to(torch.float32)))
        gate_vals, gate_idx = top_k(probs, k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
        me = probs.mean(0)
        ce = F.one_hot(gate_idx[:, 0], e).to(torch.float32).mean(0)
        aux = self.router_aux_weight * e * torch.sum(me * ce)
        return probs, gate_idx, gate_vals, aux

    def forward(self, x: torch.Tensor):
        _, gate_idx, gate_vals, aux = self.route(x)
        w_in, w_out = self.w_in.to(self.dtype), self.w_out.to(self.dtype)
        if self.ep is not None and self.ep.size > 1:
            y = self._expert_parallel(x, gate_idx, gate_vals, w_in, w_out)
        else:
            y = self._dense(x, gate_idx, gate_vals, w_in, w_out)
        return y.to(x.dtype), aux

    def _experts(self, xs, w_in, w_out, spec_in, spec_out):
        up = torch.einsum(spec_in, xs, w_in)
        g, u = up.chunk(2, dim=-1)
        return torch.einsum(spec_out, F.silu(g) * u, w_out)

    def _dense(self, x, gate_idx, gate_vals, w_in, w_out):
        """All experts on every rank: one einsum over the expert dim."""
        xc = x.to(self.dtype)
        per_expert = self._experts(xc, w_in, w_out, "th,ehm->tem",
                                   "tem,emh->teh")
        mask = F.one_hot(gate_idx, self.num_experts).to(self.dtype)
        weights = torch.einsum("tke,tk->te", mask,
                               gate_vals.to(self.dtype))
        return torch.einsum("teh,te->th", per_expert, weights)

    def capacity(self, tokens: int) -> int:
        """A bucket's rows: ``int(capacity_factor · k · t / e) + 1``."""
        return int(self.capacity_factor * self.top_k * tokens
                   / self.num_experts) + 1

    def _expert_parallel(self, x, gate_idx, gate_vals, w_in, w_out):
        """Capacity buckets of this rank's tokens, carried to the ranks
        of their experts and back by two all-to-alls."""
        comm = self.ep
        t, h = x.shape
        e, k, ep = self.num_experts, self.top_k, comm.size
        if e % ep:
            raise ValueError(f"{e} experts do not split over {ep} ep ranks")
        local_e = e // ep
        capacity = self.capacity(t)
        flat_idx = gate_idx.reshape(-1)  # [t·k], token-major
        pos, keep = bucket_positions(flat_idx, e, capacity)
        tok = torch.arange(t, device=x.device).repeat_interleave(k)
        xc = x.to(self.dtype)
        buckets = xc.new_zeros(e, capacity, h).index_put(
            (flat_idx[keep], pos[keep]), xc[tok[keep]])
        recv = _dispatch(buckets, comm).reshape(ep, local_e, capacity, h)
        lo = comm.rank * local_e
        out = self._experts(recv, w_in[lo:lo + local_e],
                            w_out[lo:lo + local_e], "slch,lhm->slcm",
                            "slcm,lmh->slch")
        back = _combine(out.reshape(e, capacity, h), comm)
        zero = torch.zeros_like(flat_idx)
        gathered = back[torch.where(keep, flat_idx, zero),
                        torch.where(keep, pos, zero)]
        gathered = torch.where(keep[:, None], gathered,
                               torch.zeros_like(gathered))
        weighted = (gathered * gate_vals.reshape(-1, 1).to(self.dtype)
                    ).reshape(t, k, h)
        y = weighted[:, 0]
        for j in range(1, k):  # a token's k contributions in k order
            y = y + weighted[:, j]
        return y
