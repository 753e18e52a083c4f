"""Parameter conversion between the JAX package's flax trees and the
port's state dicts.

The PyTorch modules (transformer.py) name their parameters after the
flax tree, so a tree converts by joining its path with dots:
``{"block_0": {"attn": {"query": {"kernel": ...}}}}`` becomes
``"block_0.attn.query.kernel"``. The layouts already agree (dense
kernels ``[in, out]``, q/k/v ``[hidden, H, D]``, out ``[H, D, hidden]``),
so no array is transposed.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax param tree (nested mappings of arrays, e.g. the
    ``"params"`` collection moved to numpy) -> a state dict for
    ``Transformer.load_state_dict``. Covers ``tok_emb/embedding``,
    ``pos_emb``, ``block_i/{ln_attn,ln_mlp}/{scale,bias}``,
    ``block_i/attn/{query,key,value,out}/{kernel,bias}``,
    ``block_i/mlp/{fc1,fc2,gate,up}/{kernel,bias}``, ``ln_final`` and
    ``lm_head``; ``load_state_dict`` (strict) rejects anything else."""
    out: Dict[str, torch.Tensor] = OrderedDict()

    def walk(node, prefix):
        for key in sorted(node):
            value = node[key]
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                walk(value, name)
            else:
                out[name] = torch.from_numpy(
                    np.array(value, dtype=np.float32, copy=True))

    walk(tree, "")
    return out


def params_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax`: a state dict (or any
    mapping of dotted names to tensors, such as the parameters'
    gradients) -> the nested flax tree of float32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, value in state.items():
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value.detach().to("cpu", torch.float32).numpy()
    return tree
