"""Parameter conversion between the JAX package's flax trees and the
port's state dicts.

The PyTorch modules (transformer.py, resnet.py, inception.py, vgg.py,
mlp.py) name their parameters after the flax tree, so a tree converts by
joining its path with dots: ``{"block_0": {"attn": {"query": {"kernel":
...}}}}`` becomes ``"block_0.attn.query.kernel"``. The transformer's
layouts already agree (dense kernels ``[in, out]``, q/k/v ``[hidden, H,
D]``, out ``[H, D, hidden]``), so no array is transposed. The CNNs'
convolution kernels are HWIO in flax and OIHW in the port:
:func:`resnet_from_flax` and :func:`resnet_to_flax` transpose every 4-D
kernel, and carry the ``batch_stats`` collection as the norms' ``mean``
and ``var`` buffers. Nothing in them is particular to the ResNet: they
convert Inception V3 (``ConvBN_i.Conv_0`` / ``.BatchNorm_0``), VGG-16,
``MLP`` and ``MnistNet`` (convolution biases, Dense kernels ``[in,
out]`` in both, VGG's and MNIST's flatten in NHWC order in both) and the
MNIST example's ``ConvNet`` as they are. :func:`shards_from_flax` gives
one rank's slices of a transformer tree on a tensor-parallel mesh,
:func:`stage_from_flax` one pipeline stage's blocks and the replicated
rest, and :func:`moe_from_flax` converts a ``MoeMlp``'s tree.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

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


def shards_from_flax(tree: Mapping[str, Any], mesh, rules=None,
                     rank: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """One rank's shards of a flax param tree: :func:`params_from_flax`,
    then the slice of each tensor that ``rank`` (default: the mesh's own)
    keeps on ``mesh`` (``parallel.mesh.Mesh``) by ``rules`` (default the
    transformer rules; ``parallel.sharding.shard_params``)."""
    from ..parallel.sharding import shard_params

    return shard_params(params_from_flax(tree), mesh, rules, rank)


def stage_from_flax(tree: Mapping[str, Any], mesh,
                    rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One pipeline stage's state dict from a flax transformer tree: the
    blocks of ``rank``'s (default: the mesh's own) pp stage, under their
    global names, and everything that is not a block (the embedding,
    positions, ``ln_final``, the head), for a model from
    ``parallel.pipeline.build_stage``."""
    S = mesh.axis_size("pp")
    n = sum(1 for k in tree if re.fullmatch(r"block_\d+", k))
    s = (mesh.coords if rank is None else mesh.coords_of(rank)).get("pp", 0)
    keep = range(s * n // S, (s + 1) * n // S)
    return OrderedDict(
        (k, v) for k, v in params_from_flax(tree).items()
        if not k.startswith("block_")
        or int(k.split(".", 1)[0][len("block_"):]) in keep)


def moe_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``MoeMlp`` tree (``router/{kernel,bias}``, ``w_in`` ``[e,
    hidden, 2·mlp]``, ``w_out`` ``[e, mlp, hidden]``) -> a state dict for
    ``models.moe.MoeMlp``; the layouts agree, nothing is transposed."""
    return params_from_flax(tree)


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


_NORM = re.compile(r"(^|\.)(?:Fused)?BatchNorm_(\d+)(?=\.)")


def rename_norms(state: Mapping[str, Any], fused_bn: bool) -> Dict[str, Any]:
    """``state`` with every ResNet norm named as the fused tree names it
    (``FusedBatchNorm_i``, ``fused_bn=True``) or as the plain tree does
    (``BatchNorm_i``): the two trees differ in nothing else."""
    prefix = "FusedBatchNorm_" if fused_bn else "BatchNorm_"
    return OrderedDict((_NORM.sub(rf"\g<1>{prefix}\2", k), v)
                       for k, v in state.items())


def resnet_from_flax(variables: Mapping[str, Any],
                     fused_bn: Optional[bool] = None
                     ) -> Dict[str, torch.Tensor]:
    """A flax ResNet's variables (``{"params": ..., "batch_stats":
    ...}`` as numpy, or the ``"params"`` tree alone) -> a state dict for
    ``models.resnet.ResNet``: 4-D (HWIO) kernels transposed to OIHW, the
    batch statistics as the norms' ``mean``/``var`` buffers. With
    ``fused_bn`` set, the norms are renamed for the fused (True) or the
    plain (False) model, whichever tree they came from."""
    if "params" not in variables:
        variables = {"params": variables}
    out: Dict[str, torch.Tensor] = OrderedDict()
    for collection in ("params", "batch_stats"):
        for name, t in params_from_flax(
                variables.get(collection, {})).items():
            out[name] = t.permute(3, 2, 0, 1).contiguous() \
                if t.dim() == 4 else t
    return rename_norms(out, fused_bn) if fused_bn is not None else out


def resnet_to_flax(state: Mapping[str, torch.Tensor],
                   fused_bn: Optional[bool] = None) -> Dict[str, Any]:
    """The inverse of :func:`resnet_from_flax`: a ResNet state dict (or
    any mapping of its dotted names to tensors, such as the parameters'
    gradients) -> ``{"params": ..., "batch_stats": ...}`` of float32
    numpy arrays, 4-D kernels back to HWIO; ``"batch_stats"`` only when
    ``state`` holds running statistics."""
    if fused_bn is not None:
        state = rename_norms(state, fused_bn)
    params, stats = {}, {}
    for name, t in state.items():
        t = t.detach()
        if t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        leaf = name.rsplit(".", 1)[-1]
        (stats if leaf in ("mean", "var") else params)[name] = t
    out = {"params": params_to_flax(params)}
    if stats:
        out["batch_stats"] = params_to_flax(stats)
    return out
