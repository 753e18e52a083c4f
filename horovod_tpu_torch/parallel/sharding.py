"""Parameter and batch sharding rules: name pattern -> partition spec.

The counterpart of the JAX package's ``parallel/sharding.py``. There
the specs tell XLA's SPMD partitioner where each tensor lives, and it
inserts the collectives; the port has no partitioner, so the same specs
decide which slice of each parameter a rank keeps (:func:`shard_params`)
and ``parallel/tensor_parallel.py`` issues the exchanges. A spec is a
tuple with one entry per dimension: None (not split), an axis name, or
a tuple of axis names (split over their product, the first outermost).

The default transformer rules are Megatron-style tensor parallelism and
ZeRO-3-style FSDP, matched against the port's dotted parameter names
(``block_0.attn.query.kernel``):

  q/k/v kernels  [embed, heads, head_dim] -> (fsdp, tp, None)
  out kernel     [heads, head_dim, embed] -> (tp, None, fsdp)
  mlp in         [embed, mlp]             -> (fsdp, tp)
  mlp out        [mlp, embed]             -> (tp, fsdp)
  embeddings     [vocab, embed]           -> (tp, fsdp)
  norms, biases  replicated

:func:`_prune_spec` drops an axis the mesh lacks (or has at size 1) and
an axis that does not divide its dimension, which replicates that
dimension: GPT-2's vocab of 50257 stays whole at any tp, a vocab of
32000 is split.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from .mesh import DATA_AXES, Mesh

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]
Rule = Tuple[str, Spec]

TRANSFORMER_RULES: List[Rule] = [
    (r"(query|key|value)\.kernel$", ("fsdp", "tp", None)),
    (r"attn\.out\.kernel$", ("tp", None, "fsdp")),
    (r"(fc1|gate|up)\.kernel$", ("fsdp", "tp")),
    (r"fc2\.kernel$", ("tp", "fsdp")),
    (r"tok_emb\.embedding$", ("tp", "fsdp")),
    (r"lm_head\.kernel$", ("fsdp", "tp")),
    (r"pos_emb$", (None, "fsdp")),
    (r".*", ()),  # everything else (norms, biases) replicated
]

RESNET_RULES: List[Rule] = [
    # conv kernels, OIHW in the port: shard output channels over tp (the
    # JAX package's HWIO kernels shard their last dimension)
    (r"conv[^.]*\.kernel$", ("tp", None, None, None)),
    (r"Dense_\d+\.kernel$", ("fsdp", "tp")),
    (r".*", ()),
]


def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _prune_spec(spec: Spec, mesh: Mesh, shape: Sequence[int]) -> Spec:
    """Drop axes absent from the mesh or of size 1, and axes that do not
    divide their dimension (that dimension is then replicated)."""
    out: List[Entry] = []
    for dim, entry in enumerate(spec):
        kept = tuple(a for a in _axes(entry) if mesh.axis_size(a) > 1)
        prod = math.prod(mesh.axis_size(a) for a in kept)
        if not kept or (dim < len(shape) and shape[dim] % prod):
            out.append(None)
        else:
            out.append(kept if len(kept) > 1 else kept[0])
    return tuple(out)


def spec_for_path(path: str, rules: Sequence[Rule]) -> Spec:
    """The spec of the first rule whose pattern is found in ``path``."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return ()


def make_param_shardings(params, mesh: Mesh,
                         rules: Optional[Sequence[Rule]] = None
                         ) -> Dict[str, Spec]:
    """name -> pruned spec for each of ``params`` (a mapping or an
    iterable of ``(name, tensor)``, e.g. ``named_parameters()``)."""
    rules = TRANSFORMER_RULES if rules is None else rules
    items = params.items() if hasattr(params, "items") else params
    return {name: _prune_spec(spec_for_path(name, rules), mesh,
                             tuple(t.shape))
            for name, t in items}


def local_slice(t: torch.Tensor, spec: Spec, mesh: Mesh,
                rank: Optional[int] = None) -> torch.Tensor:
    """``rank``'s (default: the mesh's own) slice of the full tensor
    ``t`` under ``spec``: along each split dimension, the chunk at the
    rank's row-major position over that entry's axes."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        chunk = t.shape[dim] // math.prod(mesh.axis_size(a) for a in axes)
        t = t.narrow(dim, mesh.group_index(axes, rank) * chunk, chunk)
    return t


def build_device(device, where: str) -> torch.device:
    """``device`` (None: the card) as the device a build draws on. A
    build on the card raises where none is visible: nothing falls back
    to the CPU unless the caller passes ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{where}: no CUDA device; pass device='cpu' "
                           "to run on the CPU")
    return device


def materialize_shards(model, generator: torch.Generator,
                       specs: Optional[Mapping[str, Spec]] = None,
                       mesh: Optional[Mesh] = None):
    """Give ``model`` (built on the meta device) this rank's slice of
    each of its parameters, one parameter at a time, and return it.

    ``model.init_params(generator, sink=...)`` draws each whole
    parameter into a temporary on the generator's device, in the whole
    model's order; the sink keeps the rank's slice of it under its
    pruned spec (:func:`local_slice` on ``mesh``; the whole tensor where
    ``specs`` is None or the spec splits nothing) as the module's
    parameter and drops the rest before the next draw. So a rank holds
    its slices plus at most one whole parameter, never the model, and
    its slices are bitwise those of the whole model drawn from the same
    generator. A pipeline stage (a model of some of the blocks) keeps
    only its own blocks' draws. The JAX package's ``init_fn``
    jit-initializes into the shardings instead."""
    def keep(name: str, whole: torch.Tensor) -> None:
        local = whole if specs is None else local_slice(whole, specs[name],
                                                        mesh)
        if local is not whole:
            local = local.clone(memory_format=torch.contiguous_format)
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = torch.nn.Parameter(
            local, requires_grad=mod._parameters[leaf].requires_grad)

    return model.init_params(generator, sink=keep)


def shard_params(params, mesh: Mesh,
                 rules: Optional[Sequence[Rule]] = None,
                 rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """name -> this rank's (or ``rank``'s) slice of each full parameter,
    a contiguous copy, by the rules' pruned specs."""
    items = dict(params.items() if hasattr(params, "items") else params)
    specs = make_param_shardings(items, mesh, rules)
    return {name: local_slice(t.detach(), specs[name], mesh,
                              rank).contiguous()
            for name, t in items.items()}


def unshard_params(shards: Sequence[Mapping[str, torch.Tensor]],
                   specs: Mapping[str, Spec], mesh: Mesh
                   ) -> Dict[str, torch.Tensor]:
    """The full tensors from every rank's shards (``shards[r]`` is rank
    r's mapping, e.g. its parameters or their gradients): each split
    dimension concatenated over the ranks that hold its chunks, in
    order."""
    out = {}
    for name, spec in specs.items():
        def build(base, dim):
            while dim < len(spec) and not _axes(spec[dim]):
                dim += 1
            if dim == len(spec):
                return shards[mesh.rank_of(base)][name]
            axes = _axes(spec[dim])
            parts = []
            for i in range(math.prod(mesh.axis_size(a) for a in axes)):
                coords, rest = dict(base), i
                for a in reversed(axes):
                    coords[a] = rest % mesh.axis_size(a)
                    rest //= mesh.axis_size(a)
                parts.append(build(coords, dim + 1))
            return torch.cat(parts, dim=dim)

        out[name] = build({a: 0 for a in mesh.axis_names}, 0)
    return out


def batch_sharding(mesh: Mesh, *, seq_axis: Optional[int] = None) -> Spec:
    """The batch's spec: rows over the live data axes (``("dp",)`` when
    none is live), and with ``seq_axis`` the sequence dimension over sp
    when sp is live (the JAX package's ``batch_sharding``'s spec)."""
    batch_axes = tuple(a for a in DATA_AXES
                       if mesh.axis_size(a) > 1) or ("dp",)
    entries: List[Entry] = [batch_axes if len(batch_axes) > 1
                            else batch_axes[0]]
    if seq_axis is not None:
        while len(entries) < seq_axis:
            entries.append(None)
        entries.append("sp" if mesh.axis_size("sp") > 1 else None)
    return tuple(entries)


def batch_slices(mesh: Mesh, rows: int, seq: int,
                 rank: Optional[int] = None) -> Tuple[slice, slice]:
    """The rows and the sequence span of a ``[rows, seq]`` global batch
    that ``rank`` (default: the mesh's own) takes: rows by its position
    over the live data axes, the span by its sp coordinate. Ranks that
    differ only in tp take the same."""
    n = math.prod(mesh.axis_size(a) for a in DATA_AXES)
    sp = mesh.axis_size("sp")
    if rows % n or seq % sp:
        raise ValueError(f"a [{rows}, {seq}] batch does not split over "
                         f"{n} data ranks and {sp} sequence ranks")
    r, t = rows // n, seq // sp
    i = mesh.group_index(DATA_AXES, rank)
    s = mesh.group_index(("sp",), rank)
    return slice(i * r, (i + 1) * r), slice(s * t, (s + 1) * t)
