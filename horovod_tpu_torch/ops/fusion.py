"""Tensor fusion: pack many gradients into few collectives.

The counterpart of the JAX package's ``ops/fusion.py`` bucket plan:
leaves are grouped by dtype and packed greedily into buckets bounded by
the fusion threshold (``HOROVOD_FUSION_THRESHOLD``, 128 MiB), one
collective per bucket, results sliced back out.

The plan must be the JAX package's, leaf for leaf, because it decides
which gradients travel together and in what order. JAX computes it over
``jax.tree_util.tree_flatten_with_path`` of the flax parameter tree,
which sorts dict keys at every level (``block_10`` before ``block_2``),
and breaks ties in ``_backward_availability_order`` by reversed
traversal order. So the port names each leaf by its flax path
(``block_0.attn.query.kernel`` -> ``("block_0", "attn", "query",
"kernel")``), orders leaves as that traversal does
(:func:`flatten_order`), and never uses PyTorch's registration order.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import torch

Path = Tuple[str, ...]
#: one bucket's layout: (leaf index, offset, size, shape) per leaf
BucketPlan = List[Tuple[int, int, int, Tuple[int, ...]]]


def flax_path(name: str) -> Path:
    """The flax path of a ``named_parameters()`` name."""
    return tuple(name.split("."))


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr`` of a dict-key path: ``['a']['b']``."""
    return "".join(f"['{k}']" for k in path)


def flatten_order(paths: Sequence[Path]) -> List[int]:
    """Indices of ``paths`` in the order ``tree_flatten`` visits the
    nested dict they form (sorted keys at every level)."""
    return sorted(range(len(paths)), key=lambda i: paths[i])


def _backward_availability_order(paths: Sequence[Path]) -> List[int]:
    """Leaf order approximating when backward produces each gradient,
    earliest first (the JAX package's rule, on flatten-ordered paths):
    head-side leaves without a layer index, then numbered layers in
    descending order, then embeddings; ties by reversed traversal
    order. A numbered name counts as a layer only when its prefix
    occurs with at least two indices."""
    pat = re.compile(r"([a-z_]+?)_?(\d+)")
    infos = []
    stacks: dict = {}
    for p in paths:
        s = keystr(p).lower()
        m = pat.search(s)
        infos.append((s, m))
        if m:
            stacks.setdefault(m.group(1), set()).add(int(m.group(2)))
    keys = []
    for i, (s, m) in enumerate(infos):
        if "emb" in s:
            keys.append((2, 0, -i))
        elif m and len(stacks[m.group(1)]) >= 2:
            keys.append((1, -int(m.group(2)), -i))
        else:
            keys.append((0, 0, -i))
    return sorted(range(len(paths)), key=lambda i: keys[i])


def _defaults(threshold_bytes, backward_order):
    if threshold_bytes is not None and backward_order is not None:
        return threshold_bytes, backward_order
    from ..core.knobs import Knobs
    from ..core.state import global_state

    st = global_state()
    knobs = st.knobs if st.initialized else Knobs.from_env()
    if threshold_bytes is None:
        threshold_bytes = knobs.fusion_threshold_bytes
    if backward_order is None:
        backward_order = knobs.bucket_backward_order
    return threshold_bytes, backward_order


def pytree_bucket_plan(leaves: Sequence[Tuple[Path, Sequence[int],
                                              torch.dtype]],
                       threshold_bytes: Optional[int] = None,
                       backward_order: Optional[bool] = None
                       ) -> List[BucketPlan]:
    """The bucket plan of ``leaves``, a list of ``(flax path, shape,
    dtype)`` in flatten order (:func:`flatten_order`). Returns one list
    per bucket of ``(leaf index, offset, size, shape)``, exactly as the
    JAX package's ``pytree_bucket_plan`` returns its ``plans``.
    ``threshold_bytes`` and ``backward_order`` default to the knobs."""
    threshold_bytes, backward_order = _defaults(threshold_bytes,
                                                backward_order)
    if backward_order:
        order = _backward_availability_order([p for p, _, _ in leaves])
    else:
        order = range(len(leaves))
    by_dtype: dict = {}
    for i in order:
        by_dtype.setdefault(leaves[i][2], []).append(i)

    plans: List[BucketPlan] = []
    for dtype, idxs in by_dtype.items():
        itemsize = torch.empty((), dtype=dtype).element_size()
        cur: BucketPlan = []
        cur_bytes = off = 0
        for i in idxs:
            shape = tuple(int(d) for d in leaves[i][1])
            size = 1
            for d in shape:
                size *= d
            nbytes = size * itemsize
            if cur and cur_bytes + nbytes > threshold_bytes:
                plans.append(cur)
                cur, cur_bytes, off = [], 0, 0
            cur.append((i, off, size, shape))
            off += size
            cur_bytes += nbytes
        if cur:
            plans.append(cur)
    return plans


def pack_buckets_by_plan(tensors: Sequence[torch.Tensor],
                         plans: Sequence[BucketPlan]) -> List[torch.Tensor]:
    """One flat tensor per bucket: its leaves' values concatenated (a
    new tensor, never a view of a leaf)."""
    return [torch.cat([tensors[i].reshape(-1) for (i, _, _, _) in plan])
            for plan in plans]


def unflatten_buckets_by_plan(buckets: Sequence[torch.Tensor],
                              plans: Sequence[BucketPlan],
                              nleaves: int) -> List[torch.Tensor]:
    """The leaves back out of per-bucket payloads (views into them)."""
    leaves: List[Optional[torch.Tensor]] = [None] * nleaves
    for bucket, plan in zip(buckets, plans):
        for (i, off, n, shape) in plan:
            leaves[i] = bucket[off:off + n].view(shape)
    return leaves
