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

Each plan computed is a ``FUSION_PLAN`` instant on the host timeline
(its tensors, buckets and threshold) and a ``metrics.record_fusion_plan``
(the bucket count and each bucket's fill of the threshold), as the JAX
package records its plans (``horovod_tpu/ops/fusion.py:84-104``). The
port plans when an optimizer is built; the JAX package when its step
is traced.
"""

from __future__ import annotations

import hashlib
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


def model_fingerprint(params) -> str:
    """A stable identity of a model's bucketable structure: sha256 over
    each parameter's flax path, shape and dtype in flatten order, the
    inputs :func:`pytree_bucket_plan` derives a plan from, so two models
    share a fingerprint iff they get the same plans at every threshold.
    ``params``: a module (its ``named_parameters()``), a mapping or
    ``(name, tensor)`` pairs; meta tensors do. Value-free and the same
    in every process. It differs from the JAX package's, which also
    hashes ``jax``'s treedef repr."""
    if isinstance(params, torch.nn.Module):
        params = params.named_parameters()
    items = list(params.items() if hasattr(params, "items") else params)
    paths = [flax_path(n) for n, _ in items]
    h = hashlib.sha256(b"horovod_tpu_torch")
    for i in flatten_order(paths):
        t = items[i][1]
        dtype = str(t.dtype).removeprefix("torch.")
        h.update(keystr(paths[i]).encode())
        h.update(repr((tuple(t.shape), dtype)).encode())
    return h.hexdigest()[:16]


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


def _threshold_bytes() -> int:
    """The fusion threshold of a plan given none: the autotuner's
    parameter manager's current candidate when one runs, else the
    knob."""
    from ..core.knobs import Knobs
    from ..core.state import global_state

    st = global_state()
    if st.parameter_manager is not None:
        return st.parameter_manager.fusion_threshold_bytes()
    knobs = st.knobs if st.initialized else Knobs.from_env()
    return knobs.fusion_threshold_bytes


def _defaults(threshold_bytes, backward_order):
    if threshold_bytes is not None and backward_order is not None:
        return threshold_bytes, backward_order
    from ..core.knobs import Knobs
    from ..core.state import global_state

    st = global_state()
    knobs = st.knobs if st.initialized else Knobs.from_env()
    if threshold_bytes is None:
        threshold_bytes = _threshold_bytes()
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
    _record_plan(leaves, plans, threshold_bytes)
    return plans


def _record_plan(leaves, plans: Sequence[BucketPlan],
                 threshold_bytes: int) -> None:
    """The plan's timeline instant and metrics."""
    from ..utils import metrics
    from ..utils.timeline import FUSION_PLAN, active_timeline

    if metrics.enabled():
        bucket_bytes = [
            sum(size for (_, _, size, _) in plan)
            * torch.empty((), dtype=leaves[plan[0][0]][2]).element_size()
            for plan in plans]
        metrics.record_fusion_plan(len(leaves), len(plans),
                                   threshold_bytes, bucket_bytes)
    tl = active_timeline()
    if tl is not None:
        tl.instant("fusion", FUSION_PLAN, args={
            "tensors": len(leaves), "buckets": len(plans),
            "threshold_bytes": threshold_bytes,
        })


def plan_bucket_lengths(plans: Sequence[BucketPlan]) -> List[int]:
    """Element count of each bucket of a plan: the widths the ZeRO and
    FSDP shards and the staged scheduler derive from."""
    return [sum(size for (_, _, size, _) in plan) for plan in plans]


def bucket_issue_schedule(plans: Sequence[BucketPlan],
                          leaf_stages: Sequence[Sequence[int]],
                          backward_stage_order: Sequence[int]
                          ) -> List[List[int]]:
    """When each bucket can be issued during a segmented backward.

    ``leaf_stages[i]`` lists the stages that contribute gradient to leaf
    ``i`` (a tied embedding lists two: the head's contribution and the
    input lookup's); ``backward_stage_order`` is the order the segments'
    backward runs. Returns one list per backward step: the buckets all
    of whose leaves have received every contribution by the end of that
    step, in ascending bucket order. Raises when a bucket never
    completes (the stages do not cover its leaves)."""
    remaining = [len(s) for s in leaf_stages]
    stage_to_leaves: dict = {}
    for i, sids in enumerate(leaf_stages):
        for si in sids:
            stage_to_leaves.setdefault(si, []).append(i)
    pending = list(range(len(plans)))
    schedule = []
    for si in backward_stage_order:
        for i in stage_to_leaves.get(si, ()):
            remaining[i] -= 1
        now = [bi for bi in pending
               if all(remaining[i] == 0 for (i, _, _, _) in plans[bi])]
        for bi in now:
            pending.remove(bi)
        schedule.append(now)
    if pending:
        raise ValueError(
            f"buckets {pending} never complete under this stage "
            "decomposition — some of their leaves receive no gradient "
            "contribution from any stage")
    return schedule


def bucket_prefetch_schedule(plans: Sequence[BucketPlan],
                             leaf_first_stage: Sequence[int],
                             n_stages: int) -> List[List[int]]:
    """When each bucket's parameter all-gather must have completed in a
    segmented forward: at the first stage that touches any of its leaves
    (``leaf_first_stage[i]``, the least of leaf i's stages). One list per
    forward stage. :func:`bucket_issue_schedule` driven over the stages
    in reverse, read backwards."""
    rev = bucket_issue_schedule(
        plans, [[s] for s in leaf_first_stage],
        list(reversed(range(n_stages))))
    return list(reversed(rev))


def bucket_regather_schedule(plans: Sequence[BucketPlan],
                             leaf_last_stage: Sequence[int],
                             n_stages: int) -> List[List[int]]:
    """When each bucket must be gathered again in a segmented backward
    that recomputes its stages: at the LAST forward stage touching any of
    its leaves (``leaf_last_stage[i]``, the greatest of leaf i's stages),
    the first the reversed traversal reaches. One list per backward step
    (index 0: the last forward stage's), each bucket exactly once. Every
    leaf is lifted to its bucket's greatest stage first, since the issue
    schedule waits for all of a bucket's leaves."""
    lifted = list(leaf_last_stage)
    for bp in plans:
        m = max(leaf_last_stage[i] for (i, _, _, _) in bp)
        for (i, _, _, _) in bp:
            lifted[i] = m
    return bucket_issue_schedule(
        plans, [[s] for s in lifted], list(reversed(range(n_stages))))


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


def pack_pytree_by_plan(tensors: Sequence[torch.Tensor],
                        plans: Sequence[BucketPlan]):
    """Pack ``tensors`` (the leaves, in plan order) into the buckets of
    ``plans``, which may come from other tensors of the same layout (the
    gradients packed by the parameters' plan). Returns ``(buckets,
    unflatten)``; ``unflatten(reduced)`` gives the leaves back."""
    nleaves = len(tensors)
    buckets = pack_buckets_by_plan(tensors, plans)

    def unflatten(reduced):
        return unflatten_buckets_by_plan(reduced, plans, nleaves)

    return buckets, unflatten
