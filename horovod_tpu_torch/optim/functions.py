"""Parameter, optimizer-state and object broadcast, and the object
allgather.

The counterpart of the JAX package's ``optim/functions.py`` with the
in-place semantics of its ``horovod_tpu/torch`` surface (the reference
Horovod's ``torch/functions.py``): every member of ``process_set``
(default: every rank) ends with root's values; ``root_rank`` is a
global rank, and a rank outside the set keeps its own.
"""

from __future__ import annotations

import pickle
from typing import Any, Optional

import torch

from ..core.basics import _require_init
from ..core.process_sets import set_context
from ..ops.collectives import allgather, broadcast_


def broadcast_parameters(params, root_rank: int = 0,
                         process_set=None) -> None:
    """Broadcast, in place, a ``state_dict()`` or an iterable of
    ``(name, tensor)`` such as ``named_parameters()``."""
    items = list(params.items()) if hasattr(params, "items") else \
        list(params)
    with torch.no_grad():
        for _, p in items:
            if p is not None:
                broadcast_(p.data if hasattr(p, "data") else p, root_rank,
                           process_set=process_set)


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None, process_set=None) -> Any:
    """Root's ``obj`` on every rank, pickled and broadcast as bytes
    (length first). Unpickles only bytes this program's root wrote."""
    del name
    st = _require_init()
    ctx = set_context(process_set)
    if ctx.size == 1 or not ctx.member:
        return obj
    if st.rank == root_rank:
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    else:
        payload = torch.empty(0, dtype=torch.uint8)
    length = torch.tensor([payload.numel()], dtype=torch.int64,
                          device=st.device)
    broadcast_(length, root_rank, process_set=process_set)
    buf = torch.zeros(int(length.item()), dtype=torch.uint8,
                      device=st.device)
    if st.rank == root_rank:
        buf.copy_(payload)
    broadcast_(buf, root_rank, process_set=process_set)
    return pickle.loads(buf.cpu().numpy().tobytes())


def allgather_object(obj: Any, name: Optional[str] = None,
                     process_set=None) -> list:
    """Every member's ``obj``, in set-rank order (torch/functions.py:236):
    each pickled, the lengths and then the bytes all-gathered. Unpickles
    only bytes this program's ranks wrote."""
    del name
    st = _require_init()
    ctx = set_context(process_set)
    if ctx.size == 1 and ctx.member:
        return [obj]
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    payload = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(
        st.device)
    lengths = allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                     device=st.device),
                        process_set=process_set).tolist()
    blob = allgather(payload, process_set=process_set).cpu().numpy()
    out, off = [], 0
    for n in lengths:
        out.append(pickle.loads(blob[off:off + n].tobytes()))
        off += n
    return out


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              process_set=None) -> None:
    """Broadcast a torch optimizer's state from root, in place.

    Root's structure (per-parameter state keys, tensor shapes and
    dtypes, and the non-tensor values such as ``step`` counters and
    hyperparameters) travels first as one object, so a rank whose
    optimizer has not stepped yet builds the same state; then every
    state tensor is broadcast in place and the optimizer reloads it."""
    st = _require_init()
    inner = getattr(optimizer, "_opt", optimizer)
    sd = inner.state_dict()
    if st.rank == root_rank:
        layout = {
            "groups": [{k: v for k, v in g.items() if k != "params"}
                       for g in sd["param_groups"]],
            "state": {pid: {k: (("tensor", tuple(v.shape), str(v.dtype))
                                if torch.is_tensor(v) else ("value", v))
                            for k, v in ps.items()}
                      for pid, ps in sd["state"].items()},
        }
    else:
        layout = None
    layout = broadcast_object(layout, root_rank, process_set=process_set)
    params = [p for g in inner.param_groups for p in g["params"]]
    state = {}
    for pid, entries in sorted(layout["state"].items()):
        mine = sd["state"].get(pid, {})
        state[pid] = {}
        for k, (kind, *rest) in entries.items():
            if kind == "value":
                state[pid][k] = rest[0]
                continue
            shape, dtype = rest
            t = mine.get(k)
            if t is None or tuple(t.shape) != shape:
                dev = params[pid].device if shape else torch.device("cpu")
                t = torch.zeros(shape, dtype=getattr(torch,
                                                     dtype.split(".")[-1]),
                                device=dev)
            # a CPU scalar (e.g. AdamW's step) travels through the
            # process group's device
            moved = t.to(st.device)
            broadcast_(moved, root_rank, process_set=process_set)
            state[pid][k] = moved.to(t.device)
    groups = []
    for g, vals in zip(sd["param_groups"], layout["groups"]):
        groups.append(dict(vals, params=g["params"]))
    inner.load_state_dict({"state": state, "param_groups": groups})
