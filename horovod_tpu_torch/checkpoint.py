"""Model save/load with DistributedOptimizer rehydration, and the
fully-sharded (FSDP) checkpoint.

The port of the JAX package's ``checkpoint.py`` (the reference Horovod's
``keras.load_model``: the saved optimizer is rebuilt from the file and
re-wrapped in ``DistributedOptimizer``, so slot state such as momenta
and Adam's moments carries into retraining). Where the JAX package
writes an orbax tree, the port writes ``torch.save`` files beside a JSON
spec:

* :func:`save_model` writes ``horovod_tpu_torch_model.json`` (the
  wrapper's compression name, ``backward_passes_per_step``, op,
  ``gradient_predivide_factor``, the user's metadata, and the optimizer
  spec ``(name, kwargs)``) and ``state.pt`` (the parameters by name and
  the optimizer's state dict). The spec names a ``torch.optim`` class
  (``("Adam", {"lr": 1e-3})``), where the JAX spec names an optax
  factory; ``load_model(custom_optimizers={name: factory})`` rebuilds
  any other, ``factory(params, **kwargs)``. Call it on rank 0 at a step
  boundary: a ``backward_passes_per_step`` window in progress lives in
  the parameters' ``.grad``, and the int8 wire's error-feedback
  residual is private to each rank; neither is saved, and a load starts
  the residual at zero.
* :func:`load_model` (on every rank) loads the parameters into
  ``model`` (or into new parameters by name), rebuilds the optimizer
  over them, wraps it in ``DistributedOptimizer`` with the saved
  wrapper config (each overridable) and restores its state. Tensors
  land on the model's device, or on ``device``.
* :func:`orbax_rung` is the elastic recovery ladder's last rung over a
  :func:`save_model` checkpoint.
* :func:`save_fsdp` (on every rank) writes this rank's parameter rows
  and shard state, never gathering them, as ``rank_NNNNN.pt``, and rank
  0 writes ``horovod_tpu_torch_fsdp.json`` with the layout's world and
  buckets; :func:`load_fsdp` reads this rank's file back and refuses a
  world other than the checkpoint's (re-slice with
  ``optim.fsdp.reshard_rows``).

Every read and write goes through :func:`_ckpt_io`: the fault points
``checkpoint.save`` and ``checkpoint.restore`` (``utils/faults.py``)
under the shared retry policy (``utils/retry.py``). A file is written
to a temporary name and renamed into place. A JAX (orbax) checkpoint
directory is refused with a message, never read as this format.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import torch

from .optim.compression import Compression
from .optim.distributed import DistributedOptimizer
from .utils import faults, retry

_SPEC_FILE = "horovod_tpu_torch_model.json"
_STATE_FILE = "state.pt"
_FSDP_SPEC_FILE = "horovod_tpu_torch_fsdp.json"
#: what a JAX package checkpoint directory holds (its spec files and
#: the orbax tree)
_JAX_MARKERS = ("horovod_tpu_model.json", "horovod_tpu_fsdp.json", "tree")

_COMPRESSION_NAMES = {
    Compression.none: "none",
    Compression.fp16: "fp16",
    Compression.bf16: "bf16",
    Compression.int8: "int8",
    Compression.int8_raw: "int8-raw",
}
_COMPRESSION_BY_NAME = {v: k for k, v in _COMPRESSION_NAMES.items()}


def _ckpt_io(point: str, fn: Callable, *args, **kwargs):
    """Checkpoint I/O under the shared retry policy: a transiently
    failing filesystem (an OSError) backs off and retries instead of
    losing the checkpoint; the ``checkpoint.save`` /
    ``checkpoint.restore`` fault points exercise this path."""
    def _do():
        faults.inject(point)
        return fn(*args, **kwargs)

    return retry.default_policy().call(_do, point=point)


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def _write_torch(path: str, obj) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _read_spec(path: str, name: str) -> dict:
    """The JSON spec ``name`` of the checkpoint at ``path``; a JAX
    package checkpoint, or a directory without the spec, raises."""
    spec = os.path.join(path, name)
    if not os.path.exists(spec):
        jax = [m for m in _JAX_MARKERS
               if os.path.exists(os.path.join(path, m))]
        if jax:
            raise ValueError(
                f"{path} is a JAX package (orbax) checkpoint ({', '.join(jax)}"
                "), not horovod_tpu_torch's torch.save format: restore it "
                "with horovod_tpu.checkpoint, or convert its parameters "
                "with horovod_tpu_torch.models.convert.params_from_flax")
        raise FileNotFoundError(f"no {name} at {path}: not a "
                                "horovod_tpu_torch checkpoint")
    with open(spec) as f:
        return json.load(f)


class LoadedModel(NamedTuple):
    """What retraining needs: the parameters by name, a ready
    DistributedOptimizer over them, its restored state dict (None if
    none was saved) and the user's metadata."""

    params: Dict[str, torch.Tensor]
    optimizer: Any
    opt_state: Any
    metadata: Dict[str, Any]


def _named_tensors(params) -> Dict[str, torch.Tensor]:
    """A module's parameters by name, or a mapping of names to tensors,
    detached."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    if not isinstance(params, Mapping):
        raise TypeError("save_model takes a torch.nn.Module or a mapping of "
                        f"names to tensors, got {type(params).__name__}")
    return {str(k): v.detach() for k, v in params.items()}


def save_model(path: str, params, opt_state: Any = None,
               optimizer_spec: Optional[tuple] = None,
               compression=Compression.none,
               backward_passes_per_step: int = 1, op=None,
               gradient_predivide_factor: float = 1.0,
               metadata: Optional[Dict[str, Any]] = None) -> None:
    """Save the parameters (a module or a mapping of names to tensors),
    with the optimizer's slot state (``opt_state``: its state dict, or
    the optimizer) and the spec to rebuild it.

    ``optimizer_spec`` is ``(name, kwargs)`` naming a ``torch.optim``
    class, e.g. ``("Adam", {"lr": 1e-3})``; custom optimizers save by
    name and load through ``load_model(custom_optimizers={name:
    factory})``. The wrapper's config (``compression``, one of the
    built-in ``Compression`` variants, ``backward_passes_per_step``,
    ``op``, ``gradient_predivide_factor``) is saved beside it."""
    from .ops.collectives import ReduceOp

    if compression not in _COMPRESSION_NAMES:
        # a silently dropped custom compressor would change the wire's
        # numerics on reload with no error
        raise ValueError(
            "save_model can only serialize the built-in Compression "
            "variants (none/fp16/bf16/int8/int8-raw); re-wrap custom "
            "compressors yourself after load_model")
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    if op is None:
        op = ReduceOp.AVERAGE  # DistributedOptimizer's default
    if opt_state is not None and hasattr(opt_state, "state_dict"):
        opt_state = opt_state.state_dict()
    spec: Dict[str, Any] = {
        "format": 1,
        "has_opt_state": opt_state is not None,
        "metadata": metadata or {},
        "wrapper": {
            "compression": _COMPRESSION_NAMES[compression],
            "backward_passes_per_step": int(backward_passes_per_step),
            "op": int(op),
            "gradient_predivide_factor": float(gradient_predivide_factor),
        },
    }
    if optimizer_spec is not None:
        name, kwargs = optimizer_spec
        spec["optimizer"] = {"name": str(name), "kwargs": dict(kwargs)}
    state = {"params": _named_tensors(params)}
    if opt_state is not None:
        state["opt_state"] = opt_state

    def _save():
        _write_torch(os.path.join(path, _STATE_FILE), state)
        _write_json(os.path.join(path, _SPEC_FILE), spec)

    _ckpt_io("checkpoint.save", _save)


def _load_state(path: str, device) -> dict:
    return _ckpt_io("checkpoint.restore", torch.load,
                    os.path.join(path, _STATE_FILE), map_location=device,
                    weights_only=True)


def load_params(path: str, device=None):
    """Parameters only, no optimizer rebuild: ``(params by name,
    metadata)``, the tensors on ``device`` (default: where they were
    saved from, else the CPU)."""
    path = os.path.abspath(path)
    spec = _read_spec(path, _SPEC_FILE)
    state = _load_state(path, device)
    return state["params"], dict(spec.get("metadata", {}))


def _build_optimizer(spec, params, custom_optimizers):
    name, kwargs = spec["name"], spec.get("kwargs", {})
    if custom_optimizers and name in custom_optimizers:
        return custom_optimizers[name](params, **kwargs)
    cls = getattr(torch.optim, name, None)
    if isinstance(cls, type) and issubclass(cls, torch.optim.Optimizer):
        return cls(params, **kwargs)
    raise ValueError(
        f"unknown optimizer {name!r}: not a torch.optim class; pass "
        f"custom_optimizers={{{name!r}: factory}} (reference load_model "
        "custom_optimizers, keras/__init__.py:181)")


def load_model(path: str, model: Optional[torch.nn.Module] = None,
               custom_optimizers: Optional[Dict[str, Callable]] = None,
               compression=None, device=None,
               **distributed_kwargs) -> LoadedModel:
    """Load a saved model and re-wrap its optimizer in
    ``DistributedOptimizer`` (reference keras/__init__.py:181).

    With ``model`` the saved parameters are copied into it and the
    optimizer is built over its parameters; without it, over new
    parameters by name on ``device`` (default: the CPU). The inner
    optimizer comes from the saved spec (``torch.optim.<name>`` or
    ``custom_optimizers[name]``); the wrapper's config is the saved one
    unless overridden here (``compression``, ``distributed_kwargs``);
    the saved slot state is loaded into the rebuilt optimizer, so
    training continues where it stopped. ``device`` places the new
    parameters when there is no ``model``."""
    from .ops.collectives import ReduceOp

    path = os.path.abspath(path)
    spec = _read_spec(path, _SPEC_FILE)
    opt_spec = spec.get("optimizer")
    if opt_spec is None:
        raise ValueError(
            f"checkpoint at {path} was saved without an optimizer_spec; "
            "pass one to save_model to enable optimizer rehydration")
    wrapper = dict(spec.get("wrapper", {}))
    if compression is None:
        compression = _COMPRESSION_BY_NAME.get(
            wrapper.get("compression", "none"), Compression.none)
    wrapper_kwargs = {
        "backward_passes_per_step": int(
            wrapper.get("backward_passes_per_step", 1)),
        "op": ReduceOp(int(wrapper.get("op", int(ReduceOp.AVERAGE)))),
        "gradient_predivide_factor": float(
            wrapper.get("gradient_predivide_factor", 1.0)),
    }
    wrapper_kwargs.update(distributed_kwargs)

    # read onto the CPU: the parameters are copied to their device, and
    # the optimizer's load_state_dict moves its state to its parameters'
    # (keeping the step counts where torch.optim keeps them)
    state = _load_state(path, "cpu")
    saved = state["params"]
    if model is not None:
        named = dict(model.named_parameters())
        missing = sorted(set(saved) ^ set(named))
        if missing:
            raise ValueError(f"checkpoint at {path} and the model differ in "
                             f"parameters {missing}")
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(saved[k])
    else:
        named = {k: torch.nn.Parameter(v.to(device or "cpu"))
                 for k, v in saved.items()}
    inner = _build_optimizer(opt_spec, list(named.values()),
                             custom_optimizers)
    optimizer = DistributedOptimizer(inner,
                                     named_parameters=list(named.items()),
                                     compression=compression,
                                     **wrapper_kwargs)
    opt_state = state.get("opt_state") if spec.get("has_opt_state") \
        else None
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)
    return LoadedModel(params=named, optimizer=optimizer,
                       opt_state=opt_state,
                       metadata=dict(spec.get("metadata", {})))


def orbax_rung(path: str, attrs: Optional[Dict[str, str]] = None):
    """The checkpoint rung of the elastic recovery ladder
    (``elastic/replication.run_recovery_ladder``; the JAX package's
    ``checkpoint.orbax_rung``, ``horovod_tpu/checkpoint.py:139-180``,
    whose name it keeps; the checkpoint under it is :func:`save_model`'s
    ``torch.save`` file, read as :func:`load_model` reads it): a
    callable ``fn(state) -> bool`` that restores the checkpoint into
    elastic-state attributes when the fresher rungs fall through.

    ``attrs`` maps a state attribute to the checkpoint's entry,
    ``"params"`` or ``"opt_state"`` (default: ``model`` and ``params``
    take the parameters, ``optimizer`` and ``opt_state`` the optimizer's
    state dict). A module attribute gets the parameters copied in place
    by name, an optimizer attribute loads the state dict, any other
    attribute is replaced; attributes the state does not have, or the
    checkpoint does not carry, are left alone. Attach it before
    ``hvd.elastic.run``::

        state = hvd.elastic.TorchState(model=model, optimizer=opt)
        state.orbax_restore = hvd.checkpoint.orbax_rung("/ckpt/latest")
    """
    mapping = dict(attrs) if attrs else {
        "model": "params", "params": "params",
        "optimizer": "opt_state", "opt_state": "opt_state"}

    def _restore(state) -> bool:
        root = os.path.abspath(path)
        spec = _read_spec(root, _SPEC_FILE)
        raw = _load_state(root, "cpu")
        if not spec.get("has_opt_state"):
            raw.pop("opt_state", None)
        restored = False
        for attr, key in mapping.items():
            if key not in raw or attr not in state._known:
                continue
            target = getattr(state, attr)
            if isinstance(target, torch.nn.Module):
                named = dict(target.named_parameters())
                missing = sorted(set(raw[key]) ^ set(named))
                if missing:
                    raise ValueError(f"checkpoint at {root} and the model "
                                     f"differ in parameters {missing}")
                with torch.no_grad():
                    for k, p in named.items():
                        p.copy_(raw[key][k])
            elif hasattr(target, "load_state_dict") and key == "opt_state":
                target.load_state_dict(raw[key])
            else:
                setattr(state, attr, raw[key])
            restored = True
        return restored

    return _restore


# -- fully-sharded parameters -------------------------------------------------

def _rank_file(rank: int) -> str:
    return f"rank_{rank:05d}.pt"


def _own_rows(rows, layout) -> Dict[str, torch.Tensor]:
    """This rank's ``(k_i,)`` rows by bucket name, from the optimizer's
    ``shards`` (a list in bucket order) or a mapping of bucket names to
    ``(k_i,)`` shards or ``(1, k_i)`` rows."""
    from .optim.fsdp import bucket_name

    if not isinstance(rows, Mapping):
        rows = {bucket_name(i): r for i, r in enumerate(rows)}
    out = {}
    for i, k in enumerate(layout.ks):
        name = bucket_name(i)
        r = rows[name].detach()
        if r.numel() != k or (r.dim() == 2 and r.shape[0] != 1):
            raise ValueError(
                f"save_fsdp: {name} has shape {tuple(r.shape)}; a rank "
                f"writes its own ({k},) row of the ({layout.world}, {k}) "
                "stack, never a gathered one")
        out[name] = r.reshape(-1)
    return out


def save_fsdp(path: str, rows, layout, opt_state: Any = None,
              metadata: Optional[Dict[str, Any]] = None) -> None:
    """Save this rank's FSDP parameter rows and shard state without
    gathering them: every rank calls it and writes its own file.

    ``rows``: this rank's ``(k_i,)`` rows (``FullyShardedOptimizer``'s
    ``shards``, or a mapping of bucket names to rows). ``layout``: the
    ``FsdpLayout`` they were sharded with; its world and buckets go to
    the spec, so :func:`load_fsdp` can refuse another world.
    ``opt_state``: the inner optimizer's state dict, or the
    ``FullyShardedOptimizer`` itself (then its error-feedback residual
    rows are saved too)."""
    from .core.basics import _require_init

    rank = _require_init().rank
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    residual = None
    if opt_state is not None and hasattr(opt_state, "state_dict"):
        residual = getattr(opt_state, "residuals", None)
        opt_state = opt_state.state_dict()
    mine = {"rows": _own_rows(rows, layout), "opt_state": opt_state,
            "residual": (None if residual is None
                         else [r.detach() for r in residual])}
    spec: Dict[str, Any] = {
        "format": 1,
        "kind": "fsdp_rows",
        "world": int(layout.world),
        "has_opt_state": opt_state is not None,
        "buckets": [{"index": i, "len": int(L), "k": int(k),
                     "dtype": str(d).replace("torch.", "")}
                    for i, (L, k, d) in enumerate(
                        zip(layout.lens, layout.ks, layout.dtypes))],
        "metadata": metadata or {},
    }

    def _save():
        _write_torch(os.path.join(path, _rank_file(rank)), mine)
        if rank == 0:
            _write_json(os.path.join(path, _FSDP_SPEC_FILE), spec)

    _ckpt_io("checkpoint.save", _save)


def load_fsdp(path: str, world: Optional[int] = None, optimizer=None):
    """Restore this rank's FSDP rows saved by :func:`save_fsdp`: each
    rank reads only its own file. ``world`` (default: the initialized
    world's size) must be the checkpoint's; another raises, pointing at
    ``optim.fsdp.reshard_rows``. Returns ``(rows, opt_state,
    metadata)``: ``rows`` by bucket name, ``(k_i,)`` each. With
    ``optimizer`` (a ``FullyShardedOptimizer``) the rows land on its
    shards' device and are copied into its shards, and its state (and
    error-feedback residual rows, when saved) restored; without one
    they stay on the CPU."""
    from .core.basics import _require_init
    from .optim.fsdp import bucket_name

    st = _require_init()
    world = st.size if world is None else world
    path = os.path.abspath(path)
    spec = _read_spec(path, _FSDP_SPEC_FILE)
    saved_world = int(spec["world"])
    if int(world) != saved_world:
        raise ValueError(
            f"checkpoint at {path} was sharded for world {saved_world} but "
            f"this world has {world} ranks — restore on a world of "
            f"{saved_world}, or restore there and re-slice with "
            "horovod_tpu_torch.optim.fsdp.reshard_rows")
    mine = _ckpt_io("checkpoint.restore", torch.load,
                    os.path.join(path, _rank_file(st.rank)),
                    map_location="cpu", weights_only=True)
    device = optimizer.shards[0].device if optimizer is not None else "cpu"
    rows = {k: v.to(device) for k, v in mine["rows"].items()}
    for b in spec["buckets"]:
        r = rows[bucket_name(b["index"])]
        if r.numel() != b["k"]:
            raise ValueError(f"{path}: {bucket_name(b['index'])} holds "
                             f"{r.numel()} elements, the spec {b['k']}")
    opt_state = mine["opt_state"] if spec.get("has_opt_state") else None
    if optimizer is not None:
        if len(optimizer.shards) != len(rows):
            raise ValueError(f"{path} holds {len(rows)} buckets, the "
                             f"optimizer {len(optimizer.shards)}")
        with torch.no_grad():
            for i, s in enumerate(optimizer.shards):
                s.copy_(rows[bucket_name(i)])
        if opt_state is not None:
            optimizer.load_state_dict(opt_state)
        if mine.get("residual") is not None:
            optimizer.residuals = [r.to(device) for r in mine["residual"]]
    return rows, opt_state, dict(spec.get("metadata", {}))
