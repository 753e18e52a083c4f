"""Inference engine: checkpoint restore + a CUDA graph per batch bucket.

The PyTorch counterpart of the JAX package's ``serving/engine.py``.
Request batches vary in size; the engine serves each from the smallest
covering bucket of a small padded ladder (``HOROVOD_SERVING_BUCKETS``,
default ``1,4,16,64``). Where the JAX package AOT-compiles one program
per ``(bucket, feature shape, dtype)``, the engine captures one CUDA
graph per key, with a static input batch on the card that each request
is copied into (zero-padded to the bucket) and a static output that is
copied back: a replay launches the whole forward without a Python
dispatch per kernel. Graphs are cached under the JAX package's LRU of
32; an evicted graph frees its memory. On the CPU, which has no
graphs, the same step runs directly.

Parameters come back from the checkpoint layer
(``checkpoint.load_params``) as a name -> tensor mapping on the
engine's device; ``apply_fn(params, x)`` is the pure forward.

The ``serving.replica_exec`` fault point fires before every executed
batch, so the chaos tooling (utils/faults.py) can kill or error a
replica mid-request and prove the dispatch tier's retry path works.

Metrics, as in the JAX package: each executed batch
(``record_serving_batch``, its bucket and real examples) and each
bucket's step built (``record_serving_compile``). The build is timed at
the graph's capture, the port's counterpart of the JAX package's AOT
compile; on the CPU, which has no graphs, a step is only created, and
its seconds are 0. Both records are made around the replay, never
inside a captured step (a call inside one would run at capture only).

With ``mesh`` the parameters are placed by the ``parallel/`` sharding
rules, as the JAX package places them: each rank computes its slice of
every leaf (``engine.shards``, bitwise the JAX array's shard on that
device), and requests are replicated over the mesh, so every rank
returns the same output. The port cannot partition an arbitrary
``apply_fn(params, x)`` as XLA does, so the bucket graphs read the
whole leaves every rank loaded: a rank holds the whole parameters where
a JAX device holds its shard (``engine.resident_param_bytes`` against
``engine.shard_param_bytes``; ROADMAP queue C).

Not ported yet: the autotune warm start from ``HOROVOD_AUTOTUNE_CACHE``
(ROADMAP queue A entry 12), refused.

The module also holds what both engines share: the serving knobs, the
device rule (the card unless the caller asks for the CPU) and the
graph-cache entry with its capture (:class:`GraphStep`,
:func:`capture_step`).
"""

from __future__ import annotations

import importlib
import math
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.knobs import Knobs
from ..ops import _build
from ..utils import faults, metrics

#: checkpoint metadata key under which a serving process finds the
#: model description it rebuilds the model from
SERVING_META_KEY = "serving"


def serving_knobs() -> Knobs:
    """The serving_* knob source: a fresh parse of the environment (a
    serving process has no training world whose knobs it could share)."""
    return Knobs.from_env()


def resolve_device(device, what: str) -> torch.device:
    """``device``, or the current card when it is None; without a card
    that raises: the engines never fall back to the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device by default and found none; "
                "pass device='cpu' to serve on the host through the plain "
                "PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def parse_buckets(spec: Optional[str] = None) -> Tuple[int, ...]:
    """``HOROVOD_SERVING_BUCKETS`` ("1,4,16,64") -> sorted unique ints."""
    if spec is None:
        spec = serving_knobs().serving_buckets or "1,4,16,64"
    out = sorted({int(b) for b in str(spec).replace(";", ",").split(",")
                  if str(b).strip()})
    if not out or out[0] < 1:
        raise ValueError(f"invalid serving bucket spec {spec!r}")
    return tuple(out)


def build_apply_fn(metadata: Dict[str, Any]) -> Callable:
    """Rebuild ``apply_fn(params, x)`` from checkpoint metadata.

    * ``{"model": "mlp", "features": [128, 64, 10], "input_shape":
      [8]}`` — the built-in MLP family (models/mlp.py) through
      ``torch.func.functional_call``. The port's ``MLP`` takes its
      input width as an argument where flax infers it, so the
      flattened ``input_shape`` is required;
    * ``{"model": "pkg.mod:factory", "kwargs": {...}}`` — an import
      path to a factory returning ``apply_fn``.
    """
    m = dict(metadata.get(SERVING_META_KEY, {}))
    name = m.get("model", "")
    if name == "mlp":
        from ..models.mlp import MLP

        shape = m.get("input_shape")
        if not shape:
            raise ValueError(
                "an mlp serving checkpoint needs metadata['serving']"
                "['input_shape']: the MLP's input width comes from it")
        with torch.device("meta"):
            mod = MLP(math.prod(int(d) for d in shape),
                      features=tuple(m.get("features", (128, 64, 10))))
        return lambda p, x: torch.func.functional_call(mod, p, (x,))
    if ":" in name:
        mod_name, _, attr = name.partition(":")
        factory = getattr(importlib.import_module(mod_name), attr)
        return factory(**m.get("kwargs", {}))
    raise ValueError(
        f"checkpoint metadata has no rebuildable serving model "
        f"(metadata[{SERVING_META_KEY!r}] = {m!r}); pass apply_fn "
        "explicitly or save metadata={'serving': {'model': ...}}")


# ---------------------------------------------------------------------------
# graph cache entries (shared with serving/decode.py)
# ---------------------------------------------------------------------------

def launch_counts() -> Dict[str, int]:
    """The kernels' launch counters (``_build.LAUNCHES``) and the
    append+attend routes' (as ``route:<name>``), for a capture's
    before/after."""
    from ..ops import decode_attention as da

    out = dict(_build.LAUNCHES)
    out.update({f"route:{r}": n for r, n in da.ROUTE_LAUNCHES.items()})
    return out


class GraphStep:
    """One entry of an engine's graph cache: ``fn()`` runs the step on
    static buffers (its own, by name, in ``inputs``, and the engine's)
    and returns its output tensors. On the
    card, :func:`capture_step` records it into ``graph`` and keeps the
    captured outputs; ``launches`` holds the kernel launches counted
    while it was captured (a replay launches the same kernels without
    passing through their wrappers, so the counters do not tick) and
    ``replays`` how often it ran since. ``pinned`` holds the pinned host
    buffers its inputs and outputs travel through (``to_device``,
    ``to_host``), which go with it. ``bucket`` labels its build's
    ``record_serving_compile``; ``built`` is set by its first run."""

    __slots__ = ("key", "fn", "inputs", "graph", "outputs", "launches",
                 "replays", "capture_s", "pinned", "bucket", "built")

    def __init__(self, key: Tuple, fn: Callable[[], Tuple],
                 inputs: Optional[Dict[str, torch.Tensor]] = None,
                 bucket: int = 0):
        self.key = key
        self.fn = fn
        self.inputs = dict(inputs or {})
        self.bucket = int(bucket)
        self.built = False
        self.graph = None
        self.outputs: Tuple = ()
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.capture_s = 0.0
        self.pinned: Dict[str, torch.Tensor] = {}

    def free(self) -> None:
        """Drop the graph, its outputs and its pinned host buffers,
        freeing their memory."""
        if self.graph is not None:
            self.graph.reset()
        self.graph, self.outputs = None, ()
        self.pinned.clear()


def capture_step(step: GraphStep, stream, pool=None) -> Tuple:
    """Run ``step.fn`` once uncaptured on the side ``stream``, so the
    kernels' modules are loaded and every one-time query is answered
    before capture, then capture it into a CUDA graph on the same
    stream (PyTorch's default global capture mode: a sync or an
    allocation the capture cannot hold raises). Returns the uncaptured
    run's outputs, the result of this call."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        outputs = step.fn()
    current.wait_stream(stream)
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        step.outputs = step.fn()
    step.capture_s = time.perf_counter() - t0
    after = launch_counts()
    step.launches = {k: after[k] - before.get(k, 0) for k in after
                     if after[k] != before.get(k, 0)}
    step.graph = graph
    return outputs


def run_step(step: GraphStep, stream, pool=None,
             uncaptured: bool = False) -> Tuple:
    """The step's outputs for this call: a replay of its graph on the
    card (captured on first use), ``fn()`` itself on the CPU or when
    ``uncaptured`` (the check that the replay gives the same bits). A
    step's first run records its build (``record_serving_compile``: the
    capture's seconds on the card, 0 on the CPU)."""
    if uncaptured:
        return step.fn()
    if stream is None:
        if not step.built:
            step.built = True
            metrics.record_serving_compile(step.bucket, 0.0)
        return step.fn()
    if step.graph is None:
        outputs = capture_step(step, stream, pool)
        step.built = True
        metrics.record_serving_compile(step.bucket, step.capture_s)
        return outputs
    step.graph.replay()
    step.replays += 1
    return step.outputs


def to_host(tensors: Sequence[torch.Tensor],
            pinned: Dict[str, torch.Tensor]) -> Tuple[np.ndarray, ...]:
    """Copies of ``tensors`` as numpy arrays: on the card through pinned
    buffers (``pinned``, by position and shape) and one wait on the
    stream."""
    if not tensors or tensors[0].device.type == "cpu":
        return tuple(t.numpy().copy() for t in tensors)
    bufs = []
    for i, t in enumerate(tensors):
        key = f"{i}:{tuple(t.shape)}:{t.dtype}"
        buf = pinned.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            pinned[key] = buf
        buf.copy_(t, non_blocking=True)
        bufs.append(buf)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return tuple(b.numpy().copy() for b in bufs)


def to_device(dst: torch.Tensor, src: np.ndarray,
              pinned: Dict[str, torch.Tensor], name: str) -> None:
    """Fill the static buffer ``dst`` from ``src``: on the card through
    a pinned host buffer and a copy on the current stream (the caller
    waits on the stream for its outputs before the buffer is reused)."""
    host = torch.from_numpy(np.ascontiguousarray(src))
    if dst.device.type == "cpu":
        dst.copy_(host)
        return
    buf = pinned.get(name)
    if buf is None or buf.shape != dst.shape or buf.dtype != dst.dtype:
        buf = torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True)
        pinned[name] = buf
    buf.copy_(host)
    dst.copy_(buf, non_blocking=True)


# ---------------------------------------------------------------------------
# the one-shot engine
# ---------------------------------------------------------------------------

#: a request dtype the JAX package (without x64) runs as its 32-bit twin
_CANONICAL = {"float64": "float32", "int64": "int32", "uint64": "uint32",
              "complex128": "complex64"}


class InferenceEngine:
    """Run padded request batches through a CUDA graph per bucket.

    ``apply_fn(params, x)`` is the pure forward pass on tensors of the
    engine's device; ``params`` a name -> tensor mapping (typically
    from ``checkpoint.load_params``), or a single tensor, moved to that
    device. ``feature_shape`` is the declared per-example shape (the
    checkpoint metadata's ``input_shape``): a request that violates it
    is a client error (``ValueError``, an HTTP 400), not a model crash
    that would read as replica death to the dispatch tier. Runs on the
    card unless ``device="cpu"``.

    ``mesh`` (a ``parallel.mesh.Mesh`` over the world, e.g.
    ``hvd.mesh()``) places the parameters by ``sharding_rules`` (default
    ``parallel.sharding.TRANSFORMER_RULES``): this rank's slices in
    ``shards``, the whole leaves in the graphs (module doc).
    """

    #: graphs kept per engine; beyond this the least recently used one
    #: is freed (shape/dtype-diverse traffic must not grow the cache for
    #: the process lifetime)
    MAX_CACHED_EXECUTABLES = 32

    def __init__(
        self,
        apply_fn: Callable,
        params: Any,
        *,
        buckets: Optional[Sequence[int]] = None,
        mesh=None,
        sharding_rules=None,
        default_dtype: str = "float32",
        feature_shape: Optional[Sequence[int]] = None,
        device=None,
    ):
        if sharding_rules is not None and mesh is None:
            raise ValueError("sharding_rules places parameters over a "
                             "mesh; pass mesh= too")
        if serving_knobs().autotune_cache:
            raise NotImplementedError(
                "the autotune warm start (HOROVOD_AUTOTUNE_CACHE) is not "
                "ported yet (ROADMAP queue A entry 12); unset it to serve")
        self.device = resolve_device(device, "InferenceEngine")
        self._apply = apply_fn
        self._buckets = (tuple(sorted(set(int(b) for b in buckets)))
                         if buckets else parse_buckets())
        self._default_dtype = default_dtype
        self._feature_shape = (tuple(int(d) for d in feature_shape)
                               if feature_shape else None)
        if isinstance(params, torch.Tensor):
            params = params.to(self.device)
        elif hasattr(params, "items"):
            params = {str(k): torch.as_tensor(v).to(self.device)
                      for k, v in params.items()}
        #: this rank's slice of each leaf by the rules (None: no mesh)
        self.shards = None
        if mesh is not None:
            self.shards = self._place(params, mesh, sharding_rules)
        self._params = params
        self._cache: "OrderedDict[Tuple, GraphStep]" = OrderedDict()
        # one lock around the cache, execution and capture: a capture
        # must not overlap other work on the card (PyTorch's global
        # capture mode refuses it), so a cold shape waits for the batch
        # in flight and the next batch for the capture
        self._lock = threading.Lock()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        apply_fn: Optional[Callable] = None,
        **kwargs,
    ) -> "InferenceEngine":
        """Restore params from a checkpoint (checkpoint.py) and build
        the engine; ``apply_fn`` defaults to the model named in the
        checkpoint's ``serving`` metadata block."""
        from ..checkpoint import load_params

        params, metadata = load_params(path, device="cpu")
        if apply_fn is None:
            apply_fn = build_apply_fn(metadata)
        meta = metadata.get(SERVING_META_KEY, {})
        kwargs.setdefault("default_dtype", meta.get("dtype", "float32"))
        kwargs.setdefault("feature_shape", meta.get("input_shape"))
        eng = cls(apply_fn, params, **kwargs)
        eng.metadata = metadata
        return eng

    @staticmethod
    def _place(params, mesh, rules):
        """This rank's slice of each leaf of ``params`` by the rules on
        ``mesh`` (a bare tensor is the leaf ``""``)."""
        from ..parallel import sharding as sh

        named = ({"": params} if isinstance(params, torch.Tensor)
                 else dict(params))
        specs = sh.make_param_shardings(named, mesh, rules)
        return {n: sh.local_slice(t, specs[n], mesh).contiguous()
                for n, t in named.items()}

    @property
    def resident_param_bytes(self) -> int:
        """Bytes of the parameters the graphs read on this rank (whole,
        with or without a mesh)."""
        ps = (self._params.values() if hasattr(self._params, "values")
              else [self._params])
        return sum(t.numel() * t.element_size() for t in ps)

    @property
    def shard_param_bytes(self) -> int:
        """Bytes of this rank's slices by the rules: what a JAX device
        holds on the same mesh (the whole without a mesh)."""
        if self.shards is None:
            return self.resident_param_bytes
        return sum(t.numel() * t.element_size()
                   for t in self.shards.values())

    # -- bucket machinery ---------------------------------------------------

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._buckets

    @property
    def cached_executables(self) -> int:
        """Graphs (on the CPU: steps) currently cached — surfaced on
        /healthz so probes can tell a warm replica from one that will
        capture on the next cold shape."""
        return len(self._cache)

    @property
    def pinned_bytes(self) -> int:
        """Bytes of pinned host memory the cached steps hold (their
        input and output buffers; an evicted step's go with it)."""
        return sum(b.numel() * b.element_size()
                   for step in self._cache.values()
                   for b in step.pinned.values())

    def bucket_for(self, n: int) -> int:
        """Smallest bucket covering ``n`` examples (callers split
        batches larger than the top bucket — see __call__)."""
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    @staticmethod
    def _canonical_dtype(dtype) -> str:
        """The dtype a request runs in: a float64 request runs the SAME
        graph as float32 (as it does in the JAX package, whose programs
        are 32-bit), instead of capturing a duplicate."""
        name = str(np.dtype(dtype))
        return _CANONICAL.get(name, name)

    def _executable(self, bucket: int, feature_shape: Tuple[int, ...],
                    dtype: str) -> GraphStep:
        """The cached step of a key (under the lock); a new one is
        captured by its first run."""
        # the feature shape is part of the graph's identity: a (4, 8)
        # graph cannot serve (4, 16) inputs
        key = (bucket, tuple(feature_shape), dtype)
        step = self._cache.get(key)
        if step is not None:
            self._cache.move_to_end(key)
            return step
        x = torch.zeros((bucket,) + tuple(feature_shape),
                        dtype=getattr(torch, dtype), device=self.device)

        def fn():
            with torch.inference_mode():
                return (self._apply(self._params, x),)

        step = GraphStep(key, fn, {"x": x}, bucket=bucket)
        self._cache[key] = step
        while len(self._cache) > self.MAX_CACHED_EXECUTABLES:
            self._cache.popitem(last=False)[1].free()
        return step

    def warmup(self, feature_shape: Sequence[int],
               dtype: Optional[str] = None) -> None:
        """Capture every bucket's graph for one example shape up front,
        so the first real request of each size pays no capture."""
        dtype = self._canonical_dtype(dtype or self._default_dtype)
        for b in self._buckets:
            xb = np.zeros((b,) + tuple(feature_shape), dtype)
            with self._lock:
                self._execute(self._executable(b, xb.shape[1:], dtype), xb)

    # -- execution ----------------------------------------------------------

    def _execute(self, step: GraphStep, xb: np.ndarray) -> np.ndarray:
        """Run ``step`` on the padded batch ``xb`` (under the lock)."""
        to_device(step.inputs["x"], xb, step.pinned, "x")
        return to_host(run_step(step, self._stream), step.pinned)[0]

    def _run(self, bucket: int, xb: np.ndarray) -> np.ndarray:
        with self._lock:
            step = self._executable(bucket, xb.shape[1:], str(xb.dtype))
            faults.inject("serving.replica_exec", bucket=bucket)
            return self._execute(step, xb)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """Predict on ``x`` ([n, ...features]): pad to the covering
        bucket, run its graph, slice the padding back off. Batches above
        the top bucket run as several top-bucket chunks."""
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(f"predict needs [n, ...] input, got {x.shape}")
        if (self._feature_shape is not None
                and tuple(x.shape[1:]) != self._feature_shape):
            raise ValueError(
                f"example shape {tuple(x.shape[1:])} does not match the "
                f"model's declared input_shape {self._feature_shape}")
        n = x.shape[0]
        top = self._buckets[-1]
        if n > top:
            return np.concatenate(
                [self(x[i:i + top]) for i in range(0, n, top)], axis=0)
        bucket = self.bucket_for(n)
        dtype = self._canonical_dtype(x.dtype)
        if str(x.dtype) != dtype:
            x = x.astype(dtype)
        if bucket != n:
            x = np.concatenate(
                [x, np.zeros((bucket - n,) + x.shape[1:], x.dtype)], axis=0)
        y = self._run(bucket, x)[:n]
        metrics.record_serving_batch(bucket, n)
        return y
