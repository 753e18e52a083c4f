"""Serving on the card: the one-shot predict tier and generation.

The PyTorch counterpart of the JAX package's ``serving/``:

* :class:`~horovod_tpu_torch.serving.engine.InferenceEngine` —
  checkpoint restore + a CUDA graph per padded batch-size bucket
  (``HOROVOD_SERVING_BUCKETS``), cached by (bucket, shape, dtype);
* :class:`~horovod_tpu_torch.serving.batcher.DynamicBatcher` — bounded
  admission, deadline-aware coalescing into the smallest covering
  bucket;
* :class:`~horovod_tpu_torch.serving.server.ServingServer` — POST
  /v1/predict and /v1/generate + /healthz over the per-job shared
  secret;
* :class:`~horovod_tpu_torch.serving.replica_set.ReplicaSet` —
  least-loaded multi-replica dispatch with transparent failover and
  SIGTERM drain-then-exit (exit code 83);
* :class:`~horovod_tpu_torch.serving.decode.GenerationEngine` +
  :class:`~horovod_tpu_torch.serving.scheduler.DecodeScheduler` —
  the autoregressive workload: a CUDA graph per decode and prefill
  bucket over a slotted (optionally int8 block-quantized) KV cache,
  continuously batched at iteration granularity with SLO-class
  admission and token streaming;
* :class:`~horovod_tpu_torch.serving.replica_set.ReplicaSupervisor` —
  spawn and drain replicas over the preemption (exit 83) contract;
* :class:`~horovod_tpu_torch.serving.replica_set.ReplicaAutoscaler` —
  grow and shrink the fleet off the replicas' slot occupancy
  (``/healthz``) and queue wait (``/metrics``).
"""

from .batcher import (  # noqa: F401
    Draining,
    DynamicBatcher,
    QueueFull,
    RequestTimeout,
)
from .decode import (  # noqa: F401
    GenerationEngine,
    KVCacheSpec,
    SlottedKVCache,
    TRANSFORMER_LM,
    config_from_meta,
    config_to_meta,
    parse_decode_buckets,
    parse_kv_dtype,
)
from .engine import (  # noqa: F401
    InferenceEngine,
    SERVING_META_KEY,
    build_apply_fn,
    parse_buckets,
)
from .replica_set import (  # noqa: F401
    SERVING_DECODE_KIND,
    SERVING_KIND,
    ReplicaAutoscaler,
    ReplicaSet,
    ReplicaSupervisor,
    generate_remote,
    generate_stream_remote,
    predict_remote,
    serve_replica,
)
from .scheduler import (  # noqa: F401
    DecodeScheduler,
    GenRequest,
    SLO_CLASSES,
)
from .server import AUTH_HEADER, ServingServer, sign_body  # noqa: F401
