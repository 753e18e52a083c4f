"""horovod_tpu_torch: the PyTorch and CUDA port of horovod_tpu.

This package trains and serves GPT-2-class transformer language models,
and trains the ResNet family, Inception V3, VGG-16 and MNIST nets, on
NVIDIA Hopper GPUs:

* **training**, data-parallel in the Horovod style: ``init()`` joins the
  launcher's world over ``torch.distributed`` (NCCL), a
  :func:`DistributedOptimizer` averages gradients in fused buckets
  issued as backward produces them (or combines them by Adasum,
  ``op=Adasum``: ``python -m horovod_tpu_torch.examples.adasum_gpt2``;
  over every rank or a process set, ``add_process_set``),
  ``broadcast_parameters`` starts
  every rank from rank 0's weights, and the model runs flash attention
  (:func:`make_flash_attention_fn`) and fused LayerNorm
  (``fused_norm=True``) forward and backward
  (``python -m horovod_tpu_torch.examples.gpt2_pretraining``), with the
  LM head and its cross-entropy fused over vocab blocks (``--fused-ce``,
  ``ops.fused_linear_cross_entropy``), over the
  float32 wire or the int8 wire with error feedback
  (``HOROVOD_COMPRESSION=int8``, ``Compression.int8``); BERT-Large
  masked-LM pretraining with Adam's state sharded over the ranks by
  the ZeRO-1 :func:`ShardedOptimizer`
  (``python -m horovod_tpu_torch.examples.bert_pretraining --zero``);
  the parameters too by the ZeRO-3 :func:`FullyShardedOptimizer`
  (``make_lm_train_step``'s FSDP step); each bucket's exchange issued
  inside the backward (``HOROVOD_OVERLAP_SCHEDULE``, ``ops/overlap.py``);
  and ResNet-50/101/152 with the fused BatchNorm kernels (``fused_bn=True``)
  and per-rank BatchNorm statistics, or :class:`SyncBatchNorm`'s
  world-wide ones, and Inception V3 and VGG-16
  (``python -m horovod_tpu_torch.examples.resnet50_synthetic --model``),
  and MNIST (``python -m horovod_tpu_torch.examples.mnist``);
* **tensor and sequence parallelism** on a device mesh
  (``hvd.mesh()``, ``HOROVOD_MESH="dp=2,tp=2"``, ``parallel/``):
  ``make_lm_train_step(mesh=..., sequence_parallel="ring"|"ulysses")``
  keeps this rank's slices of the weights by the JAX package's sharding
  rules and issues the Megatron exchanges, ring attention or Ulysses
  over the sp axis;
* **elastic training** (``hvd.elastic``): ``TorchState`` commits a
  model, optimizer and plain values to host memory, ``@hvd.elastic.run``
  restores and re-joins the world when a collective fails, a SIGTERM
  writes the last commit as an emergency snapshot and exits 83, commits
  can be replicated to ring partners, and a restarted worker recovers
  from the freshest verified source; the launcher's
  ``--host-discovery-script`` runs rounds under the ``ElasticDriver``,
  blacklisting failed hosts (``python -m
  horovod_tpu_torch.examples.gpt2_elastic``); ``hvd.data``'s
  ``ElasticSampler`` and loaders and ``hvd.callbacks`` go with it;
* **autotuning** (``hvd.autotune``): :class:`OnlineTuner` and
  :class:`SPMDStepTuner` build and time a step per candidate knob
  setting (``parallel.tune_lm_train_step`` for the causal-LM step),
  agree the winners over the ranks, pin them into the knobs and keep
  them in a warm-start cache (``HOROVOD_AUTOTUNE_CACHE``) that later
  runs and serving replicas read; ``HOROVOD_AUTOTUNE`` runs the
  in-step ``ParameterManager``, or the eager runtime's controller
  tuner;
* **observability**: ``hvd.metrics`` (counters, gauges, histograms,
  the per-step JSONL of ``with hvd.metrics.step():``, the Prometheus
  exposition and its push to the launcher's ``/metrics``), the host
  timeline (``HOROVOD_TIMELINE``, :func:`start_timeline`), the flight
  recorder (``utils/flight.py``), the sampled step profiler
  (``hvd.prof``, ``HOROVOD_PROF_EVERY``: a ``torch.profiler`` window
  every N steps, its attribution and ``hvd_mfu``) and the fleet-health
  monitor (``hvd.health``, ``HOROVOD_HEALTH``: detectors, SLO rules,
  ``GET /health``), read offline by ``python -m
  horovod_tpu_torch.tools.metrics_summary``, ``flight_analyze``,
  ``trace_merge`` and ``device_summary``;
* **serving**: continuous-batching decode
  (:class:`~horovod_tpu_torch.serving.scheduler.DecodeScheduler`) over a
  slotted KV cache
  (:class:`~horovod_tpu_torch.serving.decode.GenerationEngine`).

The JAX package's Pallas kernels on those paths are rewritten by hand in
CUDA C++ for ``sm_90a`` (``csrc/``, built on first use by
``ops/_build.py``): the LayerNorm/RMSNorm forward and backward, the
flash-attention forward, dQ and dK/dV, the decode KV append +
attention over a float or int8 cache, the BatchNorm statistics,
apply, backward reduction and backward dx, and the int8 wire's
quantize, quantize + error feedback, dequantize-accumulate and
dequantize, and the reduce-scatter's producer epilogues: the bucket
pack and the matmul that writes its product into the ring rows.

Worlds start from the launcher, ``python -m
horovod_tpu_torch.runner.launch -np N -H host:n,... <command>`` (the JAX
package's ``hvdrun``, one process per card; ``runner.run(fn, np=N)``
from Python), whose slot environment ``init()`` reads.

Everything runs on the card unless the caller passes ``device="cpu"``,
which runs each kernel's plain PyTorch version instead. The package
imports neither JAX nor ``horovod_tpu``; the JAX package is the
reference its tests compare against.
"""

__version__ = "0.1.0"

from . import callbacks, checkpoint, data, elastic
from .checkpoint import LoadedModel, load_model, save_model
from .core.basics import (ccl_built, cross_rank, cross_size, cuda_built,
                          cuda_enabled, ddl_built, device, dp_axis_names,
                          gloo_built, gloo_enabled, init, is_homogeneous,
                          is_initialized, local_rank, local_rank_op,
                          local_size, local_size_op, mesh, mpi_built,
                          mpi_enabled, mpi_threads_supported, nccl_built,
                          nccl_enabled, process_set_included_op, rank,
                          rank_op, rocm_built, shutdown, size, size_op,
                          xla_built, xla_enabled)
from .core.exceptions import (HorovodInternalError, HorovodTpuError,
                              HostsUpdatedInterrupt, NotInitializedError,
                              ProcessSetError)
from .core.knobs import Knobs
from .core.process_sets import (ProcessSet, add_or_get_process_set,
                                 add_process_set, get_process_set_by_id,
                                 global_process_set, remove_process_set)
from .models.convert import (params_from_flax, params_to_flax,
                             resnet_from_flax, resnet_to_flax)
from .models.resnet import ResNet, ResNet50, ResNet101, ResNet152
from .models.transformer import (BERT_LARGE, GPT2_MEDIUM, GPT2_SMALL, Bert,
                                 Transformer, TransformerConfig,
                                 causal_lm_loss, mlm_loss)
from .ops._build import LAUNCHES, reset_launches
from .ops.adasum import adasum_allreduce, hierarchical_adasum
from .ops.autotune import OnlineTuner, SPMDStepTuner
from .ops.collectives import (Adasum, Average, Max, Min, Product, ReduceOp,
                              Sum, allgather, allgather_async, allreduce,
                              allreduce_, allreduce_async, allreduce_async_,
                              alltoall, alltoall_async, barrier, broadcast,
                              broadcast_, broadcast_async, broadcast_async_,
                              grouped_allgather, grouped_allgather_async,
                              grouped_allreduce, grouped_allreduce_async,
                              grouped_reducescatter,
                              grouped_reducescatter_async, join,
                              masked_allreduce, poll, reducescatter,
                              reducescatter_async, synchronize)
from .ops.batchnorm import FusedBatchNorm, fused_batch_norm
from .ops.decode_attention import decode_append_attend
from .ops.hierarchical import hierarchical_allgather, hierarchical_psum
from .ops.flash_attention import (flash_attention, flash_attention_bhtd,
                                  make_flash_attention_fn)
from .ops.fusion import model_fingerprint
from .ops.layernorm import FusedLayerNorm, fused_layer_norm
from .ops.ring_pack import (matmul_reduce_scatter, maybe_pack_rows,
                            pack_rows_fused)
from .ops.sparse import (IndexedSlices, dense_to_sparse, sparse_allreduce,
                         sparse_to_dense)
from .optim.compression import Compression, Int8BlockCompressor, WireSpec
from .optim.distributed import (DistributedGradientTape,
                                DistributedOptimizer,
                                distributed_value_and_grad)
from .optim.functions import (allgather_object, broadcast_object,
                              broadcast_optimizer_state,
                              broadcast_parameters)
from .optim.fsdp import FullyShardedOptimizer, fsdp_layout
from .optim.zero import ShardedOptimizer, reshard_state
from .parallel.train import make_lm_train_step
from .serving.decode import GenerationEngine, KVCacheSpec, SlottedKVCache
from .serving.scheduler import DecodeScheduler, GenRequest
from .sync_batch_norm import SyncBatchNorm
from . import health  # hvd.health.verdict(), summary(), ...
from .ops import autotune  # hvd.autotune.OnlineTuner, warm_start, ...
from .ops import overlap  # hvd.overlap.fsdp_staged_value_and_grad, ...
from .optim import fsdp  # hvd.fsdp.shard_params, fsdp_layout, ...
from .utils import faults  # hvd.faults.inject, ...
from .utils import metrics  # hvd.metrics.step(), scrape(), ...
from .utils import prof  # hvd.prof.set_step_flops(), summary(), ...


def start_timeline(filename: str, mark_cycles: bool = False) -> None:
    """Start writing the host timeline to ``filename`` at run time
    (reference operations.cc:1048, the JAX package's
    ``hvd.start_timeline``)."""
    from .core.state import global_state
    from .utils.timeline import Timeline

    st = global_state()
    if st.timeline is None:
        st.timeline = Timeline(None)
    st.timeline.start(filename, mark_cycles=mark_cycles)


def stop_timeline() -> None:
    """Stop the host timeline; its file closes as a JSON array."""
    from .core.state import global_state

    st = global_state()
    if st.timeline is not None:
        st.timeline.stop()


__all__ = [
    # basics
    "init", "shutdown", "is_initialized", "size", "rank", "local_size",
    "local_rank", "cross_size", "cross_rank", "device", "mesh",
    "mpi_built", "mpi_enabled", "mpi_threads_supported", "gloo_built",
    "gloo_enabled", "nccl_built", "nccl_enabled", "cuda_built",
    "cuda_enabled", "rocm_built", "ddl_built", "ccl_built", "xla_built",
    "xla_enabled", "is_homogeneous", "dp_axis_names", "rank_op",
    "size_op", "local_rank_op", "local_size_op", "process_set_included_op",
    "HorovodTpuError", "HorovodInternalError", "HostsUpdatedInterrupt",
    "NotInitializedError",
    "ProcessSetError", "Knobs", "ProcessSet", "global_process_set",
    "add_process_set", "add_or_get_process_set", "remove_process_set",
    "get_process_set_by_id",
    # collectives
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max", "Product",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_async", "allgather",
    "allgather_async", "broadcast", "broadcast_", "broadcast_async",
    "broadcast_async_", "barrier", "poll", "synchronize", "reducescatter",
    "reducescatter_async", "grouped_reducescatter",
    "grouped_reducescatter_async", "alltoall", "alltoall_async",
    "grouped_allgather", "grouped_allgather_async", "join",
    "masked_allreduce", "sparse_allreduce", "IndexedSlices",
    "dense_to_sparse", "sparse_to_dense",
    "adasum_allreduce", "hierarchical_adasum", "hierarchical_psum",
    "hierarchical_allgather", "maybe_pack_rows",
    "pack_rows_fused", "matmul_reduce_scatter",
    # training
    "DistributedOptimizer", "ShardedOptimizer", "FullyShardedOptimizer",
    "reshard_state", "fsdp_layout", "fsdp", "overlap", "faults",
    "DistributedGradientTape", "distributed_value_and_grad",
    "model_fingerprint", "autotune", "OnlineTuner", "SPMDStepTuner",
    "Compression", "Int8BlockCompressor", "WireSpec", "broadcast_parameters",
    "broadcast_optimizer_state", "broadcast_object", "allgather_object",
    "make_lm_train_step", "checkpoint", "save_model", "load_model",
    "LoadedModel", "elastic", "data", "callbacks",
    "flash_attention", "flash_attention_bhtd", "make_flash_attention_fn",
    "SyncBatchNorm",
    # observability
    "metrics", "prof", "health", "start_timeline", "stop_timeline",
    # models
    "params_from_flax", "params_to_flax", "resnet_from_flax",
    "resnet_to_flax", "GPT2_SMALL", "GPT2_MEDIUM", "Transformer",
    "TransformerConfig", "causal_lm_loss", "BERT_LARGE", "Bert",
    "mlm_loss", "ResNet", "ResNet50",
    "ResNet101", "ResNet152",
    # kernels and serving
    "LAUNCHES", "reset_launches", "decode_append_attend", "FusedLayerNorm",
    "fused_layer_norm", "FusedBatchNorm", "fused_batch_norm",
    "GenerationEngine", "KVCacheSpec", "SlottedKVCache",
    "DecodeScheduler", "GenRequest",
]
