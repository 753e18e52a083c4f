"""horovod_tpu_torch: the PyTorch and CUDA port of horovod_tpu.

This package trains and serves GPT-2-class transformer language models,
and trains the ResNet family, on NVIDIA Hopper GPUs:

* **training**, data-parallel in the Horovod style: ``init()`` joins the
  launcher's world over ``torch.distributed`` (NCCL), a
  :func:`DistributedOptimizer` averages gradients in fused buckets
  issued as backward produces them, ``broadcast_parameters`` starts
  every rank from rank 0's weights, and the model runs flash attention
  (:func:`make_flash_attention_fn`) and fused LayerNorm
  (``fused_norm=True``) forward and backward
  (``python -m horovod_tpu_torch.examples.gpt2_pretraining``), over the
  float32 wire or the int8 wire with error feedback
  (``HOROVOD_COMPRESSION=int8``, ``Compression.int8``); BERT-Large
  masked-LM pretraining with Adam's state sharded over the ranks by
  the ZeRO-1 :func:`ShardedOptimizer`
  (``python -m horovod_tpu_torch.examples.bert_pretraining --zero``);
  and ResNet-50/101/152 with the fused BatchNorm kernels (``fused_bn=True``)
  and per-rank BatchNorm statistics, or :class:`SyncBatchNorm`'s
  world-wide ones
  (``python -m horovod_tpu_torch.examples.resnet50_synthetic``);
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

Everything runs on the card unless the caller passes ``device="cpu"``,
which runs each kernel's plain PyTorch version instead. The package
imports neither JAX nor ``horovod_tpu``; the JAX package is the
reference its tests compare against.
"""

from .core.basics import (ccl_built, cross_rank, cross_size, cuda_built,
                          cuda_enabled, ddl_built, device, gloo_built,
                          gloo_enabled, init, is_initialized, local_rank,
                          local_size, mpi_built, mpi_enabled,
                          mpi_threads_supported, nccl_built, nccl_enabled,
                          rank, rocm_built, shutdown, size, xla_built,
                          xla_enabled)
from .core.exceptions import (HorovodInternalError, NotInitializedError,
                              ProcessSetError)
from .core.knobs import Knobs
from .core.process_sets import ProcessSet, global_process_set
from .models.convert import (params_from_flax, params_to_flax,
                             resnet_from_flax, resnet_to_flax)
from .models.resnet import ResNet, ResNet50, ResNet101, ResNet152
from .models.transformer import (BERT_LARGE, GPT2_MEDIUM, GPT2_SMALL, Bert,
                                 Transformer, TransformerConfig,
                                 causal_lm_loss, mlm_loss)
from .ops._build import LAUNCHES, reset_launches
from .ops.collectives import (Adasum, Average, Max, Min, Product, ReduceOp,
                              Sum, allgather, allgather_async, allreduce,
                              allreduce_, allreduce_async, allreduce_async_,
                              barrier, broadcast, broadcast_,
                              broadcast_async, broadcast_async_,
                              grouped_allreduce, grouped_allreduce_async,
                              grouped_reducescatter,
                              grouped_reducescatter_async, poll,
                              reducescatter, reducescatter_async,
                              synchronize)
from .ops.batchnorm import FusedBatchNorm, fused_batch_norm
from .ops.decode_attention import decode_append_attend
from .ops.flash_attention import (flash_attention, flash_attention_bhtd,
                                  make_flash_attention_fn)
from .ops.layernorm import FusedLayerNorm, fused_layer_norm
from .ops.ring_pack import (matmul_reduce_scatter, maybe_pack_rows,
                            pack_rows_fused)
from .optim.compression import Compression
from .optim.distributed import DistributedOptimizer
from .optim.functions import (broadcast_object, broadcast_optimizer_state,
                              broadcast_parameters)
from .optim.zero import ShardedOptimizer, reshard_state
from .parallel.train import make_lm_train_step
from .serving.decode import GenerationEngine, KVCacheSpec, SlottedKVCache
from .serving.scheduler import DecodeScheduler, GenRequest
from .sync_batch_norm import SyncBatchNorm

__all__ = [
    # basics
    "init", "shutdown", "is_initialized", "size", "rank", "local_size",
    "local_rank", "cross_size", "cross_rank", "device",
    "mpi_built", "mpi_enabled", "mpi_threads_supported", "gloo_built",
    "gloo_enabled", "nccl_built", "nccl_enabled", "cuda_built",
    "cuda_enabled", "rocm_built", "ddl_built", "ccl_built", "xla_built",
    "xla_enabled", "HorovodInternalError", "NotInitializedError",
    "ProcessSetError", "Knobs", "ProcessSet", "global_process_set",
    # collectives
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max", "Product",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_async", "allgather",
    "allgather_async", "broadcast", "broadcast_", "broadcast_async",
    "broadcast_async_", "barrier", "poll", "synchronize", "reducescatter",
    "reducescatter_async", "grouped_reducescatter",
    "grouped_reducescatter_async", "maybe_pack_rows", "pack_rows_fused",
    "matmul_reduce_scatter",
    # training
    "DistributedOptimizer", "ShardedOptimizer", "reshard_state",
    "Compression", "broadcast_parameters",
    "broadcast_optimizer_state", "broadcast_object", "make_lm_train_step",
    "flash_attention", "flash_attention_bhtd", "make_flash_attention_fn",
    "SyncBatchNorm",
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
