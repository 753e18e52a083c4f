"""horovod_tpu_torch: the PyTorch and CUDA port of horovod_tpu.

This package serves GPT-2-class transformer language models on an
NVIDIA Hopper GPU: continuous-batching decode
(:class:`~horovod_tpu_torch.serving.scheduler.DecodeScheduler`) over a
slotted KV cache (:class:`~horovod_tpu_torch.serving.decode.GenerationEngine`),
with the JAX package's Pallas kernels on that path rewritten by hand in
CUDA C++ for ``sm_90a`` (``csrc/``, built on first use by
``ops/_build.py``): the fused LayerNorm/RMSNorm forward and the decode
KV append + attention over a float or int8 cache.

Everything runs on the card unless the caller passes ``device="cpu"``,
which runs each kernel's plain PyTorch version instead. The package
imports neither JAX nor ``horovod_tpu``; the JAX package is the
reference its tests compare against.
"""

from .core.knobs import Knobs
from .models.convert import params_from_flax
from .models.transformer import (GPT2_SMALL, Transformer, TransformerConfig,
                                 causal_lm_loss)
from .ops._build import LAUNCHES, reset_launches
from .ops.decode_attention import decode_append_attend
from .ops.layernorm import FusedLayerNorm, fused_layer_norm
from .serving.decode import GenerationEngine, KVCacheSpec, SlottedKVCache
from .serving.scheduler import DecodeScheduler, GenRequest

__all__ = [
    "Knobs", "params_from_flax", "GPT2_SMALL", "Transformer",
    "TransformerConfig", "causal_lm_loss", "LAUNCHES", "reset_launches",
    "decode_append_attend", "FusedLayerNorm", "fused_layer_norm",
    "GenerationEngine", "KVCacheSpec", "SlottedKVCache", "DecodeScheduler",
    "GenRequest",
]
