"""Assembled training steps of horovod_tpu_torch, and the device mesh,
sharding rules, tensor parallelism, sequence parallelism (ring and
Ulysses) and pipeline parallelism (GPipe and 1F1B) they run on."""

from .comm import GroupComm, SelfComm, ThreadComm, ThreadWorld, run_ranks  # noqa: F401
from .mesh import (AXIS_ORDER, Mesh, data_axes, make_mesh,  # noqa: F401
                   mesh_from_spec, parse_mesh_spec)
from .pipeline import (  # noqa: F401
    build_stage,
    gpipe,
    one_f_one_b,
    pipeline_lm_apply,
    pipeline_lm_train_step_1f1b,
    pipeline_lm_train_step_gpipe,
    stack_block_params,
    stage_layers,
    unstack_block_params,
)
from .ring_attention import make_ring_attention_fn, ring_attention  # noqa: F401
from .sharding import (  # noqa: F401
    RESNET_RULES,
    TRANSFORMER_RULES,
    batch_sharding,
    make_param_shardings,
    shard_params,
    spec_for_path,
    unshard_params,
)
from .tensor_parallel import TensorParallel, parallelize  # noqa: F401
from .train import (make_lm_train_step, sp_attention_fn,  # noqa: F401
                    tune_lm_train_step)
from .ulysses import (  # noqa: F401
    make_ulysses_attention_fn,
    padded_alltoall,
    ulysses_attention,
)
