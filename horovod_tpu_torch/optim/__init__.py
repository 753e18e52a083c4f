"""Optimizers and their wire: the data-parallel ``DistributedOptimizer``
and its gradient tape, ZeRO-1 ``ShardedOptimizer``, ZeRO-3
``FullyShardedOptimizer``, the compressors and the broadcast helpers.

The JAX package's ``error_feedback_specs`` and ``sharded_state_specs``
give ``shard_map`` the partition specs of a state that one program
holds for every rank; here each rank's process holds only its own
state, so there are no specs to give."""

from .compression import (  # noqa: F401
    Compression,
    Int8BlockCompressor,
    WireSpec,
)
from .distributed import (  # noqa: F401
    DistributedGradientTape,
    DistributedOptimizer,
    distributed_value_and_grad,
)
from .functions import (  # noqa: F401
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .fsdp import FullyShardedOptimizer, fsdp_layout  # noqa: F401
from .zero import ShardedOptimizer, reshard_state  # noqa: F401
