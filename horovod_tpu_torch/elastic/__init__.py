"""Elastic fault-tolerant training (``hvd.elastic``).

The port of the JAX package's ``horovod_tpu/elastic/`` (reference
horovod/common/elastic.py, torch/elastic/state.py): the elastic
``State`` family and the ``run`` wrapper (state.py), the SIGTERM
preemption handler and the emergency snapshot (preemption.py), and the
peer replication of commits with the recovery ladder (replication.py).
The launcher side is ``horovod_tpu_torch/runner/elastic/``.
"""

from . import preemption  # noqa: F401
from . import replication  # noqa: F401
from .preemption import PREEMPTED_EXIT_CODE  # noqa: F401
from .state import (  # noqa: F401
    HostTensor,
    ObjectState,
    State,
    TorchState,
    TpuState,
    run,
)
