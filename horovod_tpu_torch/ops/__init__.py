"""Hand-written CUDA kernels, their plain PyTorch versions and the
build that compiles them; the vocab-blocked fused LM-head
cross-entropy, which needs no kernel of its own; and the autotuner."""

from .autotune import (  # noqa: F401
    OnlineTuner,
    ParameterManager,
    SPMDStepTuner,
)
from .fused_cross_entropy import (  # noqa: F401
    fused_causal_lm_loss,
    fused_linear_cross_entropy,
)
