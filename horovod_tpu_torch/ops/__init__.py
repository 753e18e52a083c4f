"""Hand-written CUDA kernels, their plain PyTorch versions and the
build that compiles them; and the vocab-blocked fused LM-head
cross-entropy, which needs no kernel of its own."""

from .fused_cross_entropy import (  # noqa: F401
    fused_causal_lm_loss,
    fused_linear_cross_entropy,
)
