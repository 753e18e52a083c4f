"""Transformer and ResNet models and flax parameter conversion."""

from .resnet import ResNet, ResNet50, ResNet101, ResNet152  # noqa: F401
from .transformer import (  # noqa: F401
    GPT2_MEDIUM,
    GPT2_SMALL,
    Transformer,
    TransformerConfig,
    causal_lm_loss,
)
