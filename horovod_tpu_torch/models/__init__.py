"""Transformer, Mixture-of-Experts, ResNet, Inception V3, VGG-16 and
MNIST models and flax parameter conversion."""

from .inception import InceptionV3  # noqa: F401
from .mlp import MLP, MnistNet  # noqa: F401
from .moe import MoeMlp  # noqa: F401
from .resnet import ResNet, ResNet50, ResNet101, ResNet152  # noqa: F401
from .transformer import (  # noqa: F401
    BERT_BASE,
    BERT_LARGE,
    GPT2,
    GPT2_LARGE,
    GPT2_MEDIUM,
    GPT2_SMALL,
    LLAMA2_7B,
    LLAMA3_8B,
    Bert,
    Llama,
    Transformer,
    TransformerConfig,
    causal_lm_loss,
    mlm_loss,
)
from .vgg import VGG16  # noqa: F401
