"""Transformer models and flax parameter conversion."""
