"""Knobs read from the environment."""
