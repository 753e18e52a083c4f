"""Assembled training steps of horovod_tpu_torch."""
