"""Helpers of horovod_tpu_torch."""
