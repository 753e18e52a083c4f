"""Example training programs of horovod_tpu_torch
(``python -m horovod_tpu_torch.examples.<name>``)."""
