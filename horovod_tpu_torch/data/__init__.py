"""Data loading utilities (``hvd.data``).

The port of ``horovod_tpu/data/`` (reference horovod/data/
data_loader_base.py ``BaseDataLoader``/``AsyncDataLoaderMixin`` and
torch/elastic/sampler.py ``ElasticSampler``): ``ShardedDataLoader``
places each of this rank's batches on its device, ``device_prefetch``
keeps batches in flight to the card ahead of the step.
"""

from .data_loader_base import (  # noqa: F401
    AsyncDataLoaderMixin,
    BaseDataLoader,
    ShardedDataLoader,
    device_prefetch,
)
from .sampler import ElasticSampler  # noqa: F401
