"""Elastic launcher: dynamic world size with fault tolerance.

The port of the JAX package's ``runner/elastic/`` (reference
horovod/runner/elastic/): ``ElasticDriver`` (driver.py), host discovery
and the blacklist (discovery.py), the per-round worker state registry
(registration.py) and the host-update notification protocol
(worker.py). The worker side's commit/restore/sync lives in
``horovod_tpu_torch/elastic/``.
"""

from .discovery import (  # noqa: F401
    FixedHosts,
    HostDiscovery,
    HostDiscoveryScript,
    HostManager,
)
from .driver import ElasticDriver  # noqa: F401
from .settings import ElasticSettings  # noqa: F401
