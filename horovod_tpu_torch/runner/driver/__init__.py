"""Driver-side services: task-to-task NIC routability probing.

Reference horovod/runner/driver/driver_service.py: the launcher starts a
task server on every host, tasks ring-probe each other's advertised
interface addresses, and the driver intersects the routable sets into
the common NICs the job binds.
"""

from .probe import (  # noqa: F401
    DriverProbeService,
    TaskProbeService,
    find_common_nics,
    get_common_interfaces,
    interface_addresses,
)
