"""Launcher layer: the ``hvdrun`` CLI and the in-process ``run()`` API.

Reference horovod/runner/ — ``horovodrun`` (launch.py:286,583),
``horovod.run()`` (runner/__init__.py:94), gloo_run slot spawning
(gloo_run.py:242), the HTTP rendezvous store (http/http_server.py:192;
ported, started by no launch until elastic training). The JAX
package's ``horovod_tpu/runner`` is the same launcher; this one starts
one worker process per card, which ``core/basics.init()`` joins into a
``torch.distributed`` world:

    python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \\
        python -m horovod_tpu_torch.examples.gpt2_pretraining --flash

Elastic launches (``--min-np``/``--max-np``/``--host-discovery-script``)
and the launcher-supervised control plane come with ROADMAP queue A
entries 8 and 14; ``runner/launch.py`` refuses their flags.
"""

from .launch import parse_args, run_commandline  # noqa: F401
from .api import run  # noqa: F401
from .util.hosts import (  # noqa: F401
    HostInfo,
    SlotInfo,
    get_host_assignments,
    parse_hosts,
)
