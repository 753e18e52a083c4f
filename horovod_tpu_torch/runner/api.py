"""In-process ``horovod_tpu_torch.runner.run()`` API.

Reference horovod/runner/__init__.py:94 (``horovod.run``), as the JAX
package's ``runner/api.py`` carries it: run a python function on every
slot and collect return values. Each slot executes ``func`` in a
spawned interpreter (``python -c``); the function travels pickled
through a launcher-local temporary directory and the results come back
the same way.

Without ``cloudpickle`` (or with ``use_cloudpickle=False``) the function
pickles by reference: its module must be importable in the worker, so
a function defined in a ``__main__`` script does not unpickle there —
pass one from an importable module (and its directory on
``PYTHONPATH`` through ``env``).
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
from typing import Any, Callable, List, Optional

from .exec_run import run_static
from .util.hosts import HostInfo, parse_hosts

_WORKER_SNIPPET = r"""
import base64, os, pickle, sys
with open(os.environ["HVD_TPU_FUNC_FILE"], "rb") as f:
    func, args, kwargs = pickle.loads(f.read())
result = func(*args, **kwargs)
out = os.environ["HVD_TPU_RESULT_DIR"]
rank = os.environ["HVD_TPU_RANK"]
with open(os.path.join(out, f"result_{rank}.pkl"), "wb") as f:
    f.write(pickle.dumps(result))
"""


def run(
    func: Callable,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    np: int = 1,
    hosts: Optional[str] = None,
    env: Optional[dict] = None,
    use_cloudpickle: bool = True,
) -> List[Any]:
    """Run `func(*args, **kwargs)` on np slots; return per-rank results."""
    try:
        import cloudpickle  # type: ignore

        dumps = cloudpickle.dumps if use_cloudpickle else pickle.dumps
    except ImportError:
        dumps = pickle.dumps

    host_list = (
        parse_hosts(hosts) if hosts else [HostInfo("localhost", np)]
    )
    from .util.network import get_local_host_addresses

    local = set(get_local_host_addresses()) | {"localhost"}
    remote = [h.hostname for h in host_list if h.hostname not in local]
    if remote:
        # function + results travel through a launcher-local tempdir; a
        # shared-filesystem multi-host variant would need a remote channel
        raise ValueError(
            f"runner.run() executes slots on this machine only; remote "
            f"hosts {remote} are not supported — use hvdrun with a script"
        )
    with tempfile.TemporaryDirectory(prefix="hvd_torch_run_") as tmp:
        func_file = os.path.join(tmp, "func.pkl")
        with open(func_file, "wb") as f:
            f.write(dumps((func, args, kwargs or {})))
        run_env = dict(env or os.environ)
        run_env["HVD_TPU_FUNC_FILE"] = func_file
        run_env["HVD_TPU_RESULT_DIR"] = tmp
        command = [sys.executable, "-c", _WORKER_SNIPPET]
        codes = run_static(command, host_list, np, env=run_env)
        if any(codes):
            raise RuntimeError(f"worker failure, exit codes {codes}")
        results = []
        for rank in range(np):
            with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as f:
                results.append(pickle.loads(f.read()))
        return results
