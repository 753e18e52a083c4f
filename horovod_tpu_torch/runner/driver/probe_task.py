"""Probe-task entry point, launched once per host by the driver
(reference horovod/runner/task_fn.py): starts a TaskProbeService,
registers with the driver, serves probes until told to shut down."""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys

from ..util.network import BasicClient
from ..util.secret import ENV_SECRET
from .probe import RegisterTaskRequest, TaskProbeService


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("index", type=int)
    p.add_argument("driver_addresses",
                   help="base64 JSON list of (ip, port) pairs")
    p.add_argument("--linger-s", type=float, default=300.0)
    args = p.parse_args(argv)

    key = os.environ[ENV_SECRET].encode()
    addrs = [
        (str(a), int(p_))
        for a, p_ in json.loads(base64.b64decode(args.driver_addresses))
    ]
    svc = TaskProbeService(args.index, key)
    try:
        client = BasicClient("driver-probe", addrs, key)
        client.request(
            RegisterTaskRequest(args.index, svc.addresses())
        )
        # serve probes until the driver's shutdown request (or linger cap
        # so an orphaned task never outlives a dead driver for long)
        svc.stop_event.wait(timeout=args.linger_s)
        return 0
    finally:
        svc.shutdown()


if __name__ == "__main__":
    sys.exit(main())
