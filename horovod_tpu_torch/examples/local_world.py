"""Run a command as N ranks of this host.

The port's launcher, ``python -m horovod_tpu_torch.runner.launch -np N
-H localhost:N <command>``, does this and more (hostfiles, ssh, the
rendezvous KV, NIC probing, config files, ``runner.run(fn)``); this
script stays as the minimal form, and its worlds train bitwise like
the launcher's (``tests/test_torch_launch_world.py``).

Each rank gets the slot environment the launcher
exports (``HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE/CROSS_RANK/
CROSS_SIZE`` and ``HVD_TPU_COORDINATOR_ADDRESS`` on a free local port),
so ``horovod_tpu_torch.init()`` joins them into one world: rank r on
card r, or on the CPU when the command passes ``--device cpu``. Output
lines are prefixed with ``[rank]``. If a rank fails, the others are
stopped; the exit code is the first failing rank's (0 when all pass).

    python -m horovod_tpu_torch.examples.local_world -np 4 -- \\
        python -m horovod_tpu_torch.examples.gpt2_pretraining --flash
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pump(rank: int, stream) -> None:
    for line in stream:
        sys.stdout.write(f"[{rank}]{line}")
        sys.stdout.flush()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-np", "--num-proc", type=int, required=True)
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        p.error("no command given")
    n = args.num_proc
    addr = f"127.0.0.1:{_free_port()}"
    procs, pumps = [], []
    for r in range(n):
        env = dict(os.environ)
        for name, v in (("RANK", r), ("SIZE", n), ("LOCAL_RANK", r),
                        ("LOCAL_SIZE", n), ("CROSS_RANK", 0),
                        ("CROSS_SIZE", 1)):
            env[f"HOROVOD_{name}"] = env[f"HVD_TPU_{name}"] = str(v)
        env["HVD_TPU_COORDINATOR_ADDRESS"] = addr
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append(proc)
        pumps.append(threading.Thread(target=_pump, args=(r, proc.stdout),
                                      daemon=True))
        pumps[-1].start()
    failed = 0
    try:
        while any(pr.poll() is None for pr in procs):
            bad = [pr.returncode for pr in procs
                   if pr.returncode not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            time.sleep(0.2)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.terminate()
        for pr in procs:
            pr.wait()
        for t in pumps:
            t.join(timeout=5)
    return failed or next((pr.returncode for pr in procs if pr.returncode),
                          0)


if __name__ == "__main__":
    sys.exit(main())
