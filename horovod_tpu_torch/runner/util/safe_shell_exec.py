"""Subprocess execution with whole-process-tree termination.

Reference horovod/runner/common/util/safe_shell_exec.py: launcher-
spawned workers get their own process group; on failure/interrupt the
entire tree is terminated (SIGTERM, then SIGKILL after
``GRACEFUL_TERMINATION_TIME_S``) so no orphan trainer holds a card.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

GRACEFUL_TERMINATION_TIME_S = 5.0


def terminate_process_tree(
        pid: int, timeout_s: float = GRACEFUL_TERMINATION_TIME_S) -> None:
    """SIGTERM the process group; escalate to SIGKILL after timeout."""
    try:
        pgid = os.getpgid(pid)
    except ProcessLookupError:
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
    except ProcessLookupError:
        return
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            return
        time.sleep(0.1)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _pipe(stream, sink, prefix: str) -> threading.Thread:
    def pump():
        try:
            for line in iter(stream.readline, b""):
                text = line.decode(errors="replace")
                if prefix:
                    text = f"[{prefix}]{text}" if text.strip() else text
                sink.write(text)
                sink.flush()
        except ValueError:
            pass

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return t


def execute(
    command,
    env: Optional[Dict[str, str]] = None,
    stdout=None,
    stderr=None,
    prefix: str = "",
    events=None,
    shell: bool = False,
) -> int:
    """Run command in its own process group, streaming output.

    `events` is an optional list of threading.Event; if any fires, the
    process tree is terminated (the launcher's any-failure-kills-all
    behavior, reference gloo_run.py:137-199).
    """
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr
    proc = subprocess.Popen(
        command,
        env=env,
        shell=shell,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        start_new_session=True,
    )

    pumps = [
        _pipe(proc.stdout, stdout, prefix),
        _pipe(proc.stderr, stderr, prefix),
    ]

    stop_watch = threading.Event()
    if events:
        def watch():
            while not stop_watch.is_set():
                for ev in events:
                    if ev.is_set():
                        terminate_process_tree(proc.pid)
                        return
                time.sleep(0.1)

        threading.Thread(target=watch, daemon=True).start()

    try:
        ret = proc.wait()
    except KeyboardInterrupt:
        terminate_process_tree(proc.pid)
        raise
    finally:
        stop_watch.set()
    for t in pumps:
        t.join(timeout=2)
    return ret
