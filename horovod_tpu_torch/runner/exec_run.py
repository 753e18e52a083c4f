"""Static-run slot spawning (the gloo_run analog).

Reference horovod/runner/gloo_run.py — ``launch_gloo`` (:242): compute
SlotInfo assignments, build the per-slot env (HOROVOD_RANK/SIZE/...
:66-101), spawn each slot via local exec or ssh in a thread pool, and
kill everything if any slot fails (:137-199). The JAX package's
``runner/exec_run.py`` is the same flow.

A slot is one process on one card: ``core/basics.init()`` binds
``cuda:HOROVOD_LOCAL_RANK`` and joins a ``torch.distributed`` world
(NCCL; gloo with ``--device cpu``) whose TCP store rank 0 binds at
``HVD_TPU_COORDINATOR_ADDRESS`` — a free port on rank 0's host. Each
slot also gets the eager negotiation runtime's coordinator,
``HVD_TPU_NATIVE_COORDINATOR_ADDR/PORT`` (rank 0's host and another
free port there), which rank 0's C++ controller binds under
``HVD_TPU_NATIVE=1``, as the JAX package publishes them
(``horovod_tpu/runner/exec_run.py:72-82``). The slot env differs from
the JAX package's in these keys only:

* ``HOROVOD_CONTROLLER`` and ``HOROVOD_CPU_OPERATIONS`` name the port's
  data plane, ``torch.distributed``, not ``xla``;
* a static launch starts no rendezvous HTTP store and exports no
  ``HOROVOD_GLOO_RENDEZVOUS_*``/``HVD_TPU_RENDEZVOUS_*``: only an
  elastic round has one (``launch_slots(rendezvous=...)``: the elastic
  driver's ``http_server.RendezvousServer``, which already published
  the round's assignments; its address reaches every worker, whose
  notification service, replica store and recovery ladder use it,
  ``horovod_tpu/runner/exec_run.py:59-62, 118-140``). The data plane
  still meets at rank 0's TCP store;
* with NICs given or probed, ``launch_slots`` also exports
  ``NCCL_SOCKET_IFNAME`` and ``GLOO_SOCKET_IFNAME`` (unless already
  set), and a remote worker receives ``NCCL_*``, ``GLOO_*``, ``CUDA_*``
  and ``TORCH_*`` besides ``HOROVOD_*``, ``HVD_TPU_*``, ``PYTHON*`` and
  ``PATH``.
"""

from __future__ import annotations

import os
import shlex
import sys
import threading
from typing import Callable, Dict, List, Optional

from .util import safe_shell_exec
from .util.hosts import HostInfo, SlotInfo, get_host_assignments
from .util.network import (
    find_free_port,
    is_local_host,
    routable_host_address,
)
from .util.secret import ENV_SECRET

DATA_PLANE = "torch.distributed"
# env a remote worker receives over ssh: the control plane's, the
# interpreter's, and the data plane's (NCCL, gloo, CUDA, PyTorch)
REMOTE_ENV_PREFIXES = ("HOROVOD_", "HVD_TPU_", "PYTHON", "NCCL_", "GLOO_",
                       "CUDA_", "TORCH_")


def slot_env(
    slot: SlotInfo,
    base_env: Dict[str, str],
    coordinator_address: str,
    rendezvous_addr: Optional[str] = None,
    rendezvous_port: int = 0,
    native_coordinator_port: int = 0,
) -> Dict[str, str]:
    """Per-slot worker environment (reference gloo_run.py:66-101); the
    rendezvous store's address when the launch has one, and the eager
    runtime's coordinator when ``native_coordinator_port`` is given."""
    env = dict(base_env)
    pairs = {
        "RANK": slot.rank,
        "SIZE": slot.size,
        "LOCAL_RANK": slot.local_rank,
        "LOCAL_SIZE": slot.local_size,
        "CROSS_RANK": slot.cross_rank,
        "CROSS_SIZE": slot.cross_size,
    }
    for name, v in pairs.items():
        env[f"HOROVOD_{name}"] = str(v)
        env[f"HVD_TPU_{name}"] = str(v)
    if rendezvous_addr:
        env["HOROVOD_GLOO_RENDEZVOUS_ADDR"] = rendezvous_addr
        env["HOROVOD_GLOO_RENDEZVOUS_PORT"] = str(rendezvous_port)
        env["HVD_TPU_RENDEZVOUS_ADDR"] = rendezvous_addr
        env["HVD_TPU_RENDEZVOUS_PORT"] = str(rendezvous_port)
    env["HOROVOD_CONTROLLER"] = DATA_PLANE
    env["HOROVOD_CPU_OPERATIONS"] = DATA_PLANE
    # the torch.distributed TCP store: rank 0's init() binds it on its
    # host at this address, every rank dials it
    env["HVD_TPU_COORDINATOR_ADDRESS"] = coordinator_address
    env["HVD_TPU_NUM_PROCESSES"] = str(slot.size)
    env["HVD_TPU_PROCESS_ID"] = str(slot.rank)
    # the eager runtime (HVD_TPU_NATIVE=1): rank 0's C++ controller
    # binds this port on its host and every rank dials it; published
    # always, harmless when the runtime is off
    if native_coordinator_port:
        env["HVD_TPU_NATIVE_COORDINATOR_ADDR"] = (
            coordinator_address.rsplit(":", 1)[0])
        env["HVD_TPU_NATIVE_COORDINATOR_PORT"] = str(
            native_coordinator_port)
    return env


def _exec_local(command: List[str], env, slot: SlotInfo, events) -> int:
    return safe_shell_exec.execute(
        command, env=env, prefix=f"{slot.rank}", events=events
    )


def _remote_command(command: List[str], env) -> str:
    """The `cd && env ... cmd` line a remote shell runs: exports the
    control-plane env, PATH/PYTHON* so venv/PYTHONPATH setups that work
    locally keep working over ssh, and the data plane's NCCL_*/GLOO_*/
    CUDA_*/TORCH_* so interface and card choices reach the worker."""
    exported = " ".join(
        f"{k}={shlex.quote(v)}"
        for k, v in env.items()
        if k.startswith(REMOTE_ENV_PREFIXES) or k == "PATH"
    )
    return f"cd {shlex.quote(os.getcwd())} && env {exported} " + " ".join(
        shlex.quote(c) for c in command
    )


def _exec_ssh(command: List[str], env, slot: SlotInfo, events) -> int:
    # -tt allocates a tty so the remote worker gets SIGHUP when the local
    # ssh client is killed — no orphan trainers holding cards
    ssh_cmd = [
        "ssh", "-tt", "-o", "StrictHostKeyChecking=no", slot.hostname,
        _remote_command(command, env),
    ]
    return safe_shell_exec.execute(
        ssh_cmd, env=dict(os.environ), prefix=f"{slot.rank}", events=events
    )


def launch_slots(
    command: List[str],
    assignments: List[SlotInfo],
    env: Dict[str, str],
    exec_fn: Optional[Callable] = None,
    nics: Optional[List[str]] = None,
    nics_explicit: bool = True,
    rendezvous=None,
    abort: Optional[threading.Event] = None,
) -> List[int]:
    """Spawn one worker per slot; any failure terminates all others.

    Returns per-slot exit codes. `exec_fn(command, env, slot, events)` is
    injectable for tests (reference pattern: mocked ssh in test_run.py).
    ``rendezvous``: an elastic round's ``RendezvousServer``, which has
    published this round's assignments; the workers get its address.
    ``abort``, once set, stops every slot as a failure does.
    """
    host_addr = routable_host_address()
    if all(is_local_host(slot.hostname) for slot in assignments):
        # single-host world: loopback always routes; the outbound-NIC
        # address may not accept hairpin connections (containers,
        # firewalled hosts) and no remote worker needs to reach us
        host_addr = "127.0.0.1"
    if nics:
        env = dict(env)
        env["HOROVOD_NICS"] = ",".join(nics)
        # the data plane picks its sockets' interfaces from these (the
        # reference's gloo launcher exports them from the same probe);
        # a user's own setting wins, and the probe's stand-in name for
        # an unnamed outbound address is no interface
        from .driver.probe import DEFAULT_IFACE

        ifaces = [n for n in nics if n != DEFAULT_IFACE]
        for var in ("NCCL_SOCKET_IFNAME", "GLOO_SOCKET_IFNAME"):
            if ifaces and var not in env:
                env[var] = ",".join(ifaces)
        # Rebind this host's address only for an EXPLICIT
        # --network-interface: the user names a launcher NIC and gets it
        # verbatim. Auto-probed NICs were validated for WORKER-to-worker
        # routability — the launcher never probed itself, and a launcher
        # NIC that merely shares the name could carry an address workers
        # cannot route (reference ships probed NICs to NCCL/Gloo but
        # keeps its own service on all addresses, driver_service.py:260).
        if nics_explicit:
            from .driver.probe import interface_addresses

            by_iface = interface_addresses(nics)
            for nic in nics:
                if nic in by_iface:
                    host_addr = by_iface[nic]
                    break
    # The TCP store and the eager runtime's controller run inside the
    # rank-0 *worker*, so their address must name rank 0's host. A
    # local rank 0 gets ports probed free here; a remote one's ports
    # cannot be probed from here, so ports free on this host are the
    # guess (the JAX launcher guesses its rendezvous port + 19 and + 23).
    rank0_host = assignments[0].hostname
    rank0_addr = host_addr if is_local_host(rank0_host) else rank0_host
    store_port = find_free_port()
    coordinator = f"{rank0_addr}:{store_port}"
    native_port = find_free_port()
    while native_port == store_port:
        native_port = find_free_port()

    if ENV_SECRET not in env:
        from .util.secret import make_secret_key

        env = dict(env)
        env[ENV_SECRET] = make_secret_key().decode()

    rdv_port = rendezvous.port if rendezvous is not None else 0
    rdv_addr = host_addr if rendezvous is not None else None

    failure = threading.Event()
    codes: List[Optional[int]] = [None] * len(assignments)
    # set when a slot's thread is done with its process: after it reaped
    # it, or gave up on it
    done = [threading.Event() for _ in assignments]

    def run_slot(i: int, slot: SlotInfo):
        wenv = slot_env(slot, env, coordinator, rdv_addr, rdv_port,
                        native_coordinator_port=native_port)
        fn = exec_fn
        if fn is None:
            fn = _exec_local if is_local_host(slot.hostname) else _exec_ssh
        try:
            codes[i] = fn(command, wenv, slot,
                          [failure] + ([abort] if abort else []))
        except BaseException:
            codes[i] = 1
            raise
        finally:
            if codes[i] != 0:
                failure.set()
            done[i].set()

    threads = [
        threading.Thread(target=run_slot, args=(i, s), daemon=True)
        for i, s in enumerate(assignments)
    ]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join()
    except BaseException:
        # interrupted (SIGINT, or SIGTERM through launch.main): each
        # slot runs in a session of its own, so stop every slot's
        # process tree before leaving — no orphan holds a card. Wait on
        # the slots' own events, not Thread.join: a join that the signal
        # interrupted has marked its (live) thread stopped, so a second
        # join returns at once. Each slot's termination is bounded (its
        # watcher escalates to SIGKILL after GRACEFUL_TERMINATION_TIME_S)
        failure.set()
        for ev in done:
            ev.wait()
        raise
    return [c if c is not None else 1 for c in codes]


def probe_task_launcher(env: Dict[str, str]) -> Callable:
    """launch_task_fn for driver.probe.get_common_interfaces: start one
    probe task per host (local exec or ssh), detached — the task
    registers with the driver service and exits on its shutdown request
    (reference _launch_task_servers, driver_service.py:90)."""
    import base64
    import json

    secret = env.get(ENV_SECRET, os.environ.get(ENV_SECRET, ""))

    def launch(idx: int, host: str, driver_addresses) -> None:
        b64 = base64.b64encode(
            json.dumps([list(a) for a in driver_addresses]).encode()
        ).decode()
        # "python" resolves via the exported PATH on the remote host —
        # the launcher's sys.executable path may not exist there
        cmd = [
            "python", "-m", "horovod_tpu_torch.runner.driver.probe_task",
            str(idx), b64,
        ]
        task_env = dict(os.environ)
        task_env[ENV_SECRET] = secret

        def run():
            if is_local_host(host):
                local_cmd = [sys.executable] + cmd[1:]
                safe_shell_exec.execute(local_cmd, env=task_env,
                                        prefix=f"probe-{idx}")
            else:
                # same env-export contract as worker ssh (_exec_ssh):
                # PATH/PYTHON* travel so venv setups keep working
                safe_shell_exec.execute(
                    ["ssh", "-tt", "-o", "StrictHostKeyChecking=no",
                     host, _remote_command(cmd, task_env)],
                    env=dict(os.environ), prefix=f"probe-{idx}",
                )

        threading.Thread(target=run, daemon=True,
                         name=f"probe-task-{idx}").start()

    return launch


def run_static(
    command: List[str],
    hosts: List[HostInfo],
    np: int,
    env: Optional[Dict[str, str]] = None,
    exec_fn: Optional[Callable] = None,
    nics: Optional[List[str]] = None,
) -> List[int]:
    """Static (non-elastic) launch: assignments once, run to completion.

    With remote hosts and no explicit `nics`, the task-to-task NIC probe
    runs first and the control plane binds only interfaces every host
    can actually route (reference driver_service.py:260)."""
    assignments = get_host_assignments(hosts, np, np)
    env = dict(env or os.environ)
    if ENV_SECRET not in env:
        from .util.secret import make_secret_key

        env[ENV_SECRET] = make_secret_key().decode()
    host_names = [h.hostname for h in hosts]
    explicit = bool(nics)
    if exec_fn is None and (
        nics or any(not is_local_host(h) for h in host_names)
    ):
        from .driver.probe import get_common_interfaces

        nics = get_common_interfaces(
            host_names, env[ENV_SECRET].encode(), nics=nics,
            launch_task_fn=probe_task_launcher(env),
        )
    return launch_slots(
        command, assignments, env, exec_fn=exec_fn, nics=nics,
        nics_explicit=explicit,
    )
