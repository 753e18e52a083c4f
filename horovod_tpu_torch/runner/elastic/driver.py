"""Elastic driver: discovery loop, rank-stable reassignment, fault rounds.

``horovod_tpu/runner/elastic/driver.py`` (reference
runner/elastic/driver.py:69, ``ElasticDriver``): a discovery thread
polls ``HostManager.update_available_hosts`` (:102); host-set changes
are pushed to the workers (:210); ``_update_host_assignments`` (:240)
recomputes the SlotInfos keeping surviving hosts' ranks; the
``WorkerStateRegistry`` barrier ends a round; failing hosts are
blacklisted; ``reset_limit`` bounds the resets.

A reset respawns the worker processes on the new host set: each round
is a fresh ``torch.distributed`` world (a fresh TCP store at rank 0),
and the worker-side state carries over through the elastic ``State``
(``horovod_tpu_torch/elastic/``: the recovery ladder on entry, the
sync from rank 0). A worker that exits with ``PREEMPTED_EXIT_CODE``
(83) or dies of an outside SIGTERM ends its round ABORTED: its host was
healthy and stays eligible (``driver.py:301-370`` there). Left out: the
JAX driver's persisting of workers' flight-recorder dumps (ROADMAP
queue A entry 13) and the control-plane supervisor it owns (entry 14).
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

from ...elastic.preemption import PREEMPTED_EXIT_CODE
from ...utils import faults, retry
from ...utils import metrics as _metrics
from ..exec_run import launch_slots
from ..http.http_server import RendezvousServer
from ..util.hosts import SlotInfo, get_host_assignments
from ..util.network import get_local_host_addresses, is_local_host
from ..util.secret import ENV_SECRET, make_secret_key
from .discovery import NO_UPDATE, HostManager
from .registration import FAILURE, SUCCESS, WorkerStateRegistry
from .settings import ElasticSettings
from .worker import get_worker_client

LOG = logging.getLogger("horovod_tpu_torch.elastic")


class ElasticDriver:
    def __init__(
        self,
        host_manager: HostManager,
        settings: ElasticSettings,
        command: List[str],
        env: Dict[str, str],
        exec_fn: Optional[Callable] = None,
        nics: Optional[List[str]] = None,
        rendezvous_state_dir: Optional[str] = None,
    ):
        self._host_manager = host_manager
        self._settings = settings
        self._command = list(command)
        self._env = dict(env)
        # an explicit --network-interface pins the control plane for
        # every round
        self._nics = list(nics) if nics else None
        if ENV_SECRET not in self._env:
            self._env[ENV_SECRET] = make_secret_key().decode()
        self._exec_fn = exec_fn

        self._registry = WorkerStateRegistry(self._on_barrier)
        # --rendezvous-state-dir: the store persists, so a restarted
        # driver resumes the same job (same port, round and ranks)
        self._rendezvous = RendezvousServer(state_dir=rendezvous_state_dir)
        self._rank_assignments: Dict[str, List[int]] = {}
        self._assignments: List[SlotInfo] = []
        if self._rendezvous.restored:
            for slot in self._rendezvous.last_assignments():
                self._rank_assignments.setdefault(
                    slot.hostname, []).append(slot.rank)
            if self._rank_assignments:
                LOG.warning(
                    "resuming persisted rendezvous state (round %d, rank "
                    "assignments %s)", self._rendezvous.round,
                    self._rank_assignments)

        self._shutdown = threading.Event()
        self._notify_addr: Optional[str] = None
        self._notify_retry = retry.RetryPolicy(
            max_attempts=2, base_delay_s=0.05, max_delay_s=0.2)
        self._barrier_states: Optional[Dict[str, str]] = None
        self._barrier_event = threading.Event()
        self._notify_timestamp = 0
        self._discovery_thread: Optional[threading.Thread] = None
        # set when the current round's launch_slots has returned
        self._spawn_done = threading.Event()
        self._spawn_done.set()
        self._resets = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Begin host discovery (reference driver.py:102)."""
        self._host_manager.update_available_hosts()
        self._discovery_thread = threading.Thread(
            target=self._discovery_loop, daemon=True,
            name="elastic-discovery")
        self._discovery_thread.start()

    def stop(self) -> None:
        # the running round's workers watch this event: they are stopped
        # (SIGTERM, then SIGKILL) before the driver goes
        self._shutdown.set()
        self._spawn_done.wait(timeout=self._settings.spawn_join_timeout_s)
        if self._discovery_thread is not None:
            self._discovery_thread.join(timeout=5)
        self._rendezvous.shutdown_server()

    def wait_for_available_slots(self, min_np: int,
                                 timeout_s: Optional[float] = None) -> int:
        """Block until discovery reports >= min_np slots
        (reference driver.py:153)."""
        timeout_s = (timeout_s if timeout_s is not None
                     else self._settings.timeout_s)
        deadline = retry.Deadline(timeout_s)
        while not deadline.expired() and not self._shutdown.is_set():
            n = self._host_manager.current_hosts.count_available_slots()
            if n >= min_np:
                return n
            time.sleep(0.1)
        raise TimeoutError(
            f"timed out waiting for {min_np} slots (have "
            f"{self._host_manager.current_hosts.count_available_slots()})")

    # -- main loop ---------------------------------------------------------

    def run(self) -> int:
        """Run rounds until one succeeds everywhere (0) or the job
        cannot continue (1)."""
        self.start()
        try:
            while not self._shutdown.is_set():
                try:
                    self.wait_for_available_slots(self._settings.min_np)
                except TimeoutError as e:
                    LOG.error("elastic job cannot continue: %s", e)
                    return 1
                states = self._run_round()
                if states and all(s == SUCCESS for s in states.values()):
                    return 0
                self._resets += 1
                if (self._settings.reset_limit
                        and self._resets >= self._settings.reset_limit):
                    LOG.error("elastic reset limit %d reached",
                              self._settings.reset_limit)
                    return 1
            return 1
        finally:
            self.stop()

    def _run_round(self) -> Dict[str, str]:
        assignments = self._update_host_assignments()
        self._assignments = assignments
        self._registry.reset(len(assignments))
        self._barrier_event.clear()
        self._barrier_states = None

        def _init_rendezvous():
            faults.inject("rendezvous.init", round=self._rendezvous.round)
            self._rendezvous.init(assignments)

        retry.default_policy().call(_init_rendezvous,
                                    point="rendezvous.init")
        _metrics.record_elastic_event("round")

        spawn_done = self._spawn_done = threading.Event()

        def spawn():
            try:
                launch_slots(self._command, assignments, self._env,
                             exec_fn=self._wrap_exec(), nics=self._nics,
                             rendezvous=self._rendezvous,
                             abort=self._shutdown)
            finally:
                spawn_done.set()

        threading.Thread(target=spawn, daemon=True).start()
        # while waiting on the round's barrier: a worker whose exec hangs
        # (dead host, stuck ssh) never reaches a terminal state by
        # itself; once discovery stops listing its host for longer than
        # the grace, count it failed so the barrier can complete
        vanished_since: Dict[str, float] = {}
        grace = self._settings.host_vanish_grace_s
        while not self._barrier_event.wait(timeout=1.0):
            if self._shutdown.is_set():
                break
            live = self._host_manager.current_hosts.available_hosts
            now = time.monotonic()
            for slot in assignments:
                if slot.hostname in live:
                    vanished_since.pop(slot.hostname, None)
                elif now - vanished_since.setdefault(slot.hostname,
                                                     now) > grace:
                    self._registry.record_failure(slot.hostname,
                                                  slot.local_rank)
        spawn_done.wait(timeout=self._settings.spawn_join_timeout_s)
        # an interrupted round has no barrier states: "no successful
        # round", never a crash in run()
        states = self._barrier_states or {}
        if states:
            for key, state in states.items():
                if state == FAILURE:
                    host = key.rsplit(":", 1)[0]
                    self._host_manager.blacklist(host)
                    _metrics.record_elastic_event("blacklist")
                    LOG.warning("blacklisting failed host %s", host)
            self._host_manager.update_available_hosts()
        return states

    def _wrap_exec(self) -> Callable:
        """Exec wrapper recording each worker's exit in the registry
        (reference driver.py:304 _handle_worker_exit)."""
        inner = self._exec_fn

        def exec_and_record(command, env, slot, events):
            self._registry.record_ready(slot.hostname, slot.local_rank)
            try:
                # chaos hook: a driver.exec error rule fails this slot's
                # exec with no process spawned (a dead ssh)
                faults.inject("driver.exec", host=slot.hostname,
                              rank=slot.rank)
                if inner is not None:
                    code = inner(command, env, slot, events)
                else:
                    from ..exec_run import _exec_local, _exec_ssh

                    fn = (_exec_local if is_local_host(slot.hostname)
                          else _exec_ssh)
                    code = fn(command, env, slot, events)
            except Exception as e:
                # an exec that raises must still reach a terminal state,
                # or the round's barrier never fires
                LOG.warning("worker exec for rank %d raised: %s",
                            slot.rank, e)
                code = 1
            if code == 0:
                self._registry.record_success(slot.hostname,
                                              slot.local_rank)
            elif code == PREEMPTED_EXIT_CODE:
                # the worker's SIGTERM handler wrote the emergency
                # snapshot and exited with the "host going away" code:
                # terminal for the barrier, the host stays eligible
                _metrics.record_elastic_event("worker_preempted")
                LOG.warning("rank %d on %s preempted; host stays eligible",
                            slot.rank, slot.hostname)
                self._registry.record_aborted(slot.hostname,
                                              slot.local_rank)
            elif code < 0 and events and any(e.is_set() for e in events):
                # stopped by the launcher because another slot failed
                # first: not this host's fault. A worker that exited
                # nonzero by itself (code > 0) is a FAILURE even then.
                self._registry.record_aborted(slot.hostname,
                                              slot.local_rank)
            elif code == -signal.SIGTERM:
                # an outside SIGTERM with no handler installed: the
                # platform reclaiming the host, a preemption too
                _metrics.record_elastic_event("worker_preempted")
                LOG.warning("rank %d on %s killed by an outside SIGTERM; "
                            "treating as preemption, host stays eligible",
                            slot.rank, slot.hostname)
                self._registry.record_aborted(slot.hostname,
                                              slot.local_rank)
            else:
                self._registry.record_failure(slot.hostname,
                                              slot.local_rank)
            return code

        return exec_and_record

    def _on_barrier(self, states: Dict[str, str]) -> None:
        self._barrier_states = states
        self._barrier_event.set()

    # -- host management -----------------------------------------------------

    def _update_host_assignments(self) -> List[SlotInfo]:
        """Recompute slot assignments, keeping surviving hosts' ranks
        (reference driver.py:240-283)."""
        hosts = self._host_manager.current_hosts.host_infos()
        assignments = get_host_assignments(
            hosts, self._settings.min_np, self._settings.max_np,
            rank_assignments=self._rank_assignments)
        new_ranks: Dict[str, List[int]] = {}
        for slot in assignments:
            new_ranks.setdefault(slot.hostname, []).append(slot.rank)
        self._rank_assignments = new_ranks
        return assignments

    def _discovery_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                result = self._host_manager.update_available_hosts()
            except Exception as e:  # a discovery hiccup: warn, go on
                LOG.warning("host discovery failed: %s", e)
                result = NO_UPDATE
            if result != NO_UPDATE:
                self._notify_workers_host_changes(result)
            self._shutdown.wait(self._settings.discovery_interval_s)

    def _notification_addr(self) -> str:
        """The local address for worker-client lookups: the pinned
        --network-interface's when given, else the most routable one."""
        if self._notify_addr is not None:
            return self._notify_addr
        if not self._nics:
            self._notify_addr = get_local_host_addresses()[-1]
            return self._notify_addr
        try:
            from ..driver.probe import interface_addresses

            by_iface = interface_addresses(self._nics)
            for nic in self._nics:
                if nic in by_iface:
                    self._notify_addr = by_iface[nic]
                    return self._notify_addr
        except Exception as e:
            LOG.warning("could not resolve --network-interface %s for "
                        "worker notifications (%s)", self._nics, e)
        # not cached: a NIC still coming up must win the next attempt
        return get_local_host_addresses()[-1]

    def _notify_workers_host_changes(self, update_result: int) -> None:
        """Push a HostsUpdatedRequest to every registered worker
        (reference driver.py:210)."""
        self._notify_timestamp += 1
        addr = self._notification_addr()
        port = self._rendezvous.port
        key = self._env[ENV_SECRET].encode()
        timestamp = self._notify_timestamp
        for slot in self._assignments:
            def _notify(slot=slot):
                faults.inject("worker.notify", rank=slot.rank)
                client = get_worker_client(addr, port, slot.rank, key)
                if client is not None:
                    client.notify_hosts_updated(timestamp, update_result)

            try:
                # one quick retry: dead workers are expected here (often
                # the very change being notified)
                self._notify_retry.call(
                    _notify, point="worker.notify",
                    retryable=lambda e: isinstance(e, (OSError, EOFError)))
            except Exception as e:
                LOG.debug("notify rank %d failed: %s", slot.rank, e)
