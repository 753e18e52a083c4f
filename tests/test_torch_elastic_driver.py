"""The port's elastic driver (horovod_tpu_torch.runner.elastic) against
the JAX package's: tests/test_elastic_driver.py's 13 scenarios with the
same names and assertions (scripted discovery, injected exec, real
threads), then the same host sequences and worker outcomes through both
drivers, which must give the same slot assignments each round, the same
blacklist and the same return code."""

import threading
import time

import pytest

from horovod_tpu.runner.elastic import discovery as jax_discovery
from horovod_tpu.runner.elastic import driver as jax_driver
from horovod_tpu.runner.elastic import settings as jax_settings
from horovod_tpu_torch.runner.elastic.discovery import (
    ADDED,
    MIXED,
    NO_UPDATE,
    REMOVED,
    FixedHosts,
    HostDiscoveryScript,
    HostManager,
)
from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
from horovod_tpu_torch.runner.elastic.registration import (
    FAILURE,
    SUCCESS,
    WorkerStateRegistry,
)
from horovod_tpu_torch.runner.elastic.settings import ElasticSettings
from horovod_tpu_torch.runner.elastic.worker import (
    WorkerNotificationClient,
    WorkerNotificationManager,
    WorkerNotificationService,
)
from horovod_tpu_torch.runner.util.secret import make_secret_key


def settings(**kw):
    kw.setdefault("min_np", 2)
    kw.setdefault("timeout_s", 10.0)
    kw.setdefault("discovery_interval_s", 0.05)
    return ElasticSettings(**kw)


# ------------------------------------------------------------- discovery


def test_host_manager_classifies_updates():
    disc = FixedHosts({"h1": 2})
    mgr = HostManager(disc)
    assert mgr.update_available_hosts() == ADDED
    assert mgr.update_available_hosts() == NO_UPDATE
    disc.set({"h1": 2, "h2": 2})
    assert mgr.update_available_hosts() == ADDED
    disc.set({"h2": 2})
    assert mgr.update_available_hosts() == REMOVED
    disc.set({"h2": 4})
    assert mgr.update_available_hosts() == MIXED
    assert mgr.current_hosts.count_available_slots() == 4


def test_host_manager_blacklist_and_cooldown_resurrection():
    disc = FixedHosts({"h1": 1, "h2": 1})
    mgr = HostManager(disc, cooldown_range=(0.2, 0.2))
    mgr.update_available_hosts()
    mgr.blacklist("h1")
    mgr.update_available_hosts()
    assert mgr.current_hosts.available_hosts == {"h2"}
    assert mgr.is_blacklisted("h1")
    time.sleep(0.3)  # cooldown expires -> resurrection
    mgr.update_available_hosts()
    assert mgr.current_hosts.available_hosts == {"h1", "h2"}


def test_host_manager_blacklist_permanent_without_cooldown():
    disc = FixedHosts({"h1": 1})
    mgr = HostManager(disc)  # no cooldown range -> permanent
    mgr.update_available_hosts()
    mgr.blacklist("h1")
    time.sleep(0.1)
    mgr.update_available_hosts()
    assert mgr.current_hosts.available_hosts == set()


def test_discovery_script(tmp_path):
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\necho h1:2\necho h2\n")
    script.chmod(0o755)
    disc = HostDiscoveryScript(str(script), default_slots=3)
    assert disc.find_available_hosts_and_slots() == {"h1": 2, "h2": 3}


# ------------------------------------------------------------- registry


def test_registry_barrier_fires_on_all_terminal():
    fired = []
    reg = WorkerStateRegistry(lambda states: fired.append(states))
    reg.reset(2)
    reg.record_ready("h1", 0)
    reg.record_ready("h1", 1)
    assert not fired
    reg.record_success("h1", 0)
    assert not fired
    reg.record_failure("h1", 1)
    assert len(fired) == 1
    assert fired[0] == {"h1:0": SUCCESS, "h1:1": FAILURE}


def test_registry_first_terminal_state_wins():
    fired = []
    reg = WorkerStateRegistry(lambda s: fired.append(s))
    reg.reset(1)
    reg.record_failure("h1", 0)
    reg.record_success("h1", 0)  # ignored
    assert fired[0] == {"h1:0": FAILURE}


# ------------------------------------------------------------- driver


class ScriptedExec:
    """Injected exec: behavior per (round, rank) — exit code or callable."""

    def __init__(self, behavior):
        self.behavior = behavior  # {(round, rank): code}
        self.calls = []
        self.lock = threading.Lock()
        self.round_counter = {}

    def __call__(self, command, env, slot, events):
        with self.lock:
            r = self.round_counter.get(slot.rank, 0)
            self.round_counter[slot.rank] = r + 1
            self.calls.append((r, slot.rank, slot.hostname))
        code = self.behavior.get((r, slot.rank), 0)
        if callable(code):
            return code(slot, events)
        return code


def test_driver_all_success_single_round():
    disc = FixedHosts({"h1": 1, "h2": 1})
    ex = ScriptedExec({})
    driver = ElasticDriver(
        HostManager(disc), settings(), ["cmd"], {}, exec_fn=ex)
    assert driver.run() == 0
    assert sorted(c[1] for c in ex.calls) == [0, 1]


def test_driver_retries_after_failure_and_blacklists():
    """Round 0: rank on h2 fails -> h2 blacklisted; round 1 runs on the
    remaining hosts and succeeds."""
    disc = FixedHosts({"h1": 1, "h2": 1, "h3": 1})

    def fail_on_h2(slot, events):
        return 1 if slot.hostname == "h2" else 0

    ex = ScriptedExec({
        (0, 0): fail_on_h2, (0, 1): fail_on_h2, (0, 2): fail_on_h2,
    })
    driver = ElasticDriver(
        HostManager(disc), settings(min_np=2), ["cmd"], {}, exec_fn=ex)
    assert driver.run() == 0
    hosts_round1 = {c[2] for c in ex.calls if c[0] == 1}
    assert "h2" not in hosts_round1
    assert hosts_round1 <= {"h1", "h3"}


def test_driver_rank_stability_across_rounds():
    """Hosts surviving a failure keep their global ranks."""
    disc = FixedHosts({"h1": 1, "h2": 1, "h3": 1})

    def fail_h3(slot, events):
        return 1 if slot.hostname == "h3" else 0

    ex = ScriptedExec({
        (0, 0): fail_h3, (0, 1): fail_h3, (0, 2): fail_h3,
    })
    captured = {}
    orig_call = ex.__call__

    def capturing(command, env, slot, events):
        captured.setdefault(slot.hostname, []).append(
            (int(env["HOROVOD_RANK"]), int(env["HOROVOD_SIZE"])))
        return orig_call(command, env, slot, events)

    driver = ElasticDriver(
        HostManager(disc), settings(min_np=2), ["cmd"], {},
        exec_fn=capturing)
    assert driver.run() == 0
    # surviving hosts keep their round-0 rank in round 1 (size 3 -> 2)
    for host in ("h1", "h2"):
        ranks = [r for r, _ in captured[host]]
        assert len(set(ranks)) == 1, f"{host} changed rank: {ranks}"
    sizes_round1 = {s for host in ("h1", "h2")
                    for _, s in captured[host][1:]}
    assert sizes_round1 == {2}


def test_driver_reset_limit():
    disc = FixedHosts({"h1": 1, "h2": 1})
    ex = ScriptedExec({
        (r, rank): 1 for r in range(10) for rank in range(2)
    })
    driver = ElasticDriver(
        HostManager(disc, cooldown_range=(0.01, 0.02)),
        settings(min_np=1, reset_limit=2),
        ["cmd"], {}, exec_fn=ex)
    assert driver.run() == 1
    rounds = {c[0] for c in ex.calls}
    assert max(rounds) <= 2


def test_driver_scale_up_between_rounds():
    """New host appears after a failed round -> next round uses it."""
    disc = FixedHosts({"h1": 1, "h2": 1})

    def fail_once(slot, events):
        disc.set({"h1": 1, "h2": 1, "h3": 1})  # h3 joins
        return 1 if slot.rank == 1 else 0

    ex = ScriptedExec({(0, 0): fail_once, (0, 1): fail_once})
    driver = ElasticDriver(
        HostManager(disc), settings(min_np=1), ["cmd"], {}, exec_fn=ex)
    assert driver.run() == 0
    hosts_round1 = {c[2] for c in ex.calls if c[0] == 1}
    assert "h3" in hosts_round1


def test_driver_wait_for_available_slots_timeout():
    disc = FixedHosts({})
    driver = ElasticDriver(
        HostManager(disc), settings(min_np=2, timeout_s=0.3),
        ["cmd"], {}, exec_fn=ScriptedExec({}))
    driver.start()
    try:
        with pytest.raises(TimeoutError):
            driver.wait_for_available_slots(2, timeout_s=0.3)
    finally:
        driver.stop()


# ------------------------------------------------- worker notification


def test_worker_notification_roundtrip():
    """Driver-side client pushes HostsUpdatedRequest; worker-side manager
    flips the elastic host-update flag (reference worker.py protocol)."""
    from horovod_tpu_torch.elastic.state import host_update_flag

    host_update_flag.consume()  # clear
    key = make_secret_key()
    mgr = WorkerNotificationManager()
    svc = WorkerNotificationService(key, mgr)
    try:
        client = WorkerNotificationClient(svc.addresses(), key)
        client.notify_hosts_updated(timestamp=1, update_result=ADDED)
        deadline = time.time() + 2
        while time.time() < deadline and not host_update_flag.consume():
            time.sleep(0.01)
        # stale timestamp ignored
        client.notify_hosts_updated(timestamp=1, update_result=ADDED)
        time.sleep(0.1)
        assert not host_update_flag.consume()
        # newer timestamp delivered
        client.notify_hosts_updated(timestamp=2, update_result=REMOVED)
        time.sleep(0.1)
        assert host_update_flag.consume()
    finally:
        svc.shutdown()


# ---------------------------------------- the same rounds as the JAX driver

#: (hosts at start, {(round, host): exit code}, host set after round 0,
#: settings): 83 is a preemption, -15 an outside SIGTERM
_SCENARIOS = {
    "fail-one-of-three": ({"h1": 1, "h2": 1, "h3": 1},
                          {(0, "h2"): 1}, None, dict(min_np=2)),
    "two-slot-hosts": ({"a": 2, "b": 2, "c": 1},
                       {(0, "b"): 3}, None, dict(min_np=2, max_np=4)),
    "preempted-stays": ({"h1": 1, "h2": 1},
                        {(0, "h2"): 83}, None, dict(min_np=2)),
    "outside-sigterm": ({"h1": 1, "h2": 1},
                        {(0, "h1"): -15}, None, dict(min_np=2)),
    "grow-after-failure": ({"h1": 1, "h2": 1},
                           {(0, "h1"): 1}, {"h1": 1, "h2": 1, "h3": 2},
                           dict(min_np=1, max_np=3)),
    "reset-limit": ({"h1": 1, "h2": 1, "h3": 1},
                    {(0, "h1"): 1, (0, "h2"): 1},
                    None, dict(min_np=1, max_np=1, reset_limit=2)),
}


def _drive(pkg, scenario):
    """One scenario through a package's driver: the SlotInfo strings
    each round, the blacklist and the return code."""
    hosts, outcome, grown, kw = scenario
    if pkg == "jax":
        disc_mod, drv_mod, set_mod = (jax_discovery, jax_driver,
                                      jax_settings)
    else:
        from horovod_tpu_torch.runner.elastic import discovery as disc_mod
        from horovod_tpu_torch.runner.elastic import driver as drv_mod
        from horovod_tpu_torch.runner.elastic import settings as set_mod
    disc = disc_mod.FixedHosts(hosts)
    rounds, lock, seen = {}, threading.Lock(), {}
    kw = dict(kw, timeout_s=5.0, discovery_interval_s=0.05)

    def exec_fn(command, env, slot, events):
        with lock:
            r = seen.setdefault(slot.hostname, {}).setdefault(
                slot.local_rank, 0)
            seen[slot.hostname][slot.local_rank] = r + 1
            rounds.setdefault(r, []).append(slot.to_response_string())
        code = outcome.get((r, slot.hostname), 0)
        if r == 0 and grown is not None:
            disc.set(grown)
        return code

    mgr = disc_mod.HostManager(disc, kw.get("cooldown_range"))
    driver = drv_mod.ElasticDriver(mgr, set_mod.ElasticSettings(**kw),
                                   ["cmd"], {}, exec_fn=exec_fn)
    rc = driver.run()
    every = set(hosts) | set(grown or {})
    return ({r: sorted(v) for r, v in rounds.items()},
            sorted(h for h in every if mgr.is_blacklisted(h)), rc)


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_rounds_blacklist_and_code_match_jax(name):
    mine = _drive("port", _SCENARIOS[name])
    theirs = _drive("jax", _SCENARIOS[name])
    assert mine == theirs
    rounds, blacklisted, rc = mine
    if name in ("preempted-stays", "outside-sigterm"):
        assert blacklisted == [] and rc == 0 and len(rounds) == 2
    if name == "reset-limit":
        assert rc == 1 and blacklisted == ["h1", "h2"]


# ------------------------------------- tests/test_faults.py's elastic cases


def test_discovery_flap_and_retry():
    from horovod_tpu_torch.utils import faults, retry

    retry.set_default_policy(retry.RetryPolicy(
        max_attempts=4, base_delay_s=0.0, max_delay_s=0.0,
        sleep=lambda s: None))
    try:
        mgr = HostManager(FixedHosts({"a": 1, "b": 1}))
        assert mgr.update_available_hosts() == ADDED
        # one flapped poll: everything vanishes, then comes back
        faults.configure("discovery.poll:flap:times=1")
        assert mgr.update_available_hosts() == REMOVED
        assert mgr.current_hosts.count_available_slots() == 0
        assert mgr.update_available_hosts() == ADDED
        assert mgr.current_hosts.count_available_slots() == 2
        # transient poll errors retry inside one update call
        faults.configure("discovery.poll:error:times=2")
        assert mgr.update_available_hosts() == NO_UPDATE
    finally:
        faults.reset()
        retry.set_default_policy(None)


def test_driver_maps_preempted_code_to_aborted():
    """A worker exiting with PREEMPTED_EXIT_CODE reaches the barrier as
    ABORTED: terminal, never blacklisted, one round lost."""
    from horovod_tpu_torch.elastic.preemption import PREEMPTED_EXIT_CODE

    first_round = {"fired": False}

    def exec_fn(command, env, slot, events):
        if slot.rank == 1 and not first_round["fired"]:
            first_round["fired"] = True
            return PREEMPTED_EXIT_CODE
        return 0

    driver = ElasticDriver(
        HostManager(FixedHosts({"hostA": 1, "hostB": 1})),
        ElasticSettings(min_np=2, max_np=2, timeout_s=10.0,
                        discovery_interval_s=0.1, reset_limit=4),
        command=["true"], env={}, exec_fn=exec_fn)
    try:
        assert driver.run() == 0
        assert not driver._host_manager.is_blacklisted("hostA")
        assert not driver._host_manager.is_blacklisted("hostB")
        assert driver._resets == 1, "preemption costs one round, no more"
    finally:
        driver.stop()


def test_driver_stop_stops_the_rounds_workers():
    """Stopping the driver (the launcher's SIGTERM) ends the running
    round's workers: their exec sees the abort event."""
    started, ended = threading.Event(), threading.Event()

    def exec_fn(command, env, slot, events):
        started.set()
        while not any(e.is_set() for e in events):
            time.sleep(0.01)
        ended.set()
        return -15

    driver = ElasticDriver(
        HostManager(FixedHosts({"h1": 1})),
        ElasticSettings(min_np=1, timeout_s=10.0, discovery_interval_s=0.05,
                        spawn_join_timeout_s=10.0),
        ["cmd"], {}, exec_fn=exec_fn)
    t = threading.Thread(target=driver.run, daemon=True)
    t.start()
    assert started.wait(10)
    driver.stop()
    assert ended.is_set()
    t.join(10)
    assert not t.is_alive()
