"""The port's recovery layer (horovod_tpu_torch.elastic.preemption and
.replication, the durable rendezvous store) against the JAX package's:
tests/test_recovery.py's scenarios that reach no XLA, with the same
names and assertions (the corrupt action, the emergency checksum and
truncation, replication round trips and coalescing, the ladder's order
and fall-through, KV persistence and the port rebinding, the driver
resuming persisted assignments, workers riding an outage), then
cross-package cases: an emergency snapshot written by either package is
read by the other, a bf16 ``TorchState`` survives the replica and
emergency rungs bitwise, and the checkpoint rung restores a
``save_model`` checkpoint."""

import json
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.elastic import preemption, replication
from horovod_tpu_torch.elastic.state import ObjectState, TorchState
from horovod_tpu_torch.runner.http.http_server import (
    KVStoreServer,
    RendezvousServer,
)
from horovod_tpu_torch.utils import faults, metrics, retry


@pytest.fixture(autouse=True)
def _clean_modules():
    faults.reset()
    metrics.reset()
    replication.reset()
    yield
    faults.reset()
    metrics.reset()
    replication.reset()


# --------------------------------------------------------------- helpers


class _World2:
    """One in-process 'rank 0' replica store + rendezvous KV, plus a
    rank-1 replicator shipping to it."""

    def __init__(self, chunk_bytes=1 << 20):
        self.kv = KVStoreServer()
        self.port = self.kv.start_server()
        self.peer_store = replication.ReplicaStore()
        replication._http_put(
            "127.0.0.1", self.port, replication.STORE_SCOPE, "rank_0",
            json.dumps([("127.0.0.1", self.peer_store.port)]).encode())
        self.replicator = replication.Replicator(
            1, 2, [0], ("127.0.0.1", self.port),
            chunk_bytes=chunk_bytes, duty_cycle=1.0)

    @property
    def rendezvous(self):
        return ("127.0.0.1", self.port)

    def ship(self, state):
        self.replicator.submit(state._commit_count, state._saved)
        assert self.replicator.drain(10.0), "replicator never drained"

    def close(self):
        self.replicator.stop()
        self.peer_store.shutdown()
        self.kv.shutdown_server()


@pytest.fixture
def world2():
    w = _World2()
    yield w
    w.close()


# ------------------------------------------------------ corrupt action


def test_corrupt_action_flips_bytes_deterministically():
    data = bytes(range(256)) * 4
    faults.configure("x.payload:corrupt:seed=3")
    out1 = faults.corrupt("x.payload", data)
    faults.configure("x.payload:corrupt:seed=3")
    out2 = faults.corrupt("x.payload", data)
    assert out1 != data, "corrupt rule did not flip anything"
    assert out1 == out2, "same seed must corrupt identically"
    assert len(out1) == len(data)
    faults.configure("x.payload:corrupt:seed=4")
    assert faults.corrupt("x.payload", data) != out1


def test_corrupt_action_nbytes_and_times():
    data = b"\x00" * 1024
    faults.configure("x:corrupt:times=1:nbytes=1:seed=0")
    out = faults.corrupt("x", data)
    assert sum(a != b for a, b in zip(out, data)) == 1
    # times budget spent: second call passes through untouched
    assert faults.corrupt("x", data) == data


def test_corrupt_disabled_is_identity():
    data = b"payload"
    assert faults.corrupt("x", data) is data


def test_corrupt_records_fault_metric():
    metrics.enable()
    faults.configure("x:corrupt")
    faults.corrupt("x", b"abc")
    snap = metrics.registry.snapshot()
    assert snap["hvd_faults_injected_total"]["x,corrupt"] == 1.0


def test_corrupt_rule_on_inject_site_is_cooperative():
    faults.configure("p:corrupt")
    assert faults.inject("p") == "corrupt"


@pytest.mark.parametrize("spec", ["x:corrupt:seed=3", "x:corrupt:nbytes=40",
                                  "x:corrupt:seed=9:nbytes=1"])
def test_corrupt_flips_the_jax_packages_bytes(spec):
    from horovod_tpu.utils import faults as jax_faults

    data = bytes(range(256)) * 3
    faults.configure(spec)
    jax_faults.configure(spec)
    try:
        for _ in range(3):
            assert faults.corrupt("x", data) == jax_faults.corrupt("x", data)
    finally:
        jax_faults.reset()


# ----------------------------------------------- emergency checksum


def test_emergency_checksum_roundtrip(tmp_path):
    state = ObjectState(params=np.arange(6.0), step=4)
    state._commit_count = 9
    path = str(tmp_path / "e.pkl")
    preemption.emergency_save(state, path)
    epoch, saved = preemption.emergency_read(path)
    assert epoch == 9
    np.testing.assert_array_equal(saved["params"], np.arange(6.0))

    fresh = ObjectState(params=np.zeros(6), step=0)
    preemption.emergency_restore(fresh, path)
    assert fresh.step == 4
    assert fresh._commit_count == 9


def test_emergency_restore_rejects_corrupt_payload(tmp_path):
    state = ObjectState(params=np.arange(64.0), step=1)
    path = str(tmp_path / "e.pkl")
    faults.configure("emergency.payload:corrupt:seed=5")
    preemption.emergency_save(state, path)
    faults.reset()
    with pytest.raises(ValueError, match="checksum"):
        preemption.emergency_restore(
            ObjectState(params=np.zeros(64), step=0), path)


def test_emergency_restore_rejects_truncated_file(tmp_path):
    state = ObjectState(step=1)
    path = str(tmp_path / "e.pkl")
    preemption.emergency_save(state, path)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(Exception):
        preemption.emergency_restore(ObjectState(step=0), path)


def test_emergency_read_format1_compat(tmp_path):
    """Pre-checksum (format 1) files still load, with epoch 0."""
    import pickle

    path = str(tmp_path / "old.pkl")
    with open(path, "wb") as f:
        pickle.dump({"format": 1, "time_unix": 0.0,
                     "saved": {"step": 3}}, f)
    epoch, saved = preemption.emergency_read(path)
    assert epoch == 0 and saved == {"step": 3}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_emergency_snapshot_crosses_packages(tmp_path, writer):
    """An ObjectState's emergency snapshot written by one package is
    read and restored by the other, values and epoch equal."""
    from horovod_tpu.elastic import preemption as jax_preemption
    from horovod_tpu.elastic.state import ObjectState as JaxObjectState

    w_pre, w_state = ((jax_preemption, JaxObjectState) if writer == "jax"
                      else (preemption, ObjectState))
    r_pre, r_state = ((preemption, ObjectState) if writer == "jax"
                      else (jax_preemption, JaxObjectState))
    params = np.random.RandomState(1).randn(5, 7).astype(np.float32)
    state = w_state(params=params, step=12, name="x")
    state._commit_count = 6
    path = str(tmp_path / "e.pkl")
    w_pre.emergency_save(state, path)
    epoch, saved = r_pre.emergency_read(path)
    assert epoch == 6 and saved["step"] == 12 and saved["name"] == "x"
    assert saved["params"].tobytes() == params.tobytes()
    fresh = r_state(params=np.zeros((5, 7), np.float32), step=0, name="")
    r_pre.emergency_restore(fresh, path)
    assert fresh.step == 12 and fresh._commit_count == 6
    assert fresh.params.tobytes() == params.tobytes()


# ------------------------------------------------- replication wire


def test_ring_partners():
    assert replication.ring_partners(1, 2, 1) == [0]
    assert replication.ring_partners(0, 4, 2) == [1, 2]
    assert replication.ring_partners(3, 4, 2) == [0, 1]
    assert replication.ring_partners(0, 1, 1) == []
    # k clamped to the world (never replicate to yourself)
    assert replication.ring_partners(0, 3, 9) == [1, 2]


def test_replication_roundtrip_out_of_band_chunked():
    """A multi-chunk snapshot with array leaves survives the envelope +
    raw-buffer wire format bit-exactly."""
    w = _World2(chunk_bytes=4096)
    try:
        state = ObjectState(
            params={"w": np.random.RandomState(0).randn(64, 64),
                    "b": np.arange(7, dtype=np.float32)},
            step=11)
        state._commit_count = 5
        state.save()
        w.ship(state)
        got = replication.fetch_replica(1, w.rendezvous)
        assert got is not None
        epoch, saved = got
        assert epoch == 5
        assert saved["step"] == 11
        np.testing.assert_array_equal(saved["params"]["w"],
                                      state.params["w"])
        np.testing.assert_array_equal(saved["params"]["b"],
                                      state.params["b"])
        assert w.replicator.stats["replicated"] == 1
        assert w.replicator.stats["errors"] == 0
    finally:
        w.close()


def test_replication_corrupt_payload_rejected_by_checksum(world2):
    faults.configure("replication.payload:corrupt:seed=11")
    state = ObjectState(params=np.arange(512.0), step=2)
    state._commit_count = 3
    state.save()
    world2.ship(state)
    faults.reset()
    assert replication.fetch_replica(1, world2.rendezvous) is None


def test_replication_coalesces_to_freshest(world2):
    state = ObjectState(params=np.zeros(4), step=0)
    for i in range(1, 6):
        state.params = state.params + 1.0
        state.step = i
        state._commit_count = i
        state.save()
        world2.replicator.submit(i, state._saved)
    assert world2.replicator.drain(10.0)
    got = replication.fetch_replica(1, world2.rendezvous)
    assert got is not None and got[0] == 5
    np.testing.assert_array_equal(got[1]["params"], np.full(4, 5.0))


def test_on_commit_disabled_is_noop():
    """With HOROVOD_REPLICATION off the commit hook costs < 1 us a call."""
    state = ObjectState(step=0)
    n = 20000
    replication.on_commit(state)  # warm the attribute lookups
    t0 = time.perf_counter()
    for _ in range(n):
        replication.on_commit(state)
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 1e-6, f"no-op on_commit costs {per_call * 1e9:.0f} ns"


def test_commit_ships_replica_end_to_end(world2, monkeypatch):
    """State.commit() -> on_commit -> replicator -> partner store, via
    the real module singleton."""
    monkeypatch.setattr(replication, "_enabled", True)
    monkeypatch.setattr(replication, "_replicator", world2.replicator)
    state = ObjectState(params=np.arange(3.0), step=0)
    state.step = 1
    state.commit()
    assert world2.replicator.drain(10.0)
    got = replication.fetch_replica(1, world2.rendezvous)
    assert got is not None and got[0] == 1
    assert got[1]["step"] == 1


# ------------------------------------------------- recovery ladder


def _stage_peer(world2, params, step, epoch):
    state = ObjectState(params=np.asarray(params, dtype=float), step=step)
    state._commit_count = epoch
    state.save()
    world2.ship(state)


def test_ladder_prefers_peer(world2, tmp_path):
    _stage_peer(world2, [1.0, 2.0], step=7, epoch=7)
    em = str(tmp_path / "e.pkl")
    older = ObjectState(params=np.array([9.0, 9.0]), step=3)
    older._commit_count = 3
    preemption.emergency_save(older, em)

    metrics.enable()
    fresh = ObjectState(params=np.zeros(2), step=0)
    rung = replication.run_recovery_ladder(
        fresh, emergency_path=em, rendezvous=world2.rendezvous, rank=1)
    assert rung == "peer"
    assert fresh.step == 7 and fresh._commit_count == 7
    snap = metrics.registry.snapshot()
    assert snap["hvd_recovery_rung_total"]["peer"] == 1.0


def test_ladder_freshness_beats_rung_order(world2, tmp_path):
    """A fresher verified emergency snapshot outranks a staler peer
    replica: the ladder picks by epoch, not blindly by rung."""
    _stage_peer(world2, [1.0, 2.0], step=4, epoch=4)
    em = str(tmp_path / "e.pkl")
    newer = ObjectState(params=np.array([5.0, 5.0]), step=9)
    newer._commit_count = 9
    preemption.emergency_save(newer, em)

    fresh = ObjectState(params=np.zeros(2), step=0)
    rung = replication.run_recovery_ladder(
        fresh, emergency_path=em, rendezvous=world2.rendezvous, rank=1)
    assert rung == "emergency"
    assert fresh.step == 9


def test_ladder_corrupt_peer_falls_to_emergency(world2, tmp_path):
    faults.configure("replication.payload:corrupt:seed=7")
    _stage_peer(world2, [1.0, 2.0], step=8, epoch=8)
    faults.reset()
    em = str(tmp_path / "e.pkl")
    older = ObjectState(params=np.array([3.0, 4.0]), step=5)
    older._commit_count = 5
    preemption.emergency_save(older, em)

    fresh = ObjectState(params=np.zeros(2), step=0)
    rung = replication.run_recovery_ladder(
        fresh, emergency_path=em, rendezvous=world2.rendezvous, rank=1)
    assert rung == "emergency"
    assert fresh.step == 5 and fresh._commit_count == 5


def test_ladder_orbax_last_resort_and_none(world2, tmp_path):
    calls = []

    def orbax_restore(state):
        calls.append(1)
        state.step = 2
        return True

    fresh = ObjectState(params=np.zeros(2), step=0)
    rung = replication.run_recovery_ladder(
        fresh, emergency_path=str(tmp_path / "missing.pkl"),
        rendezvous=world2.rendezvous, rank=1,
        orbax_restore=orbax_restore)
    assert rung == "orbax" and calls and fresh.step == 2

    metrics.enable()
    fresh2 = ObjectState(params=np.zeros(2), step=0)
    assert replication.run_recovery_ladder(
        fresh2, rendezvous=world2.rendezvous, rank=1) is None
    snap = metrics.registry.snapshot()
    assert snap["hvd_recovery_rung_total"]["none"] == 1.0
    assert fresh2.step == 0, "no source must leave the state untouched"


def test_ladder_unknown_snapshot_keys_fall_through(world2):
    """A snapshot whose attributes the state never registered is
    treated like corruption: warn and fall through, never install."""
    state = ObjectState(other_attr=1.0)
    state._commit_count = 4
    state.save()
    world2.ship(state)
    fresh = ObjectState(params=np.zeros(2), step=0)
    assert replication.run_recovery_ladder(
        fresh, rendezvous=world2.rendezvous, rank=1) is None
    assert fresh.step == 0


def test_ladder_silent_without_sources():
    """No rendezvous, no emergency path, no checkpoint: no rung
    recorded."""
    metrics.enable()
    state = ObjectState(step=0)
    assert replication.run_recovery_ladder(state) is None
    assert "hvd_recovery_rung_total" not in metrics.registry.snapshot()


# ------------------------------------- TorchState through the rungs


def _bf16_state(seed):
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16),
                                torch.nn.Linear(16, 4)).to(torch.bfloat16)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g).to(torch.bfloat16))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    state = TorchState(model=model, optimizer=opt, scale=torch.tensor(
        [1.5, -2.25], dtype=torch.bfloat16), step=0)
    x = torch.randn(3, 8, generator=g).to(torch.bfloat16)
    model(x).float().pow(2).sum().backward()
    opt.step()
    state.step = 1
    state.commit()
    return state


def _bits(state):
    out = {f"model.{k}": v.view(torch.uint8).clone()
           if v.dim() else v.reshape(1).view(torch.uint8).clone()
           for k, v in state.model.state_dict().items()}
    for i, (pid, st) in enumerate(state.optimizer.state_dict()
                                  ["state"].items()):
        for k, v in st.items():
            out[f"opt.{pid}.{k}"] = v.reshape(-1).view(torch.uint8).clone()
    out["scale"] = state.scale.view(torch.uint8).clone()
    return out


def _same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_bf16_torch_state_survives_the_peer_rung_bitwise(world2):
    src = _bf16_state(0)
    want = _bits(src)
    world2.ship(src)
    dst = _bf16_state(1)
    assert replication.run_recovery_ladder(
        dst, rendezvous=world2.rendezvous, rank=1) == "peer"
    _same_bits(_bits(dst), want)
    assert dst.step == 1 and dst._commit_count == 1
    assert all(p.dtype == torch.bfloat16 for p in dst.model.parameters())


def test_bf16_torch_state_survives_the_emergency_rung_bitwise(tmp_path):
    src = _bf16_state(0)
    want = _bits(src)
    em = str(tmp_path / "e.pkl")
    preemption.emergency_save(src, em)
    dst = _bf16_state(1)
    assert replication.run_recovery_ladder(dst, emergency_path=em) == \
        "emergency"
    _same_bits(_bits(dst), want)


def test_checkpoint_rung_restores_save_model(tmp_path):
    """checkpoint.orbax_rung over a save_model checkpoint: the model's
    parameters in place and the optimizer's state, bitwise."""
    from horovod_tpu_torch import checkpoint

    src = _bf16_state(0)
    want = _bits(src)
    checkpoint.save_model(str(tmp_path / "ck"), src.model,
                          opt_state=src.optimizer,
                          optimizer_spec=("Adam", {"lr": 1e-2}))
    dst = _bf16_state(1)
    dst.scale = src.scale.clone()
    dst.orbax_restore = checkpoint.orbax_rung(str(tmp_path / "ck"))
    assert replication.run_recovery_ladder(dst) == "orbax"
    _same_bits(_bits(dst), want)


# ----------------------------------------- KV persistence / failover


def test_kv_store_persists_and_rebinds_port(tmp_path):
    path = str(tmp_path / "kv.pkl")
    kv = KVStoreServer(state_path=path)
    port = kv.start_server()
    with kv.lock:
        kv.store.setdefault("scope", {})["key"] = b"v1"
    kv.shutdown_server()  # final flush

    kv2 = KVStoreServer(state_path=path)
    try:
        assert kv2.restored
        assert kv2.start_server() == port, "must rebind the same port"
        assert kv2.store["scope"]["key"] == b"v1"
    finally:
        kv2.shutdown_server()


def test_kv_store_flusher_persists_mutations(tmp_path):
    path = str(tmp_path / "kv.pkl")
    kv = KVStoreServer(state_path=path, flush_interval_s=0.05)
    port = kv.start_server()
    try:
        from horovod_tpu_torch.runner.http import http_client

        http_client.put("127.0.0.1", port, "s", "k", b"live")
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if os.path.exists(path):
                import pickle

                with open(path, "rb") as f:
                    snap = pickle.load(f)
                if snap["store"].get("s", {}).get("k") == b"live":
                    break
            time.sleep(0.05)
        else:
            pytest.fail("flusher never persisted the PUT")
    finally:
        kv.shutdown_server()


def test_rendezvous_round_and_assignments_survive_restart(tmp_path):
    from horovod_tpu_torch.runner.util.hosts import SlotInfo

    slots = [SlotInfo("hostA", 0, 0, 0, 2, 1, 1),
             SlotInfo("hostB", 1, 0, 0, 2, 1, 1)]
    srv = RendezvousServer(state_dir=str(tmp_path))
    port = srv.init(slots)
    srv.shutdown_server()

    srv2 = RendezvousServer(state_dir=str(tmp_path))
    try:
        srv2.start_server()
        assert srv2.port == port
        assert srv2.round == 1
        got = srv2.last_assignments()
        assert [(s.hostname, s.rank) for s in got] == [
            ("hostA", 0), ("hostB", 1)]
    finally:
        srv2.shutdown_server()


def test_rendezvous_state_file_reads_in_the_jax_server(tmp_path):
    """The port's persisted rendezvous state is the JAX server's format:
    a JAX RendezvousServer on the same directory resumes its round and
    assignments."""
    from horovod_tpu.runner.http.http_server import \
        RendezvousServer as JaxRendezvousServer
    from horovod_tpu_torch.runner.util.hosts import SlotInfo

    srv = RendezvousServer(state_dir=str(tmp_path))
    srv.init([SlotInfo("hostA", 0, 0, 0, 1, 1, 1)])
    srv.init([SlotInfo("hostB", 0, 0, 0, 1, 1, 1)])
    srv.shutdown_server()
    theirs = JaxRendezvousServer(state_dir=str(tmp_path))
    try:
        assert theirs.restored and theirs.round == 2
        assert [(s.hostname, s.rank) for s in theirs.last_assignments()] \
            == [("hostB", 0)]
    finally:
        theirs.shutdown_server()


def test_driver_resumes_persisted_assignments(tmp_path):
    from horovod_tpu_torch.runner.elastic.discovery import (FixedHosts,
                                                            HostManager)
    from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
    from horovod_tpu_torch.runner.elastic.settings import ElasticSettings
    from horovod_tpu_torch.runner.util.hosts import SlotInfo

    srv = RendezvousServer(state_dir=str(tmp_path))
    srv.init([SlotInfo("hostA", 0, 0, 0, 2, 1, 1),
              SlotInfo("hostB", 1, 0, 0, 2, 1, 1)])
    srv.shutdown_server()

    driver = ElasticDriver(
        HostManager(FixedHosts({"hostA": 1, "hostB": 1})),
        ElasticSettings(min_np=2, max_np=2, timeout_s=5.0,
                        discovery_interval_s=0.1),
        command=["true"], env={},
        rendezvous_state_dir=str(tmp_path))
    try:
        assert driver._rank_assignments == {"hostA": [0], "hostB": [1]}
    finally:
        driver.stop()


def test_workers_ride_rendezvous_outage(tmp_path):
    """wait_for_key keeps polling through a dead-then-restarted
    rendezvous (same port via the state dir) instead of dying on the
    first refused connection."""
    from horovod_tpu_torch.runner.http import http_client

    retry.set_default_policy(retry.RetryPolicy(
        max_attempts=3, base_delay_s=0.02, max_delay_s=0.05))
    try:
        srv = RendezvousServer(state_dir=str(tmp_path))
        port = srv.init([])
        srv.shutdown_server()  # outage begins; state persisted

        result = {}

        def poll():
            result["value"] = http_client.wait_for_key(
                "127.0.0.1", port, "job", "resume", timeout_s=30.0)

        t = threading.Thread(target=poll, daemon=True)
        t.start()
        time.sleep(0.5)  # the worker is now retrying into the outage
        assert t.is_alive(), "worker died during the outage"

        srv2 = RendezvousServer(state_dir=str(tmp_path))
        srv2.start_server()
        try:
            assert srv2.port == port
            http_client.put("127.0.0.1", port, "job", "resume", b"go")
            t.join(timeout=20.0)
            assert result.get("value") == b"go"
        finally:
            srv2.shutdown_server()
    finally:
        retry.set_default_policy(None)


# ------------------------------------- outage / degradation plumbing


def test_outage_logs_once_per_outage(caplog):
    log = logging.getLogger("test.outage")
    outage = retry.Outage(log, "thing")
    with caplog.at_level(logging.INFO, logger="test.outage"):
        assert outage.failure("boom") is True
        assert outage.failure("boom") is False
        assert outage.failure("boom") is False
        assert outage.success() is True
        assert outage.success() is False
        assert outage.failure("again") is True
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 2, "one warning per outage, not per attempt"


def test_retry_policy_record_metrics_flag():
    metrics.enable()
    policy = retry.RetryPolicy(
        max_attempts=3, base_delay_s=0.0, max_delay_s=0.0,
        record_metrics=False, sleep=lambda s: None)
    with pytest.raises(ConnectionError):
        policy.call(lambda: (_ for _ in ()).throw(ConnectionError()),
                    point="x")
    snap = metrics.registry.snapshot()
    assert "hvd_retries_total" not in snap
    assert "hvd_retry_giveups_total" not in snap


def test_record_recovery_rung_disabled_and_enabled():
    metrics.record_recovery_rung("peer")  # disabled: no registry touch
    assert "hvd_recovery_rung_total" not in metrics.registry.snapshot()
    metrics.enable()
    metrics.record_recovery_rung("peer")
    metrics.record_recovery_rung("peer")
    metrics.record_recovery_rung("local")
    snap = metrics.registry.snapshot()
    assert snap["hvd_recovery_rung_total"] == {"peer": 2.0, "local": 1.0}
