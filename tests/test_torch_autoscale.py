"""The replica autoscaler (serving/replica_set.ReplicaAutoscaler) against
the JAX package's.

* the policy through ``signal_fn=`` and a fake clock, on the real
  ``ReplicaSet`` and ``ReplicaSupervisor`` with fake process handles:
  grow on sustained heat, shrink on sustained cold, hold within the
  cooldown, clamp at ``max_replicas`` and ``min_replicas``, never shrink
  a replica the supervisor did not spawn; on a seeded stream of signals
  the port's decisions, records (``hvd_serving_autoscale_events_total``,
  ``hvd_serving_replicas``) and flight kinds are the JAX package's;
* its eight knobs and their defaults are the JAX package's, read from
  the environment;
* the scrape: occupancy from each replica's ``/healthz`` ``slots{}``,
  the queue wait's deltas from ``/metrics``, equal to the JAX scrape of
  the same servers;
* end to end (scripts/decode_check.py's scenario, bounded): decode
  replicas on a tiny GPT-2 at ``device="cpu"`` behind a front door,
  eight clients saturate one replica, the autoscaler grows to two,
  the clients stop, it shrinks back and the spawned replica drains.
"""

import collections
import signal
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu.core.knobs import Knobs as JaxKnobs
from horovod_tpu.serving import replica_set as jrs
from horovod_tpu.utils import flight as jflight
from horovod_tpu.utils import metrics as jmetrics
from horovod_tpu_torch.core.knobs import Knobs
from horovod_tpu_torch.serving import (ReplicaAutoscaler, ReplicaSet,
                                       ReplicaSupervisor, ServingServer)
from horovod_tpu_torch.utils import flight, metrics

torch.set_num_threads(1)

_KNOBS = ("serving_autoscale_interval_s", "serving_autoscale_hi_occupancy",
          "serving_autoscale_lo_occupancy", "serving_autoscale_queue_wait_s",
          "serving_autoscale_min_replicas", "serving_autoscale_max_replicas",
          "serving_autoscale_sustain", "serving_autoscale_cooldown_s")


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (metrics, jmetrics, flight, jflight):
        mod.reset()
    yield
    for mod in (metrics, jmetrics, flight, jflight):
        mod.reset()


class _Handle:
    """A spawned replica's process handle: SIGTERM drains it, and it
    exits with the preemption code."""

    def __init__(self):
        self.signals = []

    def send_signal(self, sig):
        self.signals.append(sig)

    def wait(self, timeout=None):
        return 83


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _scaler(pkg, signals, clock, **kw):
    """An autoscaler of ``pkg`` over a set of one replica, fed
    ``signals`` one a poll."""
    rs_cls, sup_cls, scaler_cls = (
        (jrs.ReplicaSet, jrs.ReplicaSupervisor, jrs.ReplicaAutoscaler)
        if pkg == "jax" else (ReplicaSet, ReplicaSupervisor,
                              ReplicaAutoscaler))
    rs = rs_cls({0: "127.0.0.1:1"})
    handles = {}

    def spawn(idx):
        handles[idx] = _Handle()
        return f"127.0.0.1:{1000 + idx}", handles[idx]

    sup = sup_cls(spawn, rs)
    feed = iter(signals)
    scaler = scaler_cls(sup, rs, signal_fn=lambda: next(feed), clock=clock,
                        **kw)
    return scaler, rs, sup, handles


_POLICY = dict(min_replicas=1, max_replicas=3, hi_occupancy=0.85,
               lo_occupancy=0.25, queue_wait_hi_s=0.5, sustain=2,
               cooldown_s=10.0)
HOT = {"occupancy": 0.9, "queued": 0, "queue_wait_s": 0.0}
COLD = {"occupancy": 0.1, "queued": 0, "queue_wait_s": 0.0}
WARM = {"occupancy": 0.5, "queued": 0, "queue_wait_s": 0.0}
#: heat by the queue alone: prefills waiting past the wait limit
QUEUED = {"occupancy": 0.5, "queued": 2, "queue_wait_s": 0.8}


def _run(scaler, clock, n, dt=1.0):
    out = []
    for _ in range(n):
        out.append(scaler.poll_once())
        clock.now += dt
    return out


def test_grows_on_sustained_heat_and_holds_through_the_cooldown():
    clock = _Clock()
    scaler, rs, sup, _ = _scaler("port", [HOT] * 8, clock, **_POLICY)
    got = _run(scaler, clock, 8, dt=2.0)
    # the 2nd hot poll grows; the cooldown (10 s) holds 4 more polls;
    # the streak rebuilds and the 7th grows again
    assert got == [None, "grow", None, None, None, None, "grow", None]
    assert len(rs.replicas) == 3 and sorted(sup.owned) == [100, 101]
    assert [a for _, a in scaler.decisions] == ["grow", "grow"]


def test_heat_from_the_queue_alone_grows():
    clock = _Clock()
    scaler, rs, _, _ = _scaler("port", [QUEUED, QUEUED], clock, **_POLICY)
    assert _run(scaler, clock, 2) == [None, "grow"]
    assert len(rs.replicas) == 2


def test_clamps_at_max_and_min_replicas():
    clock = _Clock()
    scaler, rs, sup, _ = _scaler(
        "port", [HOT] * 30, clock, **dict(_POLICY, cooldown_s=0.0))
    got = _run(scaler, clock, 30)
    assert got.count("grow") == 2 and len(rs.replicas) == 3  # max 3
    clock = _Clock()
    scaler, rs, sup, handles = _scaler(
        "port", [HOT, HOT] + [COLD] * 10, clock,
        **dict(_POLICY, cooldown_s=0.0))
    got = _run(scaler, clock, 12)
    assert got.count("grow") == 1 and got.count("shrink") == 1
    # back at min 1: the set's own replica is never the supervisor's
    assert len(rs.replicas) == 1 and not sup.owned
    assert handles[100].signals == [signal.SIGTERM]


def test_shrink_needs_a_replica_the_supervisor_owns():
    clock = _Clock()
    scaler, rs, sup, _ = _scaler(
        "port", [COLD] * 6, clock, **dict(_POLICY, min_replicas=0))
    assert _run(scaler, clock, 6) == [None] * 6
    assert len(rs.replicas) == 1


def _seeded_signals(seed, n=60):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        kind = rng.randint(4)
        out.append((HOT, COLD, WARM, QUEUED)[kind])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decisions_and_records_are_the_jax_autoscalers(seed):
    sigs = _seeded_signals(seed)
    got = {}
    for pkg, mod_m, mod_f in (("jax", jmetrics, jflight),
                              ("port", metrics, flight)):
        mod_f.configure(enabled_override=True, rank=0, handlers=False)
        mod_m.enable()
        clock = _Clock()
        scaler, rs, sup, _ = _scaler(pkg, sigs, clock,
                                     **dict(_POLICY, cooldown_s=3.0))
        decisions = _run(scaler, clock, len(sigs), dt=1.0)
        got[pkg] = (decisions, sorted(rs.replicas), mod_m.scrape(),
                    collections.Counter(e[3] for e in mod_f.snapshot()))
    assert got["port"] == got["jax"]
    assert "grow" in got["port"][0]
    assert "hvd_serving_autoscale_events_total" in got["port"][2]


def test_knobs_are_the_jax_packages(monkeypatch):
    for name in _KNOBS:
        assert getattr(Knobs(), name) == getattr(JaxKnobs(), name), name
    env = {"SERVING_AUTOSCALE_INTERVAL_S": "0.5",
           "SERVING_AUTOSCALE_HI_OCCUPANCY": "0.7",
           "SERVING_AUTOSCALE_LO_OCCUPANCY": "0.2",
           "SERVING_AUTOSCALE_QUEUE_WAIT_S": "0.05",
           "SERVING_AUTOSCALE_MIN_REPLICAS": "2",
           "SERVING_AUTOSCALE_MAX_REPLICAS": "6",
           "SERVING_AUTOSCALE_SUSTAIN": "3",
           "SERVING_AUTOSCALE_COOLDOWN_S": "4.5"}
    for k, v in env.items():
        monkeypatch.setenv("HOROVOD_" + k, v)
    mine, theirs = Knobs.from_env(), JaxKnobs.from_env()
    for name in _KNOBS:
        assert getattr(mine, name) == getattr(theirs, name), name
    scaler = ReplicaAutoscaler(ReplicaSupervisor(None, None),
                               ReplicaSet({0: "127.0.0.1:1"}))
    assert (scaler.min_replicas, scaler.max_replicas, scaler.sustain,
            scaler.hi_occupancy, scaler.lo_occupancy,
            scaler.queue_wait_hi_s, scaler.cooldown_s) == (
        2, 6, 3, 0.7, 0.2, 0.05, 4.5)


def test_scrape_reads_healthz_slots_and_queue_wait_deltas():
    """Two replicas' ``/healthz`` slots and ``/metrics`` queue wait (this
    process's registry, behind both servers), read by the port's and the
    JAX package's scrape: the same signals."""
    metrics.enable()
    slots = ({"total": 4, "occupied": 3, "queued_prefills": 1},
             {"total": 4, "occupied": 1, "queued_prefills": 0})
    servers = [ServingServer(lambda x, t: x,
                             health_extra=lambda s=s: {"slots": s})
               for s in slots]
    addrs = {i: f"127.0.0.1:{srv.start()}" for i, srv in enumerate(servers)}
    try:
        mine = ReplicaAutoscaler(ReplicaSupervisor(None, None),
                                 ReplicaSet(addrs))
        theirs = jrs.ReplicaAutoscaler(jrs.ReplicaSupervisor(None, None),
                                       jrs.ReplicaSet(addrs))
        metrics.record_serving_queue_wait(0.5)
        metrics.record_serving_queue_wait(0.25, slo="interactive")
        first = mine._scrape_signals()
        assert first == theirs._scrape_signals()
        assert first == {"occupancy": 0.5, "queued": 1,
                         "queue_wait_s": 0.375}
        metrics.record_serving_queue_wait(1.0)
        second = mine._scrape_signals()
        assert second == theirs._scrape_signals()
        assert second["queue_wait_s"] == 1.0  # the delta alone
    finally:
        for srv in servers:
            srv.shutdown()


# ---------------------------------------------------------------------------
# end to end: in-process decode replicas, bounded
# ---------------------------------------------------------------------------

VOCAB = 61
_CFG = dict(vocab_size=VOCAB, num_layers=1, num_heads=2, hidden_size=16,
            max_seq_len=32)


class _Replica:
    """A decode replica in this process: an engine, its scheduler and a
    server, with the preemption contract behind ``send_signal``."""

    def __init__(self, state):
        from horovod_tpu_torch.models.transformer import (Transformer,
                                                          TransformerConfig)
        from horovod_tpu_torch.serving import GenerationEngine
        from horovod_tpu_torch.serving.scheduler import DecodeScheduler

        model = Transformer(TransformerConfig(dtype=torch.float32, **_CFG))
        eng = GenerationEngine(model, state, slots=2, max_len=24,
                               prefill_buckets=(8,), kv_dtype="fp32",
                               device="cpu")
        eng.warmup()
        self.sched = DecodeScheduler(eng, queue_limit=16,
                                     default_timeout_s=60.0,
                                     stats_every=0).start()

        def generate(req, timeout_s, _s=self.sched):
            return _s.submit(req["prompt"],
                             max_new_tokens=req.get("max_new_tokens"),
                             timeout_s=timeout_s).stream(timeout_s=60.0)

        self.server = ServingServer(
            generate_fn=generate,
            health_extra=lambda: {"slots": self.sched.slot_stats()})
        self.addr = f"127.0.0.1:{self.server.start()}"

    def send_signal(self, sig):
        assert sig == signal.SIGTERM
        self.server.draining = True
        self.sched.close(drain=True, timeout_s=30.0)
        self.server.drain(timeout_s=30.0)

    def wait(self, timeout=None):
        self.server.shutdown()
        return 83


def test_grows_under_load_and_shrinks_after_it_end_to_end():
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.serving import generate_remote

    metrics.enable()
    model = Transformer(TransformerConfig(dtype=torch.float32, **_CFG))
    model.init_params(torch.Generator().manual_seed(0))
    state = model.state_dict()
    first = _Replica(state)
    replicas = [first]
    rs = ReplicaSet({0: first.addr}, default_timeout_s=60.0)
    front = ServingServer(generate_fn=rs.generate)
    faddr = f"127.0.0.1:{front.start()}"

    def spawn(idx):
        r = _Replica(state)
        replicas.append(r)
        return r.addr, r

    sup = ReplicaSupervisor(spawn, rs)
    scaler = ReplicaAutoscaler(
        sup, rs, min_replicas=1, max_replicas=2, hi_occupancy=0.85,
        lo_occupancy=0.25, queue_wait_hi_s=0.02, sustain=2, cooldown_s=0.5)
    stop, errors, done = threading.Event(), [], [0]

    def client(seed):
        rng = np.random.RandomState(seed)
        while not stop.is_set():
            prompt = rng.randint(1, VOCAB, int(rng.randint(3, 8))).tolist()
            try:
                toks, _ = generate_remote(
                    faddr, {"prompt": prompt, "max_new_tokens": 12},
                    timeout_s=60.0)
                assert toks
                done[0] += 1
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{type(e).__name__}: {e}")
                return

    clients = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(8)]
    for c in clients:
        c.start()
    try:
        deadline = time.monotonic() + 15.0
        grew = False
        while time.monotonic() < deadline and not grew:
            grew = scaler.poll_once() == "grow"
            time.sleep(0.1)
        assert grew and len(rs.replicas) == 2, scaler.decisions
        time.sleep(0.5)
        stop.set()
        for c in clients:
            c.join(timeout=30.0)
        assert not any(c.is_alive() for c in clients)
        deadline = time.monotonic() + 15.0
        shrank = False
        while time.monotonic() < deadline and not shrank:
            shrank = scaler.poll_once() == "shrink"
            time.sleep(0.1)
        assert shrank and len(rs.replicas) == 1, scaler.decisions
    finally:
        stop.set()
        front.shutdown()
        for r in replicas:
            if not r.server.draining:
                r.send_signal(signal.SIGTERM)
                r.wait()
    assert not errors, errors[:3]
    assert done[0] > 0
    snap = metrics.registry.snapshot()
    assert snap["hvd_serving_autoscale_events_total"] == {"grow": 1.0,
                                                          "shrink": 1.0}
    assert snap["hvd_serving_replicas"][""] == 1.0
    # the spawned replica left rotation, then drained
    assert replicas[1].server.draining and 100 not in rs.replicas
