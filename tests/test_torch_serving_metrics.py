"""The serving tier's telemetry against the JAX package's.

* a request's ``X-Request-Id`` through the tiers (front door -> dispatch
  -> replica -> batcher, tests/test_serving.py's scenario) run in both
  packages: the same flight kinds, counts and ids, the same timeline
  spans, and the same metric families, label sets and counts;
* the decode scheduler on a tiny GPT-2 at ``device="cpu"`` against the
  JAX scheduler on the same weights, prompts, SLO classes and clock:
  the same tokens, evictions, slots, prefills, graphs built, queue
  waits and TTFTs (bucket for bucket: the clock is the test's) and TPOT
  counts by class, the same flight kinds and ``decode`` stat events;
* the records go around a step's replay, never inside it: a step
  replayed k times records k iterations and one build, and the step
  function itself records nothing;
* with metrics off every serving record site touches no lock and the
  registry stays empty (the disabled path, by structure);
* ``GET /metrics`` on a ``ServingServer`` answers the exposition, and
  ``serve_replica`` turns metrics on.
"""

import collections
import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.models.transformer import Transformer as JaxTransformer
from horovod_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from horovod_tpu.serving import DynamicBatcher as JaxBatcher
from horovod_tpu.serving import ReplicaSet as JaxReplicaSet
from horovod_tpu.serving import ServingServer as JaxServer
from horovod_tpu.serving import tracing as jtracing
from horovod_tpu.serving.decode import GenerationEngine as JaxEngine
from horovod_tpu.serving.scheduler import DecodeScheduler as JaxScheduler
from horovod_tpu.utils import flight as jflight
from horovod_tpu.utils import metrics as jmetrics
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)
from horovod_tpu_torch.serving import (DynamicBatcher, GenerationEngine,
                                       ReplicaSet, ServingServer, engine,
                                       tracing)
from horovod_tpu_torch.serving.scheduler import DecodeScheduler
from horovod_tpu_torch.utils import flight, metrics

torch.set_num_threads(1)

VOCAB = 61
_CFG = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, hidden_size=16,
            max_seq_len=32)
_ENGINE = dict(slots=2, max_len=24, prefill_buckets=(8, 16))
#: (prompt length, max new tokens, SLO class) of the scheduler scenario
_REQUESTS = ((5, 4, "interactive"), (9, 6, "standard"), (3, 3, "batch"),
             (12, 5, "standard"))


@pytest.fixture(autouse=True)
def _fresh():
    """Both packages' telemetry off and empty around each test, and
    their timelines as they were (``start_timeline`` outside ``init()``
    leaves one in the global state)."""
    from horovod_tpu.core.state import global_state as jax_state
    from horovod_tpu_torch.core.state import global_state

    saved = global_state().timeline, jax_state().timeline
    for mod in (metrics, jmetrics, flight, jflight):
        mod.reset()
    yield
    for mod in (metrics, jmetrics, flight, jflight):
        mod.reset()
    global_state().timeline, jax_state().timeline = saved


def _families(text):
    """Exposition -> {family: (type, {(sample, labels): value})}."""
    types, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            name, kind = line[7:].split(" ", 1)
            types[name] = kind
            out[name] = (kind, {})
        elif line and not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            name, _, labels = key.partition("{")
            fam = name if name in out else name.rsplit("_", 1)[0]
            out[fam][1][(name, labels.rstrip("}"))] = float(val)
    return out


def _same_families(jtext, ttext, exact=(), timed=()):
    """Both expositions name the same families with the same types and
    label sets; counters and gauges agree on their values, histograms
    on their counts, and ``exact`` histograms bucket for bucket;
    ``timed`` gauges only exist."""
    j, t = _families(jtext), _families(ttext)
    assert sorted(t) == sorted(j)
    for name, (kind, samples) in j.items():
        tkind, tsamples = t[name]
        assert tkind == kind and sorted(tsamples) == sorted(samples), name
        if name in timed:
            continue
        for key, v in samples.items():
            if (kind != "histogram" or key[0].endswith("_count")
                    or name in exact):
                assert tsamples[key] == v, (name, key)


# ---------------------------------------------------------------------------
# X-Request-Id through the tiers
# ---------------------------------------------------------------------------

def _tiers(server_cls, batcher_cls, set_cls, mod_metrics, mod_flight,
           start_timeline, stop_timeline, path):
    """tests/test_serving.py's scenario: a batcher behind a replica
    server, a front door dispatching to it; one request with a client id,
    one without. Returns (exposition, flight events, timeline events,
    the echoed ids)."""
    mod_flight.configure(enabled_override=True, rank=0, handlers=False)
    mod_metrics.enable()
    start_timeline(path)
    bat = batcher_cls(lambda x: x * 2.0, max_batch=4, max_wait_ms=0.0,
                      queue_limit=16).start()
    replica = server_cls(bat.__call__)
    rp = replica.start()
    front = server_cls(set_cls({0: f"127.0.0.1:{rp}"}))
    fp = front.start()
    ids = []
    try:
        x = np.ones((2, 3), np.float32)
        body = json.dumps({"inputs": x.tolist()}).encode()
        for headers in ({"X-Request-Id": "träce/me-42!"}, {}):
            req = urllib.request.Request(
                f"http://127.0.0.1:{fp}/v1/predict", data=body,
                method="POST",
                headers={"Content-Type": "application/json", **headers})
            with urllib.request.urlopen(req, timeout=10.0) as resp:
                ids.append(resp.headers.get("X-Request-Id"))
                out = json.loads(resp.read())["outputs"]
            np.testing.assert_allclose(np.asarray(out, np.float32), x * 2)
    finally:
        front.shutdown()
        replica.shutdown()
        bat.close()
        stop_timeline()
    text = mod_metrics.scrape()
    events = mod_flight.snapshot()
    with open(path) as f:
        spans = json.load(f)
    return text, events, spans, ids


def test_request_id_through_the_tiers_is_the_jax_packages(tmp_path):
    got = {}
    for name, args in (
            ("jax", (JaxServer, JaxBatcher, JaxReplicaSet, jmetrics,
                     jflight, jhvd.start_timeline, jhvd.stop_timeline)),
            ("port", (ServingServer, DynamicBatcher, ReplicaSet, metrics,
                      flight, hvd.start_timeline, hvd.stop_timeline))):
        got[name] = _tiers(*args, str(tmp_path / f"{name}.json"))
    (jtext, jev, jspans, jids), (ttext, tev, tspans, tids) = \
        got["jax"], got["port"]
    assert tids[0] == jids[0] == "trceme-42"
    assert tids[1] and tids[1] != tids[0]
    # the same flight kinds, each as often
    assert collections.Counter(e[3] for e in tev) \
        == collections.Counter(e[3] for e in jev)
    rid = tids[0]
    reqs = [e for e in tev if e[3] == "serving_request" and e[4] == rid]
    assert len(reqs) == 2 and all(e[5]["code"] == 200 for e in reqs)
    disp = [e for e in tev if e[3] == "serving_dispatch"]
    assert [e[5]["req"] for e in disp] == tids
    batches = [e for e in tev if e[3] == "serving_batch"]
    assert [e[5]["ids"] for e in batches] == [[t] for t in tids]
    # the same timeline spans: SERVING_REQUEST a tier a request,
    # SERVING_EXEC a batch
    assert collections.Counter((e["ph"], e["name"]) for e in tspans) \
        == collections.Counter((e["ph"], e["name"]) for e in jspans)
    assert collections.Counter(e["name"] for e in tspans
                               if e["ph"] == "B") == {
        "SERVING_REQUEST": 4, "SERVING_EXEC": 2}
    _same_families(jtext, ttext)
    fams = _families(ttext)
    assert fams["hvd_serving_requests_total"][1] == {
        ("hvd_serving_requests_total", 'code="200"'): 4.0}
    assert fams["hvd_serving_inflight"][1] == {
        ("hvd_serving_inflight", 'replica=""'): 0.0,
        ("hvd_serving_inflight", 'replica="0"'): 0.0}


# ---------------------------------------------------------------------------
# the decode scheduler against the JAX scheduler
# ---------------------------------------------------------------------------

class _Clock:
    """Moved by the test between iterations, never by a read: both
    schedulers see the same times however often they read it."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.fixture(scope="module")
def flax_lm():
    mod = JaxTransformer(JaxTransformerConfig(dtype=jnp.float32, **_CFG))
    params = mod.init(jax.random.PRNGKey(0),
                      jnp.ones((1, 4), jnp.int32))["params"]
    return mod, params


def _prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(1, VOCAB, n).tolist() for n, _, _ in _REQUESTS]


def _schedule(make_engine, sched_cls, mod_metrics, mod_flight, mod_tracing,
              log_path):
    mod_flight.configure(enabled_override=True, rank=0, handlers=False)
    mod_metrics.enable()
    mod_metrics.step_stats.open_log(log_path)
    eng = make_engine()
    eng.warmup()
    clock = _Clock()
    sched = sched_cls(eng, queue_limit=16, default_timeout_s=1000.0,
                      stats_every=2, clock=clock)
    reqs = []
    for i, (prompt, (_, max_new, slo)) in enumerate(zip(_prompts(),
                                                        _REQUESTS)):
        token = mod_tracing.set_request_id(f"req-{i}")
        try:
            reqs.append(sched.submit(prompt, max_new_tokens=max_new,
                                     slo=slo))
        finally:
            mod_tracing.reset_request_id(token)
        clock.now += 0.25
    for _ in range(100):
        if all(r.done for r in reqs):
            break
        clock.now += 0.5
        sched.step_once()
    mod_metrics.step_stats.close_log()
    with open(log_path) as f:
        events = [json.loads(line)["decode"] for line in f]
    return ([r.result(0)[0] for r in reqs], mod_metrics.scrape(),
            collections.Counter(e[3] for e in mod_flight.snapshot()),
            events, {"iterations": sched._iterations,
                     "tokens": sched._tokens_out,
                     "evictions": dict(sched._evictions)})


def test_scheduler_records_are_the_jax_schedulers(flax_lm, tmp_path):
    mod, params = flax_lm

    def jax_engine():
        return JaxEngine(mod, params, kv_dtype="fp32", **_ENGINE)

    def port_engine():
        model = Transformer(TransformerConfig(dtype=torch.float32, **_CFG))
        return GenerationEngine(
            model, params_from_flax(jax.tree.map(np.asarray, params)),
            kv_dtype="fp32", device="cpu", **_ENGINE)

    jtok, jtext, jflights, jevents, jstats = _schedule(
        jax_engine, JaxScheduler, jmetrics, jflight, jtracing,
        str(tmp_path / "jax.jsonl"))
    ttok, ttext, tflights, tevents, tstats = _schedule(
        port_engine, DecodeScheduler, metrics, flight, tracing,
        str(tmp_path / "port.jsonl"))
    assert ttok == jtok
    assert [len(t) for t in ttok] == [m for _, m, _ in _REQUESTS]
    assert tstats == jstats
    # the step stat events, every 2 iterations
    assert tevents == jevents and len(tevents) == jstats["iterations"] // 2
    assert tflights == jflights
    assert tflights["decode_admit"] == tflights["decode_finish"] == 4
    # the clock is the test's: queue wait and TTFT bucket for bucket;
    # the engines' own timings by count
    _same_families(jtext, ttext,
                   exact=("hvd_serving_queue_wait_seconds",
                          "hvd_serving_ttft_seconds"))
    fams = _families(ttext)
    tpot = fams["hvd_serving_tpot_seconds"][1]
    # a sequence's tokens after its first, under its class
    for slo in ("interactive", "standard", "batch"):
        want = sum(m - 1 for _, m, s in _REQUESTS if s == slo)
        assert tpot[("hvd_serving_tpot_seconds_count",
                     f'slo="{slo}"')] == want, slo
    assert fams["hvd_serving_decode_tokens_total"][1][
        ("hvd_serving_decode_tokens_total", "")] == sum(
            m for _, m, _ in _REQUESTS)
    assert fams["hvd_serving_compiles_total"][1] == {
        ("hvd_serving_compiles_total", 'bucket="2"'): 1.0,
        ("hvd_serving_compiles_total", 'bucket="8"'): 1.0,
        ("hvd_serving_compiles_total", 'bucket="16"'): 1.0}


# ---------------------------------------------------------------------------
# around the replay, never inside it
# ---------------------------------------------------------------------------

class _FakeGraph:
    """A stand-in CUDA graph: its replay reruns the step (the CPU has no
    graphs), as a real replay relaunches the captured kernels."""

    def __init__(self, step):
        self.step, self.replays = step, 0

    def replay(self):
        self.replays += 1
        self.step.outputs = self.step.fn()

    def reset(self):
        pass


def test_a_replayed_step_records_once_a_call_and_its_build_once(
        flax_lm, monkeypatch):
    mod, params = flax_lm
    model = Transformer(TransformerConfig(dtype=torch.float32, **_CFG))
    eng = GenerationEngine(
        model, params_from_flax(jax.tree.map(np.asarray, params)),
        kv_dtype="fp32", device="cpu", **_ENGINE)

    def fake_capture(step, stream, pool=None):
        outputs = step.fn()
        step.graph = _FakeGraph(step)
        step.outputs = outputs
        step.capture_s = 0.125
        return outputs

    monkeypatch.setattr(engine, "capture_step", fake_capture)
    eng._stream = object()  # take the card's path: capture, then replays
    metrics.enable()
    k = 5
    toks = np.zeros(eng.slots, np.int32)
    lens = np.full(eng.slots, 3, np.int32)
    for _ in range(k):
        eng.decode(toks, lens, slos=["interactive", "batch"])
    step = eng.graphs[("decode", 2, 24, False)]
    assert step.graph.replays == k - 1
    snap = metrics.registry.snapshot()
    assert snap["hvd_serving_decode_iterations_total"][""] == k
    assert snap["hvd_serving_tpot_seconds"]["interactive"]["count"] == k
    assert snap["hvd_serving_tpot_seconds"]["batch"]["count"] == k
    assert snap["hvd_serving_compiles_total"] == {"2": 1.0}
    assert snap["hvd_serving_compile_seconds"][""] == {"count": 1,
                                                         "sum": 0.125}
    # the captured function itself records nothing
    before = metrics.scrape()
    for _ in range(3):
        step.fn()
    assert metrics.scrape() == before


# ---------------------------------------------------------------------------
# the disabled path, and the routes
# ---------------------------------------------------------------------------

class _RaisingLock:
    def __enter__(self):
        raise AssertionError("a disabled record took a lock")

    def __exit__(self, *exc):
        return False

    def acquire(self, *a, **k):
        raise AssertionError("a disabled record took a lock")

    release = acquire


def test_disabled_serving_records_touch_no_lock(flax_lm, monkeypatch):
    mod, params = flax_lm
    model = Transformer(TransformerConfig(dtype=torch.float32, **_CFG))
    eng = GenerationEngine(
        model, params_from_flax(jax.tree.map(np.asarray, params)),
        kv_dtype="fp32", device="cpu", **_ENGINE)
    sched = DecodeScheduler(eng, queue_limit=4, default_timeout_s=100.0,
                            stats_every=1, clock=_Clock())
    assert not metrics.enabled()
    monkeypatch.setattr(metrics.registry, "_lock", _RaisingLock())
    monkeypatch.setattr(metrics.step_stats, "_lock", _RaisingLock())
    r = sched.submit([3, 4, 5], max_new_tokens=3, slo="interactive")
    while not r.done:
        sched.step_once()
    bat = DynamicBatcher(lambda x: x + 1.0, max_batch=4, max_wait_ms=0.0,
                         queue_limit=8).start()
    srv = ServingServer(bat.__call__)
    port = srv.start()
    try:
        body = json.dumps({"inputs": [[1.0, 2.0]]}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/predict", data=body,
                method="POST"), timeout=10.0) as resp:
            assert json.loads(resp.read())["outputs"] == [[2.0, 3.0]]
    finally:
        srv.shutdown()
        bat.close()
    rs = ReplicaSet({0: "127.0.0.1:1", 1: "127.0.0.1:2"})
    rs.remove_replica(1)
    rs.add_replica(1, "127.0.0.1:2")
    monkeypatch.undo()
    assert metrics.registry.snapshot() == {}
    assert metrics.scrape() == ""


def test_metrics_route_and_serve_replica_enable(monkeypatch):
    """``GET /metrics`` answers the exposition (lint clean); the replica
    process's entry turns metrics on before it serves."""
    from horovod_tpu_torch.serving import replica_set

    metrics.enable()
    srv = ServingServer(lambda x, t: x)
    port = srv.start()
    try:
        body = json.dumps({"inputs": [[1.0]]}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/predict", data=body,
                method="POST"), timeout=10.0):
            pass
        # the handler leaves the in-flight window after its reply is
        # written, so the client may read the reply first
        deadline = time.monotonic() + 5.0
        while srv.health()["inflight"] and time.monotonic() < deadline:
            time.sleep(0.01)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5.0) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == metrics.PROM_CONTENT_TYPE
            text = r.read().decode()
    finally:
        srv.shutdown()
    assert not metrics.lint_exposition(text)
    assert 'hvd_serving_inflight{replica=""} 0' in text
    assert 'hvd_serving_requests_total{code="200"} 1' in text
    metrics.reset()

    class _Stop(Exception):
        pass

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(replica_set.faults, "configure", stop)
    with pytest.raises(_Stop):
        replica_set.serve_replica(["--registry"])
    assert metrics.enabled()
