"""The port's metrics registry (horovod_tpu_torch.utils.metrics) against
the JAX package's (horovod_tpu.utils.metrics):

* the same seeded sequence of record calls renders the same exposition
  text in both, histograms and labels included;
* ``lint_exposition`` gives the same verdicts on a corpus of broken
  texts, and ``merge_expositions``/``exposition(pushed)`` the same
  bytes;
* the StepStats JSONL records are equal with ``time_unix`` and
  ``step_time_s`` masked;
* the registry's semantics (counter, gauge, histogram, headers,
  re-registration, threads), the disabled path by structure (a record
  with metrics off touches no lock and leaves the registry empty), the
  standalone endpoint and the rendezvous store's ``/metrics``, the
  knobs through ``init``, the timeline bridge, exact counters against
  the collectives issued, the optimizer's reduction at worlds 1 and 2
  (world 1 records none, as the JAX package's does), and a scrape that
  stays parseable under concurrent mutation.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.utils import metrics as jmetrics
from horovod_tpu_torch.utils import flight, metrics

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    metrics.reset()
    jmetrics.reset()
    flight.reset()
    yield
    metrics.reset()
    jmetrics.reset()
    flight.reset()


def _parse_prom(text):
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, val = line.rsplit(" ", 1)
        out[key] = float(val)
    return out


_OPS = ("allreduce", "allgather", "broadcast", "reducescatter", "alltoall")
_DTYPES = ("float32", "bfloat16", "int64")
_POINTS = ("http.put", "http.get", "checkpoint.save", 'quo"te\\')
_ACTIVITIES = ("XLA_COLLECTIVE", "NEGOTIATE_ALLREDUCE", "ALLREDUCE")


def _calls(seed, n=120):
    """A seeded list of (name, args) record calls both modules take."""
    rng = np.random.RandomState(seed)
    calls = []
    for _ in range(n):
        k = rng.randint(12)
        if k == 0:
            calls.append(("record_collective", (
                _OPS[rng.randint(5)], _DTYPES[rng.randint(3)],
                int(rng.randint(1, 1 << 20)))))
        elif k == 1:
            nb = int(rng.randint(1, 5))
            calls.append(("record_fusion_plan", (
                int(rng.randint(nb, 40)), nb, 1 << 20,
                [int(rng.randint(1, 2 << 20)) for _ in range(nb)])))
        elif k == 2:
            calls.append(("record_grad_reduction", (
                int(rng.randint(1, 1 << 24)), int(rng.randint(1, 9)))))
        elif k == 3:
            logical = int(rng.randint(1, 1 << 20))
            calls.append(("record_wire_bytes", (logical, logical // 4)))
        elif k == 4:
            calls.append(("record_timeline_activity", (
                _ACTIVITIES[rng.randint(3)], float(rng.exponential(0.01)))))
        elif k == 5:
            calls.append(("record_retry", (_POINTS[rng.randint(4)],)))
        elif k == 6:
            calls.append(("record_retry_giveup", (_POINTS[rng.randint(4)],)))
        elif k == 7:
            calls.append(("record_fault", (_POINTS[rng.randint(4)],
                                           ("error", "delay")[rng.randint(2)])))
        elif k == 8:
            calls.append(("record_recovery_rung", (
                ("peer", "emergency", "local", "none")[rng.randint(4)],)))
        elif k == 9:
            calls.append(("record_elastic_event", (
                ("round", "reset", "sync", "blacklist")[rng.randint(4)],)))
        elif k == 10:
            calls.append(("record_replication", (
                int(rng.randint(1, 1 << 16)), int(rng.randint(0, 3)))))
        else:
            calls.append((("record_stall_abort", "record_replication_error",
                           "set_queue_depth")[rng.randint(3)], ()))
    return [(n, a if n != "set_queue_depth" else (len(a) + 3,))
            for n, a in calls]


def _replay(mod, calls):
    for name, args in calls:
        getattr(mod, name)(*args)


def _histograms(mod, seed):
    rng = np.random.RandomState(seed)
    h = mod.registry.histogram("t_lat", "latency", ("code",),
                               buckets=(0.001, 0.01, 0.1))
    for _ in range(50):
        h.labels(str(rng.choice([200, 404]))).observe(
            float(rng.exponential(0.02)))
    mod.registry.gauge("t_depth", "depth").set(float(rng.randn()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_record_calls_render_the_same_exposition(seed):
    for mod in (metrics, jmetrics):
        mod.enable()
        _replay(mod, _calls(seed))
        _histograms(mod, seed)
    mine, theirs = metrics.scrape(), jmetrics.scrape()
    assert mine == theirs
    assert "hvd_fusion_fill_ratio_bucket" in mine
    assert metrics.lint_exposition(mine) == []
    assert metrics.registry.snapshot() == jmetrics.registry.snapshot()


_BROKEN = [
    "t_x_total 1\n",
    "# TYPE t_x counter\nt_x 1\nt_x 2\n",
    '# TYPE t_h histogram\nt_h_bucket{le="1"} 5\nt_h_bucket{le="+Inf"} 3\n'
    "t_h_sum 1\nt_h_count 3\n",
    '# TYPE t_h2 histogram\nt_h2_bucket{le="1"} 1\nt_h2_sum 1\n'
    "t_h2_count 1\n",
    "not a sample line\n",
    "# TYPE t_y gauge\n# TYPE t_y gauge\nt_y 1\n",
    "# TYPE t_z summaryish\nt_z 1\n",
    '# TYPE t_l counter\nt_l{bad-label="1"} 1\n',
    '# TYPE t_b histogram\nt_b_bucket{code="1"} 1\n',
    "# HELP \n",
    '# TYPE t_q counter\nt_q{a="x,y",b="z"} 1\nt_q{a="x,y",b="z"} 2\n',
    "# TYPE t_n gauge\nt_n NaN\nt_n2 +Inf\n",
]


def test_lint_gives_the_jax_verdicts():
    for mod in (metrics, jmetrics):
        mod.enable()
        _replay(mod, _calls(3))
        _histograms(mod, 3)
    corpus = _BROKEN + [metrics.scrape(),
                        metrics.scrape().replace("+Inf", "9e9", 1),
                        metrics.scrape()[::-1]]
    for text in corpus:
        assert metrics.lint_exposition(text) == \
            jmetrics.lint_exposition(text), text
    assert all(metrics.lint_exposition(t) for t in _BROKEN[:5])


def test_merge_gives_the_jax_bytes():
    payloads = []
    for seed, label in ((4, ""), (5, "1"), (6, "3@podA"), (7, "10")):
        metrics.reset()
        metrics.enable()
        _replay(metrics, _calls(seed, 40))
        _histograms(metrics, seed)
        payloads.append((label, metrics.scrape()))
    assert metrics.merge_expositions(payloads) == \
        jmetrics.merge_expositions(payloads)
    pushed = {label: text.encode() for label, text in payloads[1:]}
    for mod in (metrics, jmetrics):
        mod.reset()
        mod.enable()
        _replay(mod, _calls(8, 30))
    mine, theirs = metrics.exposition(pushed), jmetrics.exposition(pushed)
    assert mine == theirs
    assert 'rank="3",pod="podA"' in mine[1].decode()
    assert metrics.lint_exposition(mine[1].decode()) == []


def _step_records(mod, path, seed):
    mod.enable()
    mod.step_stats.open_log(path)
    rng = np.random.RandomState(seed)
    calls = _calls(seed, 60)
    at = 0
    for _ in range(6):
        take = int(rng.randint(0, 20))
        with mod.step():
            _replay(mod, calls[at:at + take])
        at += take
    mod.step_stats.close_log()
    recs = [json.loads(line) for line in open(path)]
    for r in recs:
        assert r.pop("time_unix") > 0 and r.pop("step_time_s") >= 0
    return recs


@pytest.mark.parametrize("seed", [0, 1])
def test_step_records_equal_the_jax_records(seed, tmp_path):
    mine = _step_records(metrics, str(tmp_path / "mine.jsonl"), seed)
    theirs = _step_records(jmetrics, str(tmp_path / "theirs.jsonl"), seed)
    assert mine == theirs
    assert [r["step"] for r in mine] == [1, 2, 3, 4, 5, 6]
    s = _parse_prom(metrics.scrape())
    assert s["hvd_steps_total"] == 6 and s["hvd_step_seconds_count"] == 6


def test_counter_gauge_histogram_semantics():
    metrics.enable()
    reg = metrics.registry
    c = reg.counter("t_requests_total", "help text", ("code",))
    c.labels("200").inc()
    c.labels(code="200").inc(2)
    c.labels("500").inc()
    reg.gauge("t_depth", "queue depth").set(7)
    h = reg.histogram("t_lat", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 99.0):
        h.observe(v)
    text = reg.render()
    s = _parse_prom(text)
    assert s['t_requests_total{code="200"}'] == 3
    assert s['t_requests_total{code="500"}'] == 1
    assert s["t_depth"] == 7
    assert s['t_lat_bucket{le="0.1"}'] == 1
    assert s['t_lat_bucket{le="1"}'] == 2
    assert s['t_lat_bucket{le="+Inf"}'] == 3
    assert s["t_lat_count"] == 3
    assert s["t_lat_sum"] == pytest.approx(99.55)
    assert "# HELP t_requests_total help text" in text
    assert "# TYPE t_lat histogram" in text
    with pytest.raises(ValueError, match="re-registered"):
        reg.gauge("t_requests_total", "x", ("code",))
    with pytest.raises(ValueError, match="re-registered"):
        reg.counter("t_requests_total", "x", ("other",))
    with pytest.raises(ValueError, match="expects labels"):
        c.labels("200", "extra")


def test_registry_thread_safety():
    metrics.enable()
    c = metrics.registry.counter("t_mt_total", "", ("w",))
    h = metrics.registry.histogram("t_mt_lat", "")

    def work(i):
        for _ in range(1000):
            c.labels(str(i % 4)).inc()
            h.observe(0.001)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    s = _parse_prom(metrics.registry.render())
    assert sum(v for k, v in s.items() if k.startswith("t_mt_total")) == 8000
    assert s["t_mt_lat_count"] == 8000


class _RaisingLock:
    def __enter__(self):
        raise AssertionError("a disabled record took a lock")

    def __exit__(self, *exc):
        return False

    def acquire(self, *a, **k):
        raise AssertionError("a disabled record took a lock")

    release = acquire


def test_disabled_records_touch_no_lock_and_leave_nothing(monkeypatch):
    """The disabled path by structure: with metrics off, every record
    function returns before any lock (each lock it could reach raises)
    and the registry stays empty."""
    assert not metrics.enabled()
    monkeypatch.setattr(metrics.registry, "_lock", _RaisingLock())
    monkeypatch.setattr(metrics.step_stats, "_lock", _RaisingLock())
    monkeypatch.setattr(flight, "_dump_lock", _RaisingLock())
    for name, args in _calls(9, 200):
        getattr(metrics, name)(*args)
    metrics.record_batch_execution("allreduce", 3, 4096, 0.001)
    with metrics.step():
        metrics.record_collective("allreduce", "float32", 8)
    monkeypatch.undo()
    assert metrics.scrape() == ""
    assert metrics.registry.snapshot() == {}
    assert metrics.step_stats.step == 0
    assert metrics.step_stats.collectives == {}


def test_standalone_endpoint_binds_port_zero():
    metrics.enable()
    metrics.registry.counter("t_scrape_total", "x").inc(3)
    port = metrics.start_http_server(0)
    try:
        assert metrics.http_port() == port and port > 0
        assert metrics.start_http_server(0) == port  # idempotent
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
            assert r.status == 200
            assert "version=0.0.4" in r.headers["Content-Type"]
            body = r.read().decode()
        assert _parse_prom(body)["t_scrape_total"] == 3
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=5)
    finally:
        metrics.stop_http_server()
    assert metrics.http_port() is None


def test_rendezvous_store_mounts_metrics():
    from horovod_tpu_torch.runner.http import http_client
    from horovod_tpu_torch.runner.http.http_server import KVStoreServer

    metrics.enable()
    metrics.registry.counter("t_kv_total", "x").inc(7)
    srv = KVStoreServer()
    port = srv.start_server()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
            body = r.read().decode()
        assert _parse_prom(body)["t_kv_total"] == 7
        http_client.put("127.0.0.1", port, "sc", "key", b"v")
        assert http_client.get("127.0.0.1", port, "sc", "key") == b"v"
    finally:
        srv.shutdown_server()


def test_knobs_enable_metrics_and_shutdown_ends_them(tmp_path, monkeypatch):
    path = str(tmp_path / "run.jsonl")
    monkeypatch.setenv("HOROVOD_TPU_METRICS_FILE", path)
    monkeypatch.setenv("HOROVOD_METRICS_FILE", str(tmp_path / "alias.jsonl"))
    hvd.init(device="cpu")
    try:
        assert metrics.enabled()
        with hvd.metrics.step():
            hvd.allreduce(torch.ones(4))
    finally:
        hvd.shutdown()
    assert not metrics.enabled()  # configure()'s enable ends with it
    recs = [json.loads(line) for line in open(path)]
    assert recs[0]["collectives"]["allreduce/float32"] == {
        "count": 1, "bytes": 16}
    assert not (tmp_path / "alias.jsonl").exists()


def test_timeline_bridge():
    from horovod_tpu_torch.utils.timeline import Timeline, active_timeline

    tl = Timeline(None)
    tl.activity_start("t", "ALLREDUCE")
    tl.activity_end("t", "ALLREDUCE")
    assert "hvd_timeline_activity_seconds" not in metrics.scrape()
    metrics.enable()
    tl.activity_start("grad_1", "ALLREDUCE")
    time.sleep(0.002)
    tl.activity_end("grad_1", "ALLREDUCE")
    with tl.activity("grad_1", "NEGOTIATE_ALLREDUCE"):
        pass
    s = _parse_prom(metrics.scrape())
    assert s['hvd_timeline_activity_seconds_count{activity="ALLREDUCE"}'] \
        == 1
    assert s['hvd_timeline_activity_seconds_sum{activity="ALLREDUCE"}'] \
        >= 0.002
    assert s['hvd_timeline_activity_seconds_count'
             '{activity="NEGOTIATE_ALLREDUCE"}'] == 1
    metrics.disable()
    hvd.init(device="cpu")
    try:
        assert active_timeline() is None  # no trace file, metrics off
        metrics.enable()
        assert active_timeline() is not None  # the bridge needs spans
    finally:
        hvd.shutdown()


def test_counters_equal_the_collectives_issued():
    hvd.init(device="cpu")
    try:
        metrics.enable()
        before = _parse_prom(metrics.scrape())
        x = torch.ones(1024)  # 4096 B
        for _ in range(5):
            hvd.allreduce(x)
        hvd.broadcast(torch.zeros(16), root_rank=0)  # 64 B
        hvd.grouped_allreduce([torch.ones(3), torch.ones(5)])  # one concat
        hvd.allgather(torch.ones(2, 2, dtype=torch.bfloat16))
        hvd.synchronize(hvd.allreduce_async(torch.ones(2, dtype=torch.int64),
                                            op=hvd.Sum))
        after = _parse_prom(metrics.scrape())
    finally:
        hvd.shutdown()

    def delta(op, dtype, what="collectives"):
        key = f'hvd_{what}_total{{op="{op}",dtype="{dtype}"}}'
        return after.get(key, 0) - before.get(key, 0)

    assert delta("allreduce", "float32") == 6
    assert delta("allreduce", "float32", "collective_bytes") == \
        5 * 4096 + 32
    assert delta("broadcast", "float32") == 1
    assert delta("broadcast", "float32", "collective_bytes") == 64
    assert delta("allgather", "bfloat16") == 1
    assert delta("allgather", "bfloat16", "collective_bytes") == 8
    assert delta("allreduce", "int64", "collective_bytes") == 16


def _jax_world(n):
    import jax
    from jax.sharding import Mesh

    import horovod_tpu as jhvd

    jhvd.init(mesh=Mesh(np.array(jax.devices()[:n]), ("hvd",)))
    return jhvd


def _jax_step_record(n, params, tmp_path):
    """The JAX DistributedOptimizer's step record on a world of ``n``
    (the eager path: one update a step), fusion and bytes fields."""
    import jax.numpy as jnp
    import optax

    jhvd = _jax_world(n)
    try:
        jmetrics.enable()
        path = str(tmp_path / f"jax{n}.jsonl")
        jmetrics.step_stats.open_log(path)
        tree = {k: jnp.asarray(v) for k, v in params.items()}
        opt = jhvd.DistributedOptimizer(optax.sgd(0.1))
        state = opt.init(tree)
        with jmetrics.step():
            opt.update(tree, state, tree)
        jmetrics.step_stats.close_log()
    finally:
        jhvd.shutdown()
    rec = json.loads(open(path).read().splitlines()[-1])
    return {k: rec.get(k) for k in ("fusion", "grad_bytes", "wire")}


def test_world_one_records_no_reduction_as_the_jax_package(tmp_path):
    """At world 1 the JAX DistributedOptimizer neither plans nor records
    a reduction (``_reduce_grad_tree`` returns first); the port's plans
    when it is built (the fusion plan lands in the first record) and
    records no reduction either."""
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    theirs = _jax_step_record(1, params, tmp_path)
    assert theirs == {"fusion": {"plans": 0, "buckets": 0,
                                 "fill_ratio_mean": 0.0},
                      "grad_bytes": 0, "wire": None}
    hvd.init(device="cpu")
    try:
        metrics.enable()
        path = str(tmp_path / "mine.jsonl")
        metrics.step_stats.open_log(path)
        model = torch.nn.Linear(4, 3)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=[("b", model.bias), ("w", model.weight)])
        for _ in range(2):
            with metrics.step():
                model(torch.ones(2, 4)).sum().backward()
                opt.step()
                opt.zero_grad()
        metrics.step_stats.close_log()
    finally:
        hvd.shutdown()
    recs = [json.loads(line) for line in open(path)]
    assert [r["grad_bytes"] for r in recs] == [0, 0]
    assert "wire" not in recs[0]
    assert recs[0]["fusion"]["plans"] == 1 and recs[1]["fusion"]["plans"] == 0


def test_plan_records_equal_the_jax_plans():
    """The same parameters planned by both packages record the same
    fusion metrics (the threshold cut so that each block's weight fills
    a bucket of its own: four buckets)."""
    from horovod_tpu.ops.fusion import pytree_bucket_plan as jax_plan
    from horovod_tpu_torch.ops.fusion import flax_path, pytree_bucket_plan

    rng = np.random.RandomState(1)
    shapes = {"block_0.w": (64, 32), "block_1.w": (64, 32),
              "emb.table": (100, 16), "head.b": (7,)}
    for mod in (metrics, jmetrics):
        mod.enable()
    leaves = [(flax_path(k), s, torch.float32) for k, s in
              sorted(shapes.items())]
    pytree_bucket_plan(leaves, threshold_bytes=8192, backward_order=True)
    tree = {}
    for k, s in shapes.items():
        a, b = k.split(".")
        tree.setdefault(a, {})[b] = rng.randn(*s).astype(np.float32)
    hvd.init(device="cpu")  # both read the knobs' backward order
    try:
        _jax_world(1)
        jax_plan(tree, threshold_bytes=8192, backward_order=True)
    finally:
        import horovod_tpu as jhvd

        jhvd.shutdown()
        hvd.shutdown()
    keys = ("hvd_fusion_plans_total", "hvd_fusion_buckets_total",
            "hvd_fusion_tensors_total", "hvd_fusion_fill_ratio")
    mine = {k: v for k, v in metrics.registry.snapshot().items()
            if k in keys}
    theirs = {k: v for k, v in jmetrics.registry.snapshot().items()
              if k in keys}
    assert mine == theirs and mine["hvd_fusion_buckets_total"][""] == 4


def test_scrape_stays_parseable_under_concurrent_mutation():
    metrics.enable()
    stop = threading.Event()

    def mutate():
        i = 0
        c = metrics.registry.counter("t_mut_total", "m", ("w",))
        h = metrics.registry.histogram("t_mut_lat", "m")
        while not stop.is_set():
            c.labels(str(i % 7)).inc()
            h.observe((i % 100) / 1000.0)
            metrics.registry.counter(f"t_mut_{i % 13}_total", "m").inc()
            i += 1

    t = threading.Thread(target=mutate, daemon=True)
    t.start()
    try:
        deadline = time.time() + 1.0
        n = 0
        while time.time() < deadline:
            text = metrics.scrape()
            assert metrics.lint_exposition(text) == [], n
            _, body = metrics.exposition({"5": text.encode()})
            assert metrics.lint_exposition(body.decode()) == [], n
            n += 1
        assert n > 10
    finally:
        stop.set()
        t.join(timeout=5)


def test_elastic_reset_records_events():
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.core.exceptions import HorovodInternalError

    hvd.init(device="cpu")
    try:
        metrics.enable()
        calls = {"n": 0}

        @elastic.run
        def train(state):
            calls["n"] += 1
            if calls["n"] == 1:
                raise HorovodInternalError("simulated failure")
            return "done"

        assert train(elastic.ObjectState(epoch=0)) == "done"
        s = _parse_prom(metrics.scrape())
    finally:
        elastic.preemption.uninstall()
        hvd.shutdown()
    assert s['hvd_elastic_events_total{event="reset"}'] == 1
    assert s['hvd_elastic_events_total{event="sync"}'] >= 1
