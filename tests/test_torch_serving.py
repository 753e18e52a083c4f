"""The PyTorch port's one-shot serving tier against the JAX package's.

* ``InferenceEngine`` restored from a checkpoint of an MLP (flax
  weights carried across by ``models/convert.py``) against the JAX
  ``InferenceEngine`` on the same inputs, at every bucket and above the
  top one (float32, within 1e-5 relative + 1e-6);
* ``parse_buckets`` and ``bucket_for`` as the JAX package answers them;
* the engine on the world's mesh (tests/test_serving.py's
  ``test_engine_on_mesh_replicated``) and the dynamic batcher's
  scenarios of tests/test_serving.py;
* the server's auth and probes, ``/healthz`` telling idle from wedged,
  the replica set's failover, revival and 429 retry, the malformed-input
  400 and request-id propagation;
* two end-to-end runs with ``--device cpu`` replica subprocesses:
  predict failover correctness under an injected replica fault, and
  SIGTERM draining an in-flight request before the exit with 83.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.mlp import MLP as JaxMLP
from horovod_tpu.serving.engine import InferenceEngine as JaxEngine
from horovod_tpu.serving.engine import parse_buckets as jax_parse_buckets
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.elastic.preemption import PREEMPTED_EXIT_CODE
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.runner.compute_service import ComputeService
from horovod_tpu_torch.runner.util.secret import make_secret_key
from horovod_tpu_torch.serving import (Draining, DynamicBatcher,
                                       InferenceEngine, QueueFull,
                                       ReplicaSet, ReplicaSupervisor,
                                       RequestTimeout, ServingServer,
                                       parse_buckets, predict_remote,
                                       tracing)
from horovod_tpu_torch.serving.engine import build_apply_fn

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
IN_DIM = 8
FEATURES = (16, 8, 4)
#: float32 engine against the JAX engine (different GEMMs on the CPU)
RTOL, ATOL = 1e-5, 1e-6
_META = {"serving": {"model": "mlp", "features": list(FEATURES),
                     "input_shape": [IN_DIM], "dtype": "float32"}}


@pytest.fixture(scope="module")
def flax_mlp():
    mod = JaxMLP(features=FEATURES)
    params = mod.init(jax.random.PRNGKey(0),
                      jnp.ones((2, IN_DIM)))["params"]
    return mod, params


@pytest.fixture(scope="module")
def ckpt(flax_mlp, tmp_path_factory):
    """A port checkpoint of the flax MLP's weights, with the serving
    metadata the replica rebuilds the model from."""
    _, params = flax_mlp
    path = str(tmp_path_factory.mktemp("serving") / "mlp")
    checkpoint.save_model(path, params_from_flax(
        jax.tree.map(np.asarray, params)), metadata=_META)
    return path


def _jax_forward(flax_mlp, x):
    mod, params = flax_mlp
    return np.asarray(mod.apply({"params": params}, np.asarray(x)))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["1,4,16,64", "16;4,4", " 8 ,2", "0,4",
                                  ""])
def test_parse_buckets_matches_jax(spec):
    try:
        want = jax_parse_buckets(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_buckets(spec)
        return
    assert parse_buckets(spec) == want


def test_bucket_for_matches_jax(flax_mlp):
    mod, params = flax_mlp
    theirs = JaxEngine(lambda p, x: mod.apply({"params": p}, x), params,
                       buckets=(1, 4, 16))
    mine = InferenceEngine(lambda p, x: x, {}, buckets=(1, 4, 16),
                           device="cpu")
    for n in (1, 2, 4, 5, 16, 17, 40):
        assert mine.bucket_for(n) == theirs.bucket_for(n), n
    assert mine.buckets == theirs.buckets


def test_engine_from_checkpoint_matches_jax_engine(flax_mlp, ckpt):
    """Inputs at each bucket, between buckets and above the top bucket
    (split into top-bucket chunks) give the JAX engine's outputs."""
    mod, params = flax_mlp
    theirs = JaxEngine(lambda p, x: mod.apply({"params": p}, x), params,
                       buckets=(1, 4, 16, 64))
    mine = InferenceEngine.from_checkpoint(ckpt, buckets=(1, 4, 16, 64),
                                           device="cpu")
    mine.warmup((IN_DIM,))
    rng = np.random.RandomState(0)
    for n in (1, 3, 4, 16, 20, 64, 100):
        x = rng.randn(n, IN_DIM).astype(np.float32)
        got = mine(x)
        assert got.shape == (n, FEATURES[-1]) and got.dtype == np.float32
        np.testing.assert_allclose(got, theirs(x), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, _jax_forward(flax_mlp, x),
                                   rtol=RTOL, atol=ATOL)
    # one step per (bucket, feature shape, dtype), as the JAX cache
    assert {k[0] for k in mine._cache} == {1, 4, 16, 64}
    assert all(k[1:] == ((IN_DIM,), "float32") for k in mine._cache)
    # a float64 request runs the float32 step instead of a duplicate
    n_before = mine.cached_executables
    y64 = mine(rng.randn(2, IN_DIM))
    assert y64.dtype == np.float32 and mine.cached_executables == n_before
    with pytest.raises(ValueError, match="declared input_shape"):
        mine(rng.randn(2, IN_DIM + 1).astype(np.float32))
    with pytest.raises(ValueError, match=r"\[n, \.\.\.\]"):
        mine(np.zeros((0, IN_DIM), np.float32))


def test_engine_pads_each_request_to_its_bucket(ckpt):
    """A request of n examples runs the bucket's step on the request
    zero-padded to the bucket: its rows are the module's forward of that
    padded batch, bitwise (the check phase 8 of chip_smoke.py makes on
    the card)."""
    from horovod_tpu_torch.models.mlp import MLP

    eng = InferenceEngine.from_checkpoint(ckpt, buckets=(4, 16),
                                          device="cpu")
    params, _ = checkpoint.load_params(ckpt, device="cpu")
    mod = MLP(IN_DIM, FEATURES)
    mod.load_state_dict(params)
    x = np.random.RandomState(1).randn(3, IN_DIM).astype(np.float32)
    padded = np.concatenate([x, np.zeros((1, IN_DIM), np.float32)])
    with torch.no_grad():
        want = mod(torch.from_numpy(padded)).numpy()[:3]
    assert np.array_equal(eng(x), want)


def test_engine_step_cache_is_an_lru_of_the_jax_size(monkeypatch):
    """One step per (bucket, feature shape, dtype) under the JAX
    package's LRU of 32; the least recently used entry is freed."""
    assert InferenceEngine.MAX_CACHED_EXECUTABLES == 32
    monkeypatch.setattr(InferenceEngine, "MAX_CACHED_EXECUTABLES", 2)
    eng = InferenceEngine(lambda p, x: x * 2, {}, buckets=(1, 4),
                          device="cpu")
    eng(np.ones((1, 3), np.float32))
    eng(np.ones((3, 3), np.float32))
    eng(np.ones((1, 3), np.float32))  # bucket 1 used last
    eng(np.ones((2, 5), np.float32))  # a new shape evicts bucket 4
    assert list(eng._cache) == [(1, (3,), "float32"),
                                (4, (5,), "float32")]
    np.testing.assert_allclose(eng(np.ones((2, 3), np.float32)),
                               np.full((2, 3), 2.0))


def test_evicted_step_takes_its_pinned_buffers(monkeypatch):
    """A step's pinned host buffers (its input's and outputs' staging on
    the card) belong to it: eviction frees them with the graph, and the
    engine's pinned bytes count only the cached steps'. On the CPU
    nothing is pinned, so the buffers are stood in by plain tensors."""
    monkeypatch.setattr(InferenceEngine, "MAX_CACHED_EXECUTABLES", 2)
    eng = InferenceEngine(lambda p, x: x * 2, {}, buckets=(1, 4),
                          device="cpu")
    assert not hasattr(eng, "_pinned") and eng.pinned_bytes == 0
    steps = []
    for n, width in ((1, 3), (3, 3), (2, 5)):
        eng(np.ones((n, width), np.float32))
        step = eng._cache[next(reversed(eng._cache))]
        step.pinned["x"] = torch.zeros(4, width)
        steps.append(step)
    assert steps[0].pinned == {}  # evicted by the third shape
    assert all(s.pinned for s in steps[1:])
    assert eng.pinned_bytes == 4 * (3 + 5) * 4
    steps[1].free()
    assert steps[1].pinned == {} and steps[1].graph is None


def test_engine_refuses_what_is_not_ported(monkeypatch, flax_mlp):
    # rules place parameters over a mesh: without one they mean nothing
    with pytest.raises(ValueError, match="mesh="):
        InferenceEngine(lambda p, x: x, {}, sharding_rules=[], device="cpu")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_CACHE", "/tmp/tune.json")
    with pytest.raises(NotImplementedError, match="entry 12"):
        InferenceEngine(lambda p, x: x, {}, device="cpu")


def test_engine_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(lambda p, x: x, {}, buckets=(1,))


def test_build_apply_fn_needs_the_input_shape():
    meta = {"serving": {"model": "mlp", "features": [4]}}
    with pytest.raises(ValueError, match="input_shape"):
        build_apply_fn(meta)
    with pytest.raises(ValueError, match="no rebuildable"):
        build_apply_fn({"serving": {"model": "resnet"}})


# ---------------------------------------------------------------------------
# batcher (tests/test_serving.py's scenarios)
# ---------------------------------------------------------------------------

def test_batcher_rejects_request_larger_than_queue_capacity():
    bat = DynamicBatcher(lambda x: x, max_batch=4, max_wait_ms=0.0,
                         queue_limit=8).start()
    try:
        with pytest.raises(ValueError, match="admission capacity"):
            bat.submit(np.zeros((9, 2), np.float32))
    finally:
        bat.close()


def test_engine_on_mesh_waits_for_entry_11(flax_mlp, ckpt):
    """Entry 11 has come: the JAX package's
    ``test_engine_on_mesh_replicated``. The parameters are placed by
    the parallel/ sharding rules over the world's mesh (the catch-all
    replicates the MLP's), the requests replicated, the numerics those
    of the JAX engine on its mesh of 8 and bitwise the engine without a
    mesh (a world of 2 x 2 over gloo is tests/test_torch_serving_mesh.py's)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu.parallel.mesh import make_mesh as jax_make_mesh

    mod, params = flax_mlp
    want = JaxEngine(lambda p, x: mod.apply({"params": p}, x), params,
                     buckets=(1, 4), mesh=jax_make_mesh())
    x = np.random.RandomState(1).randn(3, IN_DIM).astype(np.float32)
    hvd.init(device="cpu")
    try:
        eng = InferenceEngine.from_checkpoint(ckpt, buckets=(1, 4),
                                              mesh=hvd.mesh(), device="cpu")
        plain = InferenceEngine.from_checkpoint(ckpt, buckets=(1, 4),
                                                device="cpu")
        got = eng(x)
    finally:
        hvd.shutdown()
    np.testing.assert_allclose(got, want(x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _jax_forward(flax_mlp, x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got, plain(x))
    assert eng.shards.keys() == eng._params.keys()
    assert eng.resident_param_bytes == eng.shard_param_bytes


def test_batcher_coalesces_concurrent_requests():
    batches = []

    def run(x):
        batches.append(x.shape[0])
        return x * 2.0

    bat = DynamicBatcher(run, max_batch=16, max_wait_ms=150.0,
                         queue_limit=64).start()
    try:
        futs = [bat.submit(np.full((2, 3), float(i)), timeout_s=5.0)
                for i in range(4)]
        outs = [f.result(5.0) for f in futs]
        for i, y in enumerate(outs):
            np.testing.assert_allclose(y, np.full((2, 3), 2.0 * i))
        assert batches == [8]
    finally:
        bat.close()


def test_batcher_queue_full_and_draining():
    release = threading.Event()

    def run(x):
        release.wait(5.0)
        return x

    bat = DynamicBatcher(run, max_batch=4, max_wait_ms=0.0,
                         queue_limit=4).start()
    try:
        first = bat.submit(np.zeros((4, 2)), timeout_s=5.0)
        time.sleep(0.05)  # the worker picked it up and blocks in run()
        bat.submit(np.zeros((3, 2)), timeout_s=5.0)
        with pytest.raises(QueueFull):
            bat.submit(np.zeros((2, 2)), timeout_s=5.0)
        release.set()
        first.result(5.0)
    finally:
        bat.close()
    with pytest.raises(Draining):
        bat.submit(np.zeros((1, 2)))


def test_batcher_expired_request_times_out_without_wasting_a_slot():
    executed = []

    def run(x):
        executed.append(x.shape[0])
        time.sleep(0.15)
        return x

    bat = DynamicBatcher(run, max_batch=4, max_wait_ms=0.0,
                         queue_limit=16).start()
    try:
        a = bat.submit(np.zeros((1, 2)), timeout_s=5.0)
        time.sleep(0.05)  # a is executing
        b = bat.submit(np.zeros((1, 2)), timeout_s=0.01)  # expires queued
        a.result(5.0)
        with pytest.raises(RequestTimeout):
            b.result(5.0)
        time.sleep(0.1)
        assert executed == [1]  # b never reached the model
    finally:
        bat.close()


def test_batcher_isolates_incompatible_shapes():
    batches = []

    def run(x):
        batches.append((x.shape, str(x.dtype)))
        return x

    bat = DynamicBatcher(run, max_batch=16, max_wait_ms=150.0,
                         queue_limit=64).start()
    try:
        a = bat.submit(np.zeros((2, 4), np.float32), timeout_s=5.0)
        odd = bat.submit(np.zeros((1, 9), np.float32), timeout_s=5.0)
        b = bat.submit(np.zeros((3, 4), np.float32), timeout_s=5.0)
        wide = bat.submit(np.zeros((1, 4), np.float64), timeout_s=5.0)
        for f, shape in ((a, (2, 4)), (odd, (1, 9)), (b, (3, 4)),
                         (wide, (1, 4))):
            assert f.result(5.0).shape == shape
        assert sorted(batches) == [
            ((1, 4), "float64"), ((1, 9), "float32"),
            ((5, 4), "float32")], batches
    finally:
        bat.close()


def test_batcher_drain_flushes_queued_requests():
    bat = DynamicBatcher(lambda x: x + 1.0, max_batch=4,
                         max_wait_ms=5000.0, queue_limit=16).start()
    p = bat.submit(np.zeros((1, 2)), timeout_s=10.0)
    t0 = time.monotonic()
    bat.close(drain=True)
    assert time.monotonic() - t0 < 4.0  # the window collapsed
    np.testing.assert_allclose(p.result(0.1), np.ones((1, 2)))


# ---------------------------------------------------------------------------
# server + replica set (in process)
# ---------------------------------------------------------------------------

def test_server_auth_health_and_routes():
    key = b"per-job-secret"
    srv = ServingServer(lambda x, t: x + 1.0, key=key)
    port = srv.start()
    addr = f"127.0.0.1:{port}"
    try:
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        np.testing.assert_allclose(
            predict_remote(addr, x, 5.0, key=key), x + 1.0)
        # wrong auth -> 401, never reaches predict_fn
        body = json.dumps({"inputs": x.tolist()}).encode()
        req = urllib.request.Request(
            f"http://{addr}/v1/predict", data=body, method="POST",
            headers={"X-Hvd-Auth": "0" * 64})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5.0)
        assert ei.value.code == 401
        # probe routes stay open
        with urllib.request.urlopen(
                f"http://{addr}/healthz", timeout=5.0) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(
                f"http://{addr}/health", timeout=5.0) as r:
            assert json.loads(r.read()) == {"health": "off",
                                            "alerts_active": 0}
        # health on: the verdict, folded into /healthz too
        from horovod_tpu_torch import health
        health.configure(enabled_override=True, endpoint=None,
                         interval_s=60.0, capture=False)
        try:
            with urllib.request.urlopen(
                    f"http://{addr}/health", timeout=5.0) as r:
                assert json.loads(r.read()) == {
                    "health": "ok", "alerts_active": 0, "alerts": []}
            with urllib.request.urlopen(
                    f"http://{addr}/healthz", timeout=5.0) as r:
                assert json.loads(r.read())["health"] == "ok"
        finally:
            health.reset()
            from horovod_tpu_torch.utils import metrics
            metrics.reset()
        # the exposition: this process's registry, the server's own
        # request records in it
        metrics.enable()
        try:
            predict_remote(addr, x, 5.0, key=key)
            with urllib.request.urlopen(
                    f"http://{addr}/metrics", timeout=5.0) as r:
                assert "version=0.0.4" in r.headers["Content-Type"]
                text = r.read().decode()
        finally:
            metrics.reset()
        assert not metrics.lint_exposition(text)
        assert 'hvd_serving_requests_total{code="200"} 1' in text
        # no generation engine behind this server
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                f"http://{addr}/v1/generate", data=b"{}", method="POST"),
                timeout=5.0)
        assert ei.value.code == 404
        # draining -> 503 for predicts, healthz says so
        srv.draining = True
        with pytest.raises(urllib.error.HTTPError) as ei:
            predict_remote(addr, x, 5.0, key=key)
        assert ei.value.code == 503
        assert srv.drain(timeout_s=1.0)
    finally:
        srv.shutdown()


def test_healthz_status_body_distinguishes_idle_from_wedged():
    engine = InferenceEngine(lambda p, x: x * p, torch.tensor(2.0),
                             buckets=(1, 4), feature_shape=(3,),
                             device="cpu")
    batcher = DynamicBatcher(engine, max_batch=4, max_wait_ms=1.0,
                             queue_limit=16).start()
    srv = ServingServer(
        batcher.__call__,
        health_extra=lambda: {"buckets": list(engine.buckets),
                              "queued": batcher.pending,
                              "bucket_cache": engine.cached_executables})
    port = srv.start()
    try:
        x = np.ones((2, 3), dtype=np.float32)
        np.testing.assert_allclose(
            predict_remote(f"127.0.0.1:{port}", x, 5.0), x * 2.0)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=5.0) as r:
            h = json.loads(r.read())
        assert h["status"] == "ok"
        assert h["inflight"] == 0
        assert h["queued"] == 0
        assert h["buckets"] == [1, 4]
        assert h["bucket_cache"] >= 1  # the executed bucket is cached
    finally:
        srv.shutdown()
        batcher.close(drain=False)


def test_replica_set_least_loaded_failover_and_revival():
    good = ServingServer(lambda x, t: x * 3.0)
    bad = ServingServer(lambda x, t: (_ for _ in ()).throw(
        ConnectionError("replica dying")))
    gp, bp = good.start(), bad.start()
    rs = ReplicaSet({0: f"127.0.0.1:{gp}", 1: f"127.0.0.1:{bp}"})
    try:
        x = np.ones((2, 2), np.float32)
        for _ in range(6):
            np.testing.assert_allclose(rs.predict(x, 5.0), x * 3.0)
        assert 1 in rs.dead  # ejected after its 503
        assert 0 not in rs.dead
        rs.revive(1)
        assert 1 not in rs.dead
    finally:
        good.shutdown()
        bad.shutdown()


def test_replica_set_429_retries_elsewhere_without_ejecting():
    good = ServingServer(lambda x, t: x + 7.0)
    busy = ServingServer(lambda x, t: (_ for _ in ()).throw(
        QueueFull("admission queue at capacity")))
    gp, bp = good.start(), busy.start()
    rs = ReplicaSet({0: f"127.0.0.1:{gp}", 1: f"127.0.0.1:{bp}"})
    try:
        x = np.zeros((1, 2), np.float32)
        for _ in range(6):
            np.testing.assert_allclose(rs.predict(x, 5.0), x + 7.0)
        assert rs.dead == {}, rs.dead
    finally:
        good.shutdown()
        busy.shutdown()


def test_malformed_input_is_400_through_the_stack_and_never_ejects():
    bat = DynamicBatcher(lambda x: x, max_batch=4, max_wait_ms=0.0,
                         queue_limit=16).start()
    replica = ServingServer(bat.__call__)
    rp = replica.start()
    rs = ReplicaSet({0: f"127.0.0.1:{rp}"})
    front = ServingServer(rs.predict)
    fp = front.start()
    try:
        body = json.dumps({"inputs": []}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{fp}/v1/predict", data=body,
            method="POST",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10.0)
        assert ei.value.code == 400, ei.value.code
        assert rs.dead == {}, rs.dead
        x = np.ones((2, 3), np.float32)
        np.testing.assert_allclose(
            predict_remote(f"127.0.0.1:{fp}", x, 5.0), x)
    finally:
        front.shutdown()
        replica.shutdown()
        bat.close()


class _FakeReplica:
    """A spawned replica's process handle: SIGTERM makes it exit 83."""

    def __init__(self):
        self.signals = []

    def send_signal(self, sig):
        self.signals.append(sig)

    def wait(self, timeout=None):
        return PREEMPTED_EXIT_CODE if self.signals else None


def test_replica_supervisor_grows_and_drains_its_own_replicas():
    """Spawned replicas join the set; a shrink takes the newest out of
    rotation before it SIGTERMs it; replicas it did not spawn are never
    its to stop, and the last replica stays."""
    rs = ReplicaSet({0: "127.0.0.1:1"})
    handles = {}

    def spawn(idx):
        handles[idx] = _FakeReplica()
        return f"127.0.0.1:{1000 + idx}", handles[idx]

    sup = ReplicaSupervisor(spawn, rs)
    assert sup.grow() == 100 and sup.grow() == 101
    assert rs.replicas == {0: "127.0.0.1:1", 100: "127.0.0.1:1100",
                           101: "127.0.0.1:1101"}
    assert sup.shrink() == 101
    assert handles[101].signals == [signal.SIGTERM]
    assert 101 not in rs.replicas and set(sup.owned) == {100}
    sup.stop_all()
    assert rs.replicas == {0: "127.0.0.1:1"} and sup.owned == {}
    assert sup.shrink() is None
    with pytest.raises(ValueError, match="last serving replica"):
        rs.remove_replica(0)


def test_request_id_sanitization_units():
    assert tracing.sanitize("abc-123_x.Y:z") == "abc-123_x.Y:z"
    assert tracing.sanitize("réq/abc-123!!") == "rqabc-123"
    assert len(tracing.sanitize("a" * 500)) == 64
    minted = tracing.sanitize("//${}")
    assert minted and minted.isalnum()
    assert tracing.sanitize("") != tracing.sanitize("")


def test_request_id_propagates_front_door_to_replica():
    """The client's X-Request-Id travels front door -> dispatch ->
    replica -> batcher under the same (sanitized) id, and the reply
    echoes it; without a header a fresh id is minted."""
    bat = DynamicBatcher(lambda x: x * 2.0, max_batch=4, max_wait_ms=0.0,
                         queue_limit=16).start()
    seen = []

    def replica_fn(x, timeout_s):
        # the replica's handler context, and the batcher's pending
        seen.append(tracing.current_request_id())
        p = bat.submit(x, timeout_s)
        seen.append(p.req_id)
        return p.result(5.0)

    replica = ServingServer(replica_fn)
    rp = replica.start()
    rs = ReplicaSet({0: f"127.0.0.1:{rp}"})
    front = ServingServer(rs.predict)
    fp = front.start()
    try:
        x = np.ones((2, 3), np.float32)
        body = json.dumps({"inputs": x.tolist()}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{fp}/v1/predict", data=body,
            method="POST",
            headers={"Content-Type": "application/json",
                     "X-Request-Id": "träce/me-42!"})
        with urllib.request.urlopen(req, timeout=10.0) as resp:
            rid = resp.headers.get("X-Request-Id")
            payload = json.loads(resp.read())
        np.testing.assert_allclose(
            np.asarray(payload["outputs"], np.float32), x * 2.0)
        assert rid == "trceme-42"  # the sanitized client id
        assert seen == [rid, rid]
        req2 = urllib.request.Request(
            f"http://127.0.0.1:{fp}/v1/predict", data=body,
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req2, timeout=10.0) as resp:
            minted = resp.headers.get("X-Request-Id")
        assert minted and seen[-1] == minted
    finally:
        front.shutdown()
        replica.shutdown()
        bat.close()


# ---------------------------------------------------------------------------
# end to end: --device cpu replica subprocesses
# ---------------------------------------------------------------------------

def _spawn_replica(ckpt, index, svc_port, secret, extra_env=None,
                   extra_args=()):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "HOROVOD_TPU_FAULT_SPEC")}
    env.update({"PYTHONPATH": str(REPO), "HVD_TPU_SECRET_KEY": secret,
                "OMP_NUM_THREADS": "1"})
    env.update(extra_env or {})
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serving.replica_set",
         "--checkpoint", ckpt, "--index", str(index), "--device", "cpu",
         "--register", f"127.0.0.1:{svc_port}", "--buckets", "1,4,8",
         *extra_args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(REPO))


def _await_ready(proc, timeout_s=60.0):
    """Read stdout until the READY line; returns the bound port, then
    keeps draining the pipe."""
    lines, result = [], {}

    def reader():
        for line in proc.stdout:
            lines.append(line)
            if "SERVING_REPLICA_READY" in line and "port" not in result:
                result["port"] = int(line.rsplit("port=", 1)[1])

    threading.Thread(target=reader, daemon=True).start()
    deadline = time.monotonic() + timeout_s
    while "port" not in result and time.monotonic() < deadline:
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    if "port" not in result:
        proc.kill()
        raise AssertionError("replica never became ready:\n"
                             + "".join(lines))
    return result["port"]


def test_serving_e2e_failover_correctness(ckpt, flax_mlp):
    """Two registered replicas; replica 1's executor is fault-killed
    after 2 batches. Every response through the front door matches the
    JAX forward, the failed replica is ejected, zero client failures."""
    secret = make_secret_key()
    svc = ComputeService(secret)
    procs = [_spawn_replica(ckpt, 0, svc.port, secret.decode()),
             _spawn_replica(ckpt, 1, svc.port, secret.decode(),
                            extra_env={"HOROVOD_TPU_FAULT_SPEC":
                                       "serving.replica_exec:error:"
                                       "after=2"})]
    try:
        for p in procs:
            _await_ready(p)
        workers = svc._workers.get("serving", {})
        assert sorted(workers) == [0, 1], workers
        rs = ReplicaSet(workers, key=secret)
        front = ServingServer(rs.predict, key=secret)
        fport = front.start()
        try:
            rng = np.random.RandomState(7)
            for _ in range(24):
                n = int(rng.randint(1, 5))
                x = rng.randn(n, IN_DIM).astype(np.float32)
                y = predict_remote(f"127.0.0.1:{fport}", x, 10.0,
                                   key=secret)
                np.testing.assert_allclose(y, _jax_forward(flax_mlp, x),
                                           rtol=RTOL, atol=ATOL)
            assert 1 in rs.dead, rs.dead
            assert procs[0].poll() is None
        finally:
            front.shutdown()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        svc.shutdown()


def test_serving_e2e_sigterm_drains_inflight_then_exits_83(ckpt,
                                                           flax_mlp):
    """SIGTERM while a request sits in the batching window: the response
    still arrives, then the process exits with the preemption code."""
    secret = make_secret_key()
    svc = ComputeService(secret)
    proc = _spawn_replica(ckpt, 0, svc.port, secret.decode(),
                          extra_args=("--max-wait-ms", "3000"))
    try:
        port = _await_ready(proc)
        x = np.random.RandomState(5).randn(2, IN_DIM).astype(np.float32)
        got = {}

        def requester():
            try:
                got["y"] = predict_remote(f"127.0.0.1:{port}", x, 20.0,
                                          key=secret)
            except Exception as e:  # noqa: BLE001
                got["error"] = e

        t = threading.Thread(target=requester, daemon=True)
        t.start()
        time.sleep(0.4)  # admitted, sitting in the 3 s window
        assert proc.poll() is None
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=30)
        assert "error" not in got, f"drained request failed: {got}"
        np.testing.assert_allclose(got["y"], _jax_forward(flax_mlp, x),
                                   rtol=RTOL, atol=ATOL)
        assert proc.wait(timeout=30) == PREEMPTED_EXIT_CODE
        with pytest.raises((urllib.error.URLError, ConnectionError,
                            OSError)):
            predict_remote(f"127.0.0.1:{port}", x, 2.0, key=secret)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        svc.shutdown()
