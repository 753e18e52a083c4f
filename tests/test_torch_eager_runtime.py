"""The port's eager runtime (``horovod_tpu_torch/ops/eager_runtime.py``)
in a single process: the scenarios of the JAX package's
``tests/test_eager_runtime.py`` and ``tests/test_eager_fastpath.py``
(the steady-state plan cache bitwise equal to the negotiated path; its
invalidation by a shape change, a new tensor, process-set churn or a
join; the fault veto), and the port's ``LoopbackExecutor`` held against
the JAX one on the same numpy inputs from a seed: bitwise for float32,
and for the int8 wire's reduced value and error-feedback residual.
"""

import multiprocessing as mp
import socket

import numpy as np
import pytest
import torch

import horovod_tpu_torch._native as port_native
from horovod_tpu_torch._native import (OP_ALLGATHER, OP_ALLREDUCE,
                                       OP_ALLTOALL, OP_BROADCAST,
                                       OP_REDUCESCATTER, ExecutionBatch)
from horovod_tpu_torch.core.exceptions import HorovodInternalError
from horovod_tpu_torch.ops.eager_runtime import (EagerRuntime,
                                                 LoopbackExecutor)
from horovod_tpu_torch.utils import faults, metrics

WARMUP_K = 3


@pytest.fixture
def rt():
    r = EagerRuntime(0, 1, cycle_ms=1.0, cache_capacity=32,
                     fast_path=True, fast_path_warmup=WARMUP_K)
    yield r
    r.shutdown()


def _f32(*shape, fill):
    return torch.full(shape, float(fill), dtype=torch.float32)


# ------------------------------------------------ the pipeline, world 1

def test_allreduce_roundtrip(rt):
    x = torch.arange(8, dtype=torch.float32)
    out = rt.synchronize(rt.allreduce_async("t1", x))
    torch.testing.assert_close(out, x)  # sum over a world of 1


def test_allreduce_average_and_scales(rt):
    x = _f32(4, fill=2)
    torch.testing.assert_close(
        rt.synchronize(rt.allreduce_async("t2", x, average=True)), x)
    h = rt.enqueue("t3", x, prescale=0.5, postscale=4.0)
    torch.testing.assert_close(rt.synchronize(h), x * 0.5 * 4.0)


def test_many_tensors_all_complete(rt):
    handles = {f"g{i}": rt.allreduce_async(f"g{i}", _f32(16, fill=i))
               for i in range(20)}
    for i, h in enumerate(handles.values()):
        torch.testing.assert_close(rt.synchronize(h), _f32(16, fill=i))


def test_cache_hits_accumulate():
    r = EagerRuntime(0, 1, cycle_ms=1.0, cache_capacity=32,
                     fast_path=False)
    try:
        for _ in range(3):
            r.synchronize(r.allreduce_async("steady", _f32(8, fill=1)))
        assert r.cache_hits() >= 2
    finally:
        r.shutdown()


def test_barrier(rt):
    rt.barrier(timeout_s=10.0)


def test_bytes_negotiated_counts(rt):
    rt.synchronize(rt.allreduce_async("b", _f32(1024, fill=1)))
    assert rt.bytes_negotiated() >= 4096


def test_allgather_roundtrip(rt):
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    torch.testing.assert_close(rt.synchronize(rt.allgather_async("ag", x)),
                               x)


def test_alltoall_even(rt):
    x = torch.arange(8, dtype=torch.float32)
    out, recv = rt.synchronize(rt.alltoall_async("a2a", x))
    torch.testing.assert_close(out, x)
    assert recv.tolist() == [8]


def test_alltoall_uneven_splits(rt):
    x = torch.arange(10, dtype=torch.float32)
    out, recv = rt.synchronize(rt.alltoall_async("a2a_u", x, splits=[10]))
    torch.testing.assert_close(out, x)
    assert recv.tolist() == [10]


def test_alltoall_bad_splits_raises(rt):
    h = rt.alltoall_async("a2a_bad", _f32(10, fill=1), splits=[3])
    with pytest.raises(HorovodInternalError):
        rt.synchronize(h)


def test_bfloat16_stays_bfloat16(rt):
    """bf16 (dtype code 10) goes through negotiation and back as
    torch.bfloat16."""
    x = torch.linspace(-2, 2, 12).to(torch.bfloat16)
    out = rt.synchronize(rt.allreduce_async("bf", x))
    assert out.dtype == torch.bfloat16 and torch.equal(out, x)


def test_unknown_op_raises_not_passthrough():
    """Executors refuse unknown ops rather than succeed with garbage."""
    batch = ExecutionBatch(
        batch_id=1, op=99, reduce_op=1, root_rank=0, prescale=1.0,
        postscale=1.0, dtype=7, total_bytes=4, names=["z"], handles=[1],
        first_shape=[1], error_reason="",
    )
    with pytest.raises(HorovodInternalError):
        LoopbackExecutor(1)(batch, {"z": torch.ones(1)})


def test_autotune_waits_for_its_entry():
    """The runtime starts with the controller's tuner on (autotune was
    refused until the autotuner was ported): its collectives run, and
    its tuned parameters are the controller's, unpinned at the start
    and at the configured threshold."""
    r = EagerRuntime(0, 1, cycle_ms=1.0, fusion_threshold=1 << 20,
                     autotune=True, autotune_warmup=1,
                     autotune_cycles_per_sample=2)
    try:
        x = torch.arange(8, dtype=torch.float32)
        assert torch.equal(r.synchronize(r.allreduce_async("at", x)), x)
        tuned = r.tuned_parameters()
        assert set(tuned) == {"cycle_ms", "fusion_threshold_bytes",
                              "pinned", "cache_enabled",
                              "hierarchical_allreduce",
                              "hierarchical_local_size"}
        assert tuned["fusion_threshold_bytes"] >= 1 << 20
        assert tuned["cycle_ms"] > 0
    finally:
        r.shutdown()


# ------------------------------------ the LoopbackExecutor against JAX's

def _batch(jax_mod, op, names, shapes, dtype="float32", reduce_op=1,
           prescale=1.0, postscale=1.0, root_rank=0, all_splits=(),
           rank_dim0=()):
    return jax_mod.ExecutionBatch(
        batch_id=1, op=op, reduce_op=reduce_op, root_rank=root_rank,
        prescale=prescale, postscale=postscale, dtype=dtype,
        total_bytes=0, names=list(names), handles=list(range(len(names))),
        first_shape=list(shapes[0]), error_reason="", shapes=shapes,
        all_splits=all_splits, rank_dim0=rank_dim0)


def _same(port_out, jax_out):
    if isinstance(jax_out, tuple):
        return all(_same(p, j) for p, j in zip(port_out, jax_out))
    want = np.asarray(jax_out)
    got = port_out.numpy()
    return got.dtype == want.dtype and got.shape == want.shape and \
        np.array_equal(got.view(np.uint8), want.view(np.uint8))


_CASES = [
    ("sum", OP_ALLREDUCE, dict(reduce_op=1)),
    ("average_scaled", OP_ALLREDUCE,
     dict(reduce_op=0, prescale=0.37, postscale=1.9)),
    ("min", OP_ALLREDUCE, dict(reduce_op=3, prescale=0.5)),
    ("max", OP_ALLREDUCE, dict(reduce_op=4)),
    ("product", OP_ALLREDUCE, dict(reduce_op=5, postscale=0.1)),
    ("allgather", OP_ALLGATHER, {}),
    ("broadcast", OP_BROADCAST, dict(root_rank=2)),
    ("reducescatter_avg", OP_REDUCESCATTER,
     dict(reduce_op=0, prescale=3.0, postscale=0.25)),
    ("alltoall", OP_ALLTOALL,
     dict(all_splits=[1, 2, 3, 0, 2, 2, 2, 0, 6, 0, 0, 0, 0, 6, 0, 0])),
]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_loopback_matches_jax_loopback(case):
    """The same batch and float32 inputs through both executors, in a
    world of 4 seen from rank 2: bitwise, but for the product of the n
    identical contributions, ``x ** n`` in both, whose power numpy and
    torch round differently on the CPU (within 2 ulp here)."""
    from horovod_tpu import _native as jax_native
    from horovod_tpu.ops.eager_runtime import \
        LoopbackExecutor as JaxLoopback

    _, op, kw = case
    rs = np.random.RandomState(7)
    names = ["a", "b"]
    shapes = [[8, 3], [8]]
    xs = {n: rs.randn(*s).astype(np.float32) for n, s in zip(names,
                                                             shapes)}
    jb = _batch(jax_native, op, names, shapes, **kw)
    pb = _batch(port_native, op, names, shapes, **kw)
    theirs = JaxLoopback(4, 2, wire=None)(jb, dict(xs))
    mine = LoopbackExecutor(4, 2, wire=None)(
        pb, {n: torch.from_numpy(x.copy()) for n, x in xs.items()})
    assert set(mine) == set(theirs) == set(names)
    for n in names:
        if case[0] == "product":
            want = np.asarray(theirs[n])
            ulp = np.spacing(np.abs(want))
            assert mine[n].dtype == torch.float32
            assert np.all(np.abs(mine[n].numpy() - want) <= 2 * ulp), n
        else:
            assert _same(mine[n], theirs[n]), n


@pytest.mark.parametrize("wire", ["int8", "int8-raw", "bf16", "fp16"])
def test_loopback_wire_matches_jax(wire):
    """The wires over five steps of one name (the int8 wire's
    error-feedback residual carried across them), Average with scales,
    in a world of 3: the reduced value and the residual, bitwise."""
    from horovod_tpu import _native as jax_native
    from horovod_tpu.ops.eager_runtime import \
        LoopbackExecutor as JaxLoopback

    rs = np.random.RandomState(11)
    mine = LoopbackExecutor(3, 1, wire=wire)
    theirs = JaxLoopback(3, 1, wire=wire)
    assert mine.wire.key == (theirs.wire.kind, theirs.wire.block,
                             theirs.wire.error_feedback)
    shapes = [[37, 11]]
    for step in range(5):
        x = (rs.randn(37, 11) * 10.0 ** rs.uniform(-3, 2)).astype(
            np.float32)
        kw = dict(reduce_op=0, prescale=1.5, postscale=0.75)
        t = theirs(_batch(jax_native, OP_ALLREDUCE, ["g"], shapes, **kw),
                   {"g": x})["g"]
        m = mine(_batch(port_native, OP_ALLREDUCE, ["g"], shapes, **kw),
                 {"g": torch.from_numpy(x.copy())})["g"]
        assert _same(m, t), (wire, step)
        if wire == "int8":
            assert _same(mine._residuals["g"],
                         np.asarray(theirs._residuals["g"])), step
        else:
            assert not mine._residuals and not theirs._residuals


# ------------------------------------------------ the steady-state path

def _step(rt, names, shape=(8,), mult=1.0):
    """One training-shaped step: enqueue every name, sync in order."""
    ins = {n: torch.full(shape, (i + 1) * mult, dtype=torch.float32)
           for i, n in enumerate(names)}
    hs = {n: rt.allreduce_async(n, ins[n]) for n in names}
    return {n: rt.synchronize(h) for n, h in hs.items()}, ins


def _activate(rt, names, shape=(8,), steps=WARMUP_K + 4):
    outs = [_step(rt, names, shape) for _ in range(steps)]
    assert rt.fast_path_stats()["active"], rt.fast_path_stats()
    return outs


def _all_equal(outs):
    for out, ins in outs:
        for n, v in ins.items():
            assert torch.equal(out[n], v), n


def test_plan_activates_and_bypasses_negotiation(rt):
    names = [f"g{i}" for i in range(4)]
    _all_equal(_activate(rt, names))
    s = rt.fast_path_stats()
    assert s["activations"] == 1 and s["hits"] > 0 and s["steps"] > 0
    assert s["bypassed_bytes"] > 0
    before = rt.bytes_negotiated()
    for _ in range(5):
        _step(rt, names)
    assert rt.bytes_negotiated() == before


def test_fast_path_results_bitwise_equal_negotiated(rt):
    names = [f"b{i}" for i in range(3)]
    rt.set_fast_path(False)
    negotiated, _ = _step(rt, names, mult=0.3)
    assert not rt.fast_path_stats()["active"]
    rt.set_fast_path(True)
    _activate(rt, names)
    fast, _ = _step(rt, names, mult=0.3)
    assert rt.fast_path_stats()["steps"] > 0
    for n in names:
        assert torch.equal(negotiated[n], fast[n])


def test_fast_path_disabled_never_activates():
    r = EagerRuntime(0, 1, cycle_ms=1.0, fast_path=False)
    try:
        _all_equal([_step(r, ["x0", "x1"]) for _ in range(WARMUP_K + 6)])
        s = r.fast_path_stats()
        assert not s["active"] and s["hits"] == 0 and s["steps"] == 0
    finally:
        r.shutdown()


def test_mixed_op_plan(rt):
    """A step mixing allreduce, broadcast and reducescatter freezes and
    replays as one plan."""
    def mixed_step():
        h1 = rt.allreduce_async("m_ar", _f32(8, fill=2))
        h2 = rt.enqueue("m_bc", _f32(4, fill=7), OP_BROADCAST, root_rank=0)
        h3 = rt.enqueue("m_rs", torch.arange(8, dtype=torch.float32),
                        OP_REDUCESCATTER)
        return [rt.synchronize(h) for h in (h1, h2, h3)]

    outs = [mixed_step() for _ in range(WARMUP_K + 5)]
    s = rt.fast_path_stats()
    assert s["active"] and s["steps"] > 0
    for o in outs:
        assert torch.equal(o[0], _f32(8, fill=2))
        assert torch.equal(o[1], _f32(4, fill=7))
        assert torch.equal(o[2], torch.arange(8, dtype=torch.float32))


def test_grouped_enqueue_batch_rides_fast_path(rt):
    def gstep():
        hs = rt.enqueue_batch([
            dict(name=f"q{i}", tensor=_f32(8, fill=i + 1), group="G",
                 group_size=3) for i in range(3)])
        return [rt.synchronize(h) for h in hs]

    outs = [gstep() for _ in range(WARMUP_K + 5)]
    s = rt.fast_path_stats()
    assert s["active"] and s["steps"] > 0
    for o in outs:
        for i in range(3):
            assert torch.equal(o[i], _f32(8, fill=i + 1))


def test_shape_change_invalidates_then_relearns(rt):
    names = ["s0", "s1"]
    _activate(rt, names, shape=(8,))
    outs = _activate(rt, names, shape=(16,))
    s = rt.fast_path_stats()
    assert s["invalidations"] >= 1 and s["activations"] == 2
    _all_equal(outs)


def test_new_tensor_invalidates(rt):
    _activate(rt, ["n0", "n1"])
    h0 = rt.allreduce_async("n0", _f32(8, fill=1))
    hx = rt.allreduce_async("brand_new", _f32(2, fill=5))
    h1 = rt.allreduce_async("n1", _f32(8, fill=2))
    assert torch.equal(rt.synchronize(h0), _f32(8, fill=1))
    assert torch.equal(rt.synchronize(hx), _f32(2, fill=5))
    assert torch.equal(rt.synchronize(h1), _f32(8, fill=2))
    s = rt.fast_path_stats()
    assert not s["active"] and s["invalidations"] == 1


def test_process_set_churn_invalidates(rt):
    names = ["p0", "p1"]
    _activate(rt, names)
    rt.register_process_set(7, [0])
    s = rt.fast_path_stats()
    assert not s["active"] and s["invalidations"] == 1
    _all_equal([_step(rt, names)])
    _activate(rt, names)
    rt.deregister_process_set(7)
    s = rt.fast_path_stats()
    assert not s["active"] and s["invalidations"] == 2


def test_sync_before_step_complete_falls_back(rt):
    _activate(rt, ["w0", "w1"])
    h0 = rt.allreduce_async("w0", _f32(8, fill=3))
    assert torch.equal(rt.synchronize(h0, timeout_s=20.0), _f32(8, fill=3))
    s = rt.fast_path_stats()
    assert not s["active"]
    assert s["last_invalidation"] == "sync_before_step_complete"


def test_public_invalidate_plan_resets(rt):
    names = ["e0", "e1"]
    _activate(rt, names)
    before = rt.bytes_negotiated()
    rt.invalidate_plan("elastic_reset")
    s = rt.fast_path_stats()
    assert not s["active"] and s["invalidations"] == 1
    _activate(rt, names)
    assert rt.bytes_negotiated() > before
    assert rt.fast_path_stats()["activations"] == 2


def test_elastic_reinit_starts_cold(monkeypatch):
    """An elastic reset tears the runtime down and re-inits
    (elastic/state.py _reinitialize: shutdown + init): the new runtime
    starts with no plan and empty counters, on a world of its own."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.elastic.state import _reinitialize

    monkeypatch.setenv("HVD_TPU_NATIVE", "1")
    hvd.init(device="cpu")
    try:
        rt1 = global_state().eager_runtime
        assert rt1 is not None
        for _ in range(WARMUP_K + 4):
            hvd.synchronize(hvd.allreduce_async(torch.ones(4), name="el",
                                                op=hvd.Sum))
        assert rt1.fast_path_stats()["active"]
        _reinitialize()
        rt2 = global_state().eager_runtime
        assert rt2 is not None and rt2 is not rt1
        s = rt2.fast_path_stats()
        assert not s["active"] and s["hits"] == 0 and s["steps"] == 0
        out = hvd.synchronize(hvd.allreduce_async(torch.ones(4), name="el",
                                                  op=hvd.Sum))
        assert torch.equal(out, torch.ones(4))
    finally:
        hvd.shutdown()
    assert global_state().eager_runtime is None


def test_join_invalidates(rt):
    _activate(rt, ["j0", "j1"])
    assert rt.join_sync(timeout_s=20.0) == 0
    s = rt.fast_path_stats()
    assert not s["active"] and s["invalidations"] == 1


def test_fault_point_vetoes_activation_and_recovers():
    """eager.fast_path:error at plan activation: the plan is vetoed, the
    runtime stays on negotiation (correct results, no hang), and once
    the rule's budget is spent the next steady window activates."""
    faults.configure("eager.fast_path:error:times=1")
    r = EagerRuntime(0, 1, cycle_ms=1.0, fast_path=True,
                     fast_path_warmup=WARMUP_K)
    try:
        names = ["f0", "f1"]
        outs = [_step(r, names) for _ in range(WARMUP_K + 3)]
        s = r.fast_path_stats()
        assert s["invalidations"] >= 1
        assert s["last_invalidation"] == "fault_injected"
        _all_equal(outs)
        _all_equal(_activate(r, names, steps=WARMUP_K + 4))
    finally:
        faults.reset()
        r.shutdown()


def test_executor_error_during_fast_step_fails_and_invalidates():
    calls = {"n": 0}
    inner = LoopbackExecutor(1, 0)

    def flaky(batch, tensors):
        calls["n"] += 1
        if calls["n"] == WARMUP_K + 3:  # the first fast-path dispatch
            raise RuntimeError("boom")
        return inner(batch, tensors)

    r = EagerRuntime(0, 1, cycle_ms=1.0, executor=flaky,
                     fast_path=True, fast_path_warmup=WARMUP_K)
    try:
        for _ in range(WARMUP_K + 2):
            _step(r, ["x"])
        assert r.fast_path_stats()["active"]
        h = r.allreduce_async("x", _f32(8, fill=1))
        with pytest.raises(HorovodInternalError, match="boom"):
            r.synchronize(h, timeout_s=20.0)
        s = r.fast_path_stats()
        assert not s["active"]
        assert s["last_invalidation"] == "executor_error"
        _all_equal([_step(r, ["x"])])
    finally:
        r.shutdown()


def test_fast_path_and_runtime_counters(rt):
    """The runtime's snapshot carries the plan cache's counters; with
    metrics on, the fused-batch counters and the queue-depth gauge the
    port's registry holds are fed."""
    metrics.reset()
    metrics.enable()
    try:
        _activate(rt, ["m0", "m1"])
        snap = rt.metrics_snapshot()
        assert snap["fast_path_hits"] > 0
        assert snap["fast_path_active"] == 1
        assert snap["negotiation_bypassed_bytes"] > 0
        assert snap["executor_batches"] > 0 and \
            snap["executor_seconds"] > 0
        reg = metrics.registry.snapshot()
        fused = reg["hvd_fused_tensors_total"]
        assert sum(v for v in fused.values()) >= 2 * (WARMUP_K + 4)
        assert "hvd_eager_queue_depth" in reg
    finally:
        metrics.reset()


# ------------------------------------------------ weak scaling, world 2

def _ws_worker(rank, size, port, q):
    import torch as _torch

    from horovod_tpu_torch.ops.eager_runtime import EagerRuntime as _RT

    try:
        r = _RT(rank, size, "127.0.0.1", port, cycle_ms=1.0,
                fast_path=True, fast_path_warmup=WARMUP_K)
        try:
            names = [f"g{i}" for i in range(8)]
            order = names if rank % 2 == 0 else list(reversed(names))
            deltas = []
            for step in range(WARMUP_K + 14):
                before = r.bytes_negotiated()
                hs = [r.allreduce_async(n, _torch.ones(64)) for n in order]
                for h in hs:
                    # loopback world of 2: the sum of identical = 2x
                    out = r.synchronize(h, timeout_s=30.0)
                    assert _torch.equal(out, _torch.full((64,), 2.0))
                if step >= WARMUP_K + 4:
                    deltas.append(r.bytes_negotiated() - before)
            q.put((rank, "ok", {"deltas": deltas,
                                "stats": r.fast_path_stats()}))
        finally:
            r.shutdown()
    except Exception as e:  # surfaced to the asserting parent
        q.put((rank, "err", repr(e)))


def test_weak_scaling_world2_steady_state_negotiates_zero_bytes():
    """Two processes on the loopback executor: once the plan freezes,
    the steady-state steps negotiate 0 bytes."""
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_ws_worker, args=(r, 2, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(2):
            rank, status, payload = q.get(timeout=120)
            assert status == "ok", f"rank {rank}: {payload}"
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
    for payload in results.values():
        assert payload["stats"]["active"], payload["stats"]
        assert payload["deltas"] and all(d == 0 for d in payload["deltas"])


# ------------------------------------- the DistExecutor at world 1

def test_dist_executor_at_world_one_is_the_loopback(monkeypatch):
    """hvd.init() with HVD_TPU_NATIVE=1 gives a world of one a
    DistExecutor on a group of its own (the JAX package gives it the
    loopback executor): the same batches give the loopback's results,
    bitwise for float32 and for the int8 wire's reduced value; the int8
    residual differs in its last bits, since the DistExecutor's kernels
    (and their plain versions) round ``x - q*s`` once, as XLA's executor
    contracts it, where the loopback rounds the product first (ROADMAP
    queue C). Adasum is refused by the executor and reduced outside
    the runtime."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.ops.eager_runtime import DistExecutor
    from horovod_tpu_torch.optim.compression import WireSpec

    monkeypatch.setenv("HVD_TPU_NATIVE", "1")
    hvd.init(device="cpu")
    try:
        ex = global_state().eager_runtime._executor
        assert isinstance(ex, DistExecutor)
        rs = np.random.RandomState(3)
        names, shapes = ["a", "b"], [[16, 5], [33]]
        xs = {n: torch.from_numpy(rs.randn(*s).astype(np.float32))
              for n, s in zip(names, shapes)}
        cases = [(OP_ALLREDUCE, dict(reduce_op=r, prescale=0.37,
                                     postscale=1.9)) for r in (0, 1, 3, 4, 5)]
        cases += [(OP_ALLGATHER, {}), (OP_BROADCAST, {}),
                  (OP_REDUCESCATTER, dict(reduce_op=0, prescale=3.0))]
        for op, kw in cases + [(OP_ALLTOALL, dict(all_splits=[16]))]:
            # an alltoall batch carries one tensor (its splits matrix)
            some = names[:1] if op == OP_ALLTOALL else names
            batch = _batch(port_native, op, some, shapes[:len(some)], **kw)
            mine = ex(batch, {n: xs[n] for n in some})
            want = LoopbackExecutor(1, 0, wire=None)(
                batch, {n: xs[n] for n in some})
            for n in some:
                if isinstance(want[n], tuple):
                    assert all(torch.equal(a, b) for a, b in
                               zip(mine[n], want[n])), (op, kw, n)
                else:
                    assert torch.equal(mine[n], want[n]), (op, kw, n)
        spec = WireSpec("int8", 16, error_feedback=True)
        ex.set_wire(spec)
        loop = LoopbackExecutor(1, 0, wire=spec)
        flat = torch.from_numpy(rs.randn(500).astype(np.float32))
        batch = _batch(port_native, OP_ALLREDUCE, ["g"], [[500]],
                       reduce_op=0)
        got = ex(batch, {"g": flat})["g"]
        assert torch.equal(got, loop(batch, {"g": flat})["g"])
        # x - q*s rounded once against twice: within half an ulp of the
        # dequantized payload, a few of the residual's own last bits
        res, want = next(iter(ex._wire_residuals.values())), \
            loop._residuals["g"]
        ulp = torch.from_numpy(np.spacing(np.abs(flat.numpy())))
        assert torch.all((res - want).abs() <= ulp)
        assert not torch.equal(res, want)
        ex.set_wire(None)
        with pytest.raises(HorovodInternalError, match="Adasum"):
            ex(_batch(port_native, OP_ALLREDUCE, ["g"], [[500]],
                      reduce_op=2), {"g": flat})
        out = hvd.allreduce(flat, op=hvd.Adasum, name="adasum")
        assert torch.equal(out, flat)  # Adasum of one rank: the identity
    finally:
        hvd.shutdown()
