"""The port's native control plane (``horovod_tpu_torch/_native``: the
ctypes layer over its copy of the C++ controller) in real multi-process
worlds over localhost TCP: the scenarios of the JAX package's
``tests/test_native_runtime.py``, on the port's library, in worlds of
2 and 3 spawned processes: negotiation order, fusion, the response
cache, ragged and uneven metadata, join, barrier and groups.
``tests/test_torch_native_runtime_sets.py`` holds the rest.

The ranks load the ctypes layer by its path (it imports only the
standard library), so they start without torch or jax. The two
autotune scenarios wait for autotune (ROADMAP queue A entry 12).
"""

import importlib.util
import multiprocessing as mp
import os
import socket
import time

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "horovod_tpu_torch", "_native",
)


def _load_native(native_dir=_NATIVE_DIR, name="hvd_torch_native_standalone"):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(native_dir, "__init__.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _drain_until(rt, handles, timeout_s=30.0, execute=True):
    """Fetch batches until all handles are terminal; returns batch log."""
    log = []
    deadline = time.time() + timeout_s
    pending = set(handles)
    while pending and time.time() < deadline:
        batch = rt.next_batch(timeout_s=0.2)
        if batch is not None:
            log.append((batch.op, tuple(batch.names)))
            if execute:
                rt.batch_done(batch, ok=True)
        done = {
            h for h in pending
            if rt.poll(h) in (rt_mod_DONE, rt_mod_FAILED)
        }
        pending -= done
    return log


# poll state constants mirrored here to keep the worker picklable
rt_mod_DONE = 2
rt_mod_FAILED = -1


def _worker(rank, size, port, scenario, q, cycle_ms=1.0):
    native = _load_native()
    rt = native.NativeRuntime()
    rt.init(
        rank, size, "127.0.0.1", port,
        cycle_ms=cycle_ms,
        cache_capacity=64,
        stall_warning_s=60.0,
    )
    try:
        result = scenario(native, rt, rank, size)
        q.put((rank, "ok", result))
    except Exception as e:  # surfaced to the asserting parent
        q.put((rank, "err", repr(e)))
    finally:
        rt.shutdown()


def _run_world(size, scenario, timeout_s=60.0, cycle_ms=1.0):
    port = _free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [
        ctx.Process(target=_worker,
                    args=(r, size, port, scenario, q, cycle_ms))
        for r in range(size)
    ]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + timeout_s
    while len(results) < size and time.time() < deadline:
        try:
            rank, status, payload = q.get(timeout=1.0)
            results[rank] = (status, payload)
        except Exception:
            pass
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.terminate()
    assert len(results) == size, f"only {len(results)}/{size} reported"
    for rank, (status, payload) in results.items():
        assert status == "ok", f"rank {rank} failed: {payload}"
    return {r: payload for r, (_, payload) in results.items()}


# ---------------------------------------------------------- scenarios
# (top-level functions: spawn requires picklable targets)


def scenario_out_of_order(native, rt, rank, size):
    names = ["grad_a", "grad_b", "grad_c", "grad_d"]
    order = names if rank == 0 else list(reversed(names))
    handles = [
        rt.enqueue(n, native.OP_ALLREDUCE, "float32", [4, 4])
        for n in order
    ]
    log = _drain_until(rt, handles)
    states = [rt.poll(h) for h in handles]
    return {"log": log, "states": states}


def test_negotiation_orders_ranks_identically():
    """Ranks submit in opposite orders; the executed batch sequence must be
    identical (the controller's whole purpose, controller.h:74-111)."""
    out = _run_world(2, scenario_out_of_order)
    assert out[0]["log"] == out[1]["log"]
    all_names = [n for _, names in out[0]["log"] for n in names]
    assert sorted(all_names) == ["grad_a", "grad_b", "grad_c", "grad_d"]
    assert all(s == rt_mod_DONE for s in out[0]["states"])
    assert all(s == rt_mod_DONE for s in out[1]["states"])


def scenario_fusion(native, rt, rank, size):
    # second tensor has a different dtype: must not fuse with the others.
    # The three are one group, which the coordinator holds until every
    # member is enqueued on every rank and then releases in one cycle
    # (all-or-nothing group readiness), so no cycle can close between
    # the enqueues
    grouped = {"group": "fusion", "group_size": 3}
    h1 = rt.enqueue("w1", native.OP_ALLREDUCE, "float32", [16], **grouped)
    h2 = rt.enqueue("w2", native.OP_ALLREDUCE, "float64", [16], **grouped)
    h3 = rt.enqueue("w3", native.OP_ALLREDUCE, "float32", [16], **grouped)
    log = _drain_until(rt, [h1, h2, h3])
    return log


def test_fusion_groups_same_dtype_only():
    """Tensors fuse only within one negotiation cycle, and there only by
    dtype. The three enqueues are certain to meet in one cycle by
    structure: they are one group, held until all three are in on both
    ranks (the JAX twin relies on the three landing in one 1 ms cycle,
    which a loaded machine can split)."""
    out = _run_world(2, scenario_fusion)
    assert out[0] == out[1]
    groups = [set(names) for _, names in out[0]]
    f32 = next(g for g in groups if "w1" in g)
    f64 = next(g for g in groups if "w2" in g)
    assert f32 == {"w1", "w3"}
    assert f64 == {"w2"}


def scenario_mismatch(native, rt, rank, size):
    shape = [4] if rank == 0 else [8]
    h = rt.enqueue("bad", native.OP_ALLREDUCE, "float32", shape)
    state = rt.wait(h, timeout_s=20.0)
    # execution-side must also see the error batch (or nothing at all)
    return {"state": state, "err": rt.last_error()}


def test_shape_mismatch_fails_on_all_ranks():
    """Mismatched shapes must raise consistently on every rank, not
    deadlock (reference negotiation error channel, controller.cc:497)."""
    out = _run_world(2, scenario_mismatch)
    for r in range(2):
        assert out[r]["state"] == rt_mod_FAILED


def scenario_cache(native, rt, rank, size):
    logs = []
    for step in range(3):
        hs = [
            rt.enqueue(f"g{i}", native.OP_ALLREDUCE, "float32", [8])
            for i in range(3)
        ]
        logs.append(_drain_until(rt, hs))
    return {"logs": logs, "cache_hits": rt.cache_hits()}


def test_response_cache_steady_state():
    """Repeat steps hit the response cache; batches stay identical
    (reference response_cache.h:45 fast path)."""
    out = _run_world(2, scenario_cache)
    for r in range(2):
        # steps 2 and 3 ran from cache: ≥6 hits (3 tensors × 2 steps)
        assert out[r]["cache_hits"] >= 6, out[r]
        all_step_names = [
            sorted(n for _, names in log for n in names)
            for log in out[r]["logs"]
        ]
        assert all_step_names[0] == all_step_names[1] == all_step_names[2]
    assert out[0]["logs"][1] == out[1]["logs"][1]


def scenario_ragged_allgather(native, rt, rank, size):
    """Ranks submit different dim-0 extents; the controller must collect
    per-rank sizes into the response (reference controller.cc:497)."""
    d0 = 3 + rank  # rank 0: 3 rows, rank 1: 4 rows
    h = rt.enqueue("rag", native.OP_ALLGATHER, "float32", [d0, 2])
    dims = []
    deadline = time.time() + 20
    while rt.poll(h) not in (rt_mod_DONE, rt_mod_FAILED):
        b = rt.next_batch(timeout_s=0.2)
        if b is not None:
            dims = b.rank_dim0
            rt.batch_done(b, ok=True)
        if time.time() > deadline:
            break
    return {"state": rt.poll(h), "rank_dim0": dims}


def test_ragged_allgather_negotiates_sizes():
    out = _run_world(2, scenario_ragged_allgather)
    for r in range(2):
        assert out[r]["state"] == rt_mod_DONE, out[r]
        assert out[r]["rank_dim0"] == [3, 4], out[r]


def scenario_uneven_alltoall(native, rt, rank, size):
    """Each rank's splits row reaches every rank as the full matrix."""
    splits = [1, 3] if rank == 0 else [2, 2]
    h = rt.enqueue("a2a", native.OP_ALLTOALL, "float32", [4, 2],
                   splits=splits)
    matrix = []
    deadline = time.time() + 20
    while rt.poll(h) not in (rt_mod_DONE, rt_mod_FAILED):
        b = rt.next_batch(timeout_s=0.2)
        if b is not None:
            matrix = b.all_splits
            rt.batch_done(b, ok=True)
        if time.time() > deadline:
            break
    return {"state": rt.poll(h), "all_splits": matrix}


def test_uneven_alltoall_negotiates_matrix():
    out = _run_world(2, scenario_uneven_alltoall)
    for r in range(2):
        assert out[r]["state"] == rt_mod_DONE, out[r]
        assert out[r]["all_splits"] == [1, 3, 2, 2], out[r]


def scenario_join(native, rt, rank, size):
    log = []
    if rank == 1:
        h = rt.enqueue("tail_grad", native.OP_ALLREDUCE, "float32", [4])
        log = _drain_until(rt, [h])
    jh = rt.join()
    deadline = time.time() + 20
    while rt.poll(jh) not in (rt_mod_DONE, rt_mod_FAILED):
        b = rt.next_batch(timeout_s=0.2)
        if b is not None:
            log.append((b.op, tuple(b.names)))
            rt.batch_done(b, ok=True)
        if time.time() > deadline:
            break
    return {"log": log, "join_state": rt.poll(jh)}


def scenario_cache_heterogeneous(native, rt, rank, size):
    """Heterogeneous shapes fuse into one response; cached per-tensor
    metadata must still be each tensor's own shape, so later rounds HIT
    instead of churning through invalidate/renegotiate."""
    shapes = {"h0": [4], "h1": [8], "h2": [2, 3]}
    for step in range(4):
        hs = [
            rt.enqueue(n, native.OP_ALLREDUCE, "float32", shp)
            for n, shp in shapes.items()
        ]
        _drain_until(rt, hs)
    return {"cache_hits": rt.cache_hits()}


def test_fused_heterogeneous_shapes_cache_correctly():
    out = _run_world(2, scenario_cache_heterogeneous)
    for r in range(2):
        # rounds 2-4 should be steady-state hits: ≥ 3 tensors × 2 rounds
        assert out[r]["cache_hits"] >= 6, out[r]


def scenario_coordinated_invalidation(native, rt, rank, size):
    """Shape change after caching: every rank must erase the entry in the
    same cycle and renegotiate (reference CacheCoordinator semantics)."""
    states = []
    for shape in ([4], [4], [6], [6]):  # cache, hit, invalidate, re-hit
        h = rt.enqueue("mut", native.OP_ALLREDUCE, "float32", shape)
        _drain_until(rt, [h])
        states.append(rt.poll(h))
    return {"states": states, "cache_hits": rt.cache_hits()}


def test_shape_change_invalidates_and_renegotiates():
    out = _run_world(2, scenario_coordinated_invalidation)
    for r in range(2):
        assert all(s == rt_mod_DONE for s in out[r]["states"]), out[r]
        assert out[r]["cache_hits"] >= 2, out[r]  # rounds 2 and 4 hit


def scenario_partial_hit_mismatch(native, rt, rank, size):
    """Rank 0 re-submits with the cached metadata (hit), rank 1 changes
    the shape (invalid). Previously rank 0's parked hit deadlocked; now
    the coordinated erase kicks both into negotiation, which surfaces a
    consistent shape-mismatch error — and the world stays usable."""
    h = rt.enqueue("p", native.OP_ALLREDUCE, "float32", [8])
    _drain_until(rt, [h])
    shape = [8] if rank == 0 else [5]
    h2 = rt.enqueue("p", native.OP_ALLREDUCE, "float32", shape)
    state2 = rt.wait(h2, timeout_s=20.0)
    while state2 == 1:  # BATCHED: drain the error batch if one appears
        b = rt.next_batch(timeout_s=0.2)
        if b is not None:
            rt.batch_done(b, ok=True)
        state2 = rt.wait(h2, timeout_s=5.0)
    h3 = rt.enqueue("q", native.OP_ALLREDUCE, "float32", [3])
    _drain_until(rt, [h3])
    return {"mismatch_state": state2, "after_state": rt.poll(h3)}


def test_partial_cache_hit_does_not_deadlock():
    out = _run_world(2, scenario_partial_hit_mismatch)
    for r in range(2):
        assert out[r]["mismatch_state"] == rt_mod_FAILED, out[r]
        assert out[r]["after_state"] == rt_mod_DONE, out[r]


def test_join_covers_missing_ranks():
    """Rank 1 has one extra batch; rank 0 joins — the tensor completes with
    rank 0 counted as a zero contributor, then join completes everywhere
    (reference JoinOp, collective_operations.h:325)."""
    out = _run_world(2, scenario_join)
    assert out[0]["join_state"] == rt_mod_DONE
    assert out[1]["join_state"] == rt_mod_DONE
    # rank 1 executed its tensor; rank 0 received the same batch (it must
    # contribute zeros for a tensor it never submitted)
    r1_names = [n for _, names in out[1]["log"] for n in names]
    assert "tail_grad" in r1_names
    r0_names = [n for _, names in out[0]["log"] for n in names]
    assert "tail_grad" in r0_names


def scenario_barrier(native, rt, rank, size):
    if rank == 1:
        time.sleep(0.3)  # stagger arrival
    h = rt.barrier()
    state = rt.wait(h, timeout_s=20.0)
    # drain the barrier batch
    b = rt.next_batch(timeout_s=1.0)
    if b is not None:
        rt.batch_done(b, ok=True)
    return state


def test_barrier_completes_on_all():
    out = _run_world(2, scenario_barrier)
    assert all(v in (1, 2) for v in out.values())


def scenario_world3(native, rt, rank, size):
    hs = [
        rt.enqueue(f"p{i}", native.OP_ALLREDUCE, "float32", [32])
        for i in range(5)
    ]
    log = _drain_until(rt, hs)
    return log


def test_three_rank_world():
    out = _run_world(3, scenario_world3)
    assert out[0] == out[1] == out[2]
    names = sorted(n for _, ns in out[0] for n in ns)
    assert names == ["p0", "p1", "p2", "p3", "p4"]


# ---------------------------------------------------------- groups


def scenario_grouped_complete(native, rt, rank, size):
    """All ranks submit the full group (in different orders): every member
    completes, released in the same negotiation cycle."""
    names = ["gm0", "gm1", "gm2"]
    order = names if rank == 0 else list(reversed(names))
    hs = [
        rt.enqueue(n, native.OP_ALLREDUCE, "float32", [8],
                   group="grp-a", group_size=3)
        for n in order
    ]
    log = _drain_until(rt, hs)
    return {"log": log, "states": [rt.poll(h) for h in hs]}


def test_grouped_members_complete_together():
    out = _run_world(2, scenario_grouped_complete)
    assert out[0]["log"] == out[1]["log"]
    all_names = sorted(n for _, names in out[0]["log"] for n in names)
    assert all_names == ["gm0", "gm1", "gm2"]
    assert all(s == rt_mod_DONE for s in out[0]["states"])
    # same dtype/op → the whole group fuses into ONE batch
    assert len(out[0]["log"]) == 1, out[0]["log"]


def scenario_grouped_partial(native, rt, rank, size):
    """Rank 1 submits only one member of a 2-group: the whole group must
    block (no member executes) and the stall shutdown must fail BOTH
    ranks consistently (group_table.h all-or-nothing + the negotiation
    error channel)."""
    hs = [rt.enqueue("pg0", native.OP_ALLREDUCE, "float32", [4],
                     group="grp-p", group_size=2)]
    if rank == 0:
        hs.append(rt.enqueue("pg1", native.OP_ALLREDUCE, "float32", [4],
                             group="grp-p", group_size=2))
    deadline = time.time() + 25
    pending = set(hs)
    while pending and time.time() < deadline:
        b = rt.next_batch(timeout_s=0.2)
        if b is not None:
            rt.batch_done(b, ok=True)
        done = {h for h in pending
                if rt.poll(h) in (rt_mod_DONE, rt_mod_FAILED)}
        pending -= done
    return {"states": [rt.poll(h) for h in hs]}


def _worker_stall(rank, size, port, scenario, q):
    """Worker with a short stall-shutdown so blocked groups error out."""
    native = _load_native()
    rt = native.NativeRuntime()
    rt.init(rank, size, "127.0.0.1", port, cycle_ms=1.0,
            cache_capacity=64, stall_warning_s=1.0, stall_shutdown_s=3.0)
    try:
        result = scenario(native, rt, rank, size)
        q.put((rank, "ok", result))
    except Exception as e:
        q.put((rank, "err", repr(e)))
    finally:
        rt.shutdown()


def test_grouped_partial_submission_blocks_and_errors():
    port = _free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [
        ctx.Process(target=_worker_stall,
                    args=(r, 2, port, scenario_grouped_partial, q))
        for r in range(2)
    ]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + 60
    while len(results) < 2 and time.time() < deadline:
        try:
            rank, status, payload = q.get(timeout=1.0)
            results[rank] = (status, payload)
        except Exception:
            pass
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.terminate()
    assert len(results) == 2, f"only {len(results)}/2 reported"
    for rank, (status, payload) in results.items():
        assert status == "ok", f"rank {rank}: {payload}"
        # nothing may complete; the stall shutdown fails everything on
        # every rank — consistently, not by deadlock
        assert all(s == rt_mod_FAILED for s in payload["states"]), payload


def scenario_grouped_ag_rs_partial(native, rt, rank, size):
    """All-or-nothing also holds for allgather and reducescatter groups
    (reference operations.cc:1725, :1532): rank 1 withholds one member
    of each group — nothing executes, the stall shutdown fails all."""
    hs = [
        rt.enqueue("agp0", native.OP_ALLGATHER, "float32", [4],
                   group="grp-ag", group_size=2),
        rt.enqueue("rsp0", native.OP_REDUCESCATTER, "float32", [4],
                   group="grp-rs", group_size=2),
    ]
    if rank == 0:
        hs.append(rt.enqueue("agp1", native.OP_ALLGATHER, "float32",
                             [4], group="grp-ag", group_size=2))
        hs.append(rt.enqueue("rsp1", native.OP_REDUCESCATTER, "float32",
                             [4], group="grp-rs", group_size=2))
    deadline = time.time() + 25
    pending = set(hs)
    while pending and time.time() < deadline:
        b = rt.next_batch(timeout_s=0.2)
        if b is not None:
            rt.batch_done(b, ok=True)
        done = {h for h in pending
                if rt.poll(h) in (rt_mod_DONE, rt_mod_FAILED)}
        pending -= done
    return {"states": [rt.poll(h) for h in hs]}


def test_grouped_allgather_reducescatter_all_or_nothing():
    port = _free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [
        ctx.Process(target=_worker_stall,
                    args=(r, 2, port, scenario_grouped_ag_rs_partial, q))
        for r in range(2)
    ]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + 60
    while len(results) < 2 and time.time() < deadline:
        try:
            rank, status, payload = q.get(timeout=1.0)
            results[rank] = (status, payload)
        except Exception:
            pass
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.terminate()
    assert len(results) == 2, f"only {len(results)}/2 reported"
    for rank, (status, payload) in results.items():
        assert status == "ok", f"rank {rank}: {payload}"
        assert all(s == rt_mod_FAILED for s in payload["states"]), payload


def scenario_group_mismatch(native, rt, rank, size):
    """Same tensor, different group metadata across ranks → consistent
    negotiated error."""
    gs = 2 if rank == 0 else 3
    h = rt.enqueue("gmx", native.OP_ALLREDUCE, "float32", [4],
                   group="grp-m", group_size=gs)
    h2 = rt.enqueue("gmx2", native.OP_ALLREDUCE, "float32", [4],
                    group="grp-m", group_size=gs)
    state = rt.wait(h, timeout_s=20.0)
    state2 = rt.wait(h2, timeout_s=20.0)
    return {"state": state, "state2": state2}


def test_group_metadata_mismatch_errors_consistently():
    out = _run_world(2, scenario_group_mismatch)
    for r in range(2):
        # the whole group fails — both members, on both ranks
        assert out[r]["state"] == rt_mod_FAILED, out[r]
        assert out[r]["state2"] == rt_mod_FAILED, out[r]
