"""The port's native control plane, continued (the first half is
``tests/test_torch_native_runtime.py``): the single-rank cases, process
sets negotiated per set, a crashed rank surfacing on the survivors, the
Bayesian tuner's search, the dtype codes, and the library's build (safe
with two processes building at once; a failed build raises). The
scenarios are the JAX package's ``tests/test_native_runtime.py``, on
the port's library, in worlds of 2 and 3 spawned processes that load
the ctypes layer by its path.
"""

import importlib.util
import multiprocessing as mp
import os
import shutil
import socket
import time

import pytest

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


def _worker(rank, size, port, scenario, q):
    native = _load_native()
    rt = native.NativeRuntime()
    rt.init(
        rank, size, "127.0.0.1", port,
        cycle_ms=1.0,
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


def _run_world(size, scenario, timeout_s=60.0):
    port = _free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [
        ctx.Process(target=_worker, args=(r, size, port, scenario, q))
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


# ---------------------------------------------------------- single process


def test_single_rank_world_immediate():
    native = _load_native()
    rt = native.NativeRuntime()
    rt.init(0, 1, cycle_ms=1.0)
    try:
        h = rt.enqueue("solo", native.OP_ALLREDUCE, "float32", [4])
        batch = rt.next_batch(timeout_s=5.0)
        assert batch is not None
        assert batch.names == ["solo"]
        rt.batch_done(batch, ok=True)
        assert rt.wait(h, timeout_s=5.0) == rt_mod_DONE
    finally:
        rt.shutdown()


def test_duplicate_name_rejected():
    native = _load_native()
    rt = native.NativeRuntime()
    rt.init(0, 1, cycle_ms=1000.0)  # slow cycle: both enqueues land together
    try:
        rt.enqueue("dup", native.OP_ALLREDUCE, "float32", [4])
        h2 = rt.enqueue("dup", native.OP_ALLREDUCE, "float32", [4])
        assert rt.poll(h2) == rt_mod_FAILED
        assert "dup" in rt.last_error()
    finally:
        rt.shutdown()


# ------------------------------------------------- per-set controllers
# (reference process_set.h:89: each set negotiates independently; here
# one transport carries every set's traffic, keyed by set id)


def scenario_overlapping_sets(native, rt, rank, size):
    # world 3; A=1:{0,1}, B=2:{1,2} — registration is world-wide
    ra = rt.register_set(1, [0, 1])
    rb = rt.register_set(2, [1, 2])
    reg_states = [rt.wait(ra, 30.0), rt.wait(rb, 30.0)]
    members = {1: rt.set_members(1), 2: rt.set_members(2)}
    handles = []
    # members submit only their sets' ops (qualified names, like the
    # Python EagerRuntime does); rank 1 overlaps both
    if rank in (0, 1):
        handles.append(rt.enqueue("ps1:x", native.OP_ALLREDUCE, "float32",
                                  [4], process_set_id=1))
    if rank in (1, 2):
        handles.append(rt.enqueue("ps2:y", native.OP_ALLREDUCE, "float32",
                                  [8], process_set_id=2))
    log = []
    import time as _t
    deadline = _t.time() + 30.0
    pending = set(handles)
    while pending and _t.time() < deadline:
        batch = rt.next_batch(timeout_s=0.2)
        if batch is not None:
            log.append((batch.op, tuple(batch.names),
                        batch.process_set_id, tuple(batch.set_ranks)))
            rt.batch_done(batch, ok=True)
        pending -= {h for h in pending
                    if rt.poll(h) in (rt_mod_DONE, rt_mod_FAILED)}
    states = [rt.poll(h) for h in handles]
    # hold the world open until every rank is done: shutdown is a
    # negotiated world-wide event, so an early-returning rank would kill
    # peers' in-flight subset ops
    _drain_until(rt, [rt.enqueue("fin", native.OP_ALLREDUCE, "float32",
                                 [2])], timeout_s=20.0)
    return {"reg": reg_states, "members": members, "log": log,
            "states": states}


def test_overlapping_sets_negotiate_independently():
    """Two overlapping sets: each negotiates among its own members, a
    rank sees only its sets' batches, and batches carry the set's
    sub-mesh membership (reference process_set.h:89)."""
    out = _run_world(3, scenario_overlapping_sets)
    for r in range(3):
        assert out[r]["reg"] == [rt_mod_DONE, rt_mod_DONE]
        assert out[r]["members"] == {1: [0, 1], 2: [1, 2]}
        assert all(s == rt_mod_DONE for s in out[r]["states"])
    sets_seen = lambda r: {e[2] for e in out[r]["log"]}
    assert sets_seen(0) == {1}      # never sees set 2's batches
    assert sets_seen(2) == {2}      # never sees set 1's batches
    assert sets_seen(1) == {1, 2}   # overlap executes both
    for e in out[1]["log"]:
        assert e[3] == ((0, 1) if e[2] == 1 else (1, 2))


def scenario_set_mismatch(native, rt, rank, size):
    ranks = [0, 1] if rank == 0 else [0]
    h = rt.register_set(1, ranks)
    state = rt.wait(h, 20.0)
    return {"state": state, "err": rt.last_error()}


def test_set_registration_mismatch_fails_consistently():
    """Mismatched membership across ranks fails registration on every
    rank through the ordinary metadata-validation channel."""
    out = _run_world(2, scenario_set_mismatch)
    for r in range(2):
        assert out[r]["state"] == rt_mod_FAILED


def scenario_nonmember_enqueue(native, rt, rank, size):
    h = rt.register_set(1, [0])
    assert rt.wait(h, 30.0) == rt_mod_DONE
    # BOTH ranks enqueue the same qualified name into set 1: the member's
    # op must complete even though the non-member's errors — per-rank
    # error targeting (Response.error_rank)
    hh = rt.enqueue("ps1:z", native.OP_ALLREDUCE, "float32", [4],
                    process_set_id=1)
    _drain_until(rt, [hh], timeout_s=20.0)
    state, err = rt.poll(hh), rt.last_error()
    # hold the world open (negotiated shutdown; see overlapping_sets)
    _drain_until(rt, [rt.enqueue("fin", native.OP_ALLREDUCE, "float32",
                                 [2])], timeout_s=20.0)
    return {"state": state, "err": err}


def test_nonmember_enqueue_fails_only_offender():
    out = _run_world(2, scenario_nonmember_enqueue)
    assert out[0]["state"] == rt_mod_DONE
    assert out[1]["state"] == rt_mod_FAILED
    assert "not a member" in out[1]["err"]


def scenario_set_cache(native, rt, rank, size):
    h = rt.register_set(1, [0, 1])
    assert rt.wait(h, 30.0) == rt_mod_DONE
    for _ in range(4):
        hs = []
        if rank in (0, 1):
            hs.append(rt.enqueue("ps1:g", native.OP_ALLREDUCE, "float32",
                                 [16], process_set_id=1))
        hs.append(rt.enqueue("glob", native.OP_ALLREDUCE, "float32", [16]))
        _drain_until(rt, hs, timeout_s=20.0)
    return {"cache_hits": rt.cache_hits()}


def test_subset_ops_ride_the_cache_fast_path():
    """Member-scoped cache agreement: subset tensors cache-hit for the
    members even though non-members never claim the position (a
    world-wide AND would disable the fast path for every subset op)."""
    out = _run_world(3, scenario_set_cache)
    assert out[0]["cache_hits"] >= 2   # member: ps1:g + glob hits
    assert out[1]["cache_hits"] >= 2
    assert out[2]["cache_hits"] >= 1   # non-member still hits on glob


def scenario_set_barrier(native, rt, rank, size):
    h = rt.register_set(1, [0, 2])
    assert rt.wait(h, 30.0) == rt_mod_DONE
    state = None
    if rank in (0, 2):
        hb = rt.enqueue("ps1:__barrier__", native.OP_BARRIER, "uint8", [],
                        process_set_id=1)
        _drain_until(rt, [hb], timeout_s=20.0)
        state = rt.poll(hb)
    # hold the world open (negotiated shutdown; see overlapping_sets):
    # the non-member completes this only after the members passed their
    # barrier and submitted theirs
    _drain_until(rt, [rt.enqueue("fin", native.OP_ALLREDUCE, "float32",
                                 [2])], timeout_s=20.0)
    return {"state": state}


def test_subset_barrier_completes_for_members_only():
    out = _run_world(3, scenario_set_barrier)
    assert out[0]["state"] == rt_mod_DONE
    assert out[2]["state"] == rt_mod_DONE
    assert out[1]["state"] is None


def scenario_deregister(native, rt, rank, size):
    h = rt.register_set(1, [0, 1])
    assert rt.wait(h, 30.0) == rt_mod_DONE
    stranded_state = None
    if rank == 0:
        # submitted on one rank only: the deregistration must fail it
        # instead of leaving it pending forever
        hs = rt.enqueue("ps1:stranded", native.OP_ALLREDUCE, "float32",
                        [4], process_set_id=1)
    hd = rt.deregister_set(1)
    state = rt.wait(hd, 30.0)
    if rank == 0:
        s = rt.wait(hs, 20.0)
        while s in (0, 1):
            batch = rt.next_batch(timeout_s=0.2)
            if batch is not None:
                rt.batch_done(batch, ok=True)
            s = rt.wait(hs, 5.0)
        stranded_state = s
    members = rt.set_members(1)
    return {"state": state, "stranded": stranded_state,
            "members": members, "err": rt.last_error()}


def test_deregistered_set_fails_stranded_tensors():
    out = _run_world(2, scenario_deregister)
    for r in range(2):
        assert out[r]["state"] == rt_mod_DONE
        assert out[r]["members"] is None
    assert out[0]["stranded"] == rt_mod_FAILED


# ------------------------------------------------ crash-mid-cycle
# (reference controller.cc:252-270 lost-connection path: a dead rank
# must surface as a consistent error on every survivor, never a hang)


def _worker_crash(rank, size, port, victim, q, barrier):
    import os
    import signal

    native = _load_native()
    rt = native.NativeRuntime()
    rt.init(rank, size, "127.0.0.1", port, cycle_ms=1.0, cache_capacity=64)
    # one completed collective proves the world was fully connected
    h = rt.enqueue("warm", native.OP_ALLREDUCE, "float32", [4])
    _drain_until(rt, [h], timeout_s=30.0)
    if rt.poll(h) != rt_mod_DONE:
        q.put((rank, "warm-failed", rt.last_error()))
        rt.shutdown()
        return
    # every rank must see its OWN warm complete before the victim
    # dies: rank 0's DONE only proves the coordinator got ITS result —
    # a coordinator victim SIGKILLing itself here could still beat the
    # workers' warm responses onto the wire, and their warm (not the
    # post-crash op this test is about) would fail. Out-of-band
    # barrier, because any in-band sync has the same race.
    try:
        barrier.wait(timeout=30.0)
    except Exception:
        q.put((rank, "warm-barrier-failed", rt.last_error()))
        return
    if rank == victim:
        os.kill(os.getpid(), signal.SIGKILL)  # no cleanup, mid-world
    # the post-crash op can surface the death at either API point:
    # enqueue itself raising "lost connection" (the background loop
    # already observed the dead transport) or a successful enqueue
    # whose handle polls FAILED. Both are the non-hang contract this
    # test asserts; which one a survivor sees is a pure timing race.
    try:
        h2 = rt.enqueue("after", native.OP_ALLREDUCE, "float32", [4])
    except RuntimeError as e:
        q.put((rank, rt_mod_FAILED, str(e)))
        return
    deadline = time.time() + 45.0
    state = rt.poll(h2)
    while state in (0, 1) and time.time() < deadline:
        batch = rt.next_batch(timeout_s=0.2)
        if batch is not None:
            rt.batch_done(batch, ok=True)
        state = rt.poll(h2)
    q.put((rank, state, rt.last_error()))
    # do NOT rt.shutdown(): the broken world's negotiated shutdown can't
    # complete; the background loop already exited via the error path


def _run_crash_world(size, victim, timeout_s=90.0):
    port = _free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    barrier = ctx.Barrier(size)
    procs = [
        ctx.Process(target=_worker_crash,
                    args=(r, size, port, victim, q, barrier))
        for r in range(size)
    ]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + timeout_s
    while len(results) < size - 1 and time.time() < deadline:
        try:
            rank, state, err = q.get(timeout=1.0)
            results[rank] = (state, err)
        except Exception:
            pass
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.terminate()
    return results


def test_worker_crash_mid_cycle_errors_survivors():
    """kill -9 a worker rank between collectives: every survivor's next
    op must FAIL with the lost-connection error, not hang (reference
    controller.cc:252-270)."""
    out = _run_crash_world(3, victim=2)
    assert sorted(out) == [0, 1], f"survivors missing: {out}"
    for r in (0, 1):
        state, err = out[r]
        assert state == rt_mod_FAILED, f"rank {r} state={state} err={err}"
        assert "lost connection" in err or "rank 2" in err, err


def test_coordinator_crash_errors_workers():
    """kill -9 the coordinator: workers' transport fails and their
    pending ops raise instead of blocking forever."""
    out = _run_crash_world(3, victim=0)
    assert sorted(out) == [1, 2], f"survivors missing: {out}"
    for r in (1, 2):
        state, err = out[r]
        assert state == rt_mod_FAILED, f"rank {r} state={state} err={err}"
        assert "lost connection" in err, err


# ------------------------------------------------- Bayesian autotune


def test_bayesian_tuner_finds_optimum():
    """The GP+EI searcher (bayes.cc — role parity with the reference's
    optim/bayesian_optimization.cc) localizes the maximum of a smooth
    2-D objective within a kernel length scale in ~15 samples."""
    import ctypes

    native = _load_native()
    lib = native.load()
    dims = 2
    lib.hvd_bayes_test_create(dims)
    try:
        buf = (ctypes.c_double * dims)()

        def objective(x0, x1):
            return -((x0 - 0.7) ** 2) - (x1 - 0.3) ** 2

        for _ in range(15):
            lib.hvd_bayes_test_next(buf, dims)
            x = list(buf)
            assert all(0.0 <= v <= 1.0 for v in x), x
            lib.hvd_bayes_test_observe(buf, dims, objective(*x))
        lib.hvd_bayes_test_best(buf, dims)
        best = list(buf)
        # optimum is (0.7, 0.3) with value 0; random search over 15
        # points would miss this bar most of the time
        assert objective(*best) > -0.02, best
    finally:
        lib.hvd_bayes_test_free()


# ------------------------------------------------- dtypes and the build


def test_dtype_codes_round_trip_through_torch():
    """Every dtype code maps to its torch.dtype and back, the JAX
    package's code for the same name; bfloat16 (code 10, which numpy
    lacks) round-trips as torch.bfloat16 without numpy."""
    import torch

    jax_native = _load_native(
        os.path.join(os.path.dirname(os.path.dirname(_NATIVE_DIR)),
                     "horovod_tpu", "_native"), "hvd_jax_native_codes")
    native = _load_native()
    assert native.DTYPE_CODES == jax_native._NUMPY_TO_DTYPE
    for code, name in native.DTYPE_NAMES.items():
        dt = native.torch_dtype(code)
        assert isinstance(dt, torch.dtype) and str(dt) == f"torch.{name}"
        assert native.dtype_code(dt) == native.dtype_code(name) == code
    assert native.torch_dtype(10) is torch.bfloat16
    assert native.dtype_code(torch.bfloat16) == 10
    with pytest.raises(ValueError):
        native.dtype_code(torch.complex64)


def _build_and_run(native_dir, q):
    """Build the library of a copy of the package and run one
    negotiated allreduce on it."""
    try:
        native = _load_native(native_dir, "hvd_torch_native_copy")
        path = native.build()
        rt = native.NativeRuntime()
        rt.init(0, 1, cycle_ms=1.0)
        h = rt.enqueue("solo", native.OP_ALLREDUCE, "bfloat16", [4])
        batch = rt.next_batch(timeout_s=5.0)
        rt.batch_done(batch, ok=True)
        state = rt.wait(h, timeout_s=5.0)
        rt.shutdown()
        q.put(("ok", path, state, batch.dtype))
    except Exception as e:
        q.put(("err", repr(e), None, None))


def test_two_processes_building_at_once(tmp_path):
    """Two processes that find no library build it at once: they queue
    on the build's lock file, one compiles into a temporary name and
    moves the library into place, both load a whole library and run;
    no temporary directory is left, and a source newer than the
    library marks it stale."""
    pkg = tmp_path / "checkout" / "horovod_tpu_torch"
    shutil.copytree(_NATIVE_DIR, pkg / "_native",
                    ignore=shutil.ignore_patterns("__pycache__"))
    native_dir = str(pkg / "_native")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_build_and_run, args=(native_dir, q))
             for _ in range(2)]
    for p in procs:
        p.start()
    results = [q.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(timeout=10)
    lib = str(tmp_path / "checkout" / "build" / "native"
              / "libhvd_torch_core.so")
    for status, path, state, code in results:
        assert status == "ok", path
        assert path == lib and state == rt_mod_DONE and code == 10
    left = os.listdir(os.path.dirname(lib))
    assert sorted(left) == [".lock", "libhvd_torch_core.so"], left
    native = _load_native(native_dir, "hvd_torch_native_stale")
    assert not native._stale()
    src = os.path.join(native_dir, "hvd", "common.h")
    later = os.path.getmtime(lib) + 10
    os.utime(src, (later, later))
    assert native._stale()


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes build() raise, naming the sources it
    failed on; no library is left behind to load, and nothing falls
    back."""
    pkg = tmp_path / "checkout" / "horovod_tpu_torch"
    shutil.copytree(_NATIVE_DIR, pkg / "_native",
                    ignore=shutil.ignore_patterns("__pycache__"))
    compiler = tmp_path / "cxx"
    compiler.write_text("#!/bin/sh\necho 'error: no compiler here'\n"
                        "exit 1\n")
    compiler.chmod(0o755)
    monkeypatch.setenv("CXX", str(compiler))
    native = _load_native(str(pkg / "_native"), "hvd_torch_native_broken")
    with pytest.raises(RuntimeError, match="wire.cc:\nerror: no compiler"):
        native.build()
    assert not os.path.exists(native.LIB_PATH)
    with pytest.raises(RuntimeError, match="build failed"):
        native.NativeRuntime()
