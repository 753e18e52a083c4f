"""The eager runtime's telemetry (ops/eager_runtime.py) against the JAX
package's.

The same scenario runs in a world of two processes of each package: the
JAX ``EagerRuntime`` on its loopback executor (the world of
``tests/test_eager_fastpath.py``), the port's on a ``DistExecutor`` over
gloo. Each rank turns metrics, the flight recorder and a timeline on,
runs ``WARMUP + STEADY`` steps of three allreduces and an allgather from
the same seeded numpy inputs (``enqueue_batch``, then ``synchronize`` of
each), and reports its exposition, its flight kinds and its timeline.

* the families, their types and label sets, and the counts that do not
  depend on how the controller fused a cycle (fused tensors and bytes,
  negotiated tensors, wire bytes, the plan cache's counters) are equal
  rank by rank; the outputs are equal bit for bit;
* the timeline holds a NEGOTIATE span for each negotiated tensor, an
  execution span for each tensor and one plan activation; the flight
  ring an enqueue for each tensor and one ``plan_activate``;
* a scrape in a loop beside the executing runtime (the provider takes
  the runtime's lock) neither deadlocks nor breaks the exposition;
* with metrics off the runtime stamps no enqueue time and leaves the
  registry empty (the disabled path, by structure);
* the stall abort lands in the metrics, the flight ring and the
  timeline.
"""

import collections
import json
import multiprocessing as mp
import os
import socket
import threading
import time

import numpy as np
import pytest

WARMUP = 3
STEADY = 4
STEPS = WARMUP + STEADY
_SPECS = (("g0", (64,), "allreduce"), ("g1", (16, 8), "allreduce"),
          ("g2", (33,), "allreduce"), ("g3", (5, 3), "allgather"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(step):
    rng = np.random.RandomState(step)
    return {n: rng.randn(*shape).astype(np.float32)
            for n, shape, _ in _SPECS}


def _parse(text):
    """Exposition -> {family: {"type", "samples": {(name, labels): v}}}."""
    fams, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            name, kind = line[7:].split(" ", 1)
            types[name] = kind
            fams[name] = {"type": kind, "samples": {}}
            continue
        if not line or line.startswith("#"):
            continue
        key, val = line.rsplit(" ", 1)
        name, _, labels = key.partition("{")
        fam = next(f for f in (name, name.rsplit("_", 1)[0])
                   if f in fams)
        fams[fam]["samples"][(name, labels.rstrip("}"))] = float(val)
    return fams


def _report(metrics, flight, timeline_path, outs):
    with open(timeline_path) as f:
        events = json.load(f)
    return {
        "exposition": metrics.scrape(),
        "flight": dict(collections.Counter(e[3] for e in flight.snapshot())),
        "timeline": dict(collections.Counter(
            f"{e['ph']}:{e['name']}" for e in events)),
        "outs": {k: [v.tolist() for v in vs] for k, vs in outs.items()},
    }


def _steps(rt, op_of, to_native, from_native):
    outs = collections.defaultdict(list)
    for step in range(STEPS):
        ins = _inputs(step)
        hs = rt.enqueue_batch([
            {"name": n, "tensor": to_native(ins[n]), "op": op_of[kind]}
            for n, _, kind in _SPECS])
        for (n, _, _), h in zip(_SPECS, hs):
            outs[n].append(from_native(rt.synchronize(h, timeout_s=60.0)))
    return outs


def _jax_rank(rank, size, port, tmp, q):
    try:
        import horovod_tpu as hvd
        from horovod_tpu._native import OP_ALLGATHER, OP_ALLREDUCE
        from horovod_tpu.ops.eager_runtime import EagerRuntime
        from horovod_tpu.utils import flight, metrics

        metrics.enable()
        flight.enable()
        path = os.path.join(tmp, f"jax{rank}.json")
        hvd.start_timeline(path, mark_cycles=True)
        rt = EagerRuntime(rank, size, "127.0.0.1", port, cycle_ms=1.0,
                          fast_path=True, fast_path_warmup=WARMUP,
                          wire=None)
        try:
            outs = _steps(rt, {"allreduce": OP_ALLREDUCE,
                               "allgather": OP_ALLGATHER},
                          lambda x: x, np.asarray)
            text = metrics.scrape()
        finally:
            rt.shutdown()
            hvd.stop_timeline()
        rep = _report(metrics, flight, path, outs)
        rep["exposition"] = text
        q.put((rank, "ok", rep))
    except Exception as e:  # pragma: no cover - surfaced by the parent
        import traceback

        q.put((rank, "err", repr(e) + traceback.format_exc()))


def _port_rank(rank, size, port, gloo_port, tmp, q):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch._native import OP_ALLGATHER, OP_ALLREDUCE
        from horovod_tpu_torch.ops.eager_runtime import (DistExecutor,
                                                         EagerRuntime)
        from horovod_tpu_torch.utils import flight, metrics

        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{gloo_port}",
            rank=rank, world_size=size)
        ex = DistExecutor(rank, size, dist.new_group(list(range(size))),
                          device="cpu", wire=None)
        metrics.enable()
        flight.enable()
        path = os.path.join(tmp, f"port{rank}.json")
        hvd.start_timeline(path, mark_cycles=True)
        rt = EagerRuntime(rank, size, "127.0.0.1", port, executor=ex,
                          cycle_ms=1.0, fast_path=True,
                          fast_path_warmup=WARMUP, wire=None)
        # scrapes in a loop beside the executing runtime: the provider
        # takes the runtime's lock, every record site a family's
        stop, scrapes, bad = threading.Event(), [0], []

        def scrape_loop():
            while not stop.is_set():
                problems = metrics.lint_exposition(metrics.scrape())
                if problems:
                    bad.append(problems[:3])
                scrapes[0] += 1

        scraper = threading.Thread(target=scrape_loop, daemon=True)
        scraper.start()
        try:
            outs = _steps(rt, {"allreduce": OP_ALLREDUCE,
                               "allgather": OP_ALLGATHER},
                          torch.from_numpy, lambda t: t.numpy())
            stop.set()
            scraper.join(timeout=10.0)
            text = metrics.scrape()
        finally:
            stop.set()
            rt.shutdown()
            hvd.stop_timeline()
        rep = _report(metrics, flight, path, outs)
        rep["exposition"] = text
        rep["scraper"] = {"alive": scraper.is_alive(),
                          "scrapes": scrapes[0], "bad": bad}
        dist.destroy_process_group()
        q.put((rank, "ok", rep))
    except Exception as e:  # pragma: no cover - surfaced by the parent
        import traceback

        q.put((rank, "err", repr(e) + traceback.format_exc()))


def _start(target, extra_args, size=2):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, size, port) + extra_args
                         + (q,)) for r in range(size)]
    for p in procs:
        p.start()
    return procs, q


def _collect(procs, q, timeout=120.0):
    out = {}
    try:
        deadline = time.monotonic() + timeout
        while len(out) < len(procs) and time.monotonic() < deadline:
            try:
                r, status, payload = q.get(timeout=1.0)
            except Exception:
                continue
            assert status == "ok", f"rank {r}: {payload}"
            out[r] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
    assert len(out) == len(procs), f"{len(out)}/{len(procs)} ranks reported"
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both packages' worlds, run side by side."""
    tmp = str(tmp_path_factory.mktemp("eager_metrics"))
    jax_world = _start(_jax_rank, (tmp,))
    port_world = _start(_port_rank, (_free_port(), tmp))
    try:
        jax_out = _collect(*jax_world)
    finally:
        port_out = _collect(*port_world)
    return jax_out, port_out


#: counts fixed by the scenario, whatever the controller fused a cycle
_EXACT = ("hvd_fused_tensors_total", "hvd_fused_batch_bytes_total",
          "hvd_wire_bytes_logical_total", "hvd_wire_bytes_sent_total",
          "hvd_eager_fast_path_hits_total",
          "hvd_eager_fast_path_steps_total",
          "hvd_eager_fast_path_activations_total",
          "hvd_eager_fast_path_invalidations_total",
          "hvd_eager_fast_path_active")


@pytest.mark.parametrize("rank", [0, 1])
def test_families_labels_and_counts_are_the_jax_runtimes(worlds, rank):
    jax_out, port_out = worlds
    j, p = _parse(jax_out[rank]["exposition"]), _parse(
        port_out[rank]["exposition"])
    assert sorted(p) == sorted(j)
    for name in j:
        assert p[name]["type"] == j[name]["type"], name
        assert sorted(p[name]["samples"]) == sorted(j[name]["samples"]), name
    for name in _EXACT:
        assert p[name]["samples"] == j[name]["samples"], name
    # negotiated tensors: the warm-up's, never the fast path's
    hits = p["hvd_eager_fast_path_hits_total"]["samples"][
        ("hvd_eager_fast_path_hits_total", "")]
    key = ("hvd_negotiation_seconds_count", "")
    assert 0 < hits < len(_SPECS) * STEPS
    assert p["hvd_negotiation_seconds"]["samples"][key] \
        == j["hvd_negotiation_seconds"]["samples"][key] \
        == len(_SPECS) * STEPS - hits
    # a timing is only present, not compared
    for name in ("hvd_batch_execution_seconds", "hvd_coord_cycles_total",
                 "hvd_timeline_activity_seconds"):
        assert p[name]["samples"], name
    assert jax_out[rank]["outs"] == port_out[rank]["outs"]


@pytest.mark.parametrize("rank", [0, 1])
def test_timeline_and_flight_are_the_jax_runtimes(worlds, rank):
    jax_out, port_out = worlds
    j, p = jax_out[rank], port_out[rank]
    spans = {k: v for k, v in p["timeline"].items()
             if k != "i:CYCLE_START"}
    assert spans == {k: v for k, v in j["timeline"].items()
                     if k != "i:CYCLE_START"}
    assert p["timeline"].get("i:CYCLE_START", 0) > 0
    negotiated = p["timeline"]["B:NEGOTIATE_ALLREDUCE"] \
        + p["timeline"]["B:NEGOTIATE_ALLGATHER"]
    fams = _parse(p["exposition"])
    assert negotiated == fams["hvd_negotiation_seconds"]["samples"][
        ("hvd_negotiation_seconds_count", "")]
    assert p["timeline"]["B:ALLREDUCE"] == 3 * STEPS
    assert p["timeline"]["B:ALLGATHER"] == STEPS
    assert p["timeline"]["i:PLAN_ACTIVATED"] == 1
    assert sorted(p["flight"]) == sorted(j["flight"])
    for kind in ("enqueue", "plan_activate"):
        assert p["flight"][kind] == j["flight"][kind], kind
    assert p["flight"]["enqueue"] == len(_SPECS) * STEPS
    assert p["flight"]["plan_activate"] == 1


@pytest.mark.parametrize("rank", [0, 1])
def test_scrapes_beside_the_runtime_neither_deadlock_nor_break(worlds,
                                                               rank):
    s = worlds[1][rank]["scraper"]
    assert not s["alive"] and s["scrapes"] > 0 and not s["bad"], s


def _loopback_steps(metrics_on):
    import torch

    from horovod_tpu_torch.ops.eager_runtime import EagerRuntime
    from horovod_tpu_torch.utils import metrics

    metrics.reset()
    if metrics_on:
        metrics.enable()
    rt = EagerRuntime(0, 1, cycle_ms=1.0, fast_path=True,
                      fast_path_warmup=WARMUP, wire=None)
    stamped = []
    orig = rt._native_enqueue_locked

    def spy(*a, **k):
        h = orig(*a, **k)
        stamped.append(h in rt._handle_ts)
        return h

    rt._native_enqueue_locked = spy
    try:
        for step in range(STEPS):
            x = torch.from_numpy(_inputs(step)["g0"])
            rt.synchronize(rt.allreduce_async("g0", x))
    finally:
        rt.shutdown()
    return stamped, metrics.registry.snapshot()


def test_disabled_runtime_stamps_nothing_and_records_nothing():
    from horovod_tpu_torch.utils import metrics

    try:
        stamped, snap = _loopback_steps(False)
        assert stamped and not any(stamped)
        assert snap == {} and metrics.scrape() == ""
        stamped, snap = _loopback_steps(True)
        assert all(stamped)
        assert snap["hvd_negotiation_seconds"][""]["count"] == len(stamped)
        assert snap["hvd_batch_execution_seconds"]["allreduce"]["count"] \
            == STEPS
    finally:
        metrics.reset()


class _BlockingExecutor:
    """A stuck data plane: blocks until the watchdog's abort."""

    wire = None

    def __init__(self):
        self.release = threading.Event()

    def __call__(self, batch, tensors):
        self.release.wait(timeout=30.0)
        return {}

    def abort(self):
        self.release.set()


def test_stall_abort_records_it_and_its_instant(tmp_path):
    """A collective stuck in the data plane: the watchdog's abort lands
    in ``hvd_stall_aborts_total``, the flight ring and the timeline (a
    STALL_ABORT instant on the tensor), as in the JAX runtime."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.exceptions import HorovodInternalError
    from horovod_tpu_torch.ops.eager_runtime import EagerRuntime
    from horovod_tpu_torch.utils import flight, metrics

    metrics.reset()
    flight.reset()
    metrics.enable()
    flight.enable()
    from horovod_tpu_torch.core.state import global_state

    saved = global_state().timeline
    path = str(tmp_path / "tl.json")
    hvd.start_timeline(path)
    rt = EagerRuntime(0, 1, cycle_ms=1.0, stall_abort_s=0.5,
                      executor=_BlockingExecutor(), fast_path=False)
    try:
        with pytest.raises(HorovodInternalError, match="stalled"):
            rt.synchronize(rt.allreduce_async("stuck", torch.ones(4)),
                           timeout_s=10.0)
        snap = metrics.registry.snapshot()
        kinds = [e[3] for e in flight.snapshot()]
    finally:
        rt.shutdown()
        hvd.stop_timeline()
        global_state().timeline = saved
        metrics.reset()
        flight.reset()
    assert snap["hvd_stall_aborts_total"][""] == 1
    assert kinds.count("enqueue") == 1 and "stall_abort" in kinds
    with open(path) as f:
        events = [(e["ph"], e["name"], e["tid"]) for e in json.load(f)]
    assert ("B", "NEGOTIATE_ALLREDUCE", "stuck") in events
    assert ("i", "STALL_ABORT", "stuck") in events
