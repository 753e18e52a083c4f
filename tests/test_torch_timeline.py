"""The port's host timeline (horovod_tpu_torch.utils.timeline) against the
JAX package's (horovod_tpu.utils.timeline):

* the same seeded sequence of spans, instants and cycle marks gives the
  same Chrome trace events (timestamps and pids masked), the clock
  anchor first; the 8,192-entry span table evicts the same entries and
  bridges the same spans into the metrics;
* the writer drains in order, restarts into a fresh trace, and its file
  is well-formed JSON after ``stop``;
* the collective layer's ``XLA_COLLECTIVE`` spans and the fusion
  plan's ``FUSION_PLAN`` instant, through ``hvd.start_timeline`` and
  through ``HOROVOD_TIMELINE`` at ``init``;
* ``close`` writes the JAX ``close``'s closed array, once;
* ``profiler_trace`` is a ``torch.profiler`` trace written into its
  directory (the JAX package's traces XLA: a deliberate difference).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.utils import flight as jflight
from horovod_tpu.utils import metrics as jmetrics
from horovod_tpu.utils import timeline as jtimeline
from horovod_tpu_torch.utils import flight, metrics, timeline

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (metrics, jmetrics, flight, jflight):
        mod.reset()
    yield
    for mod in (metrics, jmetrics, flight, jflight):
        mod.reset()


def _events(path):
    with open(path) as f:
        evs = json.load(f)
    assert isinstance(evs, list)
    for ev in evs:
        assert {"ph", "name", "ts", "pid", "tid"} <= set(ev)
    return evs


def _masked(evs):
    out = []
    for ev in evs:
        ev = dict(ev)
        ev.pop("ts")
        ev.pop("pid")
        if ev["name"] == "CLOCK_ANCHOR":
            args = dict(ev["args"])
            assert args.pop("pid") == os.getpid()
            assert abs(args.pop("time_unix") - time.time()) < 60
            ev["args"] = args
        out.append(ev)
    return out


def _drive(mod, path, seed, mark_cycles):
    rng = np.random.RandomState(seed)
    tl = mod.Timeline(path, mark_cycles=mark_cycles)
    open_spans = []
    for i in range(300):
        k = rng.randint(5)
        tensor = f"grad_{rng.randint(6)}"
        if k == 0:
            act = ("ALLREDUCE", "NEGOTIATE_ALLREDUCE", "QUEUE")[
                rng.randint(3)]
            tl.activity_start(tensor, act,
                              {"bytes": int(rng.randint(1, 99))}
                              if rng.rand() < 0.5 else None)
            open_spans.append((tensor, act))
        elif k == 1 and open_spans:
            tl.activity_end(*open_spans.pop(rng.randint(len(open_spans))))
        elif k == 2:
            tl.instant(tensor, f"ev{i}", {"i": i})
        elif k == 3:
            tl.mark_cycle_start()
        else:
            with tl.activity(tensor, "XLA_COLLECTIVE"):
                pass
    tl.stop()
    return _events(path)


@pytest.mark.parametrize("seed,mark_cycles", [(0, False), (1, True)])
def test_same_sequence_gives_the_jax_events(seed, mark_cycles, tmp_path):
    for mod in (metrics, jmetrics):
        mod.enable()
    mine = _drive(timeline, str(tmp_path / "mine.json"), seed, mark_cycles)
    theirs = _drive(jtimeline, str(tmp_path / "theirs.json"), seed,
                    mark_cycles)
    assert _masked(mine) == _masked(theirs)
    assert mine[0]["name"] == "CLOCK_ANCHOR"
    assert any(e["name"] == "CYCLE_START" for e in mine) == mark_cycles
    # the metrics bridge saw the same closed spans
    counts = {k: v["count"] for k, v in metrics.registry.snapshot()[
        "hvd_timeline_activity_seconds"].items()}
    assert counts == {k: v["count"] for k, v in jmetrics.registry.snapshot()[
        "hvd_timeline_activity_seconds"].items()}


def test_span_table_evicts_as_the_jax_table(tmp_path):
    tables = []
    for mod, met in ((timeline, metrics), (jtimeline, jmetrics)):
        met.enable()
        tl = mod.Timeline(str(tmp_path / f"{mod.__name__}.json"))
        for i in range(8192):
            tl.activity_start(f"t{i}", "PHASE")
        assert len(tl._span_starts) == 8192
        tl.activity_start("t8192", "PHASE")
        tables.append(list(tl._span_starts))
        # an evicted span's end records nothing; a surviving one does
        tl.activity_end("t0", "PHASE")
        tl.activity_end("t8192", "PHASE")
        tl.stop()
        (fam,) = [v for k, v in met.registry.snapshot().items()
                  if k == "hvd_timeline_activity_seconds"]
        assert sum(v["count"] for v in fam.values()) == 1
    assert tables[0] == tables[1]
    assert len(tables[0]) == 8192 - 1024 + 1
    assert ("t0", "PHASE") not in tables[0]
    assert (timeline.SPAN_TABLE_MAX, timeline.SPAN_EVICT) == (8192, 1024)


def test_writer_drains_in_order_and_restarts(tmp_path):
    t_before = time.time()
    first, second = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    tl = timeline.Timeline(first)
    for i in range(500):
        tl.instant("t", f"ev{i}", {"i": i})
    tl.stop()
    assert not tl.active
    tl.instant("t", "dropped_while_stopped")
    tl.start(second)
    assert tl.active
    tl.instant("t", "only_in_second")
    tl.stop()
    evs = _events(first)
    anchor = evs[0]
    assert anchor["name"] == timeline.CLOCK_ANCHOR
    assert t_before <= anchor["args"]["time_unix"] <= time.time()
    assert isinstance(anchor["args"]["rank"], int)
    assert [e["name"] for e in evs[1:]] == [f"ev{i}" for i in range(500)]
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)
    assert [e["name"] for e in _events(second)] == [
        timeline.CLOCK_ANCHOR, "only_in_second"]


def test_close_writes_the_jax_closed_array(tmp_path):
    """``close`` (the JAX package's name, which its ``shutdown()``
    calls) on an active timeline writes the same closed JSON array as
    the JAX ``close``; a second close does nothing."""
    traces = []
    for mod in (timeline, jtimeline):
        path = str(tmp_path / f"{mod.__name__}.json")
        tl = mod.Timeline(path)
        with tl.activity("grad", "ALLREDUCE"):
            tl.instant("grad", "FUSION_PLAN", {"buckets": 1})
        tl.close()
        assert not tl.active
        with open(path) as f:
            text = f.read()
        tl.close()
        with open(path) as f:
            assert f.read() == text
        traces.append(_masked(json.loads(text)))
    assert traces[0] == traces[1]
    assert [e["name"] for e in traces[0]] == [
        timeline.CLOCK_ANCHOR, "ALLREDUCE", "FUSION_PLAN", "ALLREDUCE"]


def test_collectives_and_the_fusion_plan_emit_events(tmp_path):
    trace = str(tmp_path / "timeline.json")
    hvd.init(device="cpu")
    try:
        hvd.start_timeline(trace)
        hvd.allreduce(torch.ones(4), op=hvd.Sum)
        hvd.allgather(torch.ones(2, 2))
        hvd.grouped_allreduce([torch.ones(3), torch.ones(5)], op=hvd.Sum)
        model = torch.nn.Linear(4, 3)
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=1),
                                 named_parameters=model.named_parameters())
        hvd.stop_timeline()
    finally:
        hvd.shutdown()
    evs = _events(trace)
    spans = [e for e in evs if e["name"] == "XLA_COLLECTIVE"]
    assert [(e["ph"], e["tid"]) for e in spans] == [
        ("B", "allreduce"), ("E", "allreduce"),
        ("B", "allgather"), ("E", "allgather"),
        ("B", "allreduce"), ("E", "allreduce")]
    fusion = [e for e in evs if e["name"] == timeline.FUSION_PLAN]
    assert len(fusion) == 1 and fusion[0]["ph"] == "i"
    assert fusion[0]["args"] == {"tensors": 2, "buckets": 1,
                                 "threshold_bytes": 128 << 20}


def test_timeline_knob_writes_from_init_and_shutdown_closes(tmp_path,
                                                            monkeypatch):
    trace = str(tmp_path / "knob.json")
    monkeypatch.setenv("HOROVOD_TIMELINE", trace)
    monkeypatch.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    hvd.init(device="cpu")
    try:
        from horovod_tpu_torch.core.state import global_state

        tl = global_state().timeline
        assert tl.active and timeline.active_timeline() is tl
        tl.mark_cycle_start()
        hvd.broadcast(torch.ones(2), root_rank=0)
    finally:
        hvd.shutdown()
    evs = _events(trace)  # closed by shutdown: a whole JSON array
    assert evs[0]["name"] == timeline.CLOCK_ANCHOR
    assert evs[0]["args"]["rank"] == 0  # the world's rank
    names = [e["name"] for e in evs]
    assert "CYCLE_START" in names and "XLA_COLLECTIVE" in names


def test_profiler_trace_writes_a_torch_profiler_trace(tmp_path):
    logdir = str(tmp_path / "prof")
    with timeline.profiler_trace(logdir):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
