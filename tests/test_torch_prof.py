"""The port's sampled step profiler (``horovod_tpu_torch/utils/prof.py``)
and its trace reader (``utils/kineto.py``) against the JAX package's
``utils/prof.py`` and ``utils/xplane.py``: the cases of
``tests/test_prof.py`` that reach no XLA.

* the interval math and the attribution, held exactly against
  ``xplane.merge_intervals``, ``_intersect``, ``attribute`` and
  ``attribute_by_plane`` on the same interval sets, drawn from a numpy
  seed;
* a Chrome trace's spans: the card's kernels, copies and sets, one
  plane a device, NCCL kernels as collectives, host operators only for
  a capture without a card;
* the cost contract under a fake clock and stubbed captures, step by
  step beside the JAX profiler under the same stubs: every-N, the duty
  cycle, the MFU gauge and its JSONL field, the attribution gauges,
  retention, disarm and shutdown, a requested sample;
* a real CPU ``torch.profiler`` capture through ``metrics.step()``: one
  sample with its sidecar and trace, a second window refused while one
  is open, a trace without work not counted as a sample;
* ``tools.trace_merge --xplane`` (the device leg) on the JAX test's
  timelines and flight dumps and a profiler sample, and
  ``tools.device_summary`` beside the JAX ``scripts/xplane_summary.py``
  on the same spans.
"""

import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from horovod_tpu.utils import flight as jflight
from horovod_tpu.utils import metrics as jmetrics
from horovod_tpu.utils import prof as jprof
from horovod_tpu.utils import xplane
from horovod_tpu_torch.tools import device_summary, trace_merge
from horovod_tpu_torch.utils import flight, kineto, metrics, prof

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_test_helpers():
    """The xplane encoder of the JAX package's ``tests/test_prof.py``."""
    spec = importlib.util.spec_from_file_location(
        "jax_test_prof", REPO / "tests" / "test_prof.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (prof, jprof, metrics, jmetrics, flight, jflight):
        mod.reset()
    yield
    for mod in (prof, jprof, metrics, jmetrics, flight, jflight):
        mod.reset()


# ---------------------------------------------------------------------------
# interval math and attribution, held against the JAX package
# ---------------------------------------------------------------------------

def _ops(rng, n, planes=("/device:GPU:0",)):
    """``n`` op spans on a µs grid (integers, so both packages' float
    sums are exact), some collective, over ``planes``."""
    out = []
    for _ in range(n):
        start = float(rng.randint(0, 2000))
        out.append({
            "name": "k", "cat": "kernel", "start_us": start,
            "dur_us": float(rng.randint(1, 300)),
            "collective": bool(rng.rand() < 0.3),
            "plane": planes[rng.randint(len(planes))],
        })
    out.sort(key=lambda o: o["start_us"])
    return out


@pytest.mark.parametrize("seed", range(6))
def test_interval_math_matches_jax(seed):
    rng = np.random.RandomState(seed)
    spans = [(float(a), float(a + rng.randint(-5, 200)))
             for a in rng.randint(0, 1000, size=40)]
    assert kineto.merge_intervals(spans) == xplane.merge_intervals(spans)
    a = xplane.merge_intervals(spans[:20])
    b = xplane.merge_intervals(spans[20:])
    assert kineto._intersect(a, b) == xplane._intersect(a, b)
    assert kineto.merge_intervals([]) == []


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("host_wall", [None, 4000.0])
def test_attribution_matches_jax(seed, host_wall):
    rng = np.random.RandomState(100 + seed)
    ops = _ops(rng, 60)
    assert kineto.attribute(ops, host_wall_us=host_wall) == \
        xplane.attribute(ops, host_wall_us=host_wall)
    multi = _ops(rng, 80, planes=("/device:GPU:0", "/device:GPU:1",
                                   "/device:GPU:2"))
    mine = kineto.attribute_by_plane(multi, host_wall_us=host_wall)
    assert mine == xplane.attribute_by_plane(multi, host_wall_us=host_wall)
    assert mine["planes"] == 3


def test_attribute_by_plane_sees_cross_card_stragglers():
    ops = [
        {"name": "gemm", "cat": "kernel", "start_us": 0.0, "dur_us": 100.0,
         "collective": False, "plane": "/device:GPU:0"},
        {"name": "ncclDevKernel_AllReduce", "cat": "kernel",
         "start_us": 0.0, "dur_us": 100.0, "collective": True,
         "plane": "/device:GPU:1"},
    ]
    assert kineto.attribute(ops)["measured_overlap_frac"] == 1.0
    attr = kineto.attribute_by_plane(ops)
    assert attr["measured_overlap_frac"] == 0.0
    assert attr["compute_frac"] == attr["exposed_wire_frac"] == 0.5
    solo = ops[:1]
    assert kineto.attribute_by_plane(solo) == kineto.attribute(solo)


# ---------------------------------------------------------------------------
# a Chrome trace's spans
# ---------------------------------------------------------------------------

def _chrome(events):
    return {"schemaVersion": 1, "traceEvents": events}


def _x(cat, name, ts, dur, device=0, stream=7, pid=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": device if pid is None else pid, "tid": stream,
            "args": {"device": device, "stream": stream}}


def _card_trace():
    """Card 0: a GEMM (0-100 µs) and an NCCL all-reduce over its tail
    (80-180 µs) on another stream, a memcpy and a memset; host operators
    and a GPU-side annotation that are not card work."""
    return _chrome([
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "python"}},
        _x("cpu_op", "aten::mm", 990.0, 500.0, pid=4242, stream=4242),
        _x("kernel", "spin_kernel", 900.0, 1.0),
        _x("kernel", "sm90_xmma_gemm_bf16", 1000.0, 100.0),
        _x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 1080.0,
           100.0, stream=20),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1180.0, 10.0),
        _x("gpu_memset", "Memset (Device)", 1190.0, 5.0),
        _x("gpu_user_annotation", "Optimizer.step", 1000.0, 195.0),
        _x("kernel", "zero_length", 1195.0, 0.0),
    ])


def test_op_events_selects_the_cards_work():
    ops = kineto.op_events(_card_trace(), skip=(prof.SPIN_KERNEL,))
    assert [o["name"] for o in ops] == [
        "sm90_xmma_gemm_bf16", "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
        "Memcpy DtoH (Device -> Pinned)", "Memset (Device)"]
    assert [o["collective"] for o in ops] == [False, True, False, False]
    assert {o["plane"] for o in ops} == {"/device:GPU:0"}
    assert ops[1]["line"] == "stream 20"
    attr = kineto.attribute(ops)
    # compute 0-100 and 100-115 µs, collective 80-180: 20 hidden
    assert attr["collective_us"] == 100.0
    assert attr["exposed_collective_us"] == 80.0
    assert attr["measured_overlap_frac"] == 0.2
    host = kineto.op_events(_card_trace(), device_ops=False)
    assert [o["name"] for o in host] == ["aten::mm"]
    assert host[0]["plane"] == "/host:CPU"


def test_collective_is_an_nccl_kernel():
    assert kineto.is_collective("ncclKernel_AllGather_RING_LL_Sum_int8_t")
    assert kineto.is_collective("ncclDevKernel_ReduceScatter_Sum_bf16")
    assert not kineto.is_collective("nccl_helper")
    assert not kineto.is_collective("all_reduce_kernel")


def test_load_trace_reads_the_newest_and_refuses_nothing(tmp_path):
    with pytest.raises(kineto.TraceUnavailable):
        kineto.load_trace(str(tmp_path / "none"))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(kineto.TraceUnavailable):
        kineto.load_trace(str(bad))
    d = tmp_path / "cap"
    d.mkdir()
    (d / "hvd_prof_meta.json").write_text("{}")
    old, new = d / "a.json", d / "b.json"
    old.write_text(json.dumps(_chrome([])))
    new.write_text(json.dumps(_card_trace()["traceEvents"]))  # bare array
    os.utime(old, (1, 1))
    trace, path = kineto.load_trace(str(d))
    assert path == str(new) and len(trace["traceEvents"]) == 9


def test_a_cpu_capture_holds_host_operators_only(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        (x @ x).relu().sum()
    path = str(tmp_path / "t.json")
    p.export_chrome_trace(path)
    trace, _ = kineto.load_trace(path)
    assert kineto.op_events(trace) == []
    host = kineto.op_events(trace, device_ops=False)
    assert "aten::matmul" in {o["name"] for o in host}
    assert kineto.attribute(host)["compute_us"] > 0


# ---------------------------------------------------------------------------
# the cost contract: fake clock, stubbed captures, beside the JAX profiler
# ---------------------------------------------------------------------------

def _stub_both(monkeypatch, clock, capture_cost_s=0.5, parse_cost_s=0.0):
    """Both packages' capture calls advance ``clock`` by
    ``capture_cost_s`` at start and at stop; the parse charges
    ``parse_cost_s``; no sidecar is written."""
    import jax

    def cost():
        clock[0] += capture_cost_s

    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: cost())
    monkeypatch.setattr(jax.profiler, "stop_trace", cost)
    monkeypatch.setattr(prof, "_start_capture",
                        lambda: (cost(), (None, False))[1])
    monkeypatch.setattr(prof, "_stop_capture", lambda token: cost())
    for mod in (prof, jprof):
        monkeypatch.setattr(
            mod, "_spawn_parse",
            lambda token, w, mod=mod: mod._finish_sample(
                token.capture_overhead_s + parse_cost_s))
        monkeypatch.setattr(mod, "_write_sidecar", lambda t, w: None)


def _both(fn):
    """``fn(mod, metrics_mod, clock)`` once a package, each on its own
    fake clock; the two results."""
    out = []
    for mod, mmod in ((prof, metrics), (jprof, jmetrics)):
        clock = [100.0]
        out.append(fn(mod, mmod, clock))
    return out


def test_off_by_default_and_no_wrapper_installed():
    from horovod_tpu_torch.core.knobs import Knobs

    prof.configure(Knobs())
    assert not prof.active() and metrics._step_wrapper is None
    with metrics.step():
        pass
    assert prof.summary()["steps"] == 0


def test_duty_cycle_gates_the_next_sample(monkeypatch, tmp_path):
    clock = [0.0]
    _stub_both(monkeypatch, clock)  # 0.5 s start + 0.5 s stop = 1.0 s

    def run(mod, mmod, _):
        clock[0] = 100.0
        mod.configure(every=1, duty_cycle=0.5, directory=str(tmp_path),
                      clock=lambda: clock[0])
        seen = []
        for idle in (0.0, 0.0, 1.0, 0.0, 2.5):
            clock[0] += idle
            with mmod.step():
                clock[0] += 0.1
            seen.append((mod.sample_count(), mod.overhead_s()))
        return seen

    mine, theirs = _both(run)
    assert mine == theirs
    # duty 0.5: after a 1.0 s sample the gate stays shut 1.0 s
    assert [n for n, _ in mine] == [1, 1, 2, 2, 3]
    assert mine[-1][1] == pytest.approx(3.0)


@pytest.mark.parametrize("every", [1, 2, 3])
def test_sampling_respects_every_n(monkeypatch, tmp_path, every):
    clock = [0.0]
    _stub_both(monkeypatch, clock, capture_cost_s=0.001)

    def run(mod, mmod, _):
        clock[0] = 0.0
        # duty 1.0: no floor, so the cadence alone decides
        mod.configure(every=every, duty_cycle=1.0,
                      directory=str(tmp_path), clock=lambda: clock[0])
        for _ in range(9):
            with mmod.step():
                clock[0] += 1.0
        return mod.summary()["steps"], mod.sample_count()

    mine, theirs = _both(run)
    assert mine == theirs == (9, 9 // every)


def test_mfu_gauge_and_jsonl(monkeypatch, tmp_path):
    """The same declared FLOPs and step time give the JAX package's MFU
    when both divide by the same peak; the gauge and the record carry
    it."""
    from horovod_tpu.utils import mfu as jmfu
    from horovod_tpu_torch.utils import mfu

    peak = jmfu.peak_flops_per_chip()
    monkeypatch.setattr(mfu, "peak_flops_per_chip", lambda: peak)

    def run(mod, mmod, clock):
        mmod.enable()
        log = str(tmp_path / f"{mod.__name__}.jsonl")
        mmod.step_stats.open_log(log)
        mod.configure(every=0, clock=lambda: clock[0])
        mod.set_step_flops(0.01 * peak * 0.010, n_chips=1)
        assert mod.active()  # MFU alone still needs the wrapper
        with mmod.step():
            clock[0] += 0.010
        mmod.step_stats.close_log()
        rec = json.loads(open(log).read().splitlines()[0])
        return (mod.last_mfu(), mmod.registry.snapshot()["hvd_mfu"][""],
                rec["mfu"])

    mine, theirs = _both(run)
    assert mine == theirs
    assert mine[0] == pytest.approx(0.01, rel=1e-6)


def test_no_mfu_without_a_known_peak():
    """Off a card the table knows (here: no card), MFU is not computed:
    no gauge, no record field; a guessed peak would be a number of
    nothing."""
    from horovod_tpu_torch.utils import mfu

    assert mfu.peak_flops_per_chip() is None
    assert mfu.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    metrics.enable()
    clock = [0.0]
    prof.configure(every=0, clock=lambda: clock[0])
    prof.set_step_flops(1e12, n_chips=1)
    with metrics.step() as st:
        clock[0] += 0.01
    assert prof.last_mfu() is None
    assert "hvd_mfu" not in metrics.registry.snapshot()
    assert st.mfu is None


def test_record_step_attribution_exports_jax_gauges():
    attr = {"compute_frac": 0.7, "exposed_wire_frac": 0.1,
            "idle_frac": 0.05, "measured_overlap_frac": 0.8,
            "sampled_step": 12}
    for mmod in (metrics, jmetrics):
        mmod.enable()
        mmod.record_step_attribution(attr)
    names = ("hvd_step_compute_frac", "hvd_step_exposed_wire_frac",
             "hvd_step_idle_frac", "hvd_overlap_window_measured_frac")
    mine, theirs = (metrics.registry.snapshot(),
                    jmetrics.registry.snapshot())
    assert {n: mine[n] for n in names} == {n: theirs[n] for n in names}
    assert mine["hvd_overlap_window_measured_frac"][""] == 0.8
    for mmod in (metrics, jmetrics):
        mmod.record_step_attribution({"compute_frac": 0.5})
    assert metrics.registry.snapshot()[
        "hvd_overlap_window_measured_frac"][""] == -1.0
    assert metrics.registry.render() == jmetrics.registry.render()


def test_sample_dir_retention(tmp_path):
    """Both packages keep the same newest eight capture directories, by
    mtime, of the same leftovers."""
    import time as _time

    kept = []
    for mod, sub in ((prof, "mine"), (jprof, "theirs")):
        mod.configure(every=1, directory=str(tmp_path / sub))
        root = mod.default_dir()
        os.makedirs(root)
        t0 = _time.time()
        for i, n in enumerate([101] + list(range(1, 13))):
            d = os.path.join(root, f"step{n}")
            os.makedirs(d)
            os.utime(d, (t0 + i, t0 + i))
        open(os.path.join(root, "not_a_step"), "w").close()
        mod._prune_samples()
        kept.append(sorted(os.listdir(root)))
    assert kept[0] == kept[1]
    assert sorted(int(d[4:]) for d in kept[0] if d.startswith("step")) \
        == [5, 6, 7, 8, 9, 10, 11, 12]


def test_disarm_returns_to_the_noop_path():
    for mod, mmod in ((prof, metrics), (jprof, jmetrics)):
        mod.configure(every=2, duty_cycle=0.5)
        assert mod.active() and mmod._step_wrapper is not None
        mod.configure(every=0)
        assert not mod.active() and mmod._step_wrapper is None
        mod.set_step_flops(100.0)
        assert mod.active() and mmod._step_wrapper is not None
        mod.set_step_flops(0.0)
        assert not mod.active() and mmod._step_wrapper is None
        with mmod.step():
            pass
        assert mod.summary()["steps"] == 0


def test_shutdown_removes_the_wrapper(monkeypatch, tmp_path):
    clock = [0.0]
    _stub_both(monkeypatch, clock, capture_cost_s=0.001)

    def run(mod, mmod, _):
        mod.configure(every=1, duty_cycle=0.9, directory=str(tmp_path),
                      clock=lambda: clock[0])
        with mmod.step():
            clock[0] += 0.01
        n = mod.sample_count()
        mod.on_shutdown()
        with mmod.step():
            clock[0] += 0.01
        return (n, mod.active(), mmod._step_wrapper,
                mod.summary()["steps"])

    mine, theirs = _both(run)
    assert mine == theirs == (1, False, None, 1)


def test_request_sample_forces_the_next_step(monkeypatch, tmp_path):
    clock = [0.0]
    _stub_both(monkeypatch, clock, capture_cost_s=0.001)

    def run(mod, mmod, _):
        mod.configure(every=0, directory=str(tmp_path),
                      clock=lambda: clock[0])
        mod.request_sample("anomaly:test")
        mmod.enable()
        with mmod.step():
            pass
        forced = (mod.sample_count(), mod._force_next, mod.active())
        with mmod.step():
            pass
        return forced, mod.sample_count()

    mine, theirs = _both(run)
    assert mine == theirs == ((1, False, False), 1)


# ---------------------------------------------------------------------------
# a real capture on the CPU
# ---------------------------------------------------------------------------

def test_cpu_capture_end_to_end(tmp_path, monkeypatch):
    """Two steps at every 2, duty 1.0: step 2 is captured, its sidecar
    and trace written, its host operators attributed, its MFU kept
    (against a stand-in peak: no card here), and trace_merge places its
    spans."""
    from horovod_tpu_torch.utils import mfu

    monkeypatch.setattr(mfu, "peak_flops_per_chip", lambda: 1e12)
    metrics.enable()
    prof.configure(every=2, duty_cycle=1.0, directory=str(tmp_path))
    prof.set_step_flops(2.0 * 128 ** 3, n_chips=1)
    x = torch.randn(128, 128)
    for _ in range(2):
        with metrics.step():
            (x @ x).sum().item()
        prof.join(timeout_s=30.0)
    s = prof.summary()
    assert (s["samples"], s["errors"], s["steps"]) == (1, 0, 2)
    attr = prof.last_attribution()
    assert attr["sampled_step"] == 2 and attr["compute_frac"] > 0
    assert attr["host_wall_us"] > 0 and "mfu" in attr
    sample = os.path.join(prof.default_dir(), "step2")
    assert sorted(os.listdir(sample)) == ["hvd_prof_meta.json",
                                          prof.TRACE_FILE]
    meta = json.load(open(os.path.join(sample, "hvd_prof_meta.json")))
    assert meta["rank"] == flight.rank() and meta["step"] == 2
    assert meta["t_stop_unix"] >= meta["t_start_unix"]
    snap = metrics.registry.snapshot()
    assert snap["hvd_step_compute_frac"][""] == attr["compute_frac"]
    sm = trace_merge.load_prof_sample(sample)
    # no rank set (-1): the tool reads it from the rank<r> directory
    assert sm["rank"] == max(meta["rank"], 0) and sm["events"]


def test_open_window_makes_a_sample_an_error(tmp_path):
    """One process holds one profiler window: a sampled step inside a
    caller's window counts an error, is no sample, and raises
    nothing."""
    from torch.profiler import ProfilerActivity, profile

    prof.configure(every=1, duty_cycle=1.0, directory=str(tmp_path))
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.step():
            torch.ones(4).sum()
    prof.join()
    s = prof.summary()
    assert (s["samples"], s["errors"], s["steps"]) == (0, 1, 1)
    with metrics.step():  # the caller's window closed: captured
        torch.ones(4).sum()
    prof.join(timeout_s=30.0)
    assert prof.summary()["samples"] == 1


def test_a_trace_without_work_is_not_a_sample(tmp_path, monkeypatch):
    """A capture whose trace holds no device work (the CUDA window that
    lost its records) is an error, not a sample, and leaves no
    attribution."""
    prof.configure(every=1, duty_cycle=1.0, directory=str(tmp_path))

    def empty(token):
        token.capture.stop()
        with open(os.path.join(token.logdir, prof.TRACE_FILE), "w") as f:
            json.dump(_chrome([]), f)

    monkeypatch.setattr(prof, "_stop_capture", empty)
    with metrics.step():
        torch.ones(4).sum()
    prof.join(timeout_s=30.0)
    s = prof.summary()
    assert (s["samples"], s["errors"]) == (0, 1)
    assert prof.last_attribution() is None


def test_a_window_that_lost_its_spins_is_refused(tmp_path):
    """On a card the window opens with spins; a trace that kept none of
    them is refused, even though it holds kernels."""
    token = prof._Token(0.0, 0.0, str(tmp_path), 3)
    token.cuda = True
    trace = _card_trace()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e.get("name") != "spin_kernel"]
    with open(tmp_path / prof.TRACE_FILE, "w") as f:
        json.dump(trace, f)
    with pytest.raises(kineto.TraceUnavailable, match="spins"):
        prof._parse_sample(token, 0.001)
    with open(tmp_path / prof.TRACE_FILE, "w") as f:
        json.dump(_card_trace(), f)
    prof._parse_sample(token, 0.001)
    assert prof.last_attribution()["ops"] == 4  # the spin left out


# ---------------------------------------------------------------------------
# the tools: trace_merge's device leg, device_summary
# ---------------------------------------------------------------------------

def _write_prof_sample(d, rank, t0_unix, offset_s, trace):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "hvd_prof_meta.json"), "w") as f:
        json.dump({"hvd_prof_meta": 1, "rank": rank, "step": 2,
                   "t_start_unix": t0_unix,
                   "t_stop_unix": t0_unix + 0.2,
                   "clock_offset_s": offset_s}, f)
    with open(os.path.join(d, prof.TRACE_FILE), "w") as f:
        json.dump(trace, f)


def test_trace_merge_aligns_ranks_and_the_card(tmp_path, capsys):
    """The JAX test's sources with a profiler sample of rank 0: the
    ranks on one clock, the card's spans as X completes; without the
    sample the port's merge is the JAX script's."""
    jt = _jax_test_helpers()
    t0 = 1_700_000_000.0
    jt._write_timeline(str(tmp_path / "tl_rank0.json"), 0, t0,
                       [("STEP", 0.0, "B"), ("STEP", 100.0, "E")])
    jt._write_timeline(str(tmp_path / "tl_rank1.json"), 1, t0 - 2.0,
                       [("STEP", 50.0, "B"), ("STEP", 150.0, "E")])
    jt._write_flight(str(tmp_path / "flight_rank0.jsonl"), 0, t0, 0.0)
    jt._write_flight(str(tmp_path / "flight_rank1.jsonl"), 1, t0 - 2.0,
                     2.0)
    _write_prof_sample(str(tmp_path / "prof" / "rank0" / "step2"), 0,
                       t0 + 0.001, 0.0, _card_trace())
    host = ["--timeline", str(tmp_path / "tl_rank0.json"),
            "--timeline", str(tmp_path / "tl_rank1.json"),
            "--flight", str(tmp_path / "flight_rank0.jsonl"),
            "--flight", str(tmp_path / "flight_rank1.jsonl")]
    merged, report_p = str(tmp_path / "m.json"), str(tmp_path / "r.json")
    assert trace_merge.main(host + ["--xplane", str(tmp_path / "prof"),
                                    "--out", merged,
                                    "--json", report_p]) == 0
    capsys.readouterr()
    report = json.load(open(report_p))
    assert report["ranks"] == [0, 1]
    assert report["by_source"] == {
        "rank0/host": 2, "rank1/host": 2,
        "rank0/flight": 1, "rank1/flight": 1,
        "rank0/device": 4,
    }
    evs = [e for e in json.load(open(merged))["traceEvents"]
           if e["ph"] != "M"]
    b0 = next(e for e in evs if e["pid"] == 0 and e["name"] == "STEP"
              and e["ph"] == "B")
    b1 = next(e for e in evs if e["pid"] == 1 and e["name"] == "STEP"
              and e["ph"] == "B")
    assert b1["ts"] - b0["ts"] == pytest.approx(50.0, abs=1.0)
    dev = [e for e in evs if e["tid"].startswith("device:")]
    assert all(e["ph"] == "X" and e["dur"] > 0 for e in dev)
    coll = next(e for e in dev if e["name"].startswith("nccl"))
    assert coll["cat"] == "collective" and coll["tid"] == "device:stream 20"
    # the first card span sits at the sidecar's start, the rest after it
    gemm = next(e for e in dev if e["name"].startswith("sm90"))
    assert coll["ts"] - gemm["ts"] == pytest.approx(80.0, abs=1.0)
    # the host leg alone: the JAX script's trace and report
    theirs = _script("trace_merge")
    mine_out, their_out = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert trace_merge.main(host + ["--out", mine_out]) == 0
    mine_rep = json.loads(capsys.readouterr().out)
    assert theirs.main(host + ["--out", their_out]) == 0
    their_rep = json.loads(capsys.readouterr().out)
    mine_rep.pop("out"), their_rep.pop("out")
    assert mine_rep == their_rep
    mine, their = json.load(open(mine_out)), json.load(open(their_out))
    mine["metadata"].pop("tool"), their["metadata"].pop("tool")
    assert mine == their


def test_trace_merge_skips_a_sample_without_its_anchor(tmp_path, capsys):
    d = str(tmp_path / "rank0" / "step2")
    _write_prof_sample(d, 0, 1_700_000_000.0, 0.0, _card_trace())
    with open(os.path.join(d, "hvd_prof_meta.json"), "w") as f:
        f.write('{"hvd_prof_meta": 1, "rank": 0')  # torn
    assert trace_merge.load_prof_sample(d) is None
    assert "wall anchor" in capsys.readouterr().err
    assert trace_merge.main(["--xplane", str(tmp_path),
                             "--out", str(tmp_path / "o.json")]) == 1


def test_device_summary_matches_xplane_summary(tmp_path, capsys):
    """The JAX test's capture (a fusion 0-100 µs, an all-reduce over its
    tail, 80-180 µs) as an xplane for ``scripts/xplane_summary.py`` and
    as a Chrome trace for the port: the same attribution, busy and wall
    time."""
    jt = _jax_test_helpers()
    pb = tmp_path / "x" / "host.xplane.pb"
    pb.parent.mkdir()
    pb.write_bytes(jt._tpu_capture_bytes())
    chrome = tmp_path / "trace.json"
    chrome.write_text(json.dumps(_chrome([
        _x("kernel", "fusion.1", 1000.0, 100.0),
        _x("kernel", "ncclDevKernel_AllReduce_Sum", 1080.0, 100.0),
    ])))
    theirs_out, mine_out = tmp_path / "t.json", tmp_path / "m.json"
    assert _script("xplane_summary").main(
        [str(pb), "--json", str(theirs_out)]) == 0
    assert device_summary.main([str(chrome), "--json", str(mine_out),
                                "--attribute"]) == 0
    out = capsys.readouterr().out
    assert "exposed wire 44.4%" in out
    theirs, mine = json.load(open(theirs_out)), json.load(open(mine_out))
    assert mine["attribution"] == theirs["attribution"]
    (tp,), (mp,) = theirs["planes"], mine["planes"]
    for k in ("wall_us", "busy_us", "idle_frac"):
        assert mp[k] == pytest.approx(tp[k])
    assert mine["op_events"] == theirs["op_events"] == 2
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps(_chrome([])))
    assert device_summary.main([str(empty)]) == 1
