"""The port's autotuner (``horovod_tpu_torch/ops/autotune.py``) held
against the JAX package's (``horovod_tpu/ops/autotune.py``) on the CPU.

Winners are chosen through an injected clock, never wall time: each
candidate step advances a shared counter by a cost that is a function
of the knobs the tuner applied, and the clock reads the counter, so
both packages see the same step times and must produce the same trial
rows, pinned configuration, CSV log text and cache entry (but its
``time_unix``, ``fingerprint`` and ``topology``), for every combination
of the OnlineTuner's optional dimensions and the SPMDStepTuner's. A
skewed rank is a skewed clock, not a sleep. Besides: the
ParameterManager on the same ``(bytes, perf_counter)`` sequence, cache
files read across the packages, the staleness contract, the JAX
package's no-JAX cases (the failing candidate, the all-failing
dimension, the decision trail and its parseable JSONL, the numerics
opt-in), the wait on a candidate's CUDA outputs, the health monitor's
baseline from the port's cache, and the world-2 agreement as a gloo
world of two.
"""

import itertools
import json
import os
import subprocess
import sys

import pytest
import torch

import horovod_tpu.ops.autotune as jat
from horovod_tpu.core.knobs import Knobs as JKnobs
from horovod_tpu.utils import metrics as jmetrics
from horovod_tpu_torch.core.knobs import Knobs
from horovod_tpu_torch.ops import autotune as at
from horovod_tpu_torch.utils import flight, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: step seconds by fusion threshold (a threshold absent costs 1.1)
_THRESHOLD_COST = {128 << 20: 1.0, 1 << 20: 0.9, 4 << 20: 0.7,
                   16 << 20: 0.8}


def _cost(k) -> float:
    """A candidate's step seconds as a function of the knobs applied:
    every dimension moves it, some candidates win and some lose."""
    return (_THRESHOLD_COST.get(k.fusion_threshold_bytes, 1.1)
            + (0.0 if k.ordered_buckets else -0.05)
            + {"off": 0.03, "stage": 0.0, "double": 0.01}[k.overlap_schedule]
            + (-0.02 * k.hierarchical_local_size
               if k.hierarchical_allreduce else 0.0)
            + 0.004 * k.fsdp_prefetch
            + (0.002 if k.fused_collectives else 0.0)
            + {"none": 0.06, "bf16": 0.03, "int8": 0.0,
               "fp16": 0.05, "int8-raw": 0.01}[k.compression]
            + 1e-5 * k.compression_block
            + 1e-3 * k.eager_fast_path_warmup)


class _Clocked:
    """A shared clock and a step factory whose step advances it by
    :func:`_cost` of the knobs: the same times in both packages."""

    def __init__(self, knobs):
        self.knobs, self.now, self.builds = knobs, 0.0, []

    def clock(self):
        return self.now

    def factory(self, overrides):
        self.builds.append(dict(overrides))

        def step():
            self.now += _cost(self.knobs)

        return step


def _loopback(best, best_t):
    return best, best_t


def _run(mod, knobs, tmp, name, spmd=False, **flags):
    clocked = _Clocked(knobs)
    log = str(tmp / f"{name}.csv")
    cache = str(tmp / f"{name}.json")
    common = dict(thresholds=[1 << 20, 4 << 20, 16 << 20], warmup=1,
                  measure=2, log_path=log, agree_fn=_loopback,
                  clock=clocked.clock)
    if spmd:
        tuner = mod.SPMDStepTuner(knobs, hier_blocks=[2, 4],
                                  wire_candidates=["none", "int8", "bf16"],
                                  **common, **flags)
        pinned = tuner.tune(clocked.factory)
        entry = None
    else:
        tuner = mod.OnlineTuner(
            knobs, hier_blocks=[2, 4], prefetch_depths=[0, 1, 2],
            wire_candidates=["none", "int8", "bf16"],
            block_candidates=[128, 256, 512], warmup_k_candidates=[1, 3, 8],
            cache_path=cache, fingerprint="fp-parity", **common, **flags)
        pinned = tuner.tune(clocked.factory)
        with open(cache) as f:
            data = json.load(f)
        (entry,) = data.pop("entries").values()
        entry = {k: v for k, v in entry.items()
                 if k not in ("time_unix", "fingerprint", "topology")}
        entry["envelope"] = data
    with open(log) as f:
        text = f.read()
    return {"trials": tuner.trials, "pinned": pinned, "log": text,
            "entry": entry, "builds": clocked.builds,
            "knobs": {k: getattr(knobs, k) for k in at.TUNABLE_KNOBS},
            "compiles": tuner.compiles}


_ONLINE_FLAGS = ("tune_ordered", "tune_overlap", "tune_hierarchical",
                 "tune_fsdp_prefetch", "tune_fused_collectives", "tune_wire")
_ONLINE_COMBOS = list(itertools.product((False, True), repeat=6))


@pytest.mark.parametrize(
    "combo", _ONLINE_COMBOS,
    ids=["".join("1" if f else "0" for f in c) for c in _ONLINE_COMBOS])
def test_online_tuner_matches_jax(combo, tmp_path):
    """Same clock, same flags: the JAX package's trial rows, pins, log
    text, cache entry, candidate builds and knobs."""
    flags = dict(zip(_ONLINE_FLAGS, combo))
    mine = _run(at, Knobs(), tmp_path, "port", **flags)
    theirs = _run(jat, JKnobs(), tmp_path, "jax", **flags)
    assert mine == theirs
    assert mine["entry"]["schema"] == at.KNOB_SCHEMA_VERSION
    assert mine["entry"]["knobs"] == sorted(mine["pinned"])
    # the sweep moved off the incumbent's 128 MiB
    assert mine["pinned"]["fusion_threshold_bytes"] == 4 << 20


_SPMD_FLAGS = ("tune_ordered", "tune_hierarchical", "tune_wire")
_SPMD_COMBOS = list(itertools.product((False, True), repeat=3))


@pytest.mark.parametrize(
    "combo", _SPMD_COMBOS,
    ids=["".join("1" if f else "0" for f in c) for c in _SPMD_COMBOS])
def test_spmd_step_tuner_matches_jax(combo, tmp_path):
    flags = dict(zip(_SPMD_FLAGS, combo))
    mine = _run(at, Knobs(), tmp_path, "port", spmd=True, **flags)
    theirs = _run(jat, JKnobs(), tmp_path, "jax", spmd=True, **flags)
    assert mine == theirs
    assert "# pinned," in mine["log"]


@pytest.mark.parametrize("warmup,per_sample", [(0, 1), (2, 3)])
def test_parameter_manager_matches_jax(warmup, per_sample, tmp_path,
                                       monkeypatch):
    """The same ``(bytes, perf_counter)`` sequence under a patched
    clock: the same candidate walk, scores, pin and log."""
    import time

    now = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    runs = []
    for mod, knobs in ((at, Knobs()), (jat, JKnobs())):
        knobs.autotune = True
        knobs.autotune_warmup_samples = warmup
        knobs.autotune_steps_per_sample = per_sample
        knobs.autotune_log = str(tmp_path / f"{mod.__name__}.csv")
        now[0] = 0.0
        pm = mod.ParameterManager(knobs)
        walk = []
        for i in range(400):
            now[0] += 0.01 + 0.001 * ((i * 7) % 11)
            pm.observe((1 << 20) + 4096 * ((i * 13) % 17))
            walk.append(pm.fusion_threshold_bytes())
        with open(knobs.autotune_log) as f:
            runs.append((walk, pm._log_rows, pm._pinned,
                         pm.fusion_threshold_bytes(), f.read()))
    assert runs[0] == runs[1]
    assert runs[0][2] and "# pinned," in runs[0][4]


def test_cache_files_read_across_packages(tmp_path):
    """A file either package's TuneCache writes is read by the other,
    under the same key text."""
    topo = {"world": 4, "mesh_axes": {"dp": 2, "tp": 2}, "dcn_hops": 1}
    assert at.cache_key("fp", topo) == jat.cache_key("fp", topo) == \
        "fp|w4|dp=2,tp=2|dcn1"
    flat = {"world": 1, "mesh_axes": {}, "dcn_hops": 0}
    assert at.cache_key("fp", flat) == jat.cache_key("fp", flat)
    entry = {"config": {"fusion_threshold_bytes": 4 << 20,
                        "overlap_schedule": "stage"},
             "schema": at.KNOB_SCHEMA_VERSION, "step_s": 0.5,
             "time_unix": 2.0}
    for writer, reader in ((at, jat), (jat, at)):
        path = str(tmp_path / f"{writer.__name__}.json")
        writer.TuneCache(path).store(at.cache_key("fp", topo), entry)
        assert reader.TuneCache(path).lookup(
            reader.cache_key("fp", topo)) == entry
        assert reader.TuneCache(path).lookup_fingerprint("fp") == entry
    with open(tmp_path / f"{at.__name__}.json") as f:
        mine = f.read()
    with open(tmp_path / f"{jat.__name__}.json") as f:
        assert f.read() == mine


def test_stale_entries_miss_in_both(tmp_path):
    """A stale schema, an unknown knob or a malformed entry misses in
    both packages, with a flight record of why."""
    path = str(tmp_path / "c.json")
    entries = {
        "schema": {"config": {"fusion_threshold_bytes": 1 << 20},
                   "schema": at.KNOB_SCHEMA_VERSION + 1},
        "unknown": {"config": {"cycle_time_ms": 2.0},
                    "schema": at.KNOB_SCHEMA_VERSION},
        "malformed": {"schema": at.KNOB_SCHEMA_VERSION},
    }
    for k, e in entries.items():
        at.TuneCache(path).store(k, e)
    flight.reset()
    flight.enable()
    try:
        for mod in (at, jat):
            for k in entries:
                assert mod.TuneCache(path).lookup(k) is None, (mod, k)
        # (seq, monotonic, wall, kind, name, detail): the port's three
        # (the JAX package's go to its own recorder)
        names = [e[4] for e in flight.snapshot() if e[3] == "autotune"]
        assert names == ["cache_stale"] * 3
    finally:
        flight.reset()


def test_stale_schema_retunes_loudly(tmp_path):
    cache = str(tmp_path / "cache.json")
    knobs = Knobs()
    key = at.cache_key("fp-a")
    at.TuneCache(cache).store(key, {
        "config": {"fusion_threshold_bytes": 1 << 20},
        "schema": at.KNOB_SCHEMA_VERSION + 1, "time_unix": 1.0})
    clocked = _Clocked(knobs)
    t = at.OnlineTuner(knobs, thresholds=[knobs.fusion_threshold_bytes],
                       warmup=0, measure=1, tune_ordered=False,
                       tune_overlap=False, cache_path=cache,
                       fingerprint="fp-a", clock=clocked.clock)
    t.tune(clocked.factory)
    assert t.pin_source == "sweep" and clocked.builds
    entry = at.TuneCache(cache).lookup(key)
    assert entry is not None and entry["schema"] == at.KNOB_SCHEMA_VERSION


def test_warm_start_zero_builds_and_fingerprint_miss(tmp_path):
    cache = str(tmp_path / "cache.json")
    knobs = Knobs()
    c1 = _Clocked(knobs)
    t1 = at.OnlineTuner(knobs, thresholds=[1 << 20, 4 << 20], warmup=0,
                        measure=1, cache_path=cache, fingerprint="fp-a",
                        clock=c1.clock)
    cfg = t1.tune(c1.factory)
    assert t1.pin_source == "sweep" and t1.compiles == len(c1.builds) > 0

    def must_not_build(overrides):
        raise AssertionError("a warm start builds nothing")

    knobs2 = Knobs()
    t2 = at.OnlineTuner(knobs2, thresholds=[1 << 20, 4 << 20], warmup=0,
                        measure=1, cache_path=cache, fingerprint="fp-a")
    assert t2.tune(must_not_build) == cfg
    assert t2.compiles == 0 and t2.pin_source == "cache"
    assert knobs2.fusion_threshold_bytes == cfg["fusion_threshold_bytes"]
    # another fingerprint is another model: a whole sweep
    knobs3 = Knobs()
    c3 = _Clocked(knobs3)
    t3 = at.OnlineTuner(knobs3, thresholds=[1 << 20], warmup=0, measure=1,
                        cache_path=cache, fingerprint="fp-other",
                        clock=c3.clock)
    t3.tune(c3.factory)
    assert t3.pin_source == "sweep" and c3.builds


def test_failing_candidate_is_a_trial_row():
    """A candidate that fails to build (an out-of-memory threshold) is an
    error trial, the knobs are restored, and the dimension goes on to
    its agreement point (the JAX package's
    ``test_spmd_tuner_survives_failing_candidate``)."""
    knobs = Knobs()
    agreements = []

    def agree(best, best_t):
        agreements.append(dict(best))
        return best, best_t

    clocked = _Clocked(knobs)

    def factory(overrides):
        if overrides["fusion_threshold_bytes"] == 2 << 20:
            raise MemoryError("candidate OOM")
        return clocked.factory(overrides)

    tuner = at.SPMDStepTuner(
        knobs=knobs,
        thresholds=[knobs.fusion_threshold_bytes, 2 << 20, 1 << 20],
        warmup=0, measure=1, tune_ordered=True, agree_fn=agree,
        clock=clocked.clock)
    best = tuner.tune(factory)
    errs = [r for r in tuner.trials if "error" in r]
    assert len(errs) == 1
    assert errs[0]["fusion_threshold_bytes"] == 2 << 20
    assert "MemoryError" in errs[0]["error"]
    assert any(r.get("fusion_threshold_bytes") == 1 << 20
               and "step_s" in r for r in tuner.trials)
    assert best["fusion_threshold_bytes"] == 1 << 20
    assert knobs.fusion_threshold_bytes == best["fusion_threshold_bytes"]
    assert len(agreements) == 2  # thresholds + ordered flip


def test_all_failing_dimension_pins_incumbent():
    knobs = Knobs()
    incumbent = knobs.fusion_threshold_bytes

    def factory(overrides):
        raise RuntimeError("nothing builds today")

    tuner = at.SPMDStepTuner(knobs=knobs, thresholds=[incumbent, 1 << 20],
                             warmup=0, measure=1, tune_ordered=False)
    best = tuner.tune(factory)
    assert best["fusion_threshold_bytes"] == incumbent
    assert knobs.fusion_threshold_bytes == incumbent
    assert tuner.compiles == 0


@pytest.fixture
def trail(tmp_path):
    """Metrics on, the StepStats JSONL at a temporary path, in both
    packages; reset after."""
    jsonl = tmp_path / "steps.jsonl"
    for mod in (metrics, jmetrics):
        mod.reset()
        mod.enable()
    metrics.step_stats.open_log(str(jsonl))
    flight.reset()
    flight.enable()
    yield jsonl
    for mod in (metrics, jmetrics):
        mod.reset()
    flight.reset()


def _events(jsonl, **parse):
    return [json.loads(line, **parse)["autotune"]
            for line in jsonl.read_text().splitlines()
            if json.loads(line, **parse).get("event") == "autotune"]


def test_decision_trail(trail, capsys):
    """Every trial and pin lands in the registry, as ``autotune`` event
    lines in the StepStats JSONL (in the JAX package's order and
    content) and as flight records; ``tools.metrics_summary`` renders
    the sweep."""
    from horovod_tpu_torch.tools import metrics_summary

    knobs = Knobs()
    clocked = _Clocked(knobs)
    t = at.OnlineTuner(knobs, thresholds=[knobs.fusion_threshold_bytes,
                                          1 << 20],
                       warmup=0, measure=2, clock=clocked.clock)
    t.tune(clocked.factory)
    snap = metrics.registry.snapshot()
    assert sum(snap["hvd_autotune_trials_total"].values()) == len(t.trials)
    assert "hvd_autotune_best_step_s" in snap
    assert snap["hvd_autotune_dimension"]["fusion_threshold_bytes"] == \
        float(knobs.fusion_threshold_bytes)
    assert not metrics.lint_exposition(metrics.scrape())
    metrics.step_stats.close_log()
    events = _events(trail)
    assert {e["kind"] for e in events} >= {"trial", "pin"}
    finals = [e for e in events if e["dimension"] == "final"]
    assert finals and finals[-1]["config"] == t.pinned
    # the JAX package's trail for the same clock, event for event
    jsonl = trail.parent / "jax.jsonl"
    jmetrics.step_stats.open_log(str(jsonl))
    jknobs = JKnobs()
    jclocked = _Clocked(jknobs)
    jat.OnlineTuner(jknobs, thresholds=[jknobs.fusion_threshold_bytes,
                                        1 << 20],
                    warmup=0, measure=2,
                    clock=jclocked.clock).tune(jclocked.factory)
    jmetrics.step_stats.close_log()
    assert _events(jsonl) == events
    recs = [e for e in flight.snapshot() if e[3] == "autotune"]
    assert [r[4] for r in recs] == [e["kind"] for e in events
                                    if e["kind"] != "trial"]
    assert flight.last_autotune()["dimension"] == "final"
    capsys.readouterr()
    metrics_summary.summarize_autotune(events)
    table = capsys.readouterr().out
    assert "autotune sweep (decision trail)" in table
    assert table.count(" trial ") == len(t.trials)


def test_all_failing_sweep_emits_parseable_jsonl(trail):
    """An all-failed sweep keeps the incumbent and leaks no Infinity
    into the JSONL (json.dumps would write a bare non-RFC token)."""
    knobs = Knobs()

    def factory(overrides):
        raise RuntimeError("nothing builds")

    cfg = at.OnlineTuner(knobs, thresholds=[knobs.fusion_threshold_bytes,
                                            1 << 20],
                         warmup=0, measure=1).tune(factory)
    assert cfg["fusion_threshold_bytes"] == Knobs().fusion_threshold_bytes
    metrics.step_stats.close_log()

    def no_constants(name):
        raise AssertionError(f"non-RFC JSON token {name} in JSONL")

    pins = [e for e in _events(trail, parse_constant=no_constants)
            if e["kind"] in ("pin", "reject")]
    assert pins and all(p["step_s"] is None for p in pins)
    errs = metrics.registry.snapshot()["hvd_autotune_trial_errors_total"]
    # two thresholds, the ordered flip, the two overlap modes not the
    # incumbent's
    assert errs == {"fusion_threshold_bytes": 2.0, "ordered_buckets": 1.0,
                    "overlap_schedule": 2.0}


def test_warm_start_numerics_opt_in(tmp_path):
    """Cached numerics-changing winners transfer only under the opt-in,
    in both packages alike."""
    cache = str(tmp_path / "cache.json")
    params = {"w": torch.zeros(8, 8)}
    from horovod_tpu_torch.ops.fusion import model_fingerprint

    fp = model_fingerprint(params)
    at.TuneCache(cache).store(at.cache_key(fp), {
        "config": {"fusion_threshold_bytes": 1 << 20,
                   "compression": "int8", "compression_block": 128,
                   "eager_fast_path_warmup": 8},
        "schema": at.KNOB_SCHEMA_VERSION, "step_s": 0.001,
        "time_unix": 1.0})
    knobs = Knobs()
    assert at.warm_start(params, knobs, cache_path=cache) == {
        "fusion_threshold_bytes": 1 << 20}
    assert knobs.compression == "none"
    knobs2 = Knobs()
    cfg = at.warm_start(params, knobs2, cache_path=cache,
                        allow_numerics=True)
    assert cfg["compression"] == "int8"
    assert (knobs2.compression, knobs2.compression_block,
            knobs2.eager_fast_path_warmup) == ("int8", 128, 8)
    # exact topology: the entry was stored under this process's key
    assert at.warm_start(params, Knobs(), cache_path=cache,
                         exact_topology=True) is not None
    assert at.warm_start({"w": torch.zeros(8, 9)}, Knobs(),
                         cache_path=cache) is None
    assert at.warm_start(params, Knobs()) is None  # no cache configured


def test_wait_synchronizes_the_devices_of_cuda_outputs(monkeypatch):
    """A candidate's step returns before the card is done: the tuner
    waits with ``torch.cuda.synchronize`` on each device of the step's
    CUDA outputs, and on nothing for CPU outputs."""
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)

    class OnCard(torch.Tensor):
        is_cuda = True

        @property
        def device(self):
            return torch.device("cuda", 1)

    card = torch.Tensor._make_subclass(OnCard, torch.zeros(2))
    at._block_until_ready({"loss": torch.zeros(()), "n": [3]})
    assert seen == []
    at._block_until_ready((torch.zeros(1), [card, card]))
    assert seen == [torch.device("cuda", 1)]
    # each timed iteration of a candidate waits before reading the clock
    knobs = Knobs()
    clock = []
    seen.clear()

    def factory(overrides):
        return lambda: (clock.append(len(seen)), card)[1]

    tuner = at.SPMDStepTuner(knobs, thresholds=[knobs.fusion_threshold_bytes],
                             warmup=1, measure=3, tune_ordered=False,
                             clock=lambda: float(len(seen)))
    tuner.tune(factory)
    assert len(seen) == 4  # once after the warm-up, once a measured step
    assert tuner.trials[0]["step_s"] == 1.0


def test_health_baseline_from_the_tuners_cache(tmp_path):
    """``health.configure`` reads its step-time baseline from a cache
    the port's tuner wrote (the newest entry's ``step_s``)."""
    from horovod_tpu_torch import health

    cache = str(tmp_path / "cache.json")
    knobs = Knobs()
    clocked = _Clocked(knobs)
    at.OnlineTuner(knobs, thresholds=[1 << 20, 4 << 20], warmup=0,
                   measure=1, cache_path=cache, fingerprint="fp-h",
                   clock=clocked.clock).tune(clocked.factory)
    with open(cache) as f:
        (entry,) = json.load(f)["entries"].values()
    assert health._load_autotune_baseline(cache) == (entry["step_s"], None)
    knobs.autotune_cache = cache
    try:
        health.configure(knobs, enabled_override=True, rank=0)
        assert health._step_det.baseline_step_s == entry["step_s"]
    finally:
        health.reset()
        metrics.reset()


def test_parameter_manager_observes_each_synchronize(monkeypatch, caplog):
    """``HOROVOD_AUTOTUNE=1`` without the eager runtime: ``init()``
    builds the ParameterManager; each ``synchronize()`` reports the
    plan's bucket bytes to it (at world 1 too); a plan given no
    threshold takes the manager's candidate; an explicit
    ``fusion_threshold_bytes`` while tuning says once that it masks the
    tuned one."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.optim import distributed

    for k in list(os.environ):
        if k.startswith(("HOROVOD_", "HVD_TPU_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(5 << 20))
    monkeypatch.setattr(distributed, "_TUNED_MASK_WARNED", [False])
    hvd.init(device="cpu")
    try:
        pm = global_state().parameter_manager
        assert isinstance(pm, at.ParameterManager)
        assert fusion._threshold_bytes() == pm.fusion_threshold_bytes() \
            == 4 << 20  # the candidate nearest 5 MiB
        lin = torch.nn.Linear(8, 4)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(lin.parameters(), lr=0.1),
            named_parameters=lin.named_parameters())
        for _ in range(3):
            lin(torch.ones(2, 8)).sum().backward()
            opt.step()
            opt.zero_grad()
        assert pm._steps_in_sample == 3
        assert pm._bytes_in_sample == 3 * (8 * 4 + 4) * 4
        from horovod_tpu_torch.utils.logging import get_logger

        logger = get_logger()  # init() stops it propagating
        logger.addHandler(caplog.handler)
        try:
            for _ in range(2):
                hvd.DistributedOptimizer(
                    torch.optim.SGD(lin.parameters(), lr=0.1),
                    named_parameters=lin.named_parameters(),
                    fusion_threshold_bytes=1024)
        finally:
            logger.removeHandler(caplog.handler)
        masked = [r for r in caplog.records
                  if "masks the tuner's pinned bucket size" in r.message]
        assert len(masked) == 1
    finally:
        hvd.shutdown()
    assert global_state().parameter_manager is None


_AGREE_WORKER = r'''
import json
import os
import sys

import torch

torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import autotune as at

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
knobs = hvd.Knobs()
now = [0.0]
builds = []
# rank 1's clock prefers the opposite threshold
cost = {0: {128 << 20: 0.004, 1 << 20: 0.0005},
        1: {128 << 20: 0.0005, 1 << 20: 0.004}}[r]


def factory(overrides):
    builds.append(dict(overrides))

    def step():
        now[0] += cost[knobs.fusion_threshold_bytes]

    return step


tuner = at.OnlineTuner(knobs, thresholds=[knobs.fusion_threshold_bytes,
                                          1 << 20],
                       warmup=0, measure=2, tune_overlap=False,
                       cache_path=os.path.join(out, f"cache{r}.json"),
                       fingerprint="w2", clock=lambda: now[0])
config = tuner.tune(factory)
local = {row["fusion_threshold_bytes"]: row["step_s"]
         for row in tuner.trials
         if row.get("dimension") == "fusion_threshold_bytes"}
res = {"config": config, "builds": builds,
       "local_argmin": min(local, key=local.get),
       "knob": knobs.fusion_threshold_bytes,
       "topology": at.topology_key(), "key": at.cache_key("w2")}
with open(os.path.join(out, f"rank{r}.json"), "w") as f:
    json.dump(res, f)
hvd.shutdown()
'''


def _spawn_world(code, tmp_path, n=2, timeout=120, extra_env=None):
    from horovod_tpu_torch.runner.util.network import find_free_port

    port = find_free_port()
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1", **(extra_env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def test_world2_agreement_pins_identical_winners(tmp_path):
    """A gloo world of two with rank 1's clock skewed the other way: each
    rank's own clock prefers another threshold, yet both pin rank 0's,
    through the default agreement (``broadcast_object`` over the world),
    build the same candidates in the same order, and only rank 0 writes
    the cache. The topology key counts the world's two ranks."""
    _spawn_world(_AGREE_WORKER, tmp_path)
    r0, r1 = (json.loads((tmp_path / f"rank{r}.json").read_text())
              for r in (0, 1))
    assert r0["local_argmin"] == 1 << 20
    assert r1["local_argmin"] == 128 << 20
    assert r0["config"] == r1["config"]
    assert r0["config"]["fusion_threshold_bytes"] == 1 << 20
    assert r0["knob"] == r1["knob"] == 1 << 20
    assert r0["builds"] == r1["builds"]
    assert r0["topology"] == {"world": 2, "mesh_axes": {"dp": 2},
                              "dcn_hops": 0}
    assert r0["key"] == r1["key"] == "w2|w2|dp=2|dcn0"
    assert (tmp_path / "cache0.json").exists()
    assert not (tmp_path / "cache1.json").exists()
    entry = at.TuneCache(str(tmp_path / "cache0.json")).lookup(r0["key"])
    assert entry["config"] == r0["config"]
