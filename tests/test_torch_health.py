"""The port's fleet-health monitor (``horovod_tpu_torch/health/``)
against the JAX package's ``horovod_tpu/health/``: the twin of
``tests/test_health.py`` whole. The same step records, serving samples,
rule specs and rank summaries go through both packages, and the rule
transitions, verdicts, anomalies and fleet evaluations must be equal:

* the disabled path: nothing observed, the verdict "off", and no
  observer installed in the metrics slots (held by structure: the
  observers are never reached, and a disabled observe takes no lock);
* burn-rate window math, envelope hysteresis, rule parsing and its loud
  failures, the rule engine's transitions;
* the detectors' classification on the same records;
* the fleet evaluator's straggler, outlier and silent-rank verdicts;
* alert transitions to incident records, the exposition's gauges, a
  flight dump and a requested profiler sample;
* the metrics observers, the serving burn rules, the SLO-labeled
  serving histograms;
* ``GET /health`` on the port's rendezvous store (a round clears it)
  and on ``ServingServer``, and the knobs through ``init()``;
* a world of two publishers (the JAX package's slow ``health_check``
  gate, in process): the store names the slow rank.
"""

import json
import time
import urllib.request

import numpy as np
import pytest

from horovod_tpu import health as jhealth
from horovod_tpu.health import detectors as jdetectors
from horovod_tpu.health import fleet as jfleet
from horovod_tpu.health import rules as jrules
from horovod_tpu.utils import flight as jflight
from horovod_tpu.utils import metrics as jmetrics
from horovod_tpu.utils import prof as jprof
from horovod_tpu_torch import health
from horovod_tpu_torch.health import detectors, fleet, rules
from horovod_tpu_torch.utils import flight, metrics, prof

#: (health, rules, detectors, fleet, metrics, flight, prof) of each
#: package
MINE = (health, rules, detectors, fleet, metrics, flight, prof)
THEIRS = (jhealth, jrules, jdetectors, jfleet, jmetrics, jflight, jprof)
BOTH = (MINE, THEIRS)


@pytest.fixture(autouse=True)
def _fresh():
    for pkg in BOTH:
        for mod in (pkg[0], pkg[4], pkg[5], pkg[6]):
            mod.reset()
    yield
    for pkg in BOTH:
        for mod in (pkg[0], pkg[4], pkg[5], pkg[6]):
            mod.reset()


def _both(fn):
    """``fn(package tuple)`` for the port and for the JAX package."""
    return fn(MINE), fn(THEIRS)


def _no_time(x):
    """``x`` without its wall-clock stamps (they differ between two
    calls)."""
    if isinstance(x, dict):
        return {k: _no_time(v) for k, v in x.items()
                if k not in ("time_unix", "age_s")}
    if isinstance(x, list):
        return [_no_time(v) for v in x]
    return x


# ------------------------------------------------------------ no-op path

def test_disabled_observes_nothing():
    def run(p):
        h = p[0]
        assert not h.enabled()
        h.observe_step({"step": 1, "step_time_s": 9.0})
        h.observe_serving("ttft", "interactive", 9.0)
        return h.verdict(), h.incident_count()

    mine, theirs = _both(run)
    assert mine == theirs == ({"health": "off", "alerts_active": 0}, 0)


def test_disabled_overhead_held_by_structure(monkeypatch):
    """The JAX ``test_disabled_overhead_under_1us_per_call`` by
    structure, not by a clock: disabled, the metrics slots hold no
    observer (an instrumented step never reaches the monitor), and a
    direct observe returns at its gate: it takes no lock and touches no
    detector, engine or anomaly list."""
    assert not health.enabled()
    assert metrics._step_observer is None
    assert metrics._serving_observer is None

    class _Refuse:
        def __getattr__(self, name):
            raise AssertionError(f"disabled observe touched .{name}")

        def __enter__(self):
            raise AssertionError("disabled observe took the lock")

    for name in ("_lock", "_step_det", "_serving_det", "_engine",
                 "_recent_anomalies"):
        monkeypatch.setattr(health, name, _Refuse())
    for _ in range(1000):
        health.observe_step({"step": 1, "step_time_s": 0.01})
        health.observe_serving("ttft", "interactive", 0.01)
    metrics.enable()
    with metrics.step():
        pass
    metrics.record_serving_ttft(0.01, slo="interactive")


# ------------------------------------------------------------ burn rate

def _burn_trace(p, samples):
    """Feed ``(dt, value)`` samples to a BurnRate on a fake clock; its
    readings after each phase."""
    t = [1000.0]
    br = p[1].BurnRate(target_s=0.5, objective=0.99, fast_s=30.0,
                       slow_s=300.0, clock=lambda: t[0])
    out = []
    for n, value in samples:
        for _ in range(n):
            t[0] += 1.0
            br.observe(value)
        out.append((br.burn(30.0), br.burn(300.0), br.firing(),
                     br.cleared(), br.state(True), br.snapshot()))
    return out


def test_burn_rate_window_math():
    phases = [(50, 0.1), (400, 2.0), (35, 0.1)]
    mine, theirs = _both(lambda p: _burn_trace(p, phases))
    assert mine == theirs
    assert mine[0][0] == 0.0 and not mine[0][2]
    assert mine[1][0] == pytest.approx(100.0) and mine[1][2]
    assert mine[2][0] < 1.0 and mine[2][3] and mine[2][4] is False


def test_burn_rate_fires_only_on_both_windows():
    mine, theirs = _both(lambda p: _burn_trace(p, [(288, 0.1),
                                                   (12, 2.0)]))
    assert mine == theirs
    fast, slow, firing = mine[-1][:3]
    assert fast >= 14.4 and slow < 6.0 and not firing


@pytest.mark.parametrize("seed", range(4))
def test_burn_rate_on_seeded_streams(seed):
    rng = np.random.RandomState(seed)
    phases = [(int(n), float(v)) for n, v in zip(
        rng.randint(1, 120, size=8), rng.choice([0.1, 0.4, 0.6, 2.0],
                                                size=8))]
    mine, theirs = _both(lambda p: _burn_trace(p, phases))
    assert mine == theirs


def test_burn_rate_rejects_bad_objective():
    for p in BOTH:
        with pytest.raises(p[1].RuleSpecError):
            p[1].BurnRate(target_s=0.5, objective=1.0)


# ------------------------------------------------------------ envelope

def _envelope_trace(p, values, **kw):
    env = p[1].Envelope(**kw)
    out, firing = [], False
    for v in values:
        env.observe(v)
        firing = env.state(currently_firing=firing)
        out.append((firing, env.snapshot()))
    return out


def test_envelope_hysteresis():
    values = [0.1] * 6 + [1.0, 1.0, 0.1, 0.1, 0.1]
    kw = dict(factor=1.5, window=16, min_samples=4, breach_n=2, clear_n=3)
    mine, theirs = _both(lambda p: _envelope_trace(p, values, **kw))
    assert mine == theirs
    assert [f for f, _ in mine] == [False] * 7 + [True, True, True, False]


def test_envelope_drop_side():
    kw = dict(drop=0.3, window=16, min_samples=4, breach_n=1, clear_n=1)
    mine, theirs = _both(
        lambda p: _envelope_trace(p, [1.0] * 5 + [0.5], **kw))
    assert mine == theirs and mine[-1][0]


# ------------------------------------------------------------ rule parsing

def test_default_rules_parse():
    def run(p):
        return [(r.name, r.kind, r.signal, r.slo, r.params, r.classes())
                for r in p[1].parse_rules(p[1].DEFAULT_RULES)]

    mine, theirs = _both(run)
    assert mine == theirs
    assert [k for _, k, *_ in mine].count("envelope") == 2
    assert dict((n, c) for n, *_, c in mine)["step_time_envelope"] == (
        "straggler-host",)


@pytest.mark.parametrize("spec", [
    "noname",                                    # no kind
    "x:watch:signal=ttft",                       # unknown kind
    "x:burn:signal=ttft",                        # burn without target
    "x:burn:target=0.5",                         # no signal
    "x:envelope:signal=mfu",                     # envelope without bound
    "x:burn:signal=ttft:target=abc",             # non-numeric
    "x:burn:signal=ttft:garbage",                # not key=value
])
def test_malformed_rules_fail_loudly(spec):
    msgs = []
    for p in BOTH:
        with pytest.raises(p[1].RuleSpecError) as ei:
            p[1].parse_rules(spec)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_rule_engine_transitions():
    def run(p):
        t = [0.0]
        eng = p[1].RuleEngine(p[1].parse_rules(
            "env:envelope:signal=step_time:factor=1.5:min=3:breach=1"
            ":clear=2"), clock=lambda: t[0])
        out = []
        for v in (0.1, 0.1, 0.1, 0.1, 1.0, 0.1, 0.1):
            eng.observe("step_time", v)
            out.append((eng.evaluate(), eng.active_count(),
                        eng.alert_summary()))
        return out

    mine, theirs = _both(run)
    assert mine == theirs
    assert [tr[0]["state"] for tr, *_ in mine if tr] == ["fire", "clear"]
    assert mine[4][0][0]["classes"] == ["straggler-host"]


# ------------------------------------------------------------ detectors

def _detect(p, warm, last, n=10, dt=0.01, **kw):
    det = p[2].StepDetectors(**kw)
    for i in range(n):
        det.update({"step": i, "step_time_s": dt, **warm})
    out = [det.update(r) for r in last]
    return out, det.step_time_recent_s(), det.steps


_DETECTOR_CASES = {
    "straggler": ({}, [{"step": 99, "step_time_s": 0.1}], {}),
    "slow_link": ({"attribution": {"exposed_wire_frac": 0.1}},
                  [{"step": 99, "step_time_s": 0.1,
                    "attribution": {"exposed_wire_frac": 0.5}}], {}),
    "input_bound": ({"attribution": {"idle_frac": 0.05}},
                    [{"step": 99, "step_time_s": 0.1,
                      "attribution": {"idle_frac": 0.6}}], {}),
    "compute_regression": ({"mfu": 0.5},
                           [{"step": 99, "step_time_s": 0.1, "mfu": 0.1}],
                           {}),
    "retry_and_queue": ({"queue_depth": 1},
                        [{"step": 99, "step_time_s": 0.01,
                          "queue_depth": 8, "retries": {"http.put": 2},
                          "retry_giveups": {"http.put": 1}}],
                        {"retry_burst": 3, "queue_factor": 2.0}),
    "baseline": ({}, [{"step": 99, "step_time_s": 0.03}],
                 {"baseline_step_s": 0.01}),
    "spike_keeps_its_reference": ({}, [{"step": 98, "step_time_s": 0.1},
                                       {"step": 99, "step_time_s": 0.1}],
                                  {}),
}
_DETECTOR_CLASSES = {
    "straggler": [{"straggler-host"}],
    "slow_link": [{"slow-link"}],
    "input_bound": [{"input-bound"}],
    "compute_regression": [{"compute-regression"}],
    "retry_and_queue": [{"slow-link", "queue-saturation"}],
    "baseline": [{"straggler-host"}],
    "spike_keeps_its_reference": [{"straggler-host"}, {"straggler-host"}],
}


@pytest.mark.parametrize("case", sorted(_DETECTOR_CASES))
def test_detectors_classify_as_jax(case):
    warm, last, kw = _DETECTOR_CASES[case]
    dt = 0.03 if case == "baseline" else 0.01
    mine, theirs = _both(lambda p: _detect(
        p, warm, last, dt=dt, window=16, min_steps=4, **kw))
    assert mine == theirs
    assert [{a["class"] for a in out} for out in mine[0]] == \
        _DETECTOR_CLASSES[case]
    if case == "spike_keeps_its_reference":
        assert mine[0][1][0]["reference"] == pytest.approx(0.01)


@pytest.mark.parametrize("seed", range(4))
def test_detectors_on_seeded_records(seed):
    rng = np.random.RandomState(seed)
    recs = [{"step": i, "step_time_s": float(rng.choice([0.01, 0.012,
                                                         0.05])),
             "mfu": float(rng.choice([0.4, 0.45, 0.1])),
             "queue_depth": int(rng.randint(0, 6)),
             "attribution": {"exposed_wire_frac": float(rng.rand() / 2),
                             "idle_frac": float(rng.rand() / 2)}}
            for i in range(40)]

    def run(p):
        det = p[2].StepDetectors(window=16, min_steps=4)
        return [det.update(r) for r in recs], det.step_time_recent_s()

    mine, theirs = _both(run)
    assert mine == theirs
    assert any(mine[0])


def test_serving_detector_queue_wait_buildup():
    def run(p):
        det = p[2].ServingDetectors(window=32, factor=2.0, floor_s=0.05,
                                    min_samples=8)
        return [det.update_queue_wait(v) for v in [0.01] * 10 + [0.5] * 10]

    mine, theirs = _both(run)
    assert mine == theirs
    assert not any(mine[:10]) and mine[-1][0]["class"] == "queue-saturation"


# ------------------------------------------------------------ fleet view

def _summary(rank, now, recent=0.1, alerts=None):
    return {"rank": rank, "time_unix": now,
            "step_time_recent_s": recent, "steps": 20,
            "alerts": alerts or {}}


def _fleet_cases(now):
    ok = {r: _summary(r, now) for r in range(4)}
    self_rep = {r: _summary(r, now) for r in range(4)}
    self_rep[2]["alerts"] = {"step_time_envelope": {
        "active": True, "classes": ["straggler-host"]}}
    outlier = {r: _summary(r, now) for r in range(4)}
    outlier[3]["step_time_recent_s"] = 0.5
    silent = {r: _summary(r, now) for r in range(3)}
    silent[1]["time_unix"] = now - 60.0
    return {"ok": (ok, "ok", []), "self_reported": (self_rep, "degraded",
                                                    [2]),
            "outlier": (outlier, "degraded", [3]),
            "silent": (silent, "degraded", [1]), "empty": ({}, "unknown",
                                                           [])}


@pytest.mark.parametrize("case", ["ok", "self_reported", "outlier",
                                  "silent", "empty"])
def test_fleet_verdict_matches_jax(case):
    now = time.time()
    summaries, status, suspects = _fleet_cases(now)[case]
    mine, theirs = _both(lambda p: p[3].evaluate(summaries, now_unix=now))
    assert mine == theirs
    assert mine["status"] == status
    assert mine["suspected_straggler_ranks"] == suspects


def test_fleet_parses_like_jax_and_drops_garbage():
    pushed = {
        "0": json.dumps({"rank": 0, "time_unix": 1.0}).encode(),
        "1": b"\x80\x04not json",         # never unpickled, just dropped
        "2@podA": json.dumps({"time_unix": 1.0}).encode(),
    }
    mine, theirs = _both(lambda p: p[3].parse_summaries(pushed))
    assert mine == theirs
    assert set(mine) == {"0", "2@podA"}
    assert mine["2@podA"]["pod"] == "podA"
    assert _both(lambda p: p[3].evaluate_store(pushed, now_unix=2.0)) == \
        (jfleet.evaluate_store(pushed, now_unix=2.0),) * 2


# ------------------------------------------------ transitions + capture

_ENV_RULE = ("env:envelope:signal=step_time:factor=1.5:min=3:breach=1"
             ":clear=2")


def test_alert_fire_writes_incident_and_captures(tmp_path):
    def run(p):
        h, fl, pr = p[0], p[5], p[6]
        fl.enable()
        incident = str(tmp_path / f"{h.__name__}.jsonl")
        h.configure(enabled_override=True, rank=3, endpoint=None,
                    interval_s=60.0, rules=_ENV_RULE,
                    incident_file=incident, capture=True)
        verdicts = []
        for i, dt in enumerate([0.01] * 4 + [1.0] + [0.01] * 2):
            h.observe_step({"step": i, "step_time_s": dt})
            verdicts.append(h.verdict())
            if i == 4:
                dumps, forced = fl.dump_count(), pr._force_next
        with open(incident) as f:
            recs = [_no_time(json.loads(ln)) for ln in f if ln.strip()]
        return verdicts, dumps, forced, recs, h.incident_count()

    mine, theirs = _both(run)
    assert mine == theirs
    verdicts, dumps, forced, recs, n = mine
    assert verdicts[4] == {"health": "degraded", "alerts_active": 1,
                           "alerts": ["env"]}
    assert verdicts[-1]["health"] == "ok"
    assert dumps == 1 and forced
    assert [r["state"] for r in recs] == ["fire", "clear"]
    assert all(r["rank"] == 3 and r["rule"] == "env" for r in recs)
    assert n == 2


def test_incidents_land_in_the_step_log_as_events(tmp_path):
    """The transition is also an out-of-band event line of the step
    JSONL, which ``tools.metrics_summary`` and ``trace_merge`` read."""
    def run(p):
        h, m = p[0], p[4]
        m.enable()
        log = str(tmp_path / f"{h.__name__}.steps.jsonl")
        m.step_stats.open_log(log)
        h.configure(enabled_override=True, endpoint=None, interval_s=60.0,
                    rules=_ENV_RULE, capture=False)
        for dt in [0.01] * 4 + [1.0]:
            h.observe_step({"step": 0, "step_time_s": dt})
        m.step_stats.close_log()
        return [_no_time(json.loads(ln)) for ln in open(log)]

    mine, theirs = _both(run)
    assert mine == theirs
    (ev,) = mine
    assert ev["event"] == "incident" and ev["incident"]["state"] == "fire"


def test_alert_gauge_rides_the_exposition():
    def run(p):
        h, m = p[0], p[4]
        h.configure(enabled_override=True, endpoint=None, interval_s=60.0,
                    rules=_ENV_RULE, capture=False)
        for i in range(9):
            h.observe_step({"step": i, "step_time_s": 0.01})
        h.observe_step({"step": 9, "step_time_s": 1.0})
        _, body = m.exposition()
        return body.decode()

    mine, theirs = _both(run)
    assert mine == theirs
    assert 'hvd_alert_active{rule="env"} 1' in mine
    assert 'hvd_health_incidents_total{rule="env",state="fire"}' in mine
    assert "hvd_health_anomalies_total" in mine
    assert metrics.lint_exposition(mine) == []


def test_flight_anomaly_dump_rate_limited():
    def run(p):
        fl = p[5]
        fl.enable()
        return [fl.anomaly_dump(r, **kw) is not None for r, kw in (
            ("rule_a", {}), ("rule_a", {}), ("rule_b", {}),
            ("rule_a", {"min_interval_s": 0.0}))]

    mine, theirs = _both(run)
    assert mine == theirs == [True, False, True, True]


def test_prof_request_sample_forces_next_step(tmp_path, monkeypatch):
    monkeypatch.setattr(prof, "_start_capture", lambda: (None, False))
    monkeypatch.setattr(prof, "_stop_capture", lambda token: None)
    monkeypatch.setattr(prof, "_spawn_parse", lambda token, w:
                        prof._finish_sample(token.capture_overhead_s))
    prof.configure(every=0, directory=str(tmp_path))
    prof.request_sample("anomaly:test")
    metrics.enable()
    with metrics.step():
        pass
    assert prof.sample_count() >= 1
    assert not prof._force_next


# ------------------------------------------------ metrics-stream wiring

def test_step_observer_feeds_detectors():
    def run(p):
        h, m = p[0], p[4]
        m.enable()
        h.configure(enabled_override=True, endpoint=None,
                    interval_s=60.0, capture=False)
        for _ in range(3):
            with m.step():
                pass
        n = h.summary()["steps"]
        h.disable()
        with m.step():
            pass
        return n, h.summary()["steps"]

    mine, theirs = _both(run)
    assert mine == theirs == (3, 3)


def test_serving_observer_feeds_burn_rules():
    def run(p):
        h, m = p[0], p[4]
        h.configure(
            enabled_override=True, endpoint=None, interval_s=60.0,
            rules="qw:burn:signal=queue_wait:target=0.01:objective=0.5"
                  ":fast=30:slow=30:fast_factor=1:slow_factor=1",
            capture=False)
        for _ in range(10):
            m.record_serving_queue_wait(0.5, slo="interactive")
        h._tick()  # the serving rules advance on the publisher's tick
        return h.verdict()

    mine, theirs = _both(run)
    assert mine == theirs
    assert mine["health"] == "degraded"


def test_serving_histograms_carry_slo_label():
    def run(p):
        m = p[4]
        m.enable()
        m.record_serving_ttft(0.12, slo="interactive")
        m.record_serving_tpot(0.03, slo="interactive")
        m.record_serving_queue_wait(0.01, slo="batch")
        return m.exposition()[1].decode()

    mine, theirs = _both(run)
    assert mine == theirs
    assert 'hvd_serving_ttft_seconds_count{slo="interactive"} 1' in mine
    assert 'hvd_serving_queue_wait_seconds_count{slo="batch"} 1' in mine
    assert metrics.lint_exposition(mine) == []


# ------------------------------------------------ the HTTP routes

def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return json.loads(r.read())


def test_summary_publish_roundtrip():
    """A rank's summary lands at ``/health/<rank>`` of the port's store,
    and ``GET /health`` gives the JAX store's verdict on it."""
    from horovod_tpu.runner.http.http_server import KVStoreServer as JKV
    from horovod_tpu_torch.runner.http.http_server import KVStoreServer

    verdicts = []
    for p, kv in ((MINE, KVStoreServer()), (THEIRS, JKV())):
        port = kv.start_server()
        try:
            p[0].configure(enabled_override=True, rank=1,
                           endpoint=("127.0.0.1", port), interval_s=60.0,
                           capture=False)
            p[0]._tick()
            v = _get(f"http://127.0.0.1:{port}/health")
            raw = _get(f"http://127.0.0.1:{port}/health/1")
            verdicts.append((_no_time(v), sorted(raw)))
            p[0].reset()
        finally:
            kv.shutdown_server()
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][0]["status"] == "ok"
    assert list(verdicts[0][0]["by_rank"]) == ["1"]


def test_a_new_round_clears_the_health_scope():
    from horovod_tpu_torch.runner.http.http_server import RendezvousServer
    from horovod_tpu_torch.runner.util.hosts import SlotInfo

    rdv = RendezvousServer()
    port = rdv.start_server()
    try:
        assert fleet.publish_once("127.0.0.1", port, 0,
                                  {"rank": 0, "time_unix": time.time()})
        assert _get(f"http://127.0.0.1:{port}/health")["ranks"] == 1
        rdv.init([SlotInfo("localhost", 0, 0, 0, 1, 1, 1)])
        assert _get(f"http://127.0.0.1:{port}/health")["status"] == \
            "unknown"
    finally:
        rdv.shutdown_server()


def test_serving_server_health_routes():
    from horovod_tpu.serving.server import ServingServer as JServer
    from horovod_tpu_torch.serving.server import ServingServer

    out = []
    for p, cls in ((MINE, ServingServer), (THEIRS, JServer)):
        seen = []
        srv = cls(predict_fn=lambda x, t: x)
        port = srv.start()
        try:
            for on in (False, True):
                if on:
                    p[0].configure(enabled_override=True, endpoint=None,
                                   interval_s=60.0, capture=False)
                h = _get(f"http://127.0.0.1:{port}/healthz")
                v = _get(f"http://127.0.0.1:{port}/health")
                seen.append((h["status"], h["health"], h["alerts_active"],
                             v))
        finally:
            srv.shutdown()
        out.append(seen)
    assert out[0] == out[1]
    assert out[0][0] == ("ok", "off", 0, {"health": "off",
                                          "alerts_active": 0})
    assert out[0][1] == ("ok", "ok", 0, {"health": "ok", "alerts_active": 0,
                                         "alerts": []})


# ------------------------------------------------------------ knob wiring

def test_default_off():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        assert not health.enabled()
        assert metrics._step_observer is None
    finally:
        hvd.shutdown()


def test_knob_enables_and_shutdown_disables(monkeypatch, tmp_path):
    import horovod_tpu_torch as hvd
    from horovod_tpu.core.knobs import Knobs as JKnobs
    from horovod_tpu_torch.core.knobs import Knobs

    incident = str(tmp_path / "inc.jsonl")
    monkeypatch.setenv("HVD_TPU_HEALTH", "1")
    monkeypatch.setenv("HVD_TPU_HEALTH_STEP_TIME_FACTOR", "2.5")
    monkeypatch.setenv("HVD_TPU_HEALTH_INCIDENT_FILE", incident)
    monkeypatch.setenv("HOROVOD_HEALTH_MIN_STEPS", "3")
    monkeypatch.setenv("HOROVOD_PROF_EVERY", "7")
    mine, theirs = Knobs.from_env(), JKnobs.from_env()
    for f in ("health_enabled", "health_interval_s", "health_window",
              "health_min_steps", "health_step_time_factor", "health_rules",
              "health_incident_file", "health_capture", "prof_every",
              "prof_dir", "prof_duty_cycle"):
        assert getattr(mine, f) == getattr(theirs, f), f
    monkeypatch.delenv("HOROVOD_PROF_EVERY")
    hvd.init(device="cpu")
    try:
        assert health.enabled()
        assert metrics.enabled()  # health implies metrics
        assert health._step_det.step_time_factor == 2.5
        assert health._step_det.min_steps == 3
        assert health._incident_path == incident
        assert metrics._step_observer is health.observe_step
    finally:
        hvd.shutdown()
    assert not health.enabled()
    assert metrics._step_observer is None
    assert health._pub_thread is None


def test_bad_rules_knob_fails_loudly():
    class _Knobs:
        health_enabled = True
        health_rules = "broken-rule"

    for p in BOTH:
        with pytest.raises(p[1].RuleSpecError):
            p[0].configure(_Knobs())
        assert not p[0].enabled()


def test_shutdown_returns_with_a_dead_endpoint():
    """The publisher waits on its stop event: ``on_shutdown`` returns
    once its last tick gave up on an endpoint nobody listens on, within
    the publish's 2 s URL timeout."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    health.configure(enabled_override=True, endpoint=("127.0.0.1", port),
                     interval_s=3600.0, capture=False)
    t0 = time.monotonic()
    health.on_shutdown()
    assert time.monotonic() - t0 < 2.5
    assert health._pub_thread is None and not health.enabled()


# ------------------------------------------------------------ world of 2

def test_two_publishers_name_the_slow_rank():
    """The JAX package's slow ``health_check`` gate, in process: two
    ranks' monitors feed the same step stream except rank 1's late steps
    (its firing envelope), publish to one rendezvous store, and its
    ``GET /health`` names rank 1 alone, as the JAX evaluator does on the
    same summaries."""
    from horovod_tpu_torch.runner.http.http_server import KVStoreServer

    kv = KVStoreServer()
    port = kv.start_server()
    try:
        summaries = {}
        for rank in (0, 1):
            health.reset()
            health.configure(enabled_override=True, rank=rank,
                             endpoint=("127.0.0.1", port),
                             interval_s=3600.0, rules=_ENV_RULE,
                             capture=False, min_steps=3)
            for i in range(10):
                slow = rank == 1 and i >= 8
                health.observe_step({"step": i,
                                     "step_time_s": 1.0 if slow else 0.01})
            summaries[str(rank)] = health.summary()
            health.on_shutdown()  # the last tick publishes
        v = _get(f"http://127.0.0.1:{port}/health")
    finally:
        kv.shutdown_server()
    assert v["ranks"] == 2 and v["status"] == "degraded"
    assert v["suspected_straggler_ranks"] == [1]
    assert v["by_rank"]["1"]["alerts_active"] == ["env"]
    want = jfleet.evaluate(
        {k: json.loads(json.dumps(s)) for k, s in summaries.items()},
        now_unix=v["time_unix"])
    assert _no_time(v) == _no_time(want)
