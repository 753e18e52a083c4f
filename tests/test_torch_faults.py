"""Fault injection, the retry policy and the HTTP key/value client
under chaos, in the port (horovod_tpu_torch.utils.faults/retry/metrics,
runner/http): the cases of tests/test_faults.py that reach only these
modules, with the same names and assertions.

The JAX file's cases of the per-step JSONL record (StepStats, ROADMAP
queue A entry 13), elastic discovery and preemption (entry 8), and the
stall watchdog and the collectives' fault point (entry 9) come with
those entries.

Everything here is deterministic: retry schedules run on a fake clock
(zero real sleeping) and fault rules are seeded.
"""

import os
import urllib.error
import urllib.request

import pytest

from horovod_tpu_torch.utils import faults, metrics, retry


@pytest.fixture(autouse=True)
def _fresh():
    faults.reset()
    retry.set_default_policy(None)
    metrics.reset()
    yield
    faults.reset()
    retry.set_default_policy(None)
    metrics.reset()


class FakeClock:
    """Monotonic clock + sleep pair: sleeping advances the clock."""

    def __init__(self, t0=100.0):
        self.t = t0
        self.sleeps = []

    def clock(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _fast_policy(**kw):
    """A zero-real-time policy for exercising call sites."""
    clk = FakeClock()
    kw.setdefault("clock", clk.clock)
    kw.setdefault("sleep", clk.sleep)
    return retry.RetryPolicy(**kw), clk


# ------------------------------------------------------------- spec parsing

def test_spec_parses_points_actions_and_params():
    faults.configure(
        "http.put:error:0.3:seed=7;worker:kill:rank=2:step=5,"
        "collective:delay:secs=0.01:times=3"
    )
    assert faults.enabled()
    assert len(faults.rules()) == 3


def test_empty_spec_disables():
    faults.configure("")
    assert not faults.enabled()
    assert faults.inject("http.put") is None


@pytest.mark.parametrize("bad", [
    "http.put",                 # no action
    "http.put:explode",         # unknown action
    "http.put:error:nonsense",  # bare field not a probability
    "http.put:error:1.5",       # probability out of range
])
def test_malformed_specs_raise(bad):
    with pytest.raises(faults.FaultSpecError):
        faults.configure(bad)


def test_error_action_raises_connection_error():
    faults.configure("http.put:error")
    with pytest.raises(faults.InjectedFault) as ei:
        faults.inject("http.put", scope="s", key="k")
    # transport-shaped: real retry paths must treat it like ECONNRESET
    assert isinstance(ei.value, ConnectionError)
    assert "http.put" in str(ei.value)


def test_point_prefix_matching():
    faults.configure("http:error")
    with pytest.raises(faults.InjectedFault):
        faults.inject("http.get")
    # prefix is dot-anchored: "http" must not match "httpx"
    assert faults.inject("httpx.get") is None


def test_context_constraints_must_be_present_and_equal():
    faults.configure("worker:kill:rank=2:step=5")
    recorded = []
    faults._exit = recorded.append
    try:
        faults.inject("worker", rank=1, step=5)   # wrong rank
        faults.inject("worker", rank=2, step=4)   # wrong step
        faults.inject("worker", rank=2)           # step absent: no fire
        assert recorded == []
        faults.inject("worker", rank=2, step=5)
        assert recorded == [1]
    finally:
        faults._exit = os._exit


def test_kill_exit_code_override():
    faults.configure("worker:kill:code=83")
    recorded = []
    faults._exit = recorded.append
    try:
        faults.inject("worker")
        assert recorded == [83]
    finally:
        faults._exit = os._exit


def test_probability_is_seeded_and_deterministic():
    def fire_pattern():
        faults.configure("p:error:0.3:seed=7")
        pattern = []
        for _ in range(50):
            try:
                faults.inject("p")
                pattern.append(0)
            except faults.InjectedFault:
                pattern.append(1)
        return pattern

    a, b = fire_pattern(), fire_pattern()
    assert a == b, "same seed must fire identically"
    assert 0 < sum(a) < 50, "0.3 must neither always nor never fire"


def test_times_and_after_limits():
    faults.configure("p:error:times=2:after=1")
    outcomes = []
    for _ in range(5):
        try:
            faults.inject("p")
            outcomes.append("ok")
        except faults.InjectedFault:
            outcomes.append("err")
    # call 1 skipped (after=1), calls 2-3 fire (times=2), rest heal
    assert outcomes == ["ok", "err", "err", "ok", "ok"]


def test_delay_action_sleeps_in_caller():
    faults.configure("collective:delay:secs=0.25")
    slept = []
    orig = faults._sleep
    faults._sleep = slept.append
    try:
        assert faults.inject("collective", name="g0") is None
        assert slept == [0.25]
    finally:
        faults._sleep = orig


def test_cofired_rules_all_execute_before_error_raises():
    """A co-fired error rule must not swallow other fired rules'
    actions or accounting (their times budget is already spent)."""
    metrics.enable()
    faults.configure("p:error:times=1;p:delay:secs=0.1:times=1")
    slept = []
    orig = faults._sleep
    faults._sleep = slept.append
    try:
        with pytest.raises(faults.InjectedFault):
            faults.inject("p")
    finally:
        faults._sleep = orig
    assert slept == [0.1], "co-fired delay must run before the raise"
    snap = metrics.registry.snapshot()
    assert snap["hvd_faults_injected_total"]["p,delay"] == 1.0
    assert snap["hvd_faults_injected_total"]["p,error"] == 1.0


def test_retry_configure_from_knobs():
    from horovod_tpu_torch.core.knobs import Knobs

    retry.configure(Knobs(retry_max_attempts=2, retry_base_delay_seconds=9.0))
    p = retry.default_policy()
    assert p.max_attempts == 2 and p.base_delay_s == 9.0


def test_flap_is_cooperative():
    faults.configure("discovery.poll:flap:times=1")
    assert faults.inject("discovery.poll") == "flap"
    assert faults.inject("discovery.poll") is None


def test_injection_counters_reach_registry():
    metrics.enable()
    faults.configure("p:error:times=1")
    with pytest.raises(faults.InjectedFault):
        faults.inject("p")
    snap = metrics.registry.snapshot()
    assert snap["hvd_faults_injected_total"]["p,error"] == 1.0


def test_disabled_inject_is_nearly_free():
    import time as _time

    assert not faults.enabled()
    n = 20000
    t0 = _time.perf_counter()
    for _ in range(n):
        faults.inject("http.put")
    per_call = (_time.perf_counter() - t0) / n
    assert per_call < 5e-6, f"disabled inject costs {per_call * 1e6:.2f}us"


# ------------------------------------------------------------- RetryPolicy

def test_retry_succeeds_after_transient_failures():
    clk = FakeClock()
    policy = retry.RetryPolicy(
        max_attempts=5, base_delay_s=0.1, multiplier=2.0, jitter_frac=0.0,
        clock=clk.clock, sleep=clk.sleep,
    )
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise ConnectionResetError("transient")
        return "ok"

    metrics.enable()
    assert policy.call(flaky, point="t.point") == "ok"
    assert len(attempts) == 3
    # exponential, jitter-free schedule: 0.1 then 0.2
    assert clk.sleeps == [pytest.approx(0.1), pytest.approx(0.2)]
    snap = metrics.registry.snapshot()
    assert snap["hvd_retries_total"]["t.point"] == 2.0
    assert "hvd_retry_giveups_total" not in snap


def test_retry_gives_up_after_max_attempts():
    clk = FakeClock()
    policy = retry.RetryPolicy(
        max_attempts=3, base_delay_s=0.1, jitter_frac=0.0,
        clock=clk.clock, sleep=clk.sleep,
    )
    metrics.enable()
    attempts = []

    def always_fails():
        attempts.append(1)
        raise ConnectionResetError("down")

    with pytest.raises(ConnectionResetError):
        policy.call(always_fails, point="t.giveup")
    assert len(attempts) == 3
    snap = metrics.registry.snapshot()
    assert snap["hvd_retry_giveups_total"]["t.giveup"] == 1.0


def test_retry_max_delay_caps_backoff():
    clk = FakeClock()
    policy = retry.RetryPolicy(
        max_attempts=6, base_delay_s=1.0, max_delay_s=2.5, multiplier=4.0,
        jitter_frac=0.0, clock=clk.clock, sleep=clk.sleep,
    )
    calls = [0]

    def fails_forever():
        calls[0] += 1
        raise OSError("x")

    with pytest.raises(OSError):
        policy.call(fails_forever)
    assert clk.sleeps == [1.0, 2.5, 2.5, 2.5, 2.5]


def test_retry_jitter_is_seeded_and_bounded():
    def schedule():
        clk = FakeClock()
        policy = retry.RetryPolicy(
            max_attempts=4, base_delay_s=1.0, max_delay_s=100.0,
            jitter_frac=0.5, seed=11, clock=clk.clock, sleep=clk.sleep,
        )
        with pytest.raises(OSError):
            policy.call(lambda: (_ for _ in ()).throw(OSError("x")))
        return clk.sleeps

    a, b = schedule(), schedule()
    assert a == b, "seeded jitter must reproduce"
    for delay, nominal in zip(a, (1.0, 2.0, 4.0)):
        assert 0.5 * nominal <= delay <= 1.5 * nominal
    assert any(d != n for d, n in zip(a, (1.0, 2.0, 4.0)))


def test_retry_deadline_bounds_total_time():
    clk = FakeClock()
    policy = retry.RetryPolicy(
        max_attempts=100, base_delay_s=1.0, max_delay_s=1.0,
        jitter_frac=0.0, deadline_s=3.5, clock=clk.clock, sleep=clk.sleep,
    )
    calls = [0]

    def fails():
        calls[0] += 1
        raise OSError("x")

    with pytest.raises(OSError):
        policy.call(fails)
    # t=0 fail, sleep 1 (x3) → t=3 … at t>=3.5 the deadline expires
    assert clk.t - 100.0 <= 4.0
    assert calls[0] <= 5


def test_non_retryable_raises_immediately():
    policy, clk = _fast_policy(max_attempts=5)
    calls = [0]

    def bad_request():
        calls[0] += 1
        raise ValueError("not transport")

    with pytest.raises(ValueError):
        policy.call(bad_request)
    assert calls[0] == 1 and clk.sleeps == []


def test_deadline_uses_injected_monotonic_clock():
    clk = FakeClock(t0=50.0)
    d = retry.Deadline(10.0, clock=clk.clock)
    assert not d.expired()
    assert d.remaining() == pytest.approx(10.0)
    clk.t += 10.01
    assert d.expired()
    assert retry.Deadline(None, clock=clk.clock).remaining() == float("inf")


# ------------------------------------------------- http client under chaos

def _kv_server():
    from horovod_tpu_torch.runner.http.http_server import KVStoreServer

    srv = KVStoreServer()
    port = srv.start_server()
    return srv, port


def test_http_put_get_survive_injected_errors():
    from horovod_tpu_torch.runner.http import http_client

    srv, port = _kv_server()
    try:
        metrics.enable()
        policy, _ = _fast_policy(max_attempts=5)
        retry.set_default_policy(policy)
        # first two attempts of each verb die client-side, then heal
        faults.configure("http.put:error:times=2;http.get:error:times=2")
        http_client.put("127.0.0.1", port, "sc", "k", b"v")
        assert http_client.get("127.0.0.1", port, "sc", "k") == b"v"
        snap = metrics.registry.snapshot()
        assert snap["hvd_retries_total"]["http.put"] == 2.0
        assert snap["hvd_retries_total"]["http.get"] == 2.0
        assert "hvd_retry_giveups_total" not in snap
    finally:
        srv.shutdown_server()


def test_http_server_injected_503_is_retried():
    from horovod_tpu_torch.runner.http import http_client

    srv, port = _kv_server()
    try:
        policy, _ = _fast_policy(max_attempts=5)
        retry.set_default_policy(policy)
        faults.configure("http.server:error:times=2")
        http_client.put("127.0.0.1", port, "sc", "k", b"v2")
        assert http_client.get("127.0.0.1", port, "sc", "k") == b"v2"
    finally:
        srv.shutdown_server()


def test_http_get_404_is_not_retried():
    from horovod_tpu_torch.runner.http import http_client

    srv, port = _kv_server()
    try:
        calls = []
        policy, _ = _fast_policy(max_attempts=5)
        retry.set_default_policy(policy)
        orig = urllib.request.urlopen

        def counting(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        urllib.request.urlopen = counting
        try:
            assert http_client.get("127.0.0.1", port, "sc", "nope") is None
        finally:
            urllib.request.urlopen = orig
        assert len(calls) == 1, "404 must not burn retry attempts"
    finally:
        srv.shutdown_server()


def test_wait_for_key_monotonic_deadline_and_recovery():
    from horovod_tpu_torch.runner.http import http_client

    srv, port = _kv_server()
    try:
        policy, _ = _fast_policy(max_attempts=2)
        retry.set_default_policy(policy)
        srv.store.setdefault("sc", {})["k"] = b"there"
        assert http_client.wait_for_key(
            "127.0.0.1", port, "sc", "k", timeout_s=5.0
        ) == b"there"
        with pytest.raises(TimeoutError):
            http_client.wait_for_key(
                "127.0.0.1", port, "sc", "missing", timeout_s=0.3
            )
    finally:
        srv.shutdown_server()


# ------------------------------------------------------- the port's own


def test_retry_configure_matches_jax_from_env(monkeypatch):
    """The env-built default policy and the knob-built one agree with
    the JAX package's on every field."""
    from horovod_tpu.core.knobs import Knobs as JaxKnobs
    from horovod_tpu.utils import retry as jax_retry
    from horovod_tpu_torch.core.knobs import Knobs

    for k, v in (("HOROVOD_RETRY_MAX_ATTEMPTS", "7"),
                 ("HOROVOD_RETRY_BASE_DELAY", "0.3"),
                 ("HVD_TPU_RETRY_MAX_DELAY", "4.5"),
                 ("HOROVOD_RETRY_JITTER", "bounded"),
                 ("HOROVOD_RETRY_MAX_ELAPSED", "9")):
        monkeypatch.setenv(k, v)
    fields = ("max_attempts", "base_delay_s", "max_delay_s", "multiplier",
              "jitter_frac", "jitter", "max_elapsed_s", "deadline_s")
    try:
        jax_retry.set_default_policy(None)
        for build in (lambda m, k: m.set_default_policy(None),
                      lambda m, k: m.configure(k.from_env())):
            build(retry, Knobs)
            build(jax_retry, JaxKnobs)
            mine, theirs = retry.default_policy(), jax_retry.default_policy()
            for f in fields:
                assert getattr(mine, f) == getattr(theirs, f), f
            assert mine.max_attempts == 7 and mine.max_delay_s == 4.5
    finally:
        jax_retry.set_default_policy(None)


def test_fault_spec_fires_like_jax():
    """One seeded spec gives the same fire pattern in both packages."""
    from horovod_tpu.utils import faults as jax_faults

    spec = "p:error:0.4:seed=3;q:delay:secs=0.0:times=2:after=1"

    def pattern(mod):
        mod.configure(spec)
        out = []
        try:
            for i in range(40):
                point = "p.sub" if i % 2 else "q"
                try:
                    out.append(mod.inject(point, i=i))
                except mod.InjectedFault:
                    out.append("raised")
        finally:
            mod.reset()
        return out

    assert pattern(faults) == pattern(jax_faults)


def test_launched_worker_arms_faults_from_env(tmp_path):
    """A worker the launcher spawns gets --fault-spec as
    HOROVOD_TPU_FAULT_SPEC and is armed at import, before init()."""
    import subprocess
    import sys

    out = tmp_path / "rules.txt"
    code = ("from horovod_tpu_torch.utils import faults; "
            f"open({str(out)!r}, 'w').write(repr(faults.rules()))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "--fault-spec", "http.put:error:0.5:seed=2", "-np", "1",
         sys.executable, "-c", code],
        cwd=repo, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert out.read_text() == repr(["http.put:error:0.5:seed=2"])


def test_init_configures_logging_faults_and_retry(monkeypatch):
    """init() sets up the control plane from its knob snapshot: the
    log level, an explicitly knobbed fault spec and the retry policy."""
    import logging

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils.logging import get_logger

    monkeypatch.setenv("HOROVOD_LOG_LEVEL", "DEBUG")
    monkeypatch.setenv("HVD_TPU_FAULT_SPEC", "x:delay:secs=0")
    monkeypatch.setenv("HOROVOD_RETRY_MAX_ATTEMPTS", "9")
    hvd.init(device="cpu")
    try:
        assert get_logger().level == logging.DEBUG
        assert faults.rules() == ["x:delay:secs=0"]
        assert retry.default_policy().max_attempts == 9
    finally:
        hvd.shutdown()
        get_logger().setLevel(logging.WARNING)
