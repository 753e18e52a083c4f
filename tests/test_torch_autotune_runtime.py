"""The controller's tuner on the port's library: the two autotune
scenarios of the JAX package's ``tests/test_native_runtime.py``
(coordinate descent, ``:596``, and the Bayesian search, ``:996``) as
gloo worlds of two, each rank started with the launcher's slot
environment and ``HVD_TPU_NATIVE=1`` plus ``HOROVOD_AUTOTUNE=1``, so
``init()`` hands the autotune knobs to ``EagerRuntime(autotune=True)``.
Steady allreduce traffic runs until the coordinator pins; every rank
reads the same distributed parameters (``tuned_parameters()``), and
the first ``synchronize`` after the pin steers the two-level route's
knobs under the Bayesian search only (``_apply_pinned_tuning``).

The plan cache is off (``HOROVOD_EAGER_FAST_PATH=0``): a frozen plan
skips the coordinator, whose samples are what the tuner scores.
"""

import json
import os
import subprocess
import sys

import pytest

from horovod_tpu_torch.runner.exec_run import slot_env
from horovod_tpu_torch.runner.util.hosts import SlotInfo
from horovod_tpu_torch.runner.util.network import find_free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r'''
import json
import time

import torch

torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.state import global_state

hvd.init(device="cpu")
st = global_state()
rt = st.eager_runtime
native = rt._native
hier_before = (st.knobs.hierarchical_allreduce,
               st.knobs.hierarchical_local_size)
deadline = time.time() + 60
steps, hier_seen, bad = 0, set(), 0
x = torch.arange(256, dtype=torch.float32) * (hvd.rank() + 1)
while not rt.tuned_parameters()["pinned"] and time.time() < deadline:
    hs = [hvd.allreduce_async(x, name=f"at{i}", op=hvd.Sum)
          for i in range(3)]
    for h in hs:
        bad += not torch.equal(hvd.synchronize(h), x / (hvd.rank() + 1) * 3)
    hier_seen.add(bool(native.tuned_hierarchical()))
    steps += 1
# one more negotiated collective: the first synchronize after the pin
hvd.synchronize(hvd.allreduce_async(x, name="after_pin", op=hvd.Sum))
out = {"tuned": rt.tuned_parameters(), "bayes": bool(native.tuned_bayes()),
       "hier_seen": sorted(hier_seen), "steps": steps, "bad": bad,
       "hier_before": hier_before,
       "hier_after": (st.knobs.hierarchical_allreduce,
                      st.knobs.hierarchical_local_size)}
print("RESULT " + json.dumps(out), flush=True)
hvd.shutdown()
'''


def _world(extra_env, timeout=120):
    store = find_free_port()
    port = find_free_port()
    while port == store:
        port = find_free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    base.update(HVD_TPU_NATIVE="1", OMP_NUM_THREADS="1",
                HOROVOD_EAGER_FAST_PATH="0", HOROVOD_AUTOTUNE="1",
                HOROVOD_AUTOTUNE_WARMUP_SAMPLES="1",
                HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE="2",
                HOROVOD_CACHE_CAPACITY="64", PYTHONPATH=REPO, **extra_env)
    procs = []
    for r in range(2):
        env = slot_env(SlotInfo("localhost", r, r, 0, 2, 2, 1), base,
                       f"127.0.0.1:{store}", native_coordinator_port=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    try:
        for r, p in enumerate(procs):
            text, _ = p.communicate(timeout=timeout)
            lines = [ln for ln in text.splitlines()
                     if ln.startswith("RESULT ")]
            assert p.returncode == 0 and lines, text
            out[r] = json.loads(lines[-1][7:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_coordinate_descent_pins_identical_parameters():
    """The coordinator walks {threshold x cycle time} and ships the
    applied values in every response, so every rank pins the same
    ones (reference parameter_manager.cc:528). Coordinate descent
    leaves the two-level knobs alone, a user-set
    HOROVOD_HIERARCHICAL_ALLREDUCE=1 included."""
    res = _world({"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                  "HOROVOD_HIERARCHICAL_LOCAL_SIZE": "2"})
    a, b = res[0], res[1]
    for r in (a, b):
        assert r["tuned"]["pinned"], r
        assert r["bad"] == 0 and not r["bayes"], r
        assert r["hier_after"] == r["hier_before"] == [True, 2], r
    assert a["tuned"] == b["tuned"]
    assert a["tuned"]["cycle_ms"] in (0.25, 0.5, 1.0, 2.5, 5.0)
    assert a["tuned"]["fusion_threshold_bytes"] >= 1 << 20


def test_bayesian_search_pins_identical_parameters():
    """HOROVOD_AUTOTUNE_BAYES: the coordinator's Gaussian process
    searches the joint {threshold x cycle x cache x hierarchical x
    inner size} space and every rank pins the same continuous winner.
    The search explores both two-level modes (its seeding corners
    guarantee it), and the pin steers the knobs the two-level route
    reads: the first synchronize after it sets them to the winner on
    every rank."""
    res = _world({"HOROVOD_AUTOTUNE_BAYES": "1"})
    a, b = res[0], res[1]
    for r in (a, b):
        assert r["tuned"]["pinned"] and r["bayes"], r
        assert r["bad"] == 0, r
        assert r["hier_seen"] == [False, True], r
        tuned = r["tuned"]
        assert r["hier_after"][0] == tuned["hierarchical_allreduce"]
        if tuned["hierarchical_local_size"] > 0:
            assert r["hier_after"][1] == tuned["hierarchical_local_size"]
    assert a["tuned"] == b["tuned"]
    assert a["hier_after"] == b["hier_after"]
    assert 0.25 <= a["tuned"]["cycle_ms"] <= 5.0
    assert (1 << 20) <= a["tuned"]["fusion_threshold_bytes"] <= (256 << 20)
    assert 2 <= a["tuned"]["hierarchical_local_size"] <= 16


@pytest.mark.parametrize("bayes", [False, True])
def test_apply_pinned_tuning_steers_the_knobs_once(bayes, monkeypatch):
    """``_apply_pinned_tuning`` reads the controller once, after the
    pin: under the Bayesian search it sets ``hierarchical_allreduce``
    and, when the winner names one, ``hierarchical_local_size``; under
    coordinate descent it sets nothing."""
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.ops.eager_runtime import EagerRuntime

    class Controller:
        pinned = False

        def tuned_pinned(self):
            return self.pinned

        def tuned_bayes(self):
            return bayes

        def tuned_hierarchical(self):
            return False

        def tuned_hier_block(self):
            return 4

    rt = EagerRuntime.__new__(EagerRuntime)
    rt._native, rt._tuning_applied = Controller(), False
    knobs = global_state().knobs
    monkeypatch.setattr(knobs, "hierarchical_allreduce", True)
    monkeypatch.setattr(knobs, "hierarchical_local_size", 2)
    rt._apply_pinned_tuning()
    assert not rt._tuning_applied  # not pinned yet
    rt._native.pinned = True
    rt._apply_pinned_tuning()
    assert rt._tuning_applied
    want = (False, 4) if bayes else (True, 2)
    assert (knobs.hierarchical_allreduce,
            knobs.hierarchical_local_size) == want
    knobs.hierarchical_allreduce = True
    rt._apply_pinned_tuning()  # once only
    assert knobs.hierarchical_allreduce
