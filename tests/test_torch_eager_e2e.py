"""The port's eager runtime end to end: gloo worlds of 2, 3 and 4
processes, each rank started with the launcher's slot environment
(``runner/exec_run.slot_env``, the native coordinator's address
included) and ``HVD_TPU_NATIVE=1``, through ``hvd.init()`` and the public
API (``tests/torch_native_eager_worker.py``).

The scenarios are the JAX package's ``tests/native_eager_worker.py``:
rank-distinct values in rank-different enqueue orders, ragged
allgather, uneven alltoall, sparse allreduce, the grouped forms, the
plan cache over the ``torch.distributed`` executor, join covering a
rank that ran out of data, and process sets. Besides:

* the DistributedOptimizer through the runtime is bitwise its hook
  path: at world 2 with the controller fusing its two buckets into one
  batch (a sum of two terms does not depend on the order), at world 4
  with a fusion threshold that keeps each fused batch one bucket;
* the int8 + error-feedback wire is bitwise the port's
  ``emulated_quantized_psum`` of the same fused buffers and residuals;
* the executor's two-level route equals its flat route (world 4);
* a stalled rank and a crashed rank raise ``HorovodInternalError`` on
  the survivors.
"""

import json
import os
import subprocess
import sys

import pytest

from horovod_tpu_torch.runner.exec_run import slot_env
from horovod_tpu_torch.runner.util.hosts import SlotInfo
from horovod_tpu_torch.runner.util.network import find_free_port

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_native_eager_worker.py")


def _world(size, scenario, extra_env=None, timeout=90):
    """Run ``size`` ranks of the worker; each rank's exit code and its
    RESULT (None if it printed none)."""
    store = find_free_port()
    native = find_free_port()
    while native == store:
        native = find_free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    base.update(HVD_TPU_NATIVE="1", OMP_NUM_THREADS="1", **(extra_env or {}))
    procs = []
    for r in range(size):
        env = slot_env(SlotInfo("localhost", r, r, 0, size, size, 1), base,
                       f"127.0.0.1:{store}", native_coordinator_port=native)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, scenario], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    try:
        for r, p in enumerate(procs):
            text, _ = p.communicate(timeout=timeout)
            lines = [ln for ln in text.splitlines()
                     if ln.startswith("RESULT ")]
            out[r] = (p.returncode,
                      json.loads(lines[-1][7:]) if lines else None, text)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out, native


_CHECKS = ("allreduce_ok", "average_ok", "allgather_ok", "broadcast_ok",
           "reducescatter_ok", "alltoall_ok", "sparse_ok", "grouped_ok",
           "grouped_sync_ok", "grouped_allgather_ok",
           "grouped_reducescatter_ok", "fast_path_ok", "int8_wire_ok",
           "two_level_ok", "process_set_ok", "join_ok")


@pytest.mark.parametrize("size,threshold,batches", [
    (2, None, 1.0),      # the controller fuses the optimizer's 2 buckets
    (4, "2048", 2.0),    # each fused batch is one bucket
])
def test_public_api_through_the_runtime(size, threshold, batches):
    extra = {"HOROVOD_FUSION_THRESHOLD": threshold} if threshold else {}
    out, native_port = _world(size, "api", extra)
    for r, (rc, res, text) in out.items():
        assert rc == 0 and res is not None, f"rank {r}:\n{text[-3000:]}"
        for check in _CHECKS:
            assert res[check] is True, (r, check, res)
        opt = res["optimizer"]
        assert opt["bitwise"] and opt["rel_l2"] == 0.0, opt
        assert opt["buckets"] == 2 and opt["batches_per_step"] == batches
        # the launcher's published port reached the runtime, and rank
        # 0's controller listens on it
        assert res["coordinator_port"] == native_port
        assert res["bound_port"] == (native_port if r == 0 else 0)
    # the steady state rode the response cache
    assert all(res["cache_hits"] > 0 for _, res, _ in out.values())


def test_stalled_rank_raises_on_the_survivor():
    """Rank 1 stops submitting: rank 0's watchdog (1 s) raises
    HorovodInternalError ("stalled") within a few cycles of it."""
    out, _ = _world(2, "stall", {"HOROVOD_STALL_ABORT_S": "1"})
    rc, res, text = out[0]
    assert rc == 0 and res is not None, text[-3000:]
    assert "stalled" in res["raised"], res
    assert 1.0 <= res["seconds"] < 5.0, res
    assert out[1][1] == {"rank": 1, "slept": True}


def test_crashed_rank_raises_on_the_survivors():
    """Rank 1 is killed between collectives: the survivors' next
    collective raises HorovodInternalError (the controller lost it)."""
    out, _ = _world(3, "crash")
    assert out[1][0] == -9 and out[1][1] is None
    for r in (0, 2):
        rc, res, text = out[r]
        assert rc == 0 and res is not None, text[-3000:]
        # the death surfaces at the enqueue or at the handle, as the
        # controller's lost-connection error naming the dead rank
        assert res["raised"] and ("lost connection" in res["raised"]
                                  or "rank 1" in res["raised"]), res
