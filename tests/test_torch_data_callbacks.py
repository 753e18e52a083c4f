"""The port's data helpers (horovod_tpu_torch.data) and callbacks
(horovod_tpu_torch.callbacks) against the JAX package's:

* ``ElasticSampler``'s indices equal the JAX sampler's for every epoch,
  rank, world and processed cursor tried, and so do its state dicts,
  its legacy-state loading and its cursor after a world change;
* every callback's multiplier, momentum factor and schedule equals the
  JAX callback's (the JAX schedule is float32, so within 1e-6
  relative); ``MetricAverageCallback`` at world 1 and over a gloo world
  of 2; the elastic callbacks' commits and cursors; early stopping;
* the loaders (``BaseDataLoader``, ``AsyncDataLoaderMixin`` with a
  failing source and an abandoned iteration, ``ShardedDataLoader``,
  whose ``mesh=`` raises naming the ROADMAP entry) and
  ``device_prefetch`` on the CPU.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu import callbacks as jax_callbacks
from horovod_tpu.data import sampler as jax_sampler
from horovod_tpu_torch import callbacks
from horovod_tpu_torch.data import (AsyncDataLoaderMixin, BaseDataLoader,
                                    ElasticSampler, ShardedDataLoader,
                                    device_prefetch)

REPO = pathlib.Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------- sampler


@pytest.mark.parametrize("size,shuffle,seed", [(48, True, 7), (10, True, 0),
                                               (37, False, 3), (5, True, 2)])
def test_sampler_indices_match_jax(size, shuffle, seed):
    for world in (1, 2, 3, 4, 7):
        for rank in range(world):
            for epoch in (0, 1, 5):
                for batches in (0, 1, 3):
                    mine = ElasticSampler(size, shuffle=shuffle, seed=seed)
                    theirs = jax_sampler.ElasticSampler(
                        size, shuffle=shuffle, seed=seed)
                    for s in (mine, theirs):
                        s.set_epoch(epoch)
                        s.set_world(rank, world)
                        for b in range(batches):
                            s.record_batch(b, 2)
                        s.set_world(rank, world)
                    assert list(mine) == list(theirs)
                    assert len(mine) == len(theirs)
                    assert mine.processed_indices == \
                        theirs.processed_indices
                    assert mine.state_dict() == theirs.state_dict()


def test_sampler_resumes_across_a_world_change_like_jax():
    """State saved at world 3 and loaded at world 2 (and a legacy state
    without a cursor) gives the JAX sampler's indices."""
    for cls in (ElasticSampler, jax_sampler.ElasticSampler):
        assert cls.__name__ == "ElasticSampler"
    a = ElasticSampler(30, seed=1)
    a.set_world(1, 3)
    a.record_batch(0, 2)
    a.record_batch(1, 2)
    state = a.state_dict()
    legacy = {"epoch": 2, "processed_indices": [1, 2, 3],
              "num_replicas": 2}
    for st in (state, legacy):
        mine, theirs = ElasticSampler(30, seed=1), \
            jax_sampler.ElasticSampler(30, seed=1)
        for s in (mine, theirs):
            s.load_state_dict(st)
            s.set_world(0, 2)
        assert list(mine) == list(theirs)
        assert mine.processed_num == theirs.processed_num


# -------------------------------------------------------------- callbacks


@pytest.mark.parametrize("size", [1, 2, 8])
@pytest.mark.parametrize("warmup", [1.0, 2.5, 5.0])
def test_warmup_scale_momentum_and_schedule_match_jax(size, warmup):
    mine = callbacks.LearningRateWarmupCallback(
        warmup_epochs=warmup, initial_lr=0.1, size=size)
    theirs = jax_callbacks.LearningRateWarmupCallback(
        warmup_epochs=warmup, initial_lr=0.1, size=size)
    epochs = [0, 0.25, 0.5, 1, 1.7, 2.5, 3, 4.99, 5, 7]
    for e in epochs:
        assert mine.scale(e) == theirs.scale(e)
    for a, b in zip(epochs, epochs[1:]):
        assert mine.momentum_correction_factor(a, b) == \
            theirs.momentum_correction_factor(a, b)
    off = callbacks.LearningRateWarmupCallback(
        warmup_epochs=warmup, momentum_correction=False, size=size)
    assert off.momentum_correction_factor(0, 1) == 1.0
    ms = mine.as_schedule(steps_per_epoch=10)
    ts = theirs.as_schedule(steps_per_epoch=10)
    for step in (0, 1, 7, 10, 24, 49, 50, 100):
        np.testing.assert_allclose(ms(step), float(ts(step)), rtol=1e-6)
    with pytest.raises(ValueError):
        callbacks.LearningRateWarmupCallback(size=size).as_schedule(10)


@pytest.mark.parametrize("kw", [
    dict(multiplier=0.5), dict(multiplier=0.1, start_epoch=3),
    dict(multiplier=lambda e: 0.9 ** e, start_epoch=1, end_epoch=6),
    dict(multiplier=lambda e: 1.0 / (1 + e), staircase=False)])
def test_schedule_multiplier_matches_jax(kw):
    mine = callbacks.LearningRateScheduleCallback(**kw)
    theirs = jax_callbacks.LearningRateScheduleCallback(**kw)
    for e in (0, 0.5, 1, 2.7, 3, 5.5, 6, 9):
        assert mine.scale(e) == theirs.scale(e)


def test_early_stopping_matches_jax():
    values = [3.0, 2.5, 2.6, 2.55, 2.4, 2.41, 2.42, 2.43]
    for kw in (dict(patience=0), dict(patience=1, min_delta=0.05),
               dict(patience=2, mode="max", monitor="acc")):
        got = []
        for cb in (callbacks.EarlyStoppingCallback(**kw),
                   jax_callbacks.EarlyStoppingCallback(**kw)):
            cb.on_train_begin()
            trail = []
            for e, v in enumerate(values):
                cb.on_epoch_end(e, {kw.get("monitor", "val_loss"): v})
                trail.append((cb.stop_training, cb.best, cb.stopped_epoch))
            got.append(trail)
        assert got[0] == got[1]
    with pytest.raises(ValueError):
        callbacks.EarlyStoppingCallback(mode="sideways")


def test_elastic_callbacks_commit_and_track_cursors():
    from horovod_tpu_torch.elastic import ObjectState

    state = ObjectState(value=0)
    commit = callbacks.CommitStateCallback(state, batches_per_commit=3)
    batch = callbacks.UpdateBatchStateCallback(state)
    epoch = callbacks.UpdateEpochStateCallback(state)
    commit.on_train_begin()
    for b in range(7):
        state.value += 1
        commit.on_batch_end(b)
        batch.on_batch_end(b)
    assert state._commit_count == 2 and state._saved["value"] == 6
    # the commit at batch 5 ran before the cursor moved to 5
    assert state.batch == 6 and state._saved["batch"] == 4
    commit.on_epoch_end(0)
    batch.on_epoch_end(0)
    epoch.on_epoch_end(0)
    assert state._commit_count == 3 and state.batch == 0
    assert state.epoch == 1 and state._saved["epoch"] == 0
    state.restore()
    assert state.value == 7 and state.batch == 6


def test_metric_average_and_broadcast_at_world_one():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        logs = {"loss": 2.5, "acc": np.array([0.25, 0.5]),
                "t": torch.tensor(3.0), "flag": True, "name": "x"}
        callbacks.MetricAverageCallback().on_epoch_end(0, logs)
        assert logs["loss"] == 2.5 and logs["flag"] is True
        np.testing.assert_array_equal(logs["acc"], [0.25, 0.5])
        assert logs["t"] == 3.0 and logs["name"] == "x"
        model = torch.nn.Linear(3, 2)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        assert callbacks.BroadcastGlobalVariablesCallback(0) \
            .on_train_begin(model) is model
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k])
    finally:
        hvd.shutdown()


_WORKER = r'''
import sys, torch
torch.set_num_threads(1)
import numpy as np
import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks
hvd.init(device="cpu")
r = hvd.rank()
logs = {"loss": 1.0 + r, "acc": np.array([r, 2.0 * r], np.float32)}
callbacks.MetricAverageCallback().on_epoch_end(0, logs)
model = torch.nn.Linear(3, 2)
with torch.no_grad():
    model.weight.fill_(float(r + 1))
callbacks.BroadcastGlobalVariablesCallback(0).on_train_begin(model)
print("RESULT", logs["loss"], logs["acc"].tolist(),
      float(model.weight.sum()), flush=True)
hvd.shutdown()
'''


def test_metric_average_and_broadcast_over_two_ranks():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER],
                                      cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
        line = [l for l in o.splitlines() if l.startswith("RESULT")][0]
        assert line.split(None, 1)[1] == "1.5 [0.5, 1.0] 6.0", line


# ---------------------------------------------------------------- loaders


class _Range(BaseDataLoader):
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def _iterate(self):
        for i in range(self.n):
            if i == self.fail_at:
                raise KeyError("source broke")
            yield {"x": np.full((2,), i, np.float32), "i": i}


class _AsyncRange(AsyncDataLoaderMixin, _Range):
    pass


def test_async_loader_yields_in_order_and_surfaces_errors():
    got = [b["i"] for b in _AsyncRange(10, async_loader_queue_size=2)]
    assert got == list(range(10))
    assert [b["i"] for b in _AsyncRange(4, async_loader_queue_size=0)] == \
        list(range(4))
    with pytest.raises(KeyError, match="source broke"):
        list(_AsyncRange(6, fail_at=3, async_loader_queue_size=2))
    loader = _AsyncRange(100, async_loader_queue_size=2)
    for b in loader:
        if b["i"] == 2:
            break  # abandoned: the fill thread must be released
    assert not loader._async_thread.is_alive()


def test_sharded_loader_places_batches_and_refuses_a_mesh():
    loader = ShardedDataLoader(_Range(3), device="cpu")
    assert len(loader) == 3
    out = list(loader)
    assert all(torch.is_tensor(b["x"]) and b["x"].device.type == "cpu"
               for b in out)
    assert [int(b["i"]) for b in out] == [0, 1, 2]
    with pytest.raises(NotImplementedError, match="entry 11"):
        ShardedDataLoader(_Range(3), mesh=object())


@pytest.mark.parametrize("size", [0, 1, 2, 5])
def test_device_prefetch_on_the_cpu(size):
    batches = [(np.arange(4) + i, {"y": torch.tensor([i])})
               for i in range(6)]
    out = list(device_prefetch(iter(batches), device="cpu", size=size))
    assert len(out) == 6
    for i, (x, d) in enumerate(out):
        assert torch.equal(x, torch.arange(4) + i)
        assert torch.equal(d["y"], torch.tensor([i]))
