"""The autotuner on the port's training paths, on the CPU:

* ``parallel.tune_lm_train_step`` at 2 layers x 64 wide: the sweep
  builds the real step per candidate, each candidate's optimizer
  planned at the candidate's threshold and issuing as its
  ``ordered_buckets`` says, each candidate's model freed before the
  next is drawn; the warm start pins from the cache with zero tuning
  builds; the final step is bitwise an untuned build under the pinned
  knobs; and a gloo world of two with a skewed clock on rank 1 pins
  identical winners;
* ``ordered_buckets`` in gloo worlds of two, for the
  ``DistributedOptimizer`` and the ZeRO-1 ``ShardedOptimizer``: on and
  off give bitwise-equal parameters, and off issues no bucket before
  ``synchronize()``;
* the BERT example's ``--autotune-spmd`` at a tiny size in a world of
  two: each candidate's plan has the candidate's bucket count, and
  every gradient is reduced once (one hook a parameter after the
  sweep, each element in one bucket of the step).

Winners come from an injected clock that reads the applied knobs,
never from wall time.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMMON = r'''
import functools
import json
import os
import sys
import weakref

import numpy as np
import torch

torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.models.transformer import TransformerConfig
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops.autotune import OnlineTuner
from horovod_tpu_torch.parallel import train

CFG = TransformerConfig(vocab_size=128, num_layers=2, num_heads=2,
                        hidden_size=64, max_seq_len=32, dtype=torch.float32)
THRESHOLDS = [8 << 10, 64 << 10]
COST = {128 << 20: 1.0, 8 << 10: 0.6, 64 << 10: 0.8}


def adamw():
    return functools.partial(torch.optim.AdamW, lr=1e-3)


def tokens(rank=0, rows=4):
    rng = np.random.RandomState(100 + rank)
    return torch.from_numpy(rng.randint(0, CFG.vocab_size, (rows, 32)))


class KnobClock:
    """Each timed step reads ``cost(knobs)`` seconds: the clock's second
    read of a pair advances it by the cost of the knobs applied."""

    def __init__(self, knobs, sign=1.0):
        self.knobs, self.sign, self.t, self.n = knobs, sign, 0.0, 0

    def __call__(self):
        self.n += 1
        if self.n % 2 == 0:
            k = self.knobs
            cost = COST[k.fusion_threshold_bytes]
            cost += 0.0 if k.ordered_buckets else -0.05
            cost += {"off": 0.03, "stage": 0.0, "double": 0.01}[
                k.overlap_schedule]
            self.t += cost if self.sign > 0 else 2.0 - cost
        return self.t


class Builds:
    """Spy on ``make_lm_train_step``: each build's knobs, bucket count
    against the plan at the knob's threshold, the optimizer's issue
    mode, and whether every earlier build's model was freed first."""

    def __init__(self):
        self.rows, self.models, self.real = [], [], train.make_lm_train_step
        train.make_lm_train_step = self

    def __call__(self, *a, **k):
        freed = all(ref() is None for ref in self.models)
        model, step = self.real(*a, **k)
        knobs = global_state().knobs
        named = sorted(model.named_parameters(),
                       key=lambda np_: fusion.flax_path(np_[0]))
        want = len(fusion.pytree_bucket_plan(
            [(fusion.flax_path(n), tuple(p.shape), p.dtype)
             for n, p in named],
            threshold_bytes=knobs.fusion_threshold_bytes))
        self.rows.append({
            "threshold": knobs.fusion_threshold_bytes,
            "ordered": knobs.ordered_buckets,
            "opt_ordered": step.optimizer._ordered,
            "buckets": len(step.optimizer.bucket_plan),
            "want_buckets": want, "freed_before": freed})
        self.models.append(weakref.ref(model))
        return model, step


def run_steps(step, model, toks, n=2):
    losses = [step(toks).item() for _ in range(n)]
    return losses, {k: v.detach().clone() for k, v in
                    model.state_dict().items()}
'''

_TUNE_WORKER = _COMMON + r'''
out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
knobs = global_state().knobs
builds = Builds()
toks = tokens(r)
tuner = OnlineTuner(thresholds=THRESHOLDS, warmup=1, measure=2,
                    cache_path=os.path.join(out, f"cache{r}.json"),
                    clock=KnobClock(knobs, 1.0 if r == 0 else -1.0))
model, step, config = train.tune_lm_train_step(CFG, adamw, toks,
                                               tuner=tuner)
local = {}
for row in tuner.trials:
    if row["dimension"] == "fusion_threshold_bytes":
        local[row["fusion_threshold_bytes"]] = row["step_s"]
tuned, tuned_sd = run_steps(step, model, toks)
train.make_lm_train_step = builds.real
del model, step
# untuned build under the pinned knobs, the same tokens
model, step = train.make_lm_train_step(CFG, adamw())
plain, plain_sd = run_steps(step, model, toks)
res = {"config": config, "rows": builds.rows, "trials": tuner.trials,
       "local_argmin": min(local, key=local.get),
       "knobs": {k: getattr(knobs, k) for k in config},
       "losses": tuned, "plain": plain,
       "bitwise": all(torch.equal(tuned_sd[k], plain_sd[k])
                      for k in plain_sd),
       "digest": float(sum(v.double().sum() for v in tuned_sd.values()))}
with open(os.path.join(out, f"rank{r}.json"), "w") as f:
    json.dump(res, f)
hvd.shutdown()
'''


def _spawn_world(code, tmp_path, n=2, timeout=150, args=()):
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
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(tmp_path), *args], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
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
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(n)]


@pytest.fixture
def world1(monkeypatch):
    import horovod_tpu_torch as hvd

    for k in list(os.environ):
        if k.startswith(("HOROVOD_", "HVD_TPU_")):
            monkeypatch.delenv(k)
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _check_builds(rows, n_candidates):
    """Every build's plan is the candidate threshold's plan, its
    optimizer issues as the candidate's ordered_buckets says, and every
    earlier model was freed before it was drawn."""
    assert len(rows) == n_candidates + 1  # the candidates, the final
    for row in rows:
        assert row["buckets"] == row["want_buckets"], row
        assert row["opt_ordered"] == row["ordered"], row
        assert row["freed_before"], row
    counts = {row["threshold"]: row["buckets"] for row in rows}
    assert len(set(counts.values())) == 3, counts  # 128 MiB, 64 KiB, 8 KiB


def test_tune_lm_train_step_sweeps_then_warm_starts(world1, tmp_path):
    """World 1: the sweep times the six candidates (three thresholds,
    the ordered flip, two overlap modes), pins the clock's winner into
    the knobs and the cache (schema 2, the tuned knob list); the final
    step is bitwise an untuned build under the pinned knobs; a second
    run on the same cache pins from it with zero tuning builds (one
    build: the final) and the same configuration."""
    exec(compile(_COMMON, "<common>", "exec"), ns := {})
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.ops.autotune import (KNOB_SCHEMA_VERSION,
                                                TuneCache)

    knobs = global_state().knobs
    cache = str(tmp_path / "cache.json")
    builds = ns["Builds"]()
    try:
        toks = ns["tokens"]()
        tuner = ns["OnlineTuner"](thresholds=ns["THRESHOLDS"], warmup=1,
                                  measure=2, cache_path=cache,
                                  clock=ns["KnobClock"](knobs))
        model, step, config = ns["train"].tune_lm_train_step(
            ns["CFG"], ns["adamw"], toks, tuner=tuner)
        assert tuner.pin_source == "sweep" and tuner.compiles == 6
        assert not [r for r in tuner.trials if "error" in r]
        assert config == {"fusion_threshold_bytes": 8 << 10,
                          "ordered_buckets": False,
                          "overlap_schedule": "stage"}
        assert {k: getattr(knobs, k) for k in config} == config
        _check_builds(builds.rows, 6)
        (entry,) = json.load(open(cache))["entries"].values()
        assert entry["schema"] == KNOB_SCHEMA_VERSION
        assert entry["knobs"] == sorted(config)
        assert entry["config"] == config
        tuned, tuned_sd = ns["run_steps"](step, model, toks)
        del model, step
        model, step = builds.real(ns["CFG"], ns["adamw"]())
        plain, plain_sd = ns["run_steps"](step, model, toks)
        assert tuned == plain and all(np.isfinite(tuned))
        assert all(torch.equal(tuned_sd[k], plain_sd[k]) for k in plain_sd)
        del model, step

        # the warm start: a fresh knob set, the same cache
        knobs.fusion_threshold_bytes = 128 << 20
        knobs.ordered_buckets = True
        knobs.overlap_schedule = "off"
        builds.rows.clear()
        t2 = ns["OnlineTuner"](thresholds=ns["THRESHOLDS"], warmup=1,
                               measure=2, cache_path=cache)
        _, _, config2 = ns["train"].tune_lm_train_step(
            ns["CFG"], ns["adamw"], toks, tuner=t2)
        assert t2.pin_source == "cache" and t2.compiles == 0
        assert config2 == config and not t2.trials
        assert len(builds.rows) == 1 and builds.rows[0]["threshold"] == 8 << 10
        assert TuneCache(cache).lookup(next(iter(
            json.load(open(cache))["entries"]))) == entry
    finally:
        ns["train"].make_lm_train_step = builds.real


def test_tune_lm_train_step_world2_pins_identical_winners(tmp_path):
    """A gloo world of two, rank 1's clock reversed: the ranks' own
    clocks prefer different thresholds, yet both pin rank 0's winners
    through the world's agreement, build the same candidates, and
    train the same weights; only rank 0 writes the cache; each rank's
    final step is bitwise an untuned build under the pinned knobs."""
    r0, r1 = _spawn_world(_TUNE_WORKER, tmp_path)
    assert r0["local_argmin"] == 8 << 10
    assert r1["local_argmin"] == 128 << 20
    assert r0["config"] == r1["config"] == {
        "fusion_threshold_bytes": 8 << 10, "ordered_buckets": False,
        "overlap_schedule": "stage"}
    assert r0["knobs"] == r1["knobs"] == r0["config"]
    assert [row["threshold"] for row in r0["rows"]] == \
        [row["threshold"] for row in r1["rows"]]
    for r in (r0, r1):
        _check_builds(r["rows"], 6)
        assert r["losses"] == r["plain"] and r["bitwise"]
    assert r0["digest"] == r1["digest"]
    assert (tmp_path / "cache0.json").exists()
    assert not (tmp_path / "cache1.json").exists()


_ORDERED_WORKER = r'''
import functools
import json
import os
import sys

import torch

torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.state import global_state

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()


def run(kind, ordered):
    global_state().knobs.ordered_buckets = ordered
    torch.manual_seed(0)
    model = torch.nn.Sequential(*[torch.nn.Linear(16, 16)
                                  for _ in range(6)])
    named = [(f"layer_{n}", p) for n, p in model.named_parameters()]
    if kind == "zero":
        opt = hvd.ShardedOptimizer(
            functools.partial(torch.optim.Adam, lr=1e-2), named,
            fusion_threshold_bytes=1 << 10)
    else:
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2),
            named_parameters=named, fusion_threshold_bytes=1 << 10)
    g = torch.Generator().manual_seed(10 + r)
    issued, losses = [], []
    for _ in range(3):
        x = torch.randn(8, 16, generator=g)
        loss = model(x).square().mean()
        loss.backward()
        # what the hooks issued during the backward
        issued.append((opt._next, len(opt._pending)))
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
    return (issued, losses, len(opt.bucket_plan),
            {k: v.clone() for k, v in model.state_dict().items()})


res = {}
for kind in ("distributed", "zero"):
    on, off = run(kind, True), run(kind, False)
    res[kind] = {"on": on[:3], "off": off[:3],
                 "bitwise": all(torch.equal(on[3][k], off[3][k])
                                for k in on[3])}
with open(os.path.join(out, f"rank{r}.json"), "w") as f:
    json.dump(res, f)
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def ordered_world(tmp_path_factory):
    """One world of two running both optimizers, each with
    ``ordered_buckets`` on and off."""
    return _spawn_world(_ORDERED_WORKER, tmp_path_factory.mktemp("ordered"))


@pytest.mark.parametrize("kind", ["distributed", "zero"])
def test_ordered_buckets_bitwise_either_way(kind, ordered_world):
    """World of two: with ``ordered_buckets`` on the hooks issue every
    bucket during the backward, in plan order; off, none is issued
    before ``synchronize()``, which then issues them all in plan order;
    the parameters and losses are bitwise the same."""
    for res in (rank[kind] for rank in ordered_world):
        issued_on, losses_on, n = res["on"]
        issued_off, losses_off, n_off = res["off"]
        assert n == n_off > 2
        assert issued_on == [[n, n]] * 3
        assert issued_off == [[0, 0]] * 3
        assert losses_on == losses_off
        assert res["bitwise"]


_BERT_WORKER = r'''
import json
import os
import sys

import torch

torch.set_num_threads(1)
import torch.distributed as dist

from horovod_tpu_torch.examples import bert_pretraining
from horovod_tpu_torch.ops import fusion

out = sys.argv[1]
stats = {}
bert_pretraining.main(
    ["--device", "cpu", "--autotune-spmd", "--layers", "2", "--hidden",
     "192", "--seq-len", "16", "--batch-size", "2",
     "--num-warmup-batches", "1", "--num-batches-per-iter", "2",
     "--num-iters", "1"], stats)
step, batch = stats["step"], stats["batch"]
opt = step.optimizer
model_params = opt._params
hooks = [len(p._post_accumulate_grad_hooks or {}) for p in model_params]
reduced = []
real = dist.all_reduce


def counting(t, *a, **k):
    reduced.append(t.numel())
    return real(t, *a, **k)


dist.all_reduce = counting
step(*batch)
dist.all_reduce = real
named = sorted(zip(opt._names, model_params),
               key=lambda np_: fusion.flax_path(np_[0]))
leaves = [(fusion.flax_path(n), tuple(p.shape), p.dtype) for n, p in named]
want = {}
for ov, _ in stats["autotune_candidates"]:
    t = ov["fusion_threshold_bytes"]
    want[t] = len(fusion.pytree_bucket_plan(leaves, threshold_bytes=t))
res = {"candidates": stats["autotune_candidates"], "want": want,
       "hooks": hooks, "reduced": sum(reduced),
       "n_reductions": len(reduced), "buckets": len(opt.bucket_plan),
       "numel": sum(p.numel() for p in model_params),
       "losses": stats["losses"]}
with open(os.path.join(out, f"rank{int(os.environ['HOROVOD_RANK'])}.json"),
          "w") as f:
    json.dump(res, f)
'''


def test_bert_autotune_spmd_rebuilds_each_candidate(tmp_path):
    """The BERT example's ``--autotune-spmd`` in a world of two at a
    tiny size: the sweep times four thresholds and the ordered flip,
    each candidate's optimizer planned at its threshold (several
    buckets at 16 MiB, below the float32 embedding's 23 MB; one from 64
    MiB, above the model's 28 MB); after
    the sweep every parameter has one gradient hook, and a step reduces
    each element once."""
    for res in _spawn_world(_BERT_WORKER, tmp_path, timeout=240):
        cands = res["candidates"]
        assert [ov["fusion_threshold_bytes"] for ov, _ in cands][:4] == [
            16 << 20, 64 << 20, 128 << 20, 256 << 20]
        assert len(cands) == 5
        for ov, n in cands:
            assert n == res["want"][str(ov["fusion_threshold_bytes"])], cands
        assert cands[0][1] > 1 and cands[1][1] == 1
        assert res["hooks"] == [1] * len(res["hooks"])
        assert res["reduced"] == res["numel"]
        assert res["n_reductions"] == res["buckets"]
        assert all(np.isfinite(res["losses"]))
