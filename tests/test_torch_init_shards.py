"""Init straight into the shards: each rank builds its model on the meta
device and draws only its own slices, one parameter at a time
(``parallel/sharding.materialize_shards``, ``build_stage``,
``FullyShardedOptimizer.bind(materialize=)``), bitwise what building the
whole model from seed 0 and slicing it gives.

A gloo world of four worker processes builds ``make_lm_train_step`` on
each mesh (fsdp = 4, tp = 4, dp = 2 x fsdp = 2, fsdp = 2 x tp = 2) at a
small config (2 layers, width 64, vocab 128; GPT-2-style on the first
two, Llama-style with rope and an untied head on the others), then the
same step with the whole-then-slice weights loaded into it, and takes
one AdamW step on each: every rank's parameters and its ``exp_avg`` and
``exp_avg_sq`` must be bitwise the same. The same world builds the FSDP
step, whose rows must be bitwise today's ``bind`` of the whole model.

In this process, on unbound meshes (a rank's build reads only its
coordinates): each stage of pp = 4 (4 layers) holds bitwise the whole
model's blocks and no other block; a rank's peak live tensor bytes
during the build stay within its specs' reckoning
(``fsdp_axis.param_counts``, 4 bytes an element) plus the largest whole
parameter plus the computed rope tables, counted by :class:`_LiveBytes`,
a ``TorchDispatchMode`` that keeps a weak reference to the storage of
every CPU tensor an operator returns and sums those still alive after
each operator; a whole build exceeds that bound. Two injected faults
must fail the bitwise check: drawing the parameters in a shuffled order,
and keeping a neighbour's slices.
"""

import os
import pathlib
import socket
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel import fsdp_axis
from horovod_tpu_torch.parallel import mesh as pm
from horovod_tpu_torch.parallel import pipeline as pl
from horovod_tpu_torch.parallel import sharding as sh
from horovod_tpu_torch.parallel.train import build_sharded

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 4
CFGS = {
    "gpt2": dict(vocab_size=128, num_layers=2, num_heads=4, hidden_size=64,
                 max_seq_len=16),
    "llama": dict(vocab_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
                  hidden_size=64, mlp_ratio=2.0, max_seq_len=16,
                  norm="rmsnorm", position="rope", activation="swiglu",
                  tie_embeddings=False),
}
#: name -> (config, mesh axes)
MESHES = {
    "fsdp4": ("gpt2", dict(fsdp=4)),
    "tp4": ("gpt2", dict(tp=4)),
    "dp2_fsdp2": ("llama", dict(dp=2, fsdp=2)),
    "fsdp2_tp2": ("llama", dict(fsdp=2, tp=2)),
}

_WORKER = r'''
import functools
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.optim.fsdp import FullyShardedOptimizer
from horovod_tpu_torch.parallel.mesh import make_mesh
from horovod_tpu_torch.parallel.sharding import batch_slices, local_slice

out, cfgs, meshes = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
hvd.init(device="cpu")
tokens = torch.load(out + "/tokens.pt")
adamw = functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-2)


def whole(cfg):
    return tt.Transformer(cfg).init_params(torch.Generator().manual_seed(0))


res = {}
for name, (cname, axes) in meshes.items():
    cfg = tt.TransformerConfig(dtype=torch.float32, **cfgs[cname])
    mesh = make_mesh(**axes)
    full = dict(whole(cfg).named_parameters())
    rows, _ = batch_slices(mesh, *tokens.shape)
    runs = {}
    for kind in ("drawn", "sliced"):
        model, step = hvd.make_lm_train_step(cfg, adamw, device="cpu",
                                             mesh=mesh)
        if kind == "sliced":
            model.load_state_dict({
                n: t if step.specs is None
                else local_slice(t, step.specs[n], mesh)
                for n, t in full.items()})
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        step(tokens[rows])
        state = step.optimizer.state
        runs[kind] = {"params": params, "moments": {
            n: (state[p]["exp_avg"].clone(), state[p]["exp_avg_sq"].clone())
            for n, p in model.named_parameters()}}
    res[name] = runs
cfg = tt.TransformerConfig(dtype=torch.float32, **cfgs["gpt2"])
model, step = hvd.make_lm_train_step(cfg, FullyShardedOptimizer(adamw),
                                     device="cpu")
drawn = [s.detach().clone() for s in step.optimizer.shards]
meta = all(p.device.type == "meta" for p in model.parameters())
rows, _ = batch_slices(hvd.mesh(), *tokens.shape)
loss = float(step(tokens[rows]))
bound = FullyShardedOptimizer(adamw, whole(cfg).named_parameters())
res["fsdp"] = {"drawn": drawn, "bound": [s.clone() for s in bound.shards],
               "meta": meta, "loss": loss}
torch.save(res, out + "/rank%d.pt" % hvd.rank())
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cfg(name, **kw):
    return tt.TransformerConfig(dtype=torch.float32, **{**CFGS[name], **kw})


def _whole(cfg):
    """The whole model from seed 0: the reference every build is held to."""
    return dict(tt.Transformer(cfg).init_params(
        torch.Generator().manual_seed(0)).named_parameters())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("init_shards")
    tokens = np.random.RandomState(0).randint(0, 128, (4, 16))
    torch.save(torch.from_numpy(tokens), tmp / "tokens.pt")
    port = _free_port()
    procs = []
    for r in range(N):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(N),
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp), repr(CFGS),
             repr(MESHES)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=150)[0])
        finally:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(N)]


def _mismatched(got, want):
    """Names whose tensors differ in shape or in any bit."""
    assert set(got) == set(want), set(got) ^ set(want)
    return sorted(n for n in want if got[n].shape != want[n].shape
                  or not torch.equal(got[n], want[n]))


@pytest.mark.parametrize("name", list(MESHES))
def test_rank_build_is_whole_then_slice(world, name):
    """Each rank's parameters, and after one step its AdamW moments, are
    bitwise those of the same step on the whole model's slices."""
    for r in range(N):
        drawn, sliced = world[r][name]["drawn"], world[r][name]["sliced"]
        assert not _mismatched(drawn["params"], sliced["params"]), r
        for i in range(2):
            moment = {n: m[i] for n, m in drawn["moments"].items()}
            want = {n: m[i] for n, m in sliced["moments"].items()}
            assert not _mismatched(moment, want), (r, i)


def test_fsdp_rows_are_todays_bind(world):
    """The FSDP step's rows, drawn parameter by parameter into the
    model's meta parameters' layout, are bitwise ``bind`` of the whole
    model's values on every rank of the world of four; the model stays
    on the meta device and the step runs on the rows."""
    for r in range(N):
        got = world[r]["fsdp"]
        assert got["meta"], r
        assert len(got["drawn"]) == len(got["bound"])
        for a, b in zip(got["drawn"], got["bound"]):
            assert a.shape == b.shape and torch.equal(a, b), r
        assert np.isfinite(got["loss"])


class _LiveBytes(TorchDispatchMode):
    """The peak bytes of the CPU storages the operators under the mode
    returned that are still alive (a weak reference a storage), read
    after each operator."""

    def __init__(self):
        super().__init__()
        self.live = {}
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                s = t.untyped_storage()
                ref = self.live.get(s.data_ptr())
                if ref is None or ref[0]() is not s:
                    self.live[s.data_ptr()] = (weakref.ref(s), s.nbytes())
        self.peak = max(self.peak, sum(n for ref, n in self.live.values()
                                       if ref() is not None))
        return out


def _bound(cfg, specs, mesh, names):
    """A rank's reckoning of ``names`` under ``specs`` (4 bytes an
    element) plus the largest whole parameter and the rope tables."""
    with torch.device("meta"):
        model = tt.Transformer(cfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()
              if n in names}
    specs = specs or {n: () for n in shapes}
    held, _ = fsdp_axis.param_counts(specs, shapes, mesh)
    largest = max(p.numel() for p in model.parameters())
    rope = 2 * cfg.max_seq_len * cfg.head_dim // 2 \
        if cfg.position == "rope" else 0
    return 4 * (held + largest + rope)


@pytest.mark.parametrize("name", list(MESHES))
def test_build_peak_within_reckoning(name):
    """Every rank of the mesh, built alone on an unbound mesh of its
    coordinates: bitwise the whole model's slices, and its peak live
    bytes during the build within the reckoning plus one whole
    parameter."""
    cname, axes = MESHES[name]
    cfg = _cfg(cname)
    whole = _whole(cfg)
    for r in range(N):
        mesh = pm.make_mesh(world=N, rank=r, **axes)
        with _LiveBytes() as live:
            model, specs = build_sharded(cfg, mesh, "cpu")
        got = dict(model.named_parameters())
        want = {n: sh.local_slice(t, specs[n], mesh) for n, t in whole.items()}
        assert not _mismatched(got, want), r
        assert live.peak <= _bound(cfg, specs, mesh, got), (r, live.peak)


def test_peak_tracker_sees_a_whole_build():
    """The count is live: building the whole model and slicing it, as
    the step did before, peaks above a rank's bound on fsdp = 4."""
    cfg = _cfg("gpt2")
    mesh = pm.make_mesh(world=N, rank=0, fsdp=4)
    _, specs = build_sharded(cfg, mesh, "cpu")
    with _LiveBytes() as live:
        model = tt.Transformer(cfg).init_params(
            torch.Generator().manual_seed(0))
        local = {n: sh.local_slice(p, specs[n], mesh).clone()
                 for n, p in model.named_parameters()}
    assert local and live.peak > _bound(cfg, specs, mesh, local)


@pytest.mark.parametrize("stage", range(N))
def test_stage_build_is_the_whole_models(stage):
    """``build_stage`` on each stage of pp = 4 (4 layers): bitwise the
    whole model's blocks and replicated rest, no other block held, and
    no other block resident during the build (its peak within the
    stage's bytes plus one whole parameter)."""
    cfg = _cfg("llama", num_layers=4)
    whole = _whole(cfg)
    mesh = pm.make_mesh(world=N, rank=stage, pp=N)
    with _LiveBytes() as live:
        model = pl.build_stage(cfg, mesh, device="cpu")
    got = dict(model.named_parameters())
    blocks = {n.split(".")[0] for n in got if n.startswith("block_")}
    assert blocks == {f"block_{stage}"}
    assert not _mismatched(got, {n: whole[n] for n in got})
    assert live.peak <= _bound(cfg, None, mesh, got), live.peak


def _shuffled_order(monkeypatch):
    order = tt.Transformer._init_order

    def shuffled(self):
        items = list(order(self))
        np.random.RandomState(1).shuffle(items)
        yield from items

    monkeypatch.setattr(tt.Transformer, "_init_order", shuffled)


def _neighbours_slices(monkeypatch):
    local_slice = sh.local_slice

    def neighbours(t, spec, mesh, rank=None):
        return local_slice(t, spec, mesh, (mesh.rank + 1) % mesh.size)

    monkeypatch.setattr(sh, "local_slice", neighbours)


@pytest.mark.parametrize("fault", [_shuffled_order, _neighbours_slices],
                         ids=["shuffled_order", "neighbours_slices"])
def test_injected_fault_fails(monkeypatch, fault):
    """A build that draws in another order, or keeps another rank's
    slices, is caught by the bitwise check."""
    cfg = _cfg("gpt2")
    whole = _whole(cfg)
    mesh = pm.make_mesh(world=N, rank=1, fsdp=4)
    want_slices = sh.local_slice
    fault(monkeypatch)
    model, specs = build_sharded(cfg, mesh, "cpu")
    want = {n: want_slices(t, specs[n], mesh) for n, t in whole.items()}
    assert _mismatched(dict(model.named_parameters()), want)
