"""The port's ``make_lm_train_step`` on tensor- and sequence-parallel
meshes against the JAX package's, in a world of four.

Four worker processes over gloo (the launcher's slot environment) build
the step on each mesh, load their shards of the same numpy weights
(``models/convert.shards_from_flax``) and take four steps on their rows
of one global batch ``[4, 16]`` (rows 2-3 padded with -1 from position
9, so the data ranks and the sp spans count unevenly many targets);
the JAX package jits its step on the same mesh over four of the
conftest's CPU devices with ``optax.adam`` (lr 1e-3, eps 1e-6) where
the port steps ``torch.optim.Adam`` at the same hyper-parameters.
float32 throughout. The meshes:

* ``dp=2,tp=2``, a GPT-2-style model (vocab 61: not divisible, the
  embedding whole on every rank);
* ``tp=4``, a Llama-style model (RMSNorm, RoPE, SwiGLU, GQA with 2 kv
  heads of 4: the k/v kernels whole beside split query heads; untied,
  vocab 64 split over tp);
* ``dp=2,sp=2`` with ring attention, the Llama-style model;
* ``sp=4`` with Ulysses, the GPT-2-style model.

Held: the losses (the same on every rank) within 1e-5 relative of the
JAX step's at each step; each rank's parameters after four steps within
the data-parallel parity tests' tolerance (1e-6 + 1% of the most Adam
can move them, lr a step for the attention key biases, whose true
gradient is 0) of its slice of the JAX step's.

The same steps of ``tp=4`` and ``sp=4`` run again in this process on
meshes of four emulated ranks (threads exchanging through
``parallel/comm.ThreadComm``): losses and every parameter bitwise the
gloo world's. A ``FullyShardedOptimizer`` on ``fsdp=4`` (its one data
axis) takes the losses of the mesh-less FSDP step bitwise. What the
mesh path does not take raises (``test_refusals``); a live fsdp axis
under a replicated optimizer is tests/test_torch_fsdp_axis.py's.
"""

import functools
import os
import pathlib
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel import make_mesh as jmake_mesh
from horovod_tpu.parallel import make_param_shardings as jshardings
from horovod_tpu.parallel import train as jtrain

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import (params_from_flax,
                                              shards_from_flax)
from horovod_tpu_torch.parallel import comm as pc
from horovod_tpu_torch.parallel import mesh as pm
from horovod_tpu_torch.parallel.sharding import batch_slices

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 4
LR, EPS, STEPS = 1e-3, 1e-6, 4
CFGS = {
    "gpt2": dict(vocab_size=61, num_layers=2, num_heads=4, hidden_size=32,
                 max_seq_len=16),
    "llama": dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                  hidden_size=32, mlp_ratio=2.0, max_seq_len=16,
                  norm="rmsnorm", position="rope", activation="swiglu",
                  tie_embeddings=False),
}
#: name -> (config, mesh axes, sequence_parallel)
SCENARIOS = {
    "dp2_tp2": ("gpt2", dict(dp=2, tp=2), None),
    "tp4": ("llama", dict(tp=4), None),
    "dp2_sp2_ring": ("llama", dict(dp=2, sp=2), "ring"),
    "sp4_ulysses": ("gpt2", dict(sp=4), "ulysses"),
}
EMULATED = ("tp4", "sp4_ulysses")

_WORKER = r'''
import functools
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import shards_from_flax
from horovod_tpu_torch.parallel.mesh import make_mesh
from horovod_tpu_torch.parallel.sharding import batch_slices

out, lr, eps, steps = sys.argv[1], float(sys.argv[2]), float(sys.argv[3]), int(sys.argv[4])
cfgs, scenarios = eval(sys.argv[5]), eval(sys.argv[6])
hvd.init(device="cpu")
data = torch.load(out + "/data.pt", weights_only=False)
adam = functools.partial(torch.optim.Adam, lr=lr, eps=eps)
res = {}
for name, (cname, axes, sp) in scenarios.items():
    cfg = tt.TransformerConfig(dtype=torch.float32, **cfgs[cname])
    mesh = make_mesh(**axes)
    model, step = hvd.make_lm_train_step(cfg, adam, device="cpu",
                                         mesh=mesh, sequence_parallel=sp)
    model.load_state_dict(shards_from_flax(data["params"][cname], mesh))
    rows, _ = batch_slices(mesh, *data["tokens"].shape)
    tokens = data["tokens"][rows]
    res[name] = {"losses": [float(step(tokens)) for _ in range(steps)],
                 "params": {k: v.clone()
                            for k, v in model.state_dict().items()}}
# a FullyShardedOptimizer on its one data axis, and without a mesh
cfg = tt.TransformerConfig(dtype=torch.float32, **cfgs["gpt2"])
tokens = data["tokens"][hvd.rank():hvd.rank() + 1]
for name, mesh in (("fsdp_mesh", "fsdp=4"), ("fsdp_plain", None)):
    _, step = hvd.make_lm_train_step(
        cfg, hvd.FullyShardedOptimizer(adam), device="cpu", mesh=mesh)
    res[name] = [float(step(tokens)) for _ in range(2)]
torch.save(res, out + "/rank%d.pt" % hvd.rank())
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tokens():
    tokens = np.random.RandomState(0).randint(0, 61, (4, 16)).astype(
        np.int64)
    tokens[2:, 9:] = -1
    return tokens


def _flax_params(cname):
    jmod = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32,
                                               **CFGS[cname]))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                jnp.ones((1, 4), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _jax_run(cname, axes, sp, params, tokens):
    """STEPS of the JAX package's make_lm_train_step on the mesh: its
    losses and parameters after (numpy flax trees)."""
    mesh = jmake_mesh(devices=jax.devices()[:N], **axes)
    cfg = jt.TransformerConfig(dtype=jnp.float32, **CFGS[cname])
    opt = optax.adam(LR, eps=EPS)
    _, step, batch_sharding = jtrain.make_lm_train_step(
        cfg, opt, mesh, sequence_parallel=sp, donate=False)
    p = jax.device_put(params, jshardings(params, mesh))
    state = opt.init(p)
    tok = jax.device_put(jnp.asarray(tokens), batch_sharding)
    losses = []
    for _ in range(STEPS):
        p, state, loss = step(p, state, tok)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


def _param_errors(got, want):
    """Each parameter's largest difference over its tolerance."""
    out = {}
    for name, w in want.items():
        tol = (STEPS * LR * 1.01 if name.endswith("attn.key.bias")
               else 1e-6 + 1e-2 * STEPS * LR)
        out[name] = float((got[name] - w).abs().max()) / tol
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The gloo world's results, the JAX step's, and the inputs."""
    tmp = tmp_path_factory.mktemp("parallel_train")
    params = {c: _flax_params(c) for c in CFGS}
    tokens = _tokens()
    torch.save({"params": params, "tokens": torch.from_numpy(tokens)},
               tmp / "data.pt")
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
            [sys.executable, "-c", _WORKER, str(tmp), repr(LR), repr(EPS),
             str(STEPS), repr(CFGS), repr(SCENARIOS)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        # the four JAX steps compile at once while the workers run
        with ThreadPoolExecutor(len(SCENARIOS)) as ex:
            futs = {name: ex.submit(_jax_run, cname, axes, sp,
                                    params[cname], tokens)
                    for name, (cname, axes, sp) in SCENARIOS.items()}
            jax_res = {name: f.result() for name, f in futs.items()}
    finally:
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=150)[0])
            finally:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    res = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(N)]
    return {"params": params, "tokens": tokens, "jax": jax_res,
            "ranks": res}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_step_matches_jax(world, name):
    cname, axes, _ = SCENARIOS[name]
    want_losses, want_params = world["jax"][name]
    layout = pm.make_mesh(world=N, **axes)
    for r in range(N):
        got = world["ranks"][r][name]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5,
                                   err_msg=f"{name} rank {r}")
        want = shards_from_flax(want_params, layout, rank=r)
        errs = _param_errors(got["params"], want)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1, (
            f"{name} rank {r}: {worst} is {errs[worst]:.2f}x its tolerance")


def _emulate(name, params, tokens):
    """The scenario's steps on four ranks emulated by threads."""
    cname, axes, sp = SCENARIOS[name]
    cfg = tt.TransformerConfig(dtype=torch.float32, **CFGS[cname])
    layout = pm.make_mesh(world=N, **axes)
    (axis,) = axes
    tw = pc.ThreadWorld(N, timeout=60.0)
    adam = functools.partial(torch.optim.Adam, lr=LR, eps=EPS)

    def rank(r):
        mesh = pm.Mesh(layout.axis_names, layout.shape, r,
                       comms={axis: pc.ThreadComm(tw, r)})
        model, step = hvd.make_lm_train_step(
            cfg, adam, device="cpu", mesh=mesh, sequence_parallel=sp)
        model.load_state_dict(shards_from_flax(params[cname], mesh))
        rows, _ = batch_slices(mesh, *tokens.shape)
        t = torch.from_numpy(tokens[rows])
        return {"losses": [float(step(t)) for _ in range(STEPS)],
                "params": {k: v.clone()
                           for k, v in model.state_dict().items()}}

    return pc.run_ranks([tw], rank, N)


@pytest.mark.parametrize("name", EMULATED)
def test_emulated_world_is_bitwise_the_gloo_world(world, name):
    hvd.init(device="cpu")
    try:
        emulated = _emulate(name, world["params"], world["tokens"])
    finally:
        hvd.shutdown()
    for r in range(N):
        got, want = emulated[r], world["ranks"][r][name]
        assert got["losses"] == want["losses"], (name, r)
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], v), (name, r, k)


def test_fully_sharded_on_its_one_data_axis(world):
    for r in range(N):
        assert world["ranks"][r]["fsdp_mesh"] == \
            world["ranks"][r]["fsdp_plain"]
        assert np.isfinite(world["ranks"][r]["fsdp_mesh"]).all()


def test_global_mean_over_uneven_padding(world):
    """The four meshes split the padded rows differently (dp halves,
    sp spans), yet every loss is the global batch's mean: the JAX
    step's, the same on every rank, and not the mean of the ranks' own
    means."""
    tokens = world["tokens"]
    cfg = tt.TransformerConfig(dtype=torch.float32, **CFGS["gpt2"])
    model = tt.Transformer(cfg)
    model.load_state_dict(params_from_flax(world["params"]["gpt2"]))
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        want, _ = tt.causal_lm_loss(model(t), t)
        halves = [tt.causal_lm_loss(model(t[i:i + 2]), t[i:i + 2])[0]
                  for i in (0, 2)]
    for name in ("dp2_tp2", "sp4_ulysses"):
        first = [world["ranks"][r][name]["losses"][0] for r in range(N)]
        assert len(set(first)) == 1, (name, first)
        np.testing.assert_allclose(first[0], float(want), rtol=1e-5)
        assert abs(first[0] - float(sum(halves)) / 2) > 1e-4


def test_refusals():
    """What the mesh path does not take raises, as the JAX package's
    step does (a FullyShardedOptimizer with sequence parallelism, or
    with live axes other than its one data axis: ValueError), naming
    where the work is done instead (a live pp or ep axis, which the JAX
    step's rules never name, so that there it only repeats the same
    work: ValueError naming ``pipeline_lm_train_step_1f1b`` and
    ``MoeMlp``), or saying that the JAX step has no fused loss (the
    fused loss with a vocab split over tp: ValueError). A bindable
    optimizer on an emulated mesh with a live dp axis has no process set
    to bind to (ValueError), where a plain factory averages that axis
    through its communicator. A live fsdp
    axis under a replicated optimizer builds (tests/test_torch_fsdp_axis.py
    trains it): each rank keeps half of every fsdp dimension. The meshes
    are layouts whose live axes carry a stand-in communicator: each call
    raises, or builds, before any exchange."""
    cfg = tt.TransformerConfig(dtype=torch.float32, **CFGS["llama"])
    adam = functools.partial(torch.optim.Adam, lr=LR)

    def mesh(**axes):
        names, shape = zip(*axes.items())
        return pm.Mesh(names, shape, 0,
                       comms={a: pc.SelfComm() for a in names})

    def build(opt=adam, **kw):
        return hvd.make_lm_train_step(cfg, opt, device="cpu", **kw)

    hvd.init(device="cpu")
    try:
        fsdp = hvd.FullyShardedOptimizer(adam)
        with pytest.raises(ValueError, match="sequence parallelism"):
            build(fsdp, sequence_parallel="ring")
        with pytest.raises(ValueError, match="extra live axes"):
            build(fsdp, mesh=mesh(fsdp=2, tp=2))
        with pytest.raises(ValueError, match="data axes"):
            build(fsdp, mesh=mesh(dp=2, fsdp=2))
        model, step = build(mesh=mesh(fsdp=2))
        kernel = model.block_0.mlp.gate.kernel
        assert step.specs["block_0.mlp.gate.kernel"] == ("fsdp", None)
        assert kernel.shape == (cfg.hidden_size // 2, cfg.mlp_dim)
        assert step.fsdp is not None
        for axes in ({"dp": 2}, {"dp": 2, "fsdp": 2}):
            with pytest.raises(ValueError, match="no process set"):
                build(hvd.ShardedOptimizer(adam), mesh=mesh(**axes))
        with pytest.raises(ValueError, match="pipeline_lm_train_step_1f1b"):
            build(mesh=mesh(pp=2))
        with pytest.raises(ValueError, match="MoeMlp"):
            build(mesh=mesh(ep=2))
        with pytest.raises(ValueError, match="no fused loss"):
            build(mesh=mesh(tp=2), fused_ce=True)
        with pytest.raises(ValueError, match="sequence_parallel"):
            build(mesh=mesh(sp=2))
        with pytest.raises(ValueError, match="attention"):
            build(sequence_parallel="ulysses",
                  attention_fn=lambda q, k, v: q)
        with pytest.raises(ValueError, match="'ring' or 'ulysses'"):
            build(sequence_parallel="star")
        with pytest.raises(ValueError, match="none of"):
            build(mesh=mesh(hvd=2))
    finally:
        hvd.shutdown()
