"""A live fsdp axis under a replicated optimizer (ZeRO-3 by the rules):
the port's ``make_lm_train_step`` against the JAX package's, in a world
of four.

Four worker processes over gloo build the step on each mesh, load their
shards of the same numpy weights (``models/convert.shards_from_flax``:
under fsdp a rank's slices of the rules' fsdp dimensions) and take four
steps on their rows of one global batch ``[4, 16]`` (rows 2-3 padded
with -1 from position 9); the JAX package jits its step on the same mesh
over four of the conftest's CPU devices with ``optax.adam`` (lr 1e-3,
eps 1e-6), XLA gathering the weights and reduce-scattering their
gradients, where the port steps ``torch.optim.Adam`` at the same
hyper-parameters on its slices. float32 throughout. The meshes:

* ``fsdp=4``, a GPT-2-style model (vocab 61: the embedding splits over
  fsdp along its width only);
* ``dp=2,fsdp=2``, a Llama-style model (untied head, GQA);
* ``fsdp=2,tp=2``, the GPT-2-style model (the spec ``(fsdp, tp,
  None)`` gathers to the tp slice);
* ``fsdp=2,sp=2`` with ring attention, the Llama-style model.

Held: the losses within 1e-5 relative of the JAX step's at each step;
each rank's parameter slices after four steps within the data-parallel
tolerance (1e-6 + 1% of the most Adam can move them; lr a step for the
attention key biases, whose true gradient is 0) of its slices of the
JAX step's; each rank's parameter and Adam-state element counts equal
to the reckoning from the specs (``fsdp_axis.param_counts``).

The ``fsdp=4`` and ``dp=2,fsdp=2`` steps run again in this process on
four emulated ranks (``mesh.emulated_meshes``: threads over
``comm.ThreadComm``; the dp average through its communicator): losses
and every parameter bitwise the gloo world's. ``reduce_scatter`` on
every communicator (gloo ``GroupComm``, ``ThreadComm``, ``SelfComm``)
is bitwise the rank-order float32 sum of the chunks.
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
from horovod_tpu_torch.models.convert import shards_from_flax
from horovod_tpu_torch.parallel import comm as pc
from horovod_tpu_torch.parallel import fsdp_axis
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
    "fsdp4": ("gpt2", dict(fsdp=4), None),
    "dp2_fsdp2": ("llama", dict(dp=2, fsdp=2), None),
    "fsdp2_tp2": ("gpt2", dict(fsdp=2, tp=2), None),
    "fsdp2_sp2_ring": ("llama", dict(fsdp=2, sp=2), "ring"),
}
EMULATED = ("fsdp4", "dp2_fsdp2")
#: reduce_scatter's cases: (dtype, rows a rank)
RS_CASES = ((torch.float32, 8), (torch.bfloat16, 12))

_WORKER = r'''
import functools
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import shards_from_flax
from horovod_tpu_torch.parallel.comm import GroupComm
from horovod_tpu_torch.parallel.mesh import make_mesh
from horovod_tpu_torch.parallel.sharding import batch_slices

out, lr, eps, steps = sys.argv[1], float(sys.argv[2]), float(sys.argv[3]), int(sys.argv[4])
cfgs, scenarios, rs_cases = eval(sys.argv[5]), eval(sys.argv[6]), eval(sys.argv[7])
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
    losses = [float(step(tokens)) for _ in range(steps)]
    state = [t for s in step.optimizer.state.values() for k, t in s.items()
             if k != "step"]
    res[name] = {"losses": losses,
                 "params": {k: v.clone()
                            for k, v in model.state_dict().items()},
                 "specs": step.specs,
                 "state_numel": sum(t.numel() for t in state)}
comm = GroupComm()
res["reduce_scatter"] = [
    comm.reduce_scatter(data["rs"][i][hvd.rank()].to(dtype))
    for i, (dtype, _) in enumerate(rs_cases)]
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


def _rs_inputs():
    """Each reduce_scatter case's float32 inputs, ``[N ranks, N * rows,
    3]`` (the dtype cast is each side's)."""
    rng = np.random.RandomState(5)
    return [torch.from_numpy(rng.randn(N, N * rows, 3).astype(np.float32))
            for _, rows in RS_CASES]


def _rank_order_sum(parts):
    acc = parts[0].to(torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(torch.float32)
    return acc.to(parts[0].dtype)


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
    tmp = tmp_path_factory.mktemp("fsdp_axis")
    params = {c: _flax_params(c) for c in CFGS}
    tokens = _tokens()
    torch.save({"params": params, "tokens": torch.from_numpy(tokens),
                "rs": _rs_inputs()}, tmp / "data.pt")
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
             str(STEPS), repr(CFGS), repr(SCENARIOS), repr(RS_CASES)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
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
def test_fsdp_step_matches_jax(world, name):
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


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_rank_holds_its_specs_share(world, name):
    """A rank holds exactly its specs' share of the parameters and of
    Adam's two moments, and the fsdp dimensions are split."""
    cname, axes, _ = SCENARIOS[name]
    layout = pm.make_mesh(world=N, **axes)
    full = {n: tuple(v.shape) for n, v in
            shards_from_flax(world["params"][cname],
                             pm.make_mesh(world=1)).items()}
    for r in range(N):
        got = world["ranks"][r][name]
        specs = got["specs"]
        assert any(fsdp_axis.fsdp_dim(s) is not None
                   for s in specs.values()), name
        held, whole = fsdp_axis.param_counts(specs, full, layout)
        numel = sum(v.numel() for v in got["params"].values())
        assert numel == held < whole, (name, r, numel, held, whole)
        assert got["state_numel"] == 2 * held, (name, r)


def _emulate(name, params, tokens):
    """The scenario's steps on four ranks emulated by threads."""
    cname, axes, sp = SCENARIOS[name]
    cfg = tt.TransformerConfig(dtype=torch.float32, **CFGS[cname])
    meshes, worlds = pm.emulated_meshes(pm.make_mesh(world=N, **axes),
                                        timeout=60.0)
    adam = functools.partial(torch.optim.Adam, lr=LR, eps=EPS)

    def rank(r):
        mesh = meshes[r]
        model, step = hvd.make_lm_train_step(
            cfg, adam, device="cpu", mesh=mesh, sequence_parallel=sp)
        model.load_state_dict(shards_from_flax(params[cname], mesh))
        rows, _ = batch_slices(mesh, *tokens.shape)
        t = torch.from_numpy(tokens[rows])
        return {"losses": [float(step(t)) for _ in range(STEPS)],
                "params": {k: v.clone()
                           for k, v in model.state_dict().items()}}

    return pc.run_ranks(worlds, rank, N)


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


@pytest.mark.parametrize("case", range(len(RS_CASES)))
def test_reduce_scatter_is_the_rank_order_sum(world, case):
    """Rank r's chunk r of every rank's tensor, summed in rank order in
    float32 and rounded once: on gloo (the workers' ``GroupComm``), on
    emulated ranks (``ThreadComm``) and on one rank (``SelfComm``)."""
    dtype, rows = RS_CASES[case]
    inputs = [x.to(dtype) for x in _rs_inputs()[case]]
    want = [_rank_order_sum([x[r * rows:(r + 1) * rows] for x in inputs])
            for r in range(N)]
    for r in range(N):
        got = world["ranks"][r]["reduce_scatter"][case]
        assert got.dtype == dtype and torch.equal(got, want[r]), r
    tw = pc.ThreadWorld(N, timeout=30.0)
    emulated = pc.run_ranks(
        [tw], lambda r: pc.ThreadComm(tw, r).reduce_scatter(inputs[r]), N)
    for r in range(N):
        assert torch.equal(emulated[r], want[r]), r
    assert torch.equal(pc.SelfComm().reduce_scatter(inputs[0]), inputs[0])
    with pytest.raises(ValueError, match="does not split"):
        pc.ThreadComm(pc.ThreadWorld(3), 0).reduce_scatter(inputs[0][:5])


def test_gathered_weights_are_freed_between_forward_and_backward():
    """Between a block's forward and its backward only the shards live:
    every tensor the blocks' backward saved from their gathered weights
    is a view of freed storage, refilled before the backward reads it
    (the gradients are then the unsharded step's); under ``remat`` the
    recompute gathers again and the gradients are the same."""
    cfg = tt.TransformerConfig(dtype=torch.bfloat16, **CFGS["gpt2"])
    tokens = torch.from_numpy(_tokens()[:, :8]).clamp(min=0)
    adam = functools.partial(torch.optim.Adam, lr=LR, eps=EPS)
    hvd.init(device="cpu")
    try:
        model, step = hvd.make_lm_train_step(cfg, adam, device="cpu")
        step.backward(tokens)
        ref = {n: p.grad.float() for n, p in model.named_parameters()}
        for remat in (False, True):
            c = tt.TransformerConfig(dtype=torch.bfloat16, remat=remat,
                                     **CFGS["gpt2"])
            layout = pm.make_mesh(world=2, fsdp=2)
            meshes, worlds = pm.emulated_meshes(layout, timeout=60.0)

            def rank(r):
                m, st = hvd.make_lm_train_step(c, adam, device="cpu",
                                               mesh=meshes[r])
                saved, freed = [], []

                def pack(t):
                    saved.append(t)
                    return t

                def unpack(t):
                    # the first tensor the backward reads: every block's
                    # forward is done, none of their backwards has begun
                    if not freed:
                        freed.append(sum(x.untyped_storage().nbytes() == 0
                                         for x in saved))
                    return t

                with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                    st.backward(tokens[2 * r:2 * r + 2])
                return freed[0], {n: p.grad.float()
                                  for n, p in m.named_parameters()}, st.specs

            res = pc.run_ranks(worlds, rank, 2)
            # the 6 kernels of each of the 2 blocks, saved as views
            assert res[0][0] == (0 if remat else 12), (remat, res[0][0])
            from horovod_tpu_torch.parallel.sharding import unshard_params

            full = unshard_params([g for _, g, _ in res], res[0][2], layout)
            for n, g in ref.items():
                if n.endswith("attn.key.bias"):
                    continue
                tol = 2e-2 * float(g.abs().max()) + 1e-6
                assert float((full[n] - g).abs().max()) <= tol, (remat, n)
    finally:
        hvd.shutdown()


def test_thread_world_exchanges_stay_in_step():
    """``ThreadWorld.exchange`` reuses each of its two rows every other
    call: under more threads than cores and a short switch interval,
    every call of every rank still returns that call's values of every
    rank."""
    n, calls = 12, 300
    tw = pc.ThreadWorld(n, timeout=60.0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = pc.run_ranks(
            [tw], lambda r: [tw.exchange(r, (r, k)) for k in range(calls)],
            n)
    finally:
        sys.setswitchinterval(interval)
    for r in range(n):
        for k in range(calls):
            assert got[r][k] == [(j, k) for j in range(n)], (r, k)
