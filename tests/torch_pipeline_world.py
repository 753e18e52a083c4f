"""Shared harness of ``test_torch_pipeline.py`` and
``test_torch_pipeline_1f1b.py``: a gloo world of four worker processes
running the port's pipeline scenarios on the JAX test's tiny GPT-2, the
JAX package's results on the same meshes, and the checks.

The model is the JAX pipeline tests' (4 layers, hidden 64, 2 heads,
vocab 96, seq 32, float32). Each worker builds its stage
(``parallel.build_stage``), loads its blocks and the replicated rest of
the same flax weights (``models/convert.stage_from_flax``) and runs its
rows of the global batch (``sharding.batch_slices``). The tolerances
are the JAX tests': logits within 2e-4, the loss within 1e-5 relative,
gradients within rtol 3e-3, atol 3e-4.
"""

import os
import pathlib
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel import pipeline as jpipe
from horovod_tpu.parallel.mesh import make_mesh as jmake_mesh

from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import (params_from_flax,
                                              stage_from_flax)
from horovod_tpu_torch.parallel import comm as pc
from horovod_tpu_torch.parallel import mesh as pm
from horovod_tpu_torch.parallel.sharding import batch_slices

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 4
CFG = dict(vocab_size=96, num_layers=4, num_heads=2, hidden_size=64,
           max_seq_len=32)
LOGITS_TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=3e-3, atol=3e-4)

# the scenarios' runner: the workers' and the emulation's code
RUN = r'''
import torch
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import stage_from_flax
from horovod_tpu_torch.parallel import pipeline as pl
from horovod_tpu_torch.parallel.sharding import batch_slices


def run(mesh, cfg, params, tokens, m, schedule):
    model = pl.build_stage(cfg, mesh, device="cpu")
    model.load_state_dict(stage_from_flax(params, mesh))
    rows, _ = batch_slices(mesh, *tokens.shape)
    t = tokens[rows]
    out = {}
    if schedule == "gpipe":
        with torch.no_grad():
            out["logits"] = pl.pipeline_lm_apply(cfg, model, t, mesh, m)
        step = pl.pipeline_lm_train_step_gpipe
    else:
        step = pl.pipeline_lm_train_step_1f1b
    out["loss"] = float(step(cfg, model, t, mesh, m))
    out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
    return out


def learn(mesh, cfg, tokens, schedule, steps, lr, m):
    model = pl.build_stage(cfg, mesh, device="cpu")
    rows, _ = batch_slices(mesh, *tokens.shape)
    t = tokens[rows]
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    step = (pl.pipeline_lm_train_step_gpipe if schedule == "gpipe"
            else pl.pipeline_lm_train_step_1f1b)
    losses = []
    for _ in range(steps):
        losses.append(float(step(cfg, model, t, mesh, m)))
        opt.step()
        opt.zero_grad(set_to_none=True)
    return losses
'''

WORKER = RUN + r'''
import sys
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel.mesh import make_mesh

out_dir = sys.argv[1]
hvd.init(device="cpu")
data = torch.load(out_dir + "/data.pt", weights_only=False)
cfg = tt.TransformerConfig(dtype=torch.float32, **data["cfg"])
res = {}
for name, (pp, dp, m, schedule, key) in data["scenarios"].items():
    res[name] = run(make_mesh(pp=pp, dp=dp), cfg, data["params"],
                    data["tokens"][key], m, schedule)
mesh = make_mesh(pp=2, dp=2)
for schedule, (lcfg, key, steps, lr, m) in data["learn"].items():
    lcfg = tt.TransformerConfig(dtype=torch.float32, **lcfg)
    res["learn_" + schedule] = learn(mesh, lcfg, data["tokens"][key],
                                     schedule, steps, lr, m)
# the chain hops over the pp axis
comm = mesh.comm("pp")
x = torch.full((3,), float(hvd.rank() + 1))
res["hops"] = (comm.hop_forward(x), comm.hop_backward(x * 10))
torch.save(res, out_dir + "/rank%d.pt" % hvd.rank())
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tokens():
    """The global batches: the JAX tests' tokens (B 8 and 16), the last
    microbatch at M = 4 all padding or padded unevenly, and the
    convergence test's fixed-successor batch."""
    base = np.random.RandomState(0).randint(0, 96, (16, 32)).astype(np.int64)
    full, uneven = base[:8].copy(), base[:8].copy()
    full[-2:, 1:] = -1  # rows 6-7, the last microbatch at M=4: 0 targets
    uneven[-2:, 5:] = -1
    r = np.random.RandomState(0)
    table = r.randint(0, 64, (64,))
    chain = np.zeros((8, 16), dtype=np.int64)
    chain[:, 0] = r.randint(0, 64, 8)
    for t in range(1, 16):
        chain[:, t] = table[chain[:, t - 1]]
    return {"plain8": base[:8], "plain16": base, "pad_full": full,
            "pad_uneven": uneven, "table16": chain}


def jcfg(**kw):
    return jt.TransformerConfig(dtype=jnp.float32, **{**CFG, **kw})


def flax_params():
    model = jt.Transformer(jcfg())
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 32), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _jax_fn(kind, pp=1, dp=1, m=1):
    """The JAX package's ``(loss, grads, logits)`` of a token batch:
    jax.grad of the serial model (``"serial"``), through
    ``pipeline_lm_apply`` (``"gpipe"``), or ``pipeline_lm_train_step_1f1b``
    (``"1f1b"``, no logits); one compile a shape."""
    cfg = jcfg()
    if kind == "1f1b":
        mesh = jmake_mesh(pp=pp, dp=dp, devices=jax.devices()[:pp * dp])
        fn = jax.jit(lambda p, t: jpipe.pipeline_lm_train_step_1f1b(
            cfg, p, t, mesh, num_microbatches=m))
        return lambda p, t: fn(p, t) + (None,)
    if kind == "serial":
        model = jt.Transformer(cfg)

        def logits_of(p, t):
            return model.apply({"params": p}, t)
    else:
        mesh = jmake_mesh(pp=pp, dp=dp, devices=jax.devices()[:pp * dp])

        def logits_of(p, t):
            return jpipe.pipeline_lm_apply(cfg, p, t, mesh,
                                           num_microbatches=m)

    def loss(p, t):
        logits = logits_of(p, t)
        return jt.causal_lm_loss(logits, t)[0], logits

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))

    def run(p, t):
        (l, logits), g = fn(p, t)
        return l, g, logits

    return run


def _jax_group(kind, args, params, batches):
    fn = _jax_fn(kind, *args)
    out = []
    for toks in batches:
        l, g, logits = fn(params, jnp.asarray(toks))
        out.append((float(l), jax.tree.map(np.asarray, g),
                    None if logits is None else np.asarray(logits)))
    return out


def start_world(tmp, scenarios, learn=None, serial_only=()):
    """Run the gloo world of ``N`` workers on ``scenarios`` (name ->
    (pp, dp, microbatches, schedule, tokens key)) and ``learn``
    (schedule -> (cfg, tokens key, steps, lr, microbatches)), the JAX
    package's twins of each scenario (but those in ``serial_only``) and
    the serial model's on each batch meanwhile. Returns the inputs,
    ``jax`` and ``serial`` results and each rank's."""
    params, toks = flax_params(), tokens()
    torch.save({"cfg": CFG, "params": params, "learn": learn or {},
                "tokens": {k: torch.from_numpy(v) for k, v in toks.items()},
                "scenarios": scenarios}, tmp / "data.pt")
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
            [sys.executable, "-c", WORKER, str(tmp)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    # one JAX program a (kind, mesh, microbatches), compiled while the
    # workers run, each run on every batch it serves
    groups = {}
    for name, (pp, dp, m, schedule, key) in scenarios.items():
        if name not in serial_only:
            groups.setdefault((schedule, (pp, dp, m)), []).append(
                (name, key))
    for key in sorted({s[4] for s in scenarios.values()}):
        shape = toks[key].shape
        groups.setdefault(("serial", shape), []).append((key, key))
    try:
        with ThreadPoolExecutor(4) as ex:
            futs = {g: ex.submit(_jax_group, g[0],
                                 () if g[0] == "serial" else g[1], params,
                                 [toks[k] for _, k in members])
                    for g, members in groups.items()}
            jax_res, serial = {}, {}
            for g, members in groups.items():
                for (name, _), res in zip(members, futs[g].result()):
                    (serial if g[0] == "serial" else jax_res)[name] = res
    finally:
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=150)[0])
            finally:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(N)]
    return {"params": params, "tokens": toks, "jax": jax_res,
            "serial": serial, "ranks": ranks, "scenarios": scenarios}


def _check_grads(got, want_tree, what):
    want = params_from_flax(want_tree)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=f"{what}: {name}", **GRAD_TOL)


def check_scenario(world, name):
    """A scenario's loss, gradients (and GPipe's logits) on every rank
    against the serial model's and, unless it is serial-only, the JAX
    pipeline's."""
    pp, dp, _, schedule, key = world["scenarios"][name]
    wants = [("serial", world["serial"][key])]
    if name in world["jax"]:
        wants.append(("JAX pipeline", world["jax"][name]))
    layout = pm.make_mesh(world=N, pp=pp, dp=dp)
    for r in range(N):
        got = world["ranks"][r][name]
        for what, (loss, grads, logits) in wants:
            np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
            _check_grads(got["grads"], grads, f"{name} rank {r} vs {what}")
            if schedule == "gpipe":
                rows, _ = batch_slices(layout, *world["tokens"][key].shape,
                                       rank=r)
                np.testing.assert_allclose(got["logits"].numpy(),
                                           logits[rows], rtol=LOGITS_TOL,
                                           atol=LOGITS_TOL)
        assert set(got["grads"]) == set(stage_from_flax(
            world["params"], layout, rank=r)), name


def check_replicated_bitwise(world, name):
    """The embedding, positions, final norm and tied head: one gradient,
    the same bits on every pp and dp rank."""
    ranks = world["ranks"]
    for n, g in ranks[0][name]["grads"].items():
        if n.startswith("block_"):
            continue
        for r in range(1, N):
            assert torch.equal(ranks[r][name]["grads"][n], g), (name, r, n)


def check_emulated(world, name):
    """The scenario on four ranks emulated in this process
    (``mesh.emulated_meshes``): bitwise the gloo world's."""
    pp, dp, m, schedule, key = world["scenarios"][name]
    ns = {}
    exec(RUN, ns)
    cfg = tt.TransformerConfig(dtype=torch.float32, **CFG)
    meshes, worlds = pm.emulated_meshes(pm.make_mesh(world=N, pp=pp, dp=dp),
                                        timeout=60.0)
    toks = torch.from_numpy(world["tokens"][key])
    emulated = pc.run_ranks(worlds, lambda r: ns["run"](
        meshes[r], cfg, world["params"], toks, m, schedule), N)
    for r in range(N):
        got, want = emulated[r], world["ranks"][r][name]
        assert got["loss"] == want["loss"], (name, r)
        for k, v in want["grads"].items():
            assert torch.equal(got["grads"][k], v), (name, r, k)
        if "logits" in want:
            assert torch.equal(got["logits"], want["logits"]), (name, r)
