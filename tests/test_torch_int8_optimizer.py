"""The port's DistributedOptimizer on the int8 wire, in a world of two
processes over gloo, against the JAX package's.

The JAX reference is ``hvd.DistributedOptimizer(optax.sgd(1.0),
compression=Compression.int8)`` (its updates are minus the reduced
gradients) inside ``shard_map`` on a two-device
mesh, its state sharded with ``error_feedback_specs``, on its Pallas
backend (``fused_collectives``), at block 64 and a fusion threshold of
4 KiB (three buckets). Each rank's ``.grad`` comes from a backward pass
that yields the same numpy gradients JAX's ``update`` receives on that
device, for 3 steps:

* the reduced gradients and the error-feedback residuals
  (``error_feedback_residual`` against the rows of JAX's
  ``_EFState.residual``) are bitwise equal after every step, with
  ``backward_passes_per_step`` 1 and 2 (the residual compensates the
  mean reduced on the second pass) and under ``int8-raw`` (no
  residual);
* the parameters after torch's SGD agree with ``optax.sgd``'s update
  ``p + -lr * g`` of the reduced gradients within 1e-6 of their size
  plus the steps' updates: the two round it at different points;
* Min and Max under the int8 knob move uncompressed (the elementwise
  min and max of the ranks' gradients, exactly);
* a tiny float32 GPT-2 trained 3 steps through ``make_lm_train_step``
  under ``HOROVOD_COMPRESSION=int8`` (AdamW) against the JAX step on
  the same global batch and weights: losses and parameters within the
  limits stated at ``test_world_of_two_int8``, and the loss falls.

``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` with the int8 wire takes the
two-level route (flat at world 1; the worlds of 4, 6 and 8 are
``tests/test_torch_hierarchical.py``'s).
"""

import dataclasses
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.compat import shard_map
from horovod_tpu.core.state import global_state as jax_state
from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.models.convert import params_from_flax

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
LR = 1e-2
STEPS = 3
BLOCK = 64
THRESHOLD = 4096
#: the synthetic model's leaves, by flax path
SHAPES = {"dense_0.kernel": (40, 30), "dense_0.bias": (30,),
          "dense_1.kernel": (30, 7), "emb.embedding": (50, 16)}
_CFG = dict(vocab_size=61, num_layers=2, num_heads=2, hidden_size=32,
            max_seq_len=16)
GPT_LR = 1e-3


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    yield
    hvd.shutdown()


def test_hierarchical_allreduce_with_int8_raises(monkeypatch):
    """The knob is honoured: the int8 optimizer takes the two-level
    route (ops/hierarchical.py, held against the JAX package by
    tests/test_torch_hierarchical.py), which at world 1 resolves to the
    flat wire; only a residual without the int8 wire raises."""
    from horovod_tpu_torch.ops import hierarchical

    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "1")
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_LOCAL_SIZE", "2")
    hvd.init(device="cpu")
    lin = torch.nn.Linear(2, 2)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1),
                                   compression=hvd.Compression.int8)
    assert opt.wire.kind == "int8" and opt._hier_block == 1
    # other wires do not take the quantized path
    hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1),
                             compression=hvd.Compression.bf16)
    with pytest.raises(hvd.HorovodInternalError, match="int8 wire"):
        hierarchical.hierarchical_psum(torch.ones(3), 2,
                                       residual=torch.zeros(3))


_WORKER = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt

out, lr, steps, threshold = sys.argv[1], float(sys.argv[2]), \
    int(sys.argv[3]), int(sys.argv[4])
hvd.init(device="cpu")
r = hvd.rank()
grads = dict(np.load(out + "/grads.npz"))
res = {}


def run(compression, passes, op=hvd.Average):
    params = [(name, torch.nn.Parameter(torch.zeros(g.shape[3:])))
              for name, g in grads.items()]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in params], lr=lr),
        named_parameters=params, compression=compression,
        backward_passes_per_step=passes, op=op,
        fusion_threshold_bytes=threshold)
    trace = []
    for t in range(steps):
        for j in range(passes):
            loss = sum((p * torch.from_numpy(grads[name][t, j, r])).sum()
                       for name, p in params)
            loss.backward()
        opt.step()
        trace.append({
            "grad": {n: p.grad.clone() for n, p in params},
            "res": {n: v.clone()
                    for n, v in opt.error_feedback_residual.items()},
            "param": {n: p.detach().clone() for n, p in params}})
        opt.zero_grad()
    return trace, len(opt.bucket_plan), opt.wire


for key, comp, passes in (("ef", hvd.Compression.int8, 1),
                          ("ef_accum", hvd.Compression.int8, 2),
                          ("raw", hvd.Compression.int8_raw, 1)):
    res[key], res[key + "_buckets"], res[key + "_wire"] = run(comp, passes)
for op in ("Min", "Max"):
    trace, _, wire = run(None, 1, op=getattr(hvd, op))
    res[op] = trace
    res[op + "_wire"] = wire

cfg = tt.TransformerConfig(dtype=torch.float32, **eval(sys.argv[5]))
init = torch.load(out + "/init.pt")
tokens = torch.load(out + "/tokens.pt")
model, step = hvd.make_lm_train_step(
    cfg, lambda ps: torch.optim.AdamW(ps, lr=float(sys.argv[6]),
                                      weight_decay=1e-4), device="cpu")
model.load_state_dict(init)
res["gpt_wire"] = step.optimizer.wire
res["gpt_losses"] = [float(step(tokens[2 * r:2 * r + 2]))
                     for _ in range(steps)]
res["gpt_params"] = {k: v.clone() for k, v in model.state_dict().items()}
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nest(flat):
    tree = {}
    for name, v in flat.items():
        mod, leaf = name.split(".")
        tree.setdefault(mod, {})[leaf] = v
    return tree


def _flat(tree):
    return {f"{m}.{k}": np.asarray(v) for m, sub in tree.items()
            for k, v in sub.items()}


def _mesh():
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    jhvd.init(mesh=mesh)
    st = jax_state()
    st.knobs = dataclasses.replace(st.knobs, compression_block=BLOCK,
                                   fused_collectives=True)
    return mesh


@pytest.fixture
def _jax_knobs_restored():
    """The JAX package keeps its knobs across shutdown(): put them back,
    so that no later test sees this file's block."""
    saved = jax_state().knobs
    yield
    jax_state().knobs = saved


def _jax_trace(compression, passes, grads):
    """Per step: the reduced gradients (minus the updates of
    ``optax.sgd(1.0)``), the residual rows and the parameters that
    ``optax.sgd(LR)`` would reach from them (``p + -LR * g``)."""
    mesh = _mesh()
    opt = jhvd.DistributedOptimizer(optax.sgd(1.0), compression=compression,
                                    backward_passes_per_step=passes,
                                    fusion_threshold_bytes=THRESHOLD)
    params = _nest({n: jnp.zeros(g.shape[3:], jnp.float32)
                    for n, g in grads.items()})
    state = opt.init(params)
    specs = jhvd.error_feedback_specs(state)

    def body(g, s, p):
        return opt.update(jax.tree.map(lambda a: a[0], g), s, p)

    step = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("hvd"), specs, P()),
                             out_specs=(P(), specs), check_vma=False))
    trace = []
    p = {n: np.zeros(g.shape[3:], np.float32) for n, g in grads.items()}
    for t in range(STEPS):
        for j in range(passes):
            g = _nest({n: jnp.asarray(a[t, j]) for n, a in grads.items()})
            u, state = step(g, state, params)
        inner = state.inner if passes > 1 else state
        red = {n: -v for n, v in _flat(u).items()}
        p = {n: p[n] + np.float32(-LR) * red[n] for n in p}
        trace.append({
            "grad": red,
            "res": (_flat(inner.residual) if hasattr(inner, "residual")
                    else {}),
            "param": p})
    return trace


def _gpt_reference(params, tokens):
    """3 steps of hvd.DistributedOptimizer(optax.adamw) on the int8 wire
    in shard_map over a two-device mesh, batch sharded over "hvd"; the
    per-rank losses of each step and the parameters."""
    mesh = _mesh()
    model = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **_CFG))
    opt = jhvd.DistributedOptimizer(optax.adamw(GPT_LR, weight_decay=1e-4),
                                    compression=jhvd.Compression.int8)
    state = opt.init(params)
    specs = jhvd.error_feedback_specs(state)

    def loss_fn(p, tok):
        return jt.causal_lm_loss(model.apply({"params": p}, tok), tok)[0]

    def step_fn(p, s, tok):
        loss, g = jax.value_and_grad(loss_fn)(p, tok)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss[None]

    step = jax.jit(shard_map(step_fn, mesh=mesh,
                             in_specs=(P(), specs, P("hvd")),
                             out_specs=(P(), specs, P("hvd")),
                             check_vma=False))
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, jnp.asarray(tokens))
        losses.append(np.asarray(loss))
    return params, np.array(losses)


def _eq(got, want, what):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    bad = np.flatnonzero(got.reshape(-1) != want.reshape(-1))
    assert bad.size == 0, (f"{what}: {bad.size} of {got.size} differ, "
                           f"first {got.reshape(-1)[bad[0]]} vs "
                           f"{want.reshape(-1)[bad[0]]}")


def test_world_of_two_int8(tmp_path, _jax_knobs_restored):
    rs = np.random.RandomState(0)
    grads = {name: (rs.randn(STEPS, 2, 2, *shape)
                    * 10.0 ** rs.uniform(-3, 0)).astype(np.float32)
             for name, shape in SHAPES.items()}
    np.savez(tmp_path / "grads.npz", **grads)
    jmod = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **_CFG))
    gparams = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                 jnp.ones((1, 4), jnp.int32))["params"]
    torch.save(params_from_flax(jax.tree.map(np.asarray, gparams)),
               tmp_path / "init.pt")
    tokens = np.random.RandomState(1).randint(0, 61, (4, 16)).astype(np.int64)
    torch.save(torch.from_numpy(tokens), tmp_path / "tokens.pt")

    port = _free_port()
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   HOROVOD_COMPRESSION="int8",
                   HOROVOD_COMPRESSION_BLOCK=str(BLOCK),
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path), repr(LR),
             str(STEPS), str(THRESHOLD), repr(_CFG), repr(GPT_LR)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    try:
        # the JAX references run while the workers do
        want = {}
        for key, comp, passes in (("ef", jhvd.Compression.int8, 1),
                                  ("ef_accum", jhvd.Compression.int8, 2),
                                  ("raw", jhvd.Compression.int8_raw, 1)):
            want[key] = _jax_trace(comp, passes, grads)
        gpt_params, gpt_losses = _gpt_reference(gparams, tokens)
    finally:
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            finally:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]

    for key in ("ef", "ef_accum", "raw"):
        assert res[0][key + "_buckets"] == 3
        assert res[0][key + "_wire"].key == ("int8", BLOCK, key != "raw")
        for t in range(STEPS):
            w = want[key][t]
            assert set(w["res"]) == (set(SHAPES) if key != "raw" else set())
            for r in range(2):
                got = res[r][key][t]
                assert set(got["res"]) == set(w["res"])
                for name in SHAPES:
                    _eq(got["grad"][name], w["grad"][name],
                        f"{key} step {t} rank {r} reduced {name}")
                    # a float32 rounding of each step's update, which
                    # torch and optax make at different points
                    moved = LR * sum(np.abs(want[key][u]["grad"][name])
                                     for u in range(t + 1))
                    err = np.abs(got["param"][name].numpy()
                                 - w["param"][name])
                    assert (err <= 1e-6 * (np.abs(w["param"][name])
                                           + moved)).all(), (key, t, name)
                for name, row in w["res"].items():
                    _eq(got["res"][name], row[r],
                        f"{key} step {t} rank {r} residual {name}")
        assert np.abs(want[key][-1]["res"].get("dense_0.kernel", 0)).max() \
            > 0 or key == "raw"

    for op, fn in (("Min", np.minimum), ("Max", np.maximum)):
        assert res[0][op + "_wire"] is None  # uncompressed under the knob
        for t in range(STEPS):
            for name, g in grads.items():
                for r in range(2):
                    _eq(res[r][op][t]["grad"][name], fn(g[t, 0, 0],
                                                        g[t, 0, 1]),
                        f"{op} step {t} {name}")

    # the tiny GPT-2 through make_lm_train_step under the int8 knob.
    # The step returns the global batch's mean loss on every rank: with
    # the same token count on each rank, the mean of the JAX step's
    # per-rank losses. Limits: the step losses within 1e-5 relative;
    # each parameter's
    # change over the 3 steps within 1% (relative L2) of JAX's change,
    # every element within 5% of the most AdamW can move it (steps x lr).
    # The float32 gradients of the two frameworks differ in the last
    # bits, which can move an int8 code by one step here and there, and
    # Adam normalizes each element's gradient: the readings were at most
    # 0.1% and 1.5%.
    assert res[0]["gpt_wire"].key == ("int8", BLOCK, True)
    losses = np.array([res[r]["gpt_losses"] for r in range(2)]).T
    global_mean = gpt_losses.astype(np.float64).mean(1, keepdims=True)
    np.testing.assert_allclose(losses, np.repeat(global_mean, 2, 1),
                               rtol=1e-5)
    assert losses.mean(1)[-1] < losses.mean(1)[0]
    init = torch.load(tmp_path / "init.pt")
    want_p = params_from_flax(jax.tree.map(np.asarray, gpt_params))
    for name, w in want_p.items():
        dj = w.numpy() - init[name].numpy()
        for r in range(2):
            dt = res[r]["gpt_params"][name].numpy() - init[name].numpy()
            rel = np.linalg.norm(dt - dj) / max(np.linalg.norm(dj), 1e-30)
            assert rel <= 1e-2, (name, rel)
            err = float(np.abs(dt - dj).max())
            assert err <= 5e-2 * STEPS * GPT_LR, (name, err)
