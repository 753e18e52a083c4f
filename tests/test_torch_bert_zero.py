"""The port's BERT pretraining step under ZeRO-1 in a world of two
processes over gloo, against the JAX package's.

A tiny float32 BERT (2 layers, hidden 64, vocab 97, seq 16,
bidirectional attention) with flax-initialized weights trains 3 steps
through ``examples.bert_pretraining.make_mlm_train_step(zero=True)``:
``ShardedOptimizer(AdamW(weight_decay=1e-4))`` at a 16 KiB fusion
threshold (several buckets), each rank on its rows of the JAX example's
synthetic masked-LM batch (``synthetic_mlm_batch``, which must equal
the JAX example's draw). The reference is the JAX example's step:
``hvd.ShardedOptimizer(optax.adamw(lr, weight_decay=1e-4))`` inside
``shard_map`` on a two-device mesh, state sharded with
``sharded_state_specs``, the same global batch. Limits: each rank's
step losses within 1e-5 relative; each parameter's change over the 3
steps within 1% (relative L2) of JAX's change, and every element within
5% of the most AdamW can move it (steps x lr). optax and torch round the
update at different points, and Adam divides each gradient by its own
scale, so where a gradient is mostly cancellation (few masked positions
feed it) the order of float32 sums shows: the worst element read 1.75%
of steps x lr (an MLP output kernel), the same with the port's and the
JAX package's DistributedOptimizer in place of ZeRO on both sides. The
attention key biases' true gradient is 0 (softmax ignores a shift
shared by a row): Adam normalizes rounding noise of either sign there,
and they may move up to lr a step apart. Both ranks end bitwise equal,
and the loss falls.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.compat import shard_map
from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.examples.bert_pretraining import synthetic_mlm_batch
from horovod_tpu_torch.models.convert import params_from_flax

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
LR = 1e-3
STEPS = 3
THRESHOLD = 16 * 1024
_CFG = dict(vocab_size=97, num_layers=2, num_heads=1, hidden_size=64,
            max_seq_len=16, causal=False)
BATCH, SEQ, MASK_FRAC = 2, 16, 0.15

_WORKER = r'''
import functools, sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples.bert_pretraining import (
    make_mlm_train_step, synthetic_mlm_batch)
from horovod_tpu_torch.models import transformer as tt

out, lr, steps = sys.argv[1], float(sys.argv[2]), int(sys.argv[3])
kw = eval(sys.argv[4])
batch, seq, frac = int(sys.argv[5]), int(sys.argv[6]), float(sys.argv[7])
hvd.init(device="cpu")
r = hvd.rank()
cfg = tt.TransformerConfig(dtype=torch.float32, **kw)
model, step = make_mlm_train_step(
    cfg, functools.partial(torch.optim.AdamW, lr=lr, weight_decay=1e-4),
    zero=True, device="cpu")
model.load_state_dict(torch.load(out + "/init.pt"))
data = [torch.from_numpy(a) for a in synthetic_mlm_batch(
    cfg.vocab_size, batch, seq, frac, r, hvd.size())]
losses = [float(step(*data)) for _ in range(steps)]
torch.save({"losses": losses, "buckets": len(step.optimizer.bucket_plan),
            "params": {k: v.clone() for k, v in model.state_dict().items()}},
           out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_step(params, tokens, labels, mask, n):
    """The JAX example's --zero step, 3 times; per-device losses and the
    parameters."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
    jhvd.init(mesh=mesh)
    model = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **_CFG))
    opt = jhvd.ShardedOptimizer(optax.adamw(LR, weight_decay=1e-4),
                                fusion_threshold_bytes=THRESHOLD)
    state = opt.init(params)
    specs = jhvd.sharded_state_specs(state)

    def loss_fn(p, tok, lab, msk):
        return jt.mlm_loss(model.apply({"params": p}, tok), lab, msk)[0]

    def step_fn(p, s, tok, lab, msk):
        loss, g = jax.value_and_grad(loss_fn)(p, tok, lab, msk)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss[None]

    step = jax.jit(shard_map(
        step_fn, mesh=mesh,
        in_specs=(P(), specs, P("hvd"), P("hvd"), P("hvd")),
        out_specs=(P(), specs, P("hvd")), check_vma=False))
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, tokens, labels, mask)
        losses.append(np.asarray(loss))
    return params, np.array(losses), len(state[0].mu)


def test_bert_zero_world_of_two(tmp_path):
    n = 2
    jmod = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **_CFG))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                jnp.ones((1, 4), jnp.int32))["params"]
    init = params_from_flax(jax.tree.map(np.asarray, params))
    torch.save(init, tmp_path / "init.pt")
    # the JAX example's global batch, drawn as it draws it
    rng = np.random.RandomState(0)
    vocab = _CFG["vocab_size"]
    tokens = rng.randint(0, vocab, (BATCH * n, SEQ))
    labels = rng.randint(0, vocab, (BATCH * n, SEQ))
    mask = rng.rand(BATCH * n, SEQ) < MASK_FRAC
    for r in range(n):
        mine = synthetic_mlm_batch(vocab, BATCH, SEQ, MASK_FRAC, r, n)
        rows = slice(r * BATCH, (r + 1) * BATCH)
        for got, want in zip(mine, (tokens, labels, mask)):
            np.testing.assert_array_equal(got, want[rows])

    port = _free_port()
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   HOROVOD_FUSION_THRESHOLD=str(THRESHOLD),
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path), repr(LR),
             str(STEPS), repr(_CFG), str(BATCH), str(SEQ), repr(MASK_FRAC)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        want_p, want_losses, jbuckets = _jax_step(
            params, jnp.asarray(tokens), jnp.asarray(labels),
            jnp.asarray(mask), n)
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
           for r in range(n)]

    assert res[0]["buckets"] == jbuckets > 2
    losses = np.array([res[r]["losses"] for r in range(n)]).T
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses.mean(1)[-1] < losses.mean(1)[0]
    want = params_from_flax(jax.tree.map(np.asarray, want_p))
    for name, w in want.items():
        key_bias = name.endswith("attn.key.bias")
        tol = STEPS * LR * (1.01 if key_bias else 5e-2)
        dj = w.numpy() - init[name].numpy()
        for r in range(n):
            got = res[r]["params"][name]
            assert torch.equal(got, res[0]["params"][name]), name
            dt = got.numpy() - init[name].numpy()
            err = float(np.abs(dt - dj).max())
            assert err <= tol, f"rank {r}: {name} differs by {err} > {tol}"
            rel = np.linalg.norm(dt - dj) / max(np.linalg.norm(dj), 1e-30)
            assert key_bias or rel <= 1e-2, (name, rel)
