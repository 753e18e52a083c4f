"""The port's Adasum (``ops/adasum.py``, ``op=Adasum``) and its example
against the JAX package.

Gloo worlds of 2, 4 and 8 ranks (one spawn each, every scenario of that
size in it) against the JAX package's SPMD results on meshes of the
same sizes (port rank r holds what JAX device r holds):

* ``adasum_allreduce`` at worlds 2 and 4, float32 and bf16, against
  JAX's ``adasum_allreduce`` under ``shard_map``; every rank bitwise the
  others and bitwise :func:`emulated_adasum` of the same tensors (the
  composition ``chip_smoke.py`` phase 4g runs on one card);
* the anchors, bitwise: adasum(a, a) = a, and tensors with disjoint
  supports sum; the errors: a world of three (not a power of two) and a
  proper subset raise ``HorovodInternalError``;
* ``hierarchical_adasum`` on 2 x 2 (world 4, nodes of 2) and 2 x 4
  (world 8, nodes of 4) against JAX's on a ("cross", "local") mesh;
* the DistributedOptimizer with ``op=Adasum`` over several buckets (a
  small fusion threshold): the reduced gradients against JAX's
  ``DistributedOptimizer(optax.sgd(1.0), op=Adasum)`` in ``shard_map``
  and bitwise against ``emulated_adasum`` of each bucket; the int8 wire
  falls back to uncompressed under Adasum
  (``tests/test_compression.py:458``);
* the port's ``examples/adasum_gpt2.py`` at a tiny size (2 layers x
  64, vocab 128, seq 16, 2 rows a rank) for 3 steps at world 2, in
  float32, from weights converted with ``models/convert.py``, against
  the JAX example's step (``DistributedOptimizer(optax.adam, op=Adasum)``
  in ``shard_map``) on the same bigram batch.

Tolerances: float32 combines within 2e-6 relative (the dot and norms
are sums in another order); bf16 within one bf16 ulp; the example's
losses within 1e-5 relative, and each parameter's movement over the 3
steps within 1e-2 relative L2 of the JAX example's: Adam divides each
gradient by its own scale, so an element whose gradient is mostly
cancellation (one of ``block_1.mlp.fc1.bias`` reads 2.6e-9 against a
median of 1.1e-3) turns float32 rounding into up to 7% of lr there. The
key biases' true gradient is 0 (softmax ignores a shift shared by a
row), so Adam normalizes rounding noise of either sign and they are
held to steps x lr, as ``tests/test_torch_distributed.py`` holds them.
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
from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import adasum as jadasum
from horovod_tpu_torch.examples.adasum_gpt2 import bigram_tokens
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.ops.adasum import (adasum_combine, adasum_distances,
                                          emulated_adasum)
from horovod_tpu_torch.ops.fusion import (pack_buckets_by_plan,
                                          unflatten_buckets_by_plan)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
LR, STEPS = 1e-3, 3
_CFG = dict(num_layers=2, hidden_size=64, num_heads=1, vocab_size=128,
            max_seq_len=16)
MLP = {"dense_0.kernel": (6, 5), "dense_0.bias": (5,),
       "dense_1.kernel": (5, 3), "dense_1.bias": (3,)}
THRESHOLD = 64  # bytes: every leaf a bucket of its own but the small ones

_WORKER = r'''
import dataclasses
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.exceptions import HorovodInternalError

out = sys.argv[1]
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
res = {}


def raises(exc, fn):
    try:
        fn()
    except exc as e:
        return type(e).__name__ + ": " + str(e)
    return None


if n == 3:
    x = torch.ones(4)
    res["not_pow2"] = raises(HorovodInternalError,
                             lambda: hvd.adasum_allreduce(x))
    res["not_pow2_opt"] = raises(HorovodInternalError, lambda: (
        hvd.DistributedOptimizer(
            torch.optim.SGD([torch.nn.Parameter(x)], lr=1.0),
            op=hvd.Adasum)))
    torch.save(res, out + "/rank%d.pt" % r)
    hvd.shutdown()
    sys.exit(0)

data = np.load(out + "/data%d.npz" % n)
x = torch.from_numpy(data["x"][r])
res["f32"] = hvd.adasum_allreduce(x)
res["bf16"] = hvd.allreduce(x.to(torch.bfloat16), op=hvd.Adasum)
res["same"] = hvd.adasum_allreduce(torch.from_numpy(data["x"][0]))
res["disjoint"] = hvd.adasum_allreduce(torch.from_numpy(data["disjoint"][r]))
res["hier"] = hvd.hierarchical_adasum(torch.from_numpy(data["h"][r]),
                                      local_size=int(sys.argv[2]))
if n == 4:
    ps = hvd.add_or_get_process_set([1, 3])  # a cross-node set above
    res["subset"] = raises(HorovodInternalError,
                           lambda: hvd.adasum_allreduce(x, process_set=ps))
    res["subset_allreduce"] = raises(
        HorovodInternalError,
        lambda: hvd.allreduce(x, op=hvd.Adasum, process_set=ps))
    res["subset_opt"] = raises(HorovodInternalError, lambda: (
        hvd.DistributedOptimizer(
            torch.optim.SGD([torch.nn.Parameter(x)], lr=1.0),
            op=hvd.Adasum, process_set=ps)))
    # the optimizer over several buckets: each rank's own gradients
    named = [(k, torch.nn.Parameter(torch.from_numpy(data["p_" + k])))
             for k in eval(sys.argv[3])]
    p = dict(named)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([q for _, q in named], lr=1.0),
        named_parameters=named, op=hvd.Adasum,
        fusion_threshold_bytes=int(sys.argv[4]))
    inp = torch.from_numpy(data["inp"][r])
    h = torch.relu(inp @ p["dense_0.kernel"] + p["dense_0.bias"])
    ((h @ p["dense_1.kernel"] + p["dense_1.bias"]) ** 2).sum().backward()
    opt.synchronize()
    res["opt_grads"] = {k: q.grad.clone() for k, q in named}
    res["opt_buckets"] = len(opt.bucket_plan)
    int8 = hvd.DistributedOptimizer(
        torch.optim.SGD([q for _, q in named], lr=1.0),
        named_parameters=named, op=hvd.Adasum,
        compression=hvd.Compression.int8)
    res["int8_wire"] = int8.wire
if n == 2:
    from horovod_tpu_torch.examples import adasum_gpt2
    # the JAX example's model in float32, for a tight comparison
    adasum_gpt2.GPT2_SMALL = dataclasses.replace(adasum_gpt2.GPT2_SMALL,
                                                 dtype=torch.float32)
    stats = {}
    res["example"] = adasum_gpt2.main(
        ["--device", "cpu", "--layers", "2", "--hidden", "64", "--vocab",
         "128", "--seq-len", "16", "--batch-size", "2", "--steps", "3"],
        stats, init=torch.load(out + "/init.pt"))
    res["example_losses"] = stats["losses"]
    res["example_state"] = {k: v.detach().clone()
                            for k, v in stats["model"].state_dict().items()}
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(worker, n, *args):
    """Start ``worker`` as ``n`` ranks over gloo on a free port."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", worker, *map(str, args)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def _wait(procs, timeout=150):
    """Rank 0's output, raising with a failing rank's."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        finally:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    return outs[0]


def _data(n):
    """Rank r's tensors: correlated gradients (a shared part plus noise),
    the first rank's for every rank, disjoint supports, the hierarchical
    input, and the MLP's parameters and inputs."""
    rs = np.random.RandomState(20 + n)
    base = rs.randn(96).astype(np.float32)
    x = (base + 0.8 * rs.randn(n, 96)).astype(np.float32)
    disjoint = np.zeros((n, 96), np.float32)
    for r in range(n):
        disjoint[r, r * (96 // n):(r + 1) * (96 // n)] = \
            rs.randn(96 // n)
    d = {"x": x, "disjoint": disjoint,
         "h": (base[:24].reshape(8, 3) + rs.randn(n, 8, 3)).astype(
             np.float32),
         "inp": rs.randn(n, 4, 6).astype(np.float32)}
    for k, shape in MLP.items():
        d["p_" + k] = (0.5 * rs.randn(*shape)).astype(np.float32)
    return d


def _flax_mlp(d):
    return {"dense_0": {"kernel": d["p_dense_0.kernel"],
                        "bias": d["p_dense_0.bias"]},
            "dense_1": {"kernel": d["p_dense_1.kernel"],
                        "bias": d["p_dense_1.bias"]}}


def _jax_init():
    jt_cfg = jt.TransformerConfig(dtype=jnp.float32, **_CFG)
    model = jt.Transformer(jt_cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 16), jnp.int32))["params"]
    return model, params


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("adasum")
    for n in (2, 4, 8):
        np.savez(out / f"data{n}.npz", **_data(n))
    _, params = _jax_init()
    torch.save(params_from_flax(jax.tree.map(np.asarray, params)),
               out / "init.pt")
    res = {"init": out / "init.pt"}
    # the worlds run at once, each in a directory of its own
    started = {}
    for n, local in ((2, 1), (4, 2), (8, 4), (3, 1)):
        d = out / f"world{n}"
        d.mkdir()
        for f in out.glob("*.*"):
            (d / f.name).symlink_to(f)
        started[n] = (d, _start(_WORKER, n, d, local, repr(list(MLP)),
                                THRESHOLD))
    for n, (d, procs) in started.items():
        log = _wait(procs)
        res[n] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                  for r in range(n)]
        if n == 2:
            res["log"] = log
    return res


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    yield
    hvd.shutdown()


def _mesh(n, names=("hvd",), shape=None):
    devs = np.array(jax.devices()[:n])
    mesh = Mesh(devs.reshape(shape or (n,)), names)
    jhvd.init(mesh=mesh, dp_axis=names)
    return mesh


def _jax_adasum(n, x):
    mesh = _mesh(n)
    fn = shard_map(lambda t: jadasum.adasum_allreduce(t[0], "hvd")[None],
                   mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd"),
                   check_vma=False)
    return np.asarray(jax.jit(fn)(x).astype(jnp.float32))


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("n", [2, 4])
def test_adasum_allreduce_float32_matches_jax(worlds, n):
    res = worlds[n]
    x = _data(n)["x"]
    want = _jax_adasum(n, jnp.asarray(x))
    emul = emulated_adasum([torch.from_numpy(v) for v in x])
    scale = np.abs(want).max()
    for r, out in enumerate(res):
        assert torch.equal(out["f32"], res[0]["f32"])
        assert torch.equal(out["f32"], emul[r])
        np.testing.assert_allclose(out["f32"].numpy(), want[r], rtol=2e-6,
                                   atol=2e-6 * scale)


@pytest.mark.parametrize("n", [2, 4])
def test_adasum_allreduce_bf16_matches_jax(worlds, n):
    res = worlds[n]
    x = jnp.asarray(_data(n)["x"]).astype(jnp.bfloat16)
    want = _jax_adasum(n, x)
    emul = emulated_adasum([torch.from_numpy(v).to(torch.bfloat16)
                            for v in _data(n)["x"]])
    for r, out in enumerate(res):
        got = out["bf16"]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16),
                           emul[r].view(torch.int16))
        diff = np.abs(got.float().numpy() - want[r])
        assert (diff <= _bf16_ulp(want[r])).all(), diff.max()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_anchors(worlds, n):
    """adasum(a, a) = a and disjoint supports sum, bitwise, over the
    world (and for the combine alone)."""
    d = _data(n)
    a = torch.from_numpy(d["x"][0])
    assert torch.equal(adasum_combine(a, a), a)
    for out in worlds[n]:
        assert torch.equal(out["same"], a)
        assert torch.equal(out["disjoint"],
                           torch.from_numpy(d["disjoint"].sum(axis=0)))


def test_power_of_two_and_subset_errors(worlds):
    for out in worlds[3]:
        assert "power-of-two world, got 3" in out["not_pow2"]
        assert "power-of-two world, got 3" in out["not_pow2_opt"]
    for out in worlds[4]:
        for k in ("subset", "subset_allreduce", "subset_opt"):
            assert "process subset" in out[k], out[k]
    with pytest.raises(hvd.HorovodInternalError, match="power-of-two"):
        adasum_distances(6)
    assert adasum_distances(8) == [1, 2, 4]


@pytest.mark.parametrize("n,local", [(4, 2), (8, 4)])
def test_hierarchical_adasum_matches_jax(worlds, n, local):
    """Nodes of ``local`` ranks (r // local): reduce-scatter and average
    within, Adasum across, all-gather within, as JAX's function on a
    (n // local, local) mesh."""
    mesh = _mesh(n, ("cross", "local"), (n // local, local))
    h = jnp.asarray(_data(n)["h"]).reshape((n // local, local, 8, 3))
    fn = shard_map(
        lambda t: jadasum.hierarchical_adasum(t[0, 0], "cross",
                                              "local")[None, None],
        mesh=mesh, in_specs=P("cross", "local"),
        out_specs=P("cross", "local"), check_vma=False)
    want = np.asarray(jax.jit(fn)(h)).reshape(n, 8, 3)
    for r, out in enumerate(worlds[n]):
        np.testing.assert_allclose(out["hier"].numpy(), want[r], rtol=2e-6,
                                   atol=2e-6 * np.abs(want).max())


def _mlp_grads(d, r):
    p = {k: torch.from_numpy(d["p_" + k]).requires_grad_(True)
         for k in MLP}
    inp = torch.from_numpy(d["inp"][r])
    h = torch.relu(inp @ p["dense_0.kernel"] + p["dense_0.bias"])
    ((h @ p["dense_1.kernel"] + p["dense_1.bias"]) ** 2).sum().backward()
    return {k: v.grad for k, v in p.items()}


def test_distributed_optimizer_adasum_buckets(worlds):
    """Several buckets: the hook issues each bucket's first level and
    synchronize() the rest, in plan order on every rank; the result is
    bitwise the emulated composition of each bucket and matches JAX's
    DistributedOptimizer(op=Adasum)."""
    res = worlds[4]
    d = _data(4)
    opt = None
    hvd.init(device="cpu")
    named = [(k, torch.nn.Parameter(torch.from_numpy(d["p_" + k])))
             for k in MLP]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([q for _, q in named], lr=1.0),
        named_parameters=named, fusion_threshold_bytes=THRESHOLD)
    plans, order = opt.bucket_plan, [k for k, _ in
                                     zip(opt._names, opt._params)]
    assert len(plans) == res[0]["opt_buckets"] > 1
    grads = [_mlp_grads(d, r) for r in range(4)]
    buckets = [pack_buckets_by_plan([g[k] for k in order], plans)
               for g in grads]
    reduced = [emulated_adasum([b[i] for b in buckets])
               for i in range(len(plans))]
    for r, out in enumerate(res):
        leaves = unflatten_buckets_by_plan([red[r] for red in reduced],
                                           plans, len(order))
        for k, leaf in zip(order, leaves):
            assert torch.equal(out["opt_grads"][k], leaf), k

    _mesh(4)
    jopt = jhvd.DistributedOptimizer(optax.sgd(1.0), op=jhvd.Adasum,
                                     fusion_threshold_bytes=THRESHOLD)
    params = jax.tree.map(jnp.asarray, _flax_mlp(d))
    state = jopt.init(params)

    def body(inp):
        def loss(p):
            h = jax.nn.relu(inp[0] @ p["dense_0"]["kernel"]
                            + p["dense_0"]["bias"])
            return ((h @ p["dense_1"]["kernel"] + p["dense_1"]["bias"])
                    ** 2).sum()
        upd, _ = jopt.update(jax.grad(loss)(params), state, params)
        return jax.tree.map(lambda u: -u[None], upd)

    fn = shard_map(body, mesh=jhvd.mesh(), in_specs=P("hvd"),
                   out_specs=P("hvd"), check_vma=False)
    want = jax.tree.map(np.asarray, jax.jit(fn)(jnp.asarray(d["inp"])))
    for r, out in enumerate(res):
        for k, g in out["opt_grads"].items():
            layer, leaf = k.split(".")
            w = want[layer][leaf][r]
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-6,
                                       atol=2e-6 * np.abs(w).max())
        assert out["int8_wire"] is None


def test_example_tokens_are_the_jax_examples():
    """The JAX example's bigram batch, generated inline in its main."""
    vocab, B, T = 128, 4, 16
    r = np.random.RandomState(0)
    table = r.randint(0, vocab, (vocab, 4))
    toks = np.zeros((B, T), dtype=np.int64)
    toks[:, 0] = r.randint(0, vocab, B)
    choice = r.randint(0, 4, (B, T))
    for t in range(1, T):
        toks[:, t] = table[toks[:, t - 1], choice[:, t]]
    np.testing.assert_array_equal(bigram_tokens(vocab, B, T), toks)


def _jax_example_steps(params, tokens):
    """The JAX example's step (``examples/adasum_gpt2.py``) on a
    two-device mesh in float32: value_and_grad of the local loss,
    DistributedOptimizer(optax.adam(lr), op=Adasum), psum'd loss / n."""
    mesh = _mesh(2)
    model = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **_CFG))
    opt = jhvd.DistributedOptimizer(optax.adam(LR), op=jhvd.Adasum)
    state = opt.init(params)

    def loss_fn(p, tok):
        return jt.causal_lm_loss(model.apply({"params": p}, tok), tok)[0]

    def step_fn(p, s, tok):
        loss, g = jax.value_and_grad(loss_fn)(p, tok)
        upd, s = opt.update(g, s, p)
        return (optax.apply_updates(p, upd), s,
                jax.lax.psum(loss, "hvd").reshape(1) / 2)

    step = jax.jit(shard_map(step_fn, mesh=mesh,
                             in_specs=(P(), P(), P("hvd")),
                             out_specs=(P(), P(), P()), check_vma=False))
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, jnp.asarray(tokens))
        losses.append(float(loss[0]))
    return params, losses


def test_example_matches_jax_example_step(worlds):
    res = worlds[2]
    _, params = _jax_init()
    want, want_losses = _jax_example_steps(
        params, bigram_tokens(128, 4, 16))
    want = params_from_flax(jax.tree.map(np.asarray, want))
    for out in res:
        first, last = out["example"]
        np.testing.assert_allclose(out["example_losses"], want_losses,
                                   rtol=1e-5)
        assert (first, last) == (out["example_losses"][0],
                                 out["example_losses"][-1])
        init = torch.load(worlds["init"])
        for name, w in want.items():
            moved = w.numpy() - init[name].numpy()
            err = out["example_state"][name].numpy() - w.numpy()
            assert float(np.abs(err).max()) <= STEPS * LR * 1.01, name
            if name.endswith("attn.key.bias"):
                continue  # true gradient 0: Adam normalizes noise
            rel = float(np.linalg.norm(err) / np.linalg.norm(moved))
            assert rel <= 1e-2, f"{name}'s movement differs by {rel:.2e}"
        for name in want:
            assert torch.equal(out["example_state"][name],
                               res[0]["example_state"][name])
    log = worlds["log"]
    assert "step 0: loss" in log and "step 2: loss" in log
    assert "in 3 steps" in log and "adasum over 2 ranks" in log


def test_example_needs_a_card_or_the_cpu():
    """Without a card the example refuses unless asked for the CPU, and
    on the CPU a world of one trains (bf16, the example's dtype): Adasum
    of one rank is the identity, so its loss falls as plain Adam's."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would use it")
    from horovod_tpu_torch.examples import adasum_gpt2

    args = ["--layers", "1", "--hidden", "64", "--vocab", "64",
            "--seq-len", "16", "--batch-size", "2", "--steps", "4"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adasum_gpt2.main(args)
    stats = {}
    first, last = adasum_gpt2.main(args + ["--device", "cpu"], stats)
    assert len(stats["losses"]) == 4 and np.isfinite(stats["losses"]).all()
    assert last < first
