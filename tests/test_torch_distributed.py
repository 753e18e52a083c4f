"""The port's Horovod surface: basics, collectives, broadcasts, and
data-parallel training against the JAX package's DistributedOptimizer.

* a world of one (``init(device="cpu")``, gloo): topology queries,
  identity collectives, the optimizer stepping exactly as the bare torch
  optimizer does;
* without a card, ``init()``, ``make_lm_train_step`` and the example
  refuse to run unless asked for the CPU;
* compression: the cast compressors round-trip; ``Compression.int8``
  and ``HOROVOD_COMPRESSION=int8`` build an optimizer on the int8 wire
  (block 256, error feedback);
* a world of two: two worker processes join over gloo through the slot
  environment the launcher exports (``HOROVOD_RANK/SIZE``,
  ``HVD_TPU_COORDINATOR_ADDRESS``) and run every scenario in one world:
  each allreduce op with pre/postscale, grouped allreduce, uneven
  allgather, broadcast, the async handles, ``broadcast_parameters``,
  ``broadcast_optimizer_state``, ``broadcast_object``; then 3 data-
  parallel steps of a tiny float32 GPT-2 under
  ``DistributedOptimizer(torch.optim.AdamW(weight_decay=1e-4))`` (small
  fusion threshold: several buckets), the global batch split in two.
  The reference is ``hvd.DistributedOptimizer(optax.adamw(lr))`` inside
  ``shard_map`` on a two-device JAX mesh with the same global batch;
  with equal token counts per shard both equal the full-batch mean step.
  Parameters agree within 1e-6 + 1% of the most Adam can move them
  (steps x lr): Adam divides each gradient by its own scale, so where a
  gradient is mostly cancellation (a query bias) the order of float32
  sums shows in the update at ~1% of lr. The key biases' true gradient
  is 0 (softmax ignores a shift shared by a row), so Adam normalizes
  rounding noise of either sign and they may move up to lr per step
  apart. Both ranks end bitwise equal. ``backward_passes_per_step=2``
  over two half batches equals one pass over the whole shard within the
  same tolerance.
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
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
LR = 1e-3
STEPS = 3
_CFG = dict(vocab_size=61, num_layers=2, num_heads=2, hidden_size=32,
            max_seq_len=16)


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    yield
    hvd.shutdown()


# ---------------------------------------------------------------------------
# a world of one
# ---------------------------------------------------------------------------

def test_world_of_one_on_the_cpu():
    with pytest.raises(hvd.NotInitializedError):
        hvd.rank()
    hvd.init(device="cpu")
    assert hvd.is_initialized()
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
            hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
    assert hvd.gloo_enabled() and not hvd.nccl_enabled()
    assert not hvd.cuda_enabled() and not hvd.mpi_built()
    assert hvd.device() == torch.device("cpu")
    assert hvd.global_process_set().ranks == [0]
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert torch.equal(hvd.allreduce(x), x)
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum, postscale_factor=2.0),
                       2 * x)
    assert torch.equal(hvd.allgather(x), x)
    assert torch.equal(hvd.broadcast(x, root_rank=0), x)
    assert hvd.broadcast_object({"a": 1}) == {"a": 1}
    with pytest.raises(NotImplementedError, match="item 10"):
        hvd.allreduce(x, process_set=hvd.ProcessSet([0]))
    with pytest.raises(NotImplementedError, match="Adasum"):
        hvd.allreduce(x, op=hvd.Adasum)

    # the optimizer reduces nothing: its step is the bare optimizer's
    torch.manual_seed(0)
    a, b = torch.nn.Linear(4, 3), torch.nn.Linear(4, 3)
    b.load_state_dict(a.state_dict())
    dopt = hvd.DistributedOptimizer(torch.optim.AdamW(a.parameters(), lr=.1),
                                    named_parameters=a.named_parameters())
    opt = torch.optim.AdamW(b.parameters(), lr=.1)
    inp = torch.randn(5, 4)
    for m, o in ((a, dopt), (b, opt)):
        m(inp).square().sum().backward()
        o.step()
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    hvd.shutdown()
    assert not hvd.is_initialized()


def test_entry_points_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: init() would use it")
    from horovod_tpu_torch.examples import gpt2_pretraining

    cfg = dataclasses.replace(tt.GPT2_SMALL, dtype=torch.float32, **_CFG)

    def adamw(ps):
        return torch.optim.AdamW(ps, lr=LR)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    with pytest.raises(hvd.NotInitializedError):
        hvd.make_lm_train_step(cfg, adamw)
    args = ["--layers", "1", "--hidden", "64", "--seq-len", "16",
            "--batch-size", "2", "--num-iters", "1",
            "--num-batches-per-iter", "1", "--num-warmup-batches", "0"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt2_pretraining.main(args)
    with pytest.raises(NotImplementedError, match="fused"):
        gpt2_pretraining.main(args + ["--fused-ce", "--device", "cpu"])
    stats = {}
    rate, mfu = gpt2_pretraining.main(args + ["--device", "cpu", "--flash",
                                              "--fused-norm"], stats)
    assert rate > 0 and mfu is None and np.isfinite(stats["losses"]).all()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.make_lm_train_step(cfg, adamw, device="cuda")
    model, step = hvd.make_lm_train_step(cfg, adamw)
    loss = step(torch.randint(0, 61, (2, 16)))
    assert np.isfinite(float(loss))
    with pytest.raises(NotImplementedError, match="item 9"):
        hvd.make_lm_train_step(cfg, adamw, mesh="dp=1,tp=1")
    with pytest.raises(NotImplementedError, match="item 14"):
        hvd.make_lm_train_step(cfg, adamw, sequence_parallel="ring")


def test_example_shards_the_global_batch():
    """As the JAX example does, the port's example draws ``batch * n``
    rows from seed 0 and gives rank r rows ``[r * batch, (r + 1) *
    batch)``: each rank trains on its own data."""
    from horovod_tpu_torch.examples.gpt2_pretraining import synthetic_tokens

    glob = np.random.RandomState(0).randint(0, 61, (3 * 4, 16))
    shards = [synthetic_tokens(61, 3, 16, r, 4) for r in range(4)]
    assert all(s.shape == (3, 16) and s.dtype == np.int64 for s in shards)
    np.testing.assert_array_equal(np.concatenate(shards), glob)
    assert not np.array_equal(shards[0], shards[1])
    np.testing.assert_array_equal(synthetic_tokens(61, 3, 16, 0, 1),
                                  glob[:3])


def test_compression(monkeypatch):
    x = torch.linspace(-3, 3, 7)
    for comp, wire in ((hvd.Compression.fp16, torch.float16),
                       (hvd.Compression.bf16, torch.bfloat16)):
        w, ctx = comp.compress(x)
        assert w.dtype == wire
        assert torch.equal(comp.decompress(w, ctx), w.to(torch.float32))
    ints = torch.arange(3)
    assert hvd.Compression.bf16.compress(ints)[0] is ints
    assert hvd.Compression.lookup("bfloat16") is hvd.Compression.bf16
    with pytest.raises(ValueError, match="unknown"):
        hvd.Compression.lookup("int4")
    hvd.init(device="cpu")
    lin = torch.nn.Linear(2, 2)
    int8_ef = hvd.Compression.int8
    opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1),
                                   compression=int8_ef)
    assert (opt.wire.kind, opt.wire.block, opt.wire.error_feedback) == (
        "int8", 256, True)
    assert opt.error_feedback_residual == {}  # a world of one reduces nothing
    with pytest.raises(ValueError, match="int8 wire"):
        hvd.allreduce(x, compression=int8_ef)  # int8 codes cannot be summed
    hvd.shutdown()
    monkeypatch.setenv("HOROVOD_COMPRESSION", "int8")
    hvd.init(device="cpu")
    opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1))
    assert (opt.wire.kind, opt.wire.block, opt.wire.error_feedback) == (
        "int8", 256, True)


# ---------------------------------------------------------------------------
# a world of two
# ---------------------------------------------------------------------------

_WORKER = r'''
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
res = {"topology": (hvd.rank(), hvd.size(), hvd.local_rank(),
                    hvd.local_size(), hvd.gloo_enabled())}
base = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 1 + 10 * r
keep = base.clone()
for op in ("Average", "Sum", "Min", "Max", "Product"):
    res["allreduce_" + op] = hvd.allreduce(
        base, op=getattr(hvd, op), prescale_factor=0.5, postscale_factor=3.0)
res["input_untouched"] = bool(torch.equal(base, keep))
res["int_average"] = hvd.allreduce(torch.tensor([r + 1, 7],
                                                dtype=torch.int32))
h = hvd.allreduce_async(base, op=hvd.Sum)
res["async_sum"] = hvd.synchronize(h)
h2 = hvd.broadcast_async(base, root_rank=1)
hvd.barrier()
res["polled"] = hvd.poll(h2)
res["async_broadcast"] = hvd.synchronize(h2)
inplace = base.clone()
hvd.allreduce_(inplace, op=hvd.Max)
res["inplace_max"] = inplace
inplace2 = base.clone()
res["async_inplace_is_input"] = hvd.synchronize(
    hvd.allreduce_async_(inplace2, op=hvd.Min)) is inplace2
res["async_inplace_min"] = inplace2
inplace3 = base.clone()
hvd.synchronize(hvd.broadcast_async_(inplace3, root_rank=0))
res["async_inplace_broadcast"] = inplace3
res["grouped"] = hvd.grouped_allreduce(
    [base, torch.tensor([r, 2 * r], dtype=torch.int64), base[0] * 2],
    op=hvd.Sum)
res["grouped_async"] = hvd.synchronize(hvd.grouped_allreduce_async(
    [base, base[1]]))
res["allgather"] = hvd.allgather(torch.full((r + 1, 2), float(r)))
res["broadcast"] = hvd.broadcast(base, root_rank=1)

torch.manual_seed(100 + r)
lin = torch.nn.Linear(3, 2)
hvd.broadcast_parameters(lin.state_dict(), root_rank=0)
res["bp"] = {k: v.clone() for k, v in lin.state_dict().items()}
opt = torch.optim.AdamW(lin.parameters(), lr=0.1)
if r == 0:
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()
hvd.broadcast_optimizer_state(opt, root_rank=0)
res["bos"] = {k: (v.clone() if torch.is_tensor(v) else v)
              for k, v in opt.state_dict()["state"][0].items()}
res["bos_lr"] = opt.param_groups[0]["lr"]
res["bobj"] = hvd.broadcast_object({"from": r, "xs": [1, 2]}
                                   if r == 0 else None, root_rank=0)

cfg = tt.TransformerConfig(dtype=torch.float32, **eval(sys.argv[2]))
init = torch.load(out + "/init.pt")
tokens = torch.load(out + "/tokens.pt")
lr = float(sys.argv[3])
shard = tokens[2 * r:2 * r + 2]


def run(steps, passes):
    model = tt.Transformer(cfg)
    model.load_state_dict(init)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=passes, fusion_threshold_bytes=4096)
    for _ in range(steps):
        for part in shard.chunk(passes):
            loss, _ = tt.causal_lm_loss(model(part), part)
            loss.backward()
        opt.step()
        opt.zero_grad()
    return model.state_dict(), len(opt.bucket_plan)


res["dp"], res["buckets"] = run(int(sys.argv[4]), 1)
res["one_step"], _ = run(1, 1)
res["accum_one_step"], _ = run(1, 2)
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_dp_reference(params, tokens, steps):
    """``steps`` of hvd.DistributedOptimizer(optax.adamw(LR)) in
    shard_map over a two-device mesh, batch sharded over "hvd"."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    jhvd.init(mesh=mesh)
    model = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **_CFG))
    opt = jhvd.DistributedOptimizer(optax.adamw(LR))
    state = opt.init(params)

    def loss_fn(p, tok):
        return jt.causal_lm_loss(model.apply({"params": p}, tok), tok)[0]

    def step_fn(p, s, tok):
        g = jax.grad(loss_fn)(p, tok)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s

    step = jax.jit(shard_map(step_fn, mesh=mesh,
                             in_specs=(P(), P(), P("hvd")),
                             out_specs=(P(), P()), check_vma=False))
    for _ in range(steps):
        params, state = step(params, state, jnp.asarray(tokens))
    return params


def _close_params(got, want, what):
    for name, w in want.items():
        g = got[name].numpy()
        tol = (STEPS * LR * 1.01 if name.endswith("attn.key.bias")
               else 1e-6 + 1e-2 * STEPS * LR)
        err = float(np.abs(g - w.numpy()).max())
        assert err <= tol, f"{what}: {name} differs by {err} > {tol}"


def test_world_of_two_over_gloo(tmp_path):
    jmod = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **_CFG))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                jnp.ones((1, 4), jnp.int32))["params"]
    init = params_from_flax(jax.tree.map(np.asarray, params))
    tokens = np.random.RandomState(0).randint(0, 61, (4, 16)).astype(
        np.int64)
    torch.save(init, tmp_path / "init.pt")
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
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path), repr(_CFG),
             repr(LR), str(STEPS)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    # the JAX reference runs while the workers do
    want = params_from_flax(jax.tree.map(
        np.asarray, _jax_dp_reference(params, tokens, STEPS)))
    want_one = params_from_flax(jax.tree.map(
        np.asarray, _jax_dp_reference(params, tokens, 1)))

    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        finally:
            p.kill()
        assert p.returncode == 0, outs[-1]
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]

    a = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 1
    b = a + 10
    expect = {"Average": (0.5 * a + 0.5 * b) / 2 * 3,
              "Sum": (0.5 * a + 0.5 * b) * 3,
              "Min": 0.5 * a * 3, "Max": 0.5 * b * 3,
              "Product": (0.5 * a) * (0.5 * b) * 3}
    for r, out in enumerate(res):
        assert out["topology"] == (r, 2, r, 2, True)
        assert out["input_untouched"]
        for op, e in expect.items():
            assert torch.allclose(out["allreduce_" + op], e, rtol=1e-6), op
        assert out["int_average"].tolist() == [1, 7]  # 3 / 2 truncates
        assert torch.equal(out["async_sum"], a + b)
        assert out["polled"] is True
        assert torch.equal(out["async_broadcast"], b)
        assert torch.equal(out["inplace_max"], b)
        assert out["async_inplace_is_input"]
        assert torch.equal(out["async_inplace_min"], a)
        assert torch.equal(out["async_inplace_broadcast"], a)
        g0, g1, g2 = out["grouped"]
        assert torch.equal(g0, a + b) and g1.tolist() == [1, 2]
        assert g1.dtype == torch.int64 and torch.equal(g2, 2 * (a[0] + b[0]))
        ga, gb = out["grouped_async"]
        assert torch.equal(ga, (a + b) / 2) and torch.equal(gb, (a[1] + b[1])
                                                           / 2)
        assert out["allgather"].tolist() == [[0, 0], [1, 1], [1, 1]]
        assert torch.equal(out["broadcast"], b)
        assert out["bobj"] == {"from": 0, "xs": [1, 2]}
        assert out["bos_lr"] == 0.1
        assert out["buckets"] > 3
    for k in res[0]["bp"]:
        assert torch.equal(res[0]["bp"][k], res[1]["bp"][k])
    assert set(res[1]["bos"]) == set(res[0]["bos"]) >= {"exp_avg", "step"}
    for k, v in res[0]["bos"].items():
        assert torch.equal(torch.as_tensor(v), torch.as_tensor(
            res[1]["bos"][k])), k
    for k in res[0]["dp"]:
        assert torch.equal(res[0]["dp"][k], res[1]["dp"][k]), k
    _close_params(res[0]["dp"], want, f"{STEPS} DP steps")
    _close_params(res[0]["one_step"], want_one, "one DP step")
    _close_params(res[0]["accum_one_step"], want_one,
                  "backward_passes_per_step=2")
