"""The port of ``examples/llama_adasum.py`` against the JAX example.

* Its tokens are the JAX example's (the bigram batch the JAX ``main``
  draws inline from ``RandomState(0)``) and its config the JAX
  example's for the same flags.
* Its step at the JAX test's size (``tests/test_examples.py:65-76``: 2
  layers x 256, vocab 256, seq 64, batch 1) at world 2 over gloo, in
  float32 from weights converted with ``models/convert.py``, against the
  JAX example's step (``DistributedOptimizer(optax.adam(lr),
  op=Adasum)`` in ``shard_map`` on two devices) on the same batch, 3
  steps: the losses within 1e-5 relative, each parameter's movement
  within 1e-2 relative L2 of the JAX example's (Adam divides each
  gradient by its own scale, so elements whose gradient is mostly
  cancellation turn float32 rounding into a large share of lr there;
  ``tests/test_torch_adasum.py`` reads the same) and within steps x lr
  elementwise, and the two ranks bitwise equal. ``--bf16-allreduce``
  runs in the same world.
* ``--flash --remat`` give the losses of the plain run (the kernels'
  plain versions on the CPU, every block recomputed in the backward)
  within 2e-5 relative, in float32.
* The loss falls as ``tests/test_examples.py:65-76`` requires (14
  steps, by more than 0.3), in the example's bf16.
* Without a card the entry point refuses unless given ``--device cpu``.
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
from horovod_tpu_torch.examples import llama_adasum
from horovod_tpu_torch.models.convert import params_from_flax

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the JAX test's size (tests/test_examples.py:68-70)
SIZE = ["--layers", "2", "--hidden", "256", "--vocab", "256", "--seq-len",
        "64", "--batch-size", "1"]
LR, STEPS = 3e-4, 3

_WORKER = r'''
import dataclasses
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples import llama_adasum

out, size, steps = sys.argv[1], eval(sys.argv[2]), sys.argv[3]
# the JAX example's model in float32, for a tight comparison
plain = llama_adasum.LLAMA2_7B
llama_adasum.LLAMA2_7B = dataclasses.replace(plain, dtype=torch.float32)
stats = {}
res = {"example": llama_adasum.main(
    size + ["--device", "cpu", "--steps", steps], stats,
    init=torch.load(out + "/init.pt"))}
res["losses"] = stats["losses"]
res["state"] = {k: v.detach().clone()
                for k, v in stats["model"].state_dict().items()}
llama_adasum.LLAMA2_7B = plain
bf = {}
res["bf16_allreduce"] = llama_adasum.main(
    size + ["--device", "cpu", "--steps", "2", "--bf16-allreduce"], bf)
torch.save(res, out + "/rank%d.pt" % hvd.rank())
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_cfg():
    return dataclasses.replace(
        jt.LLAMA2_7B, num_layers=2, hidden_size=256, num_heads=2,
        num_kv_heads=None, vocab_size=256, max_seq_len=64,
        dtype=jnp.float32)


def _jax_init():
    model = jt.Transformer(_jax_cfg())
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 64), jnp.int32))["params"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("llama")
    params = _jax_init()
    torch.save(params_from_flax(jax.tree.map(np.asarray, params)),
               out / "init.pt")
    port = _free_port()
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(out), repr(SIZE),
             str(STEPS)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        # the JAX example's steps run while the workers do
        want = _jax_example_steps(params, llama_adasum.bigram_tokens(
            256, 2, 64))
    finally:
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=150)[0])
            finally:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    return {"res": [torch.load(out / f"rank{r}.pt", weights_only=False)
                    for r in range(2)],
            "log": outs[0], "init": torch.load(out / "init.pt"),
            "want": want}


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    yield
    hvd.shutdown()


def _jax_example_steps(params, tokens):
    """The JAX example's step on a two-device mesh in float32:
    value_and_grad of the local loss, DistributedOptimizer(optax.adam(lr),
    op=Adasum), the psum'd loss over 2."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    jhvd.init(mesh=mesh)
    try:
        model = jt.Transformer(_jax_cfg())
        opt = jhvd.DistributedOptimizer(optax.adam(LR), op=jhvd.Adasum,
                                        compression=jhvd.Compression.none)
        state = opt.init(params)

        def loss_fn(p, tok):
            return jt.causal_lm_loss(model.apply({"params": p}, tok),
                                     tok)[0]

        def step_fn(p, s, tok):
            loss, g = jax.value_and_grad(loss_fn)(p, tok)
            upd, s = opt.update(g, s, p)
            return (optax.apply_updates(p, upd), s,
                    jax.lax.psum(loss, "hvd").reshape(1) / 2)

        step = jax.jit(shard_map(step_fn, mesh=mesh,
                                 in_specs=(P(), P(), P("hvd")),
                                 out_specs=(P(), P(), P()),
                                 check_vma=False))
        losses = []
        for _ in range(STEPS):
            params, state, loss = step(params, state, jnp.asarray(tokens))
            losses.append(float(loss[0]))
    finally:
        jhvd.shutdown()
    return params_from_flax(jax.tree.map(np.asarray, params)), losses


def test_tokens_and_config_are_the_jax_examples():
    """The JAX example's bigram batch, generated inline in its main, and
    its config for the same flags."""
    vocab, B, T = 256, 2, 64
    r = np.random.RandomState(0)
    table = r.randint(0, vocab, (vocab, 4))
    toks = np.zeros((B, T), dtype=np.int64)
    toks[:, 0] = r.randint(0, vocab, B)
    choice = r.randint(0, 4, (B, T))
    for t in range(1, T):
        toks[:, t] = table[toks[:, t - 1], choice[:, t]]
    np.testing.assert_array_equal(llama_adasum.bigram_tokens(vocab, B, T),
                                  toks)
    args = llama_adasum.parser().parse_args(
        ["--layers", "12", "--hidden", "4096", "--vocab", "32000",
         "--seq-len", "4096", "--remat"])
    cfg = llama_adasum.config(args)
    want = dataclasses.replace(
        jt.LLAMA2_7B, num_layers=12, hidden_size=4096, num_heads=32,
        num_kv_heads=None, vocab_size=32000, max_seq_len=4096, remat=True)
    for field in ("num_layers", "hidden_size", "num_heads", "num_kv_heads",
                  "mlp_ratio", "vocab_size", "max_seq_len", "norm",
                  "position", "activation", "tie_embeddings", "remat",
                  "rope_theta"):
        assert getattr(cfg, field) == getattr(want, field), field
    assert cfg.head_dim == 128 and cfg.mlp_dim == 11008
    defaults = llama_adasum.parser().parse_args([])
    assert (defaults.batch_size, defaults.seq_len, defaults.steps,
            defaults.lr, defaults.layers, defaults.hidden,
            defaults.vocab) == (2, 512, 20, 3e-4, 4, 1024, 2048)
    assert not (defaults.remat or defaults.flash or defaults.bf16_allreduce)


def test_step_matches_the_jax_example(world):
    want, want_losses = world["want"]
    init = world["init"]
    for out in world["res"]:
        np.testing.assert_allclose(out["losses"], want_losses, rtol=1e-5)
        assert out["example"] == (out["losses"][0], out["losses"][-1])
        for name, w in want.items():
            moved = w.numpy() - init[name].numpy()
            err = out["state"][name].numpy() - w.numpy()
            assert float(np.abs(err).max()) <= STEPS * LR * 1.01, name
            rel = float(np.linalg.norm(err) / np.linalg.norm(moved))
            assert rel <= 1e-2, f"{name}'s movement differs by {rel:.2e}"
        for name in want:
            assert torch.equal(out["state"][name],
                               world["res"][0]["state"][name])
    log = world["log"]
    assert "Llama 2L/256H (" in log and "batch 1 x 2 ranks, seq 64" in log
    assert "step 2: loss" in log and "step 0: loss" not in log
    assert "in 3 steps" in log and "over 2 rank(s)" in log


def test_bf16_allreduce_runs(world):
    for out in world["res"]:
        first, last = out["bf16_allreduce"]
        assert np.isfinite([first, last]).all()
    assert world["res"][0]["bf16_allreduce"] == \
        world["res"][1]["bf16_allreduce"]


def test_flash_remat_gives_the_plain_losses(monkeypatch):
    monkeypatch.setattr(llama_adasum, "LLAMA2_7B", dataclasses.replace(
        llama_adasum.LLAMA2_7B, dtype=torch.float32))
    args = SIZE + ["--device", "cpu", "--steps", "3"]
    plain, fused = {}, {}
    llama_adasum.main(args, plain)
    llama_adasum.main(args + ["--flash", "--remat"], fused)
    assert fused["model"].cfg.remat and not plain["model"].cfg.remat
    np.testing.assert_allclose(fused["losses"], plain["losses"], rtol=2e-5)


def test_loss_falls_and_the_entry_point_needs_a_card(monkeypatch):
    """tests/test_examples.py:65-76's run, in the example's bf16 on the
    CPU (world 1: Adasum of one rank is the identity); without a card
    and without --device cpu the example refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama_adasum.main(SIZE + ["--steps", "2"])
    first, last = llama_adasum.main(SIZE + ["--device", "cpu", "--steps",
                                            "14"])
    assert last < first - 0.3, (first, last)
