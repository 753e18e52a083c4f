"""The port of ``examples/gpt2_elastic.py`` against the JAX example.

* Its tokens and config are the JAX example's for the same flags.
* At ``tests/test_examples.py:38-40``'s size (2 layers x 128, vocab 512,
  seq 128, batch 4 a rank, ``--steps 12 --commit-every 4``) on a gloo
  world of 2, in float32 from weights converted with
  ``models/convert.py``: every step's loss within 2e-5 relative of the
  JAX example's step (its ``build_step`` on a two-device mesh, Adam at
  lr x 2, the psum'd loss over 2); the ranks bitwise equal; the printed
  lines are the JAX example's.
* A reset injected on both ranks (the loss allreduce of step 6 raises
  ``HorovodInternalError``) restores the commit of step 4, joins the
  world again and ends bitwise the uninterrupted run: parameters, Adam's
  state and losses.
* ``--flash`` gives the plain run's losses within 2e-5 relative (the
  kernels' plain versions on the CPU).
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
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as jt
from horovod_tpu.utils.script_loader import load_example
from horovod_tpu_torch.examples import gpt2_elastic
from horovod_tpu_torch.models.convert import params_from_flax

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the JAX test's size (tests/test_examples.py:38-40: the example's
#: defaults, 12 steps, a commit every 4)
SIZE = ["--steps", "12", "--commit-every", "4"]
LOSS_RTOL = 2e-5

_WORKER = r'''
import dataclasses, sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.exceptions import HorovodInternalError
from horovod_tpu_torch.examples import gpt2_elastic

out, size = sys.argv[1], eval(sys.argv[2])
gpt2_elastic.GPT2_SMALL = dataclasses.replace(gpt2_elastic.GPT2_SMALL,
                                              dtype=torch.float32)
init = torch.load(out + "/init.pt")


def run(fail_at=None):
    real, calls = gpt2_elastic.allreduce, [0]

    def allreduce(x, *a, **k):
        calls[0] += 1
        if calls[0] == fail_at:
            raise HorovodInternalError("injected: a peer went away")
        return real(x, *a, **k)

    gpt2_elastic.allreduce = allreduce
    try:
        stats = {}
        final = gpt2_elastic.main(size + ["--device", "cpu"], stats,
                                  init=init)
    finally:
        gpt2_elastic.allreduce = real
    adam = {f"{pid}.{k}": v.clone()
            for pid, st in stats["optimizer"].state_dict()["state"].items()
            for k, v in st.items()}
    return {"final": final, "losses": stats["losses"],
            "resets": stats["resets"], "commits": len(stats["commit_s"]),
            "params": {k: v.detach().clone()
                       for k, v in stats["model"].state_dict().items()},
            "adam": adam}


res = {"plain": run(), "reset": run(fail_at=6)}
torch.save(res, out + "/rank%d.pt" % hvd.rank())
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_cfg():
    return dataclasses.replace(
        jt.GPT2_SMALL, num_layers=2, hidden_size=128, num_heads=2,
        vocab_size=512, max_seq_len=128, dtype=jnp.float32)


def _jax_example_losses(params, steps=12):
    """The JAX example's step (its own ``build_step``) on a two-device
    mesh in float32: ``DistributedOptimizer(optax.adam(lr * 2))``, the
    global batch of ``RandomState(0)`` rows sharded over the mesh."""
    example = load_example("gpt2_elastic")
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    jhvd.init(mesh=mesh)
    try:
        model = jt.Transformer(_jax_cfg())
        opt = jhvd.DistributedOptimizer(optax.adam(1e-3 * 2))
        state = opt.init(params)
        step = example.build_step(model, opt, 2, mesh)
        toks = np.random.RandomState(0).randint(0, 512, (4 * 2, 128))
        tok = jax.device_put(toks, NamedSharding(mesh, P("hvd")))
        losses = []
        for _ in range(steps):
            params, state, loss = step(params, state, tok)
            losses.append(float(loss[0]))
    finally:
        jhvd.shutdown()
    return losses


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("gpt2_elastic")
    model = jt.Transformer(_jax_cfg())
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 128), jnp.int32))["params"]
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
            [sys.executable, "-c", _WORKER, str(out), repr(SIZE)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        want = _jax_example_losses(params)
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    return {"res": [torch.load(out / f"rank{r}.pt", weights_only=False)
                    for r in range(2)], "log": outs[0], "want": want}


@pytest.fixture(autouse=True)
def _fresh_world():
    hvd.shutdown()
    yield
    hvd.shutdown()
    hvd.elastic.preemption.uninstall()


def test_tokens_and_config_are_the_jax_examples():
    rows = np.random.RandomState(0).randint(0, 512, (4 * 3, 128))
    for r in range(3):
        np.testing.assert_array_equal(gpt2_elastic.tokens(512, 4, 128, r, 3),
                                      rows[r * 4:(r + 1) * 4])
    args = gpt2_elastic.parser().parse_args(
        ["--layers", "24", "--hidden", "1024", "--vocab", "50257",
         "--seq-len", "1024"])
    cfg = gpt2_elastic.config(args)
    want = dataclasses.replace(jt.GPT2_SMALL, num_layers=24,
                               hidden_size=1024, num_heads=16,
                               vocab_size=50257, max_seq_len=1024)
    for field in ("num_layers", "hidden_size", "num_heads", "mlp_ratio",
                  "vocab_size", "max_seq_len", "norm", "position",
                  "activation", "tie_embeddings"):
        assert getattr(cfg, field) == getattr(want, field), field
    assert cfg.head_dim == 64 and cfg.mlp_dim == 4096
    d = gpt2_elastic.parser().parse_args([])
    assert (d.batch_size, d.seq_len, d.steps, d.commit_every, d.lr,
            d.layers, d.hidden, d.vocab, d.flash) == \
        (4, 128, 50, 10, 1e-3, 2, 128, 512, False)


def test_losses_match_the_jax_example(world):
    r0, r1 = world["res"]
    for out in (r0, r1):
        np.testing.assert_allclose(out["plain"]["losses"], world["want"],
                                   rtol=LOSS_RTOL)
        assert out["plain"]["final"] == out["plain"]["losses"][-1]
        assert out["plain"]["commits"] == 3
    for k, v in r0["plain"]["params"].items():
        assert torch.equal(v, r1["plain"]["params"][k]), k
    log = world["log"]
    for step in (4, 8, 12):
        assert f"step {step}: loss " in log
    assert "(world 2)" in log and "done: 12 steps, final loss" in log


def test_injected_reset_resumes_bitwise(world):
    for out in world["res"]:
        plain, reset = out["plain"], out["reset"]
        assert reset["resets"] == 1 and plain["resets"] == 0
        assert reset["losses"] == plain["losses"]
        assert reset["final"] == plain["final"]
        for k, v in plain["params"].items():
            assert torch.equal(reset["params"][k], v), k
        assert reset["adam"].keys() == plain["adam"].keys()
        for k, v in plain["adam"].items():
            assert torch.equal(reset["adam"][k], v), k


def test_flash_gives_the_plain_losses(monkeypatch):
    monkeypatch.setattr(gpt2_elastic, "GPT2_SMALL", dataclasses.replace(
        gpt2_elastic.GPT2_SMALL, dtype=torch.float32))
    args = ["--device", "cpu", "--steps", "4", "--commit-every", "2"]
    plain, fused = {}, {}
    gpt2_elastic.main(args, plain)
    hvd.shutdown()
    gpt2_elastic.main(args + ["--flash"], fused)
    np.testing.assert_allclose(fused["losses"], plain["losses"],
                               rtol=LOSS_RTOL)


def test_runs_in_bf16_and_needs_a_card(monkeypatch):
    """tests/test_examples.py:38-40's run in the example's bf16 on the
    CPU (finite), and without a card and without --device cpu the
    example refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt2_elastic.main(SIZE)
    final = gpt2_elastic.main(SIZE + ["--device", "cpu"])
    assert np.isfinite(final)
