"""The port's ``make_lm_train_step`` against the JAX package's, in a world
of two whose ranks pad their targets unevenly.

The JAX step jits one ``value_and_grad`` over the global batch, sharded
over a ``dp = 2`` mesh of two of the conftest's CPU devices: its loss
and gradients are ``Σ nll / Σ valid`` over every rank's targets. The
port runs two worker processes over gloo (the launcher's slot
environment), each with its own rows of the same global batch: rank 0's
rows carry no ``ignore_index`` (-1) padding, rank 1's are padded over
their second half, so the ranks count 30 and 16 valid targets. Both
frameworks start from the same numpy weights (``models/convert.py``)
and step AdamW (lr 1e-3, eps 1e-6, weight decay 1e-4) twice. At Adam's
default eps of 1e-8 this width has weights whose step-1 gradient is
below eps (1.1e-9 at seed 0): Adam scales their update by |g| / eps,
so the frameworks' float32 rounding (gradients equal to 4.4e-7 of the
largest) moves them by 2.4% of lr, and three of six weight seeds read
1.6-2.3x the tolerance below; at eps 1e-6 the six read at most 0.13x,
and the old step 190x on each.

* the returned loss, the same on both ranks, equals the JAX step's
  within 1e-5 relative at each step;
* the parameters after two steps agree within the tolerance of the
  data-parallel parity tests (``tests/test_torch_distributed.py``):
  1e-6 + 1% of the most Adam can move them, and lr a step for the
  attention key biases, whose true gradient is 0;
* the step as it was (each rank's own mean, the ranks' gradients of
  their own means averaged), emulated in the same workers, misses both:
  its loss by more than 1e-5 relative and its parameters by more than
  that tolerance, so the check tells the two apart.
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
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel import train as jtrain
from horovod_tpu.parallel.mesh import make_mesh
from horovod_tpu_torch.models.convert import params_from_flax

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
LR = 1e-3
STEPS = 2
EPS = 1e-6
_CFG = dict(vocab_size=61, num_layers=2, num_heads=2, hidden_size=64,
            max_seq_len=16)

_WORKER = r'''
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt

out, lr, steps = sys.argv[1], float(sys.argv[3]), int(sys.argv[4])
eps = float(sys.argv[5])
hvd.init(device="cpu")
r = hvd.rank()
cfg = tt.TransformerConfig(dtype=torch.float32, **eval(sys.argv[2]))
init = torch.load(out + "/init.pt")
shard = torch.load(out + "/tokens.pt")[2 * r:2 * r + 2]


def adamw(ps):
    return torch.optim.AdamW(ps, lr=lr, eps=eps, weight_decay=1e-4)


model, step = hvd.make_lm_train_step(cfg, adamw, device="cpu")
model.load_state_dict(init)
res = {"losses": [float(step(shard)) for _ in range(steps)],
       "params": {k: v.clone() for k, v in model.state_dict().items()}}

# the step as it was: the rank's own mean, averaged gradients of means
old = tt.Transformer(cfg)
old.load_state_dict(init)
opt = hvd.DistributedOptimizer(adamw(old.parameters()),
                               named_parameters=old.named_parameters())
res["old_losses"] = []
for _ in range(steps):
    loss, _ = tt.causal_lm_loss(old(shard), shard)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    res["old_losses"].append(float(loss))
res["old_params"] = {k: v.clone() for k, v in old.state_dict().items()}
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tokens():
    """Global batch [4, 16]: rows 0-1 (rank 0) unpadded, rows 2-3
    (rank 1) padded with -1 from position 9 on."""
    tokens = np.random.RandomState(0).randint(0, 61, (4, 16)).astype(
        np.int64)
    tokens[2:, 9:] = -1
    return tokens


def _jax_reference(params, tokens):
    """STEPS of the JAX package's make_lm_train_step on a dp = 2 mesh:
    the losses it returns and the parameters after."""
    mesh = make_mesh(dp=2, devices=jax.devices()[:2])
    cfg = jt.TransformerConfig(dtype=jnp.float32, **_CFG)
    opt = optax.adamw(LR, eps=EPS, weight_decay=1e-4)
    _, step, batch_sharding = jtrain.make_lm_train_step(cfg, opt, mesh,
                                                        donate=False)
    replicated = NamedSharding(mesh, P())
    params = jax.device_put(params, replicated)
    state = jax.device_put(opt.init(params), replicated)
    tok = jax.device_put(jnp.asarray(tokens), batch_sharding)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, tok)
        losses.append(float(loss))
    return losses, params


def _param_errors(got, want):
    """Each parameter's largest difference over its tolerance."""
    out = {}
    for name, w in want.items():
        tol = (STEPS * LR * 1.01 if name.endswith("attn.key.bias")
               else 1e-6 + 1e-2 * STEPS * LR)
        out[name] = float(np.abs(got[name].numpy() - w.numpy()).max()) / tol
    return out


def test_global_batch_loss_over_uneven_padding(tmp_path):
    jmod = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **_CFG))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                jnp.ones((1, 4), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    tokens = _tokens()
    torch.save(params_from_flax(params), tmp_path / "init.pt")
    torch.save(torch.from_numpy(tokens), tmp_path / "tokens.pt")
    # what the ranks count: the reference's shared denominator
    valid = (tokens[:, 1:] != -1).reshape(2, -1).sum(1)
    assert valid.tolist() == [30, 16]

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
             repr(LR), str(STEPS), repr(EPS)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    # the JAX reference runs while the workers do
    want_losses, want_params = _jax_reference(params, tokens)
    want = params_from_flax(jax.tree.map(np.asarray, want_params))

    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        finally:
            p.kill()
        assert p.returncode == 0, outs[-1]
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]

    for r, out in enumerate(res):
        np.testing.assert_allclose(out["losses"], want_losses, rtol=1e-5,
                                   err_msg=f"rank {r}")
        errs = _param_errors(out["params"], want)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1, (
            f"rank {r}: {worst} is {errs[worst]:.2f}x its tolerance")
    for k in res[0]["params"]:
        assert torch.equal(res[0]["params"][k], res[1]["params"][k]), k

    # the old step's readings on the same data miss both limits
    old_mean = np.mean([res[r]["old_losses"] for r in range(2)], axis=0)
    rel = np.abs(old_mean - want_losses) / np.abs(want_losses)
    assert rel[0] > 1e-5, rel
    old_errs = _param_errors(res[0]["old_params"], want)
    assert max(old_errs.values()) > 1, max(old_errs.values())
