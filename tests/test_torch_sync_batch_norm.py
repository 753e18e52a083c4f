"""The port's SyncBatchNorm against the JAX package's.

* At world 2 (two worker processes joined over gloo) against the JAX
  ``SyncBatchNorm`` under ``shard_map`` on a two-device mesh, the two
  halves of the batch with very different statistics: the output, the
  running statistics (on both ranks) and dx for one numpy cotangent,
  within 1e-5 of the largest value (float32); dx also against the
  gradient of BatchNorm over the whole global batch, which shows the
  backward averages the statistics' gradients over the world.
* In a world of one, and before ``init()``, it is local BatchNorm, as
  the JAX module outside ``shard_map``; eval uses the running
  statistics; a process set other than the global one raises.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.compat import shard_map

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    yield
    hvd.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(code, out_dir, timeout=180):
    """Run ``code`` as ranks 0 and 1 of a gloo world (the launcher's slot
    environment on a free port)."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(out_dir)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        try:
            out = p.communicate(timeout=timeout)[0]
        finally:
            p.kill()
        assert p.returncode == 0, out


# ---------------------------------------------------------------------------

_SBN_WORKER = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
d = np.load(out + "/sbn.npz")
m = hvd.SyncBatchNorm(16)
with torch.no_grad():
    m.scale.copy_(torch.from_numpy(d["scale"]))
    m.bias.copy_(torch.from_numpy(d["bias"]))
x = torch.from_numpy(d["x"][4 * r:4 * r + 4]).requires_grad_()
y = m(x)
y.backward(torch.from_numpy(d["dy"][4 * r:4 * r + 4]))
torch.save({"y": y.detach(), "dx": x.grad, "mean": m.mean, "var": m.var,
            "dscale": m.scale.grad}, out + "/sbn%d.pt" % r)
hvd.shutdown()
'''


def _sbn_inputs():
    rng = np.random.RandomState(0)
    # the two ranks' halves have very different statistics
    x = (rng.randn(8, 3, 3, 16) + np.repeat([0.0, 4.0], 4)[:, None, None,
                                                           None])
    return dict(x=x.astype(np.float32),
                dy=rng.randn(8, 3, 3, 16).astype(np.float32),
                scale=rng.uniform(0.5, 1.5, 16).astype(np.float32),
                bias=rng.randn(16).astype(np.float32))


def test_sync_batch_norm_world_of_two_matches_jax(tmp_path):
    d = _sbn_inputs()
    np.savez(tmp_path / "sbn.npz", **d)
    _run_world(_SBN_WORKER, tmp_path)
    res = [torch.load(tmp_path / f"sbn{r}.pt") for r in range(2)]

    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    jhvd.init(mesh=mesh)
    model = jhvd.SyncBatchNorm(use_running_average=False)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(d["x"][:4]))
    params = {"scale": jnp.asarray(d["scale"]),
              "bias": jnp.asarray(d["bias"])}

    def fwd(x):
        y, upd = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             x, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    sharded = shard_map(fwd, mesh=mesh, in_specs=P("hvd"),
                        out_specs=(P("hvd"), P()), check_vma=False)
    y, stats = jax.jit(sharded)(jnp.asarray(d["x"]))
    dx = jax.jit(jax.grad(lambda x: jnp.sum(sharded(x)[0]
                                            * jnp.asarray(d["dy"]))))(
        jnp.asarray(d["x"]))

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=what)

    close(torch.cat([res[0]["y"], res[1]["y"]]).numpy(), y, "y")
    close(torch.cat([res[0]["dx"], res[1]["dx"]]).numpy(), dx, "dx")
    for r in range(2):
        close(res[r]["mean"].numpy(), stats["mean"], f"rank {r} mean")
        close(res[r]["var"].numpy(), stats["var"], f"rank {r} var")
    # dx is the gradient of BatchNorm over the whole global batch
    xg = torch.from_numpy(d["x"]).requires_grad_()
    mean = xg.mean((0, 1, 2))
    var = (xg * xg).mean((0, 1, 2)) - mean * mean
    yg = (xg - mean) * (torch.rsqrt(var + 1e-5) * torch.from_numpy(
        d["scale"])) + torch.from_numpy(d["bias"])
    yg.backward(torch.from_numpy(d["dy"]))
    close(torch.cat([res[0]["dx"], res[1]["dx"]]).numpy(), xg.grad.numpy(),
          "dx vs global BatchNorm")


def test_sync_batch_norm_world_of_one_is_local_batch_norm():
    """Before init() and in a world of one it is plain local BatchNorm,
    as the JAX module outside shard_map."""
    d = _sbn_inputs()
    jm = jhvd.SyncBatchNorm(use_running_average=False)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(d["x"]))
    want, upd = jm.apply(variables, jnp.asarray(d["x"]),
                         mutable=["batch_stats"])
    for initialized in (False, True):
        if initialized:
            hvd.init(device="cpu")
        m = hvd.SyncBatchNorm(16)
        got = m(torch.from_numpy(d["x"]))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(m.var.numpy(),
                                   np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-6, atol=1e-6)
    m.eval()
    before = m.mean.clone()
    m(torch.from_numpy(d["x"]))
    assert torch.equal(m.mean, before)
    # a set of every rank is the global set: local BatchNorm in a world
    # of one
    ms = hvd.SyncBatchNorm(16, process_set=hvd.ProcessSet([0]))
    np.testing.assert_allclose(ms(torch.from_numpy(d["x"])).detach().numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
