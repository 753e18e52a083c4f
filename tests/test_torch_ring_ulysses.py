"""The port's ring attention, Ulysses and ``padded_alltoall`` against the
JAX package's, in a world of four.

Four worker processes over gloo (the launcher's slot environment) each
take their sequence span of the same numpy q, k, v (``[B, T, H, D]``
from seed 0) and run ``parallel.ring_attention`` / ``ulysses_attention``
over the world's communicator (``Mesh.comm("sp")`` on an ``sp=4``
mesh); the JAX package runs its own in ``shard_map`` over four of the
conftest's CPU devices (``tests/test_parallel.py``'s cases). float32
throughout:

* outputs within the JAX tests' tolerance of the JAX package's (rtol
  2e-4, atol 2e-5): ring causal and not, ring with GQA (2 kv heads of
  4), Ulysses causal and not, Ulysses with kv heads indivisible by sp
  (8 query heads, 2 kv heads at sp = 4: the kv heads repeated first);
* the gradients of q, k, v (each rank's span of them, the loss the sum
  of the output times a fixed random cotangent) within 1e-4 relative
  (max abs over max abs) of plain attention's autograd on the whole
  sequence: the ring's dK/dV come home over the ring, Ulysses' through
  the inverse all-to-all;
* ``padded_alltoall``: every peer's rows and splits, exactly, as the JAX
  test holds them.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.models.transformer import dot_product_attention as jdpa
from horovod_tpu.parallel import padded_alltoall as jpadded
from horovod_tpu.parallel import ring_attention as jring
from horovod_tpu.parallel import ulysses_attention as julysses

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 4
B, T, D = 2, 32, 8
#: (name, query heads, kv heads, kind, causal)
CASES = [("ring_causal", 4, 4, "ring", True),
         ("ring_full", 4, 4, "ring", False),
         ("ring_gqa", 4, 2, "ring", True),
         ("ulysses_causal", 4, 4, "ulysses", True),
         ("ulysses_full", 4, 4, "ulysses", False),
         ("ulysses_kv_indivisible", 8, 2, "ulysses", True)]

_WORKER = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.transformer import dot_product_attention
from horovod_tpu_torch.parallel import (make_mesh, padded_alltoall,
                                        ring_attention, ulysses_attention)

out = sys.argv[1]
cases = eval(sys.argv[2])
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
mesh = make_mesh(sp=n)
comm = mesh.comm("sp")
data = np.load(out + "/data.npz")
res = {}
for name, h, kh, kind, causal in cases:
    q, k, v, g = (torch.from_numpy(data[f"{name}_{x}"]) for x in "qkvg")
    t = q.shape[1] // n
    span = slice(r * t, (r + 1) * t)
    ql, kl, vl = (x[:, span].clone().requires_grad_() for x in (q, k, v))
    fn = ring_attention if kind == "ring" else ulysses_attention
    o = fn(ql, kl, vl, comm=comm, causal=causal)
    (o * g[:, span]).sum().backward()
    res[name] = {"o": o.detach(), "dq": ql.grad, "dk": kl.grad,
                 "dv": vl.grad}
# every rank sends j rows to peer j (row value 100 * src + dst)
rows = sum(range(n))
x = torch.zeros(rows, 1)
off = 0
for dst in range(n):
    x[off:off + dst] = 100 * r + dst
    off += dst
got, splits = padded_alltoall(x, torch.arange(n), n, comm=comm)
res["padded"] = {"out": got, "splits": splits}
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _data():
    rng = np.random.RandomState(0)
    out = {}
    for name, h, kh, _, _ in CASES:
        for x, heads in (("q", h), ("k", kh), ("v", kh), ("g", h)):
            out[f"{name}_{x}"] = rng.randn(B, T, heads, D).astype(
                np.float32)
    return out


def _jax_outputs(data):
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("sp",))
    spec = P(None, "sp", None, None)
    out = {}
    for name, _, _, kind, causal in CASES:
        fn = jring if kind == "ring" else julysses
        q, k, v = (jnp.asarray(data[f"{name}_{x}"]) for x in "qkv")
        out[name] = np.asarray(jax.jit(shard_map(
            lambda a, b, c, fn=fn, causal=causal: fn(a, b, c,
                                                     causal=causal),
            mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False))(q, k, v))
    return out


def _plain_grads(data, name, causal):
    """q, k, v gradients of plain attention on the whole sequence."""
    from horovod_tpu_torch.models.transformer import dot_product_attention

    q, k, v = (torch.from_numpy(data[f"{name}_{x}"]).requires_grad_()
               for x in "qkv")
    o = dot_product_attention(q, k, v, causal=causal)
    (o * torch.from_numpy(data[f"{name}_g"])).sum().backward()
    return {"dq": q.grad, "dk": k.grad, "dv": v.grad}


def _run_world(tmp_path):
    data = _data()
    np.savez(tmp_path / "data.npz", **data)
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
            [sys.executable, "-c", _WORKER, str(tmp_path), repr(CASES)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    want = _jax_outputs(data)
    for p in procs:
        try:
            out = p.communicate(timeout=120)[0]
        finally:
            p.kill()
        assert p.returncode == 0, out
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(N)]
    return data, want, res


def test_ring_ulysses_and_padded_alltoall_match_jax(tmp_path):
    data, want, res = _run_world(tmp_path)
    for name, _, _, kind, causal in CASES:
        got = torch.cat([res[r][name]["o"] for r in range(N)], dim=1)
        np.testing.assert_allclose(got.numpy(), want[name], rtol=2e-4,
                                   atol=2e-5, err_msg=name)
        plain = _plain_grads(data, name, causal)
        for g in ("dq", "dk", "dv"):
            mine = torch.cat([res[r][name][g] for r in range(N)], dim=1)
            err = (mine - plain[g]).abs().max() / plain[g].abs().max()
            assert err <= 1e-4, (name, g, float(err))

    # the JAX test's padded_alltoall, at four peers
    def body(x):
        out, rsplits = jpadded(x[0], jnp.arange(N, dtype=jnp.int32),
                               max_split=N, axis_name="sp")
        return out[None], rsplits[None]

    x = np.zeros((N, sum(range(N)), 1), np.float32)
    for src in range(N):
        off = 0
        for dst in range(N):
            x[src, off:off + dst] = 100 * src + dst
            off += dst
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("sp",))
    jout, jsplits = jax.jit(shard_map(
        body, mesh=mesh, in_specs=P("sp"), out_specs=(P("sp"), P("sp")),
        check_vma=False))(jnp.asarray(x))
    for dst in range(N):
        np.testing.assert_array_equal(res[dst]["padded"]["splits"].numpy(),
                                      np.asarray(jsplits)[dst])
        np.testing.assert_array_equal(
            res[dst]["padded"]["out"].numpy().reshape(N, N),
            np.asarray(jout)[dst].reshape(N, N))
        rows = res[dst]["padded"]["out"].reshape(N, N)
        for src in range(N):
            assert (rows[src, :dst] == 100 * src + dst).all()
            assert (rows[src, dst:] == 0).all()


def test_ring_and_ulysses_alone_are_local_attention():
    """A ring of one and Ulysses over one rank are plain attention (the
    flash block's closed form against the softmax), which is the JAX
    package's."""
    from horovod_tpu_torch.models.transformer import dot_product_attention
    from horovod_tpu_torch.parallel import ring_attention, ulysses_attention
    from horovod_tpu_torch.parallel.comm import SelfComm

    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 4, 8).astype(np.float32))
               for _ in range(3))
    for causal in (True, False):
        want = dot_product_attention(q, k, v, causal=causal)
        for fn in (ring_attention, ulysses_attention):
            got = fn(q, k, v, comm=SelfComm(), causal=causal)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # jdpa is the JAX package's: the same function
    np.testing.assert_allclose(
        np.asarray(jdpa(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                        jnp.asarray(v.numpy()), causal=True)),
        dot_product_attention(q, k, v, causal=True).numpy(), rtol=1e-5,
        atol=1e-6)
