"""The port's ``models/moe.MoeMlp`` against the JAX package's.

The same flax weights (``models/convert.moe_from_flax``) and numpy
tokens, float32, go through both:

* the dense path: output and aux loss, and ``jax.grad`` of a weighted
  sum of the output (the input's and every parameter's gradient);
* the expert-parallel path over ep = 4: JAX's ``shard_map`` over four
  of the conftest's CPU devices, the port's four ranks a gloo world of
  four processes, each rank its quarter of the tokens, at an ample
  capacity (``capacity_factor`` 8: nothing drops, the dense output) and
  at one that drops (0.5: at least a quarter of the (token, k) pairs),
  outputs and input gradients; the ranks' parameter gradients summed
  against the dense path's at the ample capacity;
* a top-k tie, which goes to the lower expert as in ``lax.top_k``;
* the same EP steps on four ranks emulated in this process
  (``parallel/comm.ThreadWorld``): bitwise the gloo world's.

Tolerances: outputs, aux and gradients within rtol 1e-5, atol 1e-6
(float32; the frameworks sum the einsums in other orders).
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
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.models import MoeMlp as JMoeMlp

from horovod_tpu_torch.models import MoeMlp
from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.models.convert import moe_from_flax
from horovod_tpu_torch.parallel import comm as pc

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 4
TOL = dict(rtol=1e-5, atol=1e-6)
H, MLP, E, K, T = 8, 16, 4, 2, 32
#: capacity factors: ample (nothing drops) and dropping
CAPACITIES = (8.0, 0.5)

_RUN = r'''
import torch
from horovod_tpu_torch.models import MoeMlp
from horovod_tpu_torch.models.convert import moe_from_flax


def run(comm, params, x, cot, cf, h, mlp, e, k):
    layer = MoeMlp(h, mlp, num_experts=e, top_k=k, capacity_factor=cf,
                   dtype=torch.float32, ep=comm)
    layer.load_state_dict(moe_from_flax(params))
    n = x.shape[0] // comm.size
    xr = x[comm.rank * n:(comm.rank + 1) * n].clone().requires_grad_()
    y, aux = layer(xr)
    (y * cot[comm.rank * n:(comm.rank + 1) * n]).sum().backward()
    return {"y": y.detach(), "aux": aux.detach(), "dx": xr.grad,
            "grads": {n: p.grad.clone() for n, p in
                      layer.named_parameters()}}
'''

_WORKER = _RUN + r'''
import sys
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel.comm import GroupComm

hvd.init(device="cpu")
d = torch.load(sys.argv[1] + "/data.pt", weights_only=False)
res = {cf: run(GroupComm(), d["params"], d["x"], d["cot"], cf, *d["dims"])
       for cf in d["capacities"]}
torch.save(res, sys.argv[1] + "/rank%d.pt" % hvd.rank())
hvd.shutdown()
'''


def _inputs():
    r = np.random.RandomState(1)
    x = r.rand(T, H).astype(np.float32)
    cot = r.randn(T, H).astype(np.float32)
    layer = JMoeMlp(hidden_size=H, mlp_dim=MLP, num_experts=E, top_k=K,
                    dtype=jnp.float32)
    params = jax.tree.map(np.asarray, layer.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    return x, cot, params


def _jax_ep(params, x, cot, cf):
    """JAX's EP path in ``shard_map`` over four devices: the output and
    the input's gradient of ``Σ y · cot``."""
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("ep",))
    layer = JMoeMlp(hidden_size=H, mlp_dim=MLP, num_experts=E, top_k=K,
                    capacity_factor=cf, dtype=jnp.float32)
    fwd = shard_map(lambda p, xs: layer.apply({"params": p}, xs)[0],
                    mesh=mesh, in_specs=(P(), P("ep")), out_specs=P("ep"),
                    check_vma=False)
    with mesh:
        y = jax.jit(fwd)(params, x)
        dx = jax.jit(jax.grad(lambda xs: jnp.sum(fwd(params, xs) * cot)))(x)
    return np.asarray(y), np.asarray(dx)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    x, cot, params = _inputs()
    torch.save({"params": params, "x": torch.from_numpy(x),
                "cot": torch.from_numpy(cot), "capacities": CAPACITIES,
                "dims": (H, MLP, E, K)}, tmp / "data.pt")
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
            [sys.executable, "-c", _WORKER, str(tmp)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        jax_ep = {cf: _jax_ep(params, x, cot, cf) for cf in CAPACITIES}
    finally:
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            finally:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(N)]
    return {"x": x, "cot": cot, "params": params, "jax_ep": jax_ep,
            "ranks": ranks}


def _port_dense(params, x, cot=None, dtype=torch.float32):
    layer = MoeMlp(H, MLP, num_experts=E, top_k=K, dtype=dtype)
    layer.load_state_dict(moe_from_flax(params))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = layer(xt)
    if cot is not None:
        (y * torch.from_numpy(cot)).sum().backward()
    return layer, xt, y, aux


def test_dense_matches_jax():
    """The dense path's output (a gated mix of the experts: its shape,
    a finite non-negative aux) and aux loss against JAX's."""
    x, _, params = _inputs()
    layer = JMoeMlp(hidden_size=H, mlp_dim=MLP, num_experts=E, top_k=K,
                    dtype=jnp.float32)
    jy, jaux = layer.apply({"params": params}, jnp.asarray(x))
    _, _, y, aux = _port_dense(params, x)
    assert y.shape == x.shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    assert np.isfinite(float(aux)) and float(aux) >= 0


def test_dense_gradients_match_jax_grad():
    x, cot, params = _inputs()
    layer = JMoeMlp(hidden_size=H, mlp_dim=MLP, num_experts=E, top_k=K,
                    dtype=jnp.float32)

    def f(p, xs):
        y, aux = layer.apply({"params": p}, xs)
        return jnp.sum(y * cot) + aux

    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    mod, xt, y, aux = _port_dense(params, x)
    ((y * torch.from_numpy(cot)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    want = moe_from_flax(jax.tree.map(np.asarray, gp))
    for n, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("cf", CAPACITIES)
def test_expert_parallel_matches_jax(world, cf):
    """Each rank's output and input gradient against JAX's ``shard_map``
    path over ep = 4; at the dropping capacity some (token, k) pairs
    must drop."""
    jy, jdx = world["jax_ep"][cf]
    n = T // N
    for r in range(N):
        got = world["ranks"][r][cf]
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(got["y"].numpy(), jy[rows], **TOL)
        np.testing.assert_allclose(got["dx"].numpy(), jdx[rows], **TOL)
    layer = MoeMlp(H, MLP, num_experts=E, top_k=K, capacity_factor=cf,
                   dtype=torch.float32)
    layer.load_state_dict(moe_from_flax(world["params"]))
    dropped = 0
    for r in range(N):
        xr = torch.from_numpy(world["x"][r * n:(r + 1) * n])
        _, idx, _, _ = layer.route(xr)
        _, keep = tmoe.bucket_positions(idx.reshape(-1), E,
                                        layer.capacity(n))
        dropped += int((~keep).sum())
    assert (dropped >= T * K // 4) == (cf < 1), (cf, dropped)


def test_expert_parallel_at_ample_capacity_is_the_dense_path(world):
    """Nothing drops: the ranks' outputs and input gradients are the
    dense path's rows, and their parameter gradients sum to the dense
    path's (each rank's expert slice, the router's over its tokens)."""
    layer, xt, y, _ = _port_dense(world["params"], world["x"],
                                  world["cot"])
    n = T // N
    ranks = [world["ranks"][r][8.0] for r in range(N)]
    np.testing.assert_allclose(torch.cat([g["y"] for g in ranks]).numpy(),
                               y.detach().numpy(), **TOL)
    np.testing.assert_allclose(torch.cat([g["dx"] for g in ranks]).numpy(),
                               xt.grad.numpy(), **TOL)
    for name, p in layer.named_parameters():
        total = sum(g["grads"][name] for g in ranks)
        np.testing.assert_allclose(total.numpy(), p.grad.numpy(),
                                   err_msg=name, rtol=1e-5, atol=1e-6)
    for r, g in enumerate(ranks):  # a rank trains only its experts
        lo = r * (E // N)
        other = torch.ones(E, dtype=torch.bool)
        other[lo:lo + E // N] = False
        assert not g["grads"]["w_in"][other].any()
        assert not g["grads"]["w_out"][other].any()
    assert n * N == T


def test_emulated_world_is_bitwise_the_gloo_world(world):
    ns = {}
    exec(_RUN, ns)
    for cf in CAPACITIES:
        tw = pc.ThreadWorld(N, timeout=60.0)
        got = pc.run_ranks([tw], lambda r: ns["run"](
            pc.ThreadComm(tw, r), world["params"],
            torch.from_numpy(world["x"]), torch.from_numpy(world["cot"]), cf,
            H, MLP, E, K), N)
        for r in range(N):
            want = world["ranks"][r][cf]
            for key in ("y", "aux", "dx"):
                assert torch.equal(got[r][key], want[key]), (cf, r, key)
            for k, v in want["grads"].items():
                assert torch.equal(got[r]["grads"][k], v), (cf, r, k)


def test_top_k_ties_go_to_the_lower_expert():
    """``lax.top_k`` breaks a tie toward the lower index; the port's
    ``top_k`` (a stable descending sort) does too: uniform routing picks
    experts 0 and 1, and a tie between experts 1 and 2 picks 1 first."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.2, 0.4, 0.0]], dtype=np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    v, i = tmoe.top_k(torch.from_numpy(probs), 2)
    assert i.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 2], [0, 2]]
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    x, _, params = _inputs()
    params = jax.tree.map(np.zeros_like, params["router"])
    params = dict(_inputs()[2], router=params)
    layer = JMoeMlp(hidden_size=H, mlp_dim=MLP, num_experts=E, top_k=K,
                    dtype=jnp.float32)
    jy, _ = layer.apply({"params": params}, jnp.asarray(x))
    mod, _, y, _ = _port_dense(params, x)
    assert mod.route(torch.from_numpy(x))[1].tolist() == [[0, 1]] * T
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)


def test_init_is_flax_lecun_normal():
    """``init_params``: truncated normals at two standard deviations of
    variance 1 / fan_in, the fans of the 3-D kernels reckoned as flax's
    (``[e, h, 2m]``: fan_in h·e), and a zero router bias."""
    big = MoeMlp(64, 128, num_experts=8, dtype=torch.float32).init_params(
        torch.Generator().manual_seed(0))
    for p, fan_in in ((big.router.kernel, 64), (big.w_in, 64 * 8),
                      (big.w_out, 128 * 8)):
        std = (1.0 / fan_in) ** 0.5
        assert float(p.abs().max()) <= 2 * std / tmoe._TRUNC_STD + 1e-7
        assert abs(float(p.std()) / std - 1) < 0.05, (p.shape, p.std())
    assert not big.router.bias.any()
