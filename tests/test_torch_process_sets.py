"""The port's process sets against the JAX package's SPMD results.

A world of four ranks over gloo (one spawn, every scenario in it)
against the JAX package on a four-device mesh: port rank r holds what
JAX device r holds (``shard_map``, device r's slice = rank r's tensor).
The cases are those of ``tests/test_process_sets.py``: registration and
ids (``init(process_sets=...)`` too), the global set, duplicate and
out-of-range sets, removal, every collective on proper subsets,
non-members, a broadcast root outside the set; and what the port adds:
``add_process_set`` is collective and refuses ranks that asked for
different members, a removed set's collectives refuse, the
optimizer's, SyncBatchNorm's and the broadcasts' ``process_set``, and
the int8 wire's fallback over a subset.

Tolerances: sums of a few small integers and their averages are exact
in float32 and compared bitwise, scaled ones within 1e-6 relative;
SyncBatchNorm within 1e-5 relative + 1e-6 and the optimizer step within
1e-6 (float32, sums in another order). Non-members: the port returns
the allreduce family's and ``broadcast``'s input untouched (the JAX
SPMD form scales it by pre/postscale), SyncBatchNorm is local there
(JAX's ``lax.pmean`` divides the singleton group's sum by the set's
size), and the shape-changing collectives raise (ROADMAP queue C,
deliberate differences).
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
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.compat import shard_map

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 4
SETS = {"s3": [0, 2, 3], "s12": [1, 2], "s03": [0, 3]}

_WORKER = r'''
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.exceptions import (HorovodInternalError,
                                               ProcessSetError)

out = sys.argv[1]
hvd.init(device="cpu", process_sets=[hvd.ProcessSet([1, 3])])
r = hvd.rank()
res = {}


def raises(exc, fn):
    try:
        fn()
    except exc as e:
        return type(e).__name__ + ": " + str(e)
    return None


ps13 = hvd.get_process_set_by_id(1)
res["init_set"] = (ps13.process_set_id, ps13.ranks)
g = hvd.global_process_set()
res["global"] = (g.process_set_id, g.ranks)
a = hvd.add_process_set([0, 2])
res["registration"] = (a.process_set_id, a.size(), a.included(2),
                       a.included(1), a.rank(2),
                       hvd.get_process_set_by_id(a.process_set_id) is a)
hvd.remove_process_set(a)
res["removed_lookup"] = raises(ProcessSetError,
                               lambda: hvd.get_process_set_by_id(2))
res["readd_id"] = hvd.add_process_set([0, 2]).process_set_id
res["duplicate"] = raises(ProcessSetError,
                          lambda: hvd.add_process_set([3, 1]))
res["remove_global"] = raises(ProcessSetError,
                              lambda: hvd.remove_process_set(0))
res["out_of_range"] = raises(ProcessSetError,
                             lambda: hvd.add_process_set([0, 99]))
res["unknown_id"] = raises(ProcessSetError,
                           lambda: hvd.remove_process_set(42))
res["dup_ranks"] = raises(ProcessSetError, lambda: hvd.ProcessSet([1, 1]))
res["disagree"] = raises(ProcessSetError,
                         lambda: hvd.add_process_set([0, 1, 2 + r % 2]))
res["after_disagree_id"] = hvd.add_process_set([0, 1]).process_set_id
res["add_or_get"] = (hvd.add_or_get_process_set([3, 1]) is ps13,
                     hvd.add_or_get_process_set(range(4)) is g)

SETS = eval(sys.argv[2])
sets = {k: hvd.add_or_get_process_set(v) for k, v in SETS.items()}
x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 1 + 10 * r
keep = x.clone()
for op in ("Average", "Sum", "Min", "Max", "Product"):
    res["allreduce_" + op] = hvd.allreduce(
        x, op=getattr(hvd, op), prescale_factor=0.5, postscale_factor=3.0,
        process_set=sets["s3"])
    res["plain_" + op] = hvd.allreduce(x, op=getattr(hvd, op),
                                       process_set=sets["s3"])
res["input_untouched"] = bool(torch.equal(x, keep))
res["int_average"] = hvd.allreduce(torch.tensor([r + 1, 7]),
                                   process_set=sets["s3"])
res["async_sum"] = hvd.synchronize(hvd.allreduce_async(
    x, op=hvd.Sum, process_set=sets["s12"]))
inplace = x.clone()
hvd.allreduce_(inplace, op=hvd.Max, process_set=sets["s12"])
res["inplace_max"] = inplace
res["grouped_sum"] = hvd.grouped_allreduce(
    [x, x[0] * 2, torch.tensor([r, 2 * r])], op=hvd.Sum,
    process_set=sets["s3"])
res["grouped_avg"] = hvd.synchronize(hvd.grouped_allreduce_async(
    [x, x[1]], process_set=sets["s3"]))
if r in SETS["s3"]:
    res["allgather"] = hvd.allgather(x, process_set=sets["s3"])
    res["allgather_uneven"] = hvd.allgather(
        torch.full((r + 1, 2), float(r)), process_set=sets["s3"])
else:
    res["allgather_nonmember"] = raises(
        ProcessSetError, lambda: hvd.allgather(x, process_set=sets["s3"]))
res["broadcast"] = hvd.broadcast(x, root_rank=2, process_set=sets["s12"])
bin_ = x.clone()
hvd.synchronize(hvd.broadcast_async_(bin_, root_rank=1,
                                     process_set=sets["s12"]))
res["broadcast_async_"] = bin_
res["broadcast_bad_root"] = raises(
    HorovodInternalError,
    lambda: hvd.broadcast(x, root_rank=0, process_set=sets["s12"]))
rs_in = torch.arange(8, dtype=torch.float32).reshape(4, 2) + r
if r in SETS["s03"]:
    res["reducescatter_sum"] = hvd.reducescatter(rs_in, op=hvd.Sum,
                                                 process_set=sets["s03"])
    res["reducescatter_avg"] = hvd.reducescatter(rs_in,
                                                 process_set=sets["s03"])
else:
    res["reducescatter_nonmember"] = raises(
        ProcessSetError,
        lambda: hvd.reducescatter(rs_in, process_set=sets["s03"]))
hvd.barrier(process_set=sets["s3"])
res["barrier"] = True

# SyncBatchNorm over s3: forward, running statistics, input gradient
bx = torch.load(out + "/bn_x.pt")[r].requires_grad_(True)
bn = hvd.SyncBatchNorm(5, process_set=sets["s3"])
y = bn(bx)
(y * torch.load(out + "/bn_w.pt")).sum().backward()
res["bn"] = (y.detach(), bn.mean.clone(), bn.var.clone(), bx.grad.clone(),
             bn.scale.grad.clone())

# DistributedOptimizer over s3: one SGD step of a linear model
torch.manual_seed(0)
lin = torch.nn.Linear(3, 2)
opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1.0),
                               named_parameters=lin.named_parameters(),
                               process_set=sets["s3"])
lin(torch.ones(4, 3) * (r + 1)).square().sum().backward()
opt.step()
res["opt"] = {k: v.detach().clone() for k, v in lin.state_dict().items()}
int8_opt = hvd.DistributedOptimizer(
    torch.optim.SGD(lin.parameters(), lr=1.0),
    compression=hvd.Compression.int8, process_set=sets["s3"])
res["int8_subset_wire"] = int8_opt.wire
from horovod_tpu_torch.optim.compression import quantized_psum
res["quantized_subset"] = raises(
    ValueError, lambda: quantized_psum(torch.ones(8), 4,
                                       process_set=sets["s3"]))

# broadcasts of parameters and objects over s12, root 2
torch.manual_seed(100 + r)
lin2 = torch.nn.Linear(2, 2)
hvd.broadcast_parameters(lin2.state_dict(), root_rank=2,
                         process_set=sets["s12"])
res["bp"] = {k: v.clone() for k, v in lin2.state_dict().items()}
res["bobj"] = hvd.broadcast_object({"from": r}, root_rank=2,
                                   process_set=sets["s12"])

# a removed set refuses its collectives on every rank
s03 = sets["s03"]
hvd.remove_process_set(s03)
res["removed_use"] = raises(ProcessSetError,
                            lambda: hvd.allreduce(x, process_set=s03))
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(worker, n, *args, timeout=120):
    """Run ``worker`` as ``n`` ranks over gloo; raise with its output if
    one fails."""
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
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        finally:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("process_sets")
    rs = np.random.RandomState(3)
    torch.save(torch.from_numpy(rs.randn(N, 6, 5).astype(np.float32)),
               out / "bn_x.pt")
    torch.save(torch.from_numpy(rs.randn(6, 5).astype(np.float32)),
               out / "bn_w.pt")
    _spawn(_WORKER, N, out, repr(SETS))
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(N)]
    return res, torch.load(out / "bn_x.pt"), torch.load(out / "bn_w.pt")


def _jax():
    jhvd.init(mesh=Mesh(np.array(jax.devices()[:N]), ("hvd",)))
    return {k: jhvd.add_process_set(v) for k, v in SETS.items()}


def _spmd(body, *per_rank, out_spec=P("hvd")):
    """``body`` on device r's slices (the leading world axis dropped);
    returns the per-device results stacked."""
    mesh = jhvd.mesh()
    fn = shard_map(lambda *xs: jax.tree.map(lambda y: y[None],
                                            body(*[x[0] for x in xs])),
                   mesh=mesh, in_specs=tuple(P("hvd") for _ in per_rank),
                   out_specs=out_spec, check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(fn)(*per_rank))


def _x():
    return np.stack([np.arange(6, dtype=np.float32).reshape(2, 3) + 1
                     + 10 * r for r in range(N)])


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_registration_and_ids(world):
    res, _, _ = world
    for out in res:
        assert out["init_set"] == (1, [1, 3])
        assert out["global"] == (0, [0, 1, 2, 3])
        assert out["registration"] == (2, 2, True, False, 1, True)
        assert "no process set with id 2" in out["removed_lookup"]
        assert out["readd_id"] == 3  # ids are never reused, as in JAX
        assert out["add_or_get"] == (True, True)


@pytest.mark.parametrize("case,msg", [
    ("duplicate", "already exists"),
    ("remove_global", "cannot remove the global"),
    ("out_of_range", "out of range"),
    ("unknown_id", "no process set with id 42"),
    ("dup_ranks", "duplicate ranks")])
def test_validation_errors(world, case, msg):
    """Raised before any cross-rank traffic, with the JAX messages."""
    for out in world[0]:
        assert out[case] is not None and msg in out[case], out[case]


def test_add_process_set_must_be_called_on_every_rank(world):
    """Ranks that ask for different members all raise, and the table
    stays consistent: the next registration gets the next id
    everywhere."""
    res = world[0]
    for out in res:
        assert "every rank with the same ranks" in out["disagree"]
    assert {out["after_disagree_id"] for out in res} == {4}


@pytest.mark.parametrize("op", ["Average", "Sum", "Min", "Max", "Product"])
def test_allreduce_subset(world, op):
    """Members hold the JAX SPMD result (numpy's for Product); the
    non-member keeps its input (JAX scales it by pre/postscale there: a
    deliberate difference)."""
    res = world[0]
    sets = _jax()
    x = jnp.asarray(_x())
    if op == "Product":
        # the JAX SPMD form gathers over unequal replica groups, which
        # XLA does not lower; numpy is the reference
        xs = _x()
        prod = np.prod(xs[SETS["s3"]], axis=0)
        want = {r: np.prod(0.5 * xs[SETS["s3"]], axis=0) * 3
                for r in SETS["s3"]}
        plain = {r: prod if r in SETS["s3"] else xs[r] for r in range(N)}
    else:
        want = _spmd(lambda t: jhvd.allreduce(
            t, op=getattr(jhvd, op), prescale_factor=0.5,
            postscale_factor=3.0, process_set=sets["s3"]), x)
        plain = _spmd(lambda t: jhvd.allreduce(
            t, op=getattr(jhvd, op), process_set=sets["s3"]), x)
    for r, out in enumerate(res):
        if r in SETS["s3"]:
            np.testing.assert_allclose(out["allreduce_" + op].numpy(),
                                       want[r], rtol=1e-6)
        else:
            _eq(out["allreduce_" + op], _x()[r])
        # without scaling, every rank (non-members too) is JAX's
        _eq(out["plain_" + op], plain[r])
        assert out["input_untouched"]


def test_integer_average_and_async_inplace(world):
    res = world[0]
    sets = _jax()
    ints = jnp.asarray(np.array([[r + 1, 7] for r in range(N)]))
    want = _spmd(lambda t: jhvd.allreduce(t, process_set=sets["s3"]), ints)
    x = jnp.asarray(_x())
    asum = _spmd(lambda t: jhvd.allreduce(t, op=jhvd.Sum,
                                          process_set=sets["s12"]), x)
    amax = _spmd(lambda t: jhvd.allreduce(t, op=jhvd.Max,
                                          process_set=sets["s12"]), x)
    for r, out in enumerate(res):
        _eq(out["int_average"], want[r])
        _eq(out["async_sum"], asum[r])
        _eq(out["inplace_max"], amax[r])


def test_grouped_allreduce_subset(world):
    res = world[0]
    sets = _jax()
    x = jnp.asarray(_x())
    ints = jnp.asarray(np.array([[r, 2 * r] for r in range(N)]))
    gsum = _spmd(lambda t, i: jhvd.grouped_allreduce(
        [t, t[0] * 2, i], op=jhvd.Sum, process_set=sets["s3"]), x, ints)
    gavg = _spmd(lambda t: jhvd.grouped_allreduce(
        [t, t[1]], process_set=sets["s3"]), x)
    for r, out in enumerate(res):
        if r not in SETS["s3"]:
            _eq(out["grouped_sum"][0], _x()[r])
            continue
        for got, want in zip(out["grouped_sum"], gsum):
            _eq(got, want[r])
        assert out["grouped_sum"][2].dtype == torch.int64
        for got, want in zip(out["grouped_avg"], gavg):
            np.testing.assert_allclose(got.numpy(), want[r], rtol=1e-6)


def test_allgather_subset(world):
    res = world[0]
    sets = _jax()
    want = _spmd(lambda t: jhvd.allgather(t, process_set=sets["s3"]),
                 jnp.asarray(_x()))
    for r, out in enumerate(res):
        if r in SETS["s3"]:
            _eq(out["allgather"], want[r])
            _eq(out["allgather_uneven"], np.concatenate(
                [np.full((m + 1, 2), float(m), np.float32)
                 for m in SETS["s3"]]))
        else:
            assert "not a member" in out["allgather_nonmember"]


def test_broadcast_subset_preserves_nonmembers(world):
    """Root 2 of {1, 2}; every rank is JAX's (non-members keep their
    input); a root outside the set raises on every rank."""
    res = world[0]
    sets = _jax()
    x = jnp.asarray(_x())
    want = _spmd(lambda t: jhvd.broadcast(t, root_rank=2,
                                          process_set=sets["s12"]), x)
    want1 = _spmd(lambda t: jhvd.broadcast(t, root_rank=1,
                                           process_set=sets["s12"]), x)
    with pytest.raises(jhvd.HorovodInternalError):
        _spmd(lambda t: jhvd.broadcast(t, root_rank=0,
                                       process_set=sets["s12"]), x)
    for r, out in enumerate(res):
        _eq(out["broadcast"], want[r])
        _eq(out["broadcast_async_"], want1[r])
        assert "not in process set [1, 2]" in out["broadcast_bad_root"]


def test_reducescatter_subset(world):
    res = world[0]
    sets = _jax()
    x = jnp.asarray(np.stack([np.arange(8, dtype=np.float32).reshape(4, 2)
                              + r for r in range(N)]))
    wsum = _spmd(lambda t: jhvd.reducescatter(t, op=jhvd.Sum,
                                              process_set=sets["s03"]), x)
    wavg = _spmd(lambda t: jhvd.reducescatter(t, process_set=sets["s03"]),
                 x)
    for r, out in enumerate(res):
        if r in SETS["s03"]:
            _eq(out["reducescatter_sum"], wsum[r])
            _eq(out["reducescatter_avg"], wavg[r])
        else:
            assert "not a member" in out["reducescatter_nonmember"]
        assert out["barrier"]


def test_sync_batch_norm_over_a_set(world):
    """Statistics and their gradients averaged over {0, 2, 3}; rank 1,
    outside the set, normalizes with its own (a singleton group in the
    JAX module)."""
    res, bx, bw = world
    sets = _jax()
    jm = jhvd.SyncBatchNorm(use_running_average=False,
                            process_set=sets["s3"])
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(bx[0].numpy()))

    def body(x, w):
        def f(x, params):
            y, upd = jm.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              x, mutable=["batch_stats"])
            return (y * w).sum(), (y, upd)
        (_, (y, upd)), (gx, gp) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(x, variables["params"])
        return (y, upd["batch_stats"]["mean"], upd["batch_stats"]["var"],
                gx, gp["scale"])

    w = jnp.broadcast_to(jnp.asarray(bw.numpy()), (N, 6, 5))
    want = _spmd(body, jnp.asarray(bx.numpy()), w)
    for r, out in enumerate(res):
        if r in SETS["s3"]:
            exps = [e[r] for e in want]
        else:
            # JAX's lax.pmean divides the singleton group's sum by the
            # set's size; the module outside shard_map is local BatchNorm
            exps = body(jnp.asarray(bx[r].numpy()), w[r])
        for got, exp in zip(out["bn"], exps):
            np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                       rtol=1e-5, atol=1e-6)


def test_distributed_optimizer_over_a_set(world):
    """Average over {0, 2, 3} as JAX's DistributedOptimizer(sgd,
    process_set) in shard_map; the non-member steps on its own gradient
    (JAX's SPMD form divides it by the set's size: a deliberate
    difference); the int8 wire falls back to uncompressed over a proper
    subset, and quantized_psum refuses one."""
    res = world[0]
    sets = _jax()
    torch.manual_seed(0)
    lin = torch.nn.Linear(3, 2)
    init = {k: v.detach().numpy() for k, v in lin.state_dict().items()}
    params = {"w": jnp.asarray(init["weight"]), "b": jnp.asarray(
        init["bias"])}
    opt = jhvd.DistributedOptimizer(optax.sgd(1.0), process_set=sets["s3"])
    state = opt.init(params)

    def body(scale):
        def loss(p):
            y = (jnp.ones((4, 3)) * scale) @ p["w"].T + p["b"]
            return (y * y).sum()
        g = jax.grad(loss)(params)
        upd, _ = opt.update(g, state, params)
        return optax.apply_updates(params, upd)

    want = _spmd(body, jnp.arange(1.0, N + 1).reshape(N, 1))
    for r, out in enumerate(res):
        got = out["opt"]
        if r in SETS["s3"]:
            np.testing.assert_allclose(got["weight"].numpy(), want["w"][r],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got["bias"].numpy(), want["b"][r],
                                       rtol=1e-6, atol=1e-6)
        else:
            local = torch.nn.Linear(3, 2)
            local.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in init.items()})
            lopt = torch.optim.SGD(local.parameters(), lr=1.0)
            local(torch.ones(4, 3) * (r + 1)).square().sum().backward()
            lopt.step()
            for k, v in local.state_dict().items():
                _eq(got[k], v.detach().numpy())
        assert out["int8_subset_wire"] is None
        assert "whole world" in out["quantized_subset"]


def test_broadcasts_over_a_set(world):
    res = world[0]
    for r, out in enumerate(res):
        if r in SETS["s12"]:
            for k in out["bp"]:
                assert torch.equal(out["bp"][k], res[2]["bp"][k])
            assert out["bobj"] == {"from": 2}
        else:
            assert out["bobj"] == {"from": r}
    assert not torch.equal(res[0]["bp"]["weight"], res[2]["bp"]["weight"])


def test_removed_set_refuses(world):
    for out in world[0]:
        assert "not registered" in out["removed_use"]
