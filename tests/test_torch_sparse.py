"""The port's sparse (IndexedSlices) allreduce against the JAX package.

The cases of ``tests/test_sparse.py``: a world of four ranks over gloo
(one spawn) against the JAX package's SPMD ``sparse_allreduce`` on a
four-device mesh (port rank r holds device r's slices): densified
sparse average equals the dense average; ``allreduce`` routes
IndexedSlices (and torch sparse COO tensors) to the sparse path; Sum
keeps duplicate indices; a grouped allreduce of sparse and dense
members; the DistributedOptimizer's sparse embedding gradients; a set
of two ranks. In one process: the dense/sparse round trip against
JAX's ``dense_to_sparse``, Min/Max and Adasum refused, and the async
routing (``allreduce_async`` takes the sparse path; the collectives
without sparse semantics refuse).

Gathered values and indices are compared bitwise (they are moved, and
Average divides by 4); densified sums within 1e-6 (float32, duplicates
added in another order).
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
from horovod_tpu.ops import sparse as jsparse
from horovod_tpu_torch.ops.sparse import (IndexedSlices, dense_to_sparse,
                                          sparse_allreduce, sparse_to_dense)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 4
V, D = 16, 4  # vocab x embedding dim


def _embedding_grads(rank, nnz=3):
    """Rank-distinct embedding gradient: nnz rows touched (the JAX
    test's construction)."""
    r = np.random.RandomState(100 + rank)
    ids = r.choice(V, size=nnz, replace=False).astype(np.int32)
    vals = r.randn(nnz, D).astype(np.float32)
    dense = np.zeros((V, D), np.float32)
    dense[ids] = vals
    return ids, vals, dense


_WORKER = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops.sparse import (IndexedSlices, sparse_allreduce,
                                          sparse_to_dense)

out, V, D = sys.argv[1], 16, 4
hvd.init(device="cpu")
r = hvd.rank()
data = np.load(out + "/data.npz")
ids = torch.from_numpy(data["ids"][r])
vals = torch.from_numpy(data["vals"][r])
sl = IndexedSlices(vals, ids, (V, D))
res = {}
red = sparse_allreduce(sl, op=hvd.Average)
res["avg"] = (red.values, red.indices, red.dense_shape)
routed = hvd.allreduce(sl, op=hvd.Average)
res["routed_type"] = type(routed).__name__
res["routed"] = sparse_to_dense(routed)
s = sparse_allreduce(sl, op=hvd.Sum)
res["sum"] = (s.values, s.indices)
res["async"] = sparse_to_dense(hvd.synchronize(hvd.allreduce_async(
    sl, op=hvd.Sum)))
g = hvd.grouped_allreduce([torch.ones(4) * r, sl, torch.full((2,), 2.0)],
                          op=hvd.Average)
res["grouped"] = (g[0], type(g[1]).__name__, sparse_to_dense(g[1]),
                  g[1].dense_shape, g[2])
coo = torch.sparse_coo_tensor(ids.long()[None], vals, size=(V, D))
cred = hvd.sparse_allreduce(coo)
res["coo"] = (cred.is_sparse, cred.coalesce().to_dense())
res["coo_routed"] = hvd.allreduce(coo, op=hvd.Sum).coalesce().to_dense()
ps = hvd.add_process_set([1, 3])
if r in (1, 3):
    sub = sparse_allreduce(sl, process_set=ps)
    res["set"] = (sub.values, sub.indices)

# DistributedOptimizer: sparse embedding gradients beside a dense leaf
torch.manual_seed(0)
emb = torch.nn.Embedding(V, D, sparse=True)
lin = torch.nn.Linear(D, 1)
params = list(emb.named_parameters(prefix="emb")) + \
    list(lin.named_parameters(prefix="lin"))
opt = hvd.DistributedOptimizer(
    torch.optim.SGD([p for _, p in params], lr=0.1),
    named_parameters=params)
tok = torch.from_numpy(data["tokens"][r])
for _ in range(2):
    lin(emb(tok)).sum().backward()
    opt.step()
    opt.zero_grad()
res["opt"] = {n: p.detach().clone() for n, p in params}
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(worker, n, *args, timeout=120):
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
    out = tmp_path_factory.mktemp("sparse")
    grads = [_embedding_grads(r) for r in range(N)]
    tokens = np.random.RandomState(5).randint(0, V, (N, 6))
    np.savez(out / "data.npz", ids=np.stack([g[0] for g in grads]),
             vals=np.stack([g[1] for g in grads]), tokens=tokens)
    _spawn(_WORKER, N, out)
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(N)]
    return res, grads, tokens


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    yield
    hvd.shutdown()


def _jax_sparse(op):
    """The JAX package's SPMD sparse_allreduce of device r's slices:
    (values, indices) stacked by device, and the densified result."""
    jhvd.init(mesh=Mesh(np.array(jax.devices()[:N]), ("hvd",)))
    grads = [_embedding_grads(r) for r in range(N)]
    ids = jnp.asarray(np.stack([g[0] for g in grads]))
    vals = jnp.asarray(np.stack([g[1] for g in grads]))

    def body(i, v):
        red = jsparse.sparse_allreduce(
            jsparse.IndexedSlices(v[0], i[0], (V, D)), op=op)
        return (red.values[None], red.indices[None],
                jsparse.sparse_to_dense(red)[None])

    fn = shard_map(body, mesh=jhvd.mesh(), in_specs=(P("hvd"), P("hvd")),
                   out_specs=P("hvd"), check_vma=False)
    return [np.asarray(o) for o in jax.jit(fn)(ids, vals)]


def test_sparse_average_matches_dense_and_jax(world):
    res, grads, _ = world
    jvals, jidx, jdense = _jax_sparse(jhvd.Average)
    dense_avg = np.mean(np.stack([g[2] for g in grads]), axis=0)
    for r, out in enumerate(res):
        values, indices, shape = out["avg"]
        assert shape == (V, D)
        np.testing.assert_array_equal(values.numpy(), jvals[r])
        np.testing.assert_array_equal(indices.numpy(), jidx[r])
        dense = sparse_to_dense(IndexedSlices(values, indices, shape))
        np.testing.assert_allclose(dense.numpy(), dense_avg, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(dense.numpy(), jdense[r], rtol=1e-6,
                                   atol=1e-7)


def test_allreduce_routes_indexed_slices(world):
    res, grads, _ = world
    dense_avg = np.mean(np.stack([g[2] for g in grads]), axis=0)
    dense_sum = np.sum(np.stack([g[2] for g in grads]), axis=0)
    for out in res:
        assert out["routed_type"] == "IndexedSlices"
        np.testing.assert_allclose(out["routed"].numpy(), dense_avg,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["async"].numpy(), dense_sum,
                                   rtol=1e-6, atol=1e-7)


def test_sparse_sum_keeps_duplicates(world):
    res, grads, _ = world
    jvals, jidx, _ = _jax_sparse(jhvd.Sum)
    for r, out in enumerate(res):
        values, indices = out["sum"]
        assert values.shape[0] == N * 3
        np.testing.assert_array_equal(values.numpy(), jvals[r])
        np.testing.assert_array_equal(indices.numpy(), jidx[r])
        np.testing.assert_array_equal(
            indices.numpy(), np.concatenate([g[0] for g in grads]))


def test_grouped_allreduce_mixed_sparse_dense(world):
    res, grads, _ = world
    dense_avg = np.mean(np.stack([g[2] for g in grads]), axis=0)
    for out in res:
        ones, kind, dense, shape, twos = out["grouped"]
        np.testing.assert_array_equal(ones.numpy(), np.full((4,), 1.5))
        assert kind == "IndexedSlices" and shape == (V, D)
        np.testing.assert_allclose(dense.numpy(), dense_avg, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(twos.numpy(), np.full((2,), 2.0))


def test_sparse_coo_allreduce_matches_dense(world):
    res, grads, _ = world
    dense_avg = np.mean(np.stack([g[2] for g in grads]), axis=0)
    dense_sum = np.sum(np.stack([g[2] for g in grads]), axis=0)
    for out in res:
        is_sparse, dense = out["coo"]
        assert is_sparse
        np.testing.assert_allclose(dense.numpy(), dense_avg, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(out["coo_routed"].numpy(), dense_sum,
                                   rtol=1e-6, atol=1e-7)


def test_sparse_allreduce_over_a_set(world):
    res, grads, _ = world
    for r in (1, 3):
        values, indices = res[r]["set"]
        np.testing.assert_array_equal(
            indices.numpy(), np.concatenate([grads[1][0], grads[3][0]]))
        np.testing.assert_array_equal(
            values.numpy(), np.concatenate([grads[1][1], grads[3][1]]) / 2)


def test_distributed_optimizer_sparse_gradients(world):
    """The embedding's sparse gradients reduce by gathering slices, the
    linear layer's dense ones in the buckets; two SGD steps equal the
    same steps on the ranks' averaged dense gradients."""
    res, _, tokens = world
    torch.manual_seed(0)
    emb = torch.nn.Embedding(V, D)
    lin = torch.nn.Linear(D, 1)
    for _ in range(2):
        gs = []
        for r in range(N):
            emb.zero_grad()
            lin.zero_grad()
            lin(emb(torch.from_numpy(tokens[r]))).sum().backward()
            gs.append([p.grad.clone() for p in (emb.weight, lin.weight,
                                                 lin.bias)])
        with torch.no_grad():
            for i, p in enumerate((emb.weight, lin.weight, lin.bias)):
                p -= 0.1 * (sum(g[i] for g in gs) / N)
    want = {"emb.weight": emb.weight, "lin.weight": lin.weight,
            "lin.bias": lin.bias}
    for out in res:
        for name, w in want.items():
            np.testing.assert_allclose(out["opt"][name].numpy(),
                                       w.detach().numpy(), rtol=1e-6,
                                       atol=1e-7)
        for name in want:
            assert torch.equal(out["opt"][name], res[0]["opt"][name])


def test_dense_to_sparse_roundtrip():
    _, _, dense = _embedding_grads(2)
    sl = dense_to_sparse(torch.from_numpy(dense))
    jsl = jsparse.dense_to_sparse(jnp.asarray(dense))
    assert sl.values.shape[0] == 3 and sl.dense_shape == (V, D)
    np.testing.assert_array_equal(sl.indices.numpy(), np.asarray(jsl.indices))
    assert sl.indices.dtype == torch.int32
    np.testing.assert_array_equal(sl.values.numpy(), np.asarray(jsl.values))
    np.testing.assert_array_equal(sparse_to_dense(sl).numpy(), dense)


def test_sparse_rejects_min_max_and_adasum():
    hvd.init(device="cpu")
    ids, vals, _ = _embedding_grads(0)
    sl = IndexedSlices(torch.from_numpy(vals), torch.from_numpy(ids),
                       (V, D))
    for op in (hvd.Min, hvd.Max):
        with pytest.raises(ValueError, match="Average and Sum"):
            sparse_allreduce(sl, op=op)
    with pytest.raises(ValueError, match="sparse"):
        hvd.allreduce(sl, op=hvd.Adasum)
    with pytest.raises(TypeError, match="in-place"):
        hvd.allreduce_(sl)


def test_async_sparse_routing_and_refusals():
    """``allreduce_async`` on IndexedSlices routes through the sparse
    path; the collectives without sparse semantics refuse loudly."""
    hvd.init(device="cpu")
    ids, vals, dense = _embedding_grads(0)
    sl = IndexedSlices(torch.from_numpy(vals), torch.from_numpy(ids),
                       (V, D))
    out = hvd.synchronize(hvd.allreduce_async(sl, op=hvd.Sum))
    np.testing.assert_array_equal(sparse_to_dense(out).numpy(), dense)
    for fn in (hvd.allgather_async, lambda t: hvd.broadcast_async(t, 0),
               hvd.reducescatter_async, hvd.alltoall_async,
               lambda t: hvd.grouped_allgather_async([t])):
        with pytest.raises(TypeError, match="IndexedSlices"):
            fn(sl)
