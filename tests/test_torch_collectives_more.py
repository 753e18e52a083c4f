"""The port's alltoall, grouped allgather, masked allreduce, join and
allgather_object against the JAX package's SPMD results.

A world of four ranks over gloo (one spawn, every scenario in it)
against the JAX package on a four-device mesh, port rank r holding what
JAX device r holds:

* ``alltoall`` with equal splits (``tests/test_collectives.py:295``),
  over the set {1, 3} (``tests/test_process_sets.py:142``), async; with
  ragged ``splits`` and the received splits, against a numpy
  construction and against the JAX package's SPMD spelling of an uneven
  exchange, ``parallel.ulysses.padded_alltoall`` with a static
  ``max_split`` (its padding stripped by the received splits), over the
  world and over {1, 3};
* ``grouped_allgather`` (``tests/test_collectives.py:181``) on equal
  shapes against JAX's, and with uneven dim 0 and three dtypes against
  numpy, over the world and a set;
* ``masked_allreduce`` (``:309``) over the world and a set; ``join``
  (``:325``) returns 0 on every rank; ``allgather_object`` of objects
  of different sizes, over the world and a set;
* the collectives without sparse semantics refuse IndexedSlices.

Every comparison is bitwise (exchanges move values; the masked
averages are of small integers), except the masked allreduce of
float32 values, within 1e-6 relative.
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
from horovod_tpu.compat import shard_map
from horovod_tpu.parallel.ulysses import padded_alltoall

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 4
SET = [1, 3]
#: rows rank r sends to each rank (ragged), and within the set {1, 3}
SPLITS = [[1, 0, 2, 1], [0, 3, 1, 1], [2, 2, 0, 0], [1, 1, 1, 3]]
SET_SPLITS = {1: [2, 1], 3: [0, 3]}
MAX_SPLIT = 3

_WORKER = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.exceptions import (HorovodInternalError,
                                               ProcessSetError)

out = sys.argv[1]
SPLITS, SET_SPLITS, SET = eval(sys.argv[2]), eval(sys.argv[3]), \
    eval(sys.argv[4])
hvd.init(device="cpu")
r = hvd.rank()
ps = hvd.add_process_set(SET)
data = np.load(out + "/data.npz")
res = {}


def raises(exc, fn):
    try:
        fn()
    except exc as e:
        return type(e).__name__ + ": " + str(e)
    return None


x = torch.from_numpy(data["a2a"][r])
res["alltoall"] = hvd.alltoall(x)
res["alltoall_async"] = hvd.synchronize(hvd.alltoall_async(x[:, 0]))
res["alltoall_indivisible"] = raises(HorovodInternalError,
                                     lambda: hvd.alltoall(torch.ones(6)))
rows = torch.from_numpy(data["rows"][r][:sum(SPLITS[r])])
res["ragged"] = hvd.alltoall(rows, splits=SPLITS[r])
res["ragged_async"] = hvd.synchronize(hvd.alltoall_async(
    rows, splits=torch.tensor(SPLITS[r])))
res["bad_splits"] = raises(HorovodInternalError,
                           lambda: hvd.alltoall(rows, splits=[1, 1]))
if r in SET:
    res["alltoall_set"] = hvd.alltoall(torch.from_numpy(data["pair"][r]),
                                       process_set=ps)
    srows = torch.from_numpy(data["rows"][r][:sum(SET_SPLITS[r])])
    res["ragged_set"] = hvd.alltoall(srows, splits=SET_SPLITS[r],
                                     process_set=ps)
else:
    res["alltoall_nonmember"] = raises(
        ProcessSetError, lambda: hvd.alltoall(x, process_set=ps))

eq = [torch.from_numpy(data["ga%d" % i][r]) for i in range(3)]
res["grouped_eq"] = hvd.grouped_allgather(eq)
mixed = [torch.full((r + 1, 3), float(r)),
         torch.arange(2 * r + 1, dtype=torch.int64),
         (torch.arange(4.0) + r).to(torch.bfloat16).reshape(2, 2)]
res["grouped_mixed"] = hvd.grouped_allgather(mixed)
res["grouped_async"] = hvd.synchronize(hvd.grouped_allgather_async(
    [mixed[2], mixed[0]]))
if r in SET:
    res["grouped_set"] = hvd.grouped_allgather(mixed, process_set=ps)

t = torch.from_numpy(data["masked"][r])
res["masked"] = hvd.masked_allreduce(t * 0 + r, r < 3)
res["masked_values"] = hvd.masked_allreduce(t, r != 1)
res["masked_set"] = hvd.masked_allreduce(t, r == 1, process_set=ps)
res["join"] = hvd.join()
res["objects"] = hvd.allgather_object({"rank": r, "pad": "x" * 10 * r})
if r in SET:
    res["objects_set"] = hvd.allgather_object([r] * r, process_set=ps)

sl = hvd.IndexedSlices(torch.ones(2, 3), torch.tensor([0, 2]), (4, 3))
res["sparse_refused"] = [
    raises(TypeError, fn) for fn in (
        lambda: hvd.alltoall(sl), lambda: hvd.allgather(sl),
        lambda: hvd.broadcast(sl, 0), lambda: hvd.reducescatter(sl),
        lambda: hvd.grouped_allgather([sl]),
        lambda: hvd.allgather_async(sl),
        lambda: hvd.broadcast_async(sl, 0),
        lambda: hvd.reducescatter_async(sl),
        lambda: hvd.alltoall_async(sl))]
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


def _data():
    rs = np.random.RandomState(7)
    return {
        # rank r's [8, 2]: chunk j (2 rows) goes to rank j
        "a2a": (np.arange(N * 8 * 2, dtype=np.float32).reshape(N, 8, 2)),
        "pair": np.stack([np.asarray([10.0 * r, 10.0 * r + 1],
                                     np.float32) for r in range(N)]),
        # rank r's rows (padded to the longest), values 100 r + row
        "rows": np.stack([100 * r + np.arange(6 * 2, dtype=np.float32)
                          .reshape(6, 2) for r in range(N)]),
        "ga0": rs.randn(N, 2, 3).astype(np.float32),
        "ga1": rs.randn(N, 1, 5).astype(np.float32),
        "ga2": rs.randn(N, 4).astype(np.float32),
        "masked": rs.randn(N, 4).astype(np.float32),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives_more")
    data = _data()
    np.savez(out / "data.npz", **data)
    _spawn(_WORKER, N, out, repr(SPLITS), repr(SET_SPLITS), repr(SET))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(N)], data


def _jax():
    jhvd.init(mesh=Mesh(np.array(jax.devices()[:N]), ("hvd",)))
    return jhvd.add_process_set(SET)


def _spmd(body, *per_rank):
    """``body`` on device r's slices (the leading world axis dropped);
    returns the per-device results stacked."""
    fn = shard_map(lambda *xs: jax.tree.map(lambda y: y[None],
                                            body(*[x[0] for x in xs])),
                   mesh=jhvd.mesh(),
                   in_specs=tuple(P("hvd") for _ in per_rank),
                   out_specs=P("hvd"), check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(fn)(*per_rank))


def _eq(got, want):
    if torch.is_tensor(got):
        got = got.float().numpy() if got.dtype == torch.bfloat16 \
            else got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


def _ragged_numpy(rows, splits, members):
    """Rank ``members[i]``'s output of a ragged alltoall among
    ``members``: from each member j in order, the rows j sends to i."""
    outs = {}
    for i, dst in enumerate(members):
        parts, recv = [], []
        for src in members:
            off = sum(splits[src][:i])
            parts.append(rows[src][off:off + splits[src][i]])
            recv.append(splits[src][i])
        outs[dst] = (np.concatenate(parts), recv)
    return outs


def test_alltoall_equal_splits(world):
    res, data = world
    _jax()
    want = _spmd(lambda t: jhvd.alltoall(t), jnp.asarray(data["a2a"]))
    want_flat = _spmd(lambda t: jhvd.alltoall(t),
                      jnp.asarray(data["a2a"][:, :, 0]))
    for r, out in enumerate(res):
        _eq(out["alltoall"], want[r])
        _eq(out["alltoall_async"], want_flat[r])
        assert "not divisible by set size 4" in out["alltoall_indivisible"]


def test_alltoall_subset(world):
    """Member 1 (set rank 0) receives chunk 0 of 1 and 3: [10, 30];
    member 3 chunk 1: [11, 31]; the non-members raise."""
    res, data = world
    ps = _jax()
    want = _spmd(lambda t: jhvd.alltoall(t, process_set=ps),
                 jnp.asarray(data["pair"]))
    _eq(res[1]["alltoall_set"], [10.0, 30.0])
    _eq(res[3]["alltoall_set"], [11.0, 31.0])
    for r in SET:
        _eq(res[r]["alltoall_set"], want[r])
    for r in (0, 2):
        assert "not a member" in res[r]["alltoall_nonmember"]


def test_alltoall_ragged_against_numpy_and_padded_alltoall(world):
    res, data = world
    _jax()
    want = _ragged_numpy(data["rows"], SPLITS, list(range(N)))
    splits = jnp.asarray(np.array(SPLITS, np.int32))
    got_jax = _spmd(lambda x, s: padded_alltoall(x, s, MAX_SPLIT,
                                                 axis_name="hvd"),
                    jnp.asarray(data["rows"]), splits)
    for r, out in enumerate(res):
        rows, recv = out["ragged"]
        _eq(rows, want[r][0])
        assert recv.dtype == torch.int32 and recv.tolist() == want[r][1]
        jrows, jrecv = got_jax[0][r], got_jax[1][r]
        assert jrecv.tolist() == recv.tolist()
        blocks = jrows.reshape(N, MAX_SPLIT, 2)
        _eq(rows, np.concatenate([blocks[j][:jrecv[j]] for j in range(N)]))
        arows, arecv = out["ragged_async"]
        _eq(arows, want[r][0])
        assert arecv.tolist() == want[r][1]
        assert "sum to dim0" in out["bad_splits"]


def test_alltoall_ragged_subset(world):
    res, data = world
    splits = {src: SET_SPLITS[src] for src in SET}
    want = _ragged_numpy(data["rows"], splits, SET)
    for r in SET:
        rows, recv = res[r]["ragged_set"]
        _eq(rows, want[r][0])
        assert recv.tolist() == want[r][1]


def test_grouped_allgather_matches_jax(world):
    res, data = world
    _jax()
    xs = [jnp.asarray(data["ga%d" % i]) for i in range(3)]
    want = _spmd(lambda a, b, c: jhvd.grouped_allgather([a, b, c]), *xs)
    for r, out in enumerate(res):
        for got, w in zip(out["grouped_eq"], want):
            _eq(got, w[r])
        for got, i in zip(out["grouped_eq"], range(3)):
            _eq(got, data["ga%d" % i].reshape(
                (-1,) + data["ga%d" % i].shape[2:]))


def _mixed(members):
    return [np.concatenate([np.full((m + 1, 3), float(m), np.float32)
                            for m in members]),
            np.concatenate([np.arange(2 * m + 1) for m in members]),
            np.concatenate([(np.arange(4.0) + m).reshape(2, 2)
                            for m in members])]


def test_grouped_allgather_uneven_and_dtypes(world):
    res, _ = world
    want = _mixed(range(N))
    for r, out in enumerate(res):
        got = out["grouped_mixed"]
        assert [g.dtype for g in got] == [torch.float32, torch.int64,
                                          torch.bfloat16]
        for g, w in zip(got, want):
            _eq(g, w)
        _eq(out["grouped_async"][0], want[2])
        _eq(out["grouped_async"][1], want[0])
    for r in SET:
        for g, w in zip(res[r]["grouped_set"], _mixed(SET)):
            _eq(g, w)


def test_masked_allreduce(world):
    """Ranks 0-2 valid: (0 + 1 + 2) / 3 on every rank
    (``tests/test_collectives.py:309``'s construction); over {1, 3} with
    only rank 1 valid, and its non-members, as JAX's SPMD form."""
    res, data = world
    ps = _jax()
    t = jnp.asarray(data["masked"])
    rk = jnp.arange(N, dtype=jnp.float32)
    want = _spmd(lambda x, k: jhvd.masked_allreduce(x * 0 + k, k < 3),
                 t, rk)
    want_v = _spmd(lambda x, k: jhvd.masked_allreduce(x, k != 1), t, rk)
    want_s = _spmd(lambda x, k: jhvd.masked_allreduce(
        x, k == 1, process_set=ps), t, rk)
    for r, out in enumerate(res):
        _eq(out["masked"], want[r])
        _eq(out["masked"], np.full((4,), np.float32(3.0) / np.float32(3.0)))
        np.testing.assert_allclose(out["masked_values"].numpy(), want_v[r],
                                   rtol=1e-6)
        np.testing.assert_allclose(out["masked_set"].numpy(), want_s[r],
                                   rtol=1e-6)


def test_join_returns_zero_on_every_rank(world):
    assert [out["join"] for out in world[0]] == [0] * N


def test_allgather_object(world):
    res, _ = world
    want = [{"rank": r, "pad": "x" * 10 * r} for r in range(N)]
    for out in res:
        assert out["objects"] == want
    for r in SET:
        assert res[r]["objects_set"] == [[1], [3, 3, 3]]


def test_collectives_refuse_indexed_slices(world):
    for out in world[0]:
        assert len(out["sparse_refused"]) == 9
        for msg in out["sparse_refused"]:
            assert msg is not None and "IndexedSlices" in msg, msg
