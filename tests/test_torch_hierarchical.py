"""The port's two-level collectives (``ops/hierarchical.py``) against the
JAX package's.

Gloo worlds of 4 (2 x 2), 6 (3 x 2) and 8 (block 2 and block 4), one
spawn each with every scenario of that world in it. Port rank r holds
what JAX device r holds; the JAX side runs ``hierarchical_psum`` and
``hierarchical_allgather`` in their one-axis form (the same ``block``)
under ``shard_map`` on a mesh of the first n CPU devices. World 6 with
block 2 is the JAX test's two-axis (3, 2) pod layout. The cases are
``tests/test_hierarchical.py``'s:

* ``allreduce`` SUM and AVERAGE at (16,), (3, 5) and (7,) with
  ``HOROVOD_HIERARCHICAL_ALLREDUCE`` (AVERAGE divides the sum), and the
  knob's flat counterpart; ``allgather`` with
  ``HOROVOD_HIERARCHICAL_ALLGATHER``;
* the int8 outer leg (block 16) at (17,), (4, 5) and (23,), without and
  with a residual: two calls, the second fed the first's residual,
  whose layout is the JAX one (the shard residual at the head of an
  x-shaped buffer, zeros after it); the error-feedback contract (the
  second call's error within twice the quantization step); the bf16
  outer wire;
* the structure, in place of the JAX test's HLO: the
  ``torch.distributed`` calls each collective makes, with their group
  sizes;
* ``resolve_block``, and the launcher's ``--hierarchical-*`` flags;
* the DistributedOptimizer's int8 + error-feedback step under the knob
  at world 4 against the JAX optimizer's: reduced buckets, residuals and
  parameters bitwise;
* ``emulated_hierarchical_psum`` (the composition ``chip_smoke.py``
  phase 4h runs on one card) bitwise the gloo world of 2 x 2.

Tolerances: bitwise where every sum is over two ranks or in peer order
(every inner domain of 2; the int8 leg's peers are summed in peer order
by B13 on both sides). An inner domain of 4 (world 8, block 4) or a
float outer leg over 3 or 4 domains adds in gloo's order, not XLA's:
within 4 float32 ulps of the largest |input| sum there. The bf16 wire
rounds each domain's shard and each outer sum to bf16: with u half a
bf16 ulp of the element's sum of |inputs|, within 2u of the JAX leg per
outer add and u per rounding of the exact sum.
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
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.compat import shard_map
from horovod_tpu.core.knobs import Knobs as JKnobs
from horovod_tpu.core.state import global_state as jax_state
from horovod_tpu.ops import hierarchical as jhier
from horovod_tpu.optim.compression import WireSpec as JWire
from horovod_tpu.runner import launch as jax_launch
from horovod_tpu.runner.util import config_parser as jax_config_parser
from horovod_tpu_torch.core.knobs import Knobs
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.ops import hierarchical as hier
from horovod_tpu_torch.optim.compression import WireSpec
from horovod_tpu_torch.runner import launch
from horovod_tpu_torch.runner.util import config_parser

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
BLOCKS = {4: (2,), 6: (2,), 8: (2, 4)}
SHAPES = ((16,), (3, 5), (7,))
Q_SHAPES = ((17,), (4, 5), (23,))
QBLOCK = 16
#: the optimizer scenario (world 4, block 2): three buckets at 4 KiB
OPT_SHAPES = {"dense_0.kernel": (40, 30), "dense_0.bias": (30,),
              "dense_1.kernel": (30, 7), "emb.embedding": (50, 16)}
OPT_BLOCK, OPT_THRESHOLD, OPT_STEPS, OPT_LR = 64, 4096, 2, 0.1

_WORKER = r'''
import dataclasses
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops import hierarchical as H
from horovod_tpu_torch.optim.compression import WireSpec

out, blocks = sys.argv[1], eval(sys.argv[2])
qblock, opt_shapes = int(sys.argv[3]), eval(sys.argv[4])
opt_local, threshold, steps, lr, opt_block = (
    int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]),
    float(sys.argv[8]), int(sys.argv[9]))
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
st = global_state()
data = np.load(out + "/data.npz")
calls = []


def counted(name, fn):
    def call(*a, group=None, **k):
        calls.append((name, dist.get_world_size(group)))
        return fn(*a, group=group, **k)
    return call


C._reduce_scatter_single = counted("reduce_scatter",
                                   C._reduce_scatter_single)
C._all_gather_single = counted("all_gather", C._all_gather_single)
dist.all_reduce = counted("all_reduce", dist.all_reduce)
dist.all_gather = counted("gather", dist.all_gather)


def knobs(**kw):
    st.knobs = dataclasses.replace(st.knobs, **kw)


def structure(fn):
    calls.clear()
    fn()
    return list(calls)


xs = [torch.from_numpy(data["x%d" % i][r]) for i in range(3)]
qs = [torch.from_numpy(data["q%d" % i][r]) for i in range(3)]
g = torch.from_numpy(data["g"][r])
res = {"flat": [hvd.allreduce(x, op=hvd.Sum) for x in xs],
       "flat_calls": structure(lambda: hvd.allreduce(xs[0], op=hvd.Sum)),
       "flat_gather_calls": structure(lambda: hvd.allgather(g))}
for block in blocks:
    knobs(hierarchical_allreduce=True, hierarchical_allgather=True,
          hierarchical_local_size=block)
    wire = WireSpec("int8", qblock)
    d = res[block] = {}
    d["sum"] = [hvd.allreduce(x, op=hvd.Sum) for x in xs]
    d["avg"] = [hvd.allreduce(x, op=hvd.Average) for x in xs]
    d["grouped"] = hvd.grouped_allreduce(xs, op=hvd.Sum)
    d["gather"] = hvd.allgather(g)
    d["float_calls"] = structure(lambda: hvd.allreduce(xs[0], op=hvd.Sum))
    d["gather_calls"] = structure(lambda: hvd.allgather(g))
    d["int8_calls"] = structure(lambda: H.hierarchical_psum(qs[0], block,
                                                            wire))
    d["int8"] = [H.hierarchical_psum(q, block, wire) for q in qs]
    ef = []
    for q in qs:
        y1, r1 = H.hierarchical_psum(q, block, wire, torch.zeros(q.shape))
        y2, r2 = H.hierarchical_psum(q, block, wire, r1)
        ef.append((y1, r1, y2, r2))
    d["int8_ef"] = ef
    d["bf16"] = [H.hierarchical_psum(x, block, WireSpec("bf16"))
                 for x in xs]
knobs(hierarchical_allreduce=False, hierarchical_allgather=False,
      hierarchical_local_size=0)
if n == 4:
    knobs(hierarchical_allreduce=True, hierarchical_local_size=opt_local,
          compression_block=opt_block)
    grads = np.load(out + "/opt_grads.npz")
    params = [(k, torch.nn.Parameter(torch.zeros(s)))
              for k, s in opt_shapes.items()]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in params], lr=lr),
        named_parameters=params, compression=hvd.Compression.int8,
        fusion_threshold_bytes=threshold)
    trace = []
    for t in range(steps):
        sum((p * torch.from_numpy(grads[k][t, r])).sum()
            for k, p in params).backward()
        opt.step()
        trace.append({
            "grad": {k: p.grad.clone() for k, p in params},
            "res": {k: v.clone()
                    for k, v in opt.error_feedback_residual.items()},
            "param": {k: p.detach().clone() for k, p in params}})
        opt.zero_grad()
    res["opt"], res["opt_buckets"] = trace, len(opt.bucket_plan)
    res["opt_block"] = opt._hier_block
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(n, out):
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
            [sys.executable, "-c", _WORKER, str(out), repr(BLOCKS[n]),
             str(QBLOCK), repr(OPT_SHAPES), "2", str(OPT_THRESHOLD),
             str(OPT_STEPS), repr(OPT_LR), str(OPT_BLOCK)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs, timeout=150):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        finally:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o


def _data(n):
    rs = np.random.RandomState(40 + n)
    d = {f"x{i}": rs.uniform(-2, 2, (n,) + s).astype(np.float32)
         for i, s in enumerate(SHAPES)}
    d.update({f"q{i}": rs.uniform(-1, 1, (n,) + s).astype(np.float32)
              for i, s in enumerate(Q_SHAPES)})
    d["g"] = rs.uniform(-2, 2, (n, 3, 2)).astype(np.float32)
    return d


def _opt_grads():
    rs = np.random.RandomState(3)
    return {k: (rs.randn(OPT_STEPS, 4, *s)
                * 10.0 ** rs.uniform(-3, 0)).astype(np.float32)
            for k, s in OPT_SHAPES.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("hier")
    started = {}
    for n in BLOCKS:
        d = base / f"world{n}"
        d.mkdir()
        np.savez(d / "data.npz", **_data(n))
        if n == 4:
            np.savez(d / "opt_grads.npz", **_opt_grads())
        started[n] = (d, _start(n, d))
    res = {}
    for n, (d, procs) in started.items():
        _wait(procs)
        res[n] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                  for r in range(n)]
    return res


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    yield
    hvd.shutdown()


_JAX_CACHE = {}


def _jax_results(n, block):
    """Every case of world ``n`` and ``block`` through the JAX package's
    one-axis ``hierarchical_psum``/``hierarchical_allgather`` in one
    ``shard_map``: each output stacked over the devices."""
    key = (n, block)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    d = _data(n)
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
    sizes = {"hvd": n}
    wire = JWire("int8", QBLOCK)

    def psum(x, **kw):
        return jhier.hierarchical_psum(x, ("hvd",), sizes, block, **kw)

    def body(x0, x1, x2, q0, q1, q2, g):
        xs, qs = [x0[0], x1[0], x2[0]], [q0[0], q1[0], q2[0]]
        out = {"sum": [psum(x) for x in xs],
               "flat": [lax.psum(x, "hvd") for x in xs],
               "gather": jhier.hierarchical_allgather(g[0], ("hvd",), sizes,
                                                      block),
               "int8": [psum(q, wire=wire) for q in qs],
               "bf16": [psum(x, wire=JWire("bf16")) for x in xs],
               "int8_ef": []}
        for q in qs:
            y1, r1 = psum(q, wire=wire, residual=jnp.zeros_like(q))
            y2, r2 = psum(q, wire=wire, residual=r1)
            out["int8_ef"].append((y1, r1, y2, r2))
        return jax.tree.map(lambda a: a[None], out)

    names = [f"x{i}" for i in range(3)] + [f"q{i}" for i in range(3)] + ["g"]
    fn = shard_map(body, mesh=mesh, in_specs=(P("hvd"),) * len(names),
                   out_specs=P("hvd"), check_vma=False)
    got = jax.jit(fn)(*[jnp.asarray(d[k]) for k in names])
    _JAX_CACHE[key] = jax.tree.map(np.asarray, got)
    return _JAX_CACHE[key]


def _exact(block, n):
    """Whether every float sum of the two-level allreduce is over two
    operands (an inner domain of 2, an outer leg of 2 domains)."""
    return block == 2 and n // block == 2


def _close(got, want, exact, scale, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=4 * np.finfo(np.float32).eps * scale,
                                   err_msg=what)


def _cases():
    return [(n, b) for n, blocks in BLOCKS.items() for b in blocks]


@pytest.mark.parametrize("n,block", _cases())
@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_allreduce_sum_and_average_match_jax(worlds, n, block, i):
    want = _jax_results(n, block)
    x = _data(n)[f"x{i}"]
    scale = np.abs(x).sum(axis=0).max()
    for r, out in enumerate(worlds[n]):
        got = out[block]
        assert got["sum"][i].shape == SHAPES[i]
        _close(got["sum"][i], want["sum"][i][r], _exact(block, n), scale,
               f"sum rank {r}")
        _close(got["grouped"][i], want["sum"][i][r], _exact(block, n), scale,
               f"grouped rank {r}")
        # AVERAGE divides the two-level sum, as the JAX leaf does
        _close(got["avg"][i], want["sum"][i][r] / np.float32(n),
               _exact(block, n), scale / n, f"average rank {r}")
        # and the value is the flat sum's
        np.testing.assert_allclose(got["sum"][i].numpy(), out["flat"][i],
                                   rtol=0, atol=8e-7 * scale)
        np.testing.assert_allclose(want["flat"][i][r], out["flat"][i],
                                   rtol=0, atol=8e-7 * scale)


@pytest.mark.parametrize("n,block", _cases())
def test_allgather_matches_jax_and_the_flat_gather(worlds, n, block):
    want = _jax_results(n, block)["gather"]
    g = _data(n)["g"]
    for r, out in enumerate(worlds[n]):
        np.testing.assert_array_equal(out[block]["gather"].numpy(), want[r])
        np.testing.assert_array_equal(want[r], g.reshape(n * 3, 2))


@pytest.mark.parametrize("n,block", _cases())
@pytest.mark.parametrize("i", range(len(Q_SHAPES)))
def test_int8_outer_leg_matches_jax(worlds, n, block, i):
    """The int8 leg: B11 or B12 on one row, the codes and scales
    gathered over the outer set, B13 in peer order; bitwise the JAX
    leg whenever the inner sum is (an inner domain of 2)."""
    want = _jax_results(n, block)
    q = _data(n)[f"q{i}"]
    ref = q.sum(axis=0)
    exact = block == 2
    scale = np.abs(q).sum(axis=0).max()
    step = (n // block) * np.abs(ref).max() / 127.0 + 1e-5
    k = -(-q[0].size // block)
    for r, out in enumerate(worlds[n]):
        got = out[block]
        _close(got["int8"][i], want["int8"][i][r], exact, scale,
               f"int8 rank {r}")
        y1, r1, y2, r2 = got["int8_ef"][i]
        wy1, wr1, wy2, wr2 = (a[r] for a in want["int8_ef"][i])
        _close(y1, wy1, exact, scale, f"ef y1 rank {r}")
        _close(y2, wy2, exact, scale, f"ef y2 rank {r}")
        _close(r1, wr1, exact, scale, f"ef residual 1 rank {r}")
        _close(r2, wr2, exact, scale, f"ef residual 2 rank {r}")
        # the layout: x's shape, the shard residual at its head, zeros
        # after it; the error-feedback contract
        assert r1.shape == q.shape[1:] and r1.dtype == torch.float32
        assert not r1.reshape(-1)[k:].any()
        assert np.abs(y1.numpy() - ref).max() <= step
        assert np.abs(y2.numpy() - ref).max() <= 2 * step


@pytest.mark.parametrize("n,block", _cases())
def test_bf16_outer_wire_matches_jax(worlds, n, block):
    """The bf16 outer wire: each domain's shard rounded to bf16 and
    summed in bf16, back to float32. With ``u`` = 2^-8 of the element's
    sum of |inputs| (half a bf16 ulp of it): within 2u of the JAX leg
    for each outer add that the two sides may order differently (at
    least one), and within u a rounding (n // block casts and
    n // block - 1 adds) of the exact sum."""
    want = _jax_results(n, block)["bf16"]
    outer = n // block
    for i in range(len(SHAPES)):
        x = _data(n)[f"x{i}"]
        ref, u = x.sum(axis=0), 2.0 ** -8 * np.abs(x).sum(axis=0)
        for r, out in enumerate(worlds[n]):
            got = out[block]["bf16"][i]
            assert got.dtype == torch.float32
            assert (np.abs(got.numpy() - want[i][r])
                    <= max(1, outer - 1) * 2 * u).all()
            assert (np.abs(got.numpy() - ref) <= (2 * outer - 1) * u).all()


@pytest.mark.parametrize("n,block", _cases())
def test_structure_of_the_collectives(worlds, n, block):
    """In place of the JAX test's HLO: without the knob one all-reduce
    over the world; with it an inner reduce-scatter, then an outer
    all-reduce (float) or two outer all-gathers (int8: codes and
    scales), then an inner all-gather; the allgather an inner then an
    outer gather (each of the dim-0 sizes and of the payload)."""
    inner, outer = block, n // block
    for out in worlds[n]:
        assert out["flat_calls"] == [("all_reduce", n)]
        got = out[block]
        assert got["float_calls"] == [("reduce_scatter", inner),
                                      ("all_reduce", outer),
                                      ("all_gather", inner)]
        assert got["int8_calls"] == [("reduce_scatter", inner),
                                     ("all_gather", outer),
                                     ("all_gather", outer),
                                     ("all_gather", inner)]
        # the allgather: a gather of the dim-0 sizes and one of the
        # payload, over the world; with the knob over the inner set, then
        # over the outer set
        assert out["flat_gather_calls"] == [("gather", n)] * 2
        assert got["gather_calls"] == [("gather", inner)] * 2 + \
            [("gather", outer)] * 2


def test_resolve_block():
    assert hier.resolve_block(8, 3) == 1   # does not divide
    assert hier.resolve_block(8, 8) == 1   # no outer level
    assert hier.resolve_block(8, 1) == 1
    assert hier.resolve_block(8, 4) == 4
    assert hier.resolve_block(6, 2) == 2
    assert hier.block_groups(6, 2) == ([[0, 1], [2, 3], [4, 5]],
                                       [[0, 2, 4], [1, 3, 5]])
    for world, block in ((8, 3), (8, 8), (8, 1), (8, 4), (6, 2)):
        assert hier.resolve_block(world, block) == \
            jhier.resolve_block(world, block)
        if block > 1 and world % block == 0:
            assert hier.block_groups(world, block) == \
                tuple(jhier._block_groups(world, block))
    # 0 takes the launcher's ranks per host
    hvd.init(device="cpu")
    st = global_state()
    st.local_size = 2
    assert hier.resolve_block(8, 0) == 2
    st.local_size = 8
    assert hier.resolve_block(8, 0) == 1
    # the gate: the global set only, by its knob
    st.knobs = dataclasses.replace(st.knobs, hierarchical_allreduce=True)
    assert hier.hierarchy_enabled_for("allreduce", None)
    assert hier.hierarchy_enabled_for("allreduce", hvd.global_process_set())
    assert not hier.hierarchy_enabled_for("allgather", None)
    # world 1: the flat route, the input itself
    x = torch.arange(5.0)
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
    assert torch.equal(hier.hierarchical_psum(x, 2), x)


def test_launcher_flags_set_the_knobs(monkeypatch):
    """``hvdrun --hierarchical-allreduce --hierarchical-allgather
    --hierarchical-local-size 2`` is accepted and exports the knobs the
    workers read, as the JAX launcher does."""
    argv = ["--hierarchical-allreduce", "--hierarchical-allgather",
            "--hierarchical-local-size", "2", "-np", "4", "python",
            "train.py"]
    mine, theirs = launch.parse_args(argv), jax_launch.parse_args(argv)
    assert launch.unported_flags(mine, argv) == []
    env = config_parser.env_from_args(mine, {})
    assert env == jax_config_parser.env_from_args(theirs, {})
    assert env == {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                   "HOROVOD_HIERARCHICAL_ALLGATHER": "1",
                   "HOROVOD_HIERARCHICAL_LOCAL_SIZE": "2"}
    assert 7 not in launch.ENTRIES
    for k in list(os.environ):
        if k.startswith(("HOROVOD_", "HVD_TPU_")):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    k, jk = Knobs.from_env(), JKnobs.from_env()
    for field in ("hierarchical_allreduce", "hierarchical_allgather",
                  "hierarchical_local_size"):
        assert getattr(k, field) == getattr(jk, field)
    assert (k.hierarchical_allreduce, k.hierarchical_allgather,
            k.hierarchical_local_size) == (True, True, 2)


def test_emulated_composition_is_the_gloo_world(worlds):
    """The stage functions composed in one process (the exchanges as
    slicing) give the gloo world of 2 x 2's bits: float32, bf16 and the
    int8 leg with residuals, two calls."""
    d = _data(4)
    res = worlds[4]
    for i in range(len(SHAPES)):
        xs = [torch.from_numpy(d[f"x{i}"][r]) for r in range(4)]
        ys, _ = hier.emulated_hierarchical_psum(xs, 2)
        bf, _ = hier.emulated_hierarchical_psum(xs, 2, WireSpec("bf16"))
        for r in range(4):
            assert torch.equal(ys[r], res[r][2]["sum"][i])
            assert torch.equal(bf[r], res[r][2]["bf16"][i])
    wire = WireSpec("int8", QBLOCK)
    for i in range(len(Q_SHAPES)):
        qs = [torch.from_numpy(d[f"q{i}"][r]) for r in range(4)]
        y1, r1 = hier.emulated_hierarchical_psum(
            qs, 2, wire, [torch.zeros(q.shape) for q in qs])
        y2, r2 = hier.emulated_hierarchical_psum(qs, 2, wire, r1)
        y0, none = hier.emulated_hierarchical_psum(qs, 2, wire)
        assert none is None
        for r in range(4):
            got = res[r][2]
            assert torch.equal(y0[r], got["int8"][i])
            for a, b in zip((y1[r], r1[r], y2[r], r2[r]), got["int8_ef"][i]):
                assert torch.equal(a, b)


def _jax_opt_trace(grads):
    """The JAX DistributedOptimizer(optax.sgd(1.0), int8) under the
    hierarchy knob (block 2) at world 4: per step the reduced gradients,
    the residual rows and the parameters ``p - lr g``."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("hvd",))
    jhvd.init(mesh=mesh)
    st = jax_state()
    st.knobs = dataclasses.replace(
        st.knobs, compression_block=OPT_BLOCK, hierarchical_allreduce=True,
        hierarchical_local_size=2)
    opt = jhvd.DistributedOptimizer(optax.sgd(1.0),
                                    compression=jhvd.Compression.int8,
                                    fusion_threshold_bytes=OPT_THRESHOLD)

    def nest(flat):
        tree = {}
        for name, v in flat.items():
            mod, leaf = name.split(".")
            tree.setdefault(mod, {})[leaf] = v
        return tree

    def flat(tree):
        return {f"{m}.{k}": np.asarray(v) for m, sub in tree.items()
                for k, v in sub.items()}

    params = nest({k: jnp.zeros(s, jnp.float32)
                   for k, s in OPT_SHAPES.items()})
    state = opt.init(params)
    specs = jhvd.error_feedback_specs(state)
    step = jax.jit(shard_map(
        lambda g, s, p: opt.update(jax.tree.map(lambda a: a[0], g), s, p),
        mesh=mesh, in_specs=(P("hvd"), specs, P()), out_specs=(P(), specs),
        check_vma=False))
    trace, p = [], {k: np.zeros(s, np.float32) for k, s in OPT_SHAPES.items()}
    for t in range(OPT_STEPS):
        u, state = step(nest({k: jnp.asarray(a[t]) for k, a in
                              grads.items()}), state, params)
        red = {k: -v for k, v in flat(u).items()}
        p = {k: p[k] + np.float32(-OPT_LR) * red[k] for k in p}
        trace.append({"grad": red, "res": flat(state.residual), "param": p})
    return trace


def test_int8_optimizer_under_the_knob_matches_jax(worlds):
    saved = jax_state().knobs
    try:
        want = _jax_opt_trace(_opt_grads())
    finally:
        jhvd.shutdown()
        jax_state().knobs = saved
    res = worlds[4]
    assert res[0]["opt_block"] == 2 and res[0]["opt_buckets"] == 3
    for t in range(OPT_STEPS):
        w = want[t]
        for r in range(4):
            got = res[r]["opt"][t]
            assert set(got["res"]) == set(OPT_SHAPES)
            for k in OPT_SHAPES:
                np.testing.assert_array_equal(
                    got["grad"][k].numpy(), w["grad"][k],
                    err_msg=f"step {t} rank {r} reduced {k}")
                np.testing.assert_array_equal(
                    got["res"][k].numpy(), w["res"][k][r],
                    err_msg=f"step {t} rank {r} residual {k}")
                np.testing.assert_allclose(
                    got["param"][k].numpy(), w["param"][k], rtol=1e-6,
                    atol=1e-6 * (1 + np.abs(w["param"][k]).max()),
                    err_msg=f"step {t} rank {r} param {k}")
