"""The rest of the public ``hvd.*`` surface: every public name of the
JAX package is in the port, or stated below with the entry that will
bring it or the deliberate difference that keeps it out.

The walk reads ``dir()`` of ``horovod_tpu``, ``horovod_tpu.optim``,
``horovod_tpu.models`` and ``horovod_tpu.serving`` (names without a
leading underscore) in a new process, as importing them gives them; a
name bound to a module may also be a module of the port's package of
the same path.

A gloo world of four worker processes runs the rest:

* ``distributed_value_and_grad`` of ``sum(tanh(w * x)^2)`` at one ``w``
  and each rank's row of ``x`` (numpy, seed 0): its gradient is the
  ranks' mean, held against the JAX package's function under
  ``shard_map`` over four of the conftest's CPU devices on the same
  inputs to ``RTOL``, atol 1e-7, and bitwise the same on every rank;
  ``DistributedGradientTape`` over a local value-and-grad gives the
  same bits; a dict of arguments with ``op=Sum`` the JAX function's
  ``op=Sum`` at the same tolerance;
* the ``_op`` queries against the integers, on the world and on a
  process set of ranks 0 and 2, as int32 tensors on the world's device;
  ``is_homogeneous`` and ``dp_axis_names`` (and ``is_homogeneous`` on
  gloo worlds laid out as two hosts of 2 + 2 and 2 + 1 ranks, each rank
  given the launcher's slot environment);
* the deliberate differences' grounds: a ``ShardedOptimizer``'s state
  is each rank's 1-D shard rows, and a ``DistributedOptimizer``'s int8
  error-feedback residual is the rank's own, in each parameter's shape:
  no leading world dimension for a partition spec to place.

``model_fingerprint``: equal for two equal plans (meta and real tensors,
a module and its ``named_parameters()``), different after one shape or
one dtype changes, and the same in a new process.
"""

import importlib
import importlib.util
import json
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
from horovod_tpu.ops.collectives import ReduceOp as JaxOp
from horovod_tpu.optim.distributed import \
    distributed_value_and_grad as jax_value_and_grad

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.runner.util.hosts import (get_host_assignments,
                                                parse_hosts)

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 4
#: the value and gradient against the JAX function's: float32, where the
#: two ``tanh``s and the two sums round apart (the healthy readings are
#: up to 1.2e-6 relative; a lost or doubled rank is off by 25% or more)
RTOL = 4e-6

#: JAX public names that a later entry of the roadmap's queue A brings
LATER = {"multipod": "entry 14"}
#: JAX public names the port leaves out on purpose, and why
DIFFERENT = {
    "error_feedback_specs": "partition specs of a state one program holds "
                            "for every rank; a port rank holds only its "
                            "own residual",
    "sharded_state_specs": "partition specs of a state one program holds "
                           "for every rank; a port rank's ZeRO state is "
                           "its own shard rows",
}
PACKAGES = ("", ".optim", ".models", ".serving")

_WORKER = r'''
import functools
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.optim import Compression, ShardedOptimizer

out = sys.argv[1]
hvd.init(device="cpu")
data = torch.load(out + "/data.pt")
r = hvd.rank()


def loss_fn(w, x):
    return torch.sum(torch.tanh(w * x) ** 2)


def local_vag(w, x):
    w = w.detach().requires_grad_()
    loss = loss_fn(w, x)
    return loss.detach(), torch.autograd.grad(loss, w)[0]


res = {}
res["vag"] = hvd.distributed_value_and_grad(loss_fn)(data["w"], data["x"][r])
res["tape"] = hvd.DistributedGradientTape(local_vag)(data["w"], data["x"][r])
res["sum"] = hvd.distributed_value_and_grad(
    lambda p, x: loss_fn(p["w"], x), op=hvd.Sum)({"w": data["w"]},
                                                 data["x"][r])[1]
ps = hvd.add_process_set([0, 2])
ops = {"rank": hvd.rank_op(), "size": hvd.size_op(),
       "local_rank": hvd.local_rank_op(), "local_size": hvd.local_size_op(),
       "included": hvd.process_set_included_op(),
       "set_rank": hvd.rank_op(ps.process_set_id),
       "set_size": hvd.size_op(ps.process_set_id),
       "set_included": hvd.process_set_included_op(ps.process_set_id)}
res["ops"] = {k: (int(v), v.dtype, v.device.type) for k, v in ops.items()}
res["homogeneous"], res["dp_axes"] = hvd.is_homogeneous(), hvd.dp_axis_names()

torch.manual_seed(0)
lin = torch.nn.Linear(8, 6)
zero = ShardedOptimizer(functools.partial(torch.optim.Adam, lr=1e-3),
                        lin.named_parameters())
lin(torch.ones(2, 8)).sum().backward()
zero.step()
res["zero_state"] = [tuple(t.shape)
                     for s in zero.state_dict()["state"].values()
                     for k, t in s.items() if k != "step"]
res["zero_ks"] = list(zero.shards.ks)
lin2 = torch.nn.Linear(8, 6)
dopt = hvd.DistributedOptimizer(torch.optim.SGD(lin2.parameters(), lr=0.1),
                                named_parameters=lin2.named_parameters(),
                                compression=Compression.int8)
lin2(torch.ones(2, 8) * (r + 1)).sum().backward()
dopt.step()
res["residual"] = {n: tuple(v.shape)
                   for n, v in dopt.error_feedback_residual.items()}
res["param_shapes"] = {n: tuple(p.shape) for n, p in lin2.named_parameters()}
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def jax_names():
    """``{package: {name: is a module}}`` of the JAX packages' public
    names as importing them gives them, read in a new process (this
    one's ``dir()`` also holds whatever submodules other tests
    imported)."""
    code = ("import importlib, json, types\n"
            "out = {}\n"
            f"for sub in {PACKAGES!r}:\n"
            "    m = importlib.import_module('horovod_tpu' + sub)\n"
            "    out[sub] = {n: isinstance(getattr(m, n), types.ModuleType)\n"
            "               for n in dir(m) if not n.startswith('_')}\n"
            "print(json.dumps(out))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_every_jax_name_is_ported_or_stated(jax_names, sub):
    """Each public name of the JAX package (top level, ``optim``,
    ``models``, ``serving``) is in the port, or stated in LATER or
    DIFFERENT; and each stated name is still missing, so the lists
    shrink as the entries land."""
    mine = importlib.import_module("horovod_tpu_torch" + sub)
    missing = []
    for name, is_module in sorted(jax_names[sub].items()):
        ported = hasattr(mine, name) or (
            is_module and importlib.util.find_spec(
                f"horovod_tpu_torch{sub}.{name}") is not None)
        if ported:
            assert name not in LATER and name not in DIFFERENT, name
        elif name not in LATER and name not in DIFFERENT:
            missing.append(name)
    assert not missing, missing


def test_stated_names_are_jax_names(jax_names):
    """Every stated name is a public name of the JAX package."""
    names = {n for sub in PACKAGES for n in jax_names[sub]}
    assert set(LATER) | set(DIFFERENT) <= names


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(3).astype(np.float32),
            rng.randn(N, 3).astype(np.float32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("surface")
    w, x = _inputs()
    torch.save({"w": torch.from_numpy(w), "x": torch.from_numpy(x)},
               tmp / "data.pt")
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
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=150)[0])
        finally:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(N)]


def _jax_value_and_grad(w, x, op=JaxOp.AVERAGE):
    """The JAX package's function under ``shard_map`` over four CPU
    devices, rank r taking row r of ``x``: each rank's value and the
    gradient reduced by ``op``."""
    def loss_fn(w, x):
        return jnp.sum(jnp.tanh(w * x) ** 2)

    vag = jax_value_and_grad(loss_fn, op=op, axis_name="hvd")
    mesh = Mesh(np.array(jax.devices()[:N]), ("hvd",))

    def body(w, x):
        loss, g = vag(w, x[0])
        return loss.reshape(1), g

    loss, g = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P(), P("hvd")),
        out_specs=(P("hvd"), P()), check_vma=False))(w, x)
    return np.asarray(loss), np.asarray(g)


def test_distributed_value_and_grad_matches_jax(world):
    w, x = _inputs()
    want_loss, want_grad = _jax_value_and_grad(w, x)
    _, want_sum = _jax_value_and_grad(w, x, JaxOp.SUM)
    for r in range(N):
        loss, grad = world[r]["vag"]
        np.testing.assert_allclose(float(loss), want_loss[r], rtol=RTOL)
        np.testing.assert_allclose(grad.numpy(), want_grad, rtol=RTOL,
                                   atol=1e-7)
        assert torch.equal(grad, world[0]["vag"][1]), r
        tape_loss, tape_grad = world[r]["tape"]
        assert torch.equal(tape_loss, loss) and torch.equal(tape_grad, grad)
        np.testing.assert_allclose(world[r]["sum"]["w"].numpy(),
                                   want_sum, rtol=RTOL, atol=1e-7)


def test_ops_are_the_integers(world):
    for r in range(N):
        got = world[r]["ops"]
        member = r in (0, 2)
        want = {"rank": r, "size": N, "local_rank": r, "local_size": N,
                "included": 1, "set_rank": (0, 2).index(r) if member
                else -1, "set_size": 2, "set_included": int(member)}
        assert {k: v[0] for k, v in got.items()} == want, r
        assert {(v[1], v[2]) for v in got.values()} == {
            (torch.int32, "cpu")}, r
        assert world[r]["homogeneous"] is True
        assert world[r]["dp_axes"] == ("dp",)


def _host_world(hosts):
    """Start a gloo world laid out as ``hosts`` (ranks a host), each
    rank printing ``is_homogeneous()``, with the environment the
    launcher gives each slot (``runner.util.hosts.get_host_assignments``:
    its ``cross_size`` counts the hosts with a slot at the rank's local
    rank, so it differs between ranks of uneven hosts); returns the
    processes."""
    port = _free_port()
    slots = get_host_assignments(
        parse_hosts(",".join(f"h{i}:{n}" for i, n in enumerate(hosts))),
        sum(hosts))
    code = ("import torch\n"
            "import horovod_tpu_torch as hvd\n"
            "hvd.init(device='cpu')\n"
            "print('HOMOGENEOUS', hvd.is_homogeneous())\n"
            "hvd.shutdown()\n")
    procs = []
    for slot in slots:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update({f"HOROVOD_{k.upper()}": str(getattr(slot, k))
                    for k in ("rank", "size", "local_rank", "local_size",
                              "cross_rank", "cross_size")})
        env.update(HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def test_is_homogeneous_across_hosts():
    """Read at ``init()`` from every rank's local size: two hosts of two
    ranks are homogeneous on every rank, hosts of two and one are not,
    though one rank of that world sees a ``cross_size`` of 1."""
    worlds = {(2, 2): True, (2, 1): False}
    uneven = get_host_assignments(parse_hosts("h0:2,h1:1"), 3)
    assert sorted(s.cross_size for s in uneven) == [1, 2, 2]
    started = {hosts: _host_world(hosts) for hosts in worlds}
    for hosts, procs in started.items():
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            finally:
                p.kill()
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
            assert f"HOMOGENEOUS {worlds[hosts]}" in out, (hosts, out)


def test_state_specs_have_nothing_to_place(world):
    """The grounds of DIFFERENT: a rank's ZeRO-1 state is 1-D rows of its
    shard width, and its error-feedback residual has each parameter's own
    shape."""
    for r in range(N):
        got = world[r]
        assert got["zero_state"] and all(
            len(s) == 1 and s[0] in got["zero_ks"]
            for s in got["zero_state"]), r
        assert got["residual"] == got["param_shapes"], r


def _meta_named(cfg):
    with torch.device("meta"):
        return list(tt.Transformer(cfg).named_parameters())


_FP_CFG = dict(vocab_size=128, num_layers=2, num_heads=4, hidden_size=64,
               max_seq_len=16)


def test_model_fingerprint():
    cfg = tt.TransformerConfig(**_FP_CFG)
    fp = hvd.model_fingerprint(_meta_named(cfg))
    assert fp == hvd.model_fingerprint(dict(_meta_named(cfg)))
    real = tt.Transformer(cfg)
    assert fp == hvd.model_fingerprint(real)
    assert fp == hvd.model_fingerprint(real.named_parameters())
    assert fp != hvd.model_fingerprint(_meta_named(
        tt.TransformerConfig(**{**_FP_CFG, "vocab_size": 120})))
    named = _meta_named(cfg)
    named[0] = (named[0][0], named[0][1].to(torch.bfloat16))
    assert fp != hvd.model_fingerprint(named)
    code = ("import torch\n"
            "import horovod_tpu_torch as hvd\n"
            "from horovod_tpu_torch.models import transformer as tt\n"
            "with torch.device('meta'):\n"
            f"    m = tt.Transformer(tt.TransformerConfig(**{_FP_CFG!r}))\n"
            "print(hvd.model_fingerprint(m))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == fp

