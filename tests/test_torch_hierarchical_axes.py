"""The two-axis form of the port's two-level collectives against the JAX
package's (``tests/test_hierarchical.py``'s two-axis and odd-pod cases).

Gloo worlds of 8 (``HOROVOD_MESH=dcn=2,ici=4``), 6 (``dcn=3,ici=2``), 5
(``dcn=5,ici=1``) and 3 (``dcn=3,ici=1``), one spawn each. Port rank r
holds what JAX device r holds on a ``("dcn", "ici")`` mesh of the first
n CPU devices, where the JAX side runs ``hierarchical_psum`` and
``hierarchical_allgather`` over both axes under ``shard_map``; the port
passes the same axes of its world's mesh (the inner domain the last
axis, even of one rank, as in the JAX package). The cases:

* ``test_two_axis_hierarchy_matches_flat`` and
  ``test_two_axis_allgather_matches_flat`` (world 8): the sum within
  rtol/atol 1e-5 of the JAX sum and of the flat sum, the gather
  exactly; with the knobs on and no local size the collectives take the
  mesh's block (4) and give the same;
* ``test_nonpow2_pods_int8_outer_leg`` at (3, 2) and (5, 1) x (17,) and
  (4, 5): within the JAX test's int8 tolerance (pods x max |sum| / 127
  + 1e-5) of the flat sum and of the JAX leg;
* ``test_nonpow2_pods_int8_error_feedback_residual`` at 3 and 5 pods of
  one rank: the first call within the tolerance, the second, fed the
  first's residual, within twice it;
* the int8 ``DistributedOptimizer`` on the world of ``dcn=3,ici=2``
  without any hierarchy knob takes the mesh's block (2): bitwise the
  one-axis block-2 route (``HOROVOD_HIERARCHICAL_ALLREDUCE`` with local
  size 2 on a one-axis world); ``ShardedOptimizer`` refuses the world
  of two live axes with the JAX package's message.
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
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.ops import hierarchical as jhier
from horovod_tpu.optim.compression import WireSpec as JWire
from horovod_tpu_torch.ops import hierarchical as hier
from horovod_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
#: world -> (dcn, ici)
LAYOUTS = {8: (2, 4), 6: (3, 2), 5: (5, 1), 3: (3, 1)}
Q_SHAPES = ((17,), (4, 5))
QBLOCK, EF_BLOCK, EF_SHAPE = 32, 16, (23,)
OPT_SHAPES = {"dense_0.kernel": (40, 30), "dense_0.bias": (30,),
              "dense_1.kernel": (30, 7), "emb.embedding": (50, 16)}
OPT_BLOCK, OPT_THRESHOLD, OPT_STEPS, OPT_LR = 64, 4096, 2, 0.1

_WORKER = r'''
import dataclasses
import functools
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.ops import hierarchical as H
from horovod_tpu_torch.optim.compression import WireSpec
from horovod_tpu_torch.parallel.mesh import mesh_from_spec

out = sys.argv[1]
qblock, ef_block = int(sys.argv[2]), int(sys.argv[3])
opt_shapes, threshold, steps, lr, opt_block = (
    eval(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6]),
    float(sys.argv[7]), int(sys.argv[8]))
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
st = global_state()
axes = st.mesh.axis_names
data = np.load(out + "/data.npz")


def t(key):
    return torch.from_numpy(data[key][r])


def knobs(**kw):
    st.knobs = dataclasses.replace(st.knobs, **kw)


res = {"mesh_block": H.mesh_block(), "axes_block": H.axes_block(axes)}
res["psum"] = H.hierarchical_psum(t("x"), axes)
res["gather"] = H.hierarchical_allgather(t("g"), axes)
res["int8"] = [H.hierarchical_psum(t("q%d" % i), axes,
                                   WireSpec("int8", qblock))
               for i in range(2)]
ef = WireSpec("int8", ef_block)
y1, r1 = H.hierarchical_psum(t("e"), axes, ef, torch.zeros(data["e"][r].shape))
y2, _ = H.hierarchical_psum(t("e"), axes, ef, r1)
res["ef"] = (y1, y2)
knobs(hierarchical_allreduce=True, hierarchical_allgather=True)
res["two_level"] = H.two_level_block("allreduce")
res["knob_sum"] = hvd.allreduce(t("x"), op=hvd.Sum)
res["knob_gather"] = hvd.allgather(t("g"))
knobs(hierarchical_allreduce=False, hierarchical_allgather=False)
if n == 6:
    knobs(compression_block=opt_block)
    grads = np.load(out + "/opt_grads.npz")

    def run_opt():
        params = [(k, torch.nn.Parameter(torch.zeros(s)))
                  for k, s in opt_shapes.items()]
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in params], lr=lr),
            named_parameters=params, compression=hvd.Compression.int8,
            fusion_threshold_bytes=threshold)
        trace = []
        for s in range(steps):
            sum((p * torch.from_numpy(grads[k][s, r])).sum()
                for k, p in params).backward()
            opt.step()
            trace.append(
                [p.grad.clone() for _, p in params]
                + [v.clone() for v in opt.error_feedback_residual.values()]
                + [p.detach().clone() for _, p in params])
            opt.zero_grad()
        return opt._hier_block, trace

    res["opt_mesh"] = run_opt()
    try:
        hvd.ShardedOptimizer(functools.partial(torch.optim.SGD, lr=lr),
                             named_parameters=[("w", torch.nn.Parameter(
                                 torch.zeros(3)))])
        res["sharded_refusal"] = None
    except ValueError as e:
        res["sharded_refusal"] = str(e)
    two_axis = st.mesh
    st.mesh = mesh_from_spec("", n, r).bind()
    knobs(hierarchical_allreduce=True, hierarchical_local_size=2)
    res["opt_one_axis"] = run_opt()
    st.mesh = two_axis
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(n, out):
    dcn, ici = LAYOUTS[n]
    port = _free_port()
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HOROVOD_MESH=f"dcn={dcn},ici={ici}",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(out), str(QBLOCK),
             str(EF_BLOCK), repr(OPT_SHAPES), str(OPT_THRESHOLD),
             str(OPT_STEPS), repr(OPT_LR), str(OPT_BLOCK)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _data(n):
    rs = np.random.RandomState(70 + n)
    d = {"x": rs.uniform(-2, 2, (n, 5)).astype(np.float32),
         "g": rs.uniform(-2, 2, (n, 2, 3)).astype(np.float32),
         "e": rs.uniform(-1, 1, (n,) + EF_SHAPE).astype(np.float32)}
    d.update({f"q{i}": rs.uniform(-2, 2, (n,) + s).astype(np.float32)
              for i, s in enumerate(Q_SHAPES)})
    return d


def _opt_grads(n):
    rs = np.random.RandomState(3)
    return {k: (rs.randn(OPT_STEPS, n, *s)
                * 10.0 ** rs.uniform(-3, 0)).astype(np.float32)
            for k, s in OPT_SHAPES.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("hier_axes")
    started = {}
    for n in LAYOUTS:
        d = base / f"world{n}"
        d.mkdir()
        np.savez(d / "data.npz", **_data(n))
        if n == 6:
            np.savez(d / "opt_grads.npz", **_opt_grads(n))
        started[n] = (d, _start(n, d))
    res = {}
    for n, (d, procs) in started.items():
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=150)[0])
            finally:
                p.kill()
        for p, o in zip(procs, outs):
            assert p.returncode == 0, o
        res[n] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                  for r in range(n)]
    return res


_JAX_CACHE = {}


def _jax_results(n):
    """The JAX package's two-axis functions over ``("dcn", "ici")`` on
    world ``n``'s layout, and the flat psum: each output stacked over the
    devices (device r is port rank r, the mesh row-major)."""
    if n in _JAX_CACHE:
        return _JAX_CACHE[n]
    dcn, ici = LAYOUTS[n]
    d = _data(n)
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(dcn, ici),
                ("dcn", "ici"))
    sizes = {"dcn": dcn, "ici": ici}
    axes = ("dcn", "ici")

    def body(x, g, e, q0, q1):
        x, g, e, q0, q1 = (a[0][0] for a in (x, g, e, q0, q1))
        out = {"psum": jhier.hierarchical_psum(x, axes, sizes),
               "flat": jax.lax.psum(x, axes),
               "gather": jhier.hierarchical_allgather(g, axes, sizes),
               "int8": [jhier.hierarchical_psum(q, axes, sizes,
                                                wire=JWire("int8", QBLOCK))
                        for q in (q0, q1)],
               "q_flat": [jax.lax.psum(q, axes) for q in (q0, q1)],
               "e_flat": jax.lax.psum(e, axes)}
        return jax.tree.map(lambda a: a[None, None], out)

    names = ["x", "g", "e", "q0", "q1"]
    fn = shard_map(body, mesh=mesh, in_specs=(P("dcn", "ici"),) * 5,
                   out_specs=P("dcn", "ici"), check_vma=False)
    got = jax.jit(fn)(*[jnp.asarray(d[k]).reshape((dcn, ici)
                                                  + d[k].shape[1:])
                        for k in names])
    _JAX_CACHE[n] = jax.tree.map(
        lambda a: np.asarray(a).reshape((n,) + a.shape[2:]), got)
    return _JAX_CACHE[n]


def test_mesh_decides_the_block(worlds):
    """The inner domain is the last live axis (the mesh's block) for the
    collectives under the knob and always for the int8 optimizer; a
    layout of one live axis gives none; the axes given name it even at
    one rank."""
    for n, (dcn, ici) in LAYOUTS.items():
        for out in worlds[n]:
            assert out["axes_block"] == ici
            assert out["mesh_block"] == (ici if ici > 1 else 0)
            want = ici if ici > 1 else 1
            assert out["two_level"] == want, (n, out["two_level"])
    assert hier.mesh_block(pm.Mesh(("dcn", "ici"), (2, 2))) == 2
    assert hier.mesh_block(pm.Mesh(("dp", "tp", "sp"), (2, 4, 1))) == 4
    assert hier.mesh_block(pm.Mesh(("dp",), (8,))) == 0
    with pytest.raises(ValueError, match="order"):
        hier.axes_block(("ici", "dcn"), pm.Mesh(("dcn", "ici"), (2, 2)))
    with pytest.raises(ValueError, match="left out"):
        hier.axes_block(("dcn",), pm.Mesh(("dcn", "ici"), (2, 2)))


def test_two_axis_hierarchy_matches_flat(worlds):
    want = _jax_results(8)
    for r, out in enumerate(worlds[8]):
        for got in (out["psum"], out["knob_sum"]):
            np.testing.assert_allclose(got.numpy(), want["psum"][r],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), want["flat"][r],
                                       rtol=1e-5, atol=1e-5)


def test_two_axis_allgather_matches_flat(worlds):
    want = _jax_results(8)["gather"]
    g = _data(8)["g"]
    for r, out in enumerate(worlds[8]):
        for got in (out["gather"], out["knob_gather"]):
            np.testing.assert_array_equal(got.numpy(), want[r])
            np.testing.assert_array_equal(got.numpy(), g.reshape(16, 3))


@pytest.mark.parametrize("n", [6, 5])
@pytest.mark.parametrize("i", range(len(Q_SHAPES)))
def test_nonpow2_pods_int8_outer_leg(worlds, n, i):
    want = _jax_results(n)
    n_pods = LAYOUTS[n][0]
    for r, out in enumerate(worlds[n]):
        ref = want["q_flat"][i][r]
        tol = n_pods * np.abs(ref).max() / 127.0 + 1e-5
        got = out["int8"][i].numpy()
        assert got.shape == Q_SHAPES[i]
        np.testing.assert_allclose(got, ref, atol=tol)
        np.testing.assert_allclose(got, want["int8"][i][r], atol=tol)


@pytest.mark.parametrize("n", [3, 5])
def test_nonpow2_pods_int8_error_feedback_residual(worlds, n):
    ref = _jax_results(n)["e_flat"][0]
    tol = n * np.abs(ref).max() / 127.0 + 1e-5
    for out in worlds[n]:
        y1, y2 = out["ef"]
        assert np.abs(y1.numpy() - ref).max() <= tol
        assert np.abs(y2.numpy() - ref).max() <= 2 * tol


def test_launcher_no_longer_refuses_the_mesh():
    """Queue A entry 11 is ported whole: no launcher flag names it."""
    from horovod_tpu_torch.runner import launch

    assert 11 not in launch.ENTRIES
    assert 11 not in launch.UNPORTED.values()


def test_int8_optimizer_takes_the_mesh_block(worlds):
    for out in worlds[6]:
        block, trace = out["opt_mesh"]
        one_block, one_trace = out["opt_one_axis"]
        assert block == one_block == 2
        for a, b in zip(trace, one_trace):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        assert out["sharded_refusal"] is not None
        assert "exactly one data-parallel axis" in out["sharded_refusal"]
        assert "('dcn', 'ici')" in out["sharded_refusal"]
