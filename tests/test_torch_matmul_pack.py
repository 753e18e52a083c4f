"""The port's matmul with the ring-row epilogue (B15's plain version),
``matmul_reduce_scatter`` and the reduce-scatter collectives against
the JAX package.

* ``matmul_pack`` on the CPU against the JAX package's ``_matmul_pack``
  (the Pallas kernel in interpret mode) at the JAX test's 24 x 33 @ 33
  x 16 and at a ragged 20 x 13 @ 13 x 11 (the shape of the card's
  ragged bf16 case: M no tile multiple, K and N odd) for n in {1, 2, 3,
  4, 8}: bitwise on integer-valued operands in
  [-4, 4] (every partial sum is an exact float32 integer, whatever the
  order), float32 and bf16; within 1e-5 relative on random float32
  operands (the two sum the products in different orders); the padding
  exactly zero;
* worlds of two and four processes over gloo against the JAX package in
  ``shard_map`` on a mesh of the same size:
  - ``matmul_reduce_scatter`` on the float32, bf16 and int8 (block 32)
    wires, and int8 with an error-feedback residual (shard and new
    residual), on integer-valued operands: bitwise on the float32 and
    int8 wires; the bf16 wire within one bf16 rounding of each shard
    value (its sum may be taken in another order or width); random
    float32 operands on the float32 wire within 1e-5 relative;
  - ``reducescatter`` (Sum, Average, pre/postscale, float32 and int32),
    ``grouped_reducescatter`` and the async forms against JAX's
    ``reducescatter``: bitwise at world 2 and on integers, within 1e-6
    relative on floats at world 4; a dim 0 that the world does not
    divide raises, as in the JAX package;
* a 3-D operand raises the JAX package's ``ValueError``;
* the tiling ``ops/ring_pack.py`` exports (``chip_smoke.py`` emulates a
  kernel that skips its last K tile with it) is the ``constexpr``
  tiling of ``csrc/matmul_pack.cu``.
"""

import os
import pathlib
import re
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
from horovod_tpu.ops import pallas_collectives as jpc
from horovod_tpu.optim import compression as jcomp
from horovod_tpu_torch.ops import ring_pack

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
BLOCK = 32
M, K, N = 24, 33, 16
#: (M, K, N) of test_matmul_pack_matches_jax: the JAX test's shape, and a
#: ragged one (M no multiple of a tile, K and N odd)
SHAPES = ((M, K, N), (20, 13, 11))


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    yield
    hvd.shutdown()


def _operands(rs, dtype, integer, lead=(), shape=(M, K, N)):
    m, k, n = shape
    if integer:
        a = rs.randint(-4, 5, lead + (m, k)).astype(np.float32)
        b = rs.randint(-4, 5, lead + (k, n)).astype(np.float32)
    else:
        a = rs.randn(*lead, m, k).astype(np.float32)
        b = rs.randn(*lead, k, n).astype(np.float32)
    return a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_matmul_pack_matches_jax(dtype, n):
    rs = np.random.RandomState(n)
    for shape in SHAPES:
        for integer in (True, False):
            if dtype == "bfloat16" and not integer:
                continue
            a, b = _operands(rs, dtype, integer, shape=shape)
            ta = torch.from_numpy(a).to(getattr(torch, dtype))
            tb = torch.from_numpy(b).to(getattr(torch, dtype))
            want = np.asarray(jpc._matmul_pack(
                jnp.asarray(a).astype(getattr(jnp, dtype)),
                jnp.asarray(b).astype(getattr(jnp, dtype)), n))
            got = ring_pack.matmul_pack(ta, tb, n)
            assert (got.dtype == torch.float32
                    and tuple(got.shape) == want.shape)
            flat = got.reshape(-1).numpy()
            assert (flat[shape[0] * shape[2]:] == 0).all()
            if integer:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=1e-5)


def _constexprs(src):
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_exported_tiling_is_the_kernel():
    """``ops/ring_pack.py``'s B15 tiling is ``csrc/matmul_pack.cu``'s:
    the bf16 kernel's block tile and ring depth, and the float32
    kernel's K tile. A wgmma m64n128k16 block of two consumer
    warpgroups covers 128 x 128, and a stage is whole k16 steps of
    128-byte rows."""
    src = (REPO / "horovod_tpu_torch" / "csrc" / "matmul_pack.cu"
           ).read_text()
    c = _constexprs(src)
    assert ring_pack.MATMUL_TILE_M == c["kTileM"] == 64 * c["kConsumers"]
    assert ring_pack.MATMUL_TILE_N == c["kTileN"]
    assert ring_pack.MATMUL_TILE_K == c["kTileK"]
    assert "m64n%dk16" % ring_pack.MATMUL_TILE_N in src
    assert ring_pack.MATMUL_TILE_K % 16 == 0
    assert ring_pack.MATMUL_TILE_K * 2 == 128  # one swizzled row
    assert ring_pack.MATMUL_F32_TILE_K == int(
        re.search(r"constexpr int kBM = \d+, kBN = \d+, kBK = (\d+)",
                  src).group(1))


def test_two_dimensional_operands_only():
    a3, b = torch.zeros(2, 3, 4), torch.zeros(4, 5)
    with pytest.raises(ValueError, match="2-D operands"):
        ring_pack.matmul_reduce_scatter(a3, b, 2)
    with pytest.raises(ValueError, match="2-D operands"):
        jpc.matmul_reduce_scatter(jnp.zeros((2, 3, 4)), jnp.zeros((4, 5)),
                                  "hvd", 2)
    with pytest.raises(ValueError, match="CUDA"):
        ring_pack.matmul_pack_cuda(torch.zeros(3, 4), torch.zeros(4, 5), 2)


_WORKER = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import ring_pack
from horovod_tpu_torch.optim.compression import parse_wire

out = sys.argv[1]
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
d = dict(np.load(out + "/data.npz"))
t = {k: torch.from_numpy(v[r]) for k, v in d.items()}
res = {}
for key, wire in (("none", None), ("bf16", parse_wire("bf16")),
                  ("int8", parse_wire("int8", int(sys.argv[2])))):
    res["mrs_" + key] = ring_pack.matmul_reduce_scatter(t["ai"], t["bi"], n,
                                                        wire=wire)
res["mrs_int8_ef"] = ring_pack.matmul_reduce_scatter(
    t["ai"], t["bi"], n, wire=parse_wire("int8", int(sys.argv[2])),
    residual=t["res"])
res["mrs_float"] = ring_pack.matmul_reduce_scatter(t["af"], t["bf"], n)
x, xi = t["x"], t["xi"]
for op in ("Sum", "Average"):
    o = getattr(hvd, op)
    res["rs_" + op] = hvd.reducescatter(x, op=o)
    res["rs_scaled_" + op] = hvd.reducescatter(x, op=o, prescale_factor=0.5,
                                               postscale_factor=3.0)
    res["rs_int_" + op] = hvd.reducescatter(xi, op=o)
    res["grouped_" + op] = hvd.grouped_reducescatter([x, xi, t["x2"]], op=o)
    res["async_" + op] = hvd.synchronize(hvd.reducescatter_async(x, op=o))
    res["grouped_async_" + op] = hvd.synchronize(
        hvd.grouped_reducescatter_async([x, xi, t["x2"]], op=o))
res["default_op"] = hvd.reducescatter(x)
assert torch.equal(x, t["x"])  # the input is left alone
try:
    hvd.reducescatter(torch.zeros(2 * n + 1, 3))
    res["uneven"] = None
except hvd.HorovodInternalError as e:
    res["uneven"] = str(e)
try:
    hvd.reducescatter(x, op=hvd.Max)
    res["max"] = None
except ValueError as e:
    res["max"] = str(e)
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _data(n):
    rs = np.random.RandomState(10 + n)
    ai, bi = _operands(rs, "float32", True, (n,))
    af, bf = _operands(rs, "float32", False, (n,))
    k = -(-M * N // n)
    k2 = -(-k // BLOCK) * BLOCK
    return {"ai": ai, "bi": bi, "af": af, "bf": bf,
            "res": (rs.randn(n, n, k2) * 1e-2).astype(np.float32),
            "x": rs.randn(n, 2 * n, 3).astype(np.float32),
            "xi": rs.randint(-50, 50, (n, 2 * n, 5)).astype(np.int32),
            "x2": rs.randn(n, 4 * n).astype(np.float32)}


def _jax_reference(n, d):
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
    jhvd.init(mesh=mesh)

    def run(fn, *args):
        return jax.jit(shard_map(
            lambda *a: jax.tree.map(lambda y: y[None],
                                    fn(*[x[0] for x in a])),
            mesh=mesh, in_specs=tuple(P("hvd") for _ in args),
            out_specs=P("hvd"), check_vma=False))(*args)

    j = {k: jnp.asarray(v) for k, v in d.items()}
    want = {}
    for key, wire in (("none", None), ("bf16", jcomp.parse_wire("bf16")),
                      ("int8", jcomp.parse_wire("int8", BLOCK))):
        want["mrs_" + key] = run(
            lambda a, b, w=wire: jpc.matmul_reduce_scatter(
                a, b, "hvd", n, wire=w), j["ai"], j["bi"])
    want["mrs_int8_ef"] = run(lambda a, b, r: jpc.matmul_reduce_scatter(
        a, b, "hvd", n, wire=jcomp.parse_wire("int8", BLOCK), residual=r),
        j["ai"], j["bi"], j["res"])
    want["mrs_float"] = run(lambda a, b: jpc.matmul_reduce_scatter(
        a, b, "hvd", n), j["af"], j["bf"])
    for op in ("Sum", "Average"):
        o = getattr(jhvd, op)
        want["rs_" + op] = run(lambda x, o=o: jhvd.reducescatter(x, op=o),
                               j["x"])
        want["rs_scaled_" + op] = run(lambda x, o=o: jhvd.reducescatter(
            x, op=o, prescale_factor=0.5, postscale_factor=3.0), j["x"])
        want["rs_int_" + op] = run(lambda x, o=o: jhvd.reducescatter(
            x, op=o), j["xi"])
        want["grouped_" + op] = run(
            lambda x, xi, x2, o=o: tuple(jhvd.grouped_reducescatter(
                [x, xi, x2], op=o)), j["x"], j["xi"], j["x2"])
    return {k: jax.tree.map(np.asarray, v) for k, v in want.items()}


def _eq(got, want, what):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("n", [2, 4])
def test_world_against_jax(n, tmp_path):
    d = _data(n)
    np.savez(tmp_path / "data.npz", **d)
    port = _free_port()
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path), str(BLOCK)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        want = _jax_reference(n, d)
    finally:
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            finally:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(n)]
    float_rtol = 0.0 if n == 2 else 1e-6
    for r in range(n):
        got = res[r]
        for key in ("mrs_none", "mrs_int8"):
            _eq(got[key], want[key][r], f"{key} rank {r}")
        shard, new_res = got["mrs_int8_ef"]
        _eq(shard, want["mrs_int8_ef"][0][r], f"int8+EF shard rank {r}")
        _eq(new_res, want["mrs_int8_ef"][1][r], f"int8+EF residual rank {r}")
        # bf16: one bf16 rounding of the shard's magnitude
        w = want["mrs_bf16"][r].astype(np.float32)
        g = got["mrs_bf16"].float().numpy()
        assert got["mrs_bf16"].dtype == torch.float32
        assert np.abs(g - w).max() <= 2.0 ** -8 * np.abs(w).max()
        np.testing.assert_allclose(got["mrs_float"].numpy(),
                                   want["mrs_float"][r], rtol=1e-5,
                                   atol=1e-5)
        for op in ("Sum", "Average"):
            for key in ("rs_", "rs_scaled_", "async_"):
                w = want[("rs_" if key == "async_" else key) + op][r]
                np.testing.assert_allclose(got[key + op].numpy(), w,
                                           rtol=float_rtol, atol=0)
                assert got[key + op].shape == w.shape
            _eq(got["rs_int_" + op], want["rs_int_" + op][r],
                f"int {op} rank {r}")
            for key in ("grouped_", "grouped_async_"):
                for i, (g, w) in enumerate(zip(got[key + op],
                                               want["grouped_" + op])):
                    assert g.shape == w[r].shape, (key, i)
                    np.testing.assert_allclose(g.numpy(), w[r],
                                               rtol=float_rtol, atol=0)
        np.testing.assert_array_equal(got["default_op"].numpy(),
                                      got["async_Average"].numpy())
        assert "not divisible by set size" in got["uneven"]
        assert "Sum and Average" in got["max"]
    with pytest.raises(Exception, match="not divisible by set size"):
        mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
        jax.jit(shard_map(lambda x: jhvd.reducescatter(x[0])[None],
                          mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd"),
                          check_vma=False))(jnp.zeros((n, 2 * n + 1, 3)))
