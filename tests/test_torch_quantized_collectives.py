"""The int8 wire's kernels and collectives against the JAX package.

The plain PyTorch versions of B11-B14 (``ops/quantized_collectives.py``,
the versions the CPU runs and the card's kernels are held against in
``chip_smoke.py``) meet the JAX package's Pallas kernels of
``ops/pallas_collectives.py``, run in interpret mode on the CPU, on the
same numpy inputs, bitwise:

* B11 ``_quantize_rows`` and B12 ``_quantize_ef_rows`` (codes, scales,
  residual), B13 ``_accum_rows`` for n in {1, 2, 4, 8}, B14
  ``_dequantize_flat``, at blocks 32 and 256, with all-zero blocks,
  values whose x / scale lands on k + 0.5, both signs of the block's
  amax (code +-127) and a ragged length;
* ``block_quantize`` against the JAX package's ``block_quantize``.

XLA on the CPU contracts the dequantize multiply into the residual's
subtraction and into the running sum over ranks (one rounding each),
which the port's kernels and plain versions do as well. It also flushes
subnormal floats to zero, which the port does not (the card keeps them,
as IEEE arithmetic does): a block whose amax is subnormal quantizes to
zero codes and scale 1 in the JAX package and to its own codes here.
That case is held to what each side must give, not bitwise
(``test_subnormal_block``; ROADMAP.md section C).

Then the collectives in worlds of 1, 2 and 4 processes over gloo:
``quantized_psum`` (777 elements, block 32, with and without a
residual, a 3-step residual trajectory) and
``quantized_reduce_scatter_rows`` (k = 100, block 32, likewise), each
against the JAX function under ``shard_map`` on ``Mesh(jax.devices()
[:n])`` with the Pallas backend on, outputs and residuals bitwise; and
the same world emulated in one process (``emulated_quantized_psum``,
the composition ``chip_smoke.py`` runs on one card), bitwise.
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

from horovod_tpu.compat import shard_map
from horovod_tpu.ops import pallas_collectives as pc
from horovod_tpu.optim import compression as jcomp
from horovod_tpu_torch.ops import quantized_collectives as qc
from horovod_tpu_torch.optim import compression as tcomp

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _eq(got, want, what):
    """Exact equality of values and shapes (a float -0 equals +0)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != " \
                                    f"{want.shape}"
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    bad = np.flatnonzero(got.reshape(-1) != want.reshape(-1))
    assert bad.size == 0, (f"{what}: {bad.size} of {got.size} differ, first "
                           f"at {bad[0]}: {got.reshape(-1)[bad[0]]} vs "
                           f"{want.reshape(-1)[bad[0]]}")


def _payload(block, nblocks, seed):
    """``nblocks`` blocks of ``block`` float32 values: random blocks of
    several magnitudes, an all-zero block, a block of values at k + 0.5
    of its scale, and blocks whose amax is negative and positive."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(nblocks, block)
         * 10.0 ** rs.uniform(-4, 2, (nblocks, 1))).astype(np.float32)
    x[1] = 0.0
    amax = np.float32(3.7)
    s = np.float32(amax * np.float32(1.0 / 127.0))
    k = np.arange(block) % 120 - 60
    x[2] = (k + np.float32(0.5)).astype(np.float32) * s
    x[2, 0] = amax
    x[3, 5] = -np.abs(x[3]).max() * 1.5
    ties = np.float32(x[2]) / s
    assert (ties == np.round(ties) + 0.5).sum() > block // 4  # real ties
    return x


@pytest.mark.parametrize("block", [32, 256])
def test_block_quantize_bitwise(block):
    x = _payload(block, 6, 0)
    q, s = jcomp.block_quantize(jnp.asarray(x))
    tq, ts = tcomp.block_quantize(torch.from_numpy(x))
    _eq(tq, q, "codes")
    _eq(ts, s, "scales")


@pytest.mark.parametrize("block", [32, 256])
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("length", [None, -37])
def test_quantize_rows_ref_matches_pallas(block, n, length):
    """B11 and B12: the payload (``length`` short of full rows: ragged),
    padded to n rows; with a residual, the new residual bitwise."""
    x = _payload(block, 4 * n, 1).reshape(-1)
    r = (np.random.RandomState(2).randn(x.size) * 1e-2).astype(np.float32)
    if length is not None:
        x, r = x[:length], r[:length]
    pad = -x.size % (n * block)
    rows = jnp.asarray(np.pad(x, (0, pad)).reshape(n, -1))
    q, s = pc._quantize_rows(rows, block)
    tq, ts = qc.quantize_rows_ref(torch.from_numpy(x), n, block)
    _eq(tq, q, "B11 codes")
    _eq(ts, s, "B11 scales")

    rows_ef = jnp.pad(jnp.asarray(x) + jnp.asarray(r), (0, pad)).reshape(n,
                                                                        -1)
    q, s, e = pc._quantize_ef_rows(rows_ef, block)
    tq, ts, te = qc.quantize_ef_rows_ref(torch.from_numpy(x),
                                         torch.from_numpy(r), n, block)
    _eq(tq, q, "B12 codes")
    _eq(ts, s, "B12 scales")
    _eq(te, np.asarray(e).reshape(-1)[:x.size], "B12 residual")


@pytest.mark.parametrize("block", [32, 256])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_accum_rows_ref_matches_pallas(block, n):
    """B13: the n ranks' shards summed in rank order, bitwise."""
    rs = np.random.RandomState(3 + n)
    c = block * 5
    q = rs.randint(-127, 128, (n, c)).astype(np.int8)
    q[:, :block] = 0  # an all-zero block on every rank
    s = (10.0 ** rs.uniform(-5, 1, (n, c // block))).astype(np.float32)
    s[:, 0] = 1.0
    want = pc._accum_rows(jnp.asarray(q), jnp.asarray(s), block)
    got = qc.accum_rows_ref(torch.from_numpy(q), torch.from_numpy(s), block)
    _eq(got, want, "B13")


@pytest.mark.parametrize("c,block,q_off,out_off,route", [
    (1024 * 256, 256, 0, 0, 16),  # block 256, as on the main path
    (160, 32, 0, 0, 16),
    (160, 16, 0, 0, 16),
    (120, 40, 0, 0, 1),          # C and block not multiples of 16
    (160, 40, 0, 0, 1),          # C is, block is not
    (96, 8, 0, 0, 1),            # block 8: 16 codes span two scales
    (160, 32, 1, 0, 1),          # codes 1 byte off alignment
    (160, 32, 16, 0, 16),        # codes 16 bytes on: aligned
    (160, 32, 0, 4, 1),          # output 4 bytes off alignment
])
def test_accum_route(c, block, q_off, out_off, route):
    """B13 takes its vector route (16 codes a thread, 16-byte loads and
    stores) only when C and the block are multiples of 16 and the codes
    and the output start 16-byte aligned; anything else goes one element
    a thread."""
    n = 3
    qbuf = torch.zeros(n * c + 64, dtype=torch.int8)
    base = (-qbuf.data_ptr()) % 16
    q = qbuf[base + q_off:base + q_off + n * c].view(n, c)
    s = torch.ones(n, c // block)
    obuf = torch.zeros(c + 16)
    obase = ((-obuf.data_ptr()) % 16) // 4
    out = obuf[obase + out_off // 4:obase + out_off // 4 + c]
    assert qc.accum_route(q, s, out, block) == route


def test_accum_route_codes_are_the_kernels():
    """The route's width is the vector kernel's ``kCodes``, and the entry
    point refuses the vector route where the wrapper would not take it."""
    src = (REPO / "horovod_tpu_torch" / "csrc" / "accum_rows.cu").read_text()
    assert f"constexpr int kCodes = {qc.ACCUM_CODES};" in src
    assert "if (C % kCodes != 0 || block % kCodes != 0 ||" in src
    assert "accum_kernel<kCodes><<<" in src and "accum_kernel<1><<<" in src


@pytest.mark.parametrize("block", [32, 256])
def test_dequantize_flat_ref_matches_pallas(block):
    """B14, whole and cut to a ragged length."""
    x = _payload(block, 5, 4).reshape(-1)
    q, s = jcomp.quantize_blocks(jnp.asarray(x), block)
    want = np.asarray(pc._dequantize_flat(q, s, block))
    tq, ts = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))
    _eq(qc.dequantize_flat_ref(tq, ts, block), want, "B14")
    _eq(qc.dequantize_flat_ref(tq, ts, block, x.size - 19),
        want[:x.size - 19], "B14 ragged")


def _round_f32(e):
    """The float32 nearest the rational ``e``, ties to even."""
    from fractions import Fraction

    f = np.float32(float(e))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - e),
                                     int(np.array(c).view(np.int32)) & 1))


def test_fma_is_correctly_rounded():
    """The plain versions' fused step ``a * b + c`` against exact rational
    arithmetic: random codes, scales and addends many binades apart
    (where the float64 sum is inexact), and products that sit exactly on
    a float32 midpoint with a tiny addend that decides the rounding,
    where rounding the float64 sum to float32 would round to even."""
    from fractions import Fraction

    rs = np.random.RandomState(5)
    n = 300
    a = rs.randint(-127, 128, n).astype(np.float32)
    b = (rs.uniform(0.5, 1, n) * 2.0 ** rs.randint(-60, 60, n)).astype(
        np.float32)
    c = (rs.randn(n) * 2.0 ** rs.randint(-90, 90, n)).astype(np.float32)
    # midpoints: 3 * b has 26 bits; keep those exactly halfway between
    # two float32 values, and add a tiny c of either sign
    bm = rs.uniform(1, 2, 4000).astype(np.float32)
    p = 3.0 * bm.astype(np.float64)
    r = p.astype(np.float32).astype(np.float64)
    mid = np.abs(r - p) == np.spacing(p.astype(np.float32)) / 2
    bm = bm[mid][:100]
    cm = (np.abs(3.0 * bm) * 2.0 ** -60 * rs.choice([-1, 1], bm.size)).astype(
        np.float32)
    a = np.concatenate([a, np.full(bm.size, 3, np.float32)])
    b, c = np.concatenate([b, bm]), np.concatenate([c, cm])
    got = qc._fma(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    _eq(got, want, "fma")
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).sum() > 10  # the midpoint cases bite


def test_subnormal_block():
    """A block whose amax is subnormal: the JAX package (XLA on the CPU
    flushes subnormals to zero) gives zero codes and scale 1; the port
    keeps IEEE subnormals and gives the block's codes and a subnormal
    scale. Both reconstruct each value within their scale's half step,
    and the normal blocks beside it stay bitwise equal."""
    block = 32
    x = _payload(block, 4, 6)
    x[0] = np.float32(3e-39) * np.linspace(-1, 1, block, dtype=np.float32)
    q, s = jcomp.block_quantize(jnp.asarray(x))
    tq, ts = tcomp.block_quantize(torch.from_numpy(x))
    assert float(s[0]) == 1.0 and not np.asarray(q[0]).any()
    assert 0 < float(ts[0]) < np.finfo(np.float32).tiny
    assert int(tq[0].abs().max()) == 127
    deq = tcomp.block_dequantize(tq, ts).numpy()
    assert (np.abs(deq[0] - x[0]) <= float(ts[0]) / 2).all()
    _eq(tq[1:], q[1:], "normal blocks' codes")
    _eq(ts[1:], s[1:], "normal blocks' scales")


# ---------------------------------------------------------------------------
# the collectives in worlds of 1, 2 and 4 over gloo
# ---------------------------------------------------------------------------

_WORKER = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.optim import compression as comp

out = sys.argv[1]
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
data = np.load(out + "/inputs.npz")
res = {}
residual = torch.zeros(777)
for t in range(3):
    x = torch.from_numpy(data["psum"][t, r])
    res[f"psum_plain_{t}"] = comp.quantized_psum(x, n, 32)
    y, residual = comp.quantized_psum(x, n, 32, residual=residual)
    res[f"psum_{t}"], res[f"psum_res_{t}"] = y, residual
k2 = -(-100 // 32) * 32
residual = torch.zeros(n, k2)
for t in range(3):
    rows = torch.from_numpy(data["rs"][t, r])
    res[f"rs_plain_{t}"] = comp.quantized_reduce_scatter_rows(rows, 32)
    shard, residual = comp.quantized_reduce_scatter_rows(
        rows, 32, residual=residual)
    res[f"rs_{t}"], res[f"rs_res_{t}"] = shard, residual
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n, script, args, extra_env=None):
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
                   OMP_NUM_THREADS="1", **(extra_env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, *args], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _join(procs, timeout=120):
    for p in procs:
        try:
            out = p.communicate(timeout=timeout)[0]
        finally:
            p.kill()
        assert p.returncode == 0, out


def _jax_trajectories(n, psum_in, rs_in):
    """The JAX package's quantized_psum and quantized_reduce_scatter_rows
    (Pallas backend) over a mesh of n devices, 3 steps, with and without
    a residual."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))

    def run(fn, outs):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("hvd"),) * 2,
                                 out_specs=outs, check_vma=False))

    psum_ef = run(lambda v, r: tuple(a[None] for a in jcomp.quantized_psum(
        v[0], "hvd", n, 32, residual=r[0])), (P("hvd"), P("hvd")))
    psum = run(lambda v, _: jcomp.quantized_psum(v[0], "hvd", n, 32)[None],
               P("hvd"))
    rs_ef = run(lambda v, r: tuple(
        a[None] for a in jcomp.quantized_reduce_scatter_rows(
            v[0], "hvd", 32, residual=r[0])), (P("hvd"), P("hvd")))
    rs = run(lambda v, _: jcomp.quantized_reduce_scatter_rows(
        v[0], "hvd", 32)[None], P("hvd"))
    want = {}
    res = jnp.zeros((n, 777), jnp.float32)
    for t in range(3):
        x = jnp.asarray(psum_in[t])
        want[f"psum_plain_{t}"] = np.asarray(psum(x, res))
        y, res = psum_ef(x, res)
        want[f"psum_{t}"], want[f"psum_res_{t}"] = map(np.asarray, (y, res))
    res = jnp.zeros((n, n, 128), jnp.float32)
    for t in range(3):
        rows = jnp.asarray(rs_in[t])
        want[f"rs_plain_{t}"] = np.asarray(rs(rows, res))
        s, res = rs_ef(rows, res)
        want[f"rs_{t}"], want[f"rs_res_{t}"] = map(np.asarray, (s, res))
    return want


@pytest.mark.parametrize("n", [1, 2, 4])
def test_collectives_match_jax(n, tmp_path, monkeypatch):
    rs = np.random.RandomState(10 + n)
    psum_in = rs.randn(3, n, 777).astype(np.float32)
    rs_in = rs.randn(3, n, n, 100).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", psum=psum_in, rs=rs_in)
    procs = _spawn(n, _WORKER, [str(tmp_path)])
    # the JAX package's Pallas backend: the kernels the port replaces
    monkeypatch.setenv("HOROVOD_FUSED_COLLECTIVES", "1")
    try:
        want = _jax_trajectories(n, psum_in, rs_in)
    finally:
        _join(procs)
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]
    for key, w in want.items():
        for r in range(n):
            _eq(got[r][key], w[r], f"world {n} rank {r} {key}")
    # the world emulated in one process (as chip_smoke.py runs it on one
    # card) composes the same stages to the same bits
    res = [torch.zeros(777)] * n
    for t in range(3):
        sums, res = qc.emulated_quantized_psum(
            [torch.from_numpy(psum_in[t, r]) for r in range(n)], n, 32, res)
        for r in range(n):
            _eq(sums[r], want[f"psum_{t}"][r], f"emulated {n} rank {r} {t}")
            _eq(res[r], want[f"psum_res_{t}"][r], f"emulated residual {t}")
    # the residual carried: non-zero and changing
    assert np.abs(want["psum_res_2"]).max() > 0
    assert not np.array_equal(want["psum_res_1"], want["psum_res_2"])
