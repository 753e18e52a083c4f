"""Plain versions of the PyTorch port's kernels against the JAX package.

Each kernel of ``horovod_tpu_torch`` has a plain PyTorch version that
the CPU runs and the card's kernel is held against (``chip_smoke.py``).
Here those plain versions meet the JAX package on the same numpy
inputs:

* the fused LayerNorm/RMSNorm forward vs the Pallas kernel (interpret
  mode on the CPU): float32 within 1e-6, bfloat16 within one bf16 ulp;
* its backward (dx, dgamma, dbeta) vs ``jax.vjp`` of the Pallas
  kernels, with and without beta, float32 and bfloat16;
* the int8 block quantize/dequantize, bitwise;
* the decode append+attend vs the Pallas append+attend kernels forced
  on (float32, bfloat16 and int8 caches, GQA, T=1, 8, 16 and 20,
  repeated positions and positions past the cache): merged buffers,
  codes and scales bitwise, the float32 output within 1e-6;
* the kernels' exported tiling and partitions against their sources.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_collectives as pc
from horovod_tpu.ops.pallas_layernorm import \
    fused_layer_norm as jax_fused_layer_norm
from horovod_tpu.optim import compression as jcomp
from horovod_tpu.serving.decode import KVCacheSpec as JaxSpec
from horovod_tpu.serving.decode import SlottedKVCache as JaxCache
from horovod_tpu_torch.ops import batchnorm as bn_mod
from horovod_tpu_torch.ops import decode_attention as tda
from horovod_tpu_torch.ops import layernorm as ln_mod
from horovod_tpu_torch.ops.layernorm import (fused_layer_norm,
                                              layer_norm_bwd_cuda,
                                              layer_norm_bwd_ref)
from horovod_tpu_torch.optim import compression as tcomp
from horovod_tpu_torch.serving.decode import KVCacheSpec, SlottedKVCache

torch.set_num_threads(1)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a).astype(np.float32)


def _bf16_ulp(x):
    """Spacing of bfloat16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


# ---------------------------------------------------------------------------
# B4: LayerNorm / RMSNorm forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,with_beta", [("layernorm", True),
                                            ("layernorm", False),
                                            ("rmsnorm", False)])
@pytest.mark.parametrize("rows,c", [(13, 40), (5, 1000), (3, 4096),
                                    (2, 8192)])
def test_layer_norm_ref_matches_pallas(dtype, kind, with_beta, rows, c):
    """13 rows (not a multiple of 8) of 40 channels (lane-padded on the
    TPU), and a few rows at the widths of the card kernel's routes: C =
    1000 (a ragged last chunk), 4096 (128 columns a lane) and 8192 (a
    block a row): float32 within 1e-6, bfloat16 within one bf16 ulp."""
    rs = np.random.RandomState(0)
    x = (rs.randn(rows, c) * 3 + 1.5).astype(np.float32)
    g = (1 + 0.1 * rs.randn(c)).astype(np.float32)
    b = (0.1 * rs.randn(c)).astype(np.float32) if with_beta else None
    xj = jnp.asarray(x).astype(_JNP[dtype])
    want = jax_fused_layer_norm(
        xj, jnp.asarray(g), None if b is None else jnp.asarray(b),
        eps=1e-5, kind=kind)
    xt = torch.from_numpy(x).to(_TORCH[dtype])
    got = fused_layer_norm(xt, torch.from_numpy(g),
                           None if b is None else torch.from_numpy(b),
                           eps=1e-5, kind=kind)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    want, got = _to_f32(want), _to_f32(got)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
            "bf16 LayerNorm differs by more than one bf16 ulp"


def test_layer_norm_rejects_bad_kind_and_rms_beta():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="unknown kind"):
        fused_layer_norm(x, torch.ones(8), kind="batchnorm")
    with pytest.raises(ValueError, match="no beta"):
        fused_layer_norm(x, torch.ones(8), torch.zeros(8), kind="rmsnorm")


# ---------------------------------------------------------------------------
# B5: LayerNorm / RMSNorm backward
# ---------------------------------------------------------------------------

def _ulps_apart(a, b):
    """Distance in bf16 ulps of the larger magnitude, per element."""
    mag = np.maximum(np.abs(a), np.abs(b))
    return np.abs(a - b) / _bf16_ulp(mag)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,with_beta", [("layernorm", True),
                                            ("layernorm", False),
                                            ("rmsnorm", False)])
def test_layer_norm_backward_matches_pallas(dtype, kind, with_beta):
    """dx, dgamma, dbeta through the port's autograd (the plain version
    of B5 on the CPU) against ``jax.vjp`` of the Pallas kernels in
    interpret mode: 13 rows (not a tile multiple) of 40 channels.
    float32: dx within 2e-6, dgamma/dbeta within 1e-5 (sums in another
    order). bfloat16: dx within one bf16 ulp of the larger value plus
    1e-6 (outputs near 0 come from cancelling terms), dgamma/dbeta
    (float32 sums of bf16 inputs) within 1e-4."""
    rs = np.random.RandomState(1)
    x = (rs.randn(13, 40) * 3 + 1.5).astype(np.float32)
    g = (1 + 0.1 * rs.randn(40)).astype(np.float32)
    b = (0.1 * rs.randn(40)).astype(np.float32) if with_beta else None
    dy = rs.randn(13, 40).astype(np.float32)
    jx = jnp.asarray(x).astype(_JNP[dtype])
    jdy = jnp.asarray(dy).astype(_JNP[dtype])
    if b is None:
        _, vjp = jax.vjp(lambda x_, g_: jax_fused_layer_norm(
            x_, g_, None, eps=1e-5, kind=kind), jx, jnp.asarray(g))
    else:
        _, vjp = jax.vjp(lambda x_, g_, b_: jax_fused_layer_norm(
            x_, g_, b_, eps=1e-5, kind=kind), jx, jnp.asarray(g),
            jnp.asarray(b))
    want = vjp(jdy)

    tx = torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    y = fused_layer_norm(tx, tg, tb, eps=1e-5, kind=kind)
    y.backward(torch.from_numpy(dy).to(_TORCH[dtype]))
    got = [tx.grad, tg.grad] + ([] if tb is None else [tb.grad])
    assert got[0].dtype == tx.dtype and got[1].dtype == torch.float32
    assert len(got) == len(want)
    dx, jdx = _to_f32(got[0]), _to_f32(want[0])
    if dtype == "float32":
        np.testing.assert_allclose(dx, jdx, rtol=0, atol=2e-6)
        sum_tol = 1e-5
    else:
        assert np.all((np.abs(dx - jdx) <= _bf16_ulp(
            np.maximum(np.abs(dx), np.abs(jdx))) + 1e-6)), \
            f"bf16 dx off by {_ulps_apart(dx, jdx).max()} ulps"
        sum_tol = 1e-4
    for t, j in zip(got[1:], want[1:]):
        np.testing.assert_allclose(_to_f32(t), _to_f32(j), rtol=0,
                                   atol=sum_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_backward_wide_ragged_row_matches_pallas(dtype):
    """C = 1000, not a multiple of 32 x 8 (the card's kernel takes its
    one-element loads or a partial last chunk there): the plain version
    of B5 against ``jax.vjp`` of the Pallas kernels, 9 rows, with beta;
    tolerances as in the 40-channel case."""
    rs = np.random.RandomState(5)
    x = (rs.randn(9, 1000) * 3 + 1.5).astype(np.float32)
    g = (1 + 0.1 * rs.randn(1000)).astype(np.float32)
    b = (0.1 * rs.randn(1000)).astype(np.float32)
    dy = rs.randn(9, 1000).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, g_, b_: jax_fused_layer_norm(
        x_, g_, b_, eps=1e-5, kind="layernorm"),
        jnp.asarray(x).astype(_JNP[dtype]), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(dy).astype(_JNP[dtype]))
    got = layer_norm_bwd_ref(torch.from_numpy(x).to(_TORCH[dtype]),
                             torch.from_numpy(dy).to(_TORCH[dtype]),
                             torch.from_numpy(g), 1e-5, False, True)
    dx, jdx = _to_f32(got[0]), _to_f32(want[0])
    if dtype == "float32":
        np.testing.assert_allclose(dx, jdx, rtol=0, atol=2e-6)
        sum_tol = 1e-5
    else:
        assert np.all(np.abs(dx - jdx) <= _bf16_ulp(
            np.maximum(np.abs(dx), np.abs(jdx))) + 1e-6), \
            f"bf16 dx off by {_ulps_apart(dx, jdx).max()} ulps"
        sum_tol = 1e-4
    for t, j in zip(got[1:], want[1:]):
        np.testing.assert_allclose(_to_f32(t), _to_f32(j), rtol=0,
                                   atol=sum_tol)


def _constexpr(src, name):
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def test_layer_norm_fwd_partition_is_the_kernels():
    """The partition ``ops/layernorm.py`` exports for B4 (``chip_smoke.py``
    emulates a skipped row of it) is the ``constexpr`` partition of
    ``csrc/layernorm_fwd.cu``: warps a block, blocks an SM, the register
    route's limit, a warp per row walking rows ``block * warps + warp``,
    ``+ blocks * warps``, ...; a block a row past the limit."""
    src = _csrc("layernorm_fwd.cu")
    assert ln_mod.FWD_WARPS == _constexpr(src, "kWarps")
    assert ln_mod.FWD_BLOCKS_PER_SM == _constexpr(src, "kBlocksPerSm")
    assert ln_mod.FWD_MAX_C == 32 * _constexpr(src, "kMaxCols")
    assert "int r = blockIdx.x * kWarps + warp;" in src
    assert "const int n_warps = gridDim.x * kWarps;" in src
    assert "r += n_warps" in src
    assert "return cpl < kMaxCols ? kBlocksPerSm : 1;" in src
    assert ln_mod.fwd_blocks(8192, 1024, 132) == 132 * ln_mod.FWD_BLOCKS_PER_SM
    assert ln_mod.fwd_blocks(8192, 4096, 132) == 132
    assert ln_mod.fwd_blocks(8, 768, 132) == 1
    assert ln_mod.fwd_blocks(512, 768, 132) == 64
    assert ln_mod.fwd_blocks(64, 8192, 132) == 64
    blocks = ln_mod.fwd_blocks(8192, 1024, 132)
    warps = blocks * ln_mod.FWD_WARPS
    rows = torch.cat([ln_mod.fwd_rows_of_warp(8192, blocks, w)
                      for w in range(warps)])
    # every row exactly once, each warp's rows in walking order
    assert torch.equal(rows.sort().values, torch.arange(8192))
    assert ln_mod.fwd_rows_of_warp(8192, blocks, 3)[:2].tolist() == [
        3, 3 + warps]


def test_layer_norm_kernels_share_the_row_statistics():
    """B4 and B5 take their row statistics from one routine in
    ``csrc/layernorm.cuh``, so the backward's recomputed mean and rstd
    are the forward's bit for bit: both sources include the header and
    call ``ln::warp_row_stats``; the fold into rstd appears in the
    header and in no other kernel source."""
    fwd, bwd = _csrc("layernorm_fwd.cu"), _csrc("layernorm_bwd.cu")
    head = _csrc("layernorm.cuh")
    for src in (fwd, bwd):
        assert '#include "layernorm.cuh"' in src
        assert ("ln::warp_row_stats<T, kWide, kChunks>(cx, lane, c, eps, "
                "rms, mean, rstd);") in src
        assert "struct Cols" not in src
    assert "ln::fold(s, ss, c, eps, rms, mean, rstd);" in fwd
    fold = "__frcp_rn(__fsqrt_rn("
    assert head.count(fold) == 1
    csrc = pathlib.Path(ln_mod.__file__).resolve().parent.parent / "csrc"
    for path in csrc.glob("*.c*"):
        if path.name != "layernorm.cuh":
            assert fold not in path.read_text(), path.name


def test_layer_norm_bwd_partition_is_the_kernels():
    """The partition ``ops/layernorm.py`` exports (``chip_smoke.py``
    emulates a column sum that leaves out one block with it) is the
    ``constexpr`` partition of ``csrc/layernorm_bwd.cu``: warps a block,
    blocks an SM, a warp per row walking rows ``block * warps + warp``,
    ``+ blocks * warps``, ..."""
    src = (pathlib.Path(ln_mod.__file__).resolve().parent.parent / "csrc"
           / "layernorm_bwd.cu").read_text()
    assert ln_mod.BWD_WARPS == _constexpr(src, "kWarps")
    assert ln_mod.BWD_BLOCKS_PER_SM == _constexpr(src, "kBlocksPerSm")
    assert "int r = blockIdx.x * kWarps + warp;" in src
    assert "const int n_warps = gridDim.x * kWarps;" in src
    assert "r += n_warps" in src
    assert ln_mod.bwd_blocks(8192, 132) == 132 * ln_mod.BWD_BLOCKS_PER_SM
    assert ln_mod.bwd_blocks(20, 132) == 3
    blocks = ln_mod.bwd_blocks(8192, 132)
    of = ln_mod.bwd_block_of_rows(8192, blocks)
    nw = blocks * ln_mod.BWD_WARPS
    for r in (0, 7, 8, nw - 1, nw, 8191):
        assert of[r].item() == (r % nw) // ln_mod.BWD_WARPS
    # every block sums rows, and each row exactly once
    assert torch.bincount(of, minlength=blocks).min().item() > 0


def test_batch_norm_reduce_partition_is_the_kernels():
    """The partition ``ops/batchnorm.py`` exports (the wrappers size the
    grid and scratch with it; ``chip_smoke.py`` emulates a sum that
    leaves out one row block with it) is the ``constexpr`` partition of
    ``csrc/batchnorm.cuh``: threads a block, vectors a column tile,
    blocks an SM, and row group g of block b walking rows ``b * groups +
    g``, ``+ row_blocks * groups``, ...; B7 and B9 launch on it."""
    csrc = pathlib.Path(bn_mod.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "batchnorm.cuh").read_text()
    assert bn_mod.THREADS == _constexpr(src, "kThreads")
    assert bn_mod.REDUCE_TILE == _constexpr(src, "kTileVecs")
    assert bn_mod.REDUCE_BLOCKS_PER_SM == _constexpr(src, "kBlocksPerSm")
    assert "s.groups = kThreads / s.tile;" in src
    assert ("static_cast<long long>(blockIdx.x) * s.groups + s.group;"
            in src)
    assert "gridDim.x) * s.groups;" in src
    assert "reduce_slot<kTileVecs>(c / VEC)" in src
    for name in ("bn_stats", "bn_bwd_reduce"):
        kernel = (csrc / f"{name}.cu").read_text()
        assert "bn::reduce<VEC>(" in kernel
        assert "__launch_bounds__(bn::kThreads, bn::kBlocksPerSm)" in kernel
        assert "column_sum" not in kernel
    # 8 row groups of 32 vectors at C = 256 bf16, blocks strided
    row_blocks, _ = bn_mod.reduce_geometry(401408, 256, 8, 2, 132)
    of = bn_mod.reduce_block_of_rows(401408, 256, 8, row_blocks)
    for r in (0, 7, 8, 8 * row_blocks - 1, 8 * row_blocks, 401407):
        assert of[r].item() == (r % (8 * row_blocks)) // 8


def test_batch_norm_apply_partition_is_the_kernels():
    """B8's layout ``ops/batchnorm.py`` states (``apply_geometry``,
    ``apply_block_of_rows``) is the one of ``csrc/bn_apply.cu``: a
    block's threads across a column tile of up to kThreads vectors and
    over kThreads / tile row groups, block b taking the contiguous tile
    of groups * kRows rows from b * groups * kRows (row group g, rows
    groups apart), a tile a block, s and t loaded once a thread."""
    csrc = pathlib.Path(bn_mod.__file__).resolve().parent.parent / "csrc"
    head = (csrc / "batchnorm.cuh").read_text()
    assert bn_mod.ROWS_IN_FLIGHT == _constexpr(head, "kRows")
    assert "elementwise_blocks" not in head
    src = (csrc / "bn_apply.cu").read_text()
    assert "using bn::kRows;" in src
    assert "bn::reduce_slot(c / VEC);" in src
    assert ("const long long per_tile = static_cast<long long>(slot.groups)"
            " * kRows;") in src
    assert "for (long long tile = blockIdx.x; tile * per_tile < n;" in src
    assert "tile += gridDim.x) {" in src
    assert "const long long r0 = tile * per_tile + slot.group;" in src
    assert "const long long r = r0 + k * slot.groups;" in src
    assert "const long long tiles = (n + per_tile - 1) / per_tile;" in src
    assert "(cv + bn::kThreads - 1) / bn::kThreads);" in src
    assert "v % cv" not in src
    assert "ks[i] = s[col + i];" in src
    # [401408, 256] bf16: 8 row groups of 32 vectors, 32 rows a block
    assert bn_mod.apply_geometry(401408, 256, 8) == (12544, 1)
    of = bn_mod.apply_block_of_rows(401408, 256, 8, 12544)
    for r in (0, 31, 32, 401407):
        assert of[r].item() == r // 32
    assert bn_mod.apply_geometry(5, 8192, 8) == (2, 4)
    assert bn_mod.apply_geometry(100, 64, 4) == (2, 1)


def test_layer_norm_bwd_ref_is_the_autograd_backward():
    """layer_norm_bwd_ref (what the card's B5 is held to) is exactly the
    CPU backward of fused_layer_norm, with and without beta."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(7, 24).astype(np.float32))
    dy = torch.from_numpy(rs.randn(7, 24).astype(np.float32))
    g = torch.from_numpy((1 + 0.1 * rs.randn(24)).astype(np.float32))
    for beta, kind in ((torch.zeros(24), "layernorm"),
                       (None, "rmsnorm")):
        xs = x.clone().requires_grad_()
        gs = g.clone().requires_grad_()
        bs = None if beta is None else beta.clone().requires_grad_()
        fused_layer_norm(xs, gs, bs, eps=1e-5, kind=kind).backward(dy)
        dx, dg, db = layer_norm_bwd_ref(x, dy, g, 1e-5, kind == "rmsnorm",
                                        beta is not None)
        assert torch.equal(xs.grad, dx) and torch.equal(gs.grad, dg)
        assert (db is None) == (bs is None)
        if db is not None:
            assert torch.equal(bs.grad, db)
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_bwd_cuda(x, dy, g, 1e-5, False, True)


# ---------------------------------------------------------------------------
# int8 block math (the int8 cache's codes and scales)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [8, 16, 64])
def test_block_quantize_bitwise(block):
    """Codes and scales bitwise equal to optim/compression.py, across
    magnitudes, with an all-zero block and exact half-way quotients."""
    rs = np.random.RandomState(block)
    x = (rs.randn(12, block) * np.logspace(-3, 3, 12)[:, None]).astype(
        np.float32)
    x[3] = 0.0                                        # all-zero block
    x[5] = np.arange(block, dtype=np.float32) - block / 2
    x[5, 0] = 127.0                                   # scale 1: k + 0.5 ties
    x[5, 1:] += 0.5
    jq, js = jcomp.block_quantize(jnp.asarray(x))
    tq, ts = tcomp.block_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy().view(np.uint32),
                          np.asarray(js).view(np.uint32))
    assert ts[3].item() == 1.0
    jd = jcomp.block_dequantize(jq, js)
    td = tcomp.block_dequantize(tq, ts)
    assert np.array_equal(td.numpy().view(np.uint32),
                          np.asarray(jd).view(np.uint32))
    flat = x.reshape(-1)
    jq2, js2 = jcomp.quantize_blocks(jnp.asarray(flat), block)
    tq2, ts2 = tcomp.quantize_blocks(torch.from_numpy(flat), block)
    assert np.array_equal(tq2.numpy(), np.asarray(jq2))
    assert np.array_equal(ts2.numpy(), np.asarray(js2))
    assert np.array_equal(
        tcomp.dequantize_blocks(tq2, ts2, block).numpy(),
        np.asarray(jcomp.dequantize_blocks(jq2, js2, block)))


def test_pad_flat_matches():
    x = np.arange(11, dtype=np.float32)
    for m in (4, 11, 16):
        assert np.array_equal(
            tcomp._pad_flat(torch.from_numpy(x), m).numpy(),
            np.asarray(jcomp._pad_flat(jnp.asarray(x), m)))


# ---------------------------------------------------------------------------
# B16 / B17: decode append + attend
# ---------------------------------------------------------------------------

_B, _L, _KH, _H, _M, _D, _BLOCK = 2, 2, 2, 4, 16, 16, 8

_CASES = {
    # name: (cache dtype, compute dtype, positions [B, T])
    "fp32_t1": ("fp32", "float32", [[5], [9]]),
    "fp32_t8_past_end_dup": ("fp32", "float32",
                             [list(range(3, 11)),
                              [9, 10, 10, 11, 12, 13, 15, 16]]),
    "bf16_t1": ("bf16", "bfloat16", [[0], [15]]),
    "bf16_t8_f32compute": ("bf16", "float32",
                           [list(range(2, 10)), list(range(9, 17))]),
    "int8_t1": ("int8", "float32", [[5], [9]]),
    "int8_t8_past_end": ("int8", "float32",
                         [list(range(3, 11)), list(range(9, 17))]),
    "int8_t1_bf16compute": ("int8", "bfloat16", [[7], [1]]),
    # the engine's prefill: a float32 cache filled whole, bf16 compute
    # (T = 16 is the first T of the card's prefill route)
    "fp32_t16_prefill_bf16compute": ("fp32", "bfloat16",
                                     [list(range(16)), list(range(16))]),
    # T = 20 > M: repeated positions and positions past the cache
    "bf16_t20_dup_past_end": ("bf16", "bfloat16",
                              [list(range(18)) + [5, 17],
                               [2, 2] + list(range(3, 21))]),
}


def _initial_buffers(kv_dtype, rs):
    """Random starting cache (every row holds something, so the merge's
    keep path is exercised) as numpy arrays."""
    shape = (_B, _L, _KH, _M, _D)
    if kv_dtype == "int8":
        # scales of blocks whose amax lies in [0.5, 3], as randn rows give
        nb = _D // _BLOCK
        return {
            "k": rs.randint(-127, 128, shape).astype(np.int8),
            "v": rs.randint(-127, 128, shape).astype(np.int8),
            "k_scale": rs.uniform(0.5, 3.0, shape[:4] + (nb,)).astype(
                np.float32) / 127,
            "v_scale": rs.uniform(0.5, 3.0, shape[:4] + (nb,)).astype(
                np.float32) / 127,
        }
    k = rs.randn(*shape).astype(np.float32)
    v = rs.randn(*shape).astype(np.float32)
    if kv_dtype == "bf16":
        k = k.astype(jnp.bfloat16)
        v = v.astype(jnp.bfloat16)
    return {"k": k, "v": v}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_append_attend_ref_matches_pallas(case, monkeypatch):
    kv_dtype, compute, positions = _CASES[case]
    rs = np.random.RandomState(sorted(_CASES).index(case))
    bufs = _initial_buffers(kv_dtype, rs)
    t = len(positions[0])
    q = rs.randn(_B, t, _H, _D).astype(np.float32)
    kn = rs.randn(_B, t, _KH, _D).astype(np.float32)
    vn = rs.randn(_B, t, _KH, _D).astype(np.float32)
    kn[0, 0, 0, :_BLOCK] = 0.0  # an all-zero quantization block
    pos = np.asarray(positions, np.int32)
    layer = 1

    # JAX: the Pallas append+attend kernel, forced on
    monkeypatch.setattr(pc, "fused_enabled", lambda knobs=None: True)
    jspec = JaxSpec(slots=_B, layers=_L, kv_heads=_KH, max_len=_M,
                    head_dim=_D, dtype=kv_dtype, block=_BLOCK,
                    compute_dtype=_JNP[compute])
    jcache = JaxCache(jspec, {n: jnp.asarray(a) for n, a in bufs.items()})
    cd = _JNP[compute]
    jout = pc.decode_append_attend(
        jcache, layer, jnp.asarray(q).astype(cd), jnp.asarray(kn).astype(cd),
        jnp.asarray(vn).astype(cd), jnp.asarray(pos))

    # port: the plain version (CPU dispatch of the same entry point)
    tspec = KVCacheSpec(slots=_B, layers=_L, kv_heads=_KH, max_len=_M,
                        head_dim=_D, dtype=kv_dtype, block=_BLOCK,
                        compute_dtype=_TORCH[compute])
    tcache = SlottedKVCache(tspec, {n: _to_torch(a)
                                    for n, a in bufs.items()})
    ct = _TORCH[compute]
    tout = tda.decode_append_attend(
        tcache, layer, torch.from_numpy(q).to(ct),
        torch.from_numpy(kn).to(ct), torch.from_numpy(vn).to(ct),
        torch.from_numpy(pos))

    for name, jbuf in jcache.buffers.items():
        got = _to_f32(tcache.buffers[name])
        assert np.array_equal(got, _to_f32(jbuf)), \
            f"{case}: buffer {name} differs from the Pallas kernel's"
    assert tout.dtype == ct and tuple(tout.shape) == (_B, t, _H, _D)
    want, got = _to_f32(jout), _to_f32(tout)
    if compute == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
            f"{case}: bf16 output differs by more than one bf16 ulp"


def _csrc(name):
    return (pathlib.Path(tda.__file__).resolve().parent.parent / "csrc"
            / name).read_text()


def test_append_attend_tiling_is_the_kernels():
    """The routes and tiling ``ops/decode_attention.py`` exports
    (``chip_smoke.py`` emulates a prefill block that skips its last key
    tile and a decode cluster that skips one CTA's span with them) are
    those of ``csrc/append_attend.cu``: the route codes, the prefill
    query and key tiles, the T from which bf16 calls take the prefill
    route, the decode cluster's largest size (the entry point reports
    the size it launched) and its span rule."""
    src = _csrc("append_attend.cu") + _csrc("decode_cluster.cuh")
    m = re.search(r"enum Route : int \{ kRouteCudaCores = (\d), "
                  r"kRoutePrefill = (\d), kRouteDecode = (\d) \}", src)
    assert m
    assert [tda.ROUTES[int(i)] for i in m.groups()] == [
        "cuda_core", "prefill", "decode"]
    assert tda.PREFILL_Q_TILE == _constexpr(src, "kQueryTile")
    assert tda.PREFILL_KEY_TILE == _constexpr(src, "kKeyTile")
    assert tda.PREFILL_MIN_T == _constexpr(src, "kPrefillMinT")
    assert tda.DECODE_MAX_CLUSTER == _constexpr(src, "kMaxCluster")
    assert re.search(r"decode_span\(int R, int C\)\s*\{\s*"
                     r"return \(R \+ C - 1\) / C;", src)
    # a prefill block's rows are whole m16 tiles of its warps
    assert tda.PREFILL_Q_TILE % 16 == 0 and tda.PREFILL_KEY_TILE % 16 == 0
    assert tda.decode_span(530, 2) == 265 and tda.decode_span(1, 8) == 1


def test_append_attend_int8_route_is_the_kernels():
    """B17 runs B16's cluster decode kernel (``csrc/decode_cluster.cuh``)
    with its own row policy, and the route constants
    ``ops/decode_attention.py`` exports for it are the sources': the
    head_dims the route is built for, the T below which it is taken, the
    codes a lane loads (the block must be a multiple), the route codes
    and the cluster's largest size, which both kernels share."""
    head = _csrc("decode_cluster.cuh")
    int8 = _csrc("append_attend_int8.cu")
    assert '#include "decode_cluster.cuh"' in int8
    assert '#include "decode_cluster.cuh"' in _csrc("append_attend.cu")
    assert "launch_decode<Int8DecodeRows, kD>" in int8
    assert "launch_decode<Rows, kD>" in _csrc("append_attend.cu")
    assert tda.INT8_CODES_PER_LOAD == _constexpr(int8, "kCodesPerLoad")
    assert tda.PREFILL_MIN_T == _constexpr(head, "kPrefillMinT")
    assert tda.DECODE_MAX_CLUSTER == _constexpr(head, "kMaxCluster")
    dims = tuple(int(d) for d in re.findall(
        r"if \(d == (\d+)\) return body", head))
    assert dims == tda.ROUTED_HEAD_DIMS
    assert re.search(r"\(D == 64 \|\| D == 128\) && block % kCodesPerLoad "
                     r"== 0 &&\s*T < kPrefillMinT", int8)
    # a lane's 16-byte load of codes is kCodesPerLoad int8 values, and
    # every routed head_dim splits into loads
    assert tda.INT8_CODES_PER_LOAD == 16
    assert all(d % tda.INT8_CODES_PER_LOAD == 0 for d in tda.ROUTED_HEAD_DIMS)
    assert "*route = kRouteDecode;" in int8
    assert "*route = kRouteCudaCores;" in int8


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_standalone_refs_equal_cache_path(kv_dtype):
    """append_attend_ref / append_attend_int8_ref (what the card's
    kernels are held against) are the cache path on raw slices."""
    rs = np.random.RandomState(7)
    bufs = _initial_buffers(kv_dtype, rs)
    q = torch.from_numpy(rs.randn(_B, 2, _H, _D).astype(np.float32))
    kn = torch.from_numpy(rs.randn(_B, 2, _KH, _D).astype(np.float32))
    vn = torch.from_numpy(rs.randn(_B, 2, _KH, _D).astype(np.float32))
    pos = torch.tensor([[4, 5], [0, 1]], dtype=torch.int32)
    spec = KVCacheSpec(slots=_B, layers=_L, kv_heads=_KH, max_len=_M,
                       head_dim=_D, dtype=kv_dtype, block=_BLOCK,
                       compute_dtype=torch.float32)
    a = SlottedKVCache(spec, {n: _to_torch(x) for n, x in bufs.items()})
    b = {n: _to_torch(x) for n, x in bufs.items()}
    out_a = a.append_attend(0, q, kn, vn, pos)
    if kv_dtype == "int8":
        out_b = tda.append_attend_int8_ref(
            q, b["k"][:, 0], b["k_scale"][:, 0], b["v"][:, 0],
            b["v_scale"][:, 0], kn, vn, pos, _BLOCK)
    else:
        out_b = tda.append_attend_ref(q, b["k"][:, 0], b["v"][:, 0], kn, vn,
                                      pos)
    assert torch.equal(out_a, out_b)
    for n in b:
        assert torch.equal(a.buffers[n], b[n]), n
