"""Plain versions of the PyTorch port's kernels against the JAX package.

Each kernel of ``horovod_tpu_torch`` has a plain PyTorch version that
the CPU runs and the card's kernel is held against (``chip_smoke.py``).
Here those plain versions meet the JAX package on the same numpy
inputs:

* the fused LayerNorm/RMSNorm forward vs the Pallas kernel (interpret
  mode on the CPU): float32 within 1e-6, bfloat16 within one bf16 ulp;
* the int8 block quantize/dequantize, bitwise;
* the decode append+attend vs the Pallas append+attend kernels forced
  on (float32, bfloat16 and int8 caches, GQA, T=1 and T=8, a position
  past the cache): merged buffers, codes and scales bitwise, the
  float32 output within 1e-6.
"""

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
from horovod_tpu_torch.ops import decode_attention as tda
from horovod_tpu_torch.ops.layernorm import fused_layer_norm
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
def test_layer_norm_ref_matches_pallas(dtype, kind, with_beta):
    """13 rows (not a multiple of 8) of 40 channels (lane-padded on the
    TPU): float32 within 1e-6, bfloat16 within one bf16 ulp."""
    rs = np.random.RandomState(0)
    x = (rs.randn(13, 40) * 3 + 1.5).astype(np.float32)
    g = (1 + 0.1 * rs.randn(40)).astype(np.float32)
    b = (0.1 * rs.randn(40)).astype(np.float32) if with_beta else None
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


def test_layer_norm_backward_raises_until_b5():
    x = torch.randn(3, 8, requires_grad=True)
    y = fused_layer_norm(x, torch.ones(8), torch.zeros(8))
    with pytest.raises(NotImplementedError, match="B5"):
        y.sum().backward()


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
