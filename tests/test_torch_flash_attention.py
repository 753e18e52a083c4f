"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU ``horovod_tpu_torch.ops.flash_attention`` runs its plain
version (the card's kernels are held against the same function in
``chip_smoke.py``); here it meets ``horovod_tpu.ops.pallas_attention``
in interpret mode on the cases of ``tests/test_pallas_attention.py``:
causal and not, T not a tile multiple (40 with tiles of 16), GQA, ring
offsets, a fully masked block. Forward O and lse, and the backward's
dQ/dK/dV through each framework's autograd, from the same numpy inputs.

Tolerances: float32 within 2e-5 (O, lse) and 1e-4 (gradients): the
order of sums only. bfloat16 within 2% of the largest value (about two
bf16 ulps): the online softmax rounds p against a running max, the
plain version against the row max.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import pallas_attention as pa
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# name: (B, Tq, Tk, H, KH, D, causal, query_offset, key_offset, block)
_CASES = {
    "causal": (1, 48, 48, 2, 2, 32, True, 0, 0, 16),
    "non_causal": (1, 48, 48, 2, 2, 32, False, 0, 0, 16),
    "unpadded_t40": (1, 40, 40, 2, 2, 16, True, 0, 0, 16),
    "gqa": (1, 32, 32, 4, 2, 16, True, 0, 0, 16),
    "unpadded_and_offset": (1, 50, 70, 2, 2, 16, True, 16, 0, 32),
    "fully_masked": (1, 8, 8, 2, 2, 16, True, 0, 8, 8),
}
_BF16 = ("causal", "unpadded_t40", "gqa")


def _inputs(case):
    b, tq, tk, h, kh, d = _CASES[case][:6]
    rs = np.random.RandomState(sorted(_CASES).index(case))
    return (rs.randn(b, tq, h, d).astype(np.float32),
            rs.randn(b, tk, kh, d).astype(np.float32),
            rs.randn(b, tk, kh, d).astype(np.float32),
            rs.randn(b, tq, h, d).astype(np.float32))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a).astype(np.float32)


def _close(got, want, dtype, atol):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        tol = 2e-2 * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("case,dtype", [(c, "float32") for c in _CASES]
                         + [(c, "bfloat16") for c in _BF16])
def test_flash_matches_pallas(case, dtype):
    b, tq, tk, h, kh, d, causal, qo, ko, block = _CASES[case]
    q, k, v, ct = _inputs(case)
    jd, td = _JNP[dtype], _TORCH[dtype]

    def jflash(q, k, v):
        return pa.flash_attention(q, k, v, causal=causal, query_offset=qo,
                                  key_offset=ko, block_q=block,
                                  block_k=block)

    @jax.jit  # Pallas in interpret mode traces far faster under jit
    def jrun(q, k, v, ct):
        out, vjp = jax.vjp(jflash, q, k, v)
        return out, vjp(ct)

    jout, jgrads = jrun(*[jnp.asarray(a).astype(jd) for a in (q, k, v, ct)])

    targs = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    tout = fa.flash_attention(*targs, causal=causal, query_offset=qo,
                              key_offset=ko)
    tout.backward(torch.from_numpy(ct).to(td))
    assert tout.dtype == td
    _close(tout, jout, dtype, 2e-5)
    for name, a, j in zip("qkv", targs, jgrads):
        assert np.isfinite(_f32(a.grad)).all(), name
        _close(a.grad, j, dtype, 1e-4)

    # lse: the forward's residual, both in float32 [B, H, Tq]
    rep = h // kh
    bh = [a.transpose(0, 2, 1, 3) for a in (q, k, v)]
    bh[1], bh[2] = (np.repeat(a, rep, axis=1) for a in bh[1:])
    scale = 1.0 / d ** 0.5
    _, res = pa._flash_fwd(*[jnp.asarray(a).astype(jd) for a in bh],
                           causal, scale, qo, ko, block, block)
    _, lse = fa.flash_attention_ref(*[torch.from_numpy(a).to(td)
                                      for a in bh], causal, scale, qo, ko)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4])[:, :, 0],
                               rtol=0, atol=2e-5 if dtype == "float32"
                               else 1e-3)
    if case == "fully_masked":
        assert np.all(_f32(tout) == 0.0)
        assert np.all(lse.numpy() == fa.NEG_INF)
        for a in targs:
            assert np.all(_f32(a.grad) == 0.0)


def test_backward_ref_equals_kernel_split():
    """flash_bwd_ref (what the card's dQ and dK/dV kernels are held to)
    is the autograd Function's CPU backward."""
    q, k, v, ct = (torch.from_numpy(a).transpose(1, 2).contiguous()
                   for a in _inputs("causal"))
    out, lse = fa.flash_attention_ref(q, k, v, True, 0.25, 3, 0)
    delta = torch.sum(ct * out, dim=-1)
    want = fa.flash_bwd_ref(q, k, v, ct, lse, delta, True, 0.25, 3, 0)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    got_out = fa.flash_attention_bhtd(qs, ks, vs, causal=True, scale=0.25,
                                      query_offset=3)
    got_out.backward(ct)
    assert torch.equal(got_out, out)
    for g, w in zip((qs.grad, ks.grad, vs.grad), want):
        assert torch.equal(g, w)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only; the CPU runs the plain
    version through the public functions."""
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, q, q, True, 0.25)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dq_cuda(q, q, q, q, q[..., 0], q[..., 0], True, 0.25)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dkv_cuda(q, q, q, q, q[..., 0], q[..., 0], True, 0.25)


def test_pluggable_into_transformer():
    """make_flash_attention_fn in the port's Transformer gives the flax
    model's logits with the Pallas flash function (float32, 1e-5), and
    equals the port's default attention within 1e-5."""
    kw = dict(num_layers=2, hidden_size=64, num_heads=4, max_seq_len=32,
              vocab_size=128)
    jcfg = dataclasses.replace(jt.GPT2_SMALL, dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tt.GPT2_SMALL, dtype=torch.float32, **kw)
    toks = np.random.RandomState(0).randint(0, 128, (2, 32))
    jmod = jt.Transformer(jcfg,
                          attention_fn=pa.make_flash_attention_fn(True))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                jnp.asarray(toks))["params"]
    jlog = np.asarray(jax.jit(jmod.apply)({"params": params},
                                          jnp.asarray(toks)))
    state = params_from_flax(jax.tree.map(np.asarray, params))
    flash = tt.Transformer(tcfg, attention_fn=fa.make_flash_attention_fn())
    flash.load_state_dict(state)
    plain = tt.Transformer(tcfg)
    plain.load_state_dict(state)
    with torch.no_grad():
        tlog = flash(torch.from_numpy(toks)).numpy()
        plog = plain(torch.from_numpy(toks)).numpy()
    assert tlog.shape == (2, 32, 128) and np.isfinite(tlog).all()
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tlog, plog, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="padding mask"):
        flash(torch.from_numpy(toks), mask=torch.ones(2, 32, dtype=bool))
