"""The port's training path against ``jax.grad`` of the flax model.

Tiny float32 configs (2 layers, hidden 64): GPT-2-like, BERT-like
(bidirectional) and Llama-like (rope, RMSNorm, SwiGLU, GQA). Flax
initializes the weights, ``params_from_flax`` loads them into the port,
and the same numpy tokens go through both with flash attention
(``make_flash_attention_fn``; Pallas in interpret mode on the JAX side)
and ``fused_norm=True``. Logits, loss and every gradient are compared,
the port's gradients mapped back to the flax tree with
``params_to_flax``. Tolerances (float32, sums in another order only):
logits and loss within 2e-5, gradients within 2e-5 + 1e-4 relative.

Within the port: remat gradients equal the plain backward's, and the
flash / fused-norm variants equal the default attention and the
unfused norms on the same weights (as tests/test_models.py checks for
the JAX package).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops.pallas_attention import \
    make_flash_attention_fn as jax_flash_fn
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax, params_to_flax
from horovod_tpu_torch.ops.flash_attention import make_flash_attention_fn

torch.set_num_threads(1)

VOCAB = 97
_CONFIGS = {
    "gpt2_like": dict(vocab_size=VOCAB, num_layers=2, num_heads=2,
                      hidden_size=64, max_seq_len=32),
    "bert_like": dict(vocab_size=VOCAB, num_layers=2, num_heads=2,
                      hidden_size=64, max_seq_len=32, causal=False),
    "llama_like": dict(vocab_size=VOCAB, num_layers=2, num_heads=4,
                       num_kv_heads=2, hidden_size=64, max_seq_len=32,
                       norm="rmsnorm", position="rope",
                       activation="swiglu", tie_embeddings=False),
}


def _tokens(seed=1, b=2, t=8):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, t)).astype(
        np.int32)


def _flax(name, **over):
    kw = dict(_CONFIGS[name], **over)
    causal = kw.get("causal", True)
    jmod = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **kw),
                          attention_fn=jax_flash_fn(causal))
    # jitted: Pallas in interpret mode traces far faster under jit
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                jnp.ones((1, 4), jnp.int32))["params"]
    return jmod, params


def _port(name, params, flash=True, **over):
    kw = dict(_CONFIGS[name], **over)
    cfg = tt.TransformerConfig(dtype=torch.float32, **kw)
    fn = make_flash_attention_fn(cfg.causal) if flash else None
    mod = tt.Transformer(cfg, attention_fn=fn)
    mod.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return mod


def _port_grads(mod, toks):
    mod.zero_grad(set_to_none=True)
    logits = mod(torch.from_numpy(toks).long())
    loss, _ = tt.causal_lm_loss(logits, torch.from_numpy(toks).long())
    loss.backward()
    return logits.detach(), loss.detach(), {
        n: p.grad.clone() for n, p in mod.named_parameters()}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_gradients_match_jax_grad(name):
    jmod, params = _flax(name, fused_norm=True)
    toks = _tokens()

    def loss_fn(p):
        logits = jmod.apply({"params": p}, jnp.asarray(toks))
        return jt.causal_lm_loss(logits, jnp.asarray(toks))[0], logits

    (jloss, jlog), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    mod = _port(name, params, fused_norm=True)
    tlog, tloss, tgrads = _port_grads(mod, toks)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=2e-5)
    assert abs(float(tloss) - float(jloss)) <= 2e-5
    got = params_to_flax(tgrads)
    want = jax.tree.map(np.asarray, jgrads)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["gpt2_like", "llama_like"])
def test_remat_gradients_equal_plain_backward(name):
    _, params = _flax(name)
    toks = _tokens(seed=2)
    plain = _port(name, params, fused_norm=True)
    remat = _port(name, params, fused_norm=True, remat=True)
    _, lp, gp = _port_grads(plain, toks)
    _, lr, gr = _port_grads(remat, toks)
    assert torch.equal(lp, lr)
    for n in gp:
        assert torch.equal(gp[n], gr[n]), n


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_flash_and_fused_norm_equal_plain_variants(name):
    """Loss and gradients of flash attention + fused norms against the
    default attention + flax-formula norms, same weights: within 2e-5
    (+1e-4 relative) in float32."""
    _, params = _flax(name)
    toks = _tokens(seed=3)
    _, lf, gf = _port_grads(_port(name, params, flash=True,
                                  fused_norm=True), toks)
    _, lp, gp = _port_grads(_port(name, params, flash=False,
                                  fused_norm=False), toks)
    assert abs(float(lf) - float(lp)) <= 2e-5
    for n in gp:
        np.testing.assert_allclose(gf[n].numpy(), gp[n].numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=n)


def test_params_to_flax_inverts_params_from_flax():
    _, params = _flax("llama_like")
    tree = jax.tree.map(np.asarray, params)
    back = params_to_flax(params_from_flax(tree))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert np.array_equal(a, b)
