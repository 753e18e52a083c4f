"""The PyTorch port's transformer against the flax model.

Weights are initialized by flax, converted with
``horovod_tpu_torch.models.convert.params_from_flax`` and loaded into
the port; the same numpy tokens then go through both. float32 configs,
so the comparison is of the algorithm: logits and losses within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax

torch.set_num_threads(1)

VOCAB = 61

_CONFIGS = {
    "gpt2_like": dict(vocab_size=VOCAB, num_layers=2, num_heads=2,
                      hidden_size=16, max_seq_len=32),
    "llama_like": dict(vocab_size=VOCAB, num_layers=2, num_heads=4,
                       num_kv_heads=2, hidden_size=32, max_seq_len=32,
                       norm="rmsnorm", position="rope",
                       activation="swiglu", tie_embeddings=False),
    "bert_like": dict(vocab_size=VOCAB, num_layers=2, num_heads=2,
                      hidden_size=16, max_seq_len=32, causal=False),
}


def _pair(name, **over):
    kw = dict(_CONFIGS[name], **over)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **kw)
    jmod = jt.Transformer(jcfg)
    params = jmod.init(jax.random.PRNGKey(0),
                       jnp.ones((1, 4), jnp.int32))["params"]
    tmod = tt.Transformer(tcfg)
    tmod.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jmod, params, tmod


def _tokens(b=2, t=12, seed=1):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("name", ["gpt2_like", "llama_like"])
@pytest.mark.parametrize("fused_norm", [False, True])
def test_forward_and_loss_match_flax(name, fused_norm):
    jmod, params, tmod = _pair(name, fused_norm=fused_norm)
    toks = _tokens()
    jlog = jmod.apply({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        tlog = tmod(torch.from_numpy(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-5)
    jl, jn = jt.causal_lm_loss(jlog, jnp.asarray(toks))
    tl, tn = tt.causal_lm_loss(tlog, torch.from_numpy(toks).long())
    assert int(tn) == int(jn)
    assert abs(float(tl) - float(jl)) <= 1e-5


@pytest.mark.parametrize("name", ["gpt2_like", "llama_like"])
def test_fused_norm_equals_plain_norm(name):
    """fused_norm=True (the kernel's plain version on the CPU) and the
    flax-formula norms agree within 1e-5 on the same weights."""
    _, _, plain = _pair(name, fused_norm=False)
    _, _, fused = _pair(name, fused_norm=True)
    toks = torch.from_numpy(_tokens(seed=3))
    with torch.no_grad():
        np.testing.assert_allclose(fused(toks).numpy(), plain(toks).numpy(),
                                   rtol=0, atol=1e-5)


def test_bert_like_padding_mask_and_mlm_loss_match_flax():
    jmod, params, tmod = _pair("bert_like")
    toks = _tokens(seed=4)
    mask = np.ones_like(toks, dtype=bool)
    mask[1, 9:] = False
    jlog = jmod.apply({"params": params}, jnp.asarray(toks),
                      mask=jnp.asarray(mask))
    with torch.no_grad():
        tlog = tmod(torch.from_numpy(toks), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-5)
    labels = _tokens(seed=5)
    labels[0, 0] = VOCAB + 3  # out of range: contributes zero
    where = np.random.RandomState(6).rand(*toks.shape) < 0.3
    jl, jn = jt.mlm_loss(jlog, jnp.asarray(labels), jnp.asarray(where))
    tl, tn = tt.mlm_loss(tlog, torch.from_numpy(labels).long(),
                         torch.from_numpy(where))
    assert int(tn) == int(jn)
    assert abs(float(tl) - float(jl)) <= 1e-5


def test_causal_lm_loss_ignore_and_out_of_range_ids():
    rs = np.random.RandomState(2)
    logits = rs.randn(2, 6, VOCAB).astype(np.float32)
    toks = _tokens(t=6, seed=7)
    toks[0, 3] = -1        # ignored
    toks[1, 4] = VOCAB + 1  # out of range
    jl, jn = jt.causal_lm_loss(jnp.asarray(logits), jnp.asarray(toks))
    tl, tn = tt.causal_lm_loss(torch.from_numpy(logits),
                               torch.from_numpy(toks).long())
    assert int(tn) == int(jn)
    assert abs(float(tl) - float(jl)) <= 1e-5


def test_bf16_config_tracks_flax():
    """bfloat16 compute (the served dtype): rounding points match, so
    the logits stay within a few bf16 ulps of flax's."""
    kw = dict(_CONFIGS["gpt2_like"])
    jmod = jt.Transformer(jt.TransformerConfig(dtype=jnp.bfloat16, **kw))
    params = jmod.init(jax.random.PRNGKey(0),
                       jnp.ones((1, 4), jnp.int32))["params"]
    tmod = tt.Transformer(tt.TransformerConfig(dtype=torch.bfloat16, **kw))
    tmod.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    toks = _tokens()
    jlog = np.asarray(jmod.apply({"params": params},
                                 jnp.asarray(toks))).astype(np.float32)
    with torch.no_grad():
        tlog = tmod(torch.from_numpy(toks)).to(torch.float32).numpy()
    assert tlog.shape == jlog.shape
    # 4 bf16 ulps at the largest logit
    tol = 4 * 2.0 ** (np.floor(np.log2(np.abs(jlog).max())) - 7)
    assert np.abs(tlog - jlog).max() <= tol


def test_init_params_distribution():
    cfg = dataclasses.replace(tt.GPT2_SMALL, num_layers=1, vocab_size=512,
                              max_seq_len=64)
    m = tt.Transformer(cfg).init_params(torch.Generator().manual_seed(0))
    emb = m.tok_emb.embedding
    assert abs(emb.std().item() - 0.02) < 1e-3
    q = m.block_0.attn.query.kernel  # [768, 12, 64], fans 768 / 768
    bound = (6.0 / (768 + 768)) ** 0.5
    assert q.abs().max().item() <= bound
    assert q.abs().max().item() > 0.99 * bound
    assert torch.all(m.block_0.attn.query.bias == 0)
    assert torch.all(m.block_0.ln_attn.scale == 1)
    again = tt.Transformer(cfg).init_params(torch.Generator().manual_seed(0))
    assert torch.equal(again.block_0.mlp.fc1.kernel, m.block_0.mlp.fc1.kernel)


def test_named_configs_match_jax():
    for name in ("GPT2_SMALL", "GPT2_MEDIUM", "GPT2_LARGE", "BERT_BASE",
                 "BERT_LARGE", "LLAMA2_7B", "LLAMA3_8B"):
        j = dataclasses.asdict(getattr(jt, name))
        t = dataclasses.asdict(getattr(tt, name))
        j.pop("dtype"), t.pop("dtype")
        assert j == t, name
