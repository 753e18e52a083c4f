"""The port's vocab-blocked fused cross-entropy against the JAX package's.

``horovod_tpu_torch.ops.fused_cross_entropy`` re-runs every case of
``tests/test_fused_cross_entropy.py`` against the JAX function on the same
numpy inputs: values within rtol 1e-5 and both gradients within atol
2e-5 in float32 (that file's own limits); in bf16 the products are exact
in float32 in both frameworks (bf16 x bf16), so the loss holds to 1e-5
relative and dX, returned in bf16, to one bf16 ulp of the larger value.
Beyond them: d/dgscale, the pad of a ragged last block (any values give
the same result), the tied ``[V, h]`` and untied ``[h, V]`` heads, no
output of N * V elements anywhere, ``make_lm_train_step(fused_ce=True)``
against the unfused step (world 1, and a gloo world of 2 against world
1 on the global batch), the examples' ``--fused-ce`` and ``entry()``.
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
from torch.utils._python_dispatch import TorchDispatchMode

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import fused_cross_entropy as jce
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.ops import fused_cross_entropy as tce

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax(x, w, t, valid=None, mean=True, block=8192):
    """The JAX function's loss, n and (dX, dW)."""
    def f(x, w):
        return jce.fused_linear_cross_entropy(
            x, w, jnp.asarray(t), valid=None if valid is None
            else jnp.asarray(valid), block_vocab=block, mean=mean)
    (loss, n), g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    return float(loss), int(n), [np.asarray(a, np.float32) for a in g]


def _port(x, w, t, valid=None, mean=True, block=8192, tied=False):
    """The port's loss, n and (dX, dW) on the same numpy inputs; ``tied``
    passes the head as the transpose of a ``[V, h]`` table."""
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(np.ascontiguousarray(w.T) if tied else w,
                      requires_grad=True)
    loss, n = tce.fused_linear_cross_entropy(
        xt, wt.t() if tied else wt, torch.from_numpy(np.asarray(t)),
        valid=None if valid is None else torch.from_numpy(valid),
        block_vocab=block, mean=mean)
    loss.backward()
    dw = wt.grad.t() if tied else wt.grad
    return float(loss), int(n), [xt.grad.float().numpy(),
                                 dw.float().numpy()]


def _close(port, ref, rtol=1e-5, atol=2e-5):
    np.testing.assert_allclose(port[0], ref[0], rtol=rtol)
    assert port[1] == ref[1]
    for a, b in zip(port[2], ref[2]):
        np.testing.assert_allclose(a, b, atol=atol)


@pytest.mark.parametrize("block", [16, 64, 128])
def test_matches_jax_values_and_grads(block):
    rng = np.random.RandomState(0)
    N, H, V = 24, 32, 100  # V not a multiple of any block size
    x = rng.normal(size=(N, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.1).astype(np.float32)
    t = rng.randint(0, V, N)
    _close(_port(x, w, t, block=block), _jax(x, w, t, block=block))


def test_masked_and_out_of_range_targets():
    """Invalid rows (MLM unmasked positions, -1 sentinels) contribute
    exactly zero loss and zero gradient."""
    rng = np.random.RandomState(1)
    N, H, V = 16, 16, 50
    x = rng.normal(size=(N, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.1).astype(np.float32)
    t = rng.randint(0, V, N)
    t[3] = -1
    valid = rng.rand(N) < 0.5
    port = _port(x, w, t, valid, block=32)
    _close(port, _jax(x, w, t, valid, block=32))
    dead = ~valid | (t < 0)
    assert np.all(port[2][0][dead] == 0)


def test_out_of_range_counts_in_denominator():
    rng = np.random.RandomState(5)
    N, H, V = 8, 8, 10
    x = rng.normal(size=(N, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.1).astype(np.float32)
    t = rng.randint(0, V, N)
    t[0] = V + 3
    port = _port(x, w, t, block=4)
    assert port[1] == N  # the corrupt id still counted
    _close(port, _jax(x, w, t, block=4))


def test_bf16_hidden_path():
    """bf16 activations: the products are bf16 x bf16 into float32 in
    both frameworks (on the CPU the port upcasts its operands, which is
    exact), so the loss holds to 1e-5 relative; dX comes back in bf16,
    within one bf16 ulp of the larger value, and dW in float32."""
    rng = np.random.RandomState(2)
    N, H, V = 32, 64, 80
    x32 = rng.normal(size=(N, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.1).astype(np.float32)
    t = rng.randint(0, V, N)
    xj = jnp.asarray(x32, jnp.bfloat16)

    def f(x, w):
        return jce.fused_linear_cross_entropy(x, w, jnp.asarray(t),
                                              block_vocab=32)
    (jl, jn), (jdx, jdw) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(xj, jnp.asarray(w))
    xt = torch.tensor(x32).to(torch.bfloat16).requires_grad_()
    wt = torch.tensor(w, requires_grad=True)
    loss, n = tce.fused_linear_cross_entropy(xt, wt, torch.from_numpy(t),
                                             block_vocab=32)
    loss.backward()
    assert int(n) == int(jn) == N and xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jdx = np.asarray(jdx, np.float32)
    tdx = xt.grad.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jdx), np.abs(tdx))
                                   + 1e-30)) - 7)
    assert np.all(np.abs(tdx - jdx) <= ulp)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), atol=2e-5)


def test_sum_mode_and_count():
    rng = np.random.RandomState(3)
    x = rng.normal(size=(4, 6, 8)).astype(np.float32)  # [B, T, H]
    w = (rng.normal(size=(8, 20)) * 0.1).astype(np.float32)
    t = rng.randint(0, 20, (4, 6))
    s_port = _port(x, w, t, mean=False)
    _close(s_port, _jax(x, w, t, mean=False))
    m_port = _port(x, w, t, mean=True)
    assert s_port[1] == 24
    np.testing.assert_allclose(s_port[0] / 24, m_port[0], rtol=1e-6)


def _gpt2_pair():
    kw = dict(num_layers=2, hidden_size=64, num_heads=4, max_seq_len=32,
              vocab_size=96)
    jmod = jt.Transformer(dataclasses.replace(jt.GPT2_SMALL,
                                              dtype=jnp.float32, **kw))
    toks = np.random.RandomState(7).randint(0, 96, (3, 32)).astype(np.int32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(toks))["params"]
    tmod = tt.Transformer(dataclasses.replace(tt.GPT2_SMALL,
                                              dtype=torch.float32, **kw))
    tmod.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jmod, params, tmod, toks


def test_fused_causal_lm_loss_matches_model_loss():
    """The causal wrapper on a tied-embedding transformer at float32
    equals the JAX wrapper on the same converted weights, and the port's
    own ``causal_lm_loss`` of the materialized logits."""
    jmod, params, tmod, toks = _gpt2_pair()
    hidden = jmod.apply({"params": params}, jnp.asarray(toks),
                        return_hidden=True)
    jl, jn = jce.fused_causal_lm_loss(
        hidden, params["tok_emb"]["embedding"].T, jnp.asarray(toks),
        block_vocab=32)
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        th = tmod(t, return_hidden=True)
        fl, fn = tce.fused_causal_lm_loss(th, tmod.tok_emb.embedding.t(), t,
                                          block_vocab=32)
        ml, mn = tt.causal_lm_loss(tmod(t), t)
    assert int(fn) == int(jn) == int(mn)
    np.testing.assert_allclose(float(fl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(fl), float(ml), rtol=1e-5)


def test_dgscale_matches_jax():
    """``gscale`` is differentiable, with gradient ``g * Σ nll`` saved in
    the forward, as the JAX custom VJP has it."""
    rng = np.random.RandomState(4)
    N, H, V = 20, 16, 70
    x = rng.normal(size=(N, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.1).astype(np.float32)
    t = rng.randint(0, V, N)
    valid = rng.rand(N) < 0.7
    jg = jax.grad(lambda s: 3.0 * jce._fused_ce(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), jnp.asarray(valid),
        s, 32))(jnp.float32(0.25))
    s = torch.tensor(0.25, requires_grad=True)
    (3.0 * tce._FusedCE.apply(torch.tensor(x), torch.tensor(w),
                              torch.from_numpy(t), torch.from_numpy(valid),
                              s, 32)).backward()
    np.testing.assert_allclose(float(s.grad), float(jg), rtol=1e-5)


@pytest.mark.parametrize("tied", [True, False])
def test_ragged_block_pad_values_do_not_matter(monkeypatch, tied):
    """Whatever the pad of the ragged last block holds (here finite
    garbage up to 1e3 instead of zeros), the loss and both gradients are
    the same: the forward masks the pad columns to NEG_INF and the
    backward zeroes their probabilities."""
    rng = np.random.RandomState(6)
    N, H, V = 24, 16, 100  # 100 = 64 + 36: the last block is ragged
    x = rng.normal(size=(N, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.1).astype(np.float32)
    t = rng.randint(0, V, N)
    t[:4] = V - 1 - np.arange(4)  # targets in the ragged block
    clean = _port(x, w, t, block=64, tied=tied)

    gen = torch.Generator().manual_seed(0)
    pad_rows, pad_w = tce._pad_rows, tce._pad_w

    def garbage_rows(rows, block):
        out = pad_rows(rows, block)
        out[rows.shape[0]:] = torch.rand(out[rows.shape[0]:].shape,
                                         generator=gen) * 1e3
        return out

    def garbage_w(w_, block):
        out, v = pad_w(w_, block)
        out = out.clone()
        out[:, v:] = torch.rand(out[:, v:].shape, generator=gen) * 1e3
        return out, v

    monkeypatch.setattr(tce, "_pad_rows", garbage_rows)
    monkeypatch.setattr(tce, "_pad_w", garbage_w)
    dirty = _port(x, w, t, block=64, tied=tied)
    assert dirty[0] == clean[0]
    for a, b in zip(dirty[2], clean[2]):
        np.testing.assert_array_equal(a, b)


def test_tied_and_untied_heads_agree():
    """The tied ``[V, h]`` table read in place and the untied ``[h, V]``
    kernel padded whole give the same loss and gradients."""
    rng = np.random.RandomState(8)
    N, H, V = 40, 16, 150
    x = rng.normal(size=(N, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.1).astype(np.float32)
    t = rng.randint(0, V, N)
    _close(_port(x, w, t, block=64, tied=True),
           _port(x, w, t, block=64, tied=False), rtol=1e-6, atol=1e-7)


class _Outputs(TorchDispatchMode):
    """Records the element count of every op's tensor outputs."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.sizes.append((str(func), o.numel()))
        return out


@pytest.mark.parametrize("tied", [True, False])
def test_no_tensor_of_n_by_v_elements(tied):
    """No op of the forward or the backward outputs N * V elements or
    more (h < N here, so the [V, h] weight gradient stays below)."""
    rng = np.random.RandomState(9)
    N, H, V, block = 256, 16, 1000, 128
    x = torch.tensor(rng.normal(size=(N, H)).astype(np.float32),
                     requires_grad=True)
    table = torch.tensor((rng.normal(size=(V, H)) * 0.1).astype(np.float32),
                         requires_grad=True)
    w = table.t() if tied else table.detach().t().contiguous(
    ).requires_grad_()
    t = torch.from_numpy(rng.randint(0, V, N))
    with _Outputs() as rec:
        loss, _ = tce.fused_linear_cross_entropy(x, w, t, block_vocab=block)
        loss.backward()
    assert rec.sizes and max(n for _, n in rec.sizes) < N * V, \
        max(rec.sizes, key=lambda s: s[1])
    assert max(n for _, n in rec.sizes) >= N * block  # the blocks ran


_STEP_CFG = dict(vocab_size=61, num_layers=2, num_heads=2, hidden_size=64,
                 max_seq_len=16)


def _tokens():
    """A global batch [4, 16]; rows 2-3 padded with -1 from position 9."""
    tokens = np.random.RandomState(0).randint(0, 61, (4, 16)).astype(
        np.int64)
    tokens[2:, 9:] = -1
    return tokens


class _Record(torch.optim.Optimizer):
    """An optimizer that keeps a copy of each parameter's gradient, by
    name order, and moves nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = None

    @torch.no_grad()
    def step(self, closure=None):
        self.grads = [p.grad.clone() for g in self.param_groups
                      for p in g["params"]]


def _step_result(tokens, fused_ce):
    """``make_lm_train_step`` at world 1 on the CPU: the loss it returns
    and the gradients its optimizer receives, by parameter name."""
    cfg = tt.TransformerConfig(dtype=torch.float32, **_STEP_CFG)
    hvd.init(device="cpu")
    try:
        model, step = hvd.make_lm_train_step(cfg, _Record, device="cpu",
                                             fused_ce=fused_ce)
        loss = float(step(torch.from_numpy(tokens)))
        grads = dict(zip([n for n, _ in model.named_parameters()],
                         step.optimizer._opt.grads))
    finally:
        hvd.shutdown()
    return loss, grads


def _grads_close(got, want):
    """Each gradient within 1e-5 of its own largest value plus 1e-6 of
    the largest over the model (for the attention key biases, whose true
    gradient is 0 and whose values are rounding noise)."""
    top = max(float(g.abs().max()) for g in want.values())
    for k, w in want.items():
        tol = 1e-5 * float(w.abs().max()) + 1e-6 * top
        assert float((got[k] - w).abs().max()) <= tol, k


def test_lm_step_fused_ce_matches_unfused():
    """``fused_ce=True`` gives the unfused step's loss within 1e-6
    relative and its gradients within ``_grads_close`` (float32; the two
    differ in the order of their sums only)."""
    tokens = _tokens()
    fl, fg = _step_result(tokens, True)
    ul, ug = _step_result(tokens, False)
    np.testing.assert_allclose(fl, ul, rtol=1e-6)
    _grads_close(fg, ug)


_WORKER = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt


class _Record(torch.optim.Optimizer):  # the test module's, copied
    def __init__(self, params):
        super().__init__(params, {})
        self.grads = None

    @torch.no_grad()
    def step(self, closure=None):
        self.grads = [p.grad.clone() for g in self.param_groups
                      for p in g["params"]]


out, cfg_kw = sys.argv[1], eval(sys.argv[2])
hvd.init(device="cpu")
r = hvd.rank()
tokens = torch.from_numpy(np.load(out + "/tokens.npy"))[2 * r:2 * r + 2]
cfg = tt.TransformerConfig(dtype=torch.float32, **cfg_kw)
model, step = hvd.make_lm_train_step(cfg, _Record, device="cpu",
                                     fused_ce=True)
loss = float(step(tokens))
names = [n for n, _ in model.named_parameters()]
torch.save({"loss": loss,
            "grads": dict(zip(names, step.optimizer._opt.grads))},
           out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_lm_step_fused_ce_world_of_two_is_world_one(tmp_path):
    """A gloo world of 2, each rank on its own rows (rank 1's padded
    unevenly), gives the world-1 step's loss on the global batch (the
    same global mean) within 1e-6 relative and its averaged gradients
    within ``_grads_close``."""
    tokens = _tokens()
    np.save(tmp_path / "tokens.npy", tokens)
    port = _free_port()
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path), repr(_STEP_CFG)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    loss1, grads1 = _step_result(tokens, True)
    for p in procs:
        try:
            out = p.communicate(timeout=120)[0]
        finally:
            p.kill()
        assert p.returncode == 0, out
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt")
        np.testing.assert_allclose(res["loss"], loss1, rtol=1e-6)
        _grads_close(res["grads"], grads1)


def test_jax_example_per_rank_mean_is_the_global_mean():
    """The JAX example averages each rank's own mean loss; with every
    target valid and even batches that equals the global mean the
    port's step takes (Σ nll over both ranks' rows / their count)."""
    rng = np.random.RandomState(10)
    B, T, H, V = 4, 9, 8, 30
    hidden = rng.normal(size=(B, T, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.1).astype(np.float32)
    toks = rng.randint(0, V, (B, T))
    per_rank = [float(jce.fused_causal_lm_loss(
        jnp.asarray(hidden[2 * r:2 * r + 2]), jnp.asarray(w),
        jnp.asarray(toks[2 * r:2 * r + 2]), block_vocab=16)[0])
        for r in range(2)]
    sums = [tce.fused_linear_cross_entropy(
        torch.from_numpy(hidden[2 * r:2 * r + 2, :-1]), torch.from_numpy(w),
        torch.from_numpy(toks[2 * r:2 * r + 2, 1:]), block_vocab=16,
        mean=False) for r in range(2)]
    glob = float(sum(s for s, _ in sums)) / float(sum(n for _, n in sums))
    np.testing.assert_allclose(np.mean(per_rank), glob, rtol=1e-6)


def test_examples_run_fused_ce_on_the_cpu():
    from horovod_tpu_torch.examples import bert_pretraining, gpt2_pretraining

    tiny = ["--layers", "2", "--hidden", "64", "--seq-len", "32",
            "--batch-size", "2", "--num-iters", "1",
            "--num-batches-per-iter", "2", "--num-warmup-batches", "1",
            "--device", "cpu", "--flash", "--fused-ce"]
    try:
        for main, extra in ((gpt2_pretraining.main, ["--fused-norm"]),
                            (bert_pretraining.main, ["--fused-ln",
                                                     "--zero"])):
            stats = {}
            rate, mfu = main(tiny + extra, stats)
            assert rate > 0 and mfu is None
            assert len(stats["losses"]) == 3
            assert np.isfinite(stats["losses"]).all()
    finally:
        hvd.shutdown()


def _entry_pair(monkeypatch, layers):
    """The JAX entry and the port's on the CPU, the port loaded with the
    JAX weights; GPT-2 small cut to ``layers`` when given."""
    import __graft_entry__ as graft

    import horovod_tpu.models as jmodels
    import horovod_tpu_torch.entry as tentry

    if layers:
        monkeypatch.setattr(jmodels, "GPT2_SMALL", dataclasses.replace(
            jmodels.GPT2_SMALL, num_layers=layers))
        monkeypatch.setattr(tentry, "GPT2_SMALL", dataclasses.replace(
            tentry.GPT2_SMALL, num_layers=layers))
    jfn, (params, jtok) = graft.entry()
    tfn, (model, ttok) = tentry.entry(device="cpu")
    assert model.cfg.max_seq_len == 512 and tuple(ttok.shape) == (4, 512)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        tl = float(tfn(model, ttok))
    return tl, float(jax.jit(jfn)(params, jtok))


def test_entry_matches_graft_entry(monkeypatch):
    """``entry(device="cpu")`` against ``__graft_entry__.entry()`` at 2 of
    GPT-2 small's 12 layers (its own widths, vocab and [4, 512] tokens),
    on the JAX weights: bf16 losses within 1e-4 relative."""
    tl, jl = _entry_pair(monkeypatch, 2)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


@pytest.mark.slow  # ~25 s on one core: GPT-2 small's 12 layers in both
def test_entry_matches_graft_entry_full_depth(monkeypatch):
    tl, jl = _entry_pair(monkeypatch, 0)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_entry_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() would use it")
    from horovod_tpu_torch.entry import entry

    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
