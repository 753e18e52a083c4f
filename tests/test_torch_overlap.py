"""The backward-interleaved collective schedule (HOROVOD_OVERLAP_SCHEDULE,
``ops/overlap.py``) and its schedules (``ops/fusion.py``) against the
JAX package.

* the mode spellings and the issue, prefetch and regather schedules are
  the JAX package's, list for list, for the same plans;
* the stages of a transformer, composed, are its forward, bitwise (tied
  and untied heads, learned and rotary positions, the fused
  cross-entropy head, per-block recomputation);
* with the knob in any mode ``make_lm_train_step`` keeps the
  hook-driven step of the DistributedOptimizer and ZeRO-1; an unknown
  spelling raises; the staged FSDP runner refuses them;
* worlds of two and four over gloo train a tiny GPT through
  ``make_lm_train_step`` 3 AdamW steps with uneven ``-1`` padding, under
  the DistributedOptimizer and ZeRO-1: ``stage`` and ``double`` are
  bitwise the knob off (losses and parameters; at world 2 on the int8
  wire with error feedback too, residuals included); the hooks issue
  each bucket during the backward of the stage after which the JAX
  package's ``bucket_issue_schedule`` issues it (the stage read from
  backward hooks on the blocks); at world 2 the ZeRO-1 step agrees with
  the JAX package's staged one (``make_lm_train_step`` on a ``dp = 2``
  mesh with the schedule on): losses within 1e-5 relative, parameters
  within 1e-6 + 1% of steps x lr (lr a step for the attention key
  biases, whose true gradient is 0).
"""

import dataclasses
import functools
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.core.state import global_state as jax_state
from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.ops import overlap as joverlap
from horovod_tpu.parallel import train as jtrain
from horovod_tpu.parallel.mesh import make_mesh
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.ops import fusion, overlap
from horovod_tpu_torch.optim import zero

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
LR = 1e-3
EPS = 1e-6
STEPS = 3
BLOCK = 32
THRESH = 8 << 10
_CFG = dict(vocab_size=61, num_layers=2, num_heads=2, hidden_size=64,
            max_seq_len=16)


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    yield
    hvd.shutdown()


# ---------------------------------------------------------------------------
# modes and schedules
# ---------------------------------------------------------------------------

def test_overlap_mode_normalization():
    for v in ("", None, "0", "off", "OFF", "none", "false", "1", "on",
              "stage", " Stage ", "yes", "2", "double", "double-buffer",
              "double_buffer"):
        assert overlap.normalize_mode(v) == joverlap.normalize_mode(v), v
    for bad in ("bogus", "3"):
        with pytest.raises(ValueError, match="overlap schedule"):
            overlap.normalize_mode(bad)
    assert hvd.Knobs().overlap_schedule == "off"
    assert overlap.schedule_mode(hvd.Knobs(overlap_schedule="2")) == \
        "double"
    assert overlap.schedule_mode(hvd.Knobs(overlap_schedule="1")) == "stage"
    assert overlap.schedule_mode(hvd.Knobs()) == "off"


def _random_plans(rs, nleaves, nbuckets):
    idx = rs.permutation(nleaves)
    cuts = sorted(rs.choice(np.arange(1, nleaves), nbuckets - 1,
                            replace=False))
    plans = []
    for part in np.split(idx, cuts):
        off, plan = 0, []
        for i in part:
            size = int(rs.randint(1, 9))
            plan.append((int(i), off, size, (size,)))
            off += size
        plans.append(plan)
    return plans


@pytest.mark.parametrize("seed", range(4))
def test_schedules_match_jax(seed):
    """For the same plans and stage maps the port's schedules are the JAX
    package's lists, in each direction; so are the bucket lengths."""
    rs = np.random.RandomState(seed)
    nleaves, S = 12, 6
    plans = _random_plans(rs, nleaves, 4)
    leaf_stages = [sorted(set(rs.randint(0, S, rs.randint(1, 3)).tolist()))
                   for _ in range(nleaves)]
    order = list(reversed(range(S)))
    assert fusion.plan_bucket_lengths(plans) == \
        jfusion.plan_bucket_lengths(plans)
    assert fusion.bucket_issue_schedule(plans, leaf_stages, order) == \
        jfusion.bucket_issue_schedule(plans, leaf_stages, order)
    first = [min(s) for s in leaf_stages]
    last = [max(s) for s in leaf_stages]
    assert fusion.bucket_prefetch_schedule(plans, first, S) == \
        jfusion.bucket_prefetch_schedule(plans, first, S)
    assert fusion.bucket_regather_schedule(plans, last, S) == \
        jfusion.bucket_regather_schedule(plans, last, S)


def test_bucket_issue_schedule_bookkeeping():
    """A tied leaf (stages 0 and 2) completes at its last stage; a leaf
    no stage reaches raises."""
    plans = [[(0, 0, 4, (4,))], [(1, 0, 4, (4,))], [(2, 0, 4, (4,))]]
    sched = fusion.bucket_issue_schedule(plans, [[2], [1], [0, 2]],
                                         [2, 1, 0])
    assert sched == [[0], [1], [2]]
    with pytest.raises(ValueError, match="never complete"):
        fusion.bucket_issue_schedule(plans, [[2], [5], [0, 2]], [2, 1, 0])
    leaves = [torch.arange(4.0) + i for i in range(3)]
    buckets, unflatten = fusion.pack_pytree_by_plan(leaves, plans)
    assert [b.tolist() for b in buckets] == [t.tolist() for t in leaves]
    back = unflatten([b * 2 for b in buckets])
    for a, b in zip(back, leaves):
        assert torch.equal(a, b * 2)


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["tied", "untied-rope", "remat",
                                     "fused-ce"])
def test_stages_compose_to_the_forward(variant):
    cfg = tt.TransformerConfig(dtype=torch.float32, **_CFG)
    if variant == "untied-rope":
        cfg = dataclasses.replace(cfg, tie_embeddings=False,
                                  position="rope")
    if variant == "remat":
        cfg = dataclasses.replace(cfg, remat=True)
    model = tt.Transformer(cfg).init_params(
        torch.Generator().manual_seed(3))
    tok = torch.from_numpy(np.random.RandomState(0).randint(0, 61, (2, 16)))
    named = dict(model.named_parameters())
    if variant == "fused-ce":
        from horovod_tpu_torch.ops.fused_cross_entropy import \
            fused_linear_cross_entropy

        def fused(h, w):
            return fused_linear_cross_entropy(
                h[:, :-1], w, tok[:, 1:], valid=tok[:, 1:] != -1,
                mean=False)[0]

        stages = overlap.transformer_lm_stages(model, tok,
                                               fused_loss_fn=fused)
        want = fused(model(tok, return_hidden=True),
                     model.tok_emb.embedding.t())
    else:
        stages = overlap.transformer_lm_stages(
            model, tok, lambda lg: tt.causal_lm_loss(lg, tok)[0])
        want = tt.causal_lm_loss(model(tok), tok)[0]
    carry = torch.zeros(())
    for st in stages:
        carry = st.fwd({k: v for k, v in named.items()
                        if k.split(".")[0] in st.keys}, carry)
    assert torch.equal(carry, want)
    assert [s.name for s in stages] == ["embed", "block_0", "block_1",
                                        "head"]
    want.backward()
    ref = {k: p.grad.clone() for k, p in named.items()}
    model.zero_grad()
    carry = torch.zeros(())
    for st in stages:
        carry = st.fwd({k: v for k, v in named.items()
                        if k.split(".")[0] in st.keys}, carry)
    carry.backward()
    for k, p in named.items():
        assert torch.equal(p.grad, ref[k]), k


@pytest.mark.parametrize("kind", ["dist", "zero"])
def test_knob_keeps_the_hook_driven_step(kind):
    """At world 1 every mode trains the same hook-driven step, bitwise;
    an unknown spelling raises before a model is built."""
    hvd.init(device="cpu")
    knobs = hvd.core.state.global_state().knobs
    cfg = tt.TransformerConfig(dtype=torch.float32, **_CFG)
    tok = torch.from_numpy(_tokens(1))
    factory = functools.partial(torch.optim.AdamW, lr=LR, eps=EPS)
    runs = {}
    for mode in ("off", "stage", "double"):
        knobs.overlap_schedule = mode
        opt = (hvd.ShardedOptimizer(factory) if kind == "zero"
               else factory)
        model, step = hvd.make_lm_train_step(cfg, opt, device="cpu")
        assert not hasattr(step, "vag")
        want = (zero._ShardedOptimizer if kind == "zero"
                else hvd.optim.distributed._DistributedOptimizer)
        assert type(step.optimizer) is want
        runs[mode] = ([step(tok) for _ in range(2)], model.state_dict())
    for mode in ("stage", "double"):
        for a, b in zip(runs[mode][0], runs["off"][0]):
            assert torch.equal(a, b), mode
        for k, v in runs["off"][1].items():
            assert torch.equal(runs[mode][1][k], v), (mode, k)
    knobs.overlap_schedule = "bogus"
    with pytest.raises(ValueError, match="overlap schedule"):
        hvd.make_lm_train_step(cfg, factory, device="cpu")


def test_fsdp_runner_refuses_replicated_optimizers():
    hvd.init(device="cpu")
    lin = torch.nn.Linear(2, 2)
    sgd = functools.partial(torch.optim.SGD, lr=0.1)
    dist_opt = hvd.DistributedOptimizer(
        sgd(lin.parameters()), named_parameters=lin.named_parameters())
    named = [("dense.kernel", lin.weight), ("dense.bias", lin.bias)]
    for opt in (dist_opt, sgd(lin.parameters()),
                hvd.ShardedOptimizer(sgd, named),
                hvd.ShardedOptimizer(sgd)):
        with pytest.raises(ValueError, match="FullyShardedOptimizer"):
            overlap.fsdp_staged_value_and_grad(lambda b: [], opt)


# ---------------------------------------------------------------------------
# worlds of two and four over gloo
# ---------------------------------------------------------------------------

_WORKER = r'''
import functools, sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.models import transformer as tt

out, lr, eps, steps, thresh = (sys.argv[1], float(sys.argv[2]),
                               float(sys.argv[3]), int(sys.argv[4]),
                               int(sys.argv[5]))
scenarios = sys.argv[6].split(",")
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
cfg = tt.TransformerConfig(dtype=torch.float32, **eval(sys.argv[7]))
init = torch.load(out + "/init.pt")
tok = torch.load(out + "/tokens.pt")[2 * r:2 * r + 2]
knobs = global_state().knobs
res = {}
for sc in scenarios:
    kind, mode, wire = sc.split(":")
    knobs.overlap_schedule = mode
    factory = functools.partial(torch.optim.AdamW, lr=lr, eps=eps,
                                weight_decay=1e-4)
    comp = hvd.Compression.int8 if wire == "int8" else hvd.Compression.none
    if kind == "zero":
        opt = hvd.ShardedOptimizer(factory, compression=comp,
                                   fusion_threshold_bytes=thresh)
    else:
        def opt(ps, _f=factory):
            return _f(ps)
    if kind == "dist":
        knobs.fusion_threshold_bytes = thresh
        knobs.compression = wire or "none"
    model, step = hvd.make_lm_train_step(cfg, opt, device="cpu")
    model.load_state_dict(init)
    # the stage whose backward runs when a bucket is issued: the head's
    # at first, block j's (stage j + 1) from its output gradient on, the
    # embedding's (stage 0) from block 0's input gradient on
    S, at, log = cfg.num_layers + 2, [0], []
    for j in range(cfg.num_layers):
        getattr(model, "block_%d" % j).register_full_backward_pre_hook(
            lambda m, go, _j=j: at.__setitem__(0, _j + 1))
    model.block_0.register_full_backward_hook(
        lambda m, gi, go: at.__setitem__(0, 0))
    orig = step.optimizer._issue
    def issue(b, _orig=orig):
        log[-1].append((S - 1 - at[0], b))
        _orig(b)
    step.optimizer._issue = issue
    rec = {"losses": [], "params": []}
    for _ in range(steps):
        at[0] = S - 1
        log.append([])
        rec["losses"].append(step(tok).clone())
        rec["params"].append({k: v.clone()
                              for k, v in model.state_dict().items()})
    rec["staged"] = hasattr(step, "vag")
    rec["issue_log"] = log
    rec["res"] = {k: v.clone() for k, v in
                  getattr(step.optimizer, "error_feedback_residual",
                          {}).items()}
    rec["plan"] = step.optimizer.bucket_plan
    rec["names"] = list(getattr(step.optimizer, "_names"))
    knobs.fusion_threshold_bytes = 128 * 1024 * 1024
    knobs.compression = "none"
    res[sc] = rec
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flax_params():
    m = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **_CFG))
    return jax.tree.map(np.asarray, jax.jit(m.init)(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"])


def _tokens(n):
    """Rank r's rows are [2r, 2r + 2); the odd ranks' rows are padded
    with -1 from position 9 on."""
    t = np.random.RandomState(0).randint(0, 61, (2 * n, 16)).astype(np.int64)
    for r in range(1, n, 2):
        t[2 * r:2 * r + 2, 9:] = -1
    return t


def _spawn(tmp_path, n, scenarios):
    torch.save(params_from_flax(_flax_params()), tmp_path / "init.pt")
    torch.save(torch.from_numpy(_tokens(n)), tmp_path / "tokens.pt")
    port = _free_port()
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   HOROVOD_COMPRESSION_BLOCK=str(BLOCK),
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path), repr(LR),
             repr(EPS), str(STEPS), str(THRESH), ",".join(scenarios),
             repr(_CFG)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _collect(procs, tmp_path):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=150)[0])
        finally:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def _expected_issue_log(names, plans):
    keys = [("tok_emb", "pos_emb")] + [
        (f"block_{i}",) for i in range(_CFG["num_layers"])] + [
        ("ln_final", "tok_emb")]
    leaf_stages = [[s for s, ks in enumerate(keys) if n.split(".")[0] in ks]
                   for n in names]
    sched = jfusion.bucket_issue_schedule(
        [list(p) for p in plans], leaf_stages,
        list(reversed(range(len(keys)))))
    return [(step, b) for step, bs in enumerate(sched) for b in bs]


def _check_bitwise(res, n, kinds):
    for kind, wire in kinds:
        off = f"{kind}:off:{wire}"
        for mode in ("stage", "double"):
            sc = f"{kind}:{mode}:{wire}"
            for r in range(n):
                a, b = res[r][sc], res[r][off]
                assert not a["staged"] and not b["staged"], sc
                assert len(a["plan"]) > 2
                for t in range(STEPS):
                    assert torch.equal(a["losses"][t], b["losses"][t]), \
                        (sc, r, t)
                    for k, v in b["params"][t].items():
                        assert torch.equal(a["params"][t][k], v), \
                            (sc, r, t, k)
                assert a["res"].keys() == b["res"].keys()
                for k, v in b["res"].items():
                    assert torch.equal(a["res"][k], v), (sc, r, k)
                want = _expected_issue_log(a["names"], a["plan"])
                assert a["issue_log"] == [want] * STEPS, sc
                assert b["issue_log"] == [want] * STEPS, off
    if any(w == "int8" for _, w in kinds):
        assert res[0]["dist:stage:int8"]["res"]


def _jax_zero_staged(n):
    """The JAX package's make_lm_train_step with ShardedOptimizer on a
    dp = n mesh, the schedule on: losses and parameters."""
    mesh = make_mesh(dp=n, devices=jax.devices()[:n])
    jhvd.init(mesh=mesh, dp_axis="dp")
    st = jax_state()
    st.knobs = dataclasses.replace(st.knobs, overlap_schedule="stage")
    cfg = jt.TransformerConfig(dtype=jnp.float32, **_CFG)
    opt = jhvd.ShardedOptimizer(optax.adamw(LR, eps=EPS, weight_decay=1e-4),
                                axis_name="dp",
                                fusion_threshold_bytes=THRESH)
    params = jax.tree.map(jnp.asarray, _flax_params())
    state = opt.init(params)
    _, step, batch_sharding = jtrain.make_lm_train_step(cfg, opt, mesh,
                                                        donate=False)
    tok = jax.device_put(jnp.asarray(_tokens(n).astype(np.int32)),
                         batch_sharding)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, tok)
        losses.append(float(loss))
    return losses, params_from_flax(jax.tree.map(np.asarray, params))


def test_world_of_two(tmp_path, monkeypatch):
    n = 2
    kinds = [("dist", ""), ("zero", ""), ("dist", "int8")]
    scenarios = [f"{k}:{m}:{w}" for k, w in kinds
                 for m in ("off", "stage", "double")]
    procs = _spawn(tmp_path, n, scenarios)
    saved = jax_state().knobs
    try:
        want_losses, want_params = _jax_zero_staged(n)
    finally:
        jax_state().knobs = saved
        res = _collect(procs, tmp_path)
    _check_bitwise(res, n, kinds)
    got = res[0]["zero:stage:"]
    np.testing.assert_allclose([float(x) for x in got["losses"]],
                               want_losses, rtol=1e-5)
    for name, w in want_params.items():
        tol = (STEPS * LR * 1.01 if name.endswith("attn.key.bias")
               else 1e-6 + 1e-2 * STEPS * LR)
        err = float((got["params"][-1][name] - w).abs().max())
        assert err <= tol, (name, err, tol)


def test_world_of_four(tmp_path):
    n = 4
    kinds = [("dist", ""), ("zero", "")]
    scenarios = [f"{k}:{m}:{w}" for k, w in kinds
                 for m in ("off", "stage", "double")]
    res = _collect(_spawn(tmp_path, n, scenarios), tmp_path)
    _check_bitwise(res, n, kinds)
