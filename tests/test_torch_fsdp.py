"""The port's fully-sharded parameters (``optim/fsdp.py``) and its FSDP
staged step (``ops/overlap.fsdp_staged_value_and_grad``) against the JAX
package, on a tiny transformer (vocab 64, 2 layers, 2 heads, hidden 32,
float32, an 8 KB fusion threshold: several buckets).

* the layout (plan, widths, bytes), the row dict, the round trip and
  ``reshard_rows`` are the JAX package's, bitwise; ``_offload_stage_set``
  picks the JAX package's stages;
* the update contract and the knob gates raise as the JAX package's
  do; ``ShardedOptimizer(params_sharded=True)`` is the
  FullyShardedOptimizer; ``make_lm_train_step`` routes it to the FSDP
  step;
* a world of one: ``make_lm_train_step`` with a FullyShardedOptimizer in
  each mode (regather, saved gathers, prefetch 0 and 2, offload) is
  bitwise the DistributedOptimizer step, losses and parameters;
* worlds of two and four over gloo, 3 AdamW steps: every mode (regather,
  saved, prefetch 0 and 2, offload) bitwise the gathered reference
  (``fsdp_value_and_grad(mode="upfront")``): parameter shards, gradient
  shards, losses, AdamW state, and on the int8 wire (block 32) with error
  feedback the residual rows; each bucket's reduce-scatter issued at the
  boundary ``bucket_issue_schedule`` (the JAX package's) names, each
  gather at ``bucket_prefetch_schedule``'s / ``bucket_regather_schedule``'s;
  a rank's AdamW state 1/n of the replicated one; the parameters within
  1e-6 + 1% of steps x lr of the JAX package's FullyShardedOptimizer step
  in ``shard_map`` on a mesh of the same size (lr a step for the
  attention key biases, whose true gradient is 0), each rank's m and v
  rows within 1e-4 relative (L2); the world of two composed in one
  process (``EmulatedWorld``), bitwise the world's on both wires.
"""

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
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.compat import shard_map
from horovod_tpu.core.state import global_state as jax_state
from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.ops import overlap as joverlap
from horovod_tpu.optim import fsdp as jfsdp
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.ops import overlap
from horovod_tpu_torch.optim import fsdp

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
LR = 1e-3
EPS = 1e-6
STEPS = 3
BLOCK = 32
THRESH = 8 << 10
_CFG = dict(vocab_size=64, num_layers=2, num_heads=2, hidden_size=32,
            max_seq_len=16)
MODES = {"regather": dict(),
         "saved": dict(regather=False),
         "prefetch0": dict(prefetch=0),
         "prefetch2": dict(prefetch=2),
         "offload": dict(offload=True)}


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    yield
    hvd.shutdown()


@pytest.fixture
def _jax_knobs_restored():
    saved = jax_state().knobs
    yield
    jax_state().knobs = saved


@functools.lru_cache(maxsize=None)
def _flax_params():
    m = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **_CFG))
    return jax.tree.map(np.asarray, jax.jit(m.init)(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"])


def _torch_named():
    return [(k, torch.nn.Parameter(v))
            for k, v in params_from_flax(_flax_params()).items()]


def _layouts(world):
    jl = jfsdp.fsdp_layout(_flax_params(), world=world,
                           fusion_threshold_bytes=THRESH,
                           bucket_backward_order=True)
    tl = fsdp.fsdp_layout(_torch_named(), world=world,
                          fusion_threshold_bytes=THRESH,
                          bucket_backward_order=True)
    return jl, tl


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_layout_matches_jax(world):
    if world == 1:  # the JAX package refuses a size-1 layout
        tl = fsdp.fsdp_layout(_torch_named(), world=1,
                              fusion_threshold_bytes=THRESH)
        assert tl.ks == tl.lens and tl.shard_bytes == tl.param_bytes
        return
    jl, tl = _layouts(world)
    assert len(tl.plans) > 2
    assert [[(i, o, s, tuple(sh)) for (i, o, s, sh) in p] for p in tl.plans] \
        == [[(i, o, s, tuple(sh)) for (i, o, s, sh) in p] for p in jl.plans]
    assert tl.lens == jl.lens and tl.ks == jl.ks
    assert (tl.param_bytes, tl.shard_bytes, tl.max_bucket_bytes) == \
        (jl.param_bytes, jl.shard_bytes, jl.max_bucket_bytes)
    abs_t = fsdp.abstract_params(tl)
    for name, (shape, _) in zip(tl.names, zip(tl.shapes, tl.dtypes)):
        assert tuple(abs_t[name].shape) == shape
        assert abs_t[name].device.type == "meta"


def test_layout_shard_unshard_roundtrip():
    """shard -> unshard is the identity, bitwise; the rows are the JAX
    package's ``shard_params`` rows; each rank's own rows are the
    optimizer's shards."""
    hvd.init(device="cpu")
    world = 8
    jl, tl = _layouts(world)
    named = _torch_named()
    rows = fsdp.shard_params(named, tl)
    jrows = jfsdp.shard_params(_flax_params(), jl)
    assert sorted(rows) == sorted(jrows)
    for k in rows:
        assert rows[k].shape == (world, tl.ks[int(k[-4:])])
        np.testing.assert_array_equal(rows[k].numpy(), np.asarray(jrows[k]))
    back = fsdp.unshard_params(rows, tl)
    for name, t in named:
        assert torch.equal(back[name], t), name
    for r in (0, 5, 7):
        opt = fsdp.FullyShardedOptimizer(
            functools.partial(torch.optim.AdamW, lr=LR), named,
            fusion_threshold_bytes=THRESH, world=world, rank=r)
        for b, s in enumerate(fsdp.local_shards(rows, tl, rank=r)):
            assert torch.equal(opt.shards[b], s)
    assert tl.shard_bytes * world >= tl.param_bytes
    assert tl.max_bucket_bytes <= tl.param_bytes + world * 4


def test_reshard_rows_across_world_sizes():
    """8 -> 4 -> 8 keeps every element, and the 4-world rows are the JAX
    package's ``reshard_rows`` rows."""
    jl, tl = _layouts(8)
    rows = fsdp.shard_params(_torch_named(), tl)
    r4 = fsdp.reshard_rows(rows, tl, 4)
    j4 = jfsdp.reshard_rows(jfsdp.shard_params(_flax_params(), jl), jl, 4)
    for i, L in enumerate(tl.lens):
        k = fsdp.bucket_name(i)
        assert r4[k].shape == (4, -(-L // 4))
        np.testing.assert_array_equal(r4[k].numpy(), np.asarray(j4[k]))
    t4 = tl._replace(world=4, ks=tuple(-(-L // 4) for L in tl.lens))
    back = fsdp.unshard_params(r4, t4)
    for name, t in _torch_named():
        assert torch.equal(back[name], t), name
    r8 = fsdp.reshard_rows(r4, t4, 8)
    for k in rows:
        assert torch.equal(r8[k], rows[k])


def test_apply_shard_updates_and_offload_stages():
    _, tl = _layouts(2)
    rows = fsdp.shard_params(_torch_named(), tl)
    local = fsdp.local_shards(rows, tl, rank=1)
    upd = [torch.full_like(s, 0.5) for s in local]
    one = {k: v[1:2] for k, v in rows.items()}
    new = fsdp.apply_shard_updates(one, upd, tl)
    for b, s in enumerate(local):
        got = new[fsdp.bucket_name(b)]
        assert got.shape == (1, s.numel())
        assert torch.equal(got.reshape(-1), s + 0.5)
    for S in (1, 2, 3, 5, 26):
        for duty in (0.0, 0.1, 0.5, 1.0, 2.0):
            assert overlap._offload_stage_set(S, duty) == \
                joverlap._offload_stage_set(S, duty), (S, duty)


def test_update_contract_errors():
    """Misuse fails at the cause, with the JAX package's messages."""
    hvd.init(device="cpu")
    named = _torch_named()
    factory = functools.partial(torch.optim.AdamW, lr=LR)
    opt = fsdp.FullyShardedOptimizer(factory, named,
                                     fusion_threshold_bytes=THRESH)
    with pytest.raises(ValueError, match="staged gradient shards"):
        opt.step()
    with pytest.raises(ValueError, match="staged gradient shards"):
        opt.step([torch.ones(3)])
    with pytest.raises(ValueError, match="SAME layout"):
        opt.step(overlap.StagedShards([torch.zeros(3)]))
    with pytest.raises(ValueError, match="world size >= 1"):
        fsdp.fsdp_layout(named, world=0)
    with pytest.raises(ValueError, match="new_world"):
        fsdp.reshard_rows(fsdp.shard_params(named, opt.layout),
                          opt.layout, 0)
    with pytest.raises(ValueError, match="FullyShardedOptimizer"):
        fsdp.fsdp_value_and_grad(
            lambda b: [], hvd.ShardedOptimizer(factory, named), opt.layout)
    with pytest.raises(ValueError, match="FullyShardedOptimizer"):
        overlap.fsdp_staged_value_and_grad(
            lambda b: [], hvd.ShardedOptimizer(factory, named), opt.layout)
    with pytest.raises(ValueError, match="FsdpLayout"):
        overlap.fsdp_staged_value_and_grad(lambda b: [], opt)
    with pytest.raises(ValueError, match="unknown fsdp mode"):
        fsdp.fsdp_value_and_grad(lambda b: [], opt, opt.layout, mode="x")
    with pytest.raises(ValueError, match="meta tensors"):
        fsdp.FullyShardedOptimizer(
            factory, [(n, t.to("meta")) for n, t in named])
    # the int8 error-feedback wire: the residual rides opt_state
    ef = fsdp.FullyShardedOptimizer(
        factory, named, compression=hvd.Compression.int8,
        fusion_threshold_bytes=THRESH)
    assert isinstance(ef.opt_state, fsdp.FsdpEFState)
    with pytest.raises(ValueError, match="without an updated residual"):
        ef.step(overlap.StagedShards([torch.zeros_like(s)
                                      for s in ef.shards]))
    bad = fsdp.FsdpEFState(ef._opt, [r[:, :-1] for r in ef.residuals])
    with pytest.raises(ValueError, match="compression-block"):
        fsdp._residual_mats(bad, ef.layout, hvd.Compression.int8
                            .resolved_block())
    vag = fsdp.fsdp_value_and_grad(lambda b: [], ef, ef.layout,
                                   mode="upfront")
    with pytest.raises(ValueError, match="opt_state="):
        vag(ef.shards, torch.zeros(1, 4, dtype=torch.long))


def test_sharded_optimizer_params_sharded_entry():
    """``ShardedOptimizer(params_sharded=True)`` is the
    FullyShardedOptimizer, bound or not; without parameters either
    optimizer waits for ``make_lm_train_step`` to bind it."""
    hvd.init(device="cpu")
    factory = functools.partial(torch.optim.AdamW, lr=LR)
    unbound = hvd.ShardedOptimizer(factory, params_sharded=True)
    assert unbound._hvd_overlap_info["kind"] == "fsdp"
    assert isinstance(unbound, fsdp.UnboundOptimizer)
    bound = unbound.bind(_torch_named())
    assert isinstance(bound, fsdp._FullyShardedOptimizer)
    assert bound._hvd_overlap_info["kind"] == "fsdp"
    direct = hvd.ShardedOptimizer(factory, _torch_named(),
                                  params_sharded=True)
    assert [tuple(s.shape) for s in direct.shards] == \
        [tuple(s.shape) for s in bound.shards]
    assert hvd.ShardedOptimizer(factory)._hvd_overlap_info["kind"] == "zero"
    assert hvd.FullyShardedOptimizer is fsdp.FullyShardedOptimizer


def test_make_lm_train_step_routes_fsdp_and_knob_gates():
    """A FullyShardedOptimizer routes make_lm_train_step to the FSDP
    step (its model's parameters on the meta device, the rows in the
    optimizer); HOROVOD_FSDP=0 makes it raise; the knob does not touch
    the DistributedOptimizer step; a mesh whose one data axis is the
    world takes the same step, and sequence parallelism raises."""
    hvd.init(device="cpu")
    cfg = tt.TransformerConfig(dtype=torch.float32, **_CFG)
    factory = functools.partial(torch.optim.AdamW, lr=LR)
    model, step = hvd.make_lm_train_step(
        cfg, hvd.FullyShardedOptimizer(factory), device="cpu")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert isinstance(step.optimizer, fsdp._FullyShardedOptimizer)
    assert np.isfinite(float(step(torch.randint(0, 64, (2, 16)))))
    assert step.vag.param_bytes == step.layout.shard_bytes
    knobs = hvd.core.state.global_state().knobs
    knobs.fsdp = False
    try:
        with pytest.raises(ValueError, match="HOROVOD_FSDP"):
            hvd.make_lm_train_step(cfg, hvd.FullyShardedOptimizer(factory),
                                   device="cpu")
        _, plain = hvd.make_lm_train_step(cfg, factory, device="cpu")
        assert isinstance(plain.optimizer,
                          hvd.optim.distributed._DistributedOptimizer)
    finally:
        knobs.fsdp = True
    # a mesh whose one data axis is the world is the FSDP step's own
    # world (here of one rank): the same step; sequence parallelism
    # raises, as in the JAX package
    tokens = torch.randint(0, 64, (2, 16))
    _, plain = hvd.make_lm_train_step(
        cfg, hvd.FullyShardedOptimizer(factory), device="cpu")
    _, on_mesh = hvd.make_lm_train_step(
        cfg, hvd.FullyShardedOptimizer(factory), mesh="fsdp=1",
        device="cpu")
    assert float(on_mesh(tokens)) == float(plain(tokens))
    with pytest.raises(ValueError, match="sequence"):
        hvd.make_lm_train_step(cfg, hvd.FullyShardedOptimizer(factory),
                               sequence_parallel="ring")


def test_knobs_defaults_and_parser(monkeypatch):
    from horovod_tpu.core.knobs import Knobs as JKnobs
    from horovod_tpu_torch.core.knobs import Knobs
    from horovod_tpu_torch.runner.util.config_parser import ARG_TO_ENV

    names = ("overlap_schedule", "fsdp", "fsdp_prefetch", "fsdp_regather",
             "fsdp_offload", "fsdp_offload_duty")
    assert {n: getattr(Knobs(), n) for n in names} == \
        {n: getattr(JKnobs(), n) for n in names}
    assert Knobs().fsdp is True and Knobs().fsdp_prefetch == 1
    for n in names[1:]:
        assert ARG_TO_ENV[n] == "HOROVOD_" + n.upper()
    for env in ({"HOROVOD_FSDP": "0", "HOROVOD_FSDP_PREFETCH": "2",
                 "HOROVOD_FSDP_REGATHER": "false",
                 "HOROVOD_FSDP_OFFLOAD": "yes",
                 "HVD_TPU_FSDP_OFFLOAD_DUTY": "0.25",
                 "HOROVOD_OVERLAP_SCHEDULE": "double"},
                {"HOROVOD_FSDP_PREFETCH": "x",
                 "HOROVOD_FSDP_OFFLOAD_DUTY": "", "HOROVOD_FSDP": "on"}):
        for k in list(os.environ):
            if k.startswith(("HOROVOD_", "HVD_TPU_")):
                monkeypatch.delenv(k)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        mine, theirs = Knobs.from_env(), JKnobs.from_env()
        assert {n: getattr(mine, n) for n in names} == \
            {n: getattr(theirs, n) for n in names}, env


@pytest.mark.parametrize("mode", sorted(MODES))
def test_world_of_one_is_the_distributed_step(mode, monkeypatch):
    """At world 1 the FSDP step (rows of (1, L): the buckets) is the
    DistributedOptimizer step bit for bit, in each mode, through
    make_lm_train_step and the knobs."""
    env = {"regather": {}, "saved": {"HOROVOD_FSDP_REGATHER": "0"},
           "prefetch0": {"HOROVOD_FSDP_PREFETCH": "0"},
           "prefetch2": {"HOROVOD_FSDP_PREFETCH": "2"},
           "offload": {"HOROVOD_FSDP_OFFLOAD": "1"}}[mode]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    hvd.init(device="cpu")
    cfg = tt.TransformerConfig(dtype=torch.float32, **_CFG)
    factory = functools.partial(torch.optim.AdamW, lr=LR, eps=EPS,
                                weight_decay=1e-4)
    tok = torch.from_numpy(np.random.RandomState(1).randint(
        0, 64, (2, 16)))
    tok[1, 9:] = -1
    model, step = hvd.make_lm_train_step(cfg, factory, device="cpu")
    want = [float(step(tok)) for _ in range(STEPS)]
    ref = {k: v.clone() for k, v in model.state_dict().items()}
    _, fstep = hvd.make_lm_train_step(
        cfg, hvd.FullyShardedOptimizer(factory,
                                       fusion_threshold_bytes=THRESH),
        device="cpu")
    got = [float(fstep(tok)) for _ in range(STEPS)]
    assert got == want
    sd = fstep.state_dict()
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k
    v = fstep.vag
    # the carries entering the blocks: stages 1 .. S-2 of embed, 2
    # blocks, head
    assert v.offload_bytes == (2 * (2 * 16 * 32 * 4) if mode == "offload"
                               else 0)
    assert (v.regather_bytes > 0) == (mode != "saved")
    assert v.param_bytes == fstep.layout.shard_bytes
    assert v.peak_param_bytes <= v.param_bytes + fstep.layout.param_bytes


# ---------------------------------------------------------------------------
# worlds of two and four over gloo
# ---------------------------------------------------------------------------

_WORKER = r'''
import functools, sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import overlap
from horovod_tpu_torch.optim import fsdp

out, lr, eps, steps, thresh = (sys.argv[1], float(sys.argv[2]),
                               float(sys.argv[3]), int(sys.argv[4]),
                               int(sys.argv[5]))
scenarios = sys.argv[6].split(",")
modes = eval(sys.argv[7])
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
cfg = tt.TransformerConfig(dtype=torch.float32, **eval(sys.argv[8]))
init = torch.load(out + "/init.pt")
tokens = torch.load(out + "/tokens.pt")
tok = tokens[2 * r:2 * r + 2]
with torch.device("meta"):
    model = tt.Transformer(cfg)


def stages_fn(b):
    return overlap.transformer_lm_stages(
        model, b, lambda lg: tt.causal_lm_loss(lg, b)[0])


res = {}
for sc in scenarios:
    mode, _, wire = sc.partition(":")
    comp = hvd.Compression.int8 if wire == "int8" else hvd.Compression.none
    opt = fsdp.FullyShardedOptimizer(
        functools.partial(torch.optim.AdamW, lr=lr, eps=eps,
                          weight_decay=1e-4),
        init.items(), compression=comp, fusion_threshold_bytes=thresh)
    if mode == "upfront":
        vag = fsdp.fsdp_value_and_grad(stages_fn, opt, opt.layout,
                                       mode="upfront")
    else:
        vag = fsdp.fsdp_value_and_grad(stages_fn, opt, opt.layout,
                                       **modes[mode])
    trace = []
    for t in range(steps):
        loss, g = vag(opt.shards, tok, opt_state=opt.opt_state)
        opt.step(g)
        rec = {"loss": loss.clone(), "shards": [s.detach().clone()
                                                for s in opt.shards],
               "grads": [x.clone() for x in g.shards]}
        if opt.residuals is not None:
            rec["res"] = [x.clone() for x in opt.residuals]
        trace.append(rec)
        opt.zero_grad()
    st = opt._opt.state
    entry = {"trace": trace, "ks": list(opt.layout.ks),
             "m": [st[s]["exp_avg"].clone() for s in opt.shards],
             "v": [st[s]["exp_avg_sq"].clone() for s in opt.shards],
             "state_bytes": opt.shard_state_bytes()}
    if mode != "upfront":
        entry.update(issue_log=vag.issue_log, gather_log=vag.gather_log,
                     peak=vag.peak_param_bytes,
                     regather_bytes=vag.regather_bytes,
                     offload_bytes=vag.offload_bytes)
    res[sc] = entry
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tokens(n):
    return torch.from_numpy(np.random.RandomState(7).randint(
        0, _CFG["vocab_size"], (2 * n, 16)).astype(np.int64))


def _spawn(tmp_path, n, scenarios):
    torch.save(params_from_flax(_flax_params()), tmp_path / "init.pt")
    torch.save(_tokens(n), tmp_path / "tokens.pt")
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
             repr(MODES), repr(_CFG)],
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


def _jax_fsdp(n):
    """STEPS of the JAX package's FullyShardedOptimizer(optax.adamw) FSDP
    step in shard_map on an n-device mesh: the unsharded parameters and
    the m and v rows after them."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
    jhvd.init(mesh=mesh)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **_CFG)
    m = jt.Transformer(jcfg)
    params = jax.tree.map(jnp.asarray, _flax_params())
    layout = jfsdp.fsdp_layout(params, world=n, fusion_threshold_bytes=THRESH)
    opt = jhvd.FullyShardedOptimizer(
        optax.adamw(LR, eps=EPS, weight_decay=1e-4),
        fusion_threshold_bytes=THRESH)

    def stages(b):
        return jhvd.overlap.transformer_lm_stages(
            m, b, lambda lg, _b=b: jt.causal_lm_loss(lg, _b)[0])

    vag = jfsdp.fsdp_value_and_grad(stages, opt, layout, mode="prefetch")

    def step(r, s, b):
        _, g = vag(r, b, opt_state=s)
        upd, s2 = opt.update(g, s, jfsdp.local_shards(r, layout))
        return jfsdp.apply_shard_updates(r, upd, layout), s2

    state = opt.init(params)
    specs = jhvd.sharded_state_specs(state)
    rspec = jfsdp.param_row_specs(layout)
    js = jax.jit(shard_map(step, mesh=mesh,
                           in_specs=(rspec, specs, P("hvd")),
                           out_specs=(rspec, specs), check_vma=False))
    rows = jfsdp.shard_params(params, layout)
    tok = jnp.asarray(_tokens(n).numpy().astype(np.int32))
    for _ in range(STEPS):
        rows, state = js(rows, state, tok)
    full = jfsdp.unshard_params(rows, layout)
    return (params_from_flax(jax.tree.map(np.asarray, full)),
            [np.asarray(x) for x in state[0].mu],
            [np.asarray(x) for x in state[0].nu])


def _bitwise_modes(res, n, wire=""):
    ref = f"upfront{wire}"
    for mode in MODES:
        sc = mode + wire
        for r in range(n):
            for t in range(STEPS):
                a, b = res[r][sc]["trace"][t], res[r][ref]["trace"][t]
                assert torch.equal(a["loss"], b["loss"]), (sc, r, t)
                for key in ("shards", "grads") + (("res",) if wire else ()):
                    for i, (x, y) in enumerate(zip(a[key], b[key])):
                        assert torch.equal(x, y), (sc, key, r, t, i)
            for key in ("m", "v"):
                for x, y in zip(res[r][sc][key], res[r][ref][key]):
                    assert torch.equal(x, y), (sc, key, r)


def _expected_logs(layout, depth, regather):
    """The issue and gather logs the JAX package's schedules give: the
    stages are embed, the blocks, the head; a leaf belongs to the stages
    whose keys hold its top-level name."""
    keys = [("tok_emb", "pos_emb")] + [
        (f"block_{i}",) for i in range(_CFG["num_layers"])] + [
        ("ln_final", "tok_emb")]
    S = len(keys)
    leaf_stages = [[s for s, ks in enumerate(keys) if n.split(".")[0] in ks]
                   for n in layout.names]
    plans = [list(p) for p in layout.plans]
    order = list(reversed(range(S)))
    issue = [(step, b) for step, bs in enumerate(
        jfusion.bucket_issue_schedule(plans, leaf_stages, order))
        for b in bs]
    need = jfusion.bucket_prefetch_schedule(
        plans, [min(s) for s in leaf_stages], S)
    gathers, held = [], set()

    def issue_gathers(sched, at, phase):
        for d in range(depth + 1):
            if at + d >= S:
                break
            for b in sched[at + d]:
                if b not in held:
                    held.add(b)
                    gathers.append((phase, at, b))

    last = [max(max(leaf_stages[i]) for (i, _, _, _) in bp) for bp in plans]
    if not regather:
        for s in range(S):
            issue_gathers(need, s, "fwd")
            held -= {b for b in list(held) if last[b] == s}
        return issue, gathers
    fwd_last = [max([s for (i, _, _, _) in bp for s in leaf_stages[i]
                     if s < S - 1], default=None) for bp in plans]
    for s in range(S - 1):
        issue_gathers(need, s, "fwd")
        held -= {b for b in list(held) if fwd_last[b] == s}
    again = jfusion.bucket_regather_schedule(
        plans, [max(s) for s in leaf_stages], S)
    first = [min(min(leaf_stages[i]) for (i, _, _, _) in bp) for bp in plans]
    for step, si in enumerate(order):
        issue_gathers(again, step, "bwd")
        held -= {b for b in list(held) if first[b] == si}
    return issue, gathers


def _check_world(res, n, want_jax):
    _bitwise_modes(res, n)
    layout = fsdp.fsdp_layout(_torch_named(), world=n,
                              fusion_threshold_bytes=THRESH)
    assert len(layout.plans) > 2
    for mode, kw in MODES.items():
        issue, gathers = _expected_logs(
            layout, kw.get("prefetch", 1), kw.get("regather", True))
        for r in range(n):
            assert res[r][mode]["issue_log"] == issue, mode
            assert res[r][mode]["gather_log"] == gathers, mode
            assert res[r][mode]["peak"] <= layout.shard_bytes + \
                layout.param_bytes + n * 4 * len(layout.plans)
        assert (res[0][mode]["offload_bytes"] > 0) == (mode == "offload")
    full = sum(p.numel() for _, p in _torch_named()) * 4 * 2
    for r in range(n):
        got = res[r]["regather"]["state_bytes"]
        assert full / n <= got <= full / n + 8 * n * len(layout.plans)
    # the JAX package's FSDP step on a mesh of the same size
    jparams, jm, jv = want_jax
    rows = {fsdp.bucket_name(b): torch.stack(
        [res[r]["regather"]["trace"][-1]["shards"][b] for r in range(n)])
        for b in range(len(layout.plans))}
    got = fsdp.unshard_params(rows, layout)
    for name, w in jparams.items():
        tol = (STEPS * LR * 1.01 if name.endswith("attn.key.bias")
               else 1e-6 + 1e-2 * STEPS * LR)
        err = float((got[name] - w).abs().max())
        assert err <= tol, (name, err, tol)
    for r in range(n):
        for key, want in (("m", jm), ("v", jv)):
            for b, rows_j in enumerate(want):
                g = res[r]["regather"][key][b].numpy()
                rel = np.linalg.norm(g - rows_j[r]) / max(
                    np.linalg.norm(rows_j[r]), 1e-30)
                assert rel <= 1e-4, (key, r, b, rel)


def _emulate(res, n, wire_name):
    """The world composed in one process (EmulatedWorld): every rank's
    shards, gradient shards and residuals bitwise the gloo world's."""
    from horovod_tpu_torch.optim import compression as tcomp

    hvd.init(device="cpu")
    named = _torch_named()
    comp = hvd.Compression.int8 if wire_name else hvd.Compression.none
    opts = [fsdp.FullyShardedOptimizer(
        functools.partial(torch.optim.AdamW, lr=LR, eps=EPS,
                          weight_decay=1e-4),
        named, compression=comp, fusion_threshold_bytes=THRESH, world=n,
        rank=r) for r in range(n)]
    cfg = tt.TransformerConfig(dtype=torch.float32, **_CFG)
    with torch.device("meta"):
        model = tt.Transformer(cfg)
    wire = tcomp.parse_wire("int8", BLOCK) if wire_name else None
    world = overlap.EmulatedWorld(n, wire)
    tokens = _tokens(n)
    vag = fsdp.fsdp_value_and_grad(
        lambda b: overlap.transformer_lm_stages(
            model, b, lambda lg: tt.causal_lm_loss(lg, b)[0]),
        opts[0], opts[0].layout)
    sc = "regather" + wire_name
    for t in range(STEPS):
        world.shards = [o.shards for o in opts]
        outs = [vag(o.shards, tokens[2 * r:2 * r + 2],
                    opt_state=o.opt_state, exchange=world.rank(r))
                for r, o in enumerate(opts)]
        world.resolve()
        for r, (o, (loss, g)) in enumerate(zip(opts, outs)):
            o.step(g)
            o.zero_grad()
            want = res[r][sc]["trace"][t]
            assert torch.equal(loss, want["loss"]), (sc, t, r)
            for key, got in (("grads", g.shards), ("shards", o.shards)) + (
                    (("res", o.residuals),) if wire_name else ()):
                for i, (x, y) in enumerate(zip(got, want[key])):
                    assert torch.equal(x, y), (sc, key, t, r, i)


def test_world_of_two(tmp_path, _jax_knobs_restored, monkeypatch):
    n = 2
    scenarios = ["upfront"] + list(MODES) + \
        ["upfront:int8"] + [m + ":int8" for m in MODES]
    procs = _spawn(tmp_path, n, scenarios)
    try:
        want = _jax_fsdp(n)
    finally:
        res = _collect(procs, tmp_path)
    res = [{k.replace(":", ""): v for k, v in r.items()} for r in res]
    _check_world(res, n, want)
    _bitwise_modes(res, n, wire="int8")
    monkeypatch.setenv("HOROVOD_COMPRESSION_BLOCK", str(BLOCK))
    _emulate(res, n, "")
    _emulate(res, n, "int8")


def test_world_of_four(tmp_path, _jax_knobs_restored):
    n = 4
    scenarios = ["upfront"] + list(MODES)
    procs = _spawn(tmp_path, n, scenarios)
    try:
        want = _jax_fsdp(n)
    finally:
        res = _collect(procs, tmp_path)
    _check_world(res, n, want)
