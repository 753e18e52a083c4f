"""The port's ZeRO-1 (``optim/zero.py``) and its bucket pack (B6's plain
version) against the JAX package.

* ``pack_rows_fused`` on the CPU and ``zero._pad_rows`` are bitwise
  equal to the JAX package's ``pack_rows_fused`` (the Pallas kernel in
  interpret mode) for n in {1, 2, 3, 4, 8}, ragged lengths, L < n, an
  unaligned slice, float32 and bf16; a bf16 NaN payload that XLA on
  the CPU quiets where its pack pads the bucket is copied bit for bit
  by the port (ROADMAP section C);
* the bucket plan and the per-bucket shard widths of a tiny BERT equal
  the JAX ``ShardedOptimizer``'s (the ``(n, k_i)`` state leaves);
* worlds of two and four processes over gloo run
  ``ShardedOptimizer(AdamW(weight_decay=1e-4))`` 3 steps on the JAX
  test's regression (``tests/test_zero.py``: 37 x 11 + 11 + 3
  parameters, not divisible by the world) against
  ``ShardedOptimizer(optax.adamw(lr, weight_decay=1e-4))`` in
  ``shard_map`` on a mesh of the same size: parameters within 1e-6 + 1%
  of the most AdamW can move them (steps x lr; optax and torch round
  the step at different points), each rank's m and v rows within 1e-4
  relative (L2) of JAX's rows; one bucket at the default threshold and
  two at 256 bytes; the bf16 and int8 wires (block 32) at world 2
  against JAX's ``ShardedOptimizer(compression=...)``. The ranks end
  bitwise equal. ZeRO against the port's ``DistributedOptimizer`` with
  the same inner optimizer (AdamW, SGD with momentum): bitwise at world
  2 (the reduce-scatter and the all-reduce add two ranks' values alike,
  and torch's optimizers are elementwise), within 1e-6 relative at
  world 4 (gloo may add four ranks in another order);
* the stage functions composed in one process (``stage_pack``,
  ``emulated_scatter_buckets``, ``RankShards``, a concatenation for the
  all-gather), fed the world's packed rows, are bitwise equal to the
  world of two at every step, on the float32 and the int8 wire;
* a world of one steps the bare inner optimizer; ``params_sharded``
  raises; ``reshard_state`` mirrors the JAX package's.
"""

import dataclasses
import functools
import os
import pathlib
import re
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
from horovod_tpu.ops import pallas_collectives as jpc
from horovod_tpu.optim import zero as jzero
from horovod_tpu_torch.ops import fusion, ring_pack
from horovod_tpu_torch.optim import compression as tcomp
from horovod_tpu_torch.optim import zero

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
LR = 0.05
STEPS = 3
BLOCK = 32
SHAPES = {"b": (11,), "s": (3,), "w": (37, 11)}


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    yield
    hvd.shutdown()


def _tbits(t):
    """A tensor's bits as a numpy array of unsigned ints."""
    it = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(it).numpy().view(
        np.uint16 if t.element_size() == 2 else np.uint32)


def _jbits(a):
    ut = jnp.uint16 if a.dtype.itemsize == 2 else jnp.uint32
    return np.asarray(jax.lax.bitcast_convert_type(a, ut))


# ---------------------------------------------------------------------------
# B6's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_pack_rows_matches_jax(dtype, n):
    rs = np.random.RandomState(n)
    tdt = getattr(torch, dtype)
    # ragged lengths, L < n, -0.0, a quiet NaN (XLA on the CPU
    # canonicalizes other NaN payloads in bf16); a slice that starts off
    # alignment
    for length in (1001, 37, max(n - 1, 1)):
        x = rs.randn(length + 3).astype(np.float32)
        x[3] = -0.0
        t = torch.from_numpy(x).to(tdt)
        t.view(torch.int16 if dtype == "bfloat16" else torch.int32)[-1] = \
            0x7FC0 if dtype == "bfloat16" else 0x7FC00000
        t = t[3:]
        bits = _tbits(t)
        # the same bits on the JAX side
        jx = jax.lax.bitcast_convert_type(jnp.asarray(bits),
                                          getattr(jnp, dtype))
        want = _jbits(jpc.pack_rows_fused(jx, n))
        got = ring_pack.pack_rows_fused(t, n)
        plain = zero._pad_rows(t.contiguous(), n)
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        for what, g in (("pack_rows_fused", got), ("_pad_rows", plain)):
            assert (_tbits(g) == want).all(), (what, length)
        np.testing.assert_array_equal(_jbits(jzero._pad_rows(jx, n)), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length,n", [
    (64, 4), (63, 4), (65, 4),        # a multiple of float32's 4-element
    (128, 3), (127, 3), (129, 3),     # vector (and bf16's 8), and +-1
    (4096, 8), (4095, 8), (4097, 8),  # a 16 KB / 8 KB bucket, +-1
    (2, 4), (5, 8),                   # L < n
])
def test_pack_rows_vector_boundary_matches_jax(dtype, length, n):
    """B6's plain version and ``zero._pad_rows`` against the JAX
    package's ``pack_rows_fused`` at lengths around the card kernel's
    16-byte vector (where one thread writes the vector that straddles L
    and the output's last n * k mod V elements go one by one), bitwise,
    from an aligned start."""
    rs = np.random.RandomState(length * 31 + n)
    tdt = getattr(torch, dtype)
    t = torch.from_numpy(rs.randn(length).astype(np.float32)).to(tdt)
    jx = jax.lax.bitcast_convert_type(jnp.asarray(_tbits(t)),
                                      getattr(jnp, dtype))
    want = _jbits(jpc.pack_rows_fused(jx, n))
    k = -(-length // n)
    assert want.shape == (n, k)
    for what, got in (("pack_rows_fused", ring_pack.pack_rows_fused(t, n)),
                      ("_pad_rows", zero._pad_rows(t, n))):
        assert got.dtype == tdt and tuple(got.shape) == (n, k), what
        assert (_tbits(got) == want).all(), what
    assert (want.reshape(-1)[length:] == 0).all()


def _csrc(name):
    return (REPO / "horovod_tpu_torch" / "csrc" / name).read_text()


def _constexpr(src, name):
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def test_pack_tile_is_the_kernels():
    """The tiling ``ops/ring_pack.py`` exports (``chip_smoke.py`` builds
    its tile-boundary cases from it) is the ``constexpr``s of
    ``csrc/pack_rows.cu``, and the wrapper's ctypes signature has the C
    entry's arity."""
    src = _csrc("pack_rows.cu")
    assert ring_pack.PACK_THREADS == _constexpr(src, "kThreads")
    assert ring_pack.PACK_TILE_UNROLL == _constexpr(src, "kTileUnroll")
    m = re.search(r'extern "C" int hvd_pack_rows\(([^)]*)\)', src)
    assert m
    assert len(m.group(1).split(",")) == len(ring_pack._ARGTYPES["pack_rows"])
    with pytest.raises(ValueError, match="CUDA"):
        ring_pack.pack_rows_cuda(torch.zeros(4), 2)


def test_bf16_nan_payloads():
    """XLA on the CPU quiets bf16 NaN payloads when its pack pads the
    bucket (ROADMAP section C); the port's pack copies bits. Both keep
    every other value, and both keep float32 NaN payloads."""
    payload = np.array([0xFFFF, 0x7F81, 0x7FC0], np.uint16)
    x = torch.from_numpy(payload.view(np.int16).copy()).view(torch.bfloat16)
    jx = jax.lax.bitcast_convert_type(jnp.asarray(payload), jnp.bfloat16)
    for n in (1, 2):
        got = _tbits(ring_pack.pack_rows_fused(x, n)).reshape(-1)
        want = _jbits(jpc.pack_rows_fused(jx, n)).reshape(-1)
        np.testing.assert_array_equal(got[:3], payload)
        if n == 1:
            np.testing.assert_array_equal(want, payload)
        else:  # padded: quieted, sign kept
            np.testing.assert_array_equal(want[:3], [0xFFC0, 0x7FC0, 0x7FC0])
        assert (got[3:] == 0).all() and (want[3:] == 0).all()
    f32 = np.array([0xFFFFFFFF, 0x7F800001, 0x7FC00000], np.uint32)
    jf = jax.lax.bitcast_convert_type(jnp.asarray(f32), jnp.float32)
    tf = torch.from_numpy(f32.view(np.int32).copy()).view(torch.float32)
    np.testing.assert_array_equal(
        _jbits(jpc.pack_rows_fused(jf, 2)).reshape(-1)[:3], f32)
    np.testing.assert_array_equal(
        _tbits(ring_pack.pack_rows_fused(tf, 2)).reshape(-1)[:3], f32)


def test_pack_rows_needs_a_known_device():
    with pytest.raises(ValueError, match="CUDA"):
        ring_pack.pack_rows_cuda(torch.zeros(4), 2)


# ---------------------------------------------------------------------------
# the plan and the shard widths
# ---------------------------------------------------------------------------

def _tiny_bert():
    cfg = jt.TransformerConfig(vocab_size=97, num_layers=2, num_heads=1,
                               hidden_size=64, max_seq_len=16,
                               causal=False, dtype=jnp.float32)
    model = jt.Transformer(cfg)
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.ones((1, 4), jnp.int32))["params"]


@pytest.mark.parametrize("n", [2, 4])
def test_plan_and_shards_match_jax(n):
    from horovod_tpu_torch.models.convert import params_from_flax

    params = _tiny_bert()
    threshold = 16 * 1024
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
    jhvd.init(mesh=mesh)
    jopt = jhvd.ShardedOptimizer(optax.adamw(LR),
                                 fusion_threshold_bytes=threshold,
                                 bucket_backward_order=True)
    jstate = jopt.init(params)
    _, jplans = jzero._plan(params, threshold, True)
    torch_params = params_from_flax(jax.tree.map(np.asarray, params))
    named = [(k, torch.nn.Parameter(v)) for k, v in torch_params.items()]
    paths = [fusion.flax_path(k) for k, _ in named]
    order = fusion.flatten_order(paths)
    plans = fusion.pytree_bucket_plan(
        [(paths[i], tuple(named[i][1].shape), named[i][1].dtype)
         for i in order], threshold_bytes=threshold, backward_order=True)
    assert len(plans) > 2
    assert [[(i, o, s, tuple(sh)) for (i, o, s, sh) in p] for p in plans] \
        == [[(i, o, s, tuple(sh)) for (i, o, s, sh) in p] for p in jplans]
    leaves = [named[i][1] for i in order]
    shards = zero.RankShards(
        functools.partial(torch.optim.AdamW, lr=LR, weight_decay=1e-4),
        leaves, plans, n, n - 1)
    mu = jstate[0].mu
    assert [tuple(m.shape) for m in mu] == [(n, k) for k in shards.ks]
    # the shard of the last rank holds its slice of each bucket, then 0s
    for b, plan in enumerate(plans):
        flat = torch.cat([leaves[i].detach().reshape(-1)
                          for (i, _, _, _) in plan])
        want = zero._pad_rows(flat, n)[n - 1]
        assert torch.equal(shards.tensors[b], want)
    # AdamW's m and v: 1/n of the replicated state, plus padding
    full = sum(p.numel() for p in leaves) * 4 * 2
    for t in shards.tensors:
        t.grad = torch.ones_like(t)
    shards.optimizer.step()
    got = shards.state_bytes()
    assert full / n <= got - 4 * len(plans) <= full / n + 8 * n * len(plans)


# ---------------------------------------------------------------------------
# a world of one, and what is not offered
# ---------------------------------------------------------------------------

def test_world_of_one_is_the_inner_optimizer():
    hvd.init(device="cpu")
    rs = np.random.RandomState(3)
    init = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]

    def run(wrap):
        ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
        factory = functools.partial(torch.optim.AdamW, lr=LR,
                                    weight_decay=1e-4)
        opt = (hvd.ShardedOptimizer(factory, ps.items()) if wrap
               else factory(list(ps.values())))
        for g in grads:
            sum((ps[k] * torch.from_numpy(g[k])).sum() for k in ps).backward()
            opt.step()
            opt.zero_grad()
        return ps, opt

    ps, opt = run(True)
    ref, _ = run(False)
    assert opt.shards is None and len(opt.bucket_plan) == 1
    for k in ps:
        assert torch.equal(ps[k], ref[k]), k
    assert opt.shard_state_bytes() == sum(
        2 * 4 * int(np.prod(s)) + 4 for s in SHAPES.values())
    assert hvd.LAUNCHES["pack_rows"] == 0


def test_params_sharded_and_wrong_residual_raise():
    hvd.init(device="cpu")
    lin = torch.nn.Linear(2, 2)
    with pytest.raises(NotImplementedError, match="item 9"):
        hvd.ShardedOptimizer(torch.optim.AdamW, lin.named_parameters(),
                             params_sharded=True)
    with pytest.raises(ValueError, match="non-int8 wire"):
        zero._scatter_bucket(torch.zeros(1, 4), 1, None,
                             residual=torch.zeros(1, 4))


def test_reshard_state_across_world_sizes():
    size = 13 * 7 + 9  # 100, divisible by neither world size
    k1, k2 = -(-size // 8), -(-size // 4)
    vals = np.arange(size, dtype=np.float32)
    mu = np.zeros(8 * k1, np.float32)
    mu[:size] = vals
    s8 = [torch.from_numpy(mu.reshape(8, k1))]
    s4 = zero.reshard_state(s8, [size], 8, 4)
    assert tuple(s4[0].shape) == (4, k2)
    np.testing.assert_array_equal(s4[0].reshape(-1)[:size].numpy(), vals)
    s8b = zero.reshard_state(s4, [size], 4, 8)
    assert torch.equal(s8b[0], s8[0])

    # the JAX package's re-slicing of the same rows, bitwise
    params = {"w": jnp.zeros((13, 7)), "b": jnp.zeros((9,))}
    jax_rows = jzero.reshard_state([jnp.asarray(mu.reshape(8, k1))], params,
                                   8, 4)
    np.testing.assert_array_equal(np.asarray(jax_rows[0]), s4[0].numpy())

    with pytest.raises(ValueError, match="size-1"):
        zero.reshard_state(s8, [size], 8, 1)
    with pytest.raises(ValueError, match="no state leaf"):
        zero.reshard_state(s8, [size], 16, 4)
    with pytest.raises(ValueError, match="does not match bucket 0"):
        zero.reshard_state([torch.zeros(8, k1 + 1)], [size], 8, 4)


# ---------------------------------------------------------------------------
# worlds of two and four over gloo
# ---------------------------------------------------------------------------

_WORKER = r'''
import functools, sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.optim import zero

out, lr, steps = sys.argv[1], float(sys.argv[2]), int(sys.argv[3])
scenarios = sys.argv[4].split(",")
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
data = dict(np.load(out + "/data.npz"))
x = torch.from_numpy(data["x"][r * 8:(r + 1) * 8])
y = torch.from_numpy(data["y"][r * 8:(r + 1) * 8])
names = ("b", "s", "w")

rows_log = []
_pack = zero.stage_pack


def recording_pack(grads, plan, n):
    rows = _pack(grads, plan, n)
    rows_log.append(rows.clone())
    return rows


zero.stage_pack = recording_pack
res = {}
for sc in scenarios:
    kind, _, opt_name = sc.partition(":")
    ps = {k: torch.nn.Parameter(torch.from_numpy(data["p_" + k].copy()))
          for k in names}
    if opt_name == "sgd":
        factory = functools.partial(torch.optim.SGD, lr=lr, momentum=0.9)
    else:
        factory = functools.partial(torch.optim.AdamW, lr=lr,
                                    weight_decay=1e-4)
    comp = {"bf16": hvd.Compression.bf16,
            "int8": hvd.Compression.int8}.get(kind, hvd.Compression.none)
    if kind == "dist":
        opt = hvd.DistributedOptimizer(factory(list(ps.values())),
                                       named_parameters=ps.items())
    else:
        opt = hvd.ShardedOptimizer(
            factory, ps.items(), compression=comp,
            fusion_threshold_bytes=256 if kind == "multi" else None)
    trace = []
    for t in range(steps):
        rows_log.clear()
        loss = ((x @ ps["w"] + ps["b"] + ps["s"].sum() - y) ** 2).mean()
        loss.backward()
        opt.step()
        rec = {"params": {k: v.detach().clone() for k, v in ps.items()},
               "loss": float(loss)}
        if kind != "dist":
            rec["rows"] = list(rows_log)
            rec["shards"] = [t_.grad.clone() for t_ in opt.shards.tensors]
        trace.append(rec)
        opt.zero_grad()
    entry = {"trace": trace, "plan": opt.bucket_plan}
    if kind != "dist":
        st = opt.shards.optimizer.state
        entry["ks"] = opt.shards.ks
        entry["state_bytes"] = opt.shard_state_bytes()
        if opt_name != "sgd":
            entry["m"] = [st[t_]["exp_avg"].clone()
                          for t_ in opt.shards.tensors]
            entry["v"] = [st[t_]["exp_avg_sq"].clone()
                          for t_ in opt.shards.tensors]
    res[sc] = entry
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, n, scenarios):
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
             str(STEPS), ",".join(scenarios)],
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


@pytest.fixture
def _jax_knobs_restored():
    saved = jax_state().knobs
    yield
    jax_state().knobs = saved


def _jax_run(n, data, compression=None, threshold=None):
    """3 steps of ShardedOptimizer(optax.adamw) in shard_map on an
    n-device mesh: parameters after each step, and the final m/v."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
    jhvd.init(mesh=mesh)
    st = jax_state()
    st.knobs = dataclasses.replace(st.knobs, compression_block=BLOCK)
    opt = jhvd.ShardedOptimizer(optax.adamw(LR, weight_decay=1e-4),
                                compression=compression,
                                fusion_threshold_bytes=threshold)
    params = {k: jnp.asarray(data["p_" + k]) for k in SHAPES}
    state = opt.init(params)
    specs = jhvd.sharded_state_specs(state)

    def step(p, s, x, y):
        g = jax.grad(lambda q: jnp.mean(
            (x @ q["w"] + q["b"] + jnp.sum(q["s"]) - y) ** 2))(p)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s

    js = jax.jit(shard_map(step, mesh=mesh,
                           in_specs=(P(), specs, P("hvd"), P("hvd")),
                           out_specs=(P(), specs), check_vma=False))
    x = jnp.asarray(data["x"][:8 * n])
    y = jnp.asarray(data["y"][:8 * n])
    trace = []
    for _ in range(STEPS):
        params, state = js(params, state, x, y)
        trace.append({k: np.asarray(v) for k, v in params.items()})
    adam = state[0]
    return trace, [np.asarray(m) for m in adam.mu], \
        [np.asarray(v) for v in adam.nu]


def _data(n):
    rs = np.random.RandomState(0)
    d = {"p_" + k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    d["x"] = rs.randn(8 * n, 37).astype(np.float32)
    d["y"] = rs.randn(8 * n, 11).astype(np.float32)
    return d


def _check_against_jax(res, want, n, what, state_rtol=1e-4, int8=False):
    jtrace, jm, jv = want
    for r in range(n):
        for t in range(STEPS):
            for k in SHAPES:
                got = res[r][what]["trace"][t]["params"][k].numpy()
                err = float(np.abs(got - jtrace[t][k]).max())
                tol = 1e-6 + 1e-2 * (t + 1) * LR
                assert err <= tol, (what, r, t, k, err)
        for name, rows_j, key in (("m", jm, "m"), ("v", jv, "v")):
            for b, rows in enumerate(rows_j):
                got = res[r][what][key][b].numpy()
                w = rows[r]
                rel = np.linalg.norm(got - w) / max(np.linalg.norm(w), 1e-30)
                assert rel <= state_rtol, (what, name, r, b, rel)
    for t in range(STEPS):
        for k in SHAPES:
            for r in range(1, n):
                assert torch.equal(res[r][what]["trace"][t]["params"][k],
                                   res[0][what]["trace"][t]["params"][k])


def _emulate(res, n, what, wire):
    """The stage functions in one process, fed each step's packed rows of
    every rank (as the world produced them): the averaged shards and the
    parameters must be bitwise the world's."""
    data = _data(n)
    params = [torch.from_numpy(data["p_" + k].copy()) for k in ("b", "s",
                                                                  "w")]
    plans = res[0][what]["plan"]
    factory = functools.partial(torch.optim.AdamW, lr=LR, weight_decay=1e-4)
    ranks = [zero.RankShards(factory, params, plans, n, r) for r in range(n)]
    for t in range(STEPS):
        rows = [res[r][what]["trace"][t]["rows"] for r in range(n)]
        shards = [[] for _ in range(n)]
        for b in range(len(plans)):
            outs = zero.emulated_scatter_buckets([rows[r][b]
                                                  for r in range(n)], n, wire)
            for r in range(n):
                assert torch.equal(outs[r], res[r][what]["trace"][t]
                                   ["shards"][b]), (what, t, b, r)
                shards[r].append(outs[r])
        for r in range(n):
            ranks[r].step(shards[r])
        gathered = [torch.cat([ranks[r].tensors[b] for r in range(n)])
                    for b in range(len(plans))]
        zero.stage_write(params, plans, gathered)
        for k, p in zip(("b", "s", "w"), params):
            assert torch.equal(p, res[0][what]["trace"][t]["params"][k]), \
                (what, t, k)


def test_world_of_two(tmp_path, _jax_knobs_restored):
    n = 2
    np.savez(tmp_path / "data.npz", **_data(n))
    scenarios = ["none", "multi", "bf16", "int8", "dist", "none:sgd",
                 "dist:sgd"]
    procs = _spawn(tmp_path, n, scenarios)
    try:
        data = _data(n)
        want = {"none": _jax_run(n, data),
                "multi": _jax_run(n, data, threshold=256),
                "bf16": _jax_run(n, data, jhvd.Compression.bf16),
                "int8": _jax_run(n, data, jhvd.Compression.int8)}
    finally:
        res = _collect(procs, tmp_path)
    assert len(res[0]["none"]["plan"]) == 1
    assert len(res[0]["multi"]["plan"]) == 2
    _check_against_jax(res, want["none"], n, "none")
    _check_against_jax(res, want["multi"], n, "multi")
    _check_against_jax(res, want["bf16"], n, "bf16", state_rtol=1e-2)
    _check_against_jax(res, want["int8"], n, "int8", state_rtol=1e-2)
    # ZeRO and the DistributedOptimizer: bitwise at world 2
    for z, d in (("none", "dist"), ("none:sgd", "dist:sgd")):
        for t in range(STEPS):
            for k in SHAPES:
                assert torch.equal(res[0][z]["trace"][t]["params"][k],
                                   res[0][d]["trace"][t]["params"][k]), \
                    (z, t, k)
    _emulate(res, n, "none", None)
    _emulate(res, n, "int8", tcomp.parse_wire("int8", BLOCK))


def test_world_of_four(tmp_path, _jax_knobs_restored):
    n = 4
    np.savez(tmp_path / "data.npz", **_data(n))
    scenarios = ["none", "multi", "dist", "none:sgd", "dist:sgd"]
    procs = _spawn(tmp_path, n, scenarios)
    try:
        data = _data(n)
        want = {"none": _jax_run(n, data),
                "multi": _jax_run(n, data, threshold=256)}
    finally:
        res = _collect(procs, tmp_path)
    _check_against_jax(res, want["none"], n, "none")
    _check_against_jax(res, want["multi"], n, "multi")
    assert res[0]["none"]["ks"] == [-(-(11 + 3 + 37 * 11) // n)]
    # ZeRO and the DistributedOptimizer: within 1e-6 relative
    for z, d in (("none", "dist"), ("none:sgd", "dist:sgd")):
        for t in range(STEPS):
            for k in SHAPES:
                got = res[0][z]["trace"][t]["params"][k].numpy()
                ref = res[0][d]["trace"][t]["params"][k].numpy()
                np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{z} {t} {k}")
