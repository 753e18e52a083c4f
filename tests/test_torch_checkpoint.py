"""The port's checkpoint (``horovod_tpu_torch/checkpoint.py``) against
the JAX package's ``checkpoint.py`` and ``tests/test_checkpoint.py``.

* The seven cases of ``tests/test_checkpoint.py``: Adam's state
  rehydrated (parameters and state bitwise, two more steps bitwise the
  uninterrupted ones), the wrapper's ``backward_passes_per_step`` and
  op round-tripping, a custom optimizer factory by name, a save without
  an optimizer spec refusing ``load_model`` (``load_params`` still
  reads it), a custom compressor refused, and the FSDP save/restore, on
  a gloo world of 4: each rank writes only its own rows, the restore
  into a fresh FullyShardedOptimizer is bitwise (rows, inner state and
  the int8 wire's residual rows), the rows reassemble into the
  parameters bitwise, and a load on a world of 2 is refused, pointing
  at ``reshard_rows``.
* ``checkpoint.save:error:times=2`` and ``checkpoint.restore:error``
  heal under the retry policy.
* A JAX package (orbax) checkpoint directory is refused with a message.
* Parity with JAX: the JAX package saves and restores its params and
  ``optax.adam`` state and takes one step; the port saves the same
  weights and state, converted (``models/convert.py``, and optax's
  ``mu``/``nu``/``count`` as torch Adam's ``exp_avg``/``exp_avg_sq``/
  ``step``), restores and takes one step with the same gradient: the
  parameters agree within ``tests/test_torch_training.py``'s gradient
  tolerance (2e-5 + 1e-4 relative; Adam's update is rounded in another
  order on each side).
"""

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
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch.optim import fsdp as fsdp_mod
from horovod_tpu_torch.utils import faults, retry

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
FSDP_SHAPES = {"w": (37, 11), "b": (11,)}


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _params(**arrays):
    return {k: torch.nn.Parameter(torch.tensor(np.asarray(v),
                                               dtype=torch.float32))
            for k, v in arrays.items()}


def _wrap(inner, params, **kw):
    return hvd.DistributedOptimizer(inner, named_parameters=params.items(),
                                    **kw)


def _train(opt, params, n, passes=1):
    """``n`` steps of gradient ones (``passes`` backward passes each)."""
    for _ in range(n):
        for _ in range(passes):
            sum(p.sum() for p in params.values()).backward()
        opt.step()
        opt.zero_grad()


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


def test_round_trip_rehydrates_adam_state(tmp_path):
    params = _params(w=np.arange(12.0).reshape(3, 4), b=np.ones(4))
    opt = _wrap(torch.optim.Adam(params.values(), lr=0.01), params)
    _train(opt, params, 3)
    hvd.save_model(str(tmp_path / "m"), params, opt_state=opt,
                   optimizer_spec=("Adam", {"lr": 0.01}),
                   metadata={"epoch": 7})
    m = hvd.load_model(str(tmp_path / "m"))
    assert m.metadata == {"epoch": 7}
    _same({k: v.detach() for k, v in m.params.items()},
          {k: v.detach() for k, v in params.items()})
    _same(m.opt_state, opt.state_dict())
    _same(m.optimizer.state_dict(), opt.state_dict())
    assert isinstance(m.optimizer._opt, torch.optim.Adam)
    # retraining with the rehydrated optimizer == continuing the original
    _train(opt, params, 2)
    _train(m.optimizer, m.params, 2)
    _same({k: v.detach() for k, v in m.params.items()},
          {k: v.detach() for k, v in params.items()})


def test_wrapper_config_round_trips(tmp_path):
    """backward_passes_per_step survives the reload: the rebuilt wrapper
    averages each window of 2 passes as the original does (the port
    saves at a window's end: a window in progress lives in .grad)."""
    params = _params(w=np.ones(4))
    opt = _wrap(torch.optim.SGD(params.values(), lr=0.1), params,
                backward_passes_per_step=2)
    _train(opt, params, 3, passes=2)
    hvd.save_model(str(tmp_path / "m"), params, opt_state=opt,
                   optimizer_spec=("SGD", {"lr": 0.1}),
                   backward_passes_per_step=2)
    m = hvd.load_model(str(tmp_path / "m"))
    assert m.optimizer._k == 2
    _same(m.opt_state, opt.state_dict())
    _train(opt, params, 3, passes=2)
    _train(m.optimizer, m.params, 3, passes=2)
    assert torch.equal(m.params["w"].detach(), params["w"].detach())


def test_custom_optimizer_factory(tmp_path):
    params = _params(w=np.ones(3))

    def my_opt(ps, lr):
        return torch.optim.SGD(ps, lr=lr)

    opt = _wrap(my_opt(params.values(), 0.5), params)
    hvd.save_model(str(tmp_path / "m"), params, opt_state=opt,
                   optimizer_spec=("my_opt", {"lr": 0.5}))
    with pytest.raises(ValueError, match="custom_optimizers"):
        hvd.load_model(str(tmp_path / "m"))
    m = hvd.load_model(str(tmp_path / "m"),
                       custom_optimizers={"my_opt": my_opt})
    _train(m.optimizer, m.params, 1)
    np.testing.assert_allclose(m.params["w"].detach().numpy(),
                               0.5 * np.ones(3), rtol=1e-6)


def test_params_only_save_requires_spec_for_load(tmp_path):
    params = _params(w=np.ones(2))
    hvd.save_model(str(tmp_path / "m"), params, metadata={"k": 1})
    with pytest.raises(ValueError, match="optimizer_spec"):
        hvd.load_model(str(tmp_path / "m"))
    got, meta = ckpt.load_params(str(tmp_path / "m"))
    assert meta == {"k": 1} and torch.equal(got["w"], torch.ones(2))


def test_reduce_op_round_trips(tmp_path):
    """op=Sum survives the reload; continuing from either is the same
    (the wrapper's config is part of the optimizer's identity)."""
    params = _params(w=np.ones(4))
    opt = _wrap(torch.optim.SGD(params.values(), lr=0.1), params,
                op=hvd.Sum)
    _train(opt, params, 1)
    hvd.save_model(str(tmp_path / "m"), params, opt_state=opt,
                   optimizer_spec=("SGD", {"lr": 0.1}), op=hvd.Sum)
    m = hvd.load_model(str(tmp_path / "m"))
    assert m.optimizer._op == hvd.Sum
    _train(opt, params, 2)
    _train(m.optimizer, m.params, 2)
    assert torch.equal(m.params["w"].detach(), params["w"].detach())
    # the caller's overrides win over the saved config
    m2 = hvd.load_model(str(tmp_path / "m"), op=hvd.Average)
    assert m2.optimizer._op == hvd.Average


def test_custom_compressor_save_rejected(tmp_path):
    class MyComp(hvd.Compression.none):
        pass

    with pytest.raises(ValueError, match="custom compressors"):
        hvd.save_model(str(tmp_path / "m"), _params(w=np.ones(2)),
                       compression=MyComp)


def test_load_into_a_model_on_its_device(tmp_path):
    """With ``model`` the parameters land in it (its device) and the
    optimizer steps them."""
    lin = torch.nn.Linear(3, 2)
    opt = _wrap(torch.optim.Adam(lin.parameters(), lr=0.1),
                dict(lin.named_parameters()))
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    opt.zero_grad()
    hvd.save_model(str(tmp_path / "m"), lin, opt_state=opt,
                   optimizer_spec=("Adam", {"lr": 0.1}))
    fresh = torch.nn.Linear(3, 2)
    m = hvd.load_model(str(tmp_path / "m"), model=fresh)
    _same(fresh.state_dict(), lin.state_dict())
    assert m.params["weight"] is fresh.weight
    for model, o in ((lin, opt), (fresh, m.optimizer)):
        model(torch.ones(1, 3)).sum().backward()
        o.step()
    _same(fresh.state_dict(), lin.state_dict())
    with pytest.raises(ValueError, match="differ in parameters"):
        hvd.load_model(str(tmp_path / "m"),
                       model=torch.nn.Linear(3, 2, bias=False))


def test_save_fault_heals_under_retry(tmp_path):
    saved = retry.default_policy()
    retry.set_default_policy(retry.RetryPolicy(max_attempts=5,
                                               base_delay_s=0.001,
                                               max_delay_s=0.002))
    try:
        faults.configure("checkpoint.save:error:times=2;"
                         "checkpoint.restore:error:times=1")
        params = _params(w=np.arange(3.0))
        hvd.save_model(str(tmp_path / "m"), params,
                       optimizer_spec=("SGD", {"lr": 1.0}))
        m = hvd.load_model(str(tmp_path / "m"))
        assert torch.equal(m.params["w"].detach(), torch.arange(3.0))
        faults.configure("checkpoint.save:error:times=9")
        with pytest.raises(faults.InjectedFault):
            hvd.save_model(str(tmp_path / "n"), params)
    finally:
        faults.configure("")
        retry.set_default_policy(saved)
    # the failed save left no file behind
    assert not (tmp_path / "n").exists() or not os.listdir(tmp_path / "n")


def test_jax_orbax_checkpoint_is_refused(tmp_path):
    jhvd.init()
    try:
        jhvd.save_model(str(tmp_path / "j"), {"w": jnp.ones((2,))},
                        optimizer_spec=("adam", {"learning_rate": 0.1}))
    finally:
        jhvd.shutdown()
    for load in (ckpt.load_model, ckpt.load_params):
        with pytest.raises(ValueError, match="orbax"):
            load(str(tmp_path / "j"))
    with pytest.raises(ValueError, match="orbax"):
        ckpt.load_fsdp(str(tmp_path / "j"), world=1)
    with pytest.raises(FileNotFoundError):
        ckpt.load_model(str(tmp_path))


def test_restore_then_adam_step_matches_jax(tmp_path):
    rs = np.random.RandomState(5)
    arrays = {"w": rs.randn(3, 4).astype(np.float32),
              "b": rs.randn(4).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32)
              for k, v in arrays.items()} for _ in range(4)]
    lr = 0.01
    # the JAX package: three steps, save, load, one step
    jhvd.init()
    try:
        jopt = jhvd.DistributedOptimizer(optax.adam(lr))
        p = {k: jnp.asarray(v) for k, v in arrays.items()}
        st = jopt.init(p)
        for g in grads[:3]:
            u, st = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                st, p)
            p = optax.apply_updates(p, u)
        jhvd.save_model(str(tmp_path / "jax"), p, opt_state=st,
                        optimizer_spec=("adam", {"learning_rate": lr}))
        jm = jhvd.load_model(str(tmp_path / "jax"))
        u, _ = jm.optimizer.update(
            {k: jnp.asarray(v) for k, v in grads[3].items()}, jm.opt_state,
            jm.params)
        want = jax.tree.map(np.asarray, optax.apply_updates(jm.params, u))
        adam = next(s for s in jax.tree_util.tree_leaves(
            jm.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu"))
        restored = {k: np.asarray(v) for k, v in jm.params.items()}
        mu = {k: np.asarray(v) for k, v in adam.mu.items()}
        nu = {k: np.asarray(v) for k, v in adam.nu.items()}
        count = int(adam.count)
    finally:
        jhvd.shutdown()
    # the port: the same weights and Adam state, converted
    params = _params(**restored)
    names = list(params)
    inner = torch.optim.Adam(params.values(), lr=lr)
    sd = inner.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(count)),
                       "exp_avg": torch.from_numpy(mu[k]),
                       "exp_avg_sq": torch.from_numpy(nu[k])}
                   for i, k in enumerate(names)}
    inner.load_state_dict(sd)
    hvd.save_model(str(tmp_path / "port"), params, opt_state=inner,
                   optimizer_spec=("Adam", {"lr": lr}))
    m = hvd.load_model(str(tmp_path / "port"))
    for k, p in m.params.items():
        p.grad = torch.from_numpy(grads[3][k])
    m.optimizer.step()
    for k in names:
        np.testing.assert_allclose(m.params[k].detach().numpy(), want[k],
                                   rtol=1e-4, atol=2e-5, err_msg=k)
    assert count == 3


_FSDP_WORKER = r'''
import functools
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch.optim import fsdp as fsdp_mod

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
data = np.load(out + "/params.npz")
named = [(k, torch.from_numpy(data[k])) for k in ("w", "b")]
factory = functools.partial(torch.optim.Adam, lr=0.01)


def build():
    return hvd.FullyShardedOptimizer(factory, named,
                                     compression=hvd.Compression.int8)


opt = build()
# the rows as sharded, then a trained state
ckpt.save_fsdp(out + "/ck0", opt.shards, opt.layout)
gen = torch.Generator().manual_seed(100 + r)
for _ in range(2):  # a non-trivial inner state on this rank's shards
    for s in opt.shards:
        s.grad = torch.randn(s.shape, generator=gen)
    opt._opt.step()
opt.residuals = [torch.randn(x.shape, generator=gen) for x in opt.residuals]
ckpt.save_fsdp(out + "/ck", opt.shards, opt.layout, opt_state=opt,
               metadata={"step": 11})
hvd.barrier()
res = {"shards": [s.detach().clone() for s in opt.shards],
       "state": opt.state_dict(), "residuals": opt.residuals}
fresh = build()
rows, state, meta = ckpt.load_fsdp(out + "/ck", optimizer=fresh)
res["meta"] = meta
res["restored"] = {"shards": [s.detach().clone() for s in fresh.shards],
                   "state": fresh.state_dict(),
                   "residuals": fresh.residuals, "rows": rows}
try:
    ckpt.load_fsdp(out + "/ck", world=2)
    res["world2"] = None
except ValueError as e:
    res["world2"] = str(e)
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fsdp_sharded_save_restore_round_trip(tmp_path):
    rs = np.random.RandomState(0)
    arrays = {k: rs.randn(*s).astype(np.float32)
              for k, s in FSDP_SHAPES.items()}
    np.savez(tmp_path / "params.npz", **arrays)
    port = _free_port()
    procs = []
    for r in range(4):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE="4",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="4",
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _FSDP_WORKER, str(tmp_path)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        finally:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(4)]
    named = [(k, torch.from_numpy(v)) for k, v in arrays.items()]
    layout = fsdp_mod.fsdp_layout(named, world=4)
    want_rows = fsdp_mod.shard_params(named, layout)
    files = sorted(os.listdir(tmp_path / "ck"))
    assert files == ["horovod_tpu_torch_fsdp.json"] + [
        f"rank_{r:05d}.pt" for r in range(4)]
    for r, out in enumerate(res):
        assert out["meta"] == {"step": 11}
        # each rank wrote its own rows, and only them
        mine = torch.load(tmp_path / "ck" / f"rank_{r:05d}.pt",
                          weights_only=True)
        for i, name in enumerate(sorted(want_rows)):
            assert mine["rows"][name].shape == (layout.ks[i],)
            assert torch.equal(mine["rows"][name], out["shards"][i])
        got = out["restored"]
        _same(got["shards"], out["shards"])
        _same(got["state"], out["state"])
        _same(got["residuals"], out["residuals"])
        assert "reshard_rows" in out["world2"]
    # the untrained rows, one file a rank, reassemble into the parameters
    rows0 = {name: torch.stack([
        torch.load(tmp_path / "ck0" / f"rank_{r:05d}.pt",
                   weights_only=True)["rows"][name] for r in range(4)])
        for name in want_rows}
    _same(rows0, want_rows)
    back = fsdp_mod.unshard_params(rows0, layout)
    for k, v in arrays.items():
        assert torch.equal(back[k], torch.from_numpy(v))
