"""The port's fused BatchNorm against the JAX package's Pallas op.

``horovod_tpu_torch.ops.batchnorm.fused_batch_norm`` on CPU tensors (the
plain versions of B7–B10) against ``horovod_tpu.ops.pallas_batchnorm.
fused_batch_norm`` (the Pallas kernels in interpret mode on the CPU, as
the JAX package's own tests run them), from the same numpy inputs: the
outputs y, mean and var, and the gradients dx, dgamma, dbeta and dres
for one numpy cotangent. Cases: {no activation, ReLU} x {no residual,
residual} at C = 64 (the JAX lane-fold path), 96 and 256, with row
counts that are no multiple of the Pallas row block.

Tolerances (float32; the two sides sum in another order): the
elementwise outputs y, dx and dres within 1e-5 relative + 1e-5 of the
largest value; the reductions mean, var, dgamma and dbeta within 1e-4
relative + 1e-5 of the largest value.

Also: the module against the JAX ``FusedBatchNorm`` in training (output
and running statistics) and in eval; bf16 input keeps float32
statistics; a bad activation or residual shape raises; the kernel
wrappers refuse CPU tensors; the reduction geometry covers every row;
B10's fold of A, B and C (``bn_bwd_constants_ref``) is bitwise the
backward's former inline arithmetic, and its wrapper refuses bad shapes.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_batchnorm as jbn
from horovod_tpu_torch.ops import batchnorm as tbn

torch.set_num_threads(1)

_SHAPES = [(4, 9, 9, 64), (3, 7, 7, 96), (2, 5, 5, 256)]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return dict(x=(rng.randn(*shape) * 2 + 0.5).astype(np.float32),
                res=rng.randn(*shape).astype(np.float32),
                gamma=(rng.rand(c) + 0.5).astype(np.float32),
                beta=rng.randn(c).astype(np.float32),
                dy=rng.randn(*shape).astype(np.float32))


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: f"C{s[-1]}")
@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["", "res"])
def test_fused_batch_norm_matches_pallas(shape, act, residual):
    d = _inputs(shape, seed=shape[-1] + (act is None) + 2 * residual)

    def jfn(x, g, b, r):
        return jbn.fused_batch_norm(x, g, b, activation=act,
                                    residual=r if residual else None)

    args = tuple(jnp.asarray(d[k]) for k in ("x", "gamma", "beta", "res"))
    (jy, jm, jv), vjp = jax.vjp(jax.jit(jfn), *args)
    zeros = jnp.zeros_like(jm)
    jgrads = vjp((jnp.asarray(d["dy"]), zeros, zeros))

    t = {k: torch.from_numpy(v).requires_grad_() for k, v in d.items()
         if k != "dy"}
    ty, tm, tv = tbn.fused_batch_norm(
        t["x"], t["gamma"], t["beta"], activation=act,
        residual=t["res"] if residual else None)
    assert not tm.requires_grad and not tv.requires_grad
    assert tm.dtype == tv.dtype == torch.float32
    ty.backward(torch.from_numpy(d["dy"]))

    _close(ty.detach(), jy, 1e-5, "y")
    _close(tm, jm, 1e-4, "mean")
    _close(tv, jv, 1e-4, "var")
    _close(t["x"].grad, jgrads[0], 1e-5, "dx")
    _close(t["gamma"].grad, jgrads[1], 1e-4, "dgamma")
    _close(t["beta"].grad, jgrads[2], 1e-4, "dbeta")
    if residual:
        _close(t["res"].grad, jgrads[3], 1e-5, "dres")
    else:
        assert t["res"].grad is None


@pytest.mark.parametrize("act,residual", [(None, False), ("relu", True)])
def test_module_matches_jax_fused_batchnorm_train_and_eval(act, residual):
    """Training output and running statistics after two steps (flax's
    rule, momentum 0.9, biased variance), then the eval affine."""
    d = _inputs((8, 5, 5, 64), seed=7)
    x2 = (np.random.RandomState(8).randn(8, 5, 5, 64) - 0.3).astype(
        np.float32)
    r = d["res"] if residual else None
    jmod = jbn.FusedBatchNorm(momentum=0.9, epsilon=1e-5, activation=act)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(d["x"]))
    params = {"scale": jnp.asarray(d["gamma"]),
              "bias": jnp.asarray(d["beta"])}
    stats = variables["batch_stats"]
    jys = []
    for x in (d["x"], x2):
        y, upd = jmod.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x), residual=r,
                            mutable=["batch_stats"])
        stats = upd["batch_stats"]
        jys.append(y)
    jeval = jmod.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x2), residual=r,
                       use_running_average=True)

    tmod = tbn.FusedBatchNorm(64, momentum=0.9, epsilon=1e-5,
                              activation=act)
    with torch.no_grad():
        tmod.scale.copy_(torch.from_numpy(d["gamma"]))
        tmod.bias.copy_(torch.from_numpy(d["beta"]))
    tr = None if r is None else torch.from_numpy(r)
    for x, jy in zip((d["x"], x2), jys):
        ty = tmod(torch.from_numpy(x), residual=tr)
        _close(ty.detach(), jy, 1e-5, "train y")
    _close(tmod.mean, stats["mean"], 1e-5, "running mean")
    _close(tmod.var, stats["var"], 1e-5, "running var")
    tmod.eval()
    before = tmod.mean.clone()
    _close(tmod(torch.from_numpy(x2), residual=tr).detach(), jeval, 1e-5,
           "eval y")
    assert torch.equal(tmod.mean, before)  # eval updates nothing


def test_module_matches_flax_batchnorm():
    """The fused module computes what flax.linen.BatchNorm computes."""
    x = np.random.RandomState(2).randn(8, 5, 5, 64).astype(np.float32)
    ref = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    v = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, upd = ref.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    mod = tbn.FusedBatchNorm(64)
    _close(mod(torch.from_numpy(x)).detach(), y, 1e-5, "y")
    _close(mod.mean, upd["batch_stats"]["mean"], 1e-5, "mean")
    _close(mod.var, upd["batch_stats"]["var"], 1e-5, "var")


def test_bf16_input_keeps_f32_statistics():
    x32 = np.random.RandomState(3).randn(16, 3, 3, 128).astype(np.float32)
    x = torch.from_numpy(x32).to(torch.bfloat16)
    y, m, v = tbn.fused_batch_norm(x, torch.ones(128), torch.zeros(128),
                                   activation="relu")
    assert y.dtype == torch.bfloat16
    assert m.dtype == torch.float32 and v.dtype == torch.float32
    jm = jbn.fused_batch_norm(jnp.asarray(x32, jnp.bfloat16),
                              jnp.ones(128), jnp.zeros(128),
                              activation="relu")[1]
    _close(m, jm, 1e-5, "bf16 mean")
    m0 = x.float().mean((0, 1, 2))
    np.testing.assert_allclose(m.numpy(), m0.numpy(), atol=1e-6)
    assert bool((y >= 0).all())


def test_rejects_bad_activation_and_shape():
    x = torch.zeros(4, 4, 4, 64)
    g, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="activation"):
        tbn.fused_batch_norm(x, g, b, activation="gelu")
    with pytest.raises(ValueError, match="residual shape"):
        tbn.fused_batch_norm(x, g, b, residual=torch.zeros(4, 4, 4, 32))
    with pytest.raises(ValueError, match="activation"):
        tbn.FusedBatchNorm(64, activation="gelu")


def test_kernel_wrappers_take_cuda_tensors_only():
    """On a CPU tensor the op runs the plain versions; the kernel
    wrappers themselves refuse it (a CUDA tensor launches the kernel or
    raises, it never falls back)."""
    x = torch.randn(32, 64)
    v = torch.ones(64)
    for call in (lambda: tbn.bn_stats_cuda(x),
                 lambda: tbn.bn_apply_cuda(x, v, v, None, True),
                 lambda: tbn.bn_bwd_reduce_cuda(x, x, None, v, v, v, v,
                                                True),
                 lambda: tbn.bn_bwd_dx_cuda(x, x, x, v, v, v, v, v, v, v,
                                            True)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("n,c,vec", [(1605632, 64, 8), (401408, 256, 8),
                                     (6272, 2048, 8), (10007, 100, 1),
                                     (3, 4096, 4), (1, 8, 8)])
def test_reduce_geometry_covers_every_row(n, c, vec):
    rows, blocks = tbn.reduce_geometry(n, c, vec)
    col_tiles = -(-(c // vec) // tbn.THREADS)
    assert rows * blocks >= n > rows * (blocks - 1)
    assert 1 <= blocks * col_tiles <= max(tbn.TARGET_BLOCKS, col_tiles)


def _inline_fold(gamma, mean, rstd, dgamma, dbeta, n):
    # the constants as _FusedBatchNormFn.backward computed them inline
    a = gamma * rstd
    b = rstd * (-a * dgamma / n)
    c = -a * dbeta / n - (-mean * rstd) * a * dgamma / n
    return a, b, c


@pytest.mark.parametrize("n,c", [(401408, 256), (1605632, 64), (6272, 2048),
                                 (10007, 100), (4099, 96), (3, 8)])
def test_bn_bwd_constants_ref_is_the_inline_fold(n, c):
    """The plain fold the dx kernel is held against returns bitwise what
    the backward computed before the fold moved into the kernel."""
    rng = np.random.RandomState(c + n % 97)
    v = {k: torch.from_numpy(rng.randn(c).astype(np.float32) * sc)
         for k, sc in (("gamma", 0.3), ("mean", 1.0), ("dgamma", 50.0),
                       ("dbeta", 80.0))}
    v["gamma"] += 1
    rstd = torch.from_numpy((rng.rand(c) + 0.2).astype(np.float32))
    args = (v["gamma"], v["mean"], rstd, v["dgamma"], v["dbeta"], float(n))
    for got, want in zip(tbn.bn_bwd_constants_ref(*args), _inline_fold(*args)):
        assert got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_bn_bwd_dx_folded_ref_is_fold_then_dx():
    d = _inputs((3, 5, 5, 96), seed=11)
    x2 = torch.from_numpy(d["x"]).reshape(-1, 96)
    dy2 = torch.from_numpy(d["dy"]).reshape(-1, 96)
    res2 = torch.from_numpy(d["res"]).reshape(-1, 96)
    g = torch.from_numpy(d["gamma"])
    mean, rstd = x2.mean(0), torch.rsqrt(x2.var(0, unbiased=False) + 1e-5)
    s, t = g * rstd, torch.from_numpy(d["beta"]) - mean * g * rstd
    dg, db = dy2.sum(0), (dy2 * x2).sum(0)
    a, b, c = _inline_fold(g, mean, rstd, dg, db, float(x2.shape[0]))
    want = tbn.bn_bwd_dx_ref(x2, dy2, res2, s, t, a, b, c, True)
    got = tbn.bn_bwd_dx_folded_ref(x2, dy2, res2, s, t, g, mean, rstd, dg,
                                   db, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _dx_args(**bad):
    x = torch.zeros(32, 64)
    v = torch.ones(64)
    args = dict(x2=x, dy2=x, res2=None, s=v, t=v, gamma=v, mean=v, rstd=v,
                dgamma=v, dbeta=v, relu=True)
    args.update(bad)
    return args


@pytest.mark.parametrize("bad,match", [
    ({}, "CUDA"),
    ({"x2": torch.zeros(2, 32, 64)}, r"\[R, C\]"),
    ({"x2": torch.zeros(32, 64, dtype=torch.float64)}, "float32/bfloat16"),
    ({"dy2": torch.zeros(32, 32)}, "dy must be"),
    ({"res2": torch.zeros(32, 64, dtype=torch.bfloat16)}, "residual must be"),
    ({"gamma": torch.ones(32)}, "gamma must be"),
    ({"rstd": torch.ones(64, dtype=torch.float64)}, "rstd must be"),
    ({"dbeta": torch.ones(128)[::2]}, "dbeta must be"),
], ids=["cpu", "rank", "dtype", "dy", "res", "gamma", "rstd", "strided"])
def test_bn_bwd_dx_cuda_rejects_bad_inputs(bad, match):
    """B10's wrapper takes contiguous [R, C] rows and [C] float32
    statistics on the card; shapes are checked before the device."""
    with pytest.raises(ValueError, match=match):
        tbn.bn_bwd_dx_cuda(**_dx_args(**bad))
