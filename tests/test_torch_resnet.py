"""The port's ResNet against the JAX package's flax ResNet.

A tiny ``ResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10)`` in
float32 on 32 x 32 images: even sizes, so flax's asymmetric "SAME"
padding (stride-2 convolutions and the max pool pad (0, 1)) shows, and
a block with a projection in each stage. Flax initializes the weights;
every BatchNorm scale is then redrawn from U(0.5, 1.5) (at init the
last scale of each block is 0, which makes every gradient inside the
blocks exactly 0 in both frameworks and would hide a wrong backward),
and ``resnet_from_flax`` loads them into the port. Held against the
JAX *unfused* model (flax.linen.BatchNorm; its fused Pallas model
would run for ~25 s in interpret mode): logits, the example's loss,
every parameter's gradient, the updated ``batch_stats``, and the eval
forward on the updated statistics, for the port's plain
(``fused_bn=False``) and fused (``fused_bn=True``, the kernels' plain
versions on the CPU) paths, with the conv and space-to-depth stems and
1x1 convolutions as convolutions or channel matmuls.

Tolerances (float32, sums in another order): logits and loss within
2e-5, gradients within 1e-4 relative + 1e-5 of the largest value,
running statistics within 1e-5.

Also: ResNet-50's parameter count and fusion bucket plan equal the JAX
package's; "SAME" padding, the max pool and space-to-depth equal
flax's; ``init_params`` draws flax's distributions; the reference's
``ResNet(norm_cls=SyncBatchNorm)`` TypeError is kept.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.models import resnet as jr
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu_torch import SyncBatchNorm
from horovod_tpu_torch.examples.resnet50_synthetic import \
    softmax_cross_entropy
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.models.convert import resnet_from_flax, \
    resnet_to_flax
from horovod_tpu_torch.ops import fusion as tfusion

torch.set_num_threads(1)

_TINY = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10)
_VARIANTS = {"conv": {}, "s2d": {"stem": "space_to_depth"},
             "dot": {"one_by_one": "dot"}}


def _perturbed(tree, rng):
    """The tree with every ``scale`` leaf redrawn from U(0.5, 1.5)."""
    return {k: (_perturbed(v, rng) if isinstance(v, dict) else
                (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                 if k == "scale" else np.asarray(v)))
            for k, v in tree.items()}


def _batch():
    rng = np.random.RandomState(0)
    return (rng.rand(4, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, 4).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _jax_run(variant):
    """Perturbed weights, and the unfused flax model's logits, loss,
    gradients, updated batch_stats and eval logits, all numpy."""
    model = jr.ResNet(dtype=jnp.float32, **_TINY, **_VARIANTS[variant])
    x, y = _batch()
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _perturbed(jax.tree.map(np.asarray, variables["params"]),
                        np.random.RandomState(5))
    stats = jax.tree.map(np.asarray, variables["batch_stats"])

    def loss_fn(p):
        logits, upd = model.apply({"params": p, "batch_stats": stats},
                                  jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        onehot = jax.nn.one_hot(jnp.asarray(y), 10)
        loss = -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1))
        return loss, (logits, upd["batch_stats"])

    (loss, (logits, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    eval_logits = jax.jit(functools.partial(model.apply, train=False))(
        {"params": params, "batch_stats": new_stats}, jnp.asarray(x))
    to_np = functools.partial(jax.tree.map, np.asarray)
    return {"params": params, "stats": stats, "loss": float(loss),
            "logits": np.asarray(logits), "grads": to_np(grads),
            "new_stats": to_np(new_stats),
            "eval_logits": np.asarray(eval_logits)}


def _leaves(tree):
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_tiny_resnet_matches_flax(variant, fused):
    ref = _jax_run(variant)
    model = tr.ResNet(dtype=torch.float32, fused_bn=fused, **_TINY,
                      **_VARIANTS[variant])
    model.load_state_dict(resnet_from_flax(
        {"params": ref["params"], "batch_stats": ref["stats"]},
        fused_bn=fused))
    x, y = _batch()
    logits = model(torch.from_numpy(x))
    loss = softmax_cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"],
                               rtol=0, atol=2e-5)
    assert abs(loss.item() - ref["loss"]) <= 2e-5

    got = resnet_to_flax({n: p.grad for n, p in model.named_parameters()},
                         fused_bn=False)
    got_g, want_g = _leaves(got["params"]), _leaves(ref["grads"])
    assert sorted(got_g) == sorted(want_g)
    for name, w in want_g.items():
        assert got_g[name].shape == w.shape, name
        np.testing.assert_allclose(got_g[name], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)
    # the gradients inside the blocks are not trivially zero
    inner = "['BottleneckBlock_0']['Conv_1']['kernel']" if variant != "dot" \
        else "['BottleneckBlock_0']['Conv_0']['kernel']"
    assert np.abs(want_g[inner]).max() > 1e-4

    stats = _leaves(resnet_to_flax(dict(model.named_buffers()),
                                   fused_bn=False)["batch_stats"])
    want_s = _leaves(ref["new_stats"])
    assert sorted(stats) == sorted(want_s)
    for name, w in want_s.items():
        np.testing.assert_allclose(stats[name], w, rtol=0, atol=1e-5,
                                   err_msg=name)

    model.eval()
    with torch.no_grad():
        ev = model(torch.from_numpy(x))
    np.testing.assert_allclose(ev.numpy(), ref["eval_logits"], rtol=0,
                               atol=2e-5)


def test_resnet50_params_and_bucket_plan_equal_jax():
    """ResNet-50's parameters (count, names, shapes up to the conv
    layout) and its gradient bucket plan, at the default 128 MiB (one
    bucket) and at 4 MiB, equal the JAX package's."""
    jmodel = jr.ResNet50(num_classes=1000, fused_bn=True)
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 224, 224, 3), jnp.bfloat16))
    jparams = abstract["params"]
    with torch.device("meta"):
        model = tr.ResNet50(num_classes=1000, fused_bn=True)
    n_jax = sum(int(np.prod(v.shape))
                for v in jax.tree_util.tree_leaves(jparams))
    assert n_jax == sum(p.numel() for p in model.parameters()) == 25557032
    assert len(list(model.buffers())) == 2 * 53

    named = list(model.named_parameters())
    paths = [tfusion.flax_path(n) for n, _ in named]
    order = tfusion.flatten_order(paths)
    leaves = [(paths[i], tuple(named[i][1].shape), torch.float32)
              for i in order]
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [tfusion.keystr(p) for p, _, _ in leaves]

    def hwio(shape):
        return (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 \
            else shape

    for threshold in (128 * 1024 * 1024, 4 * 1024 * 1024):
        _, jplans = jfusion.pytree_bucket_plan(
            jparams, threshold_bytes=threshold, backward_order=True)
        tplans = tfusion.pytree_bucket_plan(
            leaves, threshold_bytes=threshold, backward_order=True)
        assert [[(int(i), int(o), int(n), tuple(int(d) for d in s))
                 for (i, o, n, s) in b] for b in jplans] == \
            [[(i, o, n, hwio(s)) for (i, o, n, s) in b] for b in tplans]
        if threshold > 100e6:
            assert len(tplans) == 1  # 102 MB of float32 gradients


@pytest.mark.parametrize("size,k,stride", [(224, 7, 2), (112, 3, 2),
                                           (56, 3, 1), (15, 3, 2),
                                           (32, 1, 2)])
def test_same_padding_and_pool_equal_flax(size, k, stride):
    rng = np.random.RandomState(size + k)
    x = rng.randn(2, size, size, 4).astype(np.float32)
    conv = fnn.Conv(6, (k, k), (stride, stride), padding="SAME",
                    use_bias=False, dtype=jnp.float32)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = conv.apply(v, jnp.asarray(x))
    port = tr.Conv(4, 6, (k, k), (stride, stride), dtype=torch.float32)
    with torch.no_grad():
        port.kernel.copy_(torch.from_numpy(
            np.array(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
    got = port(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    pooled = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                          padding="SAME")
    np.testing.assert_array_equal(
        tr.max_pool_same(torch.from_numpy(x)).numpy(), np.asarray(pooled))


def test_space_to_depth_equals_jax():
    x = np.arange(2 * 8 * 8 * 3, dtype=np.float32).reshape(2, 8, 8, 3)
    np.testing.assert_array_equal(
        tr.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jr.space_to_depth(jnp.asarray(x))))
    with pytest.raises(ValueError, match="divisible"):
        tr.space_to_depth(torch.zeros(1, 7, 8, 3))


def test_init_params_draws_flax_distributions():
    model = tr.ResNet(dtype=torch.float32, fused_bn=True, **_TINY)
    model.init_params(torch.Generator().manual_seed(0))
    k = model.BottleneckBlock_1.Conv_1.kernel.detach()  # 3x3, 16 -> 16
    std = (1 / (9 * 16)) ** 0.5
    assert abs(float(k.std()) - std) < 0.1 * std
    assert float(k.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.equal(model.BottleneckBlock_0.FusedBatchNorm_2.scale,
                       torch.zeros(32))
    assert torch.equal(model.BottleneckBlock_0.FusedBatchNorm_1.scale,
                       torch.ones(8))
    assert torch.equal(model.bn_init.var, torch.ones(8))
    assert torch.equal(model.Dense_0.bias, torch.zeros(10))


def test_norm_cls_slot_and_its_reference_fault():
    """``norm_cls`` replaces BatchNorm and conflicts with ``fused_bn``.
    The reference's ``ResNet(norm_cls=SyncBatchNorm)`` raises a
    TypeError (its blocks pass ``scale_init``, which SyncBatchNorm
    lacks); the port keeps that behaviour (ROADMAP §C)."""
    with pytest.raises(ValueError, match="conflicts"):
        tr.ResNet(**_TINY, fused_bn=True, norm_cls=SyncBatchNorm)
    with pytest.raises(TypeError, match="scale_init"):
        tr.ResNet(**_TINY, norm_cls=SyncBatchNorm)
    jmodel = jr.ResNet(**_TINY, norm_cls=jhvd.SyncBatchNorm)
    with pytest.raises(TypeError, match="scale_init"):
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 32, 32, 3)))
