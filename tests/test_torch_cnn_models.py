"""The port's MLP, MnistNet, VGG-16 and Inception V3 against the JAX
package's flax models, and the MNIST example against the JAX example.

Flax initializes the weights and ``models/convert.resnet_from_flax``
loads them into the port (HWIO kernels to OIHW, ``batch_stats`` to the
norms' buffers); the same numpy images then go through both, in
float32, so the comparison is of the algorithm (sums in another order):
logits and losses within 2e-5, gradients within 1e-4 relative + 1e-5 of
each tensor's largest value, running statistics within 1e-5. VGG-16 runs
at 32 px; each Inception block at a small spatial size, in training mode
(batch statistics), which covers the average pool's padding count and
the concatenation order; every BatchNorm scale is redrawn from U(0.5,
1.5) first. Inception V3's and VGG-16's parameter trees are compared by
name and shape without running them (``jax.eval_shape``, the port on
the meta device). The full-size JAX Inception forward (its own test is
``slow``) is not needed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import inception as ji
from horovod_tpu.models import mlp as jm
from horovod_tpu.models import vgg as jv
from horovod_tpu.utils.script_loader import load_example
from horovod_tpu_torch.examples import mnist as tmnist
from horovod_tpu_torch.examples import resnet50_synthetic as ex
from horovod_tpu_torch.examples.resnet50_synthetic import \
    softmax_cross_entropy
from horovod_tpu_torch.models import inception as ti
from horovod_tpu_torch.models import mlp as tm
from horovod_tpu_torch.models import vgg as tv
from horovod_tpu_torch.models.convert import resnet_from_flax, \
    resnet_to_flax

torch.set_num_threads(1)


def _perturbed(tree, rng):
    """The tree with every ``scale`` leaf redrawn from U(0.5, 1.5)."""
    return {k: (_perturbed(v, rng) if isinstance(v, dict) else
                (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                 if k == "scale" else np.asarray(v)))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _close_tree(got, want, rtol, atol_share):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(got[k], w, rtol=rtol,
                                   atol=atol_share * scale + 1e-7,
                                   err_msg=k)


def _loss(logits, y, n):
    """The JAX examples' loss: mean of -sum(onehot * log_softmax)."""
    return -jnp.mean(jnp.sum(jax.nn.one_hot(y, n)
                             * jax.nn.log_softmax(logits), -1))


def _check_classifier(jmodel, tmodel, x, y, classes, train_kw=None):
    """Flax-initialized weights into the port, then logits, loss and
    every gradient (and, with batch statistics, the updated ones)."""
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree.map(np.asarray, dict(variables))
    if "batch_stats" in variables:
        variables["params"] = _perturbed(variables["params"],
                                         np.random.RandomState(1))
    tmodel.load_state_dict(resnet_from_flax(variables))
    has_bn = "batch_stats" in variables

    def loss_fn(p):
        if has_bn:
            logits, new = jmodel.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                jnp.asarray(x), mutable=["batch_stats"], **(train_kw or {}))
        else:
            logits, new = jmodel.apply({"params": p}, jnp.asarray(x),
                                       **(train_kw or {})), {}
        return _loss(logits, jnp.asarray(y), classes), (logits, new)

    (jl, (jlog, jnew)), jg = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tlog = tmodel(torch.from_numpy(x))
    tl = softmax_cross_entropy(tlog, torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=2e-5)
    grads = resnet_to_flax({n: p.grad for n, p in
                            tmodel.named_parameters()})["params"]
    _close_tree(grads, jax.tree.map(np.asarray, jg), 1e-4, 1e-5)
    if has_bn:
        stats = resnet_to_flax(dict(tmodel.named_buffers()))["batch_stats"]
        _close_tree(stats, jax.tree.map(np.asarray, jnew["batch_stats"]),
                    0, 1e-5)


def _images(b, s, c, seed=0):
    return np.random.RandomState(seed).rand(b, s, s, c).astype(np.float32)


def test_mlp_matches_flax():
    x = _images(4, 8, 3)
    y = np.random.RandomState(1).randint(0, 10, 4)
    _check_classifier(jm.MLP(), tm.MLP(8 * 8 * 3), x, y, 10)


def test_mnist_net_matches_flax():
    x = _images(4, 28, 1)
    y = np.random.RandomState(2).randint(0, 10, 4)
    _check_classifier(jm.MnistNet(), tm.MnistNet(), x, y, 10)


def test_vgg16_matches_flax_at_32px():
    """At 32 px the five pools leave 1 x 1 x 512 features; the logits,
    loss and all 16 layers' gradients match."""
    x = _images(2, 32, 3)
    y = np.array([3, 7])
    _check_classifier(jv.VGG16(num_classes=10, dtype=jnp.float32),
                      tv.VGG16(num_classes=10, dtype=torch.float32,
                               image_size=32), x, y, 10,
                      train_kw={"train": True})


def test_vgg16_flattens_in_nhwc_order():
    """At 64 px Dense_0 sees 2 x 2 x 512 features: the flatten must run
    in NHWC order for a converted kernel to see the features it was
    trained on (forward only)."""
    x = _images(2, 64, 3, seed=3)
    jmodel = jv.VGG16(num_classes=10, dtype=jnp.float32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    tmodel = tv.VGG16(num_classes=10, dtype=torch.float32, image_size=64)
    tmodel.load_state_dict(resnet_from_flax(jax.tree.map(np.asarray,
                                                         variables)))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


def _port_shapes(model):
    """The port's parameters and buffers by flax name, 4-D kernels as
    HWIO (on the meta device: no memory)."""
    out = {}
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        shape = tuple(t.shape)
        out[name] = (shape[2], shape[3], shape[1], shape[0]) \
            if len(shape) == 4 else shape
    return out


def test_vgg16_parameter_count_and_tree_at_224px():
    """138.36M parameters (the published VGG-16), name for name and shape
    for shape the flax tree."""
    variables = jax.eval_shape(jv.VGG16(num_classes=1000).init,
                               jax.random.PRNGKey(0),
                               jnp.zeros((1, 224, 224, 3)))
    with torch.device("meta"):
        model = tv.VGG16(num_classes=1000)
    assert _port_shapes(model) == _shapes(variables["params"])
    n = sum(p.numel() for p in model.parameters())
    assert abs(n - 138.36e6) < 0.5e6, n


def test_inception_v3_tree_matches_flax():
    """Inception V3's parameters and BatchNorm statistics equal the flax
    tree's, name for name and shape for shape (23.8M parameters)."""
    variables = jax.eval_shape(ji.InceptionV3(num_classes=1000).init,
                               jax.random.PRNGKey(0),
                               jnp.zeros((1, 299, 299, 3)))
    with torch.device("meta"):
        model = ti.InceptionV3(num_classes=1000)
    want = {**_shapes(variables["params"]),
            **_shapes(variables["batch_stats"])}
    assert _port_shapes(model) == want
    n = sum(p.numel() for p in model.parameters())
    assert abs(n - 23.83e6) < 0.05e6, n


_BLOCKS = {  # name: (flax block, port block, input channels, spatial size)
    "A": (functools.partial(ji.InceptionA, 16),
          lambda c, d: ti.InceptionA(c, 16, d), 24, 5),
    "B": (ji.InceptionB, ti.InceptionB, 16, 7),
    "C": (functools.partial(ji.InceptionC, 8),
          lambda c, d: ti.InceptionC(c, 8, d), 16, 7),
    "D": (ji.InceptionD, ti.InceptionD, 16, 9),
    "E": (ji.InceptionE, ti.InceptionE, 16, 4),
}


@pytest.mark.parametrize("name", sorted(_BLOCKS))
def test_inception_block_matches_flax(name):
    """Each block in float32 training mode: output (the branches'
    concatenation, the pools' padding), the gradient of a fixed linear
    function of it with respect to every parameter, and the updated
    running statistics."""
    jblock, tblock, c, s = _BLOCKS[name]
    jmodel = jblock(dtype=jnp.float32)
    tmodel = tblock(c, torch.float32)
    x = np.random.RandomState(4).randn(2, s, s, c).astype(np.float32)
    variables = jax.tree.map(np.asarray, dict(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(x))))
    variables["params"] = _perturbed(variables["params"],
                                     np.random.RandomState(5))
    tmodel.load_state_dict(resnet_from_flax(variables))

    def fn(p):
        out, new = jmodel.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), mutable=["batch_stats"])
        return jnp.sum(out * probe), (out, new)

    shape = jax.eval_shape(lambda: jmodel.apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])[0]).shape
    probe = np.random.RandomState(6).randn(*shape).astype(np.float32)
    (_, (jout, jnew)), jg = jax.jit(jax.value_and_grad(
        fn, has_aux=True))(variables["params"])
    tout = tmodel(torch.from_numpy(x))
    (tout * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=2e-5)
    grads = resnet_to_flax({n: p.grad for n, p in
                            tmodel.named_parameters()})["params"]
    _close_tree(grads, jax.tree.map(np.asarray, jg), 1e-4, 1e-5)
    stats = resnet_to_flax(dict(tmodel.named_buffers()))["batch_stats"]
    _close_tree(stats, jax.tree.map(np.asarray, jnew["batch_stats"]), 0,
                1e-5)


@pytest.mark.parametrize("model,size", [("vgg16", 64), ("inception3", 75)])
def test_synthetic_benchmark_model_flag(model, size):
    """``--model`` runs VGG-16 (no batch statistics in its step) and
    Inception V3 on the CPU at a small size, as the JAX example's test
    runs ``--model vgg16``."""
    stats = {}
    per_chip, mfu = ex.main(
        ["--model", model, "--image-size", str(size), "--batch-size", "2",
         "--num-warmup-batches", "1", "--num-batches-per-iter", "1",
         "--num-iters", "1", "--num-classes", "10", "--device", "cpu"],
        stats)
    assert per_chip > 0 and mfu is None
    assert len(stats["losses"]) == 2 and np.isfinite(stats["losses"]).all()
    import horovod_tpu_torch as hvd
    hvd.shutdown()


def test_synthetic_mnist_is_the_jax_examples():
    jex = load_example("mnist")
    for n, seed in ((100, 42), (37, 43)):
        ji_, jl = jex.synthetic_mnist(n, seed)
        ti_, tl = tmnist.synthetic_mnist(n, seed)
        assert ji_.dtype == ti_.dtype and jl.dtype == tl.dtype
        np.testing.assert_array_equal(ti_, ji_)
        np.testing.assert_array_equal(tl, jl)


def test_mnist_convnet_matches_the_jax_examples():
    jex = load_example("mnist")
    x = _images(4, 28, 1, seed=7)
    y = np.random.RandomState(8).randint(0, 10, 4)
    _check_classifier(jex.ConvNet(), tmnist.ConvNet(), x, y, 10)


def test_mnist_epoch_beats_chance_and_saves_the_flax_tree(tmp_path):
    """One CPU epoch reaches a test accuracy far above chance (0.1), and
    ``--save`` writes rank 0's parameters in the JAX example's tree
    layout (HWIO kernels)."""
    import horovod_tpu_torch as hvd

    path = tmp_path / "ckpt.npy"
    stats = {}
    try:
        acc = tmnist.main(["--epochs", "1", "--device", "cpu", "--save",
                           str(path)], stats)
    finally:
        hvd.shutdown()
    assert acc > 0.5
    assert np.mean(stats["losses"][-4:]) < np.mean(stats["losses"][:4])
    saved = np.load(path, allow_pickle=True).item()
    want = jax.eval_shape(load_example("mnist").ConvNet().init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
    assert _shapes(saved) == _shapes(want["params"])
