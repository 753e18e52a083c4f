"""The port's ResNet training in a world of two.

* Three SGD-momentum steps (lr 0.1, momentum 0.9) of the tiny float32
  ``ResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10)`` with
  ``fused_bn=True`` (the kernels' plain versions on the CPU), through
  the ported example's ``make_train_step``, in two worker processes
  joined over gloo, each on its own rows of the example's global batch.
  The reference is the JAX example's ``step_fn``
  (``examples/resnet50_synthetic.py:123-144``) under ``shard_map`` on a
  two-device mesh with the same global batch and the unfused flax model
  (its fused Pallas model would run in interpret mode for minutes).
  Compared: the loss of every step (the mean over the ranks, the JAX
  step's ``psum / n``), the parameters after three steps, and each
  rank's BatchNorm running statistics against those of the JAX device of
  the same index (neither side broadcasts them). Both ranks end with
  bitwise equal parameters. Float32, sums in another order and
  momentum carrying the differences on: losses within 1e-5, parameters
  within 2e-5 + 1e-4 relative, running statistics within 1e-5.
* The example itself, as a world of two over gloo through
  ``examples/local_world.py`` at 32 px, prints the JAX example's lines.
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
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.compat import shard_map
from horovod_tpu.models import resnet as jr
from horovod_tpu_torch.examples import resnet50_synthetic as ex
from horovod_tpu_torch.models.convert import resnet_from_flax, \
    resnet_to_flax

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
_TINY = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10)
STEPS, BATCH, SIZE = 3, 2, 32  # per-rank batch of 32 px images


@pytest.fixture(autouse=True)
def _fresh_port():
    hvd.shutdown()
    yield
    hvd.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(code, out_dir, *args, timeout=180):
    """Run ``code`` as ranks 0 and 1 of a gloo world (the launcher's slot
    environment on a free port); returns their outputs."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(out_dir), *map(str, args)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        finally:
            p.kill()
        assert p.returncode == 0, outs[-1]
    return outs


def _mesh2():
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    jhvd.init(mesh=mesh)
    return mesh


def _per_device(arr):
    """Device 0's and device 1's buffers of a replicated output."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.device.id)
    return [np.asarray(s.data) for s in shards[:2]]


# ---------------------------------------------------------------------------
# data-parallel ResNet steps
# ---------------------------------------------------------------------------

_DP_WORKER = r'''
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples import resnet50_synthetic as ex
from horovod_tpu_torch.models.resnet import ResNet

out, steps, batch, size = sys.argv[1], *map(int, sys.argv[2:5])
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
model = ResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10,
               dtype=torch.float32, fused_bn=True)
model.load_state_dict(torch.load(out + "/init.pt"))
if r == 1:  # rank 0's parameters must reach rank 1
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
images, labels = ex.synthetic_batch(batch, size, 10, r, n)
step = ex.make_train_step(model, hvd.Compression.none)
losses = []
for _ in range(steps):
    loss = step(torch.from_numpy(images), torch.from_numpy(labels))
    losses.append(float(hvd.allreduce(loss.reshape(1))))
torch.save({"losses": losses, "state": model.state_dict(),
            "buckets": len(step.optimizer.bucket_plan)},
           out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _jax_example_steps(params, stats, xb, yb, steps):
    """The JAX example's step (loss_fn + step_fn + shard_map) on a
    two-device mesh, float32: per-step losses, final params, and each
    device's batch_stats."""
    mesh = _mesh2()
    model = jr.ResNet(dtype=jnp.float32, **_TINY)
    n = 2
    opt = jhvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                    compression=jhvd.Compression.none)
    opt_state = opt.init(params)

    def loss_fn(p, bs, x, y):
        logits, new_state = model.apply(
            {"params": p, "batch_stats": bs}, x.astype(jnp.float32),
            train=True, mutable=["batch_stats"])
        onehot = jax.nn.one_hot(y, 10)
        loss = -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1))
        return loss, new_state["batch_stats"]

    def step_fn(p, bs, s, x, y):
        (loss, bs), g = jax.value_and_grad(loss_fn, has_aux=True)(
            p, bs, x, y)
        upd, s = opt.update(g, s, p)
        p = optax.apply_updates(p, upd)
        return p, bs, s, jax.lax.psum(loss, "hvd").reshape(1) / n

    step = jax.jit(shard_map(
        step_fn, mesh=mesh, in_specs=(P(), P(), P(), P("hvd"), P("hvd")),
        out_specs=(P(), P(), P(), P()), check_vma=False))
    losses = []
    for _ in range(steps):
        params, stats, opt_state, loss = step(
            params, stats, opt_state, jnp.asarray(xb), jnp.asarray(yb))
        losses.append(float(loss[0]))
    per_dev = [jax.tree.map(lambda a, i=i: _per_device(a)[i], stats)
               for i in range(2)]
    return losses, jax.tree.map(np.asarray, params), per_dev


def test_example_batch_is_the_jax_examples_global_batch():
    """Rank r's rows are rows [r*b, (r+1)*b) of the batch*n images (and
    then labels) the JAX example draws from seed 0."""
    rng = np.random.RandomState(0)
    xb = rng.rand(3 * 4, 8, 8, 3).astype(np.float32)
    yb = rng.randint(0, 10, 3 * 4)
    shards = [ex.synthetic_batch(3, 8, 10, r, 4) for r in range(4)]
    np.testing.assert_array_equal(np.concatenate([s[0] for s in shards]),
                                  xb)
    np.testing.assert_array_equal(np.concatenate([s[1] for s in shards]),
                                  yb)
    assert shards[0][1].dtype == np.int64


def test_resnet_steps_world_of_two_match_jax_example(tmp_path):
    jmodel = jr.ResNet(dtype=jnp.float32, **_TINY)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                      if p[-1].key == "scale" else np.asarray(v)),
        variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    torch.save(resnet_from_flax({"params": params, "batch_stats": stats},
                                fused_bn=True), tmp_path / "init.pt")
    rng0 = np.random.RandomState(0)
    xb = rng0.rand(BATCH * 2, SIZE, SIZE, 3).astype(np.float32)
    yb = rng0.randint(0, 10, BATCH * 2)
    outs = _run_world(_DP_WORKER, tmp_path, STEPS, BATCH, SIZE)
    want_losses, want_params, want_stats = _jax_example_steps(
        params, stats, xb, yb, STEPS)
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    assert res[0]["buckets"] == 1, outs
    for r in range(2):
        np.testing.assert_allclose(res[r]["losses"], want_losses, rtol=0,
                                   atol=1e-5)
    params_of = [{k: v for k, v in res[r]["state"].items()
                  if not k.endswith((".mean", ".var"))} for r in range(2)]
    for k in params_of[0]:
        assert torch.equal(params_of[0][k], params_of[1][k]), k
    got = resnet_to_flax(params_of[0], fused_bn=False)["params"]
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(want_params)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))
    for r in range(2):
        bufs = {k: v for k, v in res[r]["state"].items()
                if k.endswith((".mean", ".var"))}
        got_s = resnet_to_flax(bufs, fused_bn=False)["batch_stats"]
        flat_w = jax.tree_util.tree_leaves_with_path(want_stats[r])
        flat_g = jax.tree_util.tree_leaves_with_path(got_s)
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (path, g), (_, w) in zip(flat_g, flat_w):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"rank {r} "
                                       f"{jax.tree_util.keystr(path)}")
    # per-rank statistics: the two ranks saw different rows
    assert not np.allclose(want_stats[0]["bn_init"]["mean"],
                           want_stats[1]["bn_init"]["mean"])


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def test_example_world_of_two_prints_the_jax_examples_lines():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.examples.local_world",
         "-np", "2", "--", sys.executable, "-m",
         "horovod_tpu_torch.examples.resnet50_synthetic", "--device", "cpu",
         "--image-size", "32", "--batch-size", "2", "--num-classes", "10",
         "--num-warmup-batches", "1", "--num-batches-per-iter", "1",
         "--num-iters", "2", "--fused-bn"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[0]")]
    assert "[0]model: resnet50, batch 2 x 2 ranks, image 32px" in lines
    assert sum(ln.startswith("[0]iter ") and ln.endswith(
        "img/sec total") for ln in lines) == 2
    assert any(ln.startswith("[0]total img/sec on 2 rank(s): ")
               and "/chip, MFU n/a" in ln for ln in lines)
    assert not any(ln.startswith("[1]model") for ln in
                   out.stdout.splitlines())


def test_example_refuses_unported_models_and_runs_on_the_card():
    for flag in (["--fused-bn"], ["--s2d-stem"], ["--one-by-one", "dot"]):
        with pytest.raises(SystemExit, match="resnet family"):
            ex.main(["--model", "vgg16", "--device", "cpu", *flag])
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.main(["--image-size", "32", "--batch-size", "1",
                 "--num-iters", "0", "--num-warmup-batches", "0"])
    stats = {}
    rate, mfu = ex.main(["--device", "cpu", "--image-size", "32",
                         "--batch-size", "2", "--num-classes", "10",
                         "--num-warmup-batches", "1", "--num-iters", "1",
                         "--num-batches-per-iter", "2", "--fused-bn",
                         "--one-by-one", "dot", "--s2d-stem",
                         "--bf16-allreduce"], stats)
    assert rate > 0 and mfu is None
    assert len(stats["losses"]) == 3 and np.isfinite(stats["losses"]).all()
    assert stats["n_params"] == 25557032 - 1000 * 2048 - 1000 + 10 * 2049 \
        + 64 * (4 * 4 * 12 - 7 * 7 * 3)
