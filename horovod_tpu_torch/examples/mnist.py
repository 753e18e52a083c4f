"""MNIST data-parallel training, the framework's hello-world.

The port of the JAX package's ``examples/mnist.py`` (the reference
Horovod's ``examples/pytorch/pytorch_mnist.py``: ``init``,
``DistributedOptimizer``, a broadcast of the initial state, rank-0-only
checkpointing and logging): the example's small ConvNet on synthetic
"MNIST-like" digits (procedural, no download; the same arrays as the
JAX example's, bit for bit), SGD with momentum at ``lr * size`` under
the DistributedOptimizer. Each step takes ``batch * size`` rows of a
per-epoch permutation of the global training set, rank r its own
``batch`` rows of them, as the JAX example's sharded batch does; the
printed train loss and accuracy are the last step's, averaged over the
ranks.

    python -m horovod_tpu_torch.examples.mnist --epochs 2
    python -m horovod_tpu_torch.examples.mnist --device cpu  # on the CPU

``--save`` writes rank 0's parameters with ``np.save(...,
allow_pickle=True)``, as the JAX example does, in the flax tree layout
(``models/convert.resnet_to_flax``: HWIO convolution kernels).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch import nn

from ..core import basics
from ..models.convert import resnet_to_flax
from ..models.mlp import max_pool
from ..models.resnet import Conv, Dense, init_flax_params
from ..ops.collectives import allreduce
from ..optim.distributed import DistributedOptimizer
from ..optim.functions import broadcast_optimizer_state, \
    broadcast_parameters


class ConvNet(nn.Module):
    """The reference example's small convnet shape (two 3x3 "SAME"
    convolutions with biases, two dense), float32, on ``[B, 28, 28, 1]``
    NHWC images; named as flax names it (``Conv_0``, ``Conv_1``,
    ``Dense_0``, ``Dense_1``)."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(1, 32, (3, 3), dtype=torch.float32, use_bias=True)
        self.Conv_1 = Conv(32, 64, (3, 3), dtype=torch.float32,
                           use_bias=True)
        self.Dense_0 = Dense(7 * 7 * 64, 128)
        self.Dense_1 = Dense(128, 10)

    def init_params(self, generator: torch.Generator) -> "ConvNet":
        """flax's default initializers (``resnet.init_flax_params``)."""
        return init_flax_params(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(torch.relu(self.Conv_0(x)), 2, 2)
        x = max_pool(torch.relu(self.Conv_1(x)), 2, 2)
        x = x.reshape(x.shape[0], -1)  # NHWC order, as flax's
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def synthetic_mnist(n: int, seed: int):
    """Procedural digit-ish images: each class is a fixed random template
    plus noise, so the task is learnable and accuracy is meaningful."""
    rng = np.random.RandomState(1234)  # shared templates
    templates = rng.rand(10, 28, 28, 1).astype(np.float32)
    r = np.random.RandomState(seed)
    labels = r.randint(0, 10, n)
    images = templates[labels] + 0.3 * r.rand(n, 28, 28, 1).astype(np.float32)
    return images, labels


def loss_and_accuracy(logits: torch.Tensor, labels: torch.Tensor):
    """The JAX example's float32 mean softmax cross-entropy and the
    accuracy of the argmax."""
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels, 10).to(logp.dtype)
    loss = -torch.mean(torch.sum(onehot * logp, dim=-1))
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, acc


def main(argv=None, stats=None):
    p = argparse.ArgumentParser(description="horovod_tpu_torch MNIST example")
    p.add_argument("--batch-size", type=int, default=64,
                   help="per-rank batch size")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.5)
    p.add_argument("--train-size", type=int, default=2048)
    p.add_argument("--test-size", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save", default="", help="rank-0 checkpoint path")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the card)")
    args = p.parse_args(argv)

    basics.init(device=args.device)
    n, r = basics.size(), basics.rank()
    dev = basics.device()

    with torch.device(dev):
        model = ConvNet()
    model.init_params(torch.Generator(device=dev).manual_seed(args.seed))
    # scale the learning rate by the world size, broadcast the initial
    # state from rank 0: the canonical recipe (reference pytorch_mnist.py)
    broadcast_parameters(model.named_parameters(), root_rank=0)
    opt = DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr * n,
                        momentum=args.momentum),
        named_parameters=model.named_parameters())
    broadcast_optimizer_state(opt, root_rank=0)

    images, labels = synthetic_mnist(args.train_size * n, seed=args.seed)
    test_x, test_y = synthetic_mnist(args.test_size, seed=args.seed + 1)
    test_x = torch.from_numpy(test_x).to(dev)
    test_y = torch.from_numpy(test_y).to(dev)
    steps_per_epoch = args.train_size // args.batch_size
    batch = args.batch_size

    losses = []  # every step's local loss, read at the end
    for epoch in range(args.epochs):
        t0 = time.time()
        perm = np.random.RandomState(epoch).permutation(len(images))
        metrics = torch.zeros(2, device=dev)
        for i in range(steps_per_epoch):
            sel = perm[i * batch * n:(i + 1) * batch * n]
            mine = sel[r * batch:(r + 1) * batch]
            xb = torch.from_numpy(images[mine]).to(dev)
            yb = torch.from_numpy(labels[mine]).to(dev)
            loss, acc = loss_and_accuracy(model(xb), yb)
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            metrics = torch.stack([loss.detach(), acc])
            losses.append(metrics[0])
        metrics = allreduce(metrics)  # the mean over the ranks
        with torch.no_grad():
            test_loss, test_acc = loss_and_accuracy(model(test_x), test_y)
        if r == 0:
            tr_loss, tr_acc = metrics.tolist()
            print(f"epoch {epoch}: train_loss={tr_loss:.4f} "
                  f"train_acc={tr_acc:.3f} test_loss={float(test_loss):.4f} "
                  f"test_acc={float(test_acc):.3f} "
                  f"({time.time() - t0:.1f}s)", flush=True)

    if args.save and r == 0:
        # rank-0-only checkpointing, as the reference examples do
        params = resnet_to_flax(dict(model.named_parameters()))["params"]
        np.save(args.save, params, allow_pickle=True)
        print(f"saved checkpoint to {args.save}", flush=True)
    if stats is not None:
        stats["losses"] = [float(x) for x in losses]
        stats["test_acc"] = float(test_acc)
    return float(test_acc)


if __name__ == "__main__":
    main()
