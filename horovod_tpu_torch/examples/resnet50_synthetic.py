"""Synthetic CNN benchmark (images/sec + MFU), ResNet-50 by default.

The port of the JAX package's ``examples/resnet50_synthetic.py``, with
its flags, output lines and ``main(argv, stats)`` return (the reference
Horovod's ``examples/pytorch/pytorch_synthetic_benchmark.py``): a bf16
ResNet with float32 BatchNorm statistics and parameters on a synthetic
ImageNet batch, SGD (lr 0.1, momentum 0.9) under the
DistributedOptimizer's fused gradient buckets, optionally the fused
BatchNorm kernels (``--fused-bn``). ``--model`` covers the reference's
scaling trio: resnet50/101/152, inception3 (299 px) and vgg16 (no
BatchNorm, so no batch statistics in its step). Each rank trains on its
own rows of a global batch drawn from seed 0, and keeps its own
BatchNorm running statistics, as the JAX example's ``shard_map`` does.

Run on the card, one process per card (the launcher,
``horovod_tpu_torch.runner``, exports the rank environment for
several):

    python -m horovod_tpu_torch.examples.resnet50_synthetic --fused-bn
    python -m horovod_tpu_torch.examples.resnet50_synthetic --device cpu \\
        --image-size 32 --batch-size 2   # a smoke on the CPU
    python -m horovod_tpu_torch.examples.resnet50_synthetic --model \\
        inception3 --batch-size 256
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import basics
from ..models.inception import InceptionV3
from ..models.resnet import ResNet50, ResNet101, ResNet152
from ..models.vgg import VGG16
from ..ops.collectives import allreduce
from ..optim.compression import Compression
from ..optim.distributed import DistributedOptimizer
from ..optim.functions import broadcast_parameters
from ..utils.mfu import cnn_train_flops, count_params, peak_flops_per_chip

_MODELS = {
    "resnet50": (ResNet50, 224),
    "resnet101": (ResNet101, 224),
    "resnet152": (ResNet152, 224),
    "inception3": (InceptionV3, 299),
    "vgg16": (VGG16, 224),
}


def synthetic_batch(batch, image_size, num_classes, rank, size,
                    cross_size=1):
    """This rank's ``(images [batch, S, S, 3] float32, labels [batch]
    int64)`` of the synthetic global batch, as the JAX example shards
    it: ``batch * size`` images and then labels drawn from seed 0 (each
    host's rank when there are several hosts), rank r taking rows ``[r *
    batch, (r + 1) * batch)``."""
    rng = np.random.RandomState(rank if cross_size > 1 else 0)
    images = rng.rand(batch * size, image_size, image_size,
                      3).astype(np.float32)
    labels = rng.randint(0, num_classes, batch * size).astype(np.int64)
    rows = slice(rank * batch, (rank + 1) * batch)
    return images[rows], labels[rows]


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """The JAX example's loss: the float32 mean over the batch of
    ``-sum(onehot * log_softmax(logits))``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    onehot = torch.nn.functional.one_hot(labels, logits.shape[-1]).to(
        logp.dtype)
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def make_train_step(model: torch.nn.Module, compression=None):
    """``step(images, labels) -> local loss`` for data-parallel training
    of ``model``: rank 0's parameters are broadcast (the running
    statistics stay per rank), the gradients of the example's loss are
    averaged by ``DistributedOptimizer(SGD(lr=0.1, momentum=0.9))`` (the
    JAX example's ``optax.sgd(0.1, momentum=0.9)``: ``trace = g + 0.9 *
    trace``, no dampening, no weight decay), and the optimizer steps.
    ``compression=None`` takes the knobs' compressor, as the optimizer
    does. ``step.optimizer`` is the DistributedOptimizer."""
    broadcast_parameters(model.named_parameters(), root_rank=0)
    opt = DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=compression)

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        loss = softmax_cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    step.optimizer = opt
    return step


def main(argv=None, stats=None):
    p = argparse.ArgumentParser(
        description="horovod_tpu_torch synthetic CNN benchmark "
                    "(--model resnet50/101/152, inception3, vgg16)")
    p.add_argument("--model", choices=sorted(_MODELS), default="resnet50",
                   help="reference tf_cnn_benchmarks model name")
    p.add_argument("--batch-size", type=int, default=128,
                   help="per-rank batch size")
    p.add_argument("--image-size", type=int, default=0,
                   help="0 = the model's native resolution")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--num-warmup-batches", type=int, default=3)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=4)
    p.add_argument("--s2d-stem", action="store_true",
                   help="space-to-depth stem (2x2 unshuffle + 4x4/s1 "
                        "conv). resnet family only")
    p.add_argument("--fused-bn", action="store_true",
                   help="fused BN+relu(+residual) kernels "
                        "(ops/batchnorm.py). resnet family only")
    p.add_argument("--one-by-one", choices=["conv", "dot"], default="conv",
                   help="1x1 convs as convolution or channel matmul. "
                        "resnet family only")
    p.add_argument("--bf16-allreduce", action="store_true",
                   help="bfloat16 wire compression for gradients "
                        "(the reference's --fp16-allreduce)")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the card)")
    args = p.parse_args(argv)

    model_cls, native_size = _MODELS[args.model]
    if not args.image_size:
        args.image_size = native_size
    model_kw = {}
    if args.model.startswith("resnet"):
        model_kw = dict(stem="space_to_depth" if args.s2d_stem else "conv",
                        fused_bn=args.fused_bn, one_by_one=args.one_by_one)
    else:
        for flag, on in (("--s2d-stem", args.s2d_stem),
                         ("--fused-bn", args.fused_bn),
                         ("--one-by-one", args.one_by_one != "conv")):
            if on:
                raise SystemExit(f"{flag} applies to the resnet family")
        if args.model == "vgg16":
            model_kw = dict(image_size=args.image_size)
    basics.init(device=args.device)
    n = basics.size()
    dev = basics.device()
    torch.backends.cudnn.benchmark = True  # the reference benchmark's

    with torch.device(dev):
        model = model_cls(num_classes=args.num_classes, dtype=torch.bfloat16,
                          **model_kw)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    n_params = count_params(model.parameters())
    images, labels = synthetic_batch(
        args.batch_size, args.image_size, args.num_classes, basics.rank(),
        n, basics.cross_size())
    # the image batch is held in the model's compute dtype, as the JAX
    # example holds it
    xs = torch.from_numpy(images).to(dev, torch.bfloat16)
    ys = torch.from_numpy(labels).to(dev)
    step = make_train_step(model, Compression.bf16 if args.bf16_allreduce
                           else Compression.none)

    def sync_loss(loss):
        # the mean loss over the ranks; the host read closes a window
        return float(allreduce(loss.reshape(1)).item())

    if basics.rank() == 0:
        print(f"model: {args.model}, batch {args.batch_size} x {n} ranks, "
              f"image {args.image_size}px", flush=True)
    losses = []  # every step's local loss, read at the end
    for _ in range(args.num_warmup_batches):
        losses.append(step(xs, ys))
    if losses:
        sync_loss(losses[-1])

    rates, step_ms = [], []
    for it in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            losses.append(step(xs, ys))
        sync_loss(losses[-1])
        dt = time.perf_counter() - t0
        rate = args.batch_size * n * args.num_batches_per_iter / dt
        rates.append(rate)
        step_ms.append(dt * 1e3 / args.num_batches_per_iter)
        if basics.rank() == 0:
            print(f"iter {it}: {rate:.1f} img/sec total", flush=True)

    total = float(np.median(rates))
    per_chip = total / max(n, 1)
    peak = peak_flops_per_chip() if dev.type == "cuda" else None
    mfu = (cnn_train_flops(args.model, per_chip, args.image_size) / peak
           if peak else None)
    if basics.rank() == 0:
        mfu_s = f"MFU {mfu:.1%}" if mfu is not None else \
            "MFU n/a: no peak for this device"
        print(f"total img/sec on {n} rank(s): {total:.1f} "
              f"({per_chip:.1f}/chip, {mfu_s})", flush=True)
        if dev.type == "cuda":
            print(f"step {float(np.median(step_ms)):.1f} ms, peak device "
                  f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
                  " GB", flush=True)
    if stats is not None:
        stats["rates_per_chip"] = [r / max(n, 1) for r in rates]
        stats["step_ms"] = step_ms
        stats["losses"] = [float(x) for x in losses]
        stats["n_params"] = n_params
        stats["step"], stats["batch"] = step, (xs, ys)
    return per_chip, mfu


if __name__ == "__main__":
    main()
