#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (horovod_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --parity-sweep 8   # the parity limits' readings
    python3 chip_smoke.py --profiles         # kernel, int8, GPT-2, decode,
                                             # ResNet profiles
    python3 chip_smoke.py --profiler-probe 32   # what profiler windows
                                                # keep as the process ages
    python3 chip_smoke.py --adasum-sweep 8   # phase 4g's limit's readings

Phases, in order; the first failure exits non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build every kernel of ``horovod_tpu_torch/csrc/`` (one nvcc each, in
   parallel) and print the build seconds, ptxas's registers, shared
   memory and spills by kernel, and the count of tensor-core
   instructions (``mma.sync``'s HMMA, ``wgmma``'s HGMMA) in the flash,
   append+attend and matmul kernels' SASS where cuobjdump is installed;
3. hold each kernel against its plain PyTorch version on the card, at
   its path's shapes and in its working dtypes (flash attention at
   GPT-2 medium's [8, 16, 1024, 64] and Llama-2's [2, 32, 4096, 128]
   bf16, row by row, and there kernels that skip one tile of the
   kernels' own tiling must fail the same check; B1-B3 and SDPA timed
   by CUDA events and by the profiler's device time, and ptxas's lines
   of the head_dim-128 instantiations; the LayerNorm forward element by element at the
   serving and training shapes and on each of its routes, where a row
   of its partition left as stale memory must fail, timed L2-hot and,
   at [8192, 1024], L2-cold; LayerNorm backward at [8192, 1024], dx row
   by row and dgamma, dbeta per column, where sums that leave out one
   block of its partition must fail; the decode kernels at the serving
   shapes,
   B16 on its prefill (tensor cores) and decode (cluster) routes and
   B17 on the same decode route, row by row, where a prefill block that
   skips its last key tile or a cluster that skips one CTA's span must
   fail, merged caches (B17: codes and scales) bitwise; the
   BatchNorm kernels at ResNet-50's shapes, apply and dx bitwise (dx
   folding its constants from the statistics; apply also on an output
   buffer poisoned with NaN just before), the two one-launch
   reductions per channel and bitwise from run to run, where sums that
   leave out one row block of their partition, or a finish that drops
   one partial row, must fail, and the statistics kernel's folded
   constants bitwise the plain fold of its own sums; the int8 wire's
   kernels bitwise on the largest bucket of GPT-2 medium's plan at
   worlds 4 and 8 and on edge cases (the dequantize-accumulate on both
   its routes and on a NaN-poisoned output buffer); the bucket pack
   bitwise on BERT-Large's largest bucket and edge cases; the
   matmul with the ring-row epilogue row by row against a float64
   product at BERT-Large's weight-gradient shapes, where a kernel that
   skips one K tile must fail, and bitwise on integer operands), and
   time the kernel, the plain version and one PyTorch library call computing
   the same function where there is one (a yardstick only: the port
   never calls it); and the vocab-blocked fused cross-entropy (no kernel
   of its own) at GPT-2 medium's ([8184, 1024] x 50257) and BERT-Large's
   ([4096, 1024] x 30522) heads against a float64 materialized
   reference, the loss, dX row by row and dW vocab row by vocab row
   (``CE_TOL``), also with rows masked out and out-of-range ids, where a
   version that skips the ragged last vocab block, leaves its pad
   columns unmasked or drops one block's dW must fail; the head + loss
   timed fused and unfused (device ms, GEMM kernels by name, peak
   memory), and the float32 product's route;
4. train GPT-2 medium at full width and depth through the example's
   ``main`` (world of one over NCCL, batch 8 x 1024, flash attention and
   fused norms, 1 warm-up + 5 timed steps on one batch), after checking
   that the step-1 loss and every gradient of the kernel path agree
   with the plain path on the same weights (``GRAD_TOL``); the loss
   must fall; one step is profiled;
4b. train GPT-2 medium over the int8 wire (block 256, error feedback)
   in a world of four emulated on the card, 3 steps: every bucket and
   residual bitwise against the plain versions' composition, the ranks
   bitwise equal, each bucket within ``INT8_REL_TOL`` of the float32
   mean, exact launch counts, a falling loss; then the real
   ``quantized_psum`` through NCCL (a world of one), bitwise; and the
   wire's byte accounting;
4c. train BERT-Large (24 x 1024, vocab 30522, seq 512, bf16, non-causal
   flash attention, fused norms) under ZeRO-1 in a world of four
   emulated on the card, 3 steps on the float32 wire and one on the
   int8 wire: every packed bucket (B6, exactly 44 launches a step)
   bitwise against ``_pad_rows``, the ranks bitwise equal, the
   parameters within ``ZERO_REL_TOL`` of a DistributedOptimizer
   emulation on the same global batch, each rank's AdamW state 1/4 of
   the replicated one, a falling loss; then the example's ``main``
   with ``--zero --flash --fused-ln`` at world 1 over NCCL (B6 does not
   launch there); the step-1 check of the fused cross-entropy against
   ``mlm_loss`` on one BERT-Large (``CE_GRAD_TOL``) and the example's
   ``main`` again with ``--fused-ce``, a falling loss and exactly
   ``STEP_LAUNCHES`` a step; and ``matmul_reduce_scatter`` at world 1,
   bitwise against ``matmul_pack``;
4d. train GPT-2 medium at bench.py's cell through the example's
   ``main``: batch 16 x 1024, ``--flash --fused-norm --fused-ce``, 1
   warm-up + 5 timed steps, after the step-1 check of the fused LM head
   + loss against the unfused head and ``causal_lm_loss`` on the same
   weights and batch (``CE_GRAD_TOL``); the loss must fall, B1-B5 launch
   exactly ``STEP_LAUNCHES`` a step; one step is profiled (device ms by
   group, the elementwise group's top kernels by name);
4e. drive GPT-2 medium through the port's launcher
   (``horovod_tpu_torch.runner``): ``python -m
   horovod_tpu_torch.runner.launch -np 1 -H localhost:1`` running the
   example at phase 4's arguments with 3 timed steps (exit 0, the
   ``[0]``-prefixed rate line, the ``[0]iter 0`` loss printed as phase
   4's step-4 loss prints, tokens/s beside phase 4's in-process rate,
   the seconds from launch to the first step); ``runner.run(fn, np=1)``
   with one step in the worker (``cuda:0``, NCCL, world 1, B1-B5
   exactly ``STEP_LAUNCHES``, its loss bitwise phase 4's step-1 loss:
   same seed, weights and batch); ``-np 2 -H localhost:2`` on one card,
   where rank 1 must fail in ``init()`` for want of a card and the
   launcher must stop rank 0 and exit non-zero within
   ``REFUSAL_BOUND_S``, no rank training (with two cards or more: a
   world-2 NCCL run instead); and ``--check-build``, which must report
   NCCL, CUDA and nvcc;
4f. train GPT-2 medium with fully-sharded parameters
   (``FullyShardedOptimizer``, ``optim/fsdp.py``) through the staged
   FSDP runners (``ops/overlap.py``): (a) through ``make_lm_train_step`` at
   world 1 over NCCL (batch 8 x 1024, ``--flash --fused-norm``, AdamW), 3
   steps in each FSDP mode (regather, saved gathers, prefetch 0 and 2,
   offload), bitwise phase 4's losses and the DistributedOptimizer's
   parameters, exact launch counts (B1 48 and B4 97 a step under
   regather: the recompute), step ms and tokens/s beside phase 4's; (b)
   in a world of four emulated on the card (``EmulatedWorld``: a rank
   keeps its rows, a gather concatenates the ranks' rows on a side
   stream with events), 2 x 1024 a rank, 3 steps on the float32 wire and
   on the int8 wire with error feedback (block 256): every mode bitwise
   the gathered reference (losses, shards, residuals), the float32 wire
   bitwise ZeRO-1 on the same world, each B6 launch of a step bitwise
   ``_pad_rows``, each bucket issued at ``bucket_issue_schedule``'s
   boundary, exact launch counts (B6, B12, B13 once a bucket a rank);
   (c) a ``torch.cuda._sleep`` on the side stream before each exchange
   (gathers poisoned with NaN first) keeps (b)'s bits, and a dropped
   wait on one gather's event, or on the last rank's last
   reduce-scatter, must lose them; (e) a rank's peak parameter bytes
   beside shard + prefetch x the largest bucket, offloaded bytes,
   B6/B12/B13 device ms of one rank's int8 step;
4g. train GPT-2 medium under Adasum (``op=Adasum``, ``ops/adasum.py``):
   (a) the Adasum example's ``main`` (``examples/adasum_gpt2.py``, the
   JAX example's flags at 24 x 1024, vocab 50257, seq 1024, batch 8,
   ``--flash``) at world 1 over NCCL, ``ADASUM_STEPS`` steps: a falling
   loss, B1-B3 exactly 24 a step by the launch counts and by kernel name
   in a profiled step, and the parameters bitwise those of the same
   steps under a plain ``torch.optim.Adam`` (Adasum at world 1 is the
   identity), step ms and tokens/s; (b) a world of four emulated on the
   card, 2 x 1024 a rank, each rank its own model and Adam, 3 steps:
   every bucket of the optimizer's plan through ``emulated_adasum``, the
   ranks' reduced buckets and parameters bitwise equal, each bucket
   within ``ADASUM_REL_TOL`` of a float64 Adasum tree on every rank and
   step and each of ``ADASUM_FAULTS`` beyond it, the anchors (adasum(a,
   a) = a, disjoint supports sum) bitwise at the plan's bucket sizes,
   the combine's device ms a rank a step beside its bytes bound; (c)
   process sets, alltoall (equal and split), grouped allgather, masked
   allreduce, join, allgather_object and a sparse allreduce of an
   ``nn.Embedding(50257, 1024, sparse=True)`` gradient over NCCL at
   world 1;
4h. train GPT-2 medium over the two-level wire (``ops/hierarchical.py``)
   in a world of four emulated on the card as two domains of two
   (``HOROVOD_HIERARCHICAL_LOCAL_SIZE=2``), 2 x 1024 a rank, 3 steps: (a)
   float32 inner legs and the int8 outer leg with error feedback (block
   256) on every bucket of the plan, each rank stepping its own AdamW:
   buckets, residuals and parameters bitwise the plain versions'
   composition, the ranks bitwise equal, B12 and B13 exactly 12 a step a
   rank and B11, B14 none (without residuals B11 12, B12 none), each of
   ``HIER_FAULTS`` (the outer gather in reversed peer order, the shard
   residual stashed one shard late, a rank dropped from the inner
   reduce-scatter) caught, a falling loss; beside it phase 4b's flat
   int8 wire on the same gradients, each wire's relative L2 to the
   float32 mean, each leg's bytes a rank a step and one rank's outer-leg
   kernels' device ms; (b) the float32 and bf16 wires through the same
   composition within ``HIER_WIRE_TOL`` of the exact sum; (c) the knobs
   at world 1 over NCCL: the flat route, the collectives' inputs back
   bitwise and phase 4's losses bitwise;
4i. train Llama-2 at its width (hidden 4096, 32 heads of 128, MLP 11008,
   vocab 32000, untied head; depth cut to 12) and context (seq 4096,
   batch 2) through the port of ``examples/llama_adasum.py`` with
   ``--flash --remat`` at world 1 over NCCL, 4 steps: a falling loss,
   B1 24 and B2, B3 12 a step by the launch counts and by kernel name in
   a profiled fifth step of the example's own, the parameters after 4
   steps bitwise a plain ``torch.optim.Adam`` twin's; step ms, tokens/s,
   MFU, peak memory, the profiled step's device time by group;
4j. checkpoint GPT-2 medium at world 1 (phase 4's model, batch 8 x 1024,
   AdamW): 2 steps, ``save_model`` with AdamW's state, ``load_model``
   into a fresh model and optimizer, 2 more steps, bitwise 4
   uninterrupted steps; the same through ``save_fsdp``/``load_fsdp``
   with the FullyShardedOptimizer; bytes written, save and load
   seconds;
4k. train through the port of ``examples/gpt2_elastic.py`` at GPT-2
   medium's width (24 x 1024, 16 heads of 64, vocab 50257, batch 8 x
   1024, ``--flash``, 30 steps, a commit every 10) at world 1 over NCCL:
   (a) in process, a falling loss, B1-B3 exactly 24 a step, step ms,
   tokens/s and each commit's seconds, and ``device_prefetch`` of four
   token batches to the card; (b) under the elastic launcher
   (``--min-np 1 --max-np 1 --host-discovery-script``,
   ``--emergency-checkpoint``), the worker sent SIGTERM after its first
   commit: it exits 83, the host is not blacklisted, and the second
   round recovers from the emergency rung; (c) with
   ``HOROVOD_TPU_FAULT_SPEC=worker:kill:rank=0:step=2`` and two hosts
   (localhost, 127.0.0.1) discovered: the first round dies, localhost
   is blacklisted, the second round runs on 127.0.0.1 from step 0; in
   (b) and (c) every parameter and Adam moment ends bitwise (a)'s (by
   sha256); the emergency write's seconds and bytes, the seconds from
   the exit to the next round's first step, each job's seconds;
4l. carry GPT-2 medium's gradient buckets through the eager negotiation
   runtime (``HVD_TPU_NATIVE=1``: the C++ controller, the plan cache,
   the ``DistExecutor`` on a process group of its own) at world 1 over
   NCCL (24 x 1024, batch 8 x 1024, ``--flash --fused-norm``, AdamW):
   (a) 10 steps whose 12 buckets go through
   ``hvd.grouped_allreduce_async(op=Average)``, every parameter and loss
   bitwise the same steps without the runtime, the plan frozen after
   the warmup and the later steps negotiating 0 bytes, step ms beside
   the steps without it, the controller's cycles and the executor's
   host seconds; (b) the same on the int8 + error-feedback wire (block
   256): each fused batch's sum and residual bitwise the plain
   composition of B11-B14 on the same buffer, B11-B14 exactly once a
   fused batch a step, a falling loss, one step profiled; (c) a bucket
   written behind a spin kernel on the producer's stream arrives
   through the ready event, and with that wait monkeypatched out it
   must not; (d) in a process of its own, an executor that blocks makes
   the watchdog raise "stalled" within its limit plus 1.5 s, and the
   world then shuts down; (e) phase 4e's launched GPT-2 medium with
   ``HVD_TPU_NATIVE=1 --cycle-time-ms 2 --cache-capacity 256
   --stall-abort-seconds 120``: the runtime's line with those knobs and
   the published port, the ``[0]iter 0`` loss as phase 4e prints it,
   and through ``runner.run`` the published port and the knobs in the
   worker's runtime, its broadcasts through the runtime, and the loss
   bitwise phase 4's step 1;
5. train ResNet-50 (224 px, 1000 classes) through the example's
   ``main`` with ``--fused-bn`` (world of one over NCCL, batch 128, 1
   warm-up + 5 timed steps on one batch), after checking the step-1
   loss and gradients of the fused-BN path against the plain-BN path
   on the same weights (``RESNET_GRAD_TOL``); the loss must fall, each
   BatchNorm kernel must launch 53 times a step; one step is profiled,
   and there too each of B7-B10 must run 53 times and no column-sum
   kernel;
5b. train Inception V3 (299 px, batch 256) and VGG-16 (224 px, batch
   128), bench.py's batches, through the same example's ``main``
   (``--model``), 1 warm-up + 3 timed steps each: finite, falling
   losses, images/s, MFU, peak memory, one profiled step each;
5c. train MNIST for one epoch through its example's ``main`` (a falling
   loss, the test accuracy), then call ``entry()`` once: its loss finite
   and equal to ``causal_lm_loss`` of the same model;
6. serve GPT-2 small at full width (random weights from the seed,
   ``fused_norm=True``, bf16 KV cache, 8 slots x 1024) under the
   continuous-batching scheduler: 16 requests of 32..700 prompt tokens,
   32 new tokens each; 4 of them again one at a time must give the
   same tokens; a profiled window of 8 full-batch decode steps shows
   where a step's time goes; B16's launches must split by route as
   the engine's calls say (prefills of 16 rows or more on the prefill
   route, decode steps on the decode route); the first-token logits
   must agree with the plain (unfused, cache-free) forward of the same
   weights;
7. a short serve on an int8 KV cache (4 requests), whose decode steps
   must run B17 on the decode route, and the same decode-step profile;
8. print the ``{"kernels": [...]}`` line: each kernel's launches on the
   training runs of phases 4, 4b, 4c, 4d, 4e (the launched worker's
   step), 4f (the FSDP runs, not their references), 4g ((a) and (b)), 4h
   ((a)'s kernel composition), 4i, 4j, 4k (in process and the
   launched workers' second rounds), 4l ((a), (b) and (e)'s ``run()``
   worker), 5 and 5b and the
   serving runs of phases 6 and 7 (counts zeroed
   just before each run and read just after), error, tolerance and
   times;
9. print ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM: HBM bandwidth and dense peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}


class SmokeFailure(RuntimeError):
    pass


def _require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _bound(nbytes, ops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(fn, iters=50, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _kernel_events(prof):
    """The device events of a ``_profiled`` window, averaged, without
    the GPU-side copies of user annotations (e.g. ``Optimizer.step``),
    whose time overlaps the kernels they enclose, and without the spin
    kernels that open the window. The profiler loses a window's first
    device records, the more of them the older the process: a window
    that lost every spin may have lost the work's first records too,
    and fails."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    spins = sum(e.count for e in events if SPIN_KERNEL in e.key)
    lost = PROFILE_WARMUP_SPINS - spins
    PROFILER_TALLY["spins_lost_max"] = max(
        PROFILER_TALLY["spins_lost_max"], lost)
    _require(spins > 0, f"a profiler window lost all its "
                        f"{PROFILE_WARMUP_SPINS} leading spin kernels, "
                        "and maybe the first records of its work")
    return [e for e in events if SPIN_KERNEL not in e.key]


#: bytes written before each call of an L2-cold reading (``_device_ms``
#: with ``cold=True``): more than the H100's 50 MB L2. The fill's kernel
#: (``FLUSH_KERNEL`` in its name) is left out of the reading
FLUSH_BYTES = 128 << 20
FLUSH_KERNEL = "FillFunctor"

#: seconds a profiler window (``_profiled``) stays open on the host
#: before the profiled work and after the card has finished it. The
#: profiler keeps only the device events that fall inside its window on
#: the host's clock, and the card's timestamps, carried over to that
#: clock, can fall past its end: a window of tiny kernels, closed right
#: after its last one, lost some of its events or all of them
PROFILER_PAD_S = 0.02

#: spin kernels (``torch.cuda._sleep``: ATen's ``spin_kernel``) that
#: every profiler window (``_profiled``) runs before the profiled work,
#: and that ``_kernel_events`` counts and leaves out. The profiler loses
#: the first device records of a window, about one more every 16 s of the
#: process's life in ``--profiler-probe`` (a process that does nothing
#: else): a count, not a time, since a longer spin or a host pad of
#: 0.1 s before the work kept nothing more. Late in a smoke a window
#: lost a ResNet-50 step's first 3-17 records, the stem's B7 and B8
#: among them. The spins take those losses; a short spin is enough
PROFILE_WARMUP_SPINS = 128
PROFILE_WARMUP_CYCLES = 1000
SPIN_KERNEL = "spin_kernel"

#: ``_device_ms``'s tally over the run: profiler windows read, windows
#: refused (no device time, or a count of kernel calls that is not a
#: whole number a call: events dropped), and readings that fell back to
#: ``_held_ms`` after ``DEVICE_MS_WINDOWS`` refused windows; the first
#: 20 refused windows' counts, with the kernels whose calls were not a
#: whole number a call; and the most leading spins any window lost
#: (``_kernel_events``)
PROFILER_TALLY = {"windows": 0, "refused": 0, "held_event_readings": 0,
                  "refusals": [], "spins_lost_max": 0}
DEVICE_MS_WINDOWS = 3


@contextlib.contextmanager
def _profiled(*activities):
    """A ``torch.profiler`` window (CUDA activity unless ``activities``
    are given) over the block, open ``PROFILER_PAD_S`` before it and
    after the card has finished its work; ``PROFILE_WARMUP_SPINS`` spin
    kernels run, and finish, between the first pad and the block."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=list(activities)
                 or [ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        for _ in range(PROFILE_WARMUP_SPINS):
            torch.cuda._sleep(PROFILE_WARMUP_CYCLES)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILER_PAD_S)


def _held_run_ms(fn, calls, cycles):
    """CUDA-event ms of ``fn(i)`` for each i in ``calls``, enqueued
    while a spin kernel of ``cycles`` (``torch.cuda._sleep``) holds the
    stream; None if the spin ended before the host had enqueued them."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    start.record()
    for i in calls:
        fn(i)
    end.record()
    held = not start.query()
    end.synchronize()
    return start.elapsed_time(end) if held else None


def _held_ms(fn, iters=50):
    """Device time of one call of ``fn`` by CUDA events, with the stream
    held by a spin kernel until the host has enqueued the calls: the
    events then time the card's run of them, the gaps between their
    kernels included, and not the host's enqueue. All ``iters`` calls
    behind one spin of up to 1 << 28 cycles (about 135 ms at 1.98 GHz);
    failing that (the stream's queue holds about a thousand launches and
    blocks the host beyond them), each call behind a spin of its own."""
    for shift in (22, 24, 26, 28):
        ms = _held_run_ms(fn, range(iters), 1 << shift)
        if ms is not None:
            return ms / iters
    total = 0.0
    for i in range(iters):
        for shift in (22, 24, 26, 28, 30):
            ms = _held_run_ms(fn, (i,), 1 << shift)
            if ms is not None:
                break
        _require(ms is not None, "a spin of 1 << 30 cycles did not outlast "
                                 "the host's enqueue of one call")
        total += ms
    return total / iters


def _device_ms(fn, iters=50, cold=False):
    """Device time of one call of ``fn``: the summed device time of the
    kernels it launches, from ``torch.profiler`` over ``iters`` calls.
    For a call shorter than its host-side launch, where back-to-back
    CUDA-event timing measures the enqueue and not the card. A window
    without device time, or whose kernel calls are not a whole number a
    call (the profiler dropped events), is refused and profiled again;
    after ``DEVICE_MS_WINDOWS`` refused windows the reading is
    ``_held_ms``'s (``PROFILER_TALLY`` counts both). With ``cold``, each
    call follows a fill of ``FLUSH_BYTES``, whose kernel the sum leaves
    out by its name: the call finds its inputs in HBM, not in L2."""
    flush = (torch.empty(FLUSH_BYTES // 4, device="cuda") if cold
             else None)

    def call(i=0):
        if flush is not None:
            flush.fill_(float(i))
        fn(i)

    call()
    torch.cuda.synchronize()
    for _ in range(DEVICE_MS_WINDOWS):
        with _profiled() as prof:
            for i in range(iters):
                call(i)
        PROFILER_TALLY["windows"] += 1
        events = _kernel_events(prof)
        fills = sum(e.count for e in events if FLUSH_KERNEL in e.key)
        _require(flush is None or not events or fills,
                 f"no kernel named *{FLUSH_KERNEL}* among "
                 f"{[e.key[:60] for e in events]}: the L2 flush cannot be "
                 "left out of the reading")
        mine = [e for e in events
                if flush is None or FLUSH_KERNEL not in e.key]
        us = sum(_dev_us(e) for e in mine)
        calls = sum(e.count for e in mine)
        if us > 0 and calls % iters == 0 and fills % iters == 0:
            return us / 1e3 / iters
        PROFILER_TALLY["refused"] += 1
        if len(PROFILER_TALLY["refusals"]) < 20:
            PROFILER_TALLY["refusals"].append({
                "iters": iters, "device_us": us, "calls": calls,
                "fills": fills, "kernels": {
                    e.key[:60]: e.count for e in mine
                    if e.count % iters}})
    PROFILER_TALLY["held_event_readings"] += 1
    if flush is None:
        return _held_ms(fn, iters)
    return max(_held_ms(call, iters)
               - _held_ms(lambda i=0: flush.fill_(float(i)), iters), 0.0)


def _bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits), exact:
    x = m * 2^e with m in [0.5, 1) has ulp 2^(e - 8)."""
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       (e - 8).float())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

#: B4's cases: (rows, C, kind, dtype, element offset of the rows' view,
#: route, timed). The main path's shapes first (the kernel line's row is
#: the first): GPT-2 small's served decode rows [8, 768] and prefill rows
#: [512, 768], GPT-2 medium's and BERT-Large's training rows [8192,
#: 1024]; then each route of csrc/layernorm_fwd.cu: float32 rows, a
#: ragged last chunk (C = 1000: 125 16-byte loads a row, not a multiple
#: of 32), one-element loads (C = 1001; rows whose view starts 2 bytes
#: past 16-byte alignment), 128 columns a lane (C = 4096, one block an
#: SM, no second row buffer), and the long-row route (C > 4096, a block
#: a row; C = 8193 with one-element loads)
LN_CASES = (
    (8, 768, "layernorm", torch.bfloat16, 0, "register", True),
    (8, 768, "rmsnorm", torch.bfloat16, 0, "register", True),
    (512, 768, "layernorm", torch.bfloat16, 0, "register", True),
    (512, 768, "rmsnorm", torch.bfloat16, 0, "register", True),
    (8192, 1024, "layernorm", torch.bfloat16, 0, "register", True),
    (2048, 1024, "layernorm", torch.float32, 0, "register", False),
    (4099, 1000, "layernorm", torch.float32, 0,
     "register, ragged last chunk", False),
    (777, 1001, "layernorm", torch.bfloat16, 0,
     "register, one-element loads", False),
    (512, 768, "layernorm", torch.bfloat16, 1,
     "register, one-element loads (unaligned row view)", False),
    (300, 4096, "layernorm", torch.bfloat16, 0,
     "register, 128 columns a lane", True),
    (300, 4096, "rmsnorm", torch.float32, 0,
     "register, 128 columns a lane", False),
    (64, 8192, "layernorm", torch.bfloat16, 0, "long row", True),
    (33, 8193, "rmsnorm", torch.float32, 0, "long row, one-element loads",
     False),
)


#: B4's per-element limit on float32 rows: relative to the larger value,
#: plus slack for outputs near 0, where beta cancels the rest and the
#: sum order moves the result by ~1e-7. A route that rounded its output
#: or its statistics through bf16 reads hundreds of times this
LN_F32_RTOL, LN_F32_ATOL = 1e-5, 1e-6


def _ln_tol(dtype):
    return ("1 bf16 ulp of the larger value + 1e-5"
            if dtype != torch.float32
            else f"{LN_F32_RTOL:g} x the larger value + {LN_F32_ATOL:g}")


def _ln_reading(got, want, dtype):
    """Per element, |got - want| over the limit (``_ln_tol``): for bf16
    outputs one bf16 ulp of the larger of the two values, plus float32
    slack for outputs near 0, where beta cancels the rest and the sum
    order moves the result by ~1e-6; for float32 outputs
    ``LN_F32_RTOL`` of the larger value plus ``LN_F32_ATOL``. A reading
    of at most 1 passes; returned per row's maximum."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs())
    if dtype == torch.float32:
        tol = LN_F32_RTOL * big + LN_F32_ATOL
    else:
        tol = _bf16_ulp(big) + 1e-5
    return ((g - w).abs() / tol).amax(dim=1)


def check_layernorm(seed):
    """B4 against its plain version on the card (``LN_CASES``), every
    element within its dtype's limit (``_ln_reading``: bf16 rows one
    bf16 ulp of the larger value + 1e-5, float32 rows 1e-5 of it +
    1e-6); on float32 rows the plain output rounded through bf16 must
    fail that limit. At [8192, 1024] one row of the kernel's partition
    (``ops/layernorm.py`` ``fwd_rows_of_warp``: the last warp's last
    row) left as stale memory (the row before it, as a buffer reused
    from an earlier call could hold) must fail that check. The timed
    cases time the kernel, the plain version and ``F.layer_norm`` /
    ``F.rms_norm`` (one call) with L2 hot (back to back) and, at
    [8192, 1024], L2 cold (``FLUSH_BYTES`` written before each call):
    its 33.5 MB of x and y fit in the 50 MB L2, while the bound counts
    HBM bytes."""
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import layernorm as ln

    cases = []
    g = torch.Generator(device="cuda").manual_seed(seed)
    sms = _build.sm_count(torch.device("cuda", 0))
    for rows, c, kind, dtype, offset, route, timed in LN_CASES:
        rms = kind == "rmsnorm"
        flat = (torch.randn(rows * c + offset, generator=g, device="cuda")
                * 2 + 0.5).to(dtype)
        x = flat[offset:].view(rows, c)
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device="cuda")
        beta = None if rms else 0.1 * torch.randn(c, generator=g,
                                                  device="cuda")
        got = ln.layer_norm_cuda(x, gamma, beta, 1e-5, rms)
        want = ln.layer_norm_ref(x, gamma, beta, 1e-5, rms)
        torch.cuda.synchronize()
        name = f"{rows}x{c} {str(dtype)[6:]} {kind}"
        reading = _ln_reading(got, want, dtype).max().item()
        row = {"case": name, "route": route,
               "aligned": x.data_ptr() % 16 == 0,
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "reading": reading, "tol": _ln_tol(dtype)}
        _require(bool(torch.isfinite(got).all()),
                 f"layernorm_fwd {name}: not finite")
        _require(reading <= 1,
                 f"layernorm_fwd {name} ({route}): an element is "
                 f"{reading:.2f}x its limit ({_ln_tol(dtype)}) from the "
                 "plain version")
        if dtype == torch.float32:
            rounded = _ln_reading(want.to(torch.bfloat16).float(), want,
                                  dtype).max().item()
            row.update(bf16_rounded_reading=rounded)
            _require(rounded > 1, f"layernorm_fwd {name}: the plain "
                                  "output rounded through bf16 reads "
                                  f"{rounded:.2f} <= 1 and would pass")
        if (rows, c) == (8192, 1024):
            blocks = ln.fwd_blocks(rows, c, sms)
            skipped = int(ln.fwd_rows_of_warp(
                rows, blocks, blocks * ln.FWD_WARPS - 1)[-1])
            stale = got.clone()
            stale[skipped] = got[skipped - 1]
            skip = _ln_reading(stale, want, dtype)[skipped].item()
            row.update(blocks=blocks, skipped_row=skipped,
                       skip_reading=skip)
            _require(skip > 1, f"layernorm_fwd {name}: a skipped row "
                               f"({skipped}) reads {skip:.2f} <= 1 and "
                               "would pass")
        if timed:
            e = x.element_size()
            lg = gamma.to(dtype)
            lb = None if beta is None else beta.to(dtype)
            if rms:
                def lib(_=0):
                    F.rms_norm(x, (c,), lg, 1e-5)
            else:
                def lib(_=0):
                    F.layer_norm(x, (c,), lg, lb, 1e-5)

            def kernel(_=0):
                ln.layer_norm_cuda(x, gamma, beta, 1e-5, rms)

            def plain(_=0):
                ln.layer_norm_ref(x, gamma, beta, 1e-5, rms)
            nbytes = 2 * rows * c * e + c * 4 * (1 if rms else 2)
            bound, by = _bound(nbytes, rows * c * 8, "f32")
            # a call this short is shorter than its launch: times are the
            # card's (profiler), the host's enqueue is kept beside them
            row.update(ms=_device_ms(kernel), plain_ms=_device_ms(plain),
                       library_ms=_device_ms(lib),
                       enqueue_ms=_time_ms(kernel), bound_ms=bound,
                       bound_by=by)
            if (rows, c) == (8192, 1024):
                row.update(cold_ms=_device_ms(kernel, iters=20, cold=True),
                           cold_library_ms=_device_ms(lib, iters=20,
                                                      cold=True))
        print(json.dumps({"layernorm_fwd_case": row}))
        cases.append(row)
        del flat, x, got, want
    return cases


def _rel_err(got, want):
    """(max |got - want|, that over max |want|), both as floats."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def check_layernorm_bwd(seed):
    """B5 at the training path's rows (GPT-2 medium's 8 x 1024 tokens of
    1024 channels, bf16, LayerNorm with beta and RMSNorm), and on ragged
    cases: float32 with C = 1000 and bf16 with C = 1001 (no 16-byte
    chunks: the one-element loads). dx is held row by row to
    ``FLASH_TOL`` of its dtype, dgamma and dbeta per column to
    ``BN_RTOL`` of the sum of their terms' magnitudes (the plain
    version's xhat); on the main cases a column sum that leaves out one
    block of the kernel's partition (``ops/layernorm.py``
    ``bwd_block_of_rows``) must fail that check."""
    from horovod_tpu_torch.ops import layernorm as ln

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    for rows, c, kind, dtype, timed in (
            (8192, 1024, "layernorm", torch.bfloat16, True),
            (8192, 1024, "rmsnorm", torch.bfloat16, True),
            (4099, 1000, "layernorm", torch.float32, False),
            (777, 1001, "layernorm", torch.bfloat16, False)):
        rms = kind == "rmsnorm"
        rtol, atol = FLASH_TOL[dtype]
        x = (torch.randn(rows, c, generator=g, device="cuda") * 2 + 0.5).to(
            dtype)
        dy = torch.randn(rows, c, generator=g, device="cuda").to(dtype)
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device="cuda")
        got = ln.layer_norm_bwd_cuda(x, dy, gamma, 1e-5, rms, not rms)
        want = ln.layer_norm_bwd_ref(x, dy, gamma, 1e-5, rms, not rms)
        torch.cuda.synchronize()
        name = f"{rows}x{c} {str(dtype)[6:]} {kind}"
        for a, what in zip(got, ("dx", "dgamma", "dbeta")):
            _require(a is None or bool(torch.isfinite(a).all()),
                     f"layernorm_bwd {name}: {what} not finite")
        dx_share = _row_share(got[0], want[0], rtol, atol).max().item()
        xf, dyf = x.float(), dy.float()
        mean, rstd = ln._stats(xf, c, 1e-5, rms)
        terms = {"dgamma": dyf * ((xf - mean) * rstd), "dbeta": dyf}
        reads, skips = {}, {}
        blocks = ln.bwd_blocks(rows, sms)
        block_of = ln.bwd_block_of_rows(rows, blocks).cuda()
        for i, what in ((1, "dgamma"), (2, "dbeta")):
            if want[i] is None:
                continue
            absum = terms[what].abs().sum(0)
            reads[what] = _bn_reading(got[i], want[i], absum)
            if timed:
                skips[what] = _block_skip_reading(terms[what], absum,
                                                  block_of)
        row = {"case": name, "blocks": blocks,
               "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                  for a, b in zip(got, want)
                                  if b is not None),
               "dx_row_share_max": dx_share, "column_reading": reads,
               "tol": f"dx per row: ||err|| <= {rtol} ||plain|| + {atol}; "
                      f"dgamma, dbeta per column <= {BN_RTOL} x sum |terms|"}
        if skips:
            row["skip_reading"] = skips
        print(json.dumps({"layernorm_bwd_case": row}))
        _require(dx_share <= 1, f"layernorm_bwd {name}: a dx row is "
                                f"{dx_share:.2f}x its tolerance")
        for what, r in reads.items():
            _require(r <= BN_RTOL, f"layernorm_bwd {name}: {what} reads "
                                   f"{r:.2e} of its terms' magnitude > "
                                   f"{BN_RTOL}")
        for what, r in skips.items():
            _require(r > BN_RTOL, f"layernorm_bwd {name}: a {what} that "
                                  f"leaves out one block reads {r:.2e} <= "
                                  f"{BN_RTOL} and would pass")
        if timed:
            xl = x.detach().requires_grad_()
            gb = gamma.to(dtype).requires_grad_()
            bb = None if rms else torch.zeros(c, device="cuda", dtype=dtype,
                                              requires_grad=True)
            y = (F.rms_norm(xl, (c,), gb, 1e-5) if rms
                 else F.layer_norm(xl, (c,), gb, bb, 1e-5))
            wrt = (xl, gb) if rms else (xl, gb, bb)

            def lib(_=0):
                torch.autograd.grad(y, wrt, dy, retain_graph=True)

            def kernel(_=0):
                ln.layer_norm_bwd_cuda(x, dy, gamma, 1e-5, rms, not rms)

            def plain(_=0):
                ln.layer_norm_bwd_ref(x, dy, gamma, 1e-5, rms, not rms)
            nbytes = 3 * rows * c * 2 + c * 4 * (2 if rms else 3)
            bound, by = _bound(nbytes, rows * c * 20, "f32")
            row.update(ms=_device_ms(kernel),
                       plain_ms=_device_ms(plain, iters=10),
                       library_ms=_device_ms(lib), enqueue_ms=_time_ms(kernel),
                       bound_ms=bound, bound_by=by)
        cases.append(row)
    return cases


def _flash_pairs(tq, tk, causal, q_off, k_off):
    """Visible (query, key) pairs: the products the kernels must do."""
    if not causal:
        return tq * tk
    last = q_off + np.arange(tq, dtype=np.int64) - k_off  # last key seen
    return int(np.clip(last + 1, 0, tk).sum())


#: per-row tolerance of the flash kernels: the L2 norm of a row's error
#: (one query's O or dQ, one key's dK or dV, over head_dim) within
#: rtol x the plain row's norm + atol. atol covers dQ rows that are 0
#: in exact arithmetic (a query seeing one key: dP - delta cancels) and
#: come out as float32 rounding noise of ~2e-6 on both sides
FLASH_TOL = {torch.bfloat16: (1.5e-2, 1e-5), torch.float32: (1e-4, 1e-5)}
#: the per-row tolerance of the Llama-2 case ([2, 32, 4096, 128] bf16
#: causal), (rtol, atol). atol is twice FLASH_TOL's: the float32 noise
#: on the dQ rows that are 0 in exact arithmetic grows with the length
#: of the dot products behind dP - delta, so with head_dim; at 128 the
#: worst such row (query 0 of a head, plain norm 4.1e-6) read an error
#: of 1.23e-5 against FLASH_TOL's 1e-5 (NVIDIA H100 80GB HBM3, 700 W;
#: PERF.md). rtol is below FLASH_TOL's 1.5e-2 so that the one-tile skips
#: fail at this shape too: a skip of the last Q/dO tile in the first
#: block of keys, whose gradient the 4,000 earlier queries set, reads
#: 1.37e-2 to 1.54e-2 of a dK/dV row's norm at T = 4096, where every
#: row the relative term sets read at most 5.5e-3
LLAMA_FLASH_TOL = (1e-2, 2e-5)


def _row_share(got, want, rtol, atol):
    """Each row's error as a share of its tolerance, over the last axis:
    ``||got - want|| / (rtol ||want|| + atol)``; a row passes at <= 1."""
    err = (got.float() - want.float()).norm(dim=-1)
    return err / (rtol * want.float().norm(dim=-1) + atol)


def _row_rel(got, want, rtol, atol):
    """Largest per-row relative L2 error over the rows whose tolerance
    the relative term sets (``rtol ||want|| > atol``); 0 if none."""
    w = want.float().norm(dim=-1)
    err = (got.float() - want.float()).norm(dim=-1)
    big = rtol * w > atol
    return (err[big] / w[big]).max().item() if bool(big.any()) else 0.0


def _tile_skip_shares(fa, q, k, v, dout, lse, delta, got, want, args,
                      rtol, atol):
    """What the per-row check reads on kernels whose blocks each skip
    one streamed tile, the least visible one, at the bf16 kernels' own
    tiling (``ops/flash_attention.py``): the last block of query rows
    skipping the first K/V tile (forward, dQ), and the first block of
    keys skipping the last Q/dO tile (dK, dV), whose part of an early
    key's gradient is the smallest. The skipped tile's part comes from
    the plain version on the slices. Each reading is the least, over
    the (b, h) blocks, of the block's largest row share: above 1, a
    skip in any one block fails the check."""
    causal, scale, q_off, k_off = args
    t, d = q.shape[2], q.shape[3]

    def last_start(rows):
        return (t - 1) // rows * rows

    # bf16: B1, B2 and B3 on the tensor cores
    r0, kt = last_start(fa.FWD_Q_ROWS), fa.FWD_KV_TILE
    o_skip, _ = fa.flash_attention_ref(q[:, :, r0:], k[:, :, kt:],
                                       v[:, :, kt:], causal, scale,
                                       q_off + r0, k_off + kt)
    rq, kq = last_start(fa.DQ_Q_ROWS), fa.dq_kv_tile(d)
    dq_part = fa.flash_bwd_ref(q[:, :, rq:], k[:, :, :kq], v[:, :, :kq],
                               dout[:, :, rq:], lse[:, :, rq:],
                               delta[:, :, rq:], causal, scale, q_off + rq,
                               k_off)[0]
    kr, q0 = fa.DKV_K_ROWS, last_start(fa.dkv_q_tile(d))
    _, dk_part, dv_part = fa.flash_bwd_ref(
        q[:, :, q0:], k[:, :, :kr], v[:, :, :kr], dout[:, :, q0:],
        lse[:, :, q0:], delta[:, :, q0:], causal, scale, q_off + q0, k_off)
    rows = {"o": (o_skip, slice(r0, None)),
            "dq": (got["dq"][:, :, rq:].float() - dq_part.float(),
                   slice(rq, None)),
            "dk": (got["dk"][:, :, :kr].float() - dk_part.float(),
                   slice(0, kr)),
            "dv": (got["dv"][:, :, :kr].float() - dv_part.float(),
                   slice(0, kr))}
    return {what: _row_share(skip, want[what][:, :, sl], rtol,
                             atol).amax(-1).min().item()
            for what, (skip, sl) in rows.items()}


def check_flash(seed):
    """B1, B2, B3 at GPT-2 medium's attention ([8, 16, 1024, 64] bf16,
    causal), plus a non-causal, a padded-T and an offset case at batch
    2, BERT-Large's non-causal shape, every other head_dim in bf16 (one
    case with rows that see no key), float32 twice, and Llama-2's
    attention ([2, 32, 4096, 128] bf16 causal: timed, with the tile
    skips, and the head_dim-128 instantiations' ptxas lines). Every
    case feeds
    the kernel and the plain version the same inputs (the backward gets
    the plain forward's lse and delta). Each row is held to
    ``FLASH_TOL`` (the Llama-2 case to ``LLAMA_FLASH_TOL``); in the two
    timed cases, kernels that skip one tile must fail that check, and
    the kernels and SDPA are timed."""
    from horovod_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    out = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}

    def case(name, b, h, tq, tk, causal, q_off=0, k_off=0, timed=False,
             d=64, dtype=torch.bfloat16, tol=None):
        rtol, atol = tol or FLASH_TOL[dtype]

        def mk(t):
            return torch.randn(b, h, t, d, generator=g, device="cuda").to(
                dtype)
        q, k, v, dout = mk(tq), mk(tk), mk(tk), mk(tq)
        args = (causal, d ** -0.5, q_off, k_off)
        o, lse = fa.flash_fwd_cuda(q, k, v, *args)
        o_r, lse_r = fa.flash_attention_ref(q, k, v, *args)
        delta = torch.sum(dout.float() * o_r.float(), dim=-1)
        dq = fa.flash_bwd_dq_cuda(q, k, v, dout, lse_r, delta, *args)
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, dout, lse_r, delta, *args)
        dq_r, dk_r, dv_r = fa.flash_bwd_ref(q, k, v, dout, lse_r, delta,
                                            *args)
        torch.cuda.synchronize()
        got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
        want = {"o": o_r, "dq": dq_r, "dk": dk_r, "dv": dv_r}
        errs, shares, rels, worst = {}, {}, {}, {}
        for what in got:
            _require(bool(torch.isfinite(got[what]).all()),
                     f"flash {name}: {what} not finite")
            errs[what] = _rel_err(got[what], want[what])[0]
            row_shares = _row_share(got[what], want[what], rtol,
                                    atol).reshape(-1)
            i = int(row_shares.argmax())
            shares[what] = row_shares[i].item()
            rels[what] = _row_rel(got[what], want[what], rtol, atol)
            w = want[what].float().reshape(-1, d)[i]
            worst[what] = {"row": i % want[what].shape[2],
                           "plain_norm": w.norm().item(),
                           "err_norm": (got[what].float().reshape(-1, d)[i]
                                        - w).norm().item()}
        lse_err = (lse - lse_r).abs().max().item()
        skips = (_tile_skip_shares(fa, q, k, v, dout, lse_r, delta, got,
                                   want, args, rtol, atol)
                 if timed else None)
        print(json.dumps({"flash_case": name, "row_share_max": shares,
                          "row_rel_l2_max": rels, "lse_err": lse_err,
                          "worst_row": worst,
                          "tile_skip_share_min": skips}))
        for what, share in shares.items():
            _require(share <= 1, f"flash {name}: a row of {what} is "
                                 f"{share:.2f}x its tolerance from the "
                                 "plain version (largest relative L2 "
                                 f"{rels[what]:.2e})")
        _require(lse_err <= 1e-3, f"flash {name}: lse max err {lse_err}")
        for what, share in (skips or {}).items():
            _require(share > 1, f"flash {name}: a kernel skipping one tile "
                                f"of {what} reads {share:.2f}x the "
                                "tolerance and would pass")
        tol = f"per row: ||err|| <= {rtol} ||plain|| + {atol}"
        rows = {"flash_fwd": ("o",), "flash_bwd_dq": ("dq",),
                "flash_bwd_dkv": ("dk", "dv")}
        for kname, whats in rows.items():
            row = {"case": name, "tol": tol,
                   "max_abs_err": max(errs[w] for w in whats),
                   "row_rel_l2_max": max(rels[w] for w in whats),
                   "row_share_max": max(shares[w] for w in whats)}
            if kname == "flash_fwd":
                row["lse_err"] = lse_err
            if skips:
                row["tile_skip_share_min"] = min(skips[w] for w in whats)
            out[kname].append(row)
        if not timed:
            return
        bh, te = b * h, 2  # bf16 bytes
        pairs = _flash_pairs(tq, tk, causal, q_off, k_off) * bh
        rd = bh * tq * 4  # one float32 per query row
        work = {"flash_fwd": (bh * d * te * (2 * tq + 2 * tk) + rd,
                              4 * d * pairs),
                "flash_bwd_dq": (bh * d * te * (3 * tq + 2 * tk) + 2 * rd,
                                 6 * d * pairs),
                "flash_bwd_dkv": (bh * d * te * (2 * tq + 4 * tk) + 2 * rd,
                                  8 * d * pairs)}
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg,
                                                 is_causal=causal)
        def sdpa_fwd(_=0):
            F.scaled_dot_product_attention(q, k, v, is_causal=causal)

        def sdpa_bwd(_=0):
            torch.autograd.grad(lib_out, (qg, kg, vg), dout,
                                retain_graph=True)
        lib_fwd, lib_bwd = _time_ms(sdpa_fwd), _time_ms(sdpa_bwd)
        # near 0.1 ms a kernel is close to its wrapper's enqueue time:
        # the profiler's device time stands beside the event timings
        lib_dev = {"flash_fwd": _device_ms(sdpa_fwd, iters=10),
                   "bwd": _device_ms(sdpa_bwd, iters=10)}
        timings = {
            "flash_fwd": (lambda _=0: fa.flash_fwd_cuda(q, k, v, *args),
                          lambda _=0: fa.flash_attention_ref(q, k, v, *args),
                          lib_fwd),
            "flash_bwd_dq": (lambda _=0: fa.flash_bwd_dq_cuda(
                q, k, v, dout, lse_r, delta, *args), None, lib_bwd),
            "flash_bwd_dkv": (lambda _=0: fa.flash_bwd_dkv_cuda(
                q, k, v, dout, lse_r, delta, *args), None, lib_bwd),
        }
        # the plain backward computes dq, dk and dv together: its time
        # stands beside both backward kernels
        plain_bwd = _time_ms(lambda _=0: fa.flash_bwd_ref(
            q, k, v, dout, lse_r, delta, *args), iters=3, warmup=1)
        for kname, (kern, plain, lib_ms) in timings.items():
            bound, by = _bound(*work[kname], "bf16")
            out[kname][-1].update(
                ms=_time_ms(kern, iters=10, warmup=2),
                device_ms=_device_ms(kern, iters=10),
                plain_ms=(_time_ms(plain, iters=3, warmup=1) if plain
                          else plain_bwd),
                library_ms=lib_ms,
                library_device_ms=lib_dev.get(kname, lib_dev["bwd"]),
                bound_ms=bound, bound_by=by)

    case("B=8 H=16 T=1024 D=64 bf16 causal", 8, 16, 1024, 1024, True,
         timed=True)
    case("B=2 H=16 T=1024 D=64 bf16 non-causal", 2, 16, 1024, 1024, False)
    case("B=8 H=16 T=512 D=64 bf16 non-causal (BERT-Large)", 8, 16, 512,
         512, False)
    case("B=2 H=16 T=1000 D=64 bf16 causal (T not a tile multiple)", 2, 16,
         1000, 1000, True)
    case("B=2 H=16 Tq=200 Tk=1000 D=64 bf16 causal, query_offset=700", 2,
         16, 200, 1000, True, q_off=700)
    # the other head_dim instantiations and float32, once each
    case("B=1 H=4 T=300 D=128 bf16 causal", 1, 4, 300, 300, True, d=128)
    case("B=1 H=4 T=333 D=32 bf16 non-causal", 1, 4, 333, 333, False, d=32)
    case("B=1 H=4 Tq=100 Tk=200 D=16 bf16 causal, key_offset=40 (40 rows "
         "see no key)", 1, 4, 100, 200, True, k_off=40, d=16)
    case("B=1 H=4 T=200 D=32 f32 non-causal", 1, 4, 200, 200, False, d=32,
         dtype=torch.float32)
    case("B=1 H=4 Tq=64 Tk=96 D=16 f32 causal, key_offset=40", 1, 4, 64, 96,
         True, k_off=40, d=16, dtype=torch.float32)
    # Llama-2's attention (phase 4i): head_dim 128 at its context
    case("B=2 H=32 T=4096 D=128 bf16 causal (Llama-2)", 2, 32, 4096, 4096,
         True, timed=True, d=128, tol=LLAMA_FLASH_TOL)
    from horovod_tpu_torch.ops import _build

    print(json.dumps({"ptxas_head_dim_128": [
        f"{src} {fn}: {line}" for src, fn, line in ptxas_lines(
            _build, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        if re.search(r"[<,]128[,>]", fn)]}))
    return out


def _attn_bytes_ops(pos, m, h, kh, d, q_bytes, row_bytes):
    """Least bytes and operations of one append+attend call: each query
    reads its valid rows; cache rows replaced by new rows need not be
    read; q, new rows and positions are read once, the output and the
    replaced rows written once."""
    b, t = pos.shape
    nbytes = b * t * h * d * q_bytes * 2          # q in, out
    nbytes += 2 * b * t * kh * d * q_bytes        # new K, V rows
    nbytes += b * t * 4                           # positions
    ops = 0
    for bi in range(b):
        p = [int(v) for v in pos[bi]]
        covered = {v for v in p if 0 <= v < m}
        valid_max = max(min(m, v + 1) if v >= 0 else m for v in p)
        kept = sum(1 for j in range(valid_max) if j not in covered)
        nbytes += 2 * kh * kept * row_bytes           # cache rows read
        nbytes += 2 * kh * len(covered) * row_bytes   # rows written
        for v in p:
            ops += 4 * d * h * (min(m, v + 1) if v >= 0 else m)
    return nbytes, ops


def _sdpa(q, k_full, v_full, valid):
    # q [B,T,H,D]; k/v [B,KH,M,D] in the compute dtype; valid [B,T,M]
    rep = q.shape[2] // k_full.shape[1]
    k = torch.repeat_interleave(k_full, rep, dim=1)
    v = torch.repeat_interleave(v_full, rep, dim=1)
    mask = valid[:, None]
    qh = q.transpose(1, 2)

    def run(_=0):
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)
    return run


def _attend_without(q, k, v, valid, drop):
    """``cached_attention`` with the rows ``drop`` ``[B, M]`` left out of
    every query's softmax, as a kernel that never reads them computes it
    (a query left with no row gets 0)."""
    d = q.shape[3]
    rep = q.shape[2] // k.shape[1]
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    logits = torch.einsum("bthd,bhmd->bhtm", q, k).float() * float(
        1.0 / np.sqrt(d))
    logits = torch.where(valid[:, None], logits, -1e30)
    logits = logits.masked_fill(drop[:, None, None], float("-inf"))
    probs = torch.nan_to_num(torch.softmax(logits, -1), 0.0).to(q.dtype)
    return torch.einsum("bhtm,bhmd->bthd", probs, v)


def _route_skip_reading(da, q, k_full, v_full, valid, want, kh, route,
                      cluster, rtol, atol):
    """What the per-row check reads on a B16 or B17 route that skips
    part of its work, the plain version computing the rest:
    ``prefill``: the block of the last query tile (``PREFILL_Q_TILE``
    rows) leaves out the last key tile (``PREFILL_KEY_TILE`` rows) it
    visits; ``decode``: in every (batch row, kv head) cluster of
    ``cluster`` CTAs (as the entry point reported it), the last CTA with
    rows leaves out its span (``decode_span``). The reading is the least, over the (batch row,
    head) blocks or (batch row, kv head) clusters, of the largest row
    share among the rows the skip touches: above 1, a skip in any one
    block or cluster fails the check."""
    b, t, h, _ = q.shape
    m = k_full.shape[2]
    pos_end = valid.sum(-1)  # [B, T]: rows each query reads
    pos_end = torch.where(pos_end == 0, m, pos_end)  # p < 0 reads all M
    j = torch.arange(m, device=q.device)
    if route == "prefill":
        q0 = (t - 1) // da.PREFILL_Q_TILE * da.PREFILL_Q_TILE
        end = pos_end[:, q0:].amax(-1)  # [B]: the block's last row + 1
        lo = (end - 1) // da.PREFILL_KEY_TILE * da.PREFILL_KEY_TILE
        drop = (j[None] >= lo[:, None]) & (j[None] < end[:, None])
        got = _attend_without(q[:, q0:], k_full, v_full, valid[:, q0:],
                              drop)
        share = _row_share(got, want[:, q0:], rtol, atol)  # [B, T', H]
        return share.amax(1).min().item()
    r = pos_end.amax(-1)  # [B]
    span = da.decode_span(r, cluster)
    lo = (r - 1) // span * span  # the last CTA with rows
    drop = (j[None] >= lo[:, None]) & (j[None] < r[:, None])
    got = _attend_without(q, k_full, v_full, valid, drop)
    share = _row_share(got, want, rtol, atol)  # [B, T, H]
    rep = h // kh
    return share.reshape(b, t, kh, rep).amax(dim=(1, 3)).min().item()


def check_append_attend(seed):
    """B16 on its two bf16 routes at the serving shapes (GPT-2 small: 12
    heads of 64, 8 slots x 1024; prefill buckets of 512 and 1024 through
    a float32 cache, and of 8, which takes the decode route), on a bf16
    and a float32 cache, and on ragged GQA cases whose repeated and
    out-of-range positions reach both routes' gather paths; a decode
    call with 288 query rows a kv group (more than a CTA's threads); and
    on the CUDA-core route: float32 compute at the decode shape, a head
    dim of 80, and a decode call whose 480 query rows a kv group the
    decode route refuses. The merged
    caches must be bitwise equal to the plain version's and each output
    row within ``FLASH_TOL``; on the main cases a route that skips its
    last key tile (prefill) or one CTA's span (decode) must fail that
    check. Timed as device time (profiler) beside CUDA events."""
    from horovod_tpu_torch.ops import decode_attention as da

    rng = np.random.RandomState(seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cases = []

    def case(name, slots, m, t, cache_dtype, pos, route, skip=False,
             timed=True, L=12, KH=12, H=12, D=64, qdtype=torch.bfloat16):
        rtol, atol = FLASH_TOL[qdtype]
        shape = (slots, L, KH, m, D)
        if cache_dtype == torch.float32 and t == m:
            k0 = torch.zeros(shape, device="cuda")       # prefill's cache
            v0 = torch.zeros(shape, device="cuda")
        else:
            k0 = torch.randn(shape, generator=g, device="cuda").to(
                cache_dtype)
            v0 = torch.randn(shape, generator=g, device="cuda").to(
                cache_dtype)
        q = torch.randn(slots, t, H, D, generator=g, device="cuda").to(
            qdtype)
        kn = torch.randn(slots, t, KH, D, generator=g, device="cuda").to(
            qdtype)
        vn = torch.randn(slots, t, KH, D, generator=g, device="cuda").to(
            qdtype)
        posd = torch.from_numpy(pos).cuda()
        kk, vk = k0.clone(), v0.clone()
        kr, vr = k0.clone(), v0.clone()
        da.reset_route_launches()
        got = da.append_attend_cuda(q, kk[:, 0], vk[:, 0], kn, vn, posd)
        routes = {r: n for r, n in da.ROUTE_LAUNCHES.items() if n}
        cluster = da.LAST_LAUNCH["cluster"]
        want = da.append_attend_ref(q, kr[:, 0], vr[:, 0], kn, vn, posd)
        torch.cuda.synchronize()
        _require(routes == {route: 1},
                 f"append_attend {name}: took route {routes}, expected "
                 f"{route}")
        _require(bool(torch.equal(kk, kr)) and bool(torch.equal(vk, vr)),
                 f"append_attend {name}: merged cache differs")
        _require(bool(torch.isfinite(got).all()),
                 f"append_attend {name}: output not finite")
        share = _row_share(got, want, rtol, atol)
        k_full, v_full, valid = da.append_rows_ref(
            k0[:, 0].clone(), v0[:, 0].clone(), kn, vn, posd, qdtype)
        skip_share = (_route_skip_reading(da, q, k_full, v_full, valid, want,
                                        KH, route, cluster, rtol, atol)
                      if skip else None)
        row = {"case": name, "route": route, "cluster": cluster,
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "row_share_max": share.max().item(),
               "row_rel_l2_max": _row_rel(got, want, rtol, atol),
               "tol": f"per row: ||err|| <= {rtol} ||plain|| + {atol}; "
                      "merged caches bitwise"}
        if skip:
            row["skip_share_min"] = skip_share
        print(json.dumps({"append_attend_case": row}))
        _require(row["row_share_max"] <= 1,
                 f"append_attend {name}: a row is {row['row_share_max']:.2f}x "
                 "its tolerance from the plain version")
        _require(skip_share is None or skip_share > 1,
                 f"append_attend {name}: the {route} route skipping part of "
                 f"its rows reads {skip_share}x the tolerance and would pass")
        if timed:
            cb = 4 if cache_dtype == torch.float32 else 2
            nbytes, ops = _attn_bytes_ops(pos, m, H, KH, D, 2, D * cb)
            bound, by = _bound(nbytes, ops, "bf16")

            # rotate over the 12 layers' slices: a decode step finds
            # each layer's slice cold in L2, as here
            def kern(i=0):
                da.append_attend_cuda(q, kk[:, i % L], vk[:, i % L], kn, vn,
                                      posd)
            lib = _sdpa(q, k_full, v_full, valid)
            row.update(
                ms=_device_ms(kern), events_ms=_time_ms(kern),
                plain_ms=_time_ms(lambda i=0: da.append_attend_ref(
                    q, kr[:, i % L], vr[:, i % L], kn, vn, posd), iters=10),
                library_ms=_device_ms(lib), library_events_ms=_time_ms(lib),
                bound_ms=bound, bound_by=by)
        cases.append(row)

    dec = rng.randint(32, 1024, size=(8, 1)).astype(np.int32)
    case("decode B=8 T=1 M=1024 bf16 cache", 8, 1024, 1, torch.bfloat16,
         dec, "decode", skip=True)
    case("decode B=8 T=1 M=1024 f32 cache (the engine's default)", 8, 1024,
         1, torch.float32, dec, "decode")
    for t in (512, 1024):
        case(f"prefill B=1 T=M={t} f32 cache", 1, t, t, torch.float32,
             np.arange(t, dtype=np.int32)[None], "prefill", skip=True)
    case("prefill bucket 8: B=1 T=M=8 f32 cache (decode route, 8 CTAs)",
         1, 8, 8, torch.float32, np.arange(8, dtype=np.int32)[None],
         "decode", timed=False)
    # ragged GQA: repeated positions, one past M and one below 0
    pre = np.stack([np.arange(10, 34), rng.randint(0, 160, 24)]).astype(
        np.int32)
    pre[0, 5] = pre[0, 4]
    pre[0, 20] = 171
    pre[1, 3] = -1
    pre[1, 7] = pre[1, 6]
    gqa = dict(timed=False, L=2, KH=2, H=8)
    for cd, cname in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        case(f"prefill ragged B=2 H=8 KH=2 M=160 T=24 {cname} cache", 2, 160,
             24, cd, pre, "prefill", skip=True, **gqa)
        case(f"decode ragged B=2 H=8 KH=2 M=160 T=3 {cname} cache", 2, 160,
             3, cd, np.array([[50, 50, 170], [-1, 7, 100]], np.int32),
             "decode", skip=True, **gqa)
    # a kv group of 32 heads: T = 9 gives 288 query rows, more than a
    # decode CTA's 256 threads; T = 15 gives 480, whose shared memory the
    # decode route refuses, so the call runs on the CUDA cores
    wide = dict(timed=False, L=1, KH=1, H=32)
    pw = np.array([[3, 3, 40, 90, 127, 128, -1, 60, 61]], np.int32)
    case("decode B=1 H=32 KH=1 M=128 T=9 bf16 cache (288 query rows)", 1,
         128, 9, torch.bfloat16, pw, "decode", skip=True, **wide)
    case("decode refused: B=1 H=32 KH=1 M=128 T=15 bf16 cache (CUDA cores)",
         1, 128, 15, torch.bfloat16,
         np.concatenate([pw, [[70, 71, 71, 100, 5, 126]]], 1), "cuda_core",
         **wide)
    # float32 compute and a head dim the bf16 routes are not built for
    case("decode B=8 T=1 M=1024 f32 compute, f32 cache (CUDA cores)", 8,
         1024, 1, torch.float32, dec, "cuda_core", timed=False,
         qdtype=torch.float32)
    case("ragged B=2 H=8 KH=2 M=160 T=24 D=80 f32 cache (CUDA cores)", 2, 160,
         24, torch.float32, pre, "cuda_core", D=80, **gqa)
    return cases


def check_append_attend_int8(seed):
    """B17 at the serving shapes (GPT-2 small: 12 heads of 64, 8 slots x
    1024, one new row a slot) for quantization blocks of 64 and 32, on
    the cluster decode route it shares with B16; a ragged GQA call whose
    repeated and out-of-range positions reach the merge of codes and
    scales; a call with 288 query rows a kv group; and on the CUDA cores:
    a call whose shared memory the route refuses and float32 compute.
    Codes and scales must be bitwise equal to the plain version's and
    each output row within ``FLASH_TOL``; on the route a cluster that
    skips one CTA's span must fail that check. Timed as device time
    (profiler) beside CUDA events, the plain version and SDPA on the
    dequantized cache."""
    from horovod_tpu_torch.ops import decode_attention as da

    rng = np.random.RandomState(seed + 2)
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    cases = []

    def case(name, slots, m, t, block, pos, route, skip=False, timed=False,
             L=12, KH=12, H=12, D=64, qdtype=torch.bfloat16):
        rtol, atol = FLASH_TOL[qdtype]
        nb = D // block
        shape = (slots, L, KH, m)
        kc0, vc0 = (torch.randint(-127, 128, shape + (D,), generator=g,
                                  device="cuda", dtype=torch.int8)
                    for _ in range(2))
        # blocks of randn rows: amax in about [1.5, 3.5]
        ks0, vs0 = ((1.5 + 2 * torch.rand(shape + (nb,), generator=g,
                                          device="cuda")) / 127
                    for _ in range(2))
        q, kn, vn = (torch.randn(slots, t, heads, D, generator=g,
                                 device="cuda").to(qdtype)
                     for heads in (H, KH, KH))
        posd = torch.from_numpy(pos).cuda()
        kern_bufs = [x.clone() for x in (kc0, ks0, vc0, vs0)]
        ref_bufs = [x.clone() for x in (kc0, ks0, vc0, vs0)]
        da.reset_route_launches()
        got = da.append_attend_int8_cuda(
            q, *(x[:, 0] for x in kern_bufs), kn, vn, posd, block)
        routes = {r: n for r, n in da.ROUTE_LAUNCHES.items() if n}
        cluster = da.LAST_LAUNCH["cluster"]
        want = da.append_attend_int8_ref(
            q, *(x[:, 0] for x in ref_bufs), kn, vn, posd, block)
        torch.cuda.synchronize()
        _require(routes == {route: 1},
                 f"append_attend_int8 {name}: took route {routes}, expected "
                 f"{route}")
        _require((cluster > 0) == (route == "decode"),
                 f"append_attend_int8 {name}: cluster {cluster} on the "
                 f"{route} route")
        for a, b, what in zip(kern_bufs, ref_bufs, ("k codes", "k scales",
                                                    "v codes", "v scales")):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            _require(bool(torch.equal(a, b)),
                     f"append_attend_int8 {name}: {what} not bitwise equal "
                     "to the plain version")
        _require(bool(torch.isfinite(got).all()),
                 f"append_attend_int8 {name}: output not finite")
        share = _row_share(got, want, rtol, atol)
        k_full, v_full, valid = da.append_rows_int8_ref(
            *(x[:, 0].clone() for x in (kc0, ks0, vc0, vs0)), kn, vn, posd,
            block, qdtype)
        skip_share = (_route_skip_reading(da, q, k_full, v_full, valid, want,
                                          KH, route, cluster, rtol, atol)
                      if skip else None)
        row = {"case": name, "route": route, "cluster": cluster,
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "row_share_max": share.max().item(),
               "row_rel_l2_max": _row_rel(got, want, rtol, atol),
               "tol": f"per row: ||err|| <= {rtol} ||plain|| + {atol}; "
                      "codes and scales bitwise"}
        if skip:
            row["skip_share_min"] = skip_share
        print(json.dumps({"append_attend_int8_case": row}))
        _require(row["row_share_max"] <= 1,
                 f"append_attend_int8 {name}: a row is "
                 f"{row['row_share_max']:.2f}x its tolerance from the plain "
                 "version")
        _require(skip_share is None or skip_share > 1,
                 f"append_attend_int8 {name}: the {route} route skipping one "
                 f"CTA's span reads {skip_share}x the tolerance and would "
                 "pass")
        if timed:
            nbytes, ops = _attn_bytes_ops(pos, m, H, KH, D, 2, D + 4 * nb)
            bound, by = _bound(nbytes, ops, "bf16")

            # rotate over the 12 layers' slices: a decode step finds
            # each layer's slice cold in L2, as here
            def kern(i=0):
                da.append_attend_int8_cuda(
                    q, *(x[:, i % L] for x in kern_bufs), kn, vn, posd,
                    block)
            lib = _sdpa(q, k_full, v_full, valid)
            row.update(
                ms=_device_ms(kern), events_ms=_time_ms(kern),
                plain_ms=_time_ms(lambda i=0: da.append_attend_int8_ref(
                    q, *(x[:, i % L] for x in ref_bufs), kn, vn, posd,
                    block), iters=10),
                library_ms=_device_ms(lib), library_events_ms=_time_ms(lib),
                bound_ms=bound, bound_by=by)
        cases.append(row)

    dec = rng.randint(32, 1024, size=(8, 1)).astype(np.int32)
    for block in (64, 32):
        case(f"decode B=8 T=1 M=1024 int8 cache block {block}", 8, 1024, 1,
             block, dec, "decode", skip=True, timed=True)
    # ragged GQA: a repeated position, one past M and one below 0
    gqa = dict(L=2, KH=2, H=8)
    rag = np.array([[50, 50, 170], [-1, 7, 100]], np.int32)
    case("decode ragged B=2 H=8 KH=2 M=160 T=3 block 32", 2, 160, 3, 32, rag,
         "decode", skip=True, **gqa)
    # a kv group of 32 heads: T = 9 gives 288 query rows, more than a
    # decode CTA's 256 threads; T = 15 gives 480, whose shared memory the
    # route refuses, so the call runs on the CUDA cores
    wide = dict(L=1, KH=1, H=32)
    pw = np.array([[3, 3, 40, 90, 127, 128, -1, 60, 61]], np.int32)
    case("decode B=1 H=32 KH=1 M=128 T=9 block 64 (288 query rows)", 1, 128,
         9, 64, pw, "decode", skip=True, **wide)
    case("decode refused: B=1 H=32 KH=1 M=128 T=15 block 64 (CUDA cores)", 1,
         128, 15, 64, np.concatenate([pw, [[70, 71, 71, 100, 5, 126]]], 1),
         "cuda_core", **wide)
    case("decode B=8 T=1 M=1024 block 64 f32 compute (CUDA cores)", 8, 1024,
         1, 64, dec, "cuda_core", qdtype=torch.float32)
    return cases


#: per-channel tolerance of the BatchNorm reductions (B7, B9): each of
#: sum(x), sum(x^2), dgamma and dbeta within BN_RTOL x the sum of its
#: terms' magnitudes of the plain version's. The kernels and the plain
#: sums differ only in the order of float32 additions; a sum that leaves
#: out one of the kernel's row blocks, or a finish that drops one
#: partial row, must fail it
BN_RTOL = 1e-5
#: (rows, channels, dtype, relu, residual, what): the path's shapes at
#: batch 128 x 224 px, the main case first, then ragged float32 cases (a
#: row count no block size divides; C = 100 and C = 96 take 16-byte
#: loads, 25 and 24 of them a row, C = 101 one-element loads, two column
#: tiles and a one-element finish), 1000 and 50 rows (B8's last tile of
#: 16 and 64 rows ragged, and 50 rows under one tile), and 100 rows,
#: which one row block of the reductions sums (its last-block finish and
#: ticket reset with nothing to wait for)
BN_CASES = (
    (401408, 256, torch.bfloat16, True, True,
     "stage-1 block output 128x56x56x256, ReLU + residual"),
    (1605632, 64, torch.bfloat16, True, False, "stem 128x112x112x64, ReLU"),
    (401408, 256, torch.bfloat16, False, False,
     "stage-1 projection 128x56x56x256, plain"),
    (6272, 2048, torch.bfloat16, True, True,
     "stage-4 block output 128x7x7x2048, ReLU + residual"),
    (10007, 100, torch.float32, True, True, "ragged f32, ReLU + residual"),
    (4099, 96, torch.float32, False, False, "ragged f32, plain"),
    (777, 101, torch.float32, True, True,
     "ragged f32 C = 101, one-element loads, ReLU + residual"),
    (1000, 256, torch.float32, True, True,
     "1000 rows, a ragged last tile of B8, ReLU + residual"),
    (50, 64, torch.float32, True, True,
     "50 rows, under one tile of B8, ReLU + residual"),
    (100, 64, torch.float32, False, False, "one row block, plain"),
)


def _bitwise(a, b):
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return a.dtype == b.dtype and bool(torch.equal(
        a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def _on_poison(call, shape, dtype):
    """``call()``'s output tensor, written over memory that held NaN: a
    NaN tensor of the output's shape is filled and freed just before,
    and the caching allocator, back in the state it was in before that
    tensor, must hand the same block to the output (required). An output
    element the kernel leaves unwritten then reads NaN, not an earlier
    call's bits."""
    poison = torch.full(shape, float("nan"), dtype=dtype, device="cuda")
    at = poison.data_ptr()
    del poison
    out = call()
    _require(out.data_ptr() == at,
             f"the output of {shape} {dtype} did not land on the poisoned "
             "block")
    return out


def _bn_reading(got, want, terms_abs):
    """Largest per-channel error as a share of the sum of the terms'
    magnitudes (a reading of at most BN_RTOL passes)."""
    return ((got - want).abs() / terms_abs.clamp_min(1e-30)).max().item()


def _block_sums(terms, block_of):
    """Each block's float32 column sums of ``terms`` ([blocks, c]),
    ``block_of`` giving each row's block."""
    return terms.new_zeros(int(block_of.max()) + 1, terms.shape[1]
                           ).index_add_(0, block_of, terms)


def _block_skip_reading(terms, terms_abs, block_of):
    """What the per-channel (per-column) check reads on a sum that
    leaves out one block of a kernel's rows, ``block_of`` giving each
    row's block: the least, over the blocks, of the block's largest
    per-channel share. Above the limit, leaving out any one block fails
    the check."""
    blocks = _block_sums(terms, block_of)
    return (blocks.abs() / terms_abs.clamp_min(1e-30)).amax(1).min().item()


def _dropped_partial_reading(terms, terms_abs, block_of, want):
    """What the per-channel check reads on a finish that drops the last
    partial row: the row blocks' partial sums (``block_of``, the
    kernel's partition) added over every row but the last, against the
    plain sums ``want``."""
    part = _block_sums(terms, block_of)
    return _bn_reading(part[:-1].sum(0), want, terms_abs)


def check_batchnorm(seed):
    """B7-B10 at the ResNet-50 path's shapes (``BN_CASES``). B8 and B10
    (dx and dres) must be bitwise equal to their plain versions; B7 and
    B9 are held per channel (``BN_RTOL``), and in every case sums that
    leave out one row block of the kernel's partition
    (``reduce_block_of_rows``), and a finish that drops one partial row,
    must fail that check. B7's constants (mean, var, rstd, s, t) must be
    bitwise the plain fold of its own sums on the card, and B7's and
    B9's outputs bitwise equal over two runs. The per-channel constants
    between the kernels come from the plain version's sums, so each
    kernel sees the same inputs as its plain version (B9 forms u and w,
    B10 its A, B and C, from them itself). B8 runs once more on a
    NaN-poisoned output buffer (``_on_poison``), bitwise too, so a grid
    that skips a row block or a tail vector fails. The bf16 cases are
    timed: the kernel, its plain version and PyTorch calls as yardsticks
    (``torch.batch_norm_stats`` and ``torch.var_mean`` for B7, the
    training forward of ``F.batch_norm`` beside B7 + B8 and, in the plain
    case, ``torch.batch_norm_elemt`` beside B8 alone,
    ``torch.batch_norm_backward_reduce`` for B9 (no ReLU mask: B9's plain
    case) and the autograd backward of ``F.batch_norm`` beside B9 +
    B10)."""
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import batchnorm as bn

    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    sms = _build.sm_count(torch.device("cuda", 0))
    out = {k: [] for k in ("bn_stats", "bn_apply", "bn_bwd_reduce",
                           "bn_bwd_dx")}
    eps = 1e-5
    for n, c, dtype, relu, has_res, what in BN_CASES:
        def mk(scale=1.0, shift=0.0):
            return (torch.randn(n, c, generator=g, device="cuda") * scale
                    + shift).to(dtype)
        x, dy = mk(2.0, 0.5), mk()
        res = mk() if has_res else None
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device="cuda")
        beta = 0.1 * torch.randn(c, generator=g, device="cuda")
        xf = x.float()
        nf = float(n)
        # B7, twice, and its fold of its own sums in eager PyTorch
        kstats = bn.bn_stats_cuda(x, gamma, beta, eps)
        kstats2 = bn.bn_stats_cuda(x, gamma, beta, eps)
        ks, kq = kstats[:2]
        kfold = bn.bn_fwd_constants_ref(ks, kq, gamma, beta, eps, nf)
        ps, pq = bn.bn_stats_ref(x)
        # the constants of the plain sums, in the order of the op
        mean, var, rstd, s, t = bn.bn_fwd_constants_ref(ps, pq, gamma, beta,
                                                        eps, nf)
        # B8, B9 (twice)
        ky = bn.bn_apply_cuda(x, s, t, res, relu)
        ky_poison = _on_poison(
            lambda: bn.bn_apply_cuda(x, s, t, res, relu), x.shape, dtype)
        py = bn.bn_apply_ref(x, s, t, res, relu)
        kg, kb = bn.bn_bwd_reduce_cuda(x, dy, res, s, t, mean, rstd, relu)
        kred2 = bn.bn_bwd_reduce_cuda(x, dy, res, s, t, mean, rstd, relu)
        pg, pb = bn.bn_bwd_reduce_ref(x, dy, res, s, t, mean, rstd, relu)
        # B10: the kernel folds A, B and C from the statistics and the
        # plain version's column sums; the plain fold runs on the card
        kdx, kdres = bn.bn_bwd_dx_cuda(x, dy, res, s, t, gamma, mean, rstd,
                                       pg, pb, relu)
        pdx, pdres = bn.bn_bwd_dx_folded_ref(x, dy, res, s, t, gamma, mean,
                                             rstd, pg, pb, relu)
        torch.cuda.synchronize()

        dye = bn._dy_eff(x, dy, res, s, t, relu)
        terms = {"sum": xf, "sumsq": xf * xf,
                 "dgamma": dye * (xf * rstd + -mean * rstd), "dbeta": dye}
        absum = {k: v.abs().sum(0) for k, v in terms.items()}
        got = {"sum": ks, "sumsq": kq, "dgamma": kg, "dbeta": kb}
        want = {"sum": ps, "sumsq": pq, "dgamma": pg, "dbeta": pb}
        reads = {k: _bn_reading(got[k], want[k], absum[k]) for k in got}
        vec = bn.vector_width(c, dtype, x)
        row_blocks, col_tiles = bn.reduce_geometry(n, c, vec,
                                                   x.element_size(), sms)
        block_of = bn.reduce_block_of_rows(n, c, vec, row_blocks).cuda()
        skips = {k: _block_skip_reading(terms[k], absum[k], block_of)
                 for k in terms}
        dropped = {k: _dropped_partial_reading(terms[k], absum[k], block_of,
                                               want[k]) for k in terms}
        names = ("mean", "var", "rstd", "s", "t")
        bitwise = {"y": _bitwise(ky, py),
                   "y on a NaN-poisoned buffer": _bitwise(ky_poison, py),
                   "dx": _bitwise(kdx, pdx),
                   "dres": (None if res is None else _bitwise(kdres, pdres)),
                   **{f"stats_{k}": _bitwise(a, b)
                      for k, a, b in zip(names, kstats[2:], kfold)},
                   "stats_run_to_run": all(
                       _bitwise(a, b) for a, b in zip(kstats, kstats2)),
                   "bwd_reduce_run_to_run": all(
                       _bitwise(a, b) for a, b in zip((kg, kb), kred2))}
        print(json.dumps({"bn_case": what, "rows": n, "channels": c,
                          "vec": vec, "row_blocks": row_blocks,
                          "col_tiles": col_tiles,
                          "partial_share": 8 * row_blocks / (
                              n * x.element_size()),
                          "rtol": BN_RTOL, "reduce_reading": reads,
                          "skip_reading": skips,
                          "dropped_partial_reading": dropped,
                          "bitwise": bitwise}))
        for k, r in reads.items():
            _require(r <= BN_RTOL, f"batchnorm {what}: {k} reads {r:.2e} of "
                                   f"its terms' magnitude > {BN_RTOL}")
        for k, r in skips.items():
            _require(r > BN_RTOL, f"batchnorm {what}: a {k} that leaves out "
                                  f"one row block reads {r:.2e} <= "
                                  f"{BN_RTOL} and would pass")
        for k, r in dropped.items():
            _require(r > BN_RTOL, f"batchnorm {what}: a {k} whose finish "
                                  f"drops one partial row reads {r:.2e} <= "
                                  f"{BN_RTOL} and would pass")
        for k, ok in bitwise.items():
            _require(ok is not False, f"batchnorm {what}: {k} is not bitwise "
                                      "equal")
        for k, v in (("y", ky), ("dx", kdx), ("mean", kstats[2]),
                     ("rstd", kstats[4])):
            _require(bool(torch.isfinite(v).all()),
                     f"batchnorm {what}: {k} not finite")
        rows = {
            "bn_stats": {"max_abs_err": max((ks - ps).abs().max().item(),
                                            (kq - pq).abs().max().item()),
                         "tol": f"sums per channel <= {BN_RTOL} x sum "
                                "|terms|; mean, var, rstd, s, t bitwise the "
                                "plain fold of the kernel's sums",
                         "reading": {k: reads[k] for k in ("sum", "sumsq")}},
            "bn_apply": {"max_abs_err": (ky.float() - py.float()).abs().max()
                         .item(), "tol": "bitwise"},
            "bn_bwd_reduce": {
                "max_abs_err": max((kg - pg).abs().max().item(),
                                   (kb - pb).abs().max().item()),
                "tol": f"per channel <= {BN_RTOL} x sum |terms|",
                "reading": {k: reads[k] for k in ("dgamma", "dbeta")}},
            "bn_bwd_dx": {"max_abs_err": (kdx.float() - pdx.float()).abs()
                          .max().item(),
                          "tol": "bitwise (dx, dres) against the plain fold "
                                 "of A, B, C + bn_bwd_dx_ref"},
        }
        for kname, row in rows.items():
            row["case"] = f"[{n}, {c}] {str(dtype)[6:]}: {what}"
            if kname in ("bn_stats", "bn_bwd_reduce"):
                row.update(row_blocks=row_blocks, skip_reading=skips,
                           dropped_partial_reading=dropped)
            out[kname].append(row)
        if dtype != torch.bfloat16:
            continue
        # times, and the least each call could take: each input read
        # once, each output written once, over the HBM rate
        e = x.element_size()
        big = n * c * e
        nres = 1 if has_res else 0
        mask_res = 1 if (relu and has_res) else 0
        work = {
            "bn_stats": (big + 9 * c * 4, 3 * n * c),
            "bn_apply": ((2 + nres) * big + 2 * c * 4, (3 + nres) * n * c),
            "bn_bwd_reduce": ((2 + mask_res) * big + 6 * c * 4, 9 * n * c),
            "bn_bwd_dx": ((3 + mask_res + nres) * big + 7 * c * 4,
                          9 * n * c),
        }
        calls = {
            "bn_stats": (lambda _=0: bn.bn_stats_cuda(x, gamma, beta, eps),
                         lambda _=0: bn.bn_stats_folded_ref(x, gamma, beta,
                                                            eps)),
            "bn_apply": (lambda _=0: bn.bn_apply_cuda(x, s, t, res, relu),
                         lambda _=0: bn.bn_apply_ref(x, s, t, res, relu)),
            "bn_bwd_reduce": (
                lambda _=0: bn.bn_bwd_reduce_cuda(x, dy, res, s, t, mean,
                                                  rstd, relu),
                lambda _=0: bn.bn_bwd_reduce_ref(x, dy, res, s, t, mean,
                                                 rstd, relu)),
            "bn_bwd_dx": (
                lambda _=0: bn.bn_bwd_dx_cuda(x, dy, res, s, t, gamma, mean,
                                              rstd, pg, pb, relu),
                lambda _=0: bn.bn_bwd_dx_folded_ref(x, dy, res, s, t, gamma,
                                                    mean, rstd, pg, pb,
                                                    relu)),
        }
        # the yardsticks: PyTorch's BatchNorm on the NCHW (channels-last)
        # view of the same rows, a batch of 128 square images
        side = math.isqrt(n // 128)
        xn = x.reshape(128, side, side, c).permute(0, 3, 1, 2)
        xg = xn.detach().requires_grad_()
        gb = gamma.detach().requires_grad_()
        bb = beta.detach().requires_grad_()
        yl = F.batch_norm(xg, None, None, gb, bb, training=True, eps=eps)
        dyn = dy.reshape(128, side, side, c).permute(0, 3, 1, 2)
        lib_bwd = _device_ms(lambda _=0: torch.autograd.grad(
            yl, (xg, gb, bb), dyn, retain_graph=True), iters=20)
        lib = {
            "bn_stats": _device_ms(lambda _=0: torch.batch_norm_stats(
                xn, eps), iters=20),
            "bn_apply": _device_ms(lambda _=0: F.batch_norm(
                xn, None, None, gamma, beta, training=True, eps=eps),
                iters=20),
            "bn_bwd_reduce": _device_ms(
                lambda _=0: torch.batch_norm_backward_reduce(
                    dyn, xn, mean, rstd, gamma, True, True, True), iters=20),
            "bn_bwd_dx": lib_bwd,
        }
        covers = {"bn_stats": "torch.batch_norm_stats (mean, invstd)",
                  "bn_apply": "F.batch_norm training fwd (B7 + B8)",
                  "bn_bwd_reduce": "torch.batch_norm_backward_reduce (no "
                                   "ReLU mask: B9's plain case)",
                  "bn_bwd_dx": "F.batch_norm bwd (B9 + B10)"}
        also = {"bn_stats": ("torch.var_mean", _device_ms(
                    lambda _=0: torch.var_mean(x, dim=0, correction=0),
                    iters=20)),
                "bn_bwd_reduce": ("F.batch_norm bwd (B9 + B10)", lib_bwd)}
        if not relu and not has_res:
            # B8's own function in one call: (x - mean) * rstd * gamma +
            # beta from given statistics (B8 takes them folded into s, t)
            also["bn_apply"] = (
                "torch.batch_norm_elemt (one call, B8's plain case)",
                _device_ms(lambda _=0: torch.batch_norm_elemt(
                    xn, gamma, beta, mean, rstd, eps), iters=20))
        for kname, (kern, plain) in calls.items():
            bound, by = _bound(*work[kname], "f32")
            out[kname][-1].update(
                ms=_device_ms(kern, iters=20),
                plain_ms=_device_ms(plain, iters=5),
                library_ms=lib[kname], library_call=covers[kname],
                bound_ms=bound, bound_by=by)
            if kname in also:
                out[kname][-1].update(library2_call=also[kname][0],
                                      library2_ms=also[kname][1])
        del yl, xg
    # no rows: one row block sums nothing, and the fold divides by 0
    e = torch.empty(0, 64, device="cuda")
    v = torch.ones(64, device="cuda")
    es = bn.bn_stats_cuda(e, v, v, eps)
    eg = bn.bn_bwd_reduce_cuda(e, e, None, v, v, v, v, True)
    ef = bn.bn_fwd_constants_ref(es[0], es[1], v, v, eps, 0.0)
    _require(all(bool((a == 0).all()) for a in (*es[:2], *eg))
             and all(torch.equal(a.isnan(), b.isnan())
                     for a, b in zip(es[2:], ef)),
             "batchnorm: no rows must give zero sums and the fold's NaNs")
    return out


# ---------------------------------------------------------------------------
# phase 3: the int8 wire's kernels (B11-B14)
# ---------------------------------------------------------------------------

QUANT_BLOCK = 256
QUANT_RANKS = 4
#: in the order one rank runs them on the main path
QUANT_KERNELS = ("quant_ef_rows", "accum_rows", "quant_rows", "dequant_flat")
QUANT_NO_LIBRARY = ("none: no single PyTorch call computes a per-block "
                    "int8 quantize, an ordered dequantize-accumulate or a "
                    "block dequantize")


def gpt2_medium_plan(model=None):
    """GPT-2 medium's DistributedOptimizer bucket plan at the default
    128 MiB threshold and ``model``'s parameters in the plan's leaf order
    (without a model: the plan alone, from a model on the meta device)."""
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM

    return _model_plan(GPT2_MEDIUM, model)


def _model_plan(cfg, model=None):
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.ops import fusion

    if model is None:
        with torch.device("meta"):
            model = Transformer(cfg)
    named = list(model.named_parameters())
    paths = [fusion.flax_path(n) for n, _ in named]
    order = fusion.flatten_order(paths)
    plans = fusion.pytree_bucket_plan(
        [(paths[i], tuple(named[i][1].shape), named[i][1].dtype)
         for i in order], threshold_bytes=128 * 1024 * 1024,
        backward_order=True)
    return plans, [named[i][1] for i in order]


def _bucket_sizes(plans):
    return [sum(size for (_, _, size, _) in plan) for plan in plans]


@contextlib.contextmanager
def _plain_quantized():
    """The int8 wire's stage functions run the plain versions of B11-B14
    (on any device) instead of the kernels."""
    from horovod_tpu_torch.ops import quantized_collectives as qc

    saved = {name: getattr(qc, name) for name in
             ("quantize_rows", "quantize_ef_rows", "accum_rows",
              "dequantize_flat")}
    for name in saved:
        setattr(qc, name, getattr(qc, name + "_ref"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(qc, name, fn)


def _quant_payload(block, nblocks, rs):
    """The CPU test's edge cases: blocks of random magnitudes, an
    all-zero block, a block of values at k + 0.5 of its scale, blocks
    whose amax is negative, and a block whose amax is subnormal."""
    x = (rs.randn(nblocks, block)
         * 10.0 ** rs.uniform(-4, 2, (nblocks, 1))).astype(np.float32)
    x[1] = 0.0
    amax = np.float32(3.7)
    scale = np.float32(amax * np.float32(1.0 / 127.0))
    x[2] = (np.arange(block) % 120 - 60 + np.float32(0.5)).astype(
        np.float32) * scale
    x[2, 0] = amax
    x[3, 5] = -np.abs(x[3]).max() * 1.5
    x[4] = np.float32(3e-39) * np.linspace(-1, 1, block, dtype=np.float32)
    return x.reshape(-1)


def _equal(a, b):
    """Bitwise equality (float -0 and +0 differ)."""
    if a.dtype == torch.int8:
        return a.dtype == b.dtype and bool(torch.equal(a, b))
    return _bitwise(a, b)


def check_quantized(seed):
    """B11-B14 against their plain versions on the card, bitwise on
    every element. The main case is one rank's chain on the largest
    bucket of GPT-2 medium's plan (the token embedding, 50257 x 1024
    float32) at world 4, block 256: B12 on the bucket and its residual
    laid out as 4 rows, B13 on 4 rows of codes as the all-to-all
    delivers them, B11 on the reduced shard, B14 on the gathered codes.
    Then the same at world 8, and the CPU test's edge cases (all-zero
    blocks, ties, a subnormal amax, a ragged length) at blocks 32 and
    256 and n in {1, 2, 4, 8}, and at n = 3 and 12 (a partial round of
    B13's eight ranks in flight, and two rounds); at block 40 (C and the
    block not multiples of 16) B13 takes its element route. In every
    case B13 also runs on a NaN-poisoned output buffer (``_on_poison``)
    and on codes whose view starts 1 byte off 16-byte alignment (the
    element route), both bitwise, and its route is the one
    ``accum_route`` states. The main case is timed: kernel (B13 also
    L2-cold), plain version, and the bytes bound."""
    from horovod_tpu_torch.ops import quantized_collectives as qc

    plans, _ = gpt2_medium_plan()
    big = max(_bucket_sizes(plans))
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    rs = np.random.RandomState(seed + 7)
    cases = [(f"largest GPT-2 medium bucket ({big} float32), world 4",
              None, big, QUANT_RANKS, QUANT_BLOCK),
             (f"largest GPT-2 medium bucket, world 8", None, big, 8,
              QUANT_BLOCK)]
    for block, worlds in ((32, (1, 2, 3, 4, 8, 12)), (256, (1, 2, 4, 8)),
                          (40, (1, 3, 4))):
        for n in worlds:
            x = _quant_payload(block, 6 * n, rs)[:-37]
            cases.append((f"edge cases, block {block}, world {n}, ragged",
                          x, x.size, n, block))
    out = {k: [] for k in QUANT_KERNELS}
    for ci, (what, xn, length, n, block) in enumerate(cases):
        if xn is None:
            # gradient-like: per-block magnitudes over four decades
            x = (torch.randn(length // 1024, 1024, generator=g,
                             device="cuda")
                 * torch.exp(torch.empty(length // 1024, 1, device="cuda")
                             .uniform_(-9, 0, generator=g))).reshape(-1)
        else:
            x = torch.from_numpy(xn).cuda()
        r = 1e-2 * x.abs().mean() * torch.randn(length, generator=g,
                                                 device="cuda")
        kq, ks, ke = qc.quantize_ef_rows_cuda(x, r, n, block)
        pq, ps, pe = qc.quantize_ef_rows_ref(x, r, n, block)
        ka = qc.accum_rows_cuda(pq, ps, block)
        ka_poison = _on_poison(lambda: qc.accum_rows_cuda(pq, ps, block),
                               (pq.shape[1],), torch.float32)
        q_off = torch.empty(pq.numel() + 16, dtype=torch.int8,
                            device="cuda")[1:1 + pq.numel()].view(pq.shape)
        q_off.copy_(pq)
        ka_off = qc.accum_rows_cuda(q_off, ps, block)
        pa = qc.accum_rows_ref(pq, ps, block)
        route = qc.accum_route(pq, ps, ka, block)
        route_off = qc.accum_route(q_off, ps, ka_off, block)
        _require(route == (qc.ACCUM_CODES if block % 16 == 0 else 1)
                 and route_off == 1,
                 f"accum_rows {what}: routes {route}, {route_off} (codes "
                 "a thread) where the block and alignment call for "
                 "others")
        kq3, ks3 = qc.quantize_rows_cuda(pa, 1, block)
        pq3, ps3 = qc.quantize_rows_ref(pa, 1, block)
        kq1, ks1 = qc.quantize_rows_cuda(x, n, block)
        pq1, ps1 = qc.quantize_rows_ref(x, n, block)
        qa, sa = pq.reshape(-1), ps.reshape(-1)
        ky = qc.dequantize_flat_cuda(qa, sa, block, length)
        py = qc.dequantize_flat_ref(qa, sa, block, length)
        torch.cuda.synchronize()
        bitwise = {
            "quant_ef_rows": {"q": _equal(kq, pq), "s": _equal(ks, ps),
                              "residual": _equal(ke, pe)},
            "accum_rows": {"sum": _equal(ka, pa),
                           "sum on a NaN-poisoned buffer": _equal(ka_poison,
                                                                  pa),
                           "sum of codes 1 byte off alignment": _equal(
                               ka_off, pa)},
            "quant_rows": {"q shard": _equal(kq3, pq3),
                           "s shard": _equal(ks3, ps3),
                           "q rows": _equal(kq1, pq1),
                           "s rows": _equal(ks1, ps1)},
            "dequant_flat": {"y": _equal(ky, py)},
        }
        errs = {
            "quant_ef_rows": max((ke - pe).abs().max().item(),
                                 (kq.int() - pq.int()).abs().max().item()),
            "accum_rows": (ka - pa).abs().max().item(),
            "quant_rows": max((kq3.int() - pq3.int()).abs().max().item(),
                              (kq1.int() - pq1.int()).abs().max().item()),
            "dequant_flat": (ky - py).abs().max().item(),
        }
        print(json.dumps({"quant_case": what, "elements": length, "world": n,
                          "block": block, "accum_route": route,
                          "accum_route_off": route_off, "bitwise": bitwise}))
        for kname, parts in bitwise.items():
            for part, ok in parts.items():
                _require(ok, f"{kname} {what}: {part} is not bitwise equal "
                             "to the plain version")
        for kname in QUANT_KERNELS:
            out[kname].append({"case": what, "max_abs_err": errs[kname],
                               "tol": "bitwise"})
        if ci:
            continue
        m = pq.numel()
        c = m // n
        nb = m // block
        # bytes: each input read once, each output written once
        work = {
            "quant_ef_rows": (12 * length + m + 4 * nb, 8 * m),
            "accum_rows": (m + 4 * nb + 4 * c, 2 * m),
            "quant_rows": (4 * c + c + 4 * (c // block), 5 * c),
            "dequant_flat": (m + 4 * nb + 4 * length, length),
        }
        calls = {
            "quant_ef_rows": (lambda _=0: qc.quantize_ef_rows_cuda(
                x, r, n, block), lambda _=0: qc.quantize_ef_rows_ref(
                x, r, n, block)),
            "accum_rows": (lambda _=0: qc.accum_rows_cuda(pq, ps, block),
                           lambda _=0: qc.accum_rows_ref(pq, ps, block)),
            "quant_rows": (lambda _=0: qc.quantize_rows_cuda(pa, 1, block),
                           lambda _=0: qc.quantize_rows_ref(pa, 1, block)),
            "dequant_flat": (lambda _=0: qc.dequantize_flat_cuda(
                qa, sa, block, length), lambda _=0: qc.dequantize_flat_ref(
                qa, sa, block, length)),
        }
        shapes = {
            "quant_ef_rows": f"x, residual [{length}] -> [{n}, {c}] int8",
            "accum_rows": f"[{n}, {c}] int8 -> [{c}] float32",
            "quant_rows": f"shard [{c}] -> [1, {c}] int8",
            "dequant_flat": f"[{m}] int8 -> [{length}] float32",
        }
        for kname, (kern, plain) in calls.items():
            bound, by = _bound(*work[kname], "f32")
            out[kname][-1].update(
                shape=shapes[kname], ms=_device_ms(kern, iters=20),
                plain_ms=_device_ms(plain, iters=3), bound_ms=bound,
                bound_by=by, library_ms=None,
                library_call=QUANT_NO_LIBRARY)
        out["accum_rows"][-1]["cold_ms"] = _device_ms(
            calls["accum_rows"][0], iters=20, cold=True)
        del pe, pa, q_off
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3: the reduce-scatter's pack epilogues (B6, B15)
# ---------------------------------------------------------------------------

ZERO_RANKS = 4
#: per-row relative L2 limit of B15's [M, N] product against the float64
#: product of the same operands. Float32 accumulation of K exact products
#: errs by ~sqrt(K) float32 roundings of a row's scale; a kernel that
#: skips one K tile of depth t (ops/ring_pack.py: 64 in bf16, 16 in
#: float32) loses about sqrt(t / K) of a random row. The limit sits
#: between the worst healthy reading (4.7e-6, the bf16 products on the
#: tensor cores) and the least skipped-tile reading (3.4e-2, case (d);
#: NVIDIA H100 80GB HBM3, 700 W; PERF.md), both printed and checked by
#: every run
MATMUL_TOL = 1e-4
#: (name, M, K, N, dtype, n): BERT-Large's weight gradients at per-rank
#: batch 8 x 512 = 4096 tokens; ragged cases in float32 and bf16 (M not
#: a tile multiple, K and N odd: every load route of the bf16 kernel,
#: TMA and narrow copies, runs); and (b) with N = 30720, whose rows of b
#: are 16-byte aligned (TMA) where (b)'s are not (4-byte copies): the
#: price of the copy route at the same size
MATMUL_CASES = (
    ("(a) MLP-out dW = x^T dy, [4096,4096] @ [4096,1024] bf16, n = 4",
     4096, 4096, 1024, torch.bfloat16, 4),
    ("(b) tied-embedding dW of the MLM head, [1024,4096] @ [4096,30522] "
     "bf16, n = 4", 1024, 4096, 30522, torch.bfloat16, 4),
    ("(c) ragged [1000,777] @ [777,333] float32, n = 3", 1000, 777, 333,
     torch.float32, 3),
    ("(d) ragged [1000,777] @ [777,333] bf16, n = 3", 1000, 777, 333,
     torch.bfloat16, 3),
    ("(e) (b) with N = 30720, rows of b 16-byte aligned, [1024,4096] @ "
     "[4096,30720] bf16, n = 4", 1024, 4096, 30720, torch.bfloat16, 4),
)


def bert_large_plan(model=None):
    """BERT-Large's ZeRO-1 bucket plan at the default 128 MiB threshold
    (11 buckets, the largest 32,543,744 float32) and ``model``'s
    parameters in the plan's leaf order."""
    from horovod_tpu_torch.models.transformer import BERT_LARGE

    return _model_plan(BERT_LARGE, model)


def check_pack_rows(seed):
    """B6 against ``zero._pad_rows`` on the card, bitwise: the largest
    bucket of BERT-Large's plan in float32 at n in {4, 1, 2, 8} (the
    main case: n = 4), ragged lengths, L < n, n * k - L = 1, lengths at
    the kernel's tile boundaries (``ops/ring_pack.py`` ``PACK_THREADS``
    x ``PACK_TILE_UNROLL`` vectors; one element or one vector on either
    side), bf16, and sources that start off 16-byte alignment (slices of
    a larger tensor: the element-wise kernel). The main case is timed:
    the kernel, the plain version, ``F.pad`` and a ``copy_`` of the same
    bytes (one call each), and the bound; the large unaligned case is
    timed too."""
    from horovod_tpu_torch.ops import ring_pack
    from horovod_tpu_torch.optim import zero

    plans, _ = bert_large_plan()
    big = max(_bucket_sizes(plans))
    tile = 4 * ring_pack.PACK_THREADS * ring_pack.PACK_TILE_UNROLL
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    base = torch.randn(big + 8, generator=g, device="cuda")
    base[5] = -0.0
    half = base.to(torch.bfloat16)
    cases = [(f"largest BERT-Large bucket ({big} float32), world {n}",
              base[:big], n) for n in (ZERO_RANKS, 1, 2, 8)]
    cases += [("ragged: largest bucket - 1, world 4", base[:big - 1], 4),
              ("ragged: 1001 float32, world 3", base[:1001], 3),
              ("L < n: 3 float32, world 8", base[:3], 8),
              ("n*k - L = 1: 4000011 float32, world 4", base[:4000011], 4),
              ("n*k - L = 1: 40023 bf16, world 8", half[:40023], 8),
              (f"3 tiles: {3 * tile} float32, world 2", base[:3 * tile],
               2),
              (f"3 tiles + 1: {3 * tile + 1} float32, world 3",
               base[:3 * tile + 1], 3),
              (f"3 tiles - 1 vector: {3 * tile - 4} float32, world 4",
               base[:3 * tile - 4], 4),
              (f"3 tiles + 1 vector: {3 * tile + 4} float32, world 4",
               base[:3 * tile + 4], 4),
              (f"3 tiles - 1: {3 * tile - 1} float32, world 4",
               base[:3 * tile - 1], 4),
              ("bf16: largest bucket, world 4", half[:big], 4),
              ("bf16 ragged: 1001, world 3", half[:1001], 3),
              ("unaligned float32 slice [1:big+1], world 4",
               base[1:big + 1], 4),
              ("unaligned bf16 slice [3:1004], world 4", half[3:1004], 4)]
    out = []
    for ci, (what, x, n) in enumerate(cases):
        want = zero._pad_rows(x, n)
        got = ring_pack.pack_rows_cuda(x, n)
        torch.cuda.synchronize()
        ok = tuple(got.shape) == tuple(want.shape) and _bitwise(got, want)
        print(json.dumps({"pack_case": what, "elements": x.numel(),
                          "world": n, "aligned": x.data_ptr() % 16 == 0,
                          "bitwise": ok}))
        _require(ok, f"pack_rows {what}: not bitwise equal to _pad_rows")
        del got
        row = {"case": what, "max_abs_err": 0.0, "tol": "bitwise"}
        k = -(-x.numel() // n)
        if ci == 0:
            pad = n * k - big
            dst = torch.empty(n * k, device="cuda")
            bound, by = _bound(4 * big + 4 * n * k, 0, "f32")
            row.update(
                shape=f"[{big}] float32 -> [{n}, {k}]",
                ms=_device_ms(lambda _=0: ring_pack.pack_rows_cuda(x, n),
                              iters=20),
                plain_ms=_device_ms(lambda _=0: zero._pad_rows(x, n),
                                    iters=20),
                library_ms=_device_ms(lambda _=0: F.pad(x, (0, pad)).view(
                    n, k), iters=20),
                library_call="F.pad(bucket, (0, n*k - L)).view(n, k): one "
                             "call",
                library2_ms=_device_ms(lambda _=0: dst[:big].copy_(x),
                                       iters=20),
                library2_call="dst[:L].copy_(bucket) into a preallocated "
                              "[n*k]: one call, no zeros",
                bound_ms=bound, bound_by=by)
            del dst
        elif x.numel() == big and x.data_ptr() % 16:
            row.update(ms=_device_ms(
                lambda _=0: ring_pack.pack_rows_cuda(x, n), iters=20),
                bound_ms=_bound(4 * big + 4 * n * k, 0, "f32")[0])
        out.append(row)
        del want
    del base, half
    torch.cuda.empty_cache()
    return {"pack_rows": out}


def _matmul_row_rel(rows, ref64, m, ncols):
    """Per-row relative L2 of the [M, N] product held in the first M * N
    elements of the ring rows, against the float64 product."""
    g = rows.reshape(-1)[:m * ncols].view(m, ncols).double()
    return ((g - ref64).norm(dim=1)
            / ref64.norm(dim=1).clamp_min(1e-300))


def check_matmul_pack(seed):
    """B15 on the card at ``MATMUL_CASES``: each row of the product held
    within ``MATMUL_TOL`` (relative L2) of the float64 product, the
    plain float32 path (``matmul_pack_ref``, no TF32) read beside it as
    a second witness, the padding exactly zero; the kernel's product
    with its last K tile taken out (an emulated skip) must fail that
    check in every row. Integer-valued operands in [-4, 4], whose
    float32 sums are exact, must give the float64 product bitwise,
    padding included, at every shape. Each case is timed: kernel,
    plain version, ``torch.matmul`` + ``F.pad`` (two calls), bound."""
    from horovod_tpu_torch.ops import ring_pack

    g = torch.Generator(device="cuda").manual_seed(seed + 10)
    out = []
    for what, m, kd, ncols, dtype, n in MATMUL_CASES:
        a = torch.randn(m, kd, generator=g, device="cuda").to(dtype)
        b = torch.randn(kd, ncols, generator=g, device="cuda").to(dtype)
        got = ring_pack.matmul_pack_cuda(a, b, n)
        plain = ring_pack.matmul_pack_ref(a, b, n)
        ref64 = a.double() @ b.double()
        torch.cuda.synchronize()
        size, k = m * ncols, -(-m * ncols // n)
        _require(tuple(got.shape) == (n, k) and got.dtype == torch.float32,
                 f"matmul_pack {what}: shape {tuple(got.shape)}")
        _require(bool((got.reshape(-1)[size:] == 0).all()),
                 f"matmul_pack {what}: padding not zero")
        _require(bool(torch.isfinite(got).all()),
                 f"matmul_pack {what}: not finite")
        rel = _matmul_row_rel(got, ref64, m, ncols)
        plain_rel = _matmul_row_rel(plain, ref64, m, ncols)
        tile_k = (ring_pack.MATMUL_TILE_K if dtype == torch.bfloat16
                  else ring_pack.MATMUL_F32_TILE_K)
        p0 = (kd - 1) // tile_k * tile_k
        part = a[:, p0:].double() @ b[p0:, :].double()
        skip = _matmul_row_rel(
            (got.reshape(-1)[:size].view(m, ncols).double() - part), ref64,
            m, ncols)
        del part
        err = (got.reshape(-1)[:size].view(m, ncols).double()
               - ref64).abs().max().item()
        # the exactness case: integer-valued operands
        ai = torch.randint(-4, 5, (m, kd), generator=g, device="cuda").to(
            dtype)
        bi = torch.randint(-4, 5, (kd, ncols), generator=g,
                           device="cuda").to(dtype)
        goti = ring_pack.matmul_pack_cuda(ai, bi, n)
        wanti = torch.zeros(n * k, dtype=torch.float32, device="cuda")
        wanti[:size] = (ai.double() @ bi.double()).reshape(-1).float()
        plaini = ring_pack.matmul_pack_ref(ai, bi, n)
        torch.cuda.synchronize()
        exact = _bitwise(goti.reshape(-1), wanti)
        plain_exact = _bitwise(plaini.reshape(-1), wanti)
        reading = {"matmul_case": what, "row_rel_l2_max": rel.max().item(),
                   "plain_row_rel_l2_max": plain_rel.max().item(),
                   "tile_skip_row_rel_l2_min": skip.min().item(),
                   "tol": MATMUL_TOL, "integer_operands_bitwise": exact,
                   "plain_integer_operands_bitwise": plain_exact}
        print(json.dumps(reading))
        _require(reading["row_rel_l2_max"] <= MATMUL_TOL,
                 f"matmul_pack {what}: a row is {rel.max().item():.2e} "
                 f"(relative L2) from the float64 product > {MATMUL_TOL}")
        _require(reading["tile_skip_row_rel_l2_min"] > MATMUL_TOL,
                 f"matmul_pack {what}: a kernel skipping its last K tile "
                 f"reads {skip.min().item():.2e} and would pass")
        _require(exact, f"matmul_pack {what}: integer-valued operands not "
                        "bitwise equal to the exact product")
        del ref64, rel, plain_rel, skip, goti, wanti, plaini, plain
        es = a.element_size()
        bound, by = _bound((m * kd + kd * ncols) * es + 4 * n * k,
                           2 * m * ncols * kd,
                           "bf16" if dtype == torch.bfloat16 else "f32")
        pad = n * k - size
        row = dict(case=what, max_abs_err=err,
                   tol=f"per row: ||err|| <= {MATMUL_TOL} ||float64 row||; "
                       "integer operands bitwise",
                   row_rel_l2_max=reading["row_rel_l2_max"],
                   tile_skip_row_rel_l2_min=reading[
                       "tile_skip_row_rel_l2_min"],
                   shape=f"[{m},{kd}] @ [{kd},{ncols}] {str(dtype)[6:]} -> "
                         f"[{n}, {k}] float32",
                   ms=_device_ms(lambda _=0: ring_pack.matmul_pack_cuda(
                       a, b, n), iters=3),
                   plain_ms=_device_ms(lambda _=0: ring_pack.matmul_pack_ref(
                       a, b, n), iters=3),
                   library_ms=_device_ms(lambda _=0: F.pad(
                       torch.matmul(a, b).reshape(-1), (0, pad)), iters=3),
                   library_call="torch.matmul(a, b) + F.pad: two calls "
                                "(cuBLAS; the product in the operands' "
                                "dtype)",
                   bound_ms=bound, bound_by=by)
        out.append(row)
        del a, b, got, ai, bi
        torch.cuda.empty_cache()
    return {"matmul_pack": out}


# ---------------------------------------------------------------------------
# phase 3: the vocab-blocked fused cross-entropy (no kernel of its own)
# ---------------------------------------------------------------------------

#: the heads the fused loss runs on, as (label, batch, seq, vocab,
#: causal): GPT-2 medium's causal head reads hidden[:, :-1] (8 x 1023 =
#: 8184 rows), BERT-Large's masked-LM head every position (8 x 512 = 4096)
CE_HEADS = (("GPT-2 medium head", 8, 1024, 50257, True),
            ("BERT-Large head", 8, 512, 30522, False))
CE_HIDDEN = 1024
#: limits of ``fused_linear_cross_entropy`` against a float64 materialized
#: reference of the same function (the weight rounded to bf16 as the
#: function rounds it): the loss relative, dX row by row and dW vocab row
#: by vocab row, each as a relative L2 of the row. The function rounds
#: ds to bf16 before its two products, as the JAX function does, so dX
#: and dW carry bf16 rounding (2^-9 relative a term) where the loss
#: carries only float32 sums. Each limit sits between the worst healthy
#: reading and the least of the injected faults (``CE_FAULTS``; PERF.md)
CE_TOL = {"loss_rel": 1e-4, "dx_row": 2e-2, "dw_row": 2e-2}
#: faults the checks must catch: the ragged last vocab block skipped, its
#: pad columns left unmasked, the first block's dW dropped
CE_FAULTS = ("skip_ragged_block", "unmasked_pad", "drop_block_dw")


@contextlib.contextmanager
def _injected_ce_fault(name):
    """Run ``fused_linear_cross_entropy`` as a faulty version would:
    ``skip_ragged_block``: the loop over vocab blocks leaves out the
    ragged last one (forward and backward); ``unmasked_pad``: its pad
    columns keep their logits (0, from the zero pad rows) and
    probabilities; ``drop_block_dw``: the first block's weight gradient
    is never written (zeros)."""
    from horovod_tpu_torch.ops import fused_cross_entropy as fce

    if name == "skip_ragged_block":
        attr, orig = "_vocab_blocks", fce._vocab_blocks

        def faulty(v, block):
            return [b for b in orig(v, block) if b[1] == block]
    elif name == "unmasked_pad":
        attr, orig = "_mask_pad_", fce._mask_pad_

        def faulty(t, width, value):
            return None
    elif name == "drop_block_dw":
        attr, orig = "_write_dw", fce._write_dw

        def faulty(dwt, base, width, blk):
            if base == 0:
                dwt[:width].zero_()
            else:
                orig(dwt, base, width, blk)
    else:
        raise ValueError(f"unknown fault {name!r}")
    setattr(fce, attr, faulty)
    try:
        yield
    finally:
        setattr(fce, attr, orig)


def _ce_reference64(x, table, targets, valid, mean):
    """Loss, dX and dW of ``fused_linear_cross_entropy(x, table.t(),
    targets, valid=valid, mean=mean)`` computed in float64 on the whole
    [N, V] logits: the weight rounded to x's dtype first, out-of-range ids
    adding no loss but counting in the mean."""
    xd = x.double()
    wd = table.to(x.dtype).double()
    logits = xd @ wd.t()
    in_range = (targets >= 0) & (targets < table.shape[0])
    contrib = valid & in_range
    t = torch.where(in_range, targets, 0)
    rows = torch.arange(len(t), device=x.device)
    lse = torch.logsumexp(logits, dim=1)
    nll = torch.where(contrib, lse - logits[rows, t], 0.0)
    gscale = 1.0 / valid.sum().clamp(min=1).double() if mean else 1.0
    loss = (nll.sum() * gscale).item()
    p = logits.sub_(lse[:, None]).exp_()
    p[rows, t] -= 1.0
    p.mul_((contrib.double() * gscale)[:, None])
    dx, dw = p @ wd, p.t() @ xd
    del logits, p
    return loss, dx, dw


def _ce_grads(x, table, targets, valid, mean):
    """The function's loss, dX and dW (tied layout: ``table.t()``)."""
    from horovod_tpu_torch.ops.fused_cross_entropy import \
        fused_linear_cross_entropy

    xg = x.detach().requires_grad_()
    w = table.detach().requires_grad_()
    loss, _ = fused_linear_cross_entropy(xg, w.t(), targets, valid=valid,
                                         mean=mean)
    loss.backward()
    return loss.item(), xg.grad, w.grad


def _row_rel_l2(got, want):
    """Each row's ||got - want|| / ||want|| (a zero reference row reads
    its error over 1e-30)."""
    err = (got.double() - want).norm(dim=1)
    return err / want.norm(dim=1).clamp_min(1e-30)


def _ce_readings(got, want):
    dx_rel, dw_rel = _row_rel_l2(got[1], want[1]), _row_rel_l2(got[2],
                                                               want[2])
    return {"loss": got[0], "loss_ref": want[0],
            "loss_rel": abs(got[0] - want[0]) / max(abs(want[0]), 1e-30),
            "dx_row": dx_rel.max().item(),
            "dx_row_median": dx_rel.median().item(),
            "dw_row": dw_rel.max().item(),
            "dw_row_median": dw_rel.median().item()}


def _ce_within(r):
    return all(r[k] <= CE_TOL[k] for k in CE_TOL)  # False on NaN


def _gemm_kernels(fn, iters=3):
    """Each matrix-product kernel one call of ``fn`` launches: name,
    device ms a call and launches a call (one profiler window)."""
    with _profiled() as prof:
        for i in range(iters):
            fn(i)
    out = {}
    for e in _kernel_events(prof):
        if any(k in e.key.lower() for k in ("gemm", "nvjet", "cutlass",
                                            "sm90_", "xmma")):
            out[e.key[:100]] = {"ms": _dev_us(e) / 1e3 / iters,
                                "calls": e.count / iters}
    return out


def _peak_mb(fn):
    """Device memory ``fn`` allocates at its peak above what was live
    before it, in MB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def _ce_case(b, t, v, causal, g):
    """The inputs of one head: hidden [b, t, h] bf16 (unit normal, like
    a LayerNorm output), the tied table [v, h] float32 (std 0.02, GPT-2's
    init), and tokens (causal) or labels and a 15% mask (masked LM)."""
    hidden = torch.randn(b, t, CE_HIDDEN, generator=g,
                         device="cuda").to(torch.bfloat16)
    table = torch.randn(v, CE_HIDDEN, generator=g, device="cuda") * 0.02
    ids = torch.randint(0, v, (b, t), generator=g, device="cuda")
    if causal:
        return hidden, table, ids, None
    mask = torch.rand(b, t, generator=g, device="cuda") < 0.15
    return hidden, table, ids, mask


def _ce_time(label, hidden, table, ids, mask, causal):
    """Device ms, GEMM kernels and peak memory of the head + loss forward
    and backward, fused (``fused_linear_cross_entropy`` as the training
    steps call it) and unfused (the model's tied head,
    ``Embed.attend``, then ``causal_lm_nll`` or ``mlm_loss``), on the
    same inputs."""
    from horovod_tpu_torch.models.transformer import (Embed, causal_lm_nll,
                                                      mlm_loss)
    from horovod_tpu_torch.ops.fused_cross_entropy import \
        fused_linear_cross_entropy

    head = Embed(table.shape[0], CE_HIDDEN, torch.bfloat16).cuda()
    with torch.no_grad():
        head.embedding.copy_(table)

    def fused(_=0):
        xh = hidden.detach().requires_grad_()
        head.embedding.grad = None
        if causal:
            targets = ids[:, 1:]
            loss, _n = fused_linear_cross_entropy(
                xh[:, :-1], head.embedding.t(), targets,
                valid=targets != -1, mean=False)
        else:
            loss, _n = fused_linear_cross_entropy(
                xh, head.embedding.t(), ids, valid=mask)
        loss.backward()

    def unfused(_=0):
        xh = hidden.detach().requires_grad_()
        head.embedding.grad = None
        logits = head.attend(xh)
        if causal:
            loss, _n = causal_lm_nll(logits, ids)
        else:
            loss, _n = mlm_loss(logits, ids, mask)
        del logits
        loss.backward()

    n = hidden.shape[0] * (hidden.shape[1] - causal)
    v = table.shape[0]
    bound, by = _bound(0, 3 * 2 * n * CE_HIDDEN * v, "bf16")
    out = {"head": label, "rows": n, "vocab": v, "bound_ms": bound,
           "bound_by": by}
    for name, fn in (("fused", fused), ("unfused", unfused)):
        fn()
        out[name] = {"device_ms": _device_ms(fn, iters=5),
                     "peak_mb": _peak_mb(fn),
                     "gemm_kernels": _gemm_kernels(fn)}
    head.embedding.grad = None
    return out


def _ce_product_routes(hidden, table):
    """The float32 product of one vocab block at the training shape,
    [8184, 1024] @ [1024, 8192] bf16: ``torch.mm(..., out_dtype=
    torch.float32)`` (the route the card takes), beside a bf16 result
    (what the JAX function does not do) and float32 operands (the CPU's
    route); device ms and the error against float64, which shows the
    route keeps float32 logits."""
    a = hidden[:, :-1].reshape(-1, CE_HIDDEN)
    b = table[:8192].to(torch.bfloat16).t()
    want = a.double() @ b.double()
    scale = want.abs().max().item()
    routes = {"mm out_dtype=float32": lambda _=0: torch.mm(
        a, b, out_dtype=torch.float32),
              "mm bf16 result": lambda _=0: torch.mm(a, b),
              "mm of float32 operands": lambda _=0: torch.mm(a.float(),
                                                             b.float())}
    bound, by = _bound(0, 2 * a.shape[0] * CE_HIDDEN * 8192, "bf16")
    out = {"shape": [list(a.shape), list(b.shape)], "bound_ms": bound,
           "bound_by": by}
    for name, fn in routes.items():
        got = fn()
        out[name] = {"device_ms": _device_ms(fn, iters=20),
                     "dtype": str(got.dtype),
                     "max_abs_err_over_max": (
                         (got.double() - want).abs().max().item() / scale)}
        del got
    del want
    _require(out["mm out_dtype=float32"]["dtype"] == "torch.float32"
             and out["mm out_dtype=float32"]["max_abs_err_over_max"]
             < out["mm bf16 result"]["max_abs_err_over_max"] / 16,
             f"torch.mm(..., out_dtype=torch.float32) does not keep float32 "
             f"logits: {out}")
    return out


def check_fused_ce(seed):
    """``fused_linear_cross_entropy`` on the card at GPT-2 medium's and
    BERT-Large's heads against ``_ce_reference64``: the GPT-2 head all
    valid in sum mode (the training step's call), the GPT-2 head with
    half its rows invalid and out-of-range ids (mean), the BERT head
    with a 15% mask and out-of-range ids (mean, the MLM step's call);
    each reading within ``CE_TOL``, and on the first case each of
    ``CE_FAULTS`` must fail the same checks. Then the head + loss timed
    fused and unfused, and the float32 product's route."""
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    cases, timings = [], []
    for label, b, t, v, causal in CE_HEADS:
        hidden, table, ids, mask = _ce_case(b, t, v, causal, g)
        if causal:
            x = hidden[:, :-1].reshape(-1, CE_HIDDEN)
            targets = ids[:, 1:].reshape(-1)
            n = x.shape[0]
            odd = torch.randperm(n, generator=g, device="cuda")
            valid = torch.rand(n, generator=g, device="cuda") < 0.5
            t_odd = targets.clone()
            t_odd[odd[:5]] = v + 7
            valid[odd[:5]] = True
            t_odd[odd[5:10]] = -1
            valid[odd[5:10]] = False
            runs = (("all valid, sum", targets,
                     torch.ones_like(targets, dtype=torch.bool), False),
                    ("half valid, out-of-range ids, mean", t_odd, valid,
                     True))
        else:
            x = hidden.reshape(-1, CE_HIDDEN)
            targets = ids.reshape(-1).clone()
            valid = mask.reshape(-1)
            on = valid.nonzero()[:, 0]
            targets[on[:3]] = v + 7
            runs = (("15% mask, out-of-range ids, mean", targets, valid,
                     True),)
        for i, (what, tg, va, mean) in enumerate(runs):
            want = _ce_reference64(x, table, tg, va, mean)
            r = _ce_readings(_ce_grads(x, table, tg, va, mean), want)
            r.update(head=label, case=what, rows=x.shape[0], vocab=v)
            if causal and i == 0:
                r["faults"] = {}
                for name in CE_FAULTS:
                    with _injected_ce_fault(name):
                        f = _ce_readings(_ce_grads(x, table, tg, va, mean),
                                         want)
                    r["faults"][name] = {k: f[k] for k in CE_TOL}
            del want
            cases.append(r)
        timings.append(_ce_time(label, hidden, table, ids, mask, causal))
        if causal:
            routes = _ce_product_routes(hidden, table)
        del hidden, table, x
        torch.cuda.empty_cache()
    out = {"tol": CE_TOL, "cases": cases, "timings": timings,
           "product_routes": routes}
    print(json.dumps({"fused_ce": out}))
    for r in cases:
        _require(_ce_within(r), f"fused CE, {r['head']}, {r['case']}: "
                                f"{ {k: r[k] for k in CE_TOL} } not within "
                                f"{CE_TOL}")
        for name, f in r.get("faults", {}).items():
            _require(not _ce_within(f), f"fused CE: the injected fault "
                                        f"{name} passes the checks: {f}")
    return out


# ---------------------------------------------------------------------------
# phase 4: training GPT-2 medium
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--batch-size", "8", "--seq-len", "1024",
              "--num-warmup-batches", "1", "--num-batches-per-iter", "5",
              "--num-iters", "1", "--flash", "--fused-norm"]
TRAIN_STEPS = 6  # 1 warm-up + 5 timed, as TRAIN_ARGS says
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "layernorm_fwd", "layernorm_bwd")


#: relative L2 limit of a parameter's step-1 gradient against the plain
#: path, by group: the query and key projections' gradients go through
#: dS = P * (dP - delta), a difference of near-equal terms, and the two
#: paths round around it at different points (the plain path's logits
#: come out of a bf16 product; the kernels keep float32 logits and
#: round dS to bf16, as the TPU kernels do), so they read higher than
#: the rest. Each limit sits between the worst healthy reading over 8
#: seeds and the least faulty one (``--parity-sweep``; PERF.md)
GRAD_TOL = {"attn_qk": 8e-2, "rest": 3e-2}


def _grad_group(name):
    return ("attn_qk" if ".attn.query." in name or ".attn.key." in name
            else "rest")


def check_train_parity(seed, weights_seed=0, enforce=True):
    """Step-1 loss and every parameter's gradient of the kernel path
    (flash attention, fused norms) against the plain path
    (``dot_product_attention``, unfused norms) on the weights training
    starts from (``make_lm_train_step``'s seed 0) and a 2 x 1024 batch.
    With ``enforce=False`` it only prints the readings."""
    from horovod_tpu_torch.models.transformer import (GPT2_MEDIUM,
                                                      Transformer,
                                                      causal_lm_loss)
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn

    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    with torch.device("cuda"):
        fast = Transformer(cfg, attention_fn=make_flash_attention_fn(True))
        plain = Transformer(dataclasses.replace(cfg, fused_norm=False))
    fast.init_params(torch.Generator(device="cuda").manual_seed(weights_seed))
    plain.load_state_dict(fast.state_dict())
    tok = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (2, 1024))).cuda()
    losses, grads = [], []
    for model in (fast, plain):
        loss, _ = causal_lm_loss(model(tok), tok)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in model.named_parameters()})
    loss_tol = 0.02
    # a key bias shifts every logit of a row by the same q.b, which the
    # softmax ignores: its true gradient is 0 and both paths give
    # rounding noise, so it is held to the whole gradient's scale
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in grads[1].values()))
    rel, zero = {}, {}
    for n, g in grads[0].items():
        diff = (g - grads[1][n]).norm()
        if n.endswith("attn.key.bias"):
            zero[n] = (diff / total).item()
        else:
            rel[n] = (diff / grads[1][n].norm().clamp_min(1e-30)).item()
    groups = {}
    for n, r in rel.items():
        groups.setdefault(_grad_group(n), {})[n] = r
    worst = {grp: max(rs, key=rs.get) for grp, rs in groups.items()}
    out = {"train_parity": {
        "batch": "2x1024", "seed": seed, "weights_seed": weights_seed,
        "loss_kernels": losses[0],
        "loss_plain": losses[1], "loss_err": abs(losses[0] - losses[1]),
        "loss_tol": loss_tol,
        "grad_rel_l2_max": {grp: groups[grp][n] for grp, n in worst.items()},
        "grad_rel_l2_worst": worst,
        "grad_rel_l2_median": float(np.median(list(rel.values()))),
        "grad_tol": GRAD_TOL, "params": len(rel),
        "key_bias_diff_over_grad_norm_max": max(zero.values()),
        "key_bias_params": len(zero)}}
    print(json.dumps(out))
    del fast, plain, grads
    torch.cuda.empty_cache()
    if not enforce:
        return out["train_parity"]
    _require(all(np.isfinite(losses)), "parity: a loss is not finite")
    _require(abs(losses[0] - losses[1]) <= loss_tol,
             f"parity: step-1 loss {losses[0]} vs plain {losses[1]}")
    for grp, n in worst.items():
        _require(groups[grp][n] <= GRAD_TOL[grp],
                 f"parity: gradient of {n} differs from the plain path by "
                 f"{groups[grp][n]:.3e} (relative L2) > {GRAD_TOL[grp]}")
    _require(max(zero.values()) <= 1e-3,
             "parity: a key bias gradient (zero by construction) is "
             f"{max(zero.values()):.3e} of the gradient norm")
    return out["train_parity"]


PARITY_FAULTS = ("dkv_last_q_tile", "ln_last_block")


@contextlib.contextmanager
def _injected_fault(name):
    """Run the training path's backward as a faulty kernel would, for
    the readings that bound the parity limits from above:
    ``dkv_last_q_tile``: B3's loop over q tiles ends one streamed tile
    early in every block (the last tile's queries, 64 at GPT-2's
    head_dim in bf16, add nothing to dK, dV);
    ``ln_last_block``: B5's column sums leave out the last block of its
    partition (``ops/layernorm.py`` ``bwd_block_of_rows``: that block's
    rows add nothing to dgamma, dbeta)."""
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import layernorm as ln

    if name == "dkv_last_q_tile":
        mod, attr = fa, "flash_bwd_dkv_cuda"
        orig = fa.flash_bwd_dkv_cuda

        def faulty(q, k, v, dout, lse, delta, causal, scale, q_off=0,
                   k_off=0):
            dk, dv = orig(q, k, v, dout, lse, delta, causal, scale, q_off,
                          k_off)
            tile = fa.dkv_q_tile(q.shape[3])  # the bf16 kernel's
            q0 = (q.shape[2] - 1) // tile * tile
            pk, pv = orig(q[:, :, q0:], k, v, dout[:, :, q0:],
                          lse[:, :, q0:], delta[:, :, q0:], causal, scale,
                          q_off + q0, k_off)
            return dk - pk, dv - pv
    elif name == "ln_last_block":
        mod, attr = ln, "layer_norm_bwd_cuda"
        orig = ln.layer_norm_bwd_cuda

        def faulty(x2, dy2, gamma, eps, rms, with_beta):
            dx, dg, db = orig(x2, dy2, gamma, eps, rms, with_beta)
            n = x2.shape[0]
            blocks = ln.bwd_blocks(n, _build.sm_count(x2.device))
            last = (ln.bwd_block_of_rows(n, blocks) == blocks - 1).to(
                x2.device)
            _, pg, pb = ln.layer_norm_bwd_ref(x2[last], dy2[last], gamma,
                                              eps, rms, with_beta)
            return dx, dg - pg, None if db is None else db - pb
    else:
        raise ValueError(f"unknown fault {name!r}")
    setattr(mod, attr, faulty)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def parity_sweep(n_seeds):
    """The readings behind the parity limits: step-1 parity on seeds
    0..n-1 (weights and batch), and on seed 0 under each injected
    fault, for the fused cross-entropy on GPT-2 medium and BERT-Large
    (``ce_parity_sweep``), GPT-2 medium's kernels and then ResNet-50's.
    Prints one summary line for each; enforces nothing."""
    ce_parity_sweep(n_seeds)
    healthy = [check_train_parity(s, weights_seed=s, enforce=False)
               for s in range(n_seeds)]
    faults = {}
    for name in PARITY_FAULTS:
        with _injected_fault(name):
            r = check_train_parity(0, enforce=False)
        faults[name] = {"grad_rel_l2_max": r["grad_rel_l2_max"],
                        "worst": r["grad_rel_l2_worst"]}
    print(json.dumps({"parity_sweep": {
        "seeds": n_seeds, "grad_tol": GRAD_TOL,
        "grad_rel_l2_max": {grp: max(r["grad_rel_l2_max"][grp]
                                     for r in healthy)
                            for grp in GRAD_TOL},
        "per_seed": [r["grad_rel_l2_max"] for r in healthy],
        "worst": [r["grad_rel_l2_worst"] for r in healthy],
        "loss_err": [r["loss_err"] for r in healthy],
        "key_bias": [r["key_bias_diff_over_grad_norm_max"]
                     for r in healthy],
        "faults": faults}}))
    del healthy
    torch.cuda.empty_cache()
    resnet_sensitivity()
    healthy = [check_resnet_parity(s, weights_seed=s, enforce=False)
               for s in range(n_seeds)]
    faults = {}
    for name in RESNET_FAULTS:
        with _injected_bn_fault(name):
            r = check_resnet_parity(0, enforce=False)
        faults[name] = {"grad_rel_l2_max": r["grad_rel_l2_max"],
                        "worst": r["grad_rel_l2_worst"],
                        "loss_err": r["loss_err"]}
    print(json.dumps({"resnet_parity_sweep": {
        "seeds": n_seeds, "grad_tol": RESNET_GRAD_TOL,
        "grad_rel_l2_max": {grp: max(r["grad_rel_l2_max"][grp]
                                     for r in healthy)
                            for grp in RESNET_GRAD_TOL},
        "per_seed": [r["grad_rel_l2_max"] for r in healthy],
        "worst": [r["grad_rel_l2_worst"] for r in healthy],
        "loss_err": [r["loss_err"] for r in healthy],
        "faults": faults}}))
    healthy = [int8_world(s, weights_seed=s, plain=False, enforce=False)
               for s in range(n_seeds)]
    faults = {name: int8_world(0, plain=False, fault=name, enforce=False)
              for name in ("drop_rank", "zero_residual")}
    print(json.dumps({"int8_parity_sweep": {
        "seeds": n_seeds, "rel_l2_tol": INT8_REL_TOL,
        "rel_l2_max": max(r["rel_l2_max"] for r in healthy),
        "per_seed_by_step": [r["rel_l2_max_by_step"] for r in healthy],
        "losses": [r["losses"] for r in healthy],
        "faults": {k: {"rel_l2_max_by_step": v["rel_l2_max_by_step"],
                       "rel_l2_by_bucket_last_step":
                           v["rel_l2_by_bucket_last_step"]}
                   for k, v in faults.items()}}}))


def profile_train_step(step, *inputs,
                       what="one GPT-2-medium training step, batch 8x1024"):
    """Where one training step's device time goes: ``torch.profiler``
    over one step; kernels by device time and the device busy share
    (kernel time over wall time, a lower bound: the profiler adds host
    time). Returns the window's kernel events."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with _profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
        t0 = time.perf_counter()
        step(*inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernel_events(prof)
    busy_us = sum(_dev_us(e) for e in kernels)
    top = sorted(kernels, key=_dev_us, reverse=True)[:12]
    groups, calls, other = {}, {}, []
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in (
            ("flash (B1-B3)", ("flash_",)),
            ("layernorm (B4, B5)", ("layernorm_", "column_sum")),
            ("gemm", ("gemm", "nvjet", "cutlass", "sm90_", "xmma")),
            ("nccl", ("nccl",)),
            ("elementwise / reduce / other", ("",)))
            if any(k in name for k in keys)))
        groups[group] = groups.get(group, 0.0) + _dev_us(e) / 1e3
        calls[group] = calls.get(group, 0) + e.count
        if group.startswith("elementwise"):
            other.append(e)
    print(json.dumps({
        "profile": what,
        "wall_ms": wall * 1e3, "device_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernels": sum(e.count for e in kernels),
        "device_ms_by_group": groups, "launches_by_group": calls,
        "layernorm_kernel_calls": {
            k: sum(e.count for e in kernels if k in e.key)
            for k in ("layernorm_fwd", "layernorm_bwd")},
        "top": [{"name": e.key[:70], "ms": _dev_us(e) / 1e3,
                 "calls": e.count} for e in top],
        "elementwise_top": [
            {"name": e.key[:300], "ms": _dev_us(e) / 1e3, "calls": e.count}
            for e in sorted(other, key=_dev_us, reverse=True)[:15]]}))
    return kernels


def train_gpt2(seed, ledger):
    """Train GPT-2 medium at full width and depth through the example's
    ``main``: world of one over NCCL, per-rank batch 8 x 1024, flash
    attention and fused norms, 1 warm-up and 5 timed steps on one
    batch. Launch counts are zeroed just before and read just after.
    Returns the tokens/s a card and every step's loss."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import gpt2_pretraining
    from horovod_tpu_torch.ops import _build

    parity = check_train_parity(seed)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    _build.reset_launches()
    per_chip, mfu = gpt2_pretraining.main(TRAIN_ARGS, stats)
    torch.cuda.synchronize()
    ledger["train"] = dict(_build.LAUNCHES)
    losses = stats["losses"]
    _require(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
             f"training losses {losses}")
    _require(losses[-1] < losses[0],
             f"training loss did not fall: {losses}")
    for name in TRAIN_KERNELS:
        _require(ledger["train"][name] > 0,
                 f"kernel {name} was not launched while training")
    print(json.dumps({
        "phase": "train", "model": "GPT-2 medium 24x1024, 16 heads",
        "params": stats["n_params"], "batch": "8x1024", "world": hvd.size(),
        "backend": "nccl", "losses": losses,
        "tokens_per_s": per_chip, "step_ms": stats["step_ms"][0],
        "mfu": mfu, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_step": {k: ledger["train"][k] / TRAIN_STEPS
                              for k in TRAIN_KERNELS},
        "parity": parity}))
    profile_train_step(stats["step"], stats["tokens"])
    stats.clear()
    hvd.shutdown()
    torch.cuda.empty_cache()
    return per_chip, losses


# ---------------------------------------------------------------------------
# phase 4b: training GPT-2 medium over the int8 wire, a world of four
# emulated on the card
# ---------------------------------------------------------------------------

INT8_STEPS = 3
#: relative L2 limit, per bucket, of the int8 wire's reduced gradient
#: (error feedback on) against the float32 mean of the four ranks'
#: gradients. It sits between the worst healthy reading over 8 seeds
#: (0.0160) and the least reading of any bucket with one rank's shard
#: dropped in B13 (0.281; ``--parity-sweep`` on an NVIDIA H100 80GB
#: HBM3, 700 W; PERF.md). Zeroing the
#: residual each step reads below the healthy readings (0.0104: error
#: feedback trades a little per-step error for no bias over steps), so
#: that fault is held by the bitwise comparison with the plain
#: composition and the CPU tests against the JAX package instead
INT8_REL_TOL = 0.04


def _rank_grads(model, params, plans, tokens):
    """Each rank's loss and gradients (packed into the plan's buckets)
    on its shard of the global batch, through the kernel path."""
    from horovod_tpu_torch.models.transformer import causal_lm_loss
    from horovod_tpu_torch.ops.fusion import pack_buckets_by_plan

    losses, grads = [], []
    for tok in tokens:
        model.zero_grad(set_to_none=True)
        loss, _ = causal_lm_loss(model(tok), tok)
        loss.backward()
        losses.append(loss.item())
        grads.append(pack_buckets_by_plan([p.grad for p in params], plans))
    return losses, grads


@contextlib.contextmanager
def _int8_fault(name):
    """``drop_rank``: B13 leaves out the last rank's shard (a fault the
    limit must catch); ``zero_residual``: the error-feedback residual is
    zeroed before every step (read for the record)."""
    from horovod_tpu_torch.ops import quantized_collectives as qc

    orig = qc.accum_rows
    if name == "drop_rank":
        def faulty(q, s, block):
            return orig(q[:-1].contiguous(), s[:-1].contiguous(), block)
        qc.accum_rows = faulty
    elif name != "zero_residual":
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        qc.accum_rows = orig


def int8_world(seed, weights_seed=0, steps=INT8_STEPS, plain=True,
               fault=None, enforce=True):
    """GPT-2 medium (24 x 1024, vocab 50257; weights from
    ``weights_seed``) trained ``steps`` AdamW steps over the int8 wire
    (block 256, error feedback) in a world of four emulated on the card:
    the example's global batch of 8 x 1024 (seed ``seed``) split into
    four rank shards of 2 x 1024 as ``gpt2_pretraining`` shards it; each
    rank's gradients from the kernel path (flash attention, fused
    norms); every bucket of the optimizer's plan through
    ``stage_quantize`` per rank, the all-to-all as slicing,
    ``stage_reduce`` per rank, the all-gather as a concatenation and
    ``stage_dequantize``, four residual sets carried. With ``plain`` the
    plain versions' composition runs beside the kernels' and every
    reduced bucket and residual of every step must be bitwise equal to
    it; the four ranks' reduced buckets must be bitwise equal; each
    bucket's relative L2 error against the float32 mean is read
    (``INT8_REL_TOL``); each of B11-B14 must launch exactly 4 x buckets
    times a step; the loss must fall. Returns the readings."""
    from horovod_tpu_torch.models.transformer import (GPT2_MEDIUM,
                                                      Transformer)
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import quantized_collectives as qc
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn
    from horovod_tpu_torch.ops.fusion import unflatten_buckets_by_plan

    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    with torch.device("cuda"):
        model = Transformer(cfg, attention_fn=make_flash_attention_fn(True))
    model.init_params(torch.Generator(device="cuda").manual_seed(
        weights_seed))
    plans, params = gpt2_medium_plan(model)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    n, block = QUANT_RANKS, QUANT_BLOCK
    # the example's global batch (seed 0: gpt2_pretraining's own), rank
    # r's shard rows [2r, 2r + 2)
    rows = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                               (2 * n, 1024))
    tokens = [torch.from_numpy(rows[2 * r:2 * r + 2]).cuda()
              for r in range(n)]
    res_k = [[None] * n for _ in plans]
    res_p = [[None] * n for _ in plans]
    losses, rel, launches, stage_ms = [], [], [], []
    cm = _int8_fault(fault) if fault else contextlib.nullcontext()
    with cm:
        for step in range(steps):
            step_losses, grads = _rank_grads(model, params, plans, tokens)
            losses.append(float(np.mean(step_losses)))
            if fault == "zero_residual":
                res_k = [[None] * n for _ in plans]
            reduced, step_rel = [], []
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            outs = [qc.emulated_quantized_psum(
                [grads[r][b] for r in range(n)], n, block,
                [torch.zeros_like(grads[0][b]) if x is None else x
                 for x in res_k[b]]) for b in range(len(plans))]
            torch.cuda.synchronize()
            stage_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append({k: _build.LAUNCHES[k] for k in QUANT_KERNELS})
            for b, (sums, errs) in enumerate(outs):
                res_k[b] = errs
                mean = sum(g[b] for g in grads) / n
                red = sums[0] / n
                step_rel.append(((red - mean).norm()
                                 / mean.norm().clamp_min(1e-30)).item())
                if enforce:
                    for r in range(1, n):
                        _require(_equal(sums[r], sums[0]),
                                 f"int8 step {step} bucket {b}: rank {r}'s "
                                 "reduced bucket differs from rank 0's")
                reduced.append(red)
            if plain:
                with _plain_quantized():
                    pouts = [qc.emulated_quantized_psum(
                        [grads[r][b] for r in range(n)], n, block,
                        [torch.zeros_like(grads[0][b]) if x is None else x
                         for x in res_p[b]]) for b in range(len(plans))]
                for b, ((sums, errs), (psums, perrs)) in enumerate(
                        zip(outs, pouts)):
                    res_p[b] = perrs
                    for r in range(n):
                        _require(_equal(sums[r], psums[r]),
                                 f"int8 step {step} bucket {b} rank {r}: "
                                 "the reduced bucket is not bitwise the "
                                 "plain composition's")
                        _require(_equal(errs[r], perrs[r]),
                                 f"int8 step {step} bucket {b} rank {r}: "
                                 "the residual is not bitwise the plain "
                                 "composition's")
                del pouts
            rel.append(step_rel)
            del outs, grads
            leaves = unflatten_buckets_by_plan(reduced, plans, len(params))
            for p, leaf in zip(params, leaves):
                p.grad = leaf.view_as(p)
            opt.step()
            opt.zero_grad(set_to_none=True)
            del reduced, leaves
    del model, opt, res_k, res_p
    torch.cuda.empty_cache()
    out = {"seed": seed, "weights_seed": weights_seed, "fault": fault,
           "buckets": len(plans), "losses": losses,
           "rel_l2_max_by_step": [max(r) for r in rel],
           "rel_l2_max": max(max(r) for r in rel),
           "rel_l2_by_bucket_last_step": rel[-1],
           "launches_by_step": launches, "stage_wall_ms": stage_ms}
    if enforce:
        want = n * len(plans)
        for step, counts in enumerate(launches):
            for k, c in counts.items():
                _require(c == want, f"int8 step {step}: {k} launched {c} "
                                    f"times, not 4 x {len(plans)} buckets")
        _require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                 f"int8 training loss did not fall: {losses}")
        _require(out["rel_l2_max"] <= INT8_REL_TOL,
                 f"int8 reduced gradient {out['rel_l2_max']:.3e} from the "
                 f"float32 mean (relative L2) > {INT8_REL_TOL}")
    return out


def profile_int8_stages():
    """Device time of one rank's int8 stages on GPT-2 medium's plan at
    world 4: each bucket's chain of B12, B13, B11, B14 on gradient-like
    data, with the exchanges left out (they are NCCL's)."""
    from horovod_tpu_torch.ops import quantized_collectives as qc

    plans, _ = gpt2_medium_plan()
    g = torch.Generator(device="cuda").manual_seed(11)
    n, block = QUANT_RANKS, QUANT_BLOCK
    flats = [torch.randn(size, generator=g, device="cuda") * 1e-3
             for size in _bucket_sizes(plans)]
    res = [torch.zeros_like(f) for f in flats]

    def one_rank():
        for f, r in zip(flats, res):
            q, s, _ = qc.stage_quantize(f, r, n, block)
            q3, s3 = qc.stage_reduce(q, s, n, block)
            qc.stage_dequantize(torch.cat([q3] * n), torch.cat([s3] * n),
                                f.numel(), block)

    one_rank()
    torch.cuda.synchronize()
    with _profiled() as prof:
        one_rank()
        torch.cuda.synchronize()
    names = (("quantize_kernel<true>", "quant_ef_rows"),
             ("quantize_kernel<false>", "quant_rows"),
             ("accum_kernel", "accum_rows"),
             ("dequant_kernel", "dequant_flat"))
    by = {}
    for e in _kernel_events(prof):
        name = next((v for k, v in names if k in e.key),
                    "copies (the emulated gather)")
        by[name] = by.get(name, 0.0) + _dev_us(e) / 1e3
    return by


def train_int8(seed, ledger):
    """(a) GPT-2 medium over the int8 wire in a world of four emulated on
    the card (``int8_world``); (b) the real ``quantized_psum`` entry
    point through NCCL in a world of one, on the largest bucket with a
    residual, bitwise against the plain composition; (c) the wire's
    byte accounting of the plan. Launch counts are zeroed just before
    (a) and (b) and read just after. Returns one rank's stage kernels'
    device ms a step at world 4."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import quantized_collectives as qc
    from horovod_tpu_torch.optim import compression as comp

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    world = int8_world(seed)
    counts = {k: sum(step[k] for step in world["launches_by_step"])
              for k in QUANT_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 1e9

    # (b) the real entry point, a world of one over NCCL
    hvd.init()
    _require(hvd.nccl_enabled() and hvd.size() == 1,
             "train_int8 (b) needs a world of one over NCCL")
    plans, _ = gpt2_medium_plan()
    big = max(_bucket_sizes(plans))
    g = torch.Generator(device="cuda").manual_seed(seed + 8)
    x = torch.randn(big, generator=g, device="cuda") * 1e-3
    r = torch.randn(big, generator=g, device="cuda") * 1e-6
    _build.reset_launches()
    y, new_r = comp.quantized_psum(x, 1, QUANT_BLOCK, residual=r)
    torch.cuda.synchronize()
    real = {k: _build.LAUNCHES[k] for k in QUANT_KERNELS}
    with _plain_quantized():
        (py,), (pr,) = qc.emulated_quantized_psum([x], 1, QUANT_BLOCK, [r])
    _require(_equal(y, py) and _equal(new_r, pr),
             "quantized_psum through NCCL is not bitwise the plain "
             "composition")
    _require(all(real[k] == 1 for k in ("quant_ef_rows", "accum_rows",
                                         "quant_rows", "dequant_flat")),
             f"quantized_psum launched {real}")
    for k in QUANT_KERNELS:
        counts[k] += real[k]
    ledger["train_int8"] = counts
    hvd.shutdown()
    del x, r, y, new_r, py, pr

    # (c) the wire's accounting of the plan (one rank's contribution)
    spec = comp.WireSpec("int8", QUANT_BLOCK, True)
    sizes = _bucket_sizes(plans)
    logical = sum(4 * k for k in sizes)
    sent = sum(comp.wire_sent_bytes(k, 4, spec) for k in sizes)
    stages = profile_int8_stages()
    print(json.dumps({
        "phase": "train_int8", "model": "GPT-2 medium 24x1024, 16 heads",
        "world": "4 emulated on one card", "batch": "4 x 2x1024",
        "wire": spec.describe(), "buckets": len(plans),
        "bucket_elements": sizes, "losses": world["losses"],
        "rel_l2_max_by_step": world["rel_l2_max_by_step"],
        "rel_l2_tol": INT8_REL_TOL,
        "rel_l2_by_bucket_last_step": world["rel_l2_by_bucket_last_step"],
        "launches_per_step": world["launches_by_step"],
        "stage_wall_ms_per_step": world["stage_wall_ms"],
        "peak_mem_gb": peak,
        "real_quantized_psum": {"elements": big, "backend": "nccl",
                                "world": 1, "bitwise": True,
                                "launches": real},
        "wire_bytes": {"logical": logical, "sent": sent,
                       "ratio": logical / sent,
                       "residual_bytes_per_rank": logical},
        "one_rank_stage_device_ms_world4": stages,
        "one_rank_stage_device_ms_total": sum(
            v for k, v in stages.items() if not k.startswith("copies"))}))
    torch.cuda.empty_cache()
    return sum(v for k, v in stages.items() if not k.startswith("copies"))


# ---------------------------------------------------------------------------
# phase 4c: BERT-Large under ZeRO-1, a world of four emulated on the card
# ---------------------------------------------------------------------------

ZERO_STEPS = 3  # float32 wire; then one step on the int8 wire
ZERO_BUCKETS = 11
ZERO_ARGS = ["--zero", "--flash", "--fused-ln", "--batch-size", "8",
             "--seq-len", "512", "--num-warmup-batches", "1",
             "--num-batches-per-iter", "3", "--num-iters", "1"]
ZERO_TRAIN_STEPS = 4  # 1 warm-up + 3 timed, as ZERO_ARGS says
#: relative L2 limit, per bucket, of the ZeRO ranks' parameter change
#: since the start against the DistributedOptimizer emulation's (the
#: mean of the four ranks' gradients summed in the same rank order, one
#: AdamW on the full parameters). Both run torch's elementwise AdamW on
#: the same averaged gradients, so they should agree bitwise; the limit
#: leaves room for an optimizer kernel that rounds an element apart
#: where a tensor's chunking differs (torch's CPU AdamW does: 1e-6
#: after 3 steps of a tiny BERT), far below a wrong shard, offset or
#: average (a change of the order of 1)
ZERO_REL_TOL = 1e-4


def _launch_snapshot():
    from horovod_tpu_torch.ops import _build

    return dict(_build.LAUNCHES)


def _launch_delta(before):
    from horovod_tpu_torch.ops import _build

    return {k: _build.LAUNCHES[k] - before.get(k, 0)
            for k in _build.LAUNCHES}


def zero_world(seed):
    """BERT-Large (24 x 1024, 16 heads, vocab 30522, seq 512; weights
    from ``seed``; bf16 compute, non-causal flash attention, fused
    norms) trained by ZeRO-1 in a world of four emulated on the card:
    the example's global batch of 8 x 512 (``synthetic_mlm_batch``),
    rank r taking rows [2r, 2r + 2); each rank keeps its own copy of the
    parameters and computes its gradients on it; each bucket of the
    11-bucket plan is packed per rank (``zero.stage_pack``: B6, 44
    launches a step, each bitwise against ``_pad_rows``), reduce-
    scattered in rank order (``emulated_scatter_buckets``), stepped by
    the rank's AdamW on its shards (``RankShards``) and all-gathered by a
    concatenation that each rank writes back (``stage_write``). Beside
    it, the DistributedOptimizer emulation on its own parameters: the
    mean of the four ranks' gradients summed in rank order, one AdamW on
    the full parameters (it takes the ranks' gradients, so the two see
    the same inputs and any difference is the optimizers'). ``ZERO_STEPS`` steps on the
    float32 wire, then one on the int8 wire (block 256, no error
    feedback: B11 and B13 44 times each, B12 and B14 never). Returns
    the readings and the main path's launch counts (the reference's
    launches taken out)."""
    from horovod_tpu_torch.examples.bert_pretraining import \
        synthetic_mlm_batch
    from horovod_tpu_torch.models.transformer import (BERT_LARGE,
                                                      Transformer, mlm_loss)
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn
    from horovod_tpu_torch.ops.fusion import (pack_buckets_by_plan,
                                              unflatten_buckets_by_plan)
    from horovod_tpu_torch.optim import zero
    from horovod_tpu_torch.optim.compression import WireSpec

    cfg = dataclasses.replace(BERT_LARGE, fused_norm=True)
    with torch.device("cuda"):
        model = Transformer(cfg, attention_fn=make_flash_attention_fn(False))
    model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    plans, params = bert_large_plan(model)
    sizes = _bucket_sizes(plans)
    n, nleaves = ZERO_RANKS, len(params)
    factory = functools.partial(torch.optim.AdamW, lr=1e-4,
                                weight_decay=1e-4)
    with torch.no_grad():
        init = pack_buckets_by_plan([p.detach() for p in params], plans)
    rank_flat = [[b.clone() for b in init] for _ in range(n)]
    rank_leaves = [unflatten_buckets_by_plan(f, plans, nleaves)
                   for f in rank_flat]
    ranks = [zero.RankShards(factory, rank_leaves[r], plans, n, r)
             for r in range(n)]
    ref_flat = [b.clone() for b in init]
    ref_opt = factory(ref_flat)
    batches = [[torch.from_numpy(a).cuda() for a in synthetic_mlm_batch(
        cfg.vocab_size, 2, 512, 0.15, r, n)] for r in range(n)]

    def grads_on(leaves, batch):
        with torch.no_grad():
            for p, v in zip(params, leaves):
                p.copy_(v)
        model.zero_grad(set_to_none=True)
        loss, _ = mlm_loss(model(batch[0]), batch[1], batch[2])
        loss.backward()
        return loss.item(), [p.grad for p in params]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    comparison = {k: 0 for k in _build.LAUNCHES}
    wires = [None] * ZERO_STEPS + [WireSpec("int8", 256, False)]
    losses, rel, bitwise_ref, packs, scatter, wall = [], [], [], [], [], []
    for step, wire in enumerate(wires):
        t0 = time.perf_counter()
        rows, step_losses, n_packs, acc = [], [], 0, []
        for r in range(n):
            loss, grads = grads_on(rank_leaves[r], batches[r])
            step_losses.append(loss)
            before = _launch_snapshot()
            rows.append([zero.stage_pack(grads, plan, n) for plan in plans])
            n_packs += _launch_delta(before)["pack_rows"]
            for b, plan in enumerate(plans):
                flat, = pack_buckets_by_plan(grads, [plan])
                _require(_bitwise(rows[r][b], zero._pad_rows(flat, n)),
                         f"zero step {step} rank {r} bucket {b}: the packed "
                         "rows are not bitwise _pad_rows")
                if wire is not None:
                    continue
                if r == 0:  # the reference's sum, in rank order
                    acc.append(flat)
                else:
                    acc[b].add_(flat)
            del grads, flat
        losses.append(float(np.mean(step_losses)))
        packs.append(n_packs)
        before = _launch_snapshot()
        shards = [zero.emulated_scatter_buckets(
            [rows[r][b] for r in range(n)], n, wire)
            for b in range(len(plans))]
        scatter.append({k: v for k, v in _launch_delta(before).items() if v})
        del rows
        for r in range(n):
            ranks[r].step([shards[b][r] for b in range(len(plans))])
        del shards
        gathered = [torch.cat([ranks[r].tensors[b] for r in range(n)])
                    for b in range(len(plans))]
        for r in range(n):
            zero.stage_write(rank_leaves[r], plans, gathered)
        del gathered
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        for r in range(1, n):
            for b in range(len(plans)):
                _require(_bitwise(rank_flat[r][b], rank_flat[0][b]),
                         f"zero step {step}: rank {r}'s bucket {b} differs "
                         "from rank 0's")
        if wire is not None:
            continue
        # the DistributedOptimizer emulation's step (its launches are
        # not the main path's)
        before = _launch_snapshot()
        for t, a in zip(ref_flat, acc):
            t.grad = a / n
        del acc
        ref_opt.step()
        ref_opt.zero_grad(set_to_none=True)
        for k, v in _launch_delta(before).items():
            comparison[k] += v
        step_rel, step_bits = [], True
        for b in range(len(plans)):
            dz = rank_flat[0][b] - init[b]
            dr = ref_flat[b] - init[b]
            step_rel.append(((dz - dr).norm()
                             / dr.norm().clamp_min(1e-30)).item())
            step_bits = step_bits and _bitwise(rank_flat[0][b], ref_flat[b])
            del dz, dr
        rel.append(step_rel)
        bitwise_ref.append(step_bits)
    torch.cuda.synchronize()
    counts = {k: _build.LAUNCHES[k] - comparison[k] for k in _build.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 1e9
    state = [rk.state_bytes() for rk in ranks]
    ref_state = zero.state_bytes(ref_opt)

    # one rank's stage kernels, device time (a probe, after the counts)
    _, grads = grads_on(rank_leaves[0], batches[0])
    probe = zero.RankShards(factory, rank_leaves[0], plans, n, 0)
    rows0 = [zero.stage_pack(grads, plan, n) for plan in plans]
    shard0 = [rw[0].clone() for rw in rows0]
    stage_ms = {
        f"pack (B6), {len(plans)} buckets": _device_ms(
            lambda _=0: [zero.ring_pack.maybe_pack_rows(
                pack_buckets_by_plan(grads, [plan])[0], n)
                for plan in plans], iters=3),
        "AdamW on the shards": _device_ms(
            lambda _=0: probe.step(shard0), iters=3),
        "write-back of the gathered buckets": _device_ms(
            lambda _=0: zero.stage_write(rank_leaves[0], plans, init),
            iters=3)}
    del grads, rows0, shard0, probe
    out = {"seed": seed, "buckets": len(plans), "bucket_elements": sizes,
           "params": sum(sizes), "losses": losses,
           "pack_launches_by_step": packs,
           "scatter_launches_by_step": scatter,
           "rel_l2_vs_distributed_by_step": [max(r) for r in rel],
           "bitwise_vs_distributed_by_step": bitwise_ref,
           "rel_l2_tol": ZERO_REL_TOL,
           "shard_state_bytes_by_rank": state,
           "replicated_state_bytes": ref_state,
           "emulated_step_wall_ms": wall, "peak_mem_gb": peak,
           "one_rank_stage_device_ms_world4": stage_ms,
           "launches": counts}
    del model, ranks, ref_opt, rank_flat, rank_leaves, ref_flat, init
    torch.cuda.empty_cache()
    _require(len(plans) == ZERO_BUCKETS and max(sizes) == 32543744,
             f"BERT-Large's plan: {len(plans)} buckets of {sizes}")
    for step, c in enumerate(packs):
        _require(c == n * len(plans), f"zero step {step}: B6 launched {c} "
                                      f"times, not 4 x {len(plans)}")
    want_int8 = {"quant_rows": n * len(plans), "accum_rows": n * len(plans)}
    _require(scatter[-1] == want_int8,
             f"the int8 step's reduce-scatter launched {scatter[-1]}, not "
             f"{want_int8} (and no B12, B14)")
    _require(all(not c for c in scatter[:-1]),
             f"the float32 reduce-scatter launched kernels: {scatter}")
    _require(all(np.isfinite(losses)) and losses[ZERO_STEPS - 1] < losses[0],
             f"ZeRO training loss did not fall: {losses}")
    worst = max(out["rel_l2_vs_distributed_by_step"])
    _require(worst <= ZERO_REL_TOL,
             f"ZeRO parameters {worst:.3e} (relative L2 of the change) from "
             f"the DistributedOptimizer emulation > {ZERO_REL_TOL}")
    for r, b in enumerate(state):
        _require(abs(b / ref_state - 1 / n) < 1e-3,
                 f"rank {r}'s shard state {b} bytes is not 1/{n} of the "
                 f"replicated {ref_state}")
    return out


def train_zero(seed, ledger):
    """(a) BERT-Large under ZeRO-1 in a world of four emulated on the card
    (``zero_world``); (b) the example's ``main`` with ``--zero --flash
    --fused-ln`` at world 1 over NCCL, batch 8 x 512, 1 warm-up and 3
    timed steps: B6 must not launch (a world of one packs nothing);
    (c) the ``matmul_reduce_scatter`` entry point at world 1 over NCCL
    on shape (a) of ``MATMUL_CASES``, bitwise against ``matmul_pack``
    divided by 1. Launch counts are zeroed just before each and read
    just after."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import bert_pretraining
    from horovod_tpu_torch.ops import _build, ring_pack

    torch.cuda.empty_cache()
    world = zero_world(seed)
    counts = dict(world.pop("launches"))
    ce_parity = check_ce_parity("bert", seed)

    # (b) the real entry point
    torch.cuda.empty_cache()
    stats = {}
    _build.reset_launches()
    per_chip, mfu = bert_pretraining.main(ZERO_ARGS, stats)
    torch.cuda.synchronize()
    real = dict(_build.LAUNCHES)
    losses = stats["losses"]
    _require(hvd.size() == 1 and hvd.nccl_enabled(),
             "train_zero (b) needs a world of one over NCCL")
    _require(len(losses) == ZERO_TRAIN_STEPS and all(np.isfinite(losses))
             and losses[-1] < losses[0],
             f"BERT-Large --zero losses did not fall: {losses}")
    _require(real["pack_rows"] == 0,
             f"B6 launched {real['pack_rows']} times at world 1")
    for name in TRAIN_KERNELS:
        _require(real[name] > 0, f"kernel {name} was not launched by the "
                                 "BERT-Large example")
    profile_train_step(stats.pop("step"), *stats.pop("batch"),
                       what="one BERT-Large --zero training step at world "
                            "1, batch 8x512")
    torch.cuda.empty_cache()

    # (b') the same with the fused cross-entropy
    torch.cuda.reset_peak_memory_stats()
    fused = {}
    _build.reset_launches()
    fused_per_chip, fused_mfu = bert_pretraining.main(
        ZERO_ARGS + ["--fused-ce"], fused)
    torch.cuda.synchronize()
    fused_real = dict(_build.LAUNCHES)
    _require(len(fused["losses"]) == ZERO_TRAIN_STEPS
             and all(np.isfinite(fused["losses"]))
             and fused["losses"][-1] < fused["losses"][0],
             f"BERT-Large --zero --fused-ce losses did not fall: "
             f"{fused['losses']}")
    _require(fused_real["pack_rows"] == 0,
             f"B6 launched {fused_real['pack_rows']} times at world 1")
    _exact_launches(fused_real, ZERO_TRAIN_STEPS, "BERT-Large --fused-ce")
    fused_stats = {
        "args": ZERO_ARGS + ["--fused-ce"], "losses": fused["losses"],
        "tokens_per_s": fused_per_chip, "step_ms": fused["step_ms"][0],
        "mfu": fused_mfu, "peak_mem_gb": fused["peak_mem_gb"],
        "launches_per_step": {k: fused_real[k] / ZERO_TRAIN_STEPS
                              for k in STEP_LAUNCHES}, "parity": ce_parity}
    fused.clear()
    hvd.shutdown()
    torch.cuda.empty_cache()

    # (c) matmul_reduce_scatter at world 1
    hvd.init()
    _, m, kd, ncols, dtype, _ = MATMUL_CASES[0]
    g = torch.Generator(device="cuda").manual_seed(seed + 12)
    a = torch.randn(m, kd, generator=g, device="cuda").to(dtype)
    b = torch.randn(kd, ncols, generator=g, device="cuda").to(dtype)
    _build.reset_launches()
    shard = ring_pack.matmul_reduce_scatter(a, b, 1)
    torch.cuda.synchronize()
    mrs = dict(_build.LAUNCHES)
    want = ring_pack.matmul_pack_cuda(a, b, 1).reshape(-1) / 1
    _require(_bitwise(shard, want),
             "matmul_reduce_scatter through NCCL is not matmul_pack / 1")
    _require(mrs["matmul_pack"] == 1,
             f"matmul_reduce_scatter launched {mrs}")
    hvd.shutdown()
    del a, b, shard, want
    torch.cuda.empty_cache()

    ledger["train_zero"] = {k: counts[k] + real[k] + fused_real[k] + mrs[k]
                            for k in counts}
    print(json.dumps({
        "phase": "train_zero", "model": "BERT-Large 24x1024, 16 heads, "
        "vocab 30522, seq 512", "world": "4 emulated on one card",
        "batch": "4 x 2x512", **world,
        "example": {"args": ZERO_ARGS, "world": 1, "backend": "nccl",
                    "losses": losses, "tokens_per_s": per_chip,
                    "step_ms": stats["step_ms"][0], "mfu": mfu,
                    "peak_mem_gb": stats["peak_mem_gb"],
                    "optimizer_state_bytes": stats[
                        "optimizer_state_bytes"],
                    "buckets": stats["buckets"], "launches": real},
        "example_fused_ce": fused_stats,
        "matmul_reduce_scatter": {
            "shape": MATMUL_CASES[0][0], "world": 1, "backend": "nccl",
            "bitwise_vs_matmul_pack": True, "launches": {
                k: v for k, v in mrs.items() if v}}}))


# ---------------------------------------------------------------------------
# phase 4d: training GPT-2 medium with the fused cross-entropy at bench.py's
# cell (batch 16 x 1024, --flash --fused-ce)
# ---------------------------------------------------------------------------

FUSED_CE_ARGS = ["--batch-size", "16", "--seq-len", "1024",
                 "--num-warmup-batches", "1", "--num-batches-per-iter", "5",
                 "--num-iters", "1", "--flash", "--fused-norm", "--fused-ce"]
FUSED_CE_STEPS = 6  # 1 warm-up + 5 timed, as FUSED_CE_ARGS says
#: kernel launches a training step of GPT-2 medium or BERT-Large makes:
#: the 24 layers' attention, and 49 norms (two a layer and the last one)
STEP_LAUNCHES = {"flash_fwd": 24, "flash_bwd_dq": 24, "flash_bwd_dkv": 24,
                 "layernorm_fwd": 49, "layernorm_bwd": 49}

#: limits of the step-1 check of the fused LM head + loss against the
#: unfused head + model loss on one model (relative L2 per parameter, by
#: group; the loss absolute). The unfused head rounds its logits to bf16
#: (the JAX model's head does too) and the fused one keeps them float32,
#: so the two differ by that rounding, most in the tied embedding's
#: gradient. Each limit sits between the worst healthy reading over 8
#: seeds and the least faulty one (``--parity-sweep``; PERF.md)
CE_GRAD_TOL = {"tok_emb": 2e-2, "rest": 3e-2}
CE_LOSS_TOL = 1e-3


def check_ce_parity(kind, seed, weights_seed=0, enforce=True):
    """Step-1 loss and every parameter's gradient with the fused LM head
    + loss (``fused_causal_lm_loss`` for ``kind`` "gpt2", GPT-2 medium
    on a 2 x 1024 batch; ``fused_linear_cross_entropy`` with the MLM mask
    for "bert", BERT-Large on a 2 x 512 batch with a 15% mask) against the
    unfused head and ``causal_lm_loss`` / ``mlm_loss``, on one model with
    flash attention and fused norms and the weights from
    ``weights_seed``. With ``enforce=False`` it only prints the
    readings."""
    from horovod_tpu_torch.models.transformer import (BERT_LARGE,
                                                      GPT2_MEDIUM,
                                                      Transformer,
                                                      causal_lm_loss,
                                                      mlm_loss)
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn
    from horovod_tpu_torch.ops.fused_cross_entropy import (
        fused_causal_lm_loss, fused_linear_cross_entropy)

    gpt2 = kind == "gpt2"
    cfg = dataclasses.replace(GPT2_MEDIUM if gpt2 else BERT_LARGE,
                              fused_norm=True)
    with torch.device("cuda"):
        model = Transformer(cfg, attention_fn=make_flash_attention_fn(gpt2))
    model.init_params(torch.Generator(device="cuda").manual_seed(weights_seed))
    rs = np.random.RandomState(seed)
    t = 1024 if gpt2 else 512
    tok = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, t))).cuda()
    labels = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, t))).cuda()
    mask = torch.from_numpy(rs.rand(2, t) < 0.15).cuda()
    w = model.tok_emb.embedding

    def fused():
        hidden = model(tok, return_hidden=True)
        if gpt2:
            return fused_causal_lm_loss(hidden, w.t(), tok)[0]
        return fused_linear_cross_entropy(hidden, w.t(), labels,
                                          valid=mask)[0]

    def plain():
        if gpt2:
            return causal_lm_loss(model(tok), tok)[0]
        return mlm_loss(model(tok), labels, mask)[0]

    losses, grads = [], []
    for fn in (fused, plain):
        model.zero_grad(set_to_none=True)
        loss = fn()
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in grads[1].values()))
    rel, zero = {}, {}
    for n, g in grads[0].items():
        diff = (g - grads[1][n]).norm()
        if n.endswith("attn.key.bias"):  # a zero true gradient
            zero[n] = (diff / total).item()
        else:
            rel[n] = (diff / grads[1][n].norm().clamp_min(1e-30)).item()
    groups = {}
    for n, r in rel.items():
        groups.setdefault("tok_emb" if n.startswith("tok_emb.") else "rest",
                          {})[n] = r
    worst = {grp: max(rs_, key=rs_.get) for grp, rs_ in groups.items()}
    out = {"ce_parity": {
        "model": "GPT-2 medium" if gpt2 else "BERT-Large",
        "batch": f"2x{t}", "seed": seed, "weights_seed": weights_seed,
        "loss_fused": losses[0], "loss_plain": losses[1],
        "loss_err": abs(losses[0] - losses[1]), "loss_tol": CE_LOSS_TOL,
        "grad_rel_l2_max": {grp: groups[grp][n] for grp, n in worst.items()},
        "grad_rel_l2_worst": worst,
        "grad_rel_l2_median": float(np.median(list(rel.values()))),
        "grad_tol": CE_GRAD_TOL, "params": len(rel),
        "key_bias_diff_over_grad_norm_max": max(zero.values())}}
    print(json.dumps(out))
    del model, grads
    torch.cuda.empty_cache()
    if not enforce:
        return out["ce_parity"]
    _require(all(np.isfinite(losses)), "ce parity: a loss is not finite")
    _require(abs(losses[0] - losses[1]) <= CE_LOSS_TOL,
             f"ce parity ({kind}): step-1 loss {losses[0]} vs unfused "
             f"{losses[1]}")
    for grp, n in worst.items():
        _require(groups[grp][n] <= CE_GRAD_TOL[grp],
                 f"ce parity ({kind}): gradient of {n} differs from the "
                 f"unfused head by {groups[grp][n]:.3e} (relative L2) > "
                 f"{CE_GRAD_TOL[grp]}")
    _require(max(zero.values()) <= 1e-3,
             f"ce parity ({kind}): a key bias gradient (zero by "
             f"construction) is {max(zero.values()):.3e} of the gradient "
             "norm")
    return out["ce_parity"]


def ce_parity_sweep(n_seeds):
    """The readings behind ``CE_GRAD_TOL`` and ``CE_LOSS_TOL``: the step-1
    check on seeds 0..n-1 (weights and batch) and on seed 0 under each of
    ``CE_FAULTS``, for GPT-2 medium and BERT-Large. Enforces nothing."""
    for kind in ("gpt2", "bert"):
        healthy = [check_ce_parity(kind, s, weights_seed=s, enforce=False)
                   for s in range(n_seeds)]
        faults = {}
        for name in CE_FAULTS:
            with _injected_ce_fault(name):
                r = check_ce_parity(kind, 0, enforce=False)
            faults[name] = {"grad_rel_l2_max": r["grad_rel_l2_max"],
                            "loss_err": r["loss_err"]}
        print(json.dumps({"ce_parity_sweep": {
            "model": kind, "seeds": n_seeds, "grad_tol": CE_GRAD_TOL,
            "loss_tol": CE_LOSS_TOL,
            "grad_rel_l2_max": {grp: max(r["grad_rel_l2_max"][grp]
                                         for r in healthy)
                                for grp in CE_GRAD_TOL},
            "loss_err_max": max(r["loss_err"] for r in healthy),
            "per_seed": [r["grad_rel_l2_max"] for r in healthy],
            "worst": [r["grad_rel_l2_worst"] for r in healthy],
            "faults": faults}}))


def _exact_launches(counts, steps, what):
    for name, per_step in STEP_LAUNCHES.items():
        _require(counts[name] == per_step * steps,
                 f"{what}: kernel {name} launched {counts[name]} times in "
                 f"{steps} steps, not {per_step} a step")


def train_gpt2_fused_ce(seed, ledger):
    """Train GPT-2 medium at bench.py's cell through the example's
    ``main``: world of one over NCCL, batch 16 x 1024, flash attention,
    fused norms and the fused cross-entropy, 1 warm-up and 5 timed steps
    on one batch, after the step-1 check of the fused head + loss
    against the unfused one. Launch counts are zeroed just before and
    read just after, and must be exactly ``STEP_LAUNCHES`` a step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import gpt2_pretraining
    from horovod_tpu_torch.ops import _build

    parity = check_ce_parity("gpt2", seed)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    _build.reset_launches()
    per_chip, mfu = gpt2_pretraining.main(FUSED_CE_ARGS, stats)
    torch.cuda.synchronize()
    ledger["train_fused_ce"] = dict(_build.LAUNCHES)
    losses = stats["losses"]
    _require(len(losses) == FUSED_CE_STEPS and all(np.isfinite(losses))
             and losses[-1] < losses[0],
             f"GPT-2 --fused-ce losses did not fall: {losses}")
    _exact_launches(ledger["train_fused_ce"], FUSED_CE_STEPS,
                    "GPT-2 --fused-ce")
    print(json.dumps({
        "phase": "train_fused_ce", "model": "GPT-2 medium 24x1024, 16 heads",
        "args": FUSED_CE_ARGS, "params": stats["n_params"],
        "batch": "16x1024", "world": hvd.size(), "backend": "nccl",
        "losses": losses, "tokens_per_s": per_chip,
        "step_ms": stats["step_ms"][0], "mfu": mfu,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_step": {k: ledger["train_fused_ce"][k] / FUSED_CE_STEPS
                              for k in STEP_LAUNCHES},
        "parity": parity}))
    profile_train_step(stats["step"], stats["tokens"],
                       what="one GPT-2-medium --fused-ce training step, "
                            "batch 16x1024")
    stats.clear()
    hvd.shutdown()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4e: GPT-2 medium through the port's launcher
# ---------------------------------------------------------------------------

#: phase 4's arguments with 3 timed steps (1 warm-up + 3)
LAUNCH_ARGS = ["--batch-size", "8", "--seq-len", "1024",
               "--num-warmup-batches", "1", "--num-batches-per-iter", "3",
               "--num-iters", "1", "--flash", "--fused-norm"]
LAUNCH_STEPS = 4  # 1 warm-up + 3 timed, as LAUNCH_ARGS says
#: one step, no warm-up: what ``launched_step`` runs in ``runner.run``'s
#: worker
RUN_ARGS = ["--batch-size", "8", "--seq-len", "1024",
            "--num-warmup-batches", "0", "--num-batches-per-iter", "1",
            "--num-iters", "1", "--flash", "--fused-norm"]
#: seconds within which ``-np 2`` on one card must have exited: rank 1
#: spawns, imports torch and the package and fails in ``init()``; the
#: launcher then stops rank 0 (SIGTERM, SIGKILL after 5 s)
REFUSAL_BOUND_S = 90.0
#: a subprocess of this phase that runs longer fails the smoke
LAUNCH_TIMEOUT_S = 300.0


def _launcher(*args):
    return [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *args]


def _gpt2(*args):
    return [sys.executable, "-m", "horovod_tpu_torch.examples.gpt2_pretraining",
            *args]


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    return env


def _stream(argv, timeout=LAUNCH_TIMEOUT_S, env_extra=None):
    """Run ``argv`` (a launcher command line) from the checkout's root,
    with ``env_extra`` added to the environment, its stderr merged into
    its stdout, and stamp each line with the seconds since the start:
    ``(exit code, [(seconds, line)], wall seconds)``. Past ``timeout``
    the launcher gets SIGTERM, which stops its workers too, then
    SIGKILL; the smoke fails."""
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=HERE,
                            env=dict(_child_env(), **(env_extra or {})),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines = []

    def pump():
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        raise SmokeFailure(f"{' '.join(argv[2:5])} ... ran over {timeout} s:"
                           + "\n".join(l for _, l in lines[-20:]))
    reader.join(timeout=30)
    return rc, lines, time.perf_counter() - t0


def _first(lines, prefix):
    return next(((t, l) for t, l in lines if l.startswith(prefix)),
                (None, None))


def launched_step():
    """``runner.run``'s function: one GPT-2 medium step through the
    example's ``main`` in the launched worker (``RUN_ARGS``), its launch
    counts zeroed just before and read just after. Runs in the worker,
    which imports this file as the module ``chip_smoke``."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import gpt2_pretraining
    from horovod_tpu_torch.ops import _build

    stats = {}
    _build.reset_launches()
    gpt2_pretraining.main(RUN_ARGS, stats)
    torch.cuda.synchronize()
    out = {"device": str(hvd.device()), "backend": dist.get_backend(),
           "size": hvd.size(), "launches": dict(_build.LAUNCHES),
           "losses": stats["losses"], "step_ms": stats["step_ms"]}
    stats.clear()
    hvd.shutdown()
    return out


def launch_gpt2(ledger, in_process_rate, in_process_losses):
    """Phase 4e: GPT-2 medium through ``horovod_tpu_torch.runner``, the
    launcher's command line and its ``run()`` API; the one-card refusal
    of ``-np 2``; ``--check-build``. The launched runs start from phase
    4's seed, weights and batch, so their losses are phase 4's: the
    ``run()`` step's bitwise, the command line's as printed."""
    import importlib

    from horovod_tpu_torch.runner import run

    # the parent holds the earlier phases' cache; a child needs ~20 GB
    torch.cuda.empty_cache()
    report = {"phase": "launch", "model": "GPT-2 medium 24x1024, 16 heads",
              "batch": "8x1024"}

    # (1) the command line, one slot
    rc, lines, wall = _stream(_launcher("-np", "1", "-H", "localhost:1",
                                        *_gpt2(*LAUNCH_ARGS)))
    for t, line in lines:
        print(f"launch -np 1 +{t:.2f} s: {line}")
    _require(rc == 0, "launch -np 1: exit %d:\n%s"
             % (rc, "\n".join(l for _, l in lines[-30:])))
    first_s, _ = _first(lines, "[0]GPT-2 24L/1024H")
    _, rate_line = _first(lines, "[0]tokens/sec on 1 rank(s): ")
    _require(first_s is not None and rate_line is not None,
             "launch -np 1: no [0]-prefixed header or rate line:\n"
             + "\n".join(l for _, l in lines[-30:]))
    launched_rate = float(rate_line.split(": ")[1].split()[0])
    # the example prints iter 0's last step: step LAUNCH_STEPS
    _, iter_line = _first(lines, "[0]iter 0: ")
    want = f"(loss {in_process_losses[LAUNCH_STEPS - 1]:.3f})"
    _require(iter_line is not None and iter_line.endswith(want),
             f"launch -np 1: [0]iter 0 line {iter_line!r}, phase 4's "
             f"step {LAUNCH_STEPS} prints {want}")
    report["cli"] = {
        "argv": "launch -np 1 -H localhost:1 gpt2_pretraining "
                + " ".join(LAUNCH_ARGS),
        "rc": rc, "wall_s": wall, "launch_to_first_step_s": first_s,
        "iter0_loss": iter_line.rsplit("(loss ", 1)[1].rstrip(")"),
        "in_process_step_loss": in_process_losses[LAUNCH_STEPS - 1],
        "tokens_per_s": launched_rate,
        "in_process_tokens_per_s": in_process_rate,
        "launched_over_in_process": launched_rate / in_process_rate}

    # (2) run(fn, np=1): fn pickles by reference, so it must come from a
    # module the worker can import, not from __main__
    smoke = importlib.import_module("chip_smoke")
    t0 = time.perf_counter()
    res = run(smoke.launched_step, np=1, env=_child_env())[0]
    run_s = time.perf_counter() - t0
    _require(res["device"] == "cuda:0" and res["backend"] == "nccl"
             and res["size"] == 1,
             f"run(fn, np=1): device {res['device']}, backend "
             f"{res['backend']}, world {res['size']}")
    _require(res["losses"] == in_process_losses[:1],
             f"run(fn, np=1): losses {res['losses']}, phase 4's step 1 "
             f"{in_process_losses[0]!r}")
    _exact_launches(res["launches"], 1, "run(fn, np=1)")
    ledger["launch_run"] = res["launches"]
    report["run"] = {"wall_s": run_s, **{k: res[k] for k in (
        "device", "backend", "size", "losses", "step_ms")},
        "in_process_step1_loss": in_process_losses[0],
        "launches": {k: res["launches"][k] for k in STEP_LAUNCHES}}

    # (3) two slots on this host
    cards = torch.cuda.device_count()
    rc, lines, wall = _stream(_launcher("-np", "2", "-H", "localhost:2",
                                        *_gpt2(*LAUNCH_ARGS)))
    text = "\n".join(l for _, l in lines)
    if cards < 2:
        # rank 0 waits in init() for rank 1, which has no card: no step
        # may run, and rank 1 must not go on without one
        trained = [l for _, l in lines
                   if re.match(r"\[\d\](iter |tokens/sec)|\[1\]GPT-2 ", l)]
        _require(rc != 0 and wall < REFUSAL_BOUND_S and not trained
                 and "[1]RuntimeError: horovod_tpu_torch.init(): local "
                     "rank 1 needs card cuda:1, but 1 card(s) are visible"
                 in text,
                 f"launch -np 2 on one card: exit {rc} after {wall:.1f} s "
                 f"(bound {REFUSAL_BOUND_S} s), lines of training "
                 f"{trained}:\n" + "\n".join(l for _, l in lines[-30:]))
        report["np2_one_card"] = {
            "rc": rc, "wall_s": wall, "bound_s": REFUSAL_BOUND_S,
            "rank1_error": next(l for _, l in lines
                                if "needs card cuda:1" in l)}
    else:
        _require(rc == 0 and "[0]tokens/sec on 2 rank(s)" in text,
                 f"launch -np 2 on {cards} cards: exit {rc}:\n"
                 + "\n".join(l for _, l in lines[-30:]))
        report["np2_nccl"] = {"rc": rc, "wall_s": wall}

    # (4) --check-build on the card
    rc, lines, _ = _stream(_launcher("--check-build"), timeout=120)
    text = "\n".join(l for _, l in lines)
    for need in ("[X] NCCL", "[X] CUDA", "[X] nvcc"):
        _require(rc == 0 and need in text,
                 f"--check-build: no {need!r} (exit {rc}):\n{text}")
    report["check_build"] = [l.strip() for _, l in lines if "[" in l]
    print(json.dumps(report))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4f: GPT-2 medium with fully-sharded parameters (FSDP / ZeRO-3) and
# the backward-interleaved overlap scheduler
# ---------------------------------------------------------------------------

FSDP_STEPS = 3
#: steps timed after the checked ones (world 1), for the median step time
FSDP_TIMED_STEPS = 5
FSDP_RANKS = 4
#: the FSDP knobs of each mode (ops/overlap.fsdp_staged_value_and_grad)
FSDP_MODES = (
    ("regather", dict(regather=True, prefetch=1, offload=False)),
    ("saved", dict(regather=False, prefetch=1, offload=False)),
    ("prefetch0", dict(regather=True, prefetch=0, offload=False)),
    ("prefetch2", dict(regather=True, prefetch=2, offload=False)),
    ("offload", dict(regather=True, prefetch=1, offload=True)))
FSDP_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                "layernorm_fwd", "layernorm_bwd", "pack_rows",
                "quant_ef_rows", "accum_rows")
#: ``torch.cuda._sleep`` cycles put on the side stream before each
#: exchange in the stream-ordering checks: ~20 ms at the H100's boost
#: clock, more than a block's forward at 2 x 1024
FSDP_DELAY_CYCLES = 40_000_000


def _fsdp_launches(cfg, buckets, regather, steps, ranks=1, int8=False):
    """Each kernel's launches over ``steps`` steps of ``ranks`` ranks, from
    the stage plan (embed, one stage a block, head): a block stage's
    forward runs B1 once and B4 twice, twice under regather (the forward
    without grad, then the recompute), its backward B2, B3 once and B5
    twice; the head B4 and B5 once. Each bucket is packed (B6) once a
    rank; the int8 wire with error feedback quantizes it with the
    residual (B12) and sums the ranks' codes (B13) once."""
    L = cfg.num_layers
    fwd = 2 if regather else 1
    per = {"flash_fwd": fwd * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
           "layernorm_fwd": fwd * 2 * L + 1, "layernorm_bwd": 2 * L + 1,
           "pack_rows": buckets, "quant_ef_rows": buckets if int8 else 0,
           "accum_rows": buckets if int8 else 0}
    return {k: v * steps * ranks for k, v in per.items()}


def _launch_check(counts, want, what):
    from horovod_tpu_torch.ops import _build

    for name in _build.LAUNCHES:
        _require(counts.get(name, 0) == want.get(name, 0),
                 f"{what}: kernel {name} launched {counts.get(name, 0)} "
                 f"times, not {want.get(name, 0)}")


def _first_difference(got, want):
    """``None`` when the named tensors are bitwise equal, else the names
    that differ, the worst by relative L2 first, with its largest
    difference and relative L2."""
    worst, names = None, []
    for name, w in want.items():
        g = got[name]
        if not _bitwise(g, w):
            d = (g.float() - w.float())
            rel = (d.norm() / w.float().norm().clamp_min(1e-30)).item()
            names.append(name)
            if worst is None or rel > worst["rel_l2"]:
                worst = {"param": name, "max_abs": d.abs().max().item(),
                         "rel_l2": rel}
    return None if worst is None else {**worst, "differ": names}


def _set_fsdp_knobs(knobs, regather, prefetch, offload):
    knobs.fsdp_regather, knobs.fsdp_prefetch = regather, prefetch
    knobs.fsdp_offload = offload


def fsdp_world_one(in_process_losses, in_process_rate):
    """(a) GPT-2 medium (batch 8 x 1024, ``--flash --fused-norm``, AdamW,
    seed 0) through ``make_lm_train_step`` with a FullyShardedOptimizer
    at world 1 over NCCL, 3 steps in each mode, against the
    DistributedOptimizer step on the same seed, weights and batch:
    phase 4's losses and the parameters after 3 steps, bitwise. Launch
    counts zeroed just before each mode and read just after, exact from
    the stage plan. Returns the readings and the summed launches."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.examples.gpt2_pretraining import synthetic_tokens
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn

    hvd.init()
    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    factory = functools.partial(torch.optim.AdamW, lr=1e-4,
                                weight_decay=1e-4)
    flash = make_flash_attention_fn(causal=True)
    tokens = torch.from_numpy(synthetic_tokens(
        cfg.vocab_size, 8, 1024, 0, 1)).cuda()
    model, step = hvd.make_lm_train_step(cfg, factory, attention_fn=flash)
    ref_losses = [float(step(tokens)) for _ in range(FSDP_STEPS)]
    ref = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, step
    torch.cuda.empty_cache()
    _require(ref_losses == in_process_losses[:FSDP_STEPS],
             f"the DistributedOptimizer step's losses {ref_losses} are not "
             f"phase 4's {in_process_losses[:FSDP_STEPS]}")
    knobs = global_state().knobs
    total, modes = {}, {}
    for name, kw in FSDP_MODES:
        _set_fsdp_knobs(knobs, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        _, fstep = hvd.make_lm_train_step(
            cfg, hvd.FullyShardedOptimizer(factory), attention_fn=flash)
        losses = [float(fstep(tokens)) for _ in range(FSDP_STEPS)]
        counts = dict(_build.LAUNCHES)
        layout, vag = fstep.layout, fstep.vag
        want = _fsdp_launches(cfg, len(layout.plans), kw["regather"],
                              FSDP_STEPS)
        _launch_check(counts, want, f"FSDP world 1, {name}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        parts = _first_difference(fstep.state_dict(), ref)
        _require(parts is None and losses == ref_losses,
                 f"FSDP world 1, {name}: not bitwise the "
                 f"DistributedOptimizer step: {parts}, losses {losses} vs "
                 f"{ref_losses}")
        if name in ("regather", "saved"):
            profile_train_step(fstep, tokens, what="one FSDP step at "
                               f"world 1 ({name}), batch 8x1024")
        secs = []
        for _ in range(FSDP_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fstep(tokens)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        step_s = float(np.median(secs))
        modes[name] = {
            "losses": losses, "bitwise_losses": True,
            "bitwise_params": True,
            "step_ms": step_s * 1e3, "step_ms_all": [x * 1e3 for x in secs],
            "tokens_per_s": 8 * 1024 / step_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "param_bytes": vag.param_bytes,
            "peak_param_bytes": vag.peak_param_bytes,
            "regather_bytes": vag.regather_bytes,
            "offload_bytes": vag.offload_bytes,
            "launches_per_step": {k: counts[k] / FSDP_STEPS
                                  for k in FSDP_KERNELS}}
        _require((vag.offload_bytes > 0) == kw["offload"],
                 f"FSDP world 1, {name}: offloaded {vag.offload_bytes} B")
        del fstep, vag
        torch.cuda.empty_cache()
    _set_fsdp_knobs(knobs, True, 1, False)
    hvd.shutdown()
    return {"ref_losses": ref_losses,
            "phase4_tokens_per_s": in_process_rate,
            "buckets": len(layout.plans), "modes": modes}, total


def _emulated_fsdp(cfg, init_named, batches, wire, mode, steps,
                   side=None, snapshot=False, pack_check=False):
    """FSDP on GPT-2 medium in a world of ``FSDP_RANKS`` emulated on the
    card (``EmulatedWorld``: each rank keeps only its rows; a gather is
    the concatenation of the ranks' rows, issued on a side stream with
    events; the reduce-scatter ``zero.emulated_scatter_buckets``, with the
    residuals on the int8 wire), each rank's loss its own mean.
    ``mode`` is ``"upfront"`` (the gathered reference) or one of
    ``FSDP_MODES``. Returns the losses, the final shards and residuals
    (and step 1's with ``snapshot``), the figures of one rank's last
    step, and the launches."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      causal_lm_loss)
    from horovod_tpu_torch.ops import _build, overlap, ring_pack
    from horovod_tpu_torch.optim import fsdp, zero
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn

    n = FSDP_RANKS
    comp = hvd.Compression.int8 if wire is not None else \
        hvd.Compression.none
    factory = functools.partial(torch.optim.AdamW, lr=1e-4,
                                weight_decay=1e-4)
    opts = [fsdp.FullyShardedOptimizer(factory, init_named,
                                       compression=comp, world=n, rank=r)
            for r in range(n)]
    with torch.device("meta"):
        model = Transformer(cfg, attention_fn=make_flash_attention_fn(True))

    def stages_fn(tok):
        return overlap.transformer_lm_stages(
            model, tok, lambda lg: causal_lm_loss(lg, tok)[0])

    kw = {} if mode == "upfront" else dict(FSDP_MODES)[mode]
    vag = fsdp.fsdp_value_and_grad(
        stages_fn, opts[0], opts[0].layout,
        mode="upfront" if mode == "upfront" else "prefetch", **kw)
    world = overlap.EmulatedWorld(n, wire)
    packs = []
    orig = ring_pack.maybe_pack_rows
    if pack_check:
        def checked(bucket, k):
            rows = orig(bucket, k)
            packs.append(_bitwise(rows, zero._pad_rows(bucket, k)))
            return rows
        ring_pack.maybe_pack_rows = checked
    losses, snap = [], None
    torch.cuda.synchronize()
    _build.reset_launches()
    try:
        for t in range(steps):
            world.shards = [o.shards for o in opts]
            outs = [vag(o.shards, batches[r], opt_state=o.opt_state,
                        exchange=world.rank(r),
                        side=side(r) if side else None)
                    for r, o in enumerate(opts)]
            world.resolve()
            for o, (_, g) in zip(opts, outs):
                o.step(g)
                o.zero_grad()
            losses.append([loss.item() for loss, _ in outs])
            ring_pack.maybe_pack_rows = orig
            if snapshot and t == 0:
                snap = _fsdp_state(opts)
            del outs
    finally:
        ring_pack.maybe_pack_rows = orig
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    out = {"losses": losses, "final": _fsdp_state(opts), "step1": snap,
           "launches": counts, "packs_bitwise": packs,
           "layout": opts[0].layout,
           "state_bytes": [o.shard_state_bytes() for o in opts]}
    if mode != "upfront":
        out.update(peak_param_bytes=vag.peak_param_bytes,
                   param_bytes=vag.param_bytes,
                   offload_bytes=vag.offload_bytes,
                   regather_bytes=vag.regather_bytes,
                   issue_log=vag.issue_log, gather_log=vag.gather_log)
    del opts, vag, world
    torch.cuda.empty_cache()
    return out


def _faulty_side(drop=None):
    """A side stream with the faults of phase 4f (c): each exchange
    behind a spin of ``FSDP_DELAY_CYCLES`` on the side stream, each
    gather's output filled with NaN on the compute stream before it is
    issued, and the compute stream's wait on ``drop`` (``(kind,
    bucket)``) left out."""
    from horovod_tpu_torch.ops import overlap

    class FaultySide(overlap.SideStream):
        def issue(self, start):
            def delayed():
                torch.cuda._sleep(FSDP_DELAY_CYCLES)
                return start()
            return super().issue(delayed)

        def consume(self, pending, kind, bucket):
            if (kind, bucket) != drop or pending.event is None:
                return super().consume(pending, kind, bucket)
            out = pending.finish()
            for t in overlap._tensors(out):
                t.record_stream(torch.cuda.current_stream())
            return out

        def empty(self, n, dtype):
            return super().empty(n, dtype).fill_(float("nan"))

    return FaultySide("cuda")


def _fsdp_state(opts):
    return {"shards": [[s.detach().clone() for s in o.shards] for o in opts],
            "res": [[r.clone() for r in o.residuals] if o.residuals else []
                    for o in opts]}


def _same_state(a, b):
    return all(_bitwise(x, y)
               for key in ("shards", "res")
               for xs, ys in zip(a[key], b[key]) for x, y in zip(xs, ys))


def _zero1_emulated(cfg, init_state, layout, batches, steps):
    """ZeRO-1 on the same world and buckets (``layout``'s plan;
    ``zero_world``'s stage functions): each rank's replica and monolithic
    backward, the pack (B6), the emulated reduce-scatter, ``RankShards``
    and a concatenation for the all-gather. Returns the losses and each
    rank's shards."""
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      causal_lm_loss)
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn
    from horovod_tpu_torch.optim import zero

    n = FSDP_RANKS
    with torch.device("cuda"):
        model = Transformer(cfg, attention_fn=make_flash_attention_fn(True))
    model.load_state_dict(init_state)
    named = dict(model.named_parameters())
    plans = [list(p) for p in layout.plans]
    params = [named[name] for name in layout.names]
    factory = functools.partial(torch.optim.AdamW, lr=1e-4,
                                weight_decay=1e-4)
    ranks = [zero.RankShards(factory, params, plans, n, r)
             for r in range(n)]
    losses = []
    for _ in range(steps):
        rows, step_losses = [], []
        for r in range(n):
            model.zero_grad(set_to_none=True)
            loss, _ = causal_lm_loss(model(batches[r]), batches[r])
            loss.backward()
            step_losses.append(loss.item())
            grads = [p.grad for p in params]
            rows.append([zero.stage_pack(grads, plan, n) for plan in plans])
        losses.append(step_losses)
        shards = [zero.emulated_scatter_buckets(
            [rows[r][b] for r in range(n)], n, None)
            for b in range(len(plans))]
        del rows
        for r in range(n):
            ranks[r].step([shards[b][r] for b in range(len(plans))])
        zero.stage_write(params, plans, [
            torch.cat([ranks[r].tensors[b] for r in range(n)])
            for b in range(len(plans))])
    out = {"losses": losses,
           "shards": [[t.clone() for t in rk.tensors] for rk in ranks]}
    del model, ranks
    torch.cuda.empty_cache()
    return out


def _fsdp_profile(cfg, init_named, batches, wire):
    """Device ms of B6, B12 and B13 a rank in a regather step on the int8
    wire: B6 in rank 0's backward; B12 and B13, which the emulation runs
    for every rank when it resolves the step's reduce-scatters, over that
    resolve divided by the ranks. Read from the first pair of windows
    that held every launch; "not measured" when none of
    ``DEVICE_MS_WINDOWS`` did."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      causal_lm_loss)
    from horovod_tpu_torch.ops import overlap
    from horovod_tpu_torch.optim import fsdp
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn

    n = FSDP_RANKS
    opts = [fsdp.FullyShardedOptimizer(
        functools.partial(torch.optim.AdamW, lr=1e-4), init_named,
        compression=hvd.Compression.int8, world=n, rank=r)
        for r in range(n)]
    with torch.device("meta"):
        model = Transformer(cfg, attention_fn=make_flash_attention_fn(True))
    vag = fsdp.fsdp_value_and_grad(
        lambda tok: overlap.transformer_lm_stages(
            model, tok, lambda lg: causal_lm_loss(lg, tok)[0]),
        opts[0], opts[0].layout)
    world = overlap.EmulatedWorld(n, wire)
    world.shards = [o.shards for o in opts]

    def rank(r):
        return vag(opts[r].shards, batches[r], opt_state=opts[r].opt_state,
                   exchange=world.rank(r))

    for r in range(n):  # warm-up
        rank(r)
    world.resolve()
    torch.cuda.synchronize()
    names = (("pack_tiles_kernel", "B6 pack_rows"),
             ("pack_elem_kernel", "B6 pack_rows"),
             ("quantize_kernel<true>", "B12 quant_ef_rows"),
             ("accum_kernel", "B13 accum_rows"))
    by, calls = {}, {}

    def tally(prof, share):
        for e in _kernel_events(prof):
            name = next((v for k, v in names if k in e.key), None)
            if name:
                by[name] = by.get(name, 0.0) + _dev_us(e) / 1e3 / share
                calls[name] = calls.get(name, 0) + e.count / share

    whole = len(opts[0].layout.plans)
    for _ in range(DEVICE_MS_WINDOWS):  # a window that dropped events
        by.clear()
        calls.clear()
        with _profiled() as prof:
            rank(0)
            torch.cuda.synchronize()
        tally(prof, 1)
        for r in range(1, n):
            rank(r)
        torch.cuda.synchronize()
        with _profiled() as prof:
            world.resolve()
            torch.cuda.synchronize()
        tally(prof, n)
        if all(calls.get(k) == whole for _, k in names):
            break
    else:  # no window held every launch: its sums are no reading
        by = {k: "not measured" for k in by}
    del opts, vag, world
    torch.cuda.empty_cache()
    return {"device_ms_a_rank": by, "launches_a_rank": calls}


def _expected_issue_log(cfg, names, plans):
    """Each bucket at the backward step where its last gradient arrives
    (``fusion.bucket_issue_schedule`` over embed, the blocks, the tied
    head)."""
    from horovod_tpu_torch.ops.fusion import bucket_issue_schedule

    keys = [("tok_emb", "pos_emb")] + [
        (f"block_{i}",) for i in range(cfg.num_layers)] + [
        ("ln_final", "tok_emb")]
    leaf_stages = [[s for s, ks in enumerate(keys) if n.split(".")[0] in ks]
                   for n in names]
    sched = bucket_issue_schedule(plans, leaf_stages,
                                  list(reversed(range(len(keys)))))
    return [(step, b) for step, bs in enumerate(sched) for b in bs]


def train_fsdp(seed, ledger, in_process_losses, in_process_rate):
    """Phase 4f. (a) :func:`fsdp_world_one`; (b) FSDP in a world of four
    emulated on the card, GPT-2 medium at 2 x 1024 a rank, 3 steps on
    the float32 wire and on the int8 wire with error feedback (block
    256), every mode bitwise against the gathered reference
    (``fsdp_value_and_grad(mode="upfront")``): losses, shards and
    residuals; the float32 wire bitwise against ZeRO-1 on the same world
    (:func:`_zero1_emulated`); each B6 launch of a step bitwise against
    ``_pad_rows``; each bucket issued at its scheduled boundary; exact
    launch counts. (c) the stream ordering (:func:`_faulty_side`): a
    delay on the side stream before every exchange (gathers poisoned
    with NaN first) leaves (b)'s results bitwise, and dropping the
    compute stream's wait on one gather's event, or on the last rank's
    last reduce-scatter, must break them. (e) readings. The replicated
    optimizers keep their hook-driven step under the overlap knob, so
    they have no staged path to hold here (``tests/test_torch_overlap.py``
    holds their issue boundaries on gloo worlds)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.gpt2_pretraining import synthetic_tokens
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM, Transformer
    from horovod_tpu_torch.ops import overlap
    from horovod_tpu_torch.optim.compression import WireSpec

    torch.cuda.empty_cache()
    world_one, counts = fsdp_world_one(in_process_losses, in_process_rate)
    print(json.dumps({"phase": "train_fsdp (a) world 1",
                      "model": "GPT-2 medium 24x1024, 16 heads, batch "
                               "8x1024, --flash --fused-norm", **world_one}))

    hvd.init()
    n = FSDP_RANKS
    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    with torch.device("cuda"):
        init_model = Transformer(cfg)
    init_model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    init_state = {k: v.detach().clone()
                  for k, v in init_model.state_dict().items()}
    init_named = [(k, v) for k, v in init_state.items()]
    del init_model
    batches = [torch.from_numpy(synthetic_tokens(
        cfg.vocab_size, 2, 1024, r, n)).cuda() for r in range(n)]
    int8 = WireSpec("int8", 256, True)

    # (b) every mode against the gathered reference, on both wires; on
    # the float32 wire the reference against ZeRO-1 on the same world
    runs, zero_bitwise = {}, None
    for wire_name, wire in (("float32", None), ("int8 ef", int8)):
        ref = _emulated_fsdp(cfg, init_named, batches, wire, "upfront",
                             FSDP_STEPS)
        runs[(wire_name, "upfront")] = ref
        if wire is None:
            zero1 = _zero1_emulated(cfg, init_state, ref["layout"],
                                    batches, FSDP_STEPS)
            zero_bitwise = (zero1["losses"] == ref["losses"] and all(
                _bitwise(x, y) for xs, ys in zip(zero1["shards"],
                                                 ref["final"]["shards"])
                for x, y in zip(xs, ys)))
            del zero1
            _require(zero_bitwise, "FSDP on the float32 wire is not "
                                   "bitwise ZeRO-1 on the same world")
        for mode, kw in FSDP_MODES:
            got = _emulated_fsdp(
                cfg, init_named, batches, wire, mode, FSDP_STEPS,
                snapshot=mode == "regather",
                pack_check=(mode == "regather" and wire is None))
            _require(got["losses"] == ref["losses"]
                     and _same_state(got["final"], ref["final"]),
                     f"FSDP world {n}, {wire_name}, {mode}: not bitwise "
                     "the gathered reference")
            layout = got["layout"]
            want = _fsdp_launches(cfg, len(layout.plans), kw["regather"],
                                  FSDP_STEPS, ranks=n,
                                  int8=wire is not None)
            _launch_check(got["launches"], want,
                          f"FSDP world {n}, {wire_name}, {mode}")
            _require(got["issue_log"] == _expected_issue_log(
                cfg, layout.names, [list(p) for p in layout.plans]),
                f"FSDP world {n}, {mode}: issue log {got['issue_log']}")
            if mode == "regather":
                for k, v in got["launches"].items():
                    counts[k] = counts.get(k, 0) + v
            del got["final"]
            runs[(wire_name, mode)] = got
        del ref["final"]
    checked = runs[("float32", "regather")]["packs_bitwise"]
    _require(len(checked) == n * len(layout.plans) and all(checked),
             f"B6 on the FSDP path: {checked.count(True)} of "
             f"{len(checked)} packs bitwise _pad_rows")
    for (wire_name, mode), got in runs.items():
        for r, b in enumerate(got["state_bytes"]):
            full = got["layout"].param_bytes * 2
            _require(abs(b / full - 1 / n) < 1e-3,
                     f"rank {r}'s AdamW state {b} B is not 1/{n} of {full}")

    # (c) the stream ordering of the gathers and the reduce-scatters
    plain = runs[("float32", "regather")]
    drop = layout.bucket_of[layout.names.index("block_0.attn.query.kernel")]
    last = plain["issue_log"][-1][1]

    def delayed(drop=None, rank=None):
        """Each rank's side stream, delayed; the wait on ``drop`` left
        out on ``rank``'s (every rank's when None)."""
        return lambda r: _faulty_side(drop if rank in (None, r) else None)

    slow = _emulated_fsdp(cfg, init_named, batches, None, "regather", 1,
                          side=delayed())
    broken = _emulated_fsdp(cfg, init_named, batches, None, "regather", 1,
                            side=delayed(("gather", drop)))
    slow_ok = (slow["losses"] == plain["losses"][:1]
               and _same_state(slow["final"], plain["step1"]))
    broken_ok = (broken["losses"] == plain["losses"][:1]
                 and _same_state(broken["final"], plain["step1"]))
    _require(slow_ok, "FSDP with a delayed side stream is not bitwise")
    _require(not broken_ok, "FSDP without the wait on bucket "
                            f"{drop}'s gather still read bitwise")
    # the last rank's last reduce-scatter: no later wait covers it, and
    # the exchanges are resolved right after that rank's backward. The
    # fault runs first, on a batch no run drew before, so no block the
    # allocator hands its pack can hold the right rows already
    fresh = [torch.from_numpy(np.random.RandomState(seed + 1 + r).randint(
        0, cfg.vocab_size, (2, 1024))).cuda() for r in range(n)]
    broken_s = _emulated_fsdp(cfg, init_named, fresh, None, "regather", 1,
                              side=delayed(("scatter", last), n - 1))
    one = _emulated_fsdp(cfg, init_named, fresh, None, "regather", 1)
    scatter_ok = (broken_s["losses"] == one["losses"]
                  and _same_state(broken_s["final"], one["final"]))
    _require(not scatter_ok, "FSDP without the wait on the last rank's "
                             f"reduce-scatter of bucket {last} still read "
                             "bitwise")
    del slow, broken, broken_s, one

    # (e) readings
    prof = _fsdp_profile(cfg, init_named, batches, int8)
    ledger["train_fsdp"] = counts
    print(json.dumps({
        "phase": "train_fsdp (b), (c), (e) world 4 emulated",
        "model": "GPT-2 medium 24x1024, 16 heads", "batch": "4 x 2x1024",
        "buckets": len(layout.plans), "bucket_bytes": [
            L * 4 for L in layout.lens],
        "shard_bytes": layout.shard_bytes,
        "max_bucket_bytes": layout.max_bucket_bytes,
        "modes": {f"{w} {m}": {
            "losses": got["losses"][-1],
            "peak_param_bytes_a_rank": got.get("peak_param_bytes"),
            "bound_shard_plus_prefetch_x_largest": (
                layout.shard_bytes + dict(FSDP_MODES)[m]["prefetch"]
                * layout.max_bucket_bytes) if m != "upfront" else None,
            "offload_bytes_a_rank": got.get("offload_bytes"),
            "regather_bytes_a_rank": got.get("regather_bytes")}
            for (w, m), got in runs.items()},
        "bitwise_vs_gathered_reference": True,
        "bitwise_vs_zero1_float32": zero_bitwise,
        "b6_packs_bitwise": len(checked),
        "stream_checks": {"delayed_gathers_bitwise": slow_ok,
                          "dropped_gather_wait_bitwise": broken_ok,
                          "dropped_bucket": drop,
                          "dropped_last_scatter_wait_bitwise": scatter_ok,
                          "dropped_scatter_bucket": last},
        "one_rank_int8_step": prof,
        "launches": counts}))
    del runs, init_state, init_named, batches
    hvd.shutdown()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4g: GPT-2 medium under Adasum (op=Adasum), process sets and the rest
# of the collectives
# ---------------------------------------------------------------------------

#: the JAX example's flags at GPT-2 medium's full width and depth
ADASUM_STEPS = 4
ADASUM_ARGS = ["--layers", "24", "--hidden", "1024", "--vocab", "50257",
               "--seq-len", "1024", "--batch-size", "8", "--flash",
               "--steps", str(ADASUM_STEPS)]
ADASUM_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
ADASUM_RANKS = 4
ADASUM_WORLD_STEPS = 3
#: relative L2 limit, per bucket and rank, of the emulated world's
#: Adasum-reduced bucket against a float64 Adasum tree of the same four
#: float32 gradients. It sits between the worst healthy reading over 8
#: seeds (2.17e-7) and the least reading of any injected fault over them
#: (the dot in bf16, 4.04e-5; ``--adasum-sweep 8`` on an NVIDIA H100
#: 80GB HBM3, 700 W; PERF.md), a factor of about 13 from each
ADASUM_REL_TOL = 3e-6
#: the faults the limit must catch: the last level skipped, partner
#: ``(r + d) % n`` in place of ``r ^ d``, the 1/2 dropped from the
#: coefficient, the dot taken in bf16
ADASUM_FAULTS = ("skip_level", "partner_plus", "no_half", "bf16_dot")


def _adasum_coefficient(dot, norm, half=0.5):
    one = torch.ones((), dtype=dot.dtype, device=dot.device)
    return torch.where(norm > 0, 1.0 - half * dot / torch.where(
        norm > 0, norm, one), one)


def _faulty_adasum(parts, fault):
    """The emulated world's Adasum with ``fault`` (``ADASUM_FAULTS``)."""
    from horovod_tpu_torch.ops.adasum import adasum_combine, adasum_distances

    def combine(a, b):
        if fault not in ("no_half", "bf16_dot"):
            return adasum_combine(a, b)
        af, bf = a.float(), b.float()
        dot = ((a.bfloat16() * b.bfloat16()).sum().float()
               if fault == "bf16_dot" else (af * bf).sum())
        half = 1.0 if fault == "no_half" else 0.5
        return (_adasum_coefficient(dot, (af * af).sum(), half) * af
                + _adasum_coefficient(dot, (bf * bf).sum(), half) * bf)

    n = len(parts)
    levels = adasum_distances(n)
    if fault == "skip_level":
        levels = levels[:-1]
    for d in levels:
        partner = ((lambda r: (r + d) % n) if fault == "partner_plus"
                   else (lambda r: r ^ d))
        parts = [combine(parts[r], parts[partner(r)]) for r in range(n)]
    return parts


def _adasum_tree64(parts):
    """The Adasum of ``parts`` in float64: the recursive-doubling tree,
    which every rank's partner order gives (the combine is symmetric)."""
    parts = [p.double() for p in parts]
    while len(parts) > 1:
        nxt = []
        for a, b in zip(parts[0::2], parts[1::2]):
            dot = (a * b).sum()
            nxt.append(_adasum_coefficient(dot, (a * a).sum()) * a
                       + _adasum_coefficient(dot, (b * b).sum()) * b)
        parts = nxt
    return parts[0]


def _bucket_rel(got, want64):
    return ((got.double() - want64).norm()
            / want64.norm().clamp_min(1e-300)).item()


def adasum_world(seed, weights_seed=0, steps=ADASUM_WORLD_STEPS,
                 enforce=True):
    """GPT-2 medium (24 x 1024, vocab 50257; weights from
    ``weights_seed``) trained ``steps`` Adam steps under Adasum in a
    world of four emulated on the card: the example's global batch of
    8 x 1024 (its bigram language, seed ``seed``) split into four rank
    shards of 2 x 1024; each rank its own model and Adam, its gradients
    from the kernel path (flash attention) packed into the optimizer's
    bucket plan; every bucket through ``emulated_adasum`` (the port's
    combine, indexing as the exchange, levels d = 1, 2). Reads each
    bucket's relative L2 against the float64 tree (``ADASUM_REL_TOL``)
    on every rank and step, and, on step 1's gradients, each fault's.
    With ``enforce``: the ranks' reduced buckets bitwise equal, every
    reading within the limit and every fault's beyond it, the anchors
    at the plan's bucket sizes (adasum(a, a) = a, disjoint supports
    sum, bitwise), the four ranks' parameters bitwise equal after every
    step, B1-B3 launched 24 a step a rank, a falling loss. Returns the
    readings."""
    from horovod_tpu_torch.examples.adasum_gpt2 import bigram_tokens
    from horovod_tpu_torch.models.transformer import (GPT2_MEDIUM,
                                                      Transformer,
                                                      causal_lm_loss)
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.adasum import (adasum_combine,
                                              emulated_adasum)
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn
    from horovod_tpu_torch.ops.fusion import (pack_buckets_by_plan,
                                              unflatten_buckets_by_plan)

    n = ADASUM_RANKS
    cfg = GPT2_MEDIUM
    models = []
    for r in range(n):
        with torch.device("cuda"):
            models.append(Transformer(
                cfg, attention_fn=make_flash_attention_fn(True)))
        if r == 0:
            models[0].init_params(torch.Generator(device="cuda").manual_seed(
                weights_seed))
        else:
            models[r].load_state_dict(models[0].state_dict())
    params = []
    for m in models:  # the same plan, each rank's parameters in its order
        plans, ps = _model_plan(cfg, m)
        params.append(ps)
    opts = [torch.optim.Adam(m.parameters(), lr=1e-3) for m in models]
    rows = bigram_tokens(cfg.vocab_size, 2 * n, 1024, seed)
    tokens = [torch.from_numpy(rows[2 * r:2 * r + 2]).cuda()
              for r in range(n)]
    losses, rel, faults, launches = [], [], {}, []
    anchors = None
    for step in range(steps):
        _build.reset_launches()
        step_losses, grads = [], []
        for r in range(n):
            loss, _ = causal_lm_loss(models[r](tokens[r]), tokens[r])
            loss.backward()
            step_losses.append(loss.item())
            grads.append(pack_buckets_by_plan(
                [p.grad for p in params[r]], plans))
            models[r].zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        launches.append({k: _build.LAUNCHES[k] for k in ADASUM_KERNELS})
        losses.append(float(np.mean(step_losses)))
        outs, step_rel = [], []
        for b in range(len(plans)):
            parts = [grads[r][b] for r in range(n)]
            red = emulated_adasum(parts)
            tree = _adasum_tree64(parts)
            step_rel.append(max(_bucket_rel(x, tree) for x in red))
            if enforce:
                for r in range(1, n):
                    _require(_bitwise(red[r], red[0]),
                             f"adasum step {step} bucket {b}: rank {r}'s "
                             "reduced bucket differs from rank 0's")
            if step == 0:
                for name in ADASUM_FAULTS:
                    faults.setdefault(name, []).append(max(
                        _bucket_rel(x, tree)
                        for x in _faulty_adasum(parts, name)))
            outs.append(red)
            del tree
        rel.append(step_rel)
        if step == 0:
            anchors = _adasum_anchors(grads, adasum_combine, enforce)
        for r in range(n):
            leaves = unflatten_buckets_by_plan([o[r] for o in outs], plans,
                                               len(params[r]))
            for p, leaf in zip(params[r], leaves):
                p.grad = leaf.view_as(p)
            opts[r].step()
            opts[r].zero_grad(set_to_none=True)
        del outs, grads
        if enforce:
            ref = models[0].state_dict()
            for r in range(1, n):
                diff = _first_difference(models[r].state_dict(), ref)
                _require(diff is None,
                         f"adasum step {step}: rank {r}'s parameters differ "
                         f"from rank 0's: {diff}")
    timing = _adasum_combine_timing(models, params, plans, tokens)
    del models, opts
    torch.cuda.empty_cache()
    out = {"seed": seed, "weights_seed": weights_seed,
           "buckets": len(plans), "bucket_elements": _bucket_sizes(plans),
           "losses": losses, "rel_l2_max_by_step": [max(r) for r in rel],
           "rel_l2_max": max(max(r) for r in rel),
           "rel_l2_by_bucket_last_step": rel[-1],
           "fault_rel_l2_min_over_buckets_max": {
               k: max(v) for k, v in faults.items()},
           "fault_rel_l2_by_bucket": faults,
           "launches_by_step": launches, "anchors": anchors, **timing}
    if enforce:
        for step, counts in enumerate(launches):
            for k, c in counts.items():
                _require(c == STEP_LAUNCHES[k] * n,
                         f"adasum step {step}: {k} launched {c} times, not "
                         f"{STEP_LAUNCHES[k]} a rank x {n}")
        _require(all(np.isfinite(losses)) and min(losses[1:]) < losses[0],
                 f"adasum training loss did not fall: {losses}")
        _require(out["rel_l2_max"] <= ADASUM_REL_TOL,
                 f"adasum reduced bucket {out['rel_l2_max']:.3e} from the "
                 f"float64 tree (relative L2) > {ADASUM_REL_TOL}")
        for name, reading in out["fault_rel_l2_min_over_buckets_max"].items():
            _require(reading > ADASUM_REL_TOL,
                     f"adasum fault {name} reads {reading:.3e} (relative "
                     f"L2, worst bucket) <= {ADASUM_REL_TOL}: the limit "
                     "does not catch it")
    return out


def _adasum_anchors(grads, combine, enforce):
    """At each bucket of the plan (rank 0's and rank 1's step-1
    gradients): adasum(a, a) = a, and a on one half with b on the other
    (disjoint supports) sums, bitwise."""
    same = disjoint = 0
    for b in range(len(grads[0])):
        a, c = grads[0][b], grads[1][b]
        same += _bitwise(combine(a, a), a)
        half = a.numel() // 2
        lo = torch.cat([a[:half], torch.zeros_like(a[half:])])
        hi = torch.cat([torch.zeros_like(c[:half]), c[half:]])
        disjoint += _bitwise(combine(lo, hi), lo + hi)
    nb = len(grads[0])
    if enforce:
        _require(same == nb, f"adasum(a, a) != a bitwise on {nb - same} of "
                             f"{nb} buckets")
        _require(disjoint == nb, "adasum of disjoint supports is not their "
                                 f"sum bitwise on {nb - disjoint} of {nb} "
                                 "buckets")
    return {"buckets": nb, "same_is_identity": same,
            "disjoint_is_sum": disjoint}


def _adasum_combine_timing(models, params, plans, tokens):
    """Device ms of one rank's combines a step at world 4 (two levels
    over every bucket of the plan, on one step's gradients of two ranks)
    beside the bytes bound: a level reads both partials and writes one,
    3 x 4 bytes an element."""
    from horovod_tpu_torch.models.transformer import causal_lm_loss
    from horovod_tpu_torch.ops.adasum import adasum_combine, adasum_distances
    from horovod_tpu_torch.ops.fusion import pack_buckets_by_plan

    grads = []
    for r in range(2):
        loss, _ = causal_lm_loss(models[r](tokens[r]), tokens[r])
        loss.backward()
        grads.append(pack_buckets_by_plan([p.grad for p in params[r]],
                                          plans))
        models[r].zero_grad(set_to_none=True)
    levels = len(adasum_distances(ADASUM_RANKS))

    def one_rank(i=0):
        for _ in range(levels):
            for a, b in zip(grads[0], grads[1]):
                adasum_combine(a, b)

    ms = _device_ms(one_rank, iters=5)
    elements = sum(_bucket_sizes(plans))
    bound, by = _bound(levels * 3 * 4 * elements, levels * 9 * elements,
                       "f32")
    return {"combine_device_ms_per_rank_step": ms,
            "combine_bound_ms": bound, "combine_bound_by": by,
            "combine_levels": levels, "combine_elements": elements}


def adasum_sweep(n_seeds):
    """The readings behind ``ADASUM_REL_TOL``: the emulated world on
    seeds 0..n-1 (weights and batch), with the faults read on each; one
    summary line, nothing enforced."""
    runs = [adasum_world(s, weights_seed=s, enforce=False)
            for s in range(n_seeds)]
    print(json.dumps({"adasum_sweep": {
        "seeds": n_seeds, "rel_l2_tol": ADASUM_REL_TOL,
        "rel_l2_max": max(r["rel_l2_max"] for r in runs),
        "per_seed_by_step": [r["rel_l2_max_by_step"] for r in runs],
        "fault_min_over_seeds": {
            k: min(r["fault_rel_l2_min_over_buckets_max"][k] for r in runs)
            for k in ADASUM_FAULTS},
        "fault_least_bucket_seed0": {
            k: min(v) for k, v in runs[0]["fault_rel_l2_by_bucket"].items()},
        "losses": [r["losses"] for r in runs],
        "combine_device_ms": [r["combine_device_ms_per_rank_step"]
                              for r in runs],
        "combine_bound_ms": runs[0]["combine_bound_ms"]}}))


def _raises(exc, fn):
    """Whether ``fn()`` raises ``exc`` (any other exception propagates)."""
    try:
        fn()
    except exc:
        return True
    return False


def adasum_surface():
    """(c) process sets and the collectives of this slice over NCCL at
    world 1, each on cuda tensors against its single-rank result; a
    sparse allreduce of an ``nn.Embedding(50257, 1024, sparse=True)``
    gradient from one batch's token ids against its dense gradient."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.adasum_gpt2 import bigram_tokens

    hvd.init()
    _require(hvd.nccl_enabled() and hvd.size() == 1,
             "phase 4g (c) needs a world of one over NCCL")
    glob = hvd.global_process_set()
    _require(_raises(hvd.ProcessSetError, lambda: hvd.add_process_set([0])),
             "add_process_set([0]) did not raise the duplicate error")
    _require(hvd.add_or_get_process_set([0]) is glob,
             "add_or_get_process_set([0]) is not the global set")
    _require(_raises(hvd.ProcessSetError, lambda: hvd.remove_process_set(0)),
             "removing the global set did not raise")

    def trained(process_set):
        torch.manual_seed(1)
        lin = torch.nn.Linear(64, 32).cuda()
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(lin.parameters(), lr=1e-2),
            named_parameters=lin.named_parameters(), op=hvd.Adasum,
            process_set=process_set)
        x = torch.randn(16, 64, device="cuda")
        for _ in range(3):
            lin(x).square().mean().backward()
            opt.step()
            opt.zero_grad()
        return lin.state_dict()

    _require(_first_difference(trained(glob), trained(None)) is None,
             "DistributedOptimizer(process_set=global) differs from the "
             "default")
    x = torch.arange(32, dtype=torch.float32, device="cuda").reshape(8, 4)
    got = {"alltoall": hvd.alltoall(x)}
    out, recv = hvd.alltoall(x, splits=[8])
    got["alltoall_splits"] = out
    _require(recv.tolist() == [8], f"alltoall received splits {recv}")
    ga, gb = hvd.grouped_allgather([x, x[:3, :2].to(torch.bfloat16)])
    got["grouped_allgather"] = ga
    _require(_bitwise(gb, x[:3, :2].to(torch.bfloat16)),
             "grouped_allgather's bf16 member")
    got["masked_allreduce"] = hvd.masked_allreduce(x, True)
    _require(torch.equal(hvd.masked_allreduce(x, False),
                         torch.zeros_like(x)), "masked_allreduce(invalid)")
    _require(hvd.join() == 0, "join() != 0")
    _require(hvd.allgather_object({"rank": 0}) == [{"rank": 0}],
             "allgather_object")
    for name, t in got.items():
        _require(t.device.type == "cuda" and _bitwise(t, x),
                 f"{name} at world 1 is not its input on the card")
    tok = torch.from_numpy(bigram_tokens(50257, 8, 1024)).cuda()
    sparse = torch.nn.Embedding(50257, 1024, sparse=True).cuda()
    dense = torch.nn.Embedding(50257, 1024).cuda()
    dense.load_state_dict(sparse.state_dict())
    w = torch.randn(1024, device="cuda")
    for emb in (sparse, dense):
        (emb(tok) * w).sum().backward()
    red = hvd.sparse_allreduce(sparse.weight.grad)
    _require(red.is_sparse and red.device.type == "cuda",
             "sparse_allreduce did not return a sparse cuda tensor")
    err = (red.to_dense() - dense.weight.grad).abs().max().item()
    scale = dense.weight.grad.abs().max().item()
    _require(err <= 1e-6 * scale,
             f"sparse allreduce differs from the dense gradient by {err} "
             f"(max |g| {scale})")
    rows = int(red.coalesce().indices().shape[1])
    hvd.shutdown()
    return {"process_sets": "duplicate, add_or_get, remove 0, optimizer "
                            "process_set=global bitwise",
            "collectives": sorted(got) + ["join", "allgather_object"],
            "sparse": {"rows": rows, "unique_tokens": int(
                tok.unique().numel()), "max_abs_err": err,
                "max_abs_grad": scale}}


def train_adasum(seed, ledger):
    """Phase 4g. (a) the Adasum example's ``main`` at GPT-2 medium's full
    width (``ADASUM_ARGS``), world 1 over NCCL: a falling loss, B1-B3
    exactly 24 a step (by the launch counts, and by kernel name in a
    profiled step of the twin below), and the parameters bitwise those
    of the same steps under a plain ``torch.optim.Adam`` (at world 1
    Adasum is the identity); (b) :func:`adasum_world`; (c)
    :func:`adasum_surface`. Launch counts are zeroed just before (a)
    and (b) and read just after."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import adasum_gpt2
    from horovod_tpu_torch.models.transformer import causal_lm_loss
    from horovod_tpu_torch.ops import _build
    from torch.profiler import ProfilerActivity

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    _build.reset_launches()
    first, last = adasum_gpt2.main(ADASUM_ARGS, stats)
    torch.cuda.synchronize()
    ledger["train_adasum"] = {k: _build.LAUNCHES[k] for k in ADASUM_KERNELS}
    losses = stats["losses"]
    _require(len(losses) == ADASUM_STEPS and all(np.isfinite(losses))
             and losses[-1] < losses[0],
             f"Adasum example losses did not fall: {losses}")
    for k in ADASUM_KERNELS:
        _require(ledger["train_adasum"][k] == STEP_LAUNCHES[k] * ADASUM_STEPS,
                 f"Adasum example: {k} launched {ledger['train_adasum'][k]} "
                 f"times in {ADASUM_STEPS} steps, not {STEP_LAUNCHES[k]} a "
                 "step")
    peak = torch.cuda.max_memory_allocated() / 1e9
    model, tok = stats["model"], stats["tokens"]
    step_ms, rates = stats["step_ms"], stats["tokens_per_s"]
    got = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del stats, model
    hvd.shutdown()
    torch.cuda.empty_cache()

    # the twin: the same steps under a plain torch.optim.Adam
    with torch.device("cuda"):
        twin = adasum_gpt2.Transformer(
            dataclasses.replace(
                adasum_gpt2.GPT2_SMALL, num_layers=24, hidden_size=1024,
                num_heads=16, vocab_size=50257, max_seq_len=1024),
            attention_fn=adasum_gpt2.make_flash_attention_fn(causal=True))
    twin.init_params(torch.Generator(device="cuda").manual_seed(0))
    adam = torch.optim.Adam(twin.parameters(), lr=1e-3)

    def twin_step():
        causal_lm_loss(twin(tok), tok)[0].backward()
        adam.step()
        adam.zero_grad(set_to_none=True)

    for _ in range(ADASUM_STEPS - 1):
        twin_step()
    with _profiled(ProfilerActivity.CUDA) as prof:
        twin_step()
    by_name = {k: sum(e.count for e in _kernel_events(prof)
                      if k + "_" in e.key) for k in ADASUM_KERNELS}
    for k, c in by_name.items():
        _require(c == STEP_LAUNCHES[k],
                 f"profiled twin step: {c} kernels named {k}*, not "
                 f"{STEP_LAUNCHES[k]}")
    diff = _first_difference(got, twin.state_dict())
    _require(diff is None, "the Adasum example at world 1 is not bitwise "
                           f"plain Adam's steps: {diff}")
    del twin, adam, got
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "train_adasum (a) world 1",
        "model": "GPT-2 medium 24x1024, 16 heads, vocab 50257",
        "args": ADASUM_ARGS, "batch": "8x1024", "backend": "nccl",
        "losses": losses, "step_ms": step_ms, "tokens_per_s": rates,
        "step_ms_median_after_first": float(np.median(step_ms[1:])),
        "tokens_per_s_median_after_first": float(np.median(rates[1:])),
        "peak_mem_gb": peak, "bitwise_plain_adam": True,
        "launches_per_step": {k: ledger["train_adasum"][k] / ADASUM_STEPS
                              for k in ADASUM_KERNELS},
        "profiled_step_kernels": by_name}))

    torch.cuda.reset_peak_memory_stats()
    world = adasum_world(seed)
    ledger["train_adasum_world"] = {
        k: sum(s[k] for s in world["launches_by_step"])
        for k in ADASUM_KERNELS}
    world["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"phase": "train_adasum (b) world 4 emulated",
                      "model": "GPT-2 medium 24x1024", "batch": "4 x 2x1024",
                      "rel_l2_tol": ADASUM_REL_TOL, **world}))
    print(json.dumps({"phase": "train_adasum (c) surface, world 1 nccl",
                      **adasum_surface()}))


# ---------------------------------------------------------------------------
# phase 4h: the two-level (hierarchical) wire, a world of four emulated on
# the card as two domains of two
# ---------------------------------------------------------------------------

HIER_RANKS, HIER_BLOCK, HIER_STEPS = 4, 2, 3
#: the int8 outer leg's kernels, in the order one rank runs them
HIER_KERNELS = ("quant_ef_rows", "accum_rows", "quant_rows", "dequant_flat")
#: the faults every one of which the checks must catch: the outer gather
#: in reversed peer order, the shard residual stashed one shard past its
#: place, one rank left out of the inner reduce-scatter
HIER_FAULTS = ("outer_peer_order", "residual_offset", "drop_inner_rank")
#: elementwise limits of (b)'s float wires against the exact (float64)
#: sum of the four ranks' gradients, in units of the element's sum of
#: |gradients|: float32 rounds twice (an inner and an outer add, 2^-24
#: each), bf16 four times (the inner float32 add, two casts and an add
#: at 2^-8), with a unit of slack
HIER_WIRE_TOL = {"float32": 3 * 2.0 ** -24, "bf16": 4 * 2.0 ** -8}


@contextlib.contextmanager
def _hier_fault(name):
    """One of ``HIER_FAULTS`` patched into ``ops/hierarchical.py``'s
    stages (the emulation calls them through the module)."""
    from horovod_tpu_torch.ops import hierarchical as hier

    if name == "outer_peer_order":
        attr = "stage_outer_accumulate"
        orig = hier.stage_outer_accumulate

        def faulty(qg, sg, n, length, block):
            return orig(qg.reshape(n, -1).flip(0).reshape(-1).contiguous(),
                        sg.reshape(n, -1).flip(0).reshape(-1).contiguous(),
                        n, length, block)
    elif name == "residual_offset":
        attr = "_stash_shard_residual"
        orig = hier._stash_shard_residual

        def faulty(like, shard_res, shard_len):
            buf = torch.zeros(like.numel(), dtype=torch.float32,
                              device=like.device)
            k = min(shard_len, like.numel() - shard_len)
            buf[shard_len:shard_len + k] = shard_res.reshape(-1)[:k]
            return buf.reshape(like.shape)
    elif name == "drop_inner_rank":
        attr = "stage_inner_reduce"
        orig = hier.stage_inner_reduce

        def faulty(chunks):
            return orig(chunks[:-1])
    else:
        raise ValueError(f"unknown fault {name!r}")
    setattr(hier, attr, faulty)
    try:
        yield
    finally:
        setattr(hier, attr, orig)


def _leg_bytes(sizes, n, block, wire_block):
    """Bytes one rank sends a step on each leg (ring algorithms: a
    reduce-scatter or an all-gather over g ranks sends g - 1 chunks), on
    the two-level int8 wire with inner domains of ``block`` and on the
    flat int8 wire, from the plan's bucket sizes (float32 payloads)."""
    outer = n // block
    two = {"inner_reduce_scatter_float32": 0, "outer_all_gather_int8": 0,
           "outer_all_gather_scales": 0, "inner_all_gather_float32": 0}
    flat = {"all_to_all_int8_and_scales": 0, "all_gather_int8_and_scales": 0}
    for L in sizes:
        lp = -(-L // block) * block
        k = lp // block
        m = -(-k // wire_block) * wire_block
        two["inner_reduce_scatter_float32"] += (block - 1) * k * 4
        two["outer_all_gather_int8"] += (outer - 1) * m
        two["outer_all_gather_scales"] += (outer - 1) * (m // wire_block) * 4
        two["inner_all_gather_float32"] += (block - 1) * k * 4
        c = -(-L // (n * wire_block)) * wire_block
        flat["all_to_all_int8_and_scales"] += (n - 1) * (c + c // wire_block
                                                         * 4)
        flat["all_gather_int8_and_scales"] += (n - 1) * (c + c // wire_block
                                                         * 4)
    two["outer_total"] = (two["outer_all_gather_int8"]
                          + two["outer_all_gather_scales"])
    return {"two_level": two, "flat_int8": flat,
            "float32_ring_allreduce": sum(2 * (n - 1) * -(-L // n) * 4
                                          for L in sizes)}


def _hier_stage_ms(plans, block, wire_block):
    """Device ms of one rank's outer-leg kernels a step on the plan at
    inner domains of ``block``: B12 on its float32 shard of each bucket,
    B13 over the ``HIER_RANKS // block`` peers' rows; the copies that
    stand for the exchanges left out."""
    from horovod_tpu_torch.ops import hierarchical as hier

    n_outer = HIER_RANKS // block
    g = torch.Generator(device="cuda").manual_seed(12)
    shards = [torch.randn(-(-size // block), generator=g, device="cuda")
              * 1e-3 for size in _bucket_sizes(plans)]
    res = [torch.zeros_like(s) for s in shards]
    rows = []
    for s, r in zip(shards, res):
        q, sc, _ = hier.stage_outer_quantize(s, r, wire_block)
        rows.append((torch.cat([q] * n_outer), torch.cat([sc] * n_outer)))

    def one_rank():
        for s, r, (qg, sg) in zip(shards, res, rows):
            hier.stage_outer_quantize(s, r, wire_block)
            hier.stage_outer_accumulate(qg, sg, n_outer, s.numel(),
                                        wire_block)

    one_rank()
    torch.cuda.synchronize()
    with _profiled() as prof:
        one_rank()
        torch.cuda.synchronize()
    by = {}
    for e in _kernel_events(prof):
        name = ("quant_ef_rows" if "quantize_kernel<true>" in e.key
                else "accum_rows" if "accum_kernel" in e.key
                else "other (slicing)")
        by[name] = by.get(name, 0.0) + _dev_us(e) / 1e3
    return by


def hier_world(seed, weights_seed=0, steps=HIER_STEPS):
    """(a) GPT-2 medium (24 x 1024, vocab 50257; weights from
    ``weights_seed``) trained ``steps`` AdamW steps over the two-level
    int8 wire with error feedback (block 256) in a world of four
    emulated on the card as two domains of two
    (``HOROVOD_HIERARCHICAL_LOCAL_SIZE=2``): phase 4b's global batch of
    8 x 1024 split into four rank shards of 2 x 1024, each rank's
    gradients from the kernel path, every bucket of the optimizer's plan
    through ``emulated_hierarchical_psum`` (the inner reduce-scatter as
    sums in rank order, B12 on each rank's shard, the outer gather as a
    concatenation, B13 over the peers, the inner gather as a
    concatenation), four residual sets carried, and each rank stepping
    its own parameter buckets with its own AdamW on the reduced mean.
    Beside it the plain versions' composition, on the same gradients
    with residuals of its own, and a plain rank's parameters: every
    reduced bucket, residual and parameter bitwise equal to the
    kernels'; the four ranks' reduced buckets and parameters bitwise
    equal; B12 and B13 exactly 12 a step a rank, B11 and B14 none; the
    loss falls. Also, on the same gradients: each of ``HIER_FAULTS`` in
    the kernels' composition must leave the plain one's bits in some
    bucket within two steps; phase 4b's flat int8 wire (its own
    residuals) and each wire's relative L2 to the float32 mean; one step
    without residuals (B11 12 a rank, B12 none); (b)'s float32 and bf16
    wires against the exact sum. Returns the readings and the launch
    counts of the main run."""
    from horovod_tpu_torch.models.transformer import (GPT2_MEDIUM,
                                                      Transformer)
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import hierarchical as hier
    from horovod_tpu_torch.ops import quantized_collectives as qc
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn
    from horovod_tpu_torch.ops.fusion import (pack_buckets_by_plan,
                                              unflatten_buckets_by_plan)
    from horovod_tpu_torch.optim.compression import WireSpec

    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    with torch.device("cuda"):
        model = Transformer(cfg, attention_fn=make_flash_attention_fn(True))
    model.init_params(torch.Generator(device="cuda").manual_seed(
        weights_seed))
    plans, params = gpt2_medium_plan(model)
    n, block, nb = HIER_RANKS, HIER_BLOCK, len(plans)
    wire = WireSpec("int8", QUANT_BLOCK, True)
    rows = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                               (2 * n, 1024))
    tokens = [torch.from_numpy(rows[2 * r:2 * r + 2]).cuda()
              for r in range(n)]

    def flat_params():
        return [b.detach().clone() for b in pack_buckets_by_plan(
            [p.detach() for p in params], plans)]

    def adamw(bufs):
        return torch.optim.AdamW(bufs, lr=1e-4, weight_decay=1e-4)

    ranks = [flat_params() for _ in range(n)]
    plain = flat_params()
    opts, plain_opt = [adamw(b) for b in ranks], adamw(plain)

    def zero_res():
        return [[torch.zeros_like(ranks[0][b]) for _ in range(n)]
                for b in range(nb)]

    res_k, res_p, res_f, res_fault = (zero_res(), zero_res(), zero_res(),
                                      zero_res())
    caught = {f: [0, 0] for f in HIER_FAULTS}
    losses, launches, rel, rel_flat, stage_ms = [], [], [], [], []
    wires = {}
    for step in range(steps):
        step_losses, grads = _rank_grads(model, params, plans, tokens)
        losses.append(float(np.mean(step_losses)))
        counts = {k: 0 for k in HIER_KERNELS}
        plain_red, step_rel, step_flat, secs = [], [], [], 0.0
        for b in range(nb):
            xs = [grads[r][b] for r in range(n)]
            torch.cuda.synchronize()
            before = _launch_snapshot()
            t0 = time.perf_counter()
            ys, errs = hier.emulated_hierarchical_psum(xs, block, wire,
                                                       res_k[b])
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            delta = _launch_delta(before)
            for k in HIER_KERNELS:
                counts[k] += delta[k]
            with _plain_quantized():
                pys, perrs = hier.emulated_hierarchical_psum(xs, block,
                                                             wire, res_p[b])
            for r in range(n):
                _require(_equal(ys[r], ys[0]),
                         f"hierarchical step {step} bucket {b}: rank {r}'s "
                         "reduced bucket differs from rank 0's")
                _require(_equal(pys[r], ys[r]) and _equal(perrs[r], errs[r]),
                         f"hierarchical step {step} bucket {b} rank {r}: "
                         "the reduced bucket or residual is not bitwise the "
                         "plain composition's")
            if step < 2:  # each fault, on the healthy run's inputs
                for f in HIER_FAULTS:
                    carried = f == "residual_offset"
                    with _hier_fault(f):
                        fys, fres = hier.emulated_hierarchical_psum(
                            xs, block, wire,
                            res_fault[b] if carried else res_k[b])
                    if carried:
                        res_fault[b] = fres
                    caught[f][step] += not all(_equal(fy, y) for fy, y
                                               in zip(fys, ys))
                    del fys, fres
            res_k[b], res_p[b] = errs, perrs
            # AVERAGE: a true division of each rank's own sum, as the
            # optimizer divides
            for r in range(n):
                ranks[r][b].grad = ys[r] / n
            plain_red.append(pys[0])
            del ys, pys
            mean = sum(xs) / n
            step_rel.append(((ranks[0][b].grad - mean).norm()
                             / mean.norm().clamp_min(1e-30)).item())
            sums, res_f[b] = qc.emulated_quantized_psum(xs, n, QUANT_BLOCK,
                                                        res_f[b])
            step_flat.append(((sums[0] / n - mean).norm()
                              / mean.norm().clamp_min(1e-30)).item())
            del sums, mean
            if step == 0:
                before = _launch_snapshot()
                hier.emulated_hierarchical_psum(xs, block, wire)
                raw = _launch_delta(before)
                for k in HIER_KERNELS:
                    wires.setdefault("int8 raw, launches", {k: 0 for k in
                                                            HIER_KERNELS})
                    wires["int8 raw, launches"][k] += raw[k]
            if step == steps - 1:
                exact = sum(x.double() for x in xs)
                scale = sum(x.double().abs() for x in xs).clamp_min(1e-300)
                for kind, w in (("float32", None),
                                ("bf16", WireSpec("bf16"))):
                    ws, _ = hier.emulated_hierarchical_psum(xs, block, w)
                    err = (ws[0].double() - exact).abs()
                    got = wires.setdefault(kind, {
                        "worst_error_per_sum_abs": 0.0,
                        "tol": HIER_WIRE_TOL[kind], "rel_l2_max": 0.0})
                    got["worst_error_per_sum_abs"] = max(
                        got["worst_error_per_sum_abs"],
                        (err / scale).max().item())
                    got["rel_l2_max"] = max(
                        got["rel_l2_max"],
                        (err.norm() / exact.norm()).item())
                    del ws, err
                del exact, scale
        launches.append(counts)
        stage_ms.append(secs * 1e3)
        rel.append(step_rel)
        rel_flat.append(step_flat)
        for r in range(n):
            opts[r].step()
            opts[r].zero_grad(set_to_none=True)
        for b in range(nb):
            plain[b].grad = plain_red[b] / n
        plain_opt.step()
        plain_opt.zero_grad(set_to_none=True)
        for b in range(nb):
            _require(_equal(plain[b], ranks[0][b]),
                     f"hierarchical step {step} bucket {b}: the parameters "
                     "are not bitwise the plain composition's")
            for r in range(1, n):
                _require(_equal(ranks[r][b], ranks[0][b]),
                         f"hierarchical step {step} bucket {b}: rank {r}'s "
                         "parameters differ from rank 0's")
        leaves = unflatten_buckets_by_plan(ranks[0], plans, len(params))
        with torch.no_grad():
            for p, leaf in zip(params, leaves):
                p.copy_(leaf.view_as(p))
        del plain_red, grads, leaves
        torch.cuda.empty_cache()
    for kind in ("float32", "bf16"):
        worst = wires[kind]["worst_error_per_sum_abs"]
        _require(worst <= HIER_WIRE_TOL[kind],
                 f"hierarchical {kind} wire: an element is {worst:.3e} of "
                 "its sum of |gradients| from the exact sum (limit "
                 f"{HIER_WIRE_TOL[kind]:.3e})")
    want = n * nb
    for step, counts in enumerate(launches):
        got = (counts["quant_ef_rows"], counts["accum_rows"],
               counts["quant_rows"], counts["dequant_flat"])
        _require(got == (want, want, 0, 0),
                 f"hierarchical step {step}: B12, B13, B11, B14 launched "
                 f"{got}, not ({want}, {want}, 0, 0): 12 buckets a rank")
    raw = wires["int8 raw, launches"]
    _require((raw["quant_rows"], raw["quant_ef_rows"], raw["accum_rows"],
              raw["dequant_flat"]) == (want, 0, want, 0),
             f"hierarchical without residuals launched {raw}")
    for f, counts in caught.items():
        _require(any(counts), f"hierarchical fault {f} left every bucket's "
                              "bits as they were: the checks would pass it")
    _require(all(np.isfinite(losses)) and losses[-1] < losses[0],
             f"hierarchical training loss did not fall: {losses}")
    sizes = _bucket_sizes(plans)
    del model, ranks, plain, opts, plain_opt, res_k, res_p, res_f, res_fault
    torch.cuda.empty_cache()
    return {"seed": seed, "buckets": nb, "bucket_elements": sizes,
            "losses": losses, "rel_l2_max_by_step": [max(r) for r in rel],
            "flat_int8_rel_l2_max_by_step": [max(r) for r in rel_flat],
            "rel_l2_by_bucket_last_step": rel[-1],
            "flat_int8_rel_l2_by_bucket_last_step": rel_flat[-1],
            "launches_by_step": launches, "stage_wall_ms": stage_ms,
            "faults_buckets_differing_steps_1_2": caught, "wires": wires,
            "leg_bytes_per_rank_step": _leg_bytes(sizes, n, block,
                                                  QUANT_BLOCK),
            "one_rank_outer_leg_device_ms": _hier_stage_ms(plans, block,
                                                           QUANT_BLOCK)}


def hier_world_one(in_process_losses):
    """(c) The knobs at world 1 over NCCL (``HOROVOD_HIERARCHICAL_ALLREDUCE``,
    ``_ALLGATHER``, ``_LOCAL_SIZE=2``, the int8 wire): ``resolve_block``
    gives 1, so every call takes the flat route. ``allreduce`` and
    ``allgather`` return their input bitwise; ``hierarchical_psum`` with
    the int8 wire and a residual is the plain composition's bits; GPT-2
    medium through ``make_lm_train_step`` (batch 8 x 1024, AdamW, phase
    4's seed, weights and batch) gives phase 4's first four losses
    bitwise. Returns the readings."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.gpt2_pretraining import synthetic_tokens
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM
    from horovod_tpu_torch.ops import hierarchical as hier
    from horovod_tpu_torch.ops import quantized_collectives as qc
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn
    from horovod_tpu_torch.optim.compression import WireSpec

    env = {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
           "HOROVOD_HIERARCHICAL_ALLGATHER": "1",
           "HOROVOD_HIERARCHICAL_LOCAL_SIZE": str(HIER_BLOCK),
           "HOROVOD_COMPRESSION": "int8"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        hvd.init()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    try:
        _require(hvd.nccl_enabled() and hvd.size() == 1,
                 "phase 4h (c) needs a world of one over NCCL")
        _require(hier.resolve_block(1, HIER_BLOCK) == 1
                 and hier.hierarchy_enabled_for("allreduce", None)
                 and hier.hierarchy_enabled_for("allgather", None),
                 "phase 4h (c): the knobs did not reach the world of one")
        g = torch.Generator(device="cuda").manual_seed(21)
        x = torch.randn(1 << 20, generator=g, device="cuda")
        r = torch.randn(1 << 20, generator=g, device="cuda") * 1e-6
        _require(_bitwise(hvd.allreduce(x, op=hvd.Sum), x)
                 and _bitwise(hvd.allreduce(x, op=hvd.Average), x)
                 and _bitwise(hvd.allgather(x.reshape(1024, -1)),
                              x.reshape(1024, -1)),
                 "phase 4h (c): a collective at world 1 is not its input")
        y, new_r = hier.hierarchical_psum(x, HIER_BLOCK,
                                          WireSpec("int8", QUANT_BLOCK),
                                          residual=r)
        with _plain_quantized():
            (py,), (pr,) = qc.emulated_quantized_psum([x], 1, QUANT_BLOCK,
                                                      [r])
        _require(_equal(y, py) and _equal(new_r, pr),
                 "phase 4h (c): hierarchical_psum at world 1 is not the "
                 "flat wire's plain composition")
        cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
        factory = functools.partial(torch.optim.AdamW, lr=1e-4,
                                    weight_decay=1e-4)
        tokens = torch.from_numpy(synthetic_tokens(
            cfg.vocab_size, 8, 1024, 0, 1)).cuda()
        model, step = hvd.make_lm_train_step(
            cfg, factory, attention_fn=make_flash_attention_fn(causal=True))
        _require(step.optimizer.wire.kind == "int8"
                 and step.optimizer._hier_block == 1,
                 "phase 4h (c): the int8 optimizer's two-level block is "
                 "not 1")
        losses = [float(step(tokens)) for _ in range(4)]
        _require(losses == in_process_losses[:4],
                 f"phase 4h (c): losses {losses} under the knobs are not "
                 f"phase 4's {in_process_losses[:4]}")
        del model, step
        torch.cuda.empty_cache()
        return {"world": 1, "backend": "nccl", "resolve_block": 1,
                "wire": "int8 block 256 ef",
                "losses_bitwise_phase4": losses}
    finally:
        hvd.shutdown()


def train_hierarchical(seed, ledger, in_process_losses, flat_stage_ms):
    """Phase 4h: (a) and (b) :func:`hier_world`, (c)
    :func:`hier_world_one`. Launch counts are zeroed just before (a)'s
    reductions and read just after."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    world = hier_world(seed)
    ledger["train_hierarchical"] = {
        k: sum(s[k] for s in world["launches_by_step"])
        for k in HIER_KERNELS}
    world["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stage = world["one_rank_outer_leg_device_ms"]
    print(json.dumps({
        "phase": "train_hierarchical (a, b) world 4 emulated as 2 x 2",
        "model": "GPT-2 medium 24x1024", "batch": "4 x 2x1024",
        "wire": "two-level: float32 inner legs, int8 block 256 ef outer",
        "phase4b_flat_one_rank_stage_device_ms": flat_stage_ms,
        "one_rank_outer_leg_device_ms_total": sum(
            v for k, v in stage.items() if not k.startswith("other")),
        **world}))
    print(json.dumps({"phase": "train_hierarchical (c) world 1 nccl",
                      **hier_world_one(in_process_losses)}))


# ---------------------------------------------------------------------------
# phase 4i: Llama-2 under Adasum at width 4096 (head_dim 128)
# ---------------------------------------------------------------------------

LLAMA_STEPS = 4
LLAMA_LAYERS = 12
#: the Llama example's flags at Llama-2's width and context, depth cut
LLAMA_ARGS = ["--layers", str(LLAMA_LAYERS), "--hidden", "4096", "--vocab",
              "32000", "--seq-len", "4096", "--batch-size", "2", "--flash",
              "--remat", "--steps", str(LLAMA_STEPS)]
LLAMA_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
#: a step's launches: the forward of each block twice under remat
LLAMA_LAUNCHES = {"flash_fwd": 2 * LLAMA_LAYERS,
                  "flash_bwd_dq": LLAMA_LAYERS,
                  "flash_bwd_dkv": LLAMA_LAYERS}


def train_llama(seed, ledger):
    """Phase 4i. The Llama example's ``main`` (``LLAMA_ARGS``: hidden
    4096, 32 heads of 128, MLP 11008, vocab 32000, untied head, seq 4096,
    batch 2, ``--flash --remat``, depth 12) at world 1 over NCCL: a
    falling loss, B1 exactly 24 and B2, B3 12 each a step by the launch
    counts and by kernel name in one more step of the example's own
    (``stats["step"]``), profiled, and the parameters after its
    ``LLAMA_STEPS`` steps bitwise those of the same steps under a plain
    ``torch.optim.Adam`` (the twin, built after the example's model is
    freed). Prints step ms, tokens/s, MFU (6 N tokens, N without the
    input embedding, a lookup, plus the causal attention's 6 B T^2
    hidden a layer, over 989 TFLOP/s), the peak memory and the profiled
    step's device time by group."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import llama_adasum
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      causal_lm_loss)
    from horovod_tpu_torch.ops import _build

    del seed  # the example draws its own weights and batch (seed 0)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    _build.reset_launches()
    llama_adasum.main(LLAMA_ARGS, stats)
    torch.cuda.synchronize()
    ledger["train_llama"] = {k: _build.LAUNCHES[k] for k in LLAMA_KERNELS}
    losses = stats["losses"]
    _require(len(losses) == LLAMA_STEPS and all(np.isfinite(losses))
             and losses[-1] < losses[0],
             f"Llama example losses did not fall: {losses}")
    for k, per in LLAMA_LAUNCHES.items():
        _require(ledger["train_llama"][k] == per * LLAMA_STEPS,
                 f"Llama example: {k} launched {ledger['train_llama'][k]} "
                 f"times in {LLAMA_STEPS} steps, not {per} a step")
    peak = torch.cuda.max_memory_allocated() / 1e9
    model, tok = stats["model"], stats["tokens"]
    cfg, n_params = model.cfg, stats["n_params"]
    step_ms, rates = stats["step_ms"], stats["tokens_per_s"]
    got = {k: v.detach().to("cpu") for k, v in model.state_dict().items()}
    kernels = profile_train_step(
        stats["step"], what=f"one Llama-2 step of the example "
                            f"({LLAMA_LAYERS} x 4096, head_dim 128, seq "
                            "4096, batch 2, --flash --remat, Adam under "
                            "op=Adasum)")
    by_name = {k: sum(e.count for e in kernels if k + "_" in e.key)
               for k in LLAMA_KERNELS}
    for k, c in by_name.items():
        _require(c == LLAMA_LAUNCHES[k],
                 f"profiled Llama step: {c} kernels named {k}*, not "
                 f"{LLAMA_LAUNCHES[k]}")
    del stats, model, kernels
    hvd.shutdown()
    torch.cuda.empty_cache()

    # the twin: the same steps under a plain torch.optim.Adam
    with torch.device("cuda"):
        twin = Transformer(cfg, attention_fn=llama_adasum.
                           make_flash_attention_fn(causal=True))
    twin.init_params(torch.Generator(device="cuda").manual_seed(0))
    adam = torch.optim.Adam(twin.parameters(), lr=3e-4)

    def twin_step():
        causal_lm_loss(twin(tok), tok)[0].backward()
        adam.step()
        adam.zero_grad(set_to_none=True)

    for _ in range(LLAMA_STEPS):
        twin_step()
    differ = [k for k, v in twin.state_dict().items()
              if not _bitwise(v.detach().to("cpu"), got[k])]
    _require(not differ, "the Llama example at world 1 is not bitwise "
                         f"plain Adam's steps: {differ}")
    del twin, adam, got
    torch.cuda.empty_cache()
    tokens = 2 * 4096
    n_matmul = n_params - cfg.vocab_size * cfg.hidden_size
    flops = (6 * n_matmul * tokens
             + cfg.num_layers * 6 * 2 * 4096 ** 2 * cfg.hidden_size)
    med = float(np.median(step_ms[1:]))
    print(json.dumps({
        "phase": "train_llama world 1",
        "model": f"Llama-2 {cfg.num_layers} x {cfg.hidden_size}, "
                 f"{cfg.num_heads} heads of {cfg.head_dim}, MLP "
                 f"{cfg.mlp_dim}, vocab {cfg.vocab_size}, untied head",
        "params": n_params, "params_in_flops": n_matmul,
        "args": LLAMA_ARGS, "backend": "nccl",
        "losses": losses, "step_ms": step_ms, "tokens_per_s": rates,
        "step_ms_median_after_first": med,
        "tokens_per_s_median_after_first": tokens / (med / 1e3),
        "model_flops_per_step": flops,
        "mfu": flops / (med / 1e3) / PEAK_OPS["bf16"],
        "peak_mem_gb": peak, "bitwise_plain_adam": True,
        "launches_per_step": {k: ledger["train_llama"][k] / LLAMA_STEPS
                              for k in LLAMA_KERNELS},
        "profiled_step_kernels": by_name}))


# ---------------------------------------------------------------------------
# phase 4j: checkpoint, save and resume
# ---------------------------------------------------------------------------

CKPT_STEPS = 2  # steps before the save, and after the load


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def train_checkpoint(ledger):
    """Phase 4j. GPT-2 medium (phase 4's model: batch 8 x 1024,
    ``--flash --fused-norm``, AdamW, phase 4's weights and batch) at
    world 1 over NCCL: (a) the DistributedOptimizer, ``CKPT_STEPS``
    steps, ``save_model`` with AdamW's state into a temporary directory,
    ``load_model`` into a fresh model (other weights) and optimizer,
    ``CKPT_STEPS`` more: parameters and losses bitwise ``2 x CKPT_STEPS``
    uninterrupted steps; (b) the same through ``save_fsdp``/``load_fsdp``
    with a FullyShardedOptimizer (``make_lm_train_step``), against its
    own uninterrupted steps. Prints the bytes written and the save and
    load seconds; the directory is removed in a ``finally``. Launch
    counts are zeroed just before the runs and read just after."""
    import shutil
    import tempfile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch.examples.gpt2_pretraining import synthetic_tokens
    from horovod_tpu_torch.models.transformer import (GPT2_MEDIUM,
                                                      Transformer,
                                                      causal_lm_loss)
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn

    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    flash = make_flash_attention_fn(causal=True)
    spec = ("AdamW", {"lr": 1e-4, "weight_decay": 1e-4})
    factory = functools.partial(torch.optim.AdamW, **spec[1])
    tokens = torch.from_numpy(synthetic_tokens(
        cfg.vocab_size, 8, 1024, 0, 1)).cuda()
    out = {}
    hvd.init()
    root = tempfile.mkdtemp(prefix="hvd_ckpt_")
    try:
        _require(hvd.nccl_enabled() and hvd.size() == 1,
                 "phase 4j needs a world of one over NCCL")

        def fresh(weights_seed):
            with torch.device("cuda"):
                model = Transformer(cfg, attention_fn=flash)
            model.init_params(torch.Generator(device="cuda").manual_seed(
                weights_seed))
            return model

        def train(model, opt, steps):
            losses = []
            for _ in range(steps):
                loss = causal_lm_loss(model(tokens), tokens)[0]
                loss.backward()
                opt.step()
                opt.zero_grad(set_to_none=True)
                losses.append(loss.item())
            return losses

        def distributed(model):
            return hvd.DistributedOptimizer(
                factory(model.parameters()),
                named_parameters=model.named_parameters())

        _build.reset_launches()
        model = fresh(0)
        ref_losses = train(model, distributed(model), 2 * CKPT_STEPS)
        ref = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model
        torch.cuda.empty_cache()
        model = fresh(0)
        opt = distributed(model)
        losses = train(model, opt, CKPT_STEPS)
        path = os.path.join(root, "model")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_model(path, model, opt_state=opt, optimizer_spec=spec,
                        metadata={"step": CKPT_STEPS})
        save_s = time.perf_counter() - t0
        written = _dir_bytes(path)
        del model, opt
        torch.cuda.empty_cache()
        model = fresh(1)  # other weights: the load must overwrite them
        t0 = time.perf_counter()
        m = ckpt.load_model(path, model=model)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        _require(m.metadata == {"step": CKPT_STEPS},
                 f"phase 4j: metadata {m.metadata}")
        losses += train(model, m.optimizer, CKPT_STEPS)
        diff = _first_difference(model.state_dict(), ref)
        _require(diff is None and losses == ref_losses,
                 f"phase 4j (a): resumed training is not bitwise the "
                 f"uninterrupted steps: {diff}, losses {losses} vs "
                 f"{ref_losses}")
        out["distributed_optimizer"] = {
            "losses": losses, "bitwise": True, "bytes_written": written,
            "save_s": save_s, "load_s": load_s}
        del model, m, ref
        shutil.rmtree(path)
        torch.cuda.empty_cache()

        # (b) FSDP at world 1
        def fsdp():
            return hvd.make_lm_train_step(
                cfg, hvd.FullyShardedOptimizer(factory), attention_fn=flash)

        _, fstep = fsdp()
        ref_losses = [float(fstep(tokens)) for _ in range(2 * CKPT_STEPS)]
        ref = fstep.state_dict()
        del fstep
        torch.cuda.empty_cache()
        _, fstep = fsdp()
        losses = [float(fstep(tokens)) for _ in range(CKPT_STEPS)]
        path = os.path.join(root, "fsdp")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_fsdp(path, fstep.optimizer.shards, fstep.layout,
                       opt_state=fstep.optimizer,
                       metadata={"step": CKPT_STEPS})
        save_s = time.perf_counter() - t0
        written = _dir_bytes(path)
        del fstep
        torch.cuda.empty_cache()
        _, fstep = fsdp()
        t0 = time.perf_counter()
        _, _, meta = ckpt.load_fsdp(path, optimizer=fstep.optimizer)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        losses += [float(fstep(tokens)) for _ in range(CKPT_STEPS)]
        diff = _first_difference(fstep.state_dict(), ref)
        _require(diff is None and losses == ref_losses
                 and meta == {"step": CKPT_STEPS},
                 f"phase 4j (b): resumed FSDP training is not bitwise the "
                 f"uninterrupted steps: {diff}, losses {losses} vs "
                 f"{ref_losses}")
        torch.cuda.synchronize()
        ledger["train_checkpoint"] = {k: _build.LAUNCHES[k]
                                      for k in TRAIN_KERNELS}
        out["fsdp"] = {"losses": losses, "bitwise": True,
                       "bytes_written": written, "save_s": save_s,
                       "load_s": load_s,
                       "buckets": len(fstep.layout.plans)}
        del fstep, ref
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        hvd.shutdown()
    print(json.dumps({"phase": "train_checkpoint world 1",
                      "model": "GPT-2 medium 24x1024, batch 8x1024, AdamW",
                      "steps": f"{CKPT_STEPS} + save/load + {CKPT_STEPS}",
                      **out}))


# ---------------------------------------------------------------------------
# phase 4k: elastic training, preemption and the recovery ladder
# ---------------------------------------------------------------------------

#: the elastic example at GPT-2 medium's width: 16 heads of 64, MLP 4096
ELASTIC_ARGS = ["--layers", "24", "--hidden", "1024", "--vocab", "50257",
                "--seq-len", "1024", "--batch-size", "8", "--flash",
                "--steps", "30", "--commit-every", "10"]
ELASTIC_STEPS = 30
ELASTIC_COMMIT_EVERY = 10
ELASTIC_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
ELASTIC_LAYERS = 24
#: a launcher run of phase 4k that takes longer fails the smoke
ELASTIC_TIMEOUT_S = 420.0
#: (c)'s fault: rank 0's worker dies at its second commit (step 20)
ELASTIC_KILL_SPEC = "worker:kill:rank=0:step=2"


def _elastic_digests(model, adam):
    """sha256 of the bytes of every parameter and of Adam's two moments
    and step count for it, by name."""
    import hashlib

    def digest(t):
        a = t.detach().contiguous().cpu().reshape(-1).view(
            torch.uint8).numpy()
        return hashlib.sha256(a).hexdigest()

    out = {}
    for name, p in model.named_parameters():
        out[name] = digest(p)
        for key, v in adam.state[p].items():
            out[f"{name}/{key}"] = digest(v)
    return out


def _elastic_round():
    """This worker's elastic round and host, from the launcher's
    rendezvous store."""
    from horovod_tpu_torch.runner.http import http_client
    from horovod_tpu_torch.runner.util.hosts import SlotInfo

    addr = os.environ["HVD_TPU_RENDEZVOUS_ADDR"]
    port = int(os.environ["HVD_TPU_RENDEZVOUS_PORT"])
    rank = os.environ.get("HOROVOD_RANK", "0")
    rnd = int(http_client.get(addr, port, "rendezvous", "round"))
    slot = SlotInfo.from_response_string(http_client.get(
        addr, port, "rendezvous", f"rank_{rank}").decode())
    return rnd, slot.hostname


def elastic_worker(out_path):
    """Phase 4k's worker, run by the elastic launcher: the example's
    ``main`` at ``ELASTIC_ARGS``; writes the digests, the launch counts,
    the commit seconds and the wall time of its first step to
    ``out_path``. A respawned round drops the fault spec, so that only
    the first round dies at its commit."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import gpt2_elastic
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.utils import faults

    rnd, host = _elastic_round()
    if rnd:
        os.environ.pop("HOROVOD_TPU_FAULT_SPEC", None)
        faults.reset()
    print(f"elastic worker: round {rnd} on {host}", flush=True)
    real, first = gpt2_elastic.allreduce, []

    def timed(x, *args, **kwargs):  # the step's loss: once a step
        out = real(x, *args, **kwargs)
        if not first:
            torch.cuda.synchronize()
            first.append(time.time())
        return out

    gpt2_elastic.allreduce = timed
    _build.reset_launches()
    stats = {}
    gpt2_elastic.main(ELASTIC_ARGS, stats)
    torch.cuda.synchronize()
    with open(out_path, "w") as f:
        json.dump({"round": rnd, "host": host,
                   "digests": _elastic_digests(stats["model"],
                                               stats["optimizer"]),
                   "launches": {k: _build.LAUNCHES[k]
                                for k in ELASTIC_KERNELS},
                   "losses": stats["losses"],
                   "commit_s": stats["commit_s"],
                   "first_step_unix": first[0]}, f)
    hvd.shutdown()
    return 0


def _children(pid):
    """The pids whose parent is ``pid`` (from /proc)."""
    kids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            kids.append(int(entry))
    return kids


def _elastic_launch(args, out_path, env_extra=None, on_line=None):
    """Run the elastic launcher over ``elastic_worker``; each output line
    is stamped with ``time.time()`` and handed to ``on_line(t, line,
    proc)``. Returns ``(exit code, [(t, line)], t0, t1)``. Past
    ``ELASTIC_TIMEOUT_S`` the launcher gets SIGTERM (its driver stops the
    round's workers) and the smoke fails."""
    import signal
    import threading

    argv = _launcher(*args, sys.executable,
                     os.path.join(HERE, "chip_smoke.py"),
                     "--elastic-worker", out_path)
    env = _child_env()
    env.update(env_extra or {})
    t0 = time.time()
    proc = subprocess.Popen(argv, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []

    def pump():
        for line in proc.stdout:
            t = time.time()
            lines.append((t, line.rstrip("\n")))
            if on_line is not None:
                on_line(t, lines[-1][1], proc)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=ELASTIC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        raise SmokeFailure("elastic launch ran over "
                           f"{ELASTIC_TIMEOUT_S} s:\n"
                           + "\n".join(l for _, l in lines[-30:]))
    t1 = time.time()
    reader.join(timeout=30)
    for t, line in lines:
        print(f"elastic +{t - t0:.2f} s: {line}")
    return rc, lines, t0, t1


def _elastic_line(lines, text):
    return next(((t, l) for t, l in lines if text in l), (None, None))


def train_elastic(ledger):
    """Phase 4k. The port of ``examples/gpt2_elastic.py`` at GPT-2
    medium's width (``ELASTIC_ARGS``: 24 x 1024, 16 heads of 64, vocab
    50257, batch 8 x 1024, ``--flash``, 30 steps, a commit every 10) at
    world 1 over NCCL:

    (a) in process through its ``main``: a falling loss, B1-B3 exactly
        24 a step by the launch counts; each commit interval's ms a step
        and tokens/s, each ``commit()``'s seconds; the sha256 of every
        parameter's and Adam moment's bytes after 30 steps; and
        ``hvd.data.device_prefetch`` of four token batches to the card,
        each equal to its rows;
    (b) preempted: ``launch -np 1 --min-np 1 --max-np 1
        --host-discovery-script`` (``echo localhost:1``)
        ``--emergency-checkpoint``, the worker ``elastic_worker``; after
        the worker's ``step 10:`` line the worker (the launcher's child,
        found under /proc) gets SIGTERM: it must exit 83 (the driver's
        "preempted; host stays eligible" line, no blacklisting), the
        second round runs on localhost and recovers from the emergency
        rung at commit epoch 1 or later (its log names the rung), and its
        digests are (a)'s, bitwise; SIGTERM -> exit seconds, the file's
        bytes, exit -> the second round's first step, the job's seconds;
    (c) killed: ``HOROVOD_TPU_FAULT_SPEC=worker:kill:rank=0:step=2`` and a
        discovery script printing ``localhost:1`` and ``127.0.0.1:1``:
        the first round dies at its second commit, localhost is
        blacklisted, the second round runs on 127.0.0.1 from step 0 (no
        peer, no emergency file) and the launcher exits 0 with (a)'s
        digests, bitwise.

    Each run's launch counts are zeroed just before it and read just
    after (the workers' own, for (b) and (c))."""
    import gc
    import shutil
    import signal
    import tempfile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.examples import gpt2_elastic
    from horovod_tpu_torch.ops import _build

    per_step = ELASTIC_LAYERS
    report = {"phase": "train_elastic",
              "model": "GPT-2 medium width 24x1024, batch 8x1024, Adam"}
    torch.cuda.empty_cache()

    # (a) in process
    stats = {}
    _build.reset_launches()
    t0 = time.perf_counter()
    gpt2_elastic.main(ELASTIC_ARGS, stats)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    ledger["train_elastic"] = {k: _build.LAUNCHES[k] for k in
                               ELASTIC_KERNELS}
    for k in ELASTIC_KERNELS:
        _require(ledger["train_elastic"][k] == per_step * ELASTIC_STEPS,
                 f"phase 4k (a): {k} launched {ledger['train_elastic'][k]}"
                 f" times in {ELASTIC_STEPS} steps, not {per_step} a step")
    losses = stats["losses"]
    _require(len(losses) == ELASTIC_STEPS and all(np.isfinite(losses))
             and losses[-1] < losses[0],
             f"phase 4k (a): losses did not fall: {losses}")
    want = _elastic_digests(stats["model"], stats["optimizer"])
    report["a_in_process"] = {
        "losses_first_last": [losses[0], losses[-1]],
        "interval_step_ms": stats["interval_step_ms"],
        "tokens_per_s": stats["tokens_per_s"],
        "commit_s": stats["commit_s"], "wall_s": wall_a,
        "digests": len(want), "launches": ledger["train_elastic"]}
    # the data helpers' card path: device_prefetch's pinned copies on a
    # side stream, each batch equal to a blocking copy
    from horovod_tpu_torch.data import device_prefetch

    rows = [gpt2_elastic.tokens(50257, 8, 1024, r, 4) for r in range(4)]
    got = list(device_prefetch(iter(rows), size=2))
    _require(len(got) == 4 and all(
        g.is_cuda and torch.equal(g.cpu(), torch.from_numpy(w))
        for g, w in zip(got, rows)),
        "phase 4k: device_prefetch's batches differ from their rows")
    report["a_in_process"]["device_prefetch"] = "4 batches equal"
    # the run armed the preemption handler in this process: disarm it
    elastic.preemption.uninstall()
    hvd.shutdown()
    del stats
    gc.collect()
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="hvd_elastic_")
    try:
        one = os.path.join(root, "one.sh")
        with open(one, "w") as f:
            f.write("#!/bin/sh\necho localhost:1\n")
        two = os.path.join(root, "two.sh")
        with open(two, "w") as f:
            f.write("#!/bin/sh\necho localhost:1\necho 127.0.0.1:1\n")
        for path in (one, two):
            os.chmod(path, 0o755)

        # (b) preempted after the worker's first commit
        emergency = os.path.join(root, "emergency.pkl")
        out_b = os.path.join(root, "b.json")
        sent = {}

        def preempt(t, line, proc):
            if "sigterm" in sent or "step 10:" not in line:
                return
            workers = [pid for pid in _children(proc.pid)
                       if "--elastic-worker" in open(
                           f"/proc/{pid}/cmdline").read()]
            if workers:
                sent["sigterm"], sent["pid"] = time.time(), workers[0]
                os.kill(workers[0], signal.SIGTERM)

                def gone():
                    while os.path.exists(f"/proc/{workers[0]}"):
                        time.sleep(0.02)
                    sent["exit"] = time.time()

                import threading

                threading.Thread(target=gone, daemon=True).start()

        rc, lines, t0, t1 = _elastic_launch(
            ["-np", "1", "--min-np", "1", "--max-np", "1",
             "--host-discovery-script", one,
             "--emergency-checkpoint", emergency], out_b, on_line=preempt)
        text = "\n".join(l for _, l in lines[-40:])
        _require(rc == 0 and "exit" in sent,
                 f"phase 4k (b): launcher exit {rc}, signal {sent}:\n"
                 + text)
        _, pre = _elastic_line(lines, "rank 0 on localhost preempted")
        _require(pre is not None and _elastic_line(
            lines, "blacklisting")[1] is None,
                 "phase 4k (b): the worker did not exit 83, or localhost "
                 "was blacklisted:\n" + text)
        _, rung = _elastic_line(lines, "recovered state from emergency "
                                       "snapshot (commit epoch ")
        epoch = int(rung.rsplit("epoch ", 1)[1].split(")")[0]) if rung \
            else 0
        _, second = _elastic_line(lines, "elastic worker: round 1 on "
                                         "localhost")
        _require(epoch >= 1 and second is not None,
                 "phase 4k (b): no second round on localhost recovering "
                 "from the emergency rung:\n" + text)
        with open(out_b) as f:
            got_b = json.load(f)
        diff = sorted(k for k in want if got_b["digests"].get(k) != want[k])
        _require(not diff and len(got_b["digests"]) == len(want),
                 f"phase 4k (b): {len(diff)} tensors differ from (a), "
                 f"e.g. {diff[:4]}")
        resumed = ELASTIC_STEPS - epoch * ELASTIC_COMMIT_EVERY
        for k in ELASTIC_KERNELS:
            _require(got_b["launches"][k] == per_step * resumed,
                     f"phase 4k (b): {k} launched {got_b['launches'][k]} "
                     f"times in the second round's {resumed} steps")
        ledger["train_elastic_preempted"] = got_b["launches"]
        report["b_preempted"] = {
            "bitwise": True, "recovered_epoch": epoch,
            "sigterm_to_exit_s": sent["exit"] - sent["sigterm"],
            "emergency_bytes": os.path.getsize(emergency),
            "exit_to_first_step_s": got_b["first_step_unix"] - sent["exit"],
            "job_s": t1 - t0, "a_wall_s": wall_a,
            "second_round_commit_s": got_b["commit_s"]}
        os.remove(emergency)

        # (c) killed at its second commit
        out_c = os.path.join(root, "c.json")
        rc, lines, t0, t1 = _elastic_launch(
            ["-np", "1", "--min-np", "1", "--max-np", "1",
             "--host-discovery-script", two], out_c,
            env_extra={"HOROVOD_TPU_FAULT_SPEC": ELASTIC_KILL_SPEC})
        text = "\n".join(l for _, l in lines[-40:])
        _require(rc == 0, f"phase 4k (c): launcher exit {rc}:\n" + text)
        _, black = _elastic_line(lines, "blacklisting failed host localhost")
        _, second = _elastic_line(lines, "elastic worker: round 1 on "
                                         "127.0.0.1")
        _require(black is not None and second is not None,
                 "phase 4k (c): localhost not blacklisted, or no second "
                 "round on 127.0.0.1:\n" + text)
        with open(out_c) as f:
            got_c = json.load(f)
        diff = sorted(k for k in want if got_c["digests"].get(k) != want[k])
        _require(not diff and len(got_c["digests"]) == len(want),
                 f"phase 4k (c): {len(diff)} tensors differ from (a), "
                 f"e.g. {diff[:4]}")
        for k in ELASTIC_KERNELS:
            _require(got_c["launches"][k] == per_step * ELASTIC_STEPS,
                     f"phase 4k (c): {k} launched {got_c['launches'][k]} "
                     f"times in the second round's {ELASTIC_STEPS} steps")
        ledger["train_elastic_killed"] = got_c["launches"]
        report["c_killed"] = {"bitwise": True, "job_s": t1 - t0,
                              "blacklisted": "localhost",
                              "second_round_host": "127.0.0.1"}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(report))


# ---------------------------------------------------------------------------
# phase 4l: the eager negotiation runtime carrying GPT-2 medium's buckets
# ---------------------------------------------------------------------------

EAGER_STEPS = 10
#: GPT-2 medium's DistributedOptimizer buckets at the 128 MiB threshold
EAGER_BUCKETS = 12
#: the int8 wire of (b)
EAGER_BLOCK = 256
#: ``torch.cuda._sleep`` cycles ahead of the bucket's write in (c):
#: about 70 ms at the H100's boost clock, far longer than a negotiation
#: cycle and the execute thread's handoff
EAGER_SPIN_CYCLES = 1 << 27
#: (c)'s bucket: 16 Mi float32 (64 MiB), of the order of a bucket
EAGER_READY_NUMEL = 1 << 24
#: (d): the watchdog, and how much later than it the raise may come (a
#: few of the watchdog's 0.25 s wait slices)
EAGER_STALL_ABORT_S = 2.0
EAGER_STALL_SLACK_S = 1.5
#: (e): the launcher's flags of the runtime's knobs
EAGER_LAUNCH_FLAGS = ["--cycle-time-ms", "2", "--cache-capacity", "256",
                      "--stall-abort-seconds", "120"]
INT8_KERNELS = ("quant_rows", "quant_ef_rows", "accum_rows", "dequant_flat")


class _EagerBucketsAdamW(torch.optim.AdamW):
    """AdamW whose step first averages the gradients' fusion buckets
    through the eager runtime: ``hvd.grouped_allreduce_async`` of every
    bucket of the plan, ``op=Average`` (one all-or-nothing group, fused
    by the controller, executed by the ``DistExecutor``), the results
    written back into ``.grad``. ``bind`` gives it the plan once the
    model exists."""

    def bind(self, plans, params):
        self.plans, self.ordered = plans, params

    @torch.no_grad()
    def step(self, closure=None):
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops.fusion import (pack_buckets_by_plan,
                                                  unflatten_buckets_by_plan)

        buckets = pack_buckets_by_plan([p.grad for p in self.ordered],
                                       self.plans)
        reduced = hvd.synchronize(hvd.grouped_allreduce_async(
            buckets, op=hvd.Average, name="gpt2.grad"))
        for p, g in zip(self.ordered, unflatten_buckets_by_plan(
                reduced, self.plans, len(self.ordered))):
            p.grad.copy_(g)
        return super().step(closure)


def _eager_gpt2(cfg, optimizer_cls):
    """GPT-2 medium (random weights from seed 0, flash attention) and a
    step at world 1: the causal-LM loss weighted as
    ``make_lm_train_step`` weights it at world 1 (``1 / n`` of the valid
    targets), AdamW (lr 1e-4, weight decay 1e-4) of ``optimizer_cls``."""
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      causal_lm_nll)
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn

    with torch.device("cuda"):
        model = Transformer(cfg, attention_fn=make_flash_attention_fn(
            causal=True))
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    opt = optimizer_cls(model.parameters(), lr=1e-4, weight_decay=1e-4)

    def step(tokens):
        nll, count = causal_lm_nll(model(tokens), tokens)
        n = count.double().clamp(min=1)
        (nll * (1 / n).float()).backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return float(nll.detach().double().float() / n.float())

    return model, opt, step


class _RecordingExecutor:
    """The runtime's executor with a record of every batch it ran: the
    packed float32 input, the bucket's error-feedback residual before
    and after, and the outputs (phase 4l (b) holds them against the
    plain composition)."""

    def __init__(self, inner):
        self.inner = inner
        self.log = []

    def __getattr__(self, item):
        return getattr(self.inner, item)

    def __call__(self, batch, tensors):
        mine = tuple(batch.names)
        before = {k: v.clone() for k, v in self.inner._wire_residuals.items()
                  if k[0] == mine}
        flat = torch.cat([tensors[n].reshape(-1) for n in batch.names])
        out = self.inner(batch, tensors)
        key, res = next((k, v) for k, v in
                        self.inner._wire_residuals.items() if k[0] == mine)
        self.log.append((list(batch.names), flat.to(torch.float32),
                         before.get(key), res,
                         [out[n] for n in batch.names]))
        return out


def _eager_int8_plain(log):
    """Each recorded batch's sum and residual against the plain versions
    of B11-B14 composed on the same buffer and residual (world 1):
    bitwise. Returns the number of batches held."""
    from horovod_tpu_torch.ops.quantized_collectives import \
        emulated_quantized_psum

    with _plain_quantized():
        for names, flat, res, new_res, outs in log:
            if res is None:
                res = torch.zeros_like(flat)
            (y,), (err,) = emulated_quantized_psum([flat], 1, EAGER_BLOCK,
                                                   [res])
            got = torch.cat([o.reshape(-1) for o in outs])
            _require(_bitwise(got, y.to(got.dtype)) and _bitwise(new_res,
                                                                 err),
                     f"phase 4l (b): batch {names[:2]}... is not the plain "
                     "composition of B11-B14 on its buffer")
    return len(log)


class _BlockingExecutor:
    """An executor that blocks (a stuck data plane) until the watchdog's
    abort releases it; the abort also aborts the inner executor's
    group."""

    def __init__(self, inner):
        import threading

        self.inner = inner
        self.wire = inner.wire
        self.release = threading.Event()

    def __call__(self, batch, tensors):
        self.release.wait(timeout=60.0)
        return {}

    def abort(self):
        self.release.set()
        self.inner.abort()


def eager_stall_worker() -> int:
    """Phase 4l (d), in a process of its own (a stuck card must not hold
    the smoke): the runtime with ``stall_abort_s`` =
    ``EAGER_STALL_ABORT_S`` and an executor that blocks; the waiting
    thread must raise "stalled" and the world must then shut down.
    Prints one JSON line."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.exceptions import HorovodInternalError
    from horovod_tpu_torch.core.state import global_state

    os.environ["HVD_TPU_NATIVE"] = "1"
    os.environ["HOROVOD_STALL_ABORT_S"] = str(EAGER_STALL_ABORT_S)
    hvd.init()
    rt = global_state().eager_runtime
    rt._executor = _BlockingExecutor(rt._executor)
    h = hvd.allreduce_async(torch.ones(1 << 20, device="cuda"),
                            name="stuck", op=hvd.Sum)
    t0 = time.perf_counter()
    raised = None
    try:
        hvd.synchronize(h)
    except HorovodInternalError as e:
        raised = str(e)
    raise_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hvd.shutdown()
    print(json.dumps({"raised": raised, "raise_s": raise_s,
                      "shutdown_s": time.perf_counter() - t0}), flush=True)
    return 0


def launched_eager_step():
    """``runner.run``'s function for phase 4l (e): one GPT-2 medium step
    through the example's ``main`` (``RUN_ARGS``) with the eager runtime
    live (the caller's env), metrics on to count the runtime's batches;
    its launch counts zeroed just before and read just after, the
    runtime's facts read before shutdown."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.examples import gpt2_pretraining
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.utils import metrics

    metrics.enable()
    stats = {}
    _build.reset_launches()
    gpt2_pretraining.main(RUN_ARGS, stats)
    torch.cuda.synchronize()
    st = global_state()
    rt, k = st.eager_runtime, st.knobs
    fused = metrics.registry.snapshot().get("hvd_fused_tensors_total", {})
    out = {"device": str(hvd.device()), "size": hvd.size(),
           "launches": dict(_build.LAUNCHES), "losses": stats["losses"],
           "runtime": rt is not None,
           "coordinator_port": rt.coordinator_port if rt else None,
           "published_port": int(os.environ.get(
               "HVD_TPU_NATIVE_COORDINATOR_PORT", "0")),
           "knobs": [k.cycle_time_ms, k.cache_capacity,
                     k.stall_abort_time_seconds],
           "fused_tensors_by_op": fused,
           "snapshot": rt.metrics_snapshot() if rt else None}
    stats.clear()
    hvd.shutdown()
    metrics.reset()
    return out


def _eager_launch(ledger, in_process_losses):
    """Phase 4l (e): phase 4e's launched GPT-2 medium with the runtime:
    the command line with ``EAGER_LAUNCH_FLAGS`` and ``HVD_TPU_NATIVE=1``
    (exit 0, the runtime's line with the flags' values and the published
    port, the ``[0]iter 0`` loss as phase 4e prints it), and
    ``runner.run(launched_eager_step, np=1)`` with the same knobs: its
    runtime got the published port and the knobs, the example's
    broadcasts ran through it, B1-B5 exactly ``STEP_LAUNCHES``, and its
    loss bitwise phase 4's step 1 (phase 4e's ``run()`` leg)."""
    import importlib

    from horovod_tpu_torch.runner import run

    torch.cuda.empty_cache()
    env = {"HVD_TPU_NATIVE": "1", "HOROVOD_LOG_LEVEL": "INFO"}
    rc, lines, wall = _stream(
        _launcher("-np", "1", "-H", "localhost:1", *EAGER_LAUNCH_FLAGS,
                  *_gpt2(*LAUNCH_ARGS)), env_extra=env)
    text = "\n".join(l for _, l in lines[-30:])
    _require(rc == 0, f"phase 4l (e): launch exit {rc}:\n{text}")
    rt_line = next((l for _, l in lines if "eager runtime: rank 0 of 1"
                    in l), None)
    m = rt_line and re.search(
        r"coordinator ([\d.]+):(\d+), cycle 2.0 ms, cache 256, "
        r"stall abort 120.0 s", rt_line)
    _require(m and int(m.group(2)) > 0,
             f"phase 4l (e): no runtime line with the flags' knobs and a "
             f"published port: {rt_line!r}\n{text}")
    _, iter_line = _first(lines, "[0]iter 0: ")
    want = f"(loss {in_process_losses[LAUNCH_STEPS - 1]:.3f})"
    _require(iter_line is not None and iter_line.endswith(want),
             f"phase 4l (e): [0]iter 0 line {iter_line!r}, phase 4e "
             f"prints {want}")
    _, rate_line = _first(lines, "[0]tokens/sec on 1 rank(s): ")
    smoke = importlib.import_module("chip_smoke")
    run_env = dict(_child_env(), HVD_TPU_NATIVE="1",
                   HOROVOD_CYCLE_TIME="2", HOROVOD_CACHE_CAPACITY="256",
                   HOROVOD_STALL_ABORT_S="120")
    t0 = time.perf_counter()
    res = run(smoke.launched_eager_step, np=1, env=run_env)[0]
    run_s = time.perf_counter() - t0
    _require(res["runtime"] and res["device"] == "cuda:0"
             and res["size"] == 1
             and res["coordinator_port"] == res["published_port"] > 0
             and res["knobs"] == [2.0, 256, 120.0],
             f"phase 4l (e): run(): runtime {res['runtime']}, port "
             f"{res['coordinator_port']} of {res['published_port']}, "
             f"knobs {res['knobs']}")
    _require(res["fused_tensors_by_op"].get("broadcast", 0) > 0,
             "phase 4l (e): the example's broadcasts did not run through "
             f"the runtime: {res['fused_tensors_by_op']}")
    _require(res["losses"] == in_process_losses[:1],
             f"phase 4l (e): run() losses {res['losses']}, phase 4's step "
             f"1 {in_process_losses[0]!r}")
    _exact_launches(res["launches"], 1, "phase 4l (e) run()")
    ledger["eager_launch_run"] = res["launches"]
    return {"cli": {"rc": rc, "wall_s": wall, "runtime_line": rt_line,
                    "iter0_loss": iter_line.rsplit("(loss ", 1)[1][:-1],
                    "tokens_per_s": float(rate_line.split(": ")[1].split()[0])
                    if rate_line else None},
            "run": {"wall_s": run_s, "losses": res["losses"],
                    "coordinator_port": res["coordinator_port"],
                    "fused_tensors_by_op": res["fused_tensors_by_op"],
                    "executor_batches": res["snapshot"]["executor_batches"],
                    "bytes_negotiated": res["snapshot"]["bytes_negotiated"]}}


def _eager_ready_wait():
    """Phase 4l (c): a bucket written on the producer's stream behind a
    spin kernel reaches the runtime's stream only through the ready
    event: with the wait, the average (world 1) is the bucket; with the
    wait monkeypatched out, the runtime reads it before the write and
    the result must differ."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import eager_runtime

    src = torch.randn(EAGER_READY_NUMEL, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(5))

    def produce(k):
        buf = torch.full_like(src, float("nan"))
        torch.cuda._sleep(EAGER_SPIN_CYCLES)
        buf.copy_(src * k)
        out = hvd.synchronize(hvd.grouped_allreduce_async(
            [buf], op=hvd.Average, name="ready"))[0]
        torch.cuda.synchronize()
        return _bitwise(out, src * k)

    torch.cuda.synchronize()
    waited = [produce(k) for k in (1.0, 2.0)]
    saved = eager_runtime._wait_ready
    eager_runtime._wait_ready = lambda stream, events: None
    try:
        dropped = [produce(k) for k in (3.0, 4.0)]
    finally:
        eager_runtime._wait_ready = saved
    _require(all(waited), "phase 4l (c): the bucket did not arrive "
                          f"through the ready event: {waited}")
    _require(not any(dropped), "phase 4l (c): with the ready-event wait "
                               "dropped the runtime still read the "
                               f"written bucket: {dropped}")
    return {"with_wait_bitwise": waited, "dropped_wait_bitwise": dropped,
            "spin_cycles": EAGER_SPIN_CYCLES,
            "bucket_mib": EAGER_READY_NUMEL * 4 / 2 ** 20}


def train_eager(seed, ledger, in_process_losses):
    """Phase 4l: the eager negotiation runtime (``HVD_TPU_NATIVE=1``,
    ``ops/eager_runtime.py``: the C++ controller, the plan cache, the
    ``DistExecutor`` on a process group of its own) carrying GPT-2
    medium's gradient buckets at world 1 over NCCL (24 x 1024, batch 8 x
    1024, flash attention and fused norms, AdamW):

    (a) ``EAGER_STEPS`` steps whose 12 buckets (``gpt2_medium_plan``) go
        through ``hvd.grouped_allreduce_async(op=Average)`` into the
        runtime, against the same steps without it: every parameter and
        loss bitwise, the plan frozen after the warmup, the later steps
        negotiating 0 bytes, step ms beside the steps without the
        runtime, the controller's cycles, the executor's host seconds;
    (b) the same on the int8 + error-feedback wire (block 256): each
        fused batch's sum and residual bitwise the plain composition of
        B11-B14 on the same buffer, B11-B14 launched exactly once each a
        fused batch a step, a falling loss, one step profiled;
    (c) a dropped ready-event wait must lose the bucket
        (``_eager_ready_wait``);
    (d) the stall watchdog in a process of its own
        (``eager_stall_worker``): "stalled" within the watchdog plus
        ``EAGER_STALL_SLACK_S``, then the world shuts down;
    (e) phase 4e's launched GPT-2 medium with the runtime
        (``_eager_launch``).

    Launch counts are zeroed just before each run and read just after."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.examples.gpt2_pretraining import synthetic_tokens
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.eager_runtime import DistExecutor
    from horovod_tpu_torch.optim.compression import WireSpec

    t_phase = time.perf_counter()
    report = {"phase": "eager", "model": "GPT-2 medium 24x1024, 16 heads",
              "batch": "8x1024", "steps": EAGER_STEPS}
    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    os.environ["HVD_TPU_NATIVE"] = "1"
    try:
        hvd.init()
        rt = global_state().eager_runtime
        _require(rt is not None and isinstance(rt._executor, DistExecutor),
                 "phase 4l: hvd.init() with HVD_TPU_NATIVE=1 started no "
                 "runtime on a DistExecutor")
        tokens = torch.from_numpy(synthetic_tokens(
            cfg.vocab_size, 8, 1024, 0, 1)).cuda()

        def timed(step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(tokens)
            torch.cuda.synchronize()
            return loss, (time.perf_counter() - t0) * 1e3

        # the same steps without the runtime
        model, _, step = _eager_gpt2(cfg, torch.optim.AdamW)
        ref = [timed(step) for _ in range(EAGER_STEPS)]
        ref_losses = [l for l, _ in ref]
        ref_state = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}
        del model, step
        torch.cuda.empty_cache()

        # (a) the float32 wire
        model, opt, step = _eager_gpt2(cfg, _EagerBucketsAdamW)
        plans, params = gpt2_medium_plan(model)
        _require(len(plans) == EAGER_BUCKETS,
                 f"phase 4l: {len(plans)} buckets, not {EAGER_BUCKETS}")
        opt.bind(plans, params)
        snap0 = rt.metrics_snapshot()
        _build.reset_launches()
        steps = []
        for _ in range(EAGER_STEPS):
            before = rt.metrics_snapshot()
            loss, ms = timed(step)
            after = rt.metrics_snapshot()
            steps.append({
                "loss": loss, "ms": ms,
                "negotiated_bytes": after["bytes_negotiated"]
                - before["bytes_negotiated"],
                "fast_path": after["fast_path_active"] == 1,
                "batches": after["executor_batches"]
                - before["executor_batches"],
                "executor_ms": (after["executor_seconds"]
                                - before["executor_seconds"]) * 1e3,
                "cycles": after["cycles"] - before["cycles"],
                "coordinator_work_us": after["work_us"] - before["work_us"]})
        counts = dict(_build.LAUNCHES)
        ledger["eager_a"] = counts
        _exact_launches(counts, EAGER_STEPS, "phase 4l (a)")
        diff = _first_difference(model.state_dict(), ref_state)
        losses = [s["loss"] for s in steps]
        _require(diff is None and losses == ref_losses,
                 f"phase 4l (a): not bitwise the steps without the "
                 f"runtime: {diff}, losses {losses} vs {ref_losses}")
        frozen = [i for i, s in enumerate(steps) if s["fast_path"]]
        _require(frozen and frozen == list(range(frozen[0], EAGER_STEPS)),
                 f"phase 4l (a): the plan did not freeze and stay: "
                 f"{[s['fast_path'] for s in steps]}")
        zero = [s["negotiated_bytes"] == 0 for s in steps[frozen[0]:]]
        _require(all(zero), "phase 4l (a): steps after the freeze "
                 f"negotiated {[s['negotiated_bytes'] for s in steps]}")
        snap1 = rt.metrics_snapshot()
        report["a"] = {
            "bitwise_params_and_losses": True, "buckets": len(plans),
            "freeze_step": frozen[0] + 1, "zero_byte_steps": len(zero),
            "losses": losses,
            "phase4_losses_bitwise": ref_losses[:TRAIN_STEPS]
            == in_process_losses,
            "steps": steps, "ref_step_ms": [ms for _, ms in ref],
            "step_ms_median": float(np.median([s["ms"] for s in steps])),
            "ref_step_ms_median": float(np.median([ms for _, ms in ref])),
            "runtime_totals": {k: snap1[k] - snap0[k] for k in (
                "cycles", "busy_cycles", "work_us", "wait_us",
                "bytes_negotiated", "responses", "executor_seconds",
                "executor_batches", "fast_path_steps", "cache_hits")},
            "launches_per_step": {k: counts[k] / EAGER_STEPS
                                  for k in STEP_LAUNCHES}}
        del model, opt, step
        torch.cuda.empty_cache()

        # (b) the int8 + error-feedback wire
        rt.set_wire(WireSpec("int8", EAGER_BLOCK, error_feedback=True))
        recorder = _RecordingExecutor(rt._executor)
        rt._executor = recorder
        model, opt, step = _eager_gpt2(cfg, _EagerBucketsAdamW)
        opt.bind(*gpt2_medium_plan(model))
        total = {}
        b_steps = []
        for i in range(EAGER_STEPS):
            recorder.log = []
            _build.reset_launches()
            loss, ms = timed(step)
            counts = dict(_build.LAUNCHES)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            batches = len(recorder.log)
            _exact_launches(counts, 1, f"phase 4l (b) step {i + 1}")
            # each fused batch: B12 on its buffer and residual, B13 and
            # B11 on its shard, B14 on the gathered codes
            for name in INT8_KERNELS:
                _require(counts[name] == batches,
                         f"phase 4l (b) step {i + 1}: {name} launched "
                         f"{counts[name]} times for {batches} batches")
            held = _eager_int8_plain(recorder.log)
            b_steps.append({"loss": loss, "ms": ms, "batches": held,
                            "fast_path": rt.fast_path_stats()["active"]})
        ledger["eager_b"] = total
        b_losses = [s["loss"] for s in b_steps]
        _require(all(np.isfinite(b_losses)) and b_losses[-1] < b_losses[0],
                 f"phase 4l (b): the loss did not fall: {b_losses}")
        recorder.log = []
        with _profiled() as prof:
            step(tokens)
            torch.cuda.synchronize()
        names = (("quantize_kernel<true>", "quant_ef_rows"),
                 ("quantize_kernel<false>", "quant_rows"),
                 ("accum_kernel", "accum_rows"),
                 ("dequant_kernel", "dequant_flat"), ("nccl", "nccl"))
        by = {}
        for e in _kernel_events(prof):
            name = next((v for k, v in names if k in e.key.lower()
                         or k in e.key), None)
            if name is not None:
                by[name] = by.get(name, 0.0) + _dev_us(e) / 1e3
        report["b"] = {
            "wire": f"int8 block {EAGER_BLOCK} ef",
            "bitwise_plain_composition": True, "steps": b_steps,
            "int8_launches_per_step": {k: total[k] / EAGER_STEPS
                                       for k in INT8_KERNELS},
            "profiled_step_device_ms": by,
            "step_ms_median": float(np.median([s["ms"] for s in b_steps]))}
        rt._executor = recorder.inner
        rt.set_wire(None)
        del model, opt, step, recorder
        torch.cuda.empty_cache()

        # (c) the ready event
        report["c"] = _eager_ready_wait()
        hvd.shutdown()
    finally:
        os.environ.pop("HVD_TPU_NATIVE", None)
        if hvd.is_initialized():
            hvd.shutdown()
    torch.cuda.empty_cache()

    # (d) the stall watchdog, in a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                           "--eager-stall-worker"], cwd=HERE,
                          env=_child_env(), capture_output=True, text=True,
                          timeout=180)
    line = next((l for l in reversed(proc.stdout.splitlines())
                 if l.startswith("{")), None)
    _require(proc.returncode == 0 and line,
             f"phase 4l (d): exit {proc.returncode}:\n{proc.stderr[-3000:]}")
    d = json.loads(line)
    _require(d["raised"] and "stalled" in d["raised"]
             and d["raise_s"] < EAGER_STALL_ABORT_S + EAGER_STALL_SLACK_S,
             f"phase 4l (d): {d}")
    report["d"] = {**d, "abort_s": EAGER_STALL_ABORT_S,
                   "process_s": time.perf_counter() - t0}

    # (e) the launcher
    report["e"] = _eager_launch(ledger, in_process_losses)
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(report))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: training ResNet-50
# ---------------------------------------------------------------------------

RESNET_ARGS = ["--fused-bn", "--batch-size", "128",
               "--num-warmup-batches", "1", "--num-batches-per-iter", "5",
               "--num-iters", "1"]
RESNET_STEPS = 6  # 1 warm-up + 5 timed, as RESNET_ARGS says
BN_KERNELS = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx")
#: BatchNorm layers of ResNet-50: the stem, 16 blocks x 3, 4 projections
RESNET_BN_LAYERS = 53
RESNET_PARITY_BATCH = 16

#: step-1 parity of the fused-BN path against the plain-BN path, in
#: float32: the loss within RESNET_LOSS_TOL, each parameter's gradient
#: within a relative L2 limit by group (convolution kernels, BatchNorm
#: scales and biases, the Dense head). A ResNet-50's step-1 gradient
#: amplifies a relative change of its input by 10^3 or more (BatchNorm
#: gradients grow with depth at init, the more so the larger the
#: residual branches), so in bf16 the two paths' different rounding
#: points give unrelated gradients; in float32 they differ by rounding
#: times that gain. The bf16 kernels are held bitwise in phase 3. The
#: conv and norm limits sit between the worst healthy reading over the
#: seeds and the least reading under injected B9/B10 faults
#: (``--parity-sweep``; PERF.md); the backward reaches the Dense head
#: before any BatchNorm, so its limit guards the head and the loss only
RESNET_LOSS_TOL = 1e-3
RESNET_GRAD_TOL = {"conv": 2.5e-2, "norm": 4.5e-2, "dense": 1e-4}


def _resnet_group(name):
    if name.startswith("Dense_0."):
        return "dense"
    return "conv" if name.endswith(".kernel") else "norm"


def _resnet_pair(weights_seed, dtype, last_scale=(0.1, 0.3)):
    """A fused-BN and a plain-BN ResNet-50 on the card with the same
    weights: ``init_params`` from ``weights_seed``, then every BatchNorm
    scale redrawn, the last of each block from U(*last_scale) (at init
    it is 0, which makes every gradient inside the blocks exactly 0 on
    both paths) and the others from U(0.5, 1.5)."""
    from horovod_tpu_torch.models.convert import rename_norms
    from horovod_tpu_torch.models.resnet import ResNet50

    with torch.device("cuda"):
        fast = ResNet50(num_classes=1000, fused_bn=True, dtype=dtype)
        plain = ResNet50(num_classes=1000, fused_bn=False, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(weights_seed)
    fast.init_params(gen)
    with torch.no_grad():
        for m in fast.modules():
            if hasattr(m, "scale_init"):
                lo, hi = last_scale if m.scale_init == "zeros" else (0.5, 1.5)
                m.scale.uniform_(lo, hi, generator=gen)
    plain.load_state_dict(rename_norms(fast.state_dict(), fused_bn=False))
    return fast, plain


def _resnet_batch(seed):
    rng = np.random.RandomState(seed)
    b = RESNET_PARITY_BATCH
    x = torch.from_numpy(rng.rand(b, 224, 224, 3).astype(np.float32)).cuda()
    return x, torch.from_numpy(rng.randint(0, 1000, b)).cuda()


def _resnet_grads(model, x, y):
    """(step-1 loss, every parameter's gradient by its plain-tree name)."""
    from horovod_tpu_torch.examples.resnet50_synthetic import \
        softmax_cross_entropy
    from horovod_tpu_torch.models.convert import rename_norms

    model.zero_grad(set_to_none=True)
    loss = softmax_cross_entropy(model(x), y)
    loss.backward()
    return loss.item(), rename_norms(
        {n: p.grad.float() for n, p in model.named_parameters()}, False)


def _rel_l2(got, want):
    return {n: ((g - want[n]).norm() / want[n].norm().clamp_min(1e-30)).item()
            for n, g in got.items()}


def check_resnet_parity(seed, weights_seed=0, enforce=True):
    """Step-1 loss and every parameter's gradient of the fused-BN
    ResNet-50 (B7-B10) against the plain-BN one on the same weights
    (``_resnet_pair``), in float32, on a 16 x 224 px batch drawn from
    ``seed``. With ``enforce=False`` it only prints the readings."""
    fast, plain = _resnet_pair(weights_seed, torch.float32)
    x, y = _resnet_batch(seed)
    b = RESNET_PARITY_BATCH
    losses, grads = zip(*(_resnet_grads(m, x, y) for m in (fast, plain)))
    rel = _rel_l2(grads[0], grads[1])
    groups = {}
    for n, r in rel.items():
        groups.setdefault(_resnet_group(n), {})[n] = r
    worst = {grp: max(rs, key=rs.get) for grp, rs in groups.items()}
    out = {"resnet_parity": {
        "batch": f"{b}x224", "seed": seed, "weights_seed": weights_seed,
        "loss_kernels": losses[0], "loss_plain": losses[1],
        "loss_err": abs(losses[0] - losses[1]), "loss_tol": RESNET_LOSS_TOL,
        "grad_rel_l2_max": {grp: groups[grp][n] for grp, n in worst.items()},
        "grad_rel_l2_worst": worst,
        "grad_rel_l2_median": float(np.median(list(rel.values()))),
        "grad_tol": RESNET_GRAD_TOL, "params": len(rel)}}
    print(json.dumps(out))
    del fast, plain, grads
    torch.cuda.empty_cache()
    if not enforce:
        return out["resnet_parity"]
    _require(all(np.isfinite(losses)), "resnet parity: a loss is not finite")
    _require(abs(losses[0] - losses[1]) <= RESNET_LOSS_TOL,
             f"resnet parity: step-1 loss {losses[0]} vs plain {losses[1]}")
    for grp, n in worst.items():
        _require(groups[grp][n] <= RESNET_GRAD_TOL[grp],
                 f"resnet parity: gradient of {n} differs from the plain "
                 f"path by {groups[grp][n]:.3e} (relative L2) > "
                 f"{RESNET_GRAD_TOL[grp]}")
    return out["resnet_parity"]


def resnet_sensitivity():
    """Why the step-1 parity runs in float32 with small last scales: how
    far ResNet-50's step-1 gradient moves (relative L2 per parameter,
    median and max) when its input is scaled by 1 + 1e-6, in float32 on
    the fused path, with the last scale of each block in U(0.1, 0.3) (the
    check's) and in U(0.5, 1.5); and what the parity check would read in
    bf16 on healthy kernels. Prints one line; enforces nothing."""
    x, y = _resnet_batch(0)
    out = {}
    for label, last in (("last_scales_0.1_0.3", (0.1, 0.3)),
                        ("all_scales_0.5_1.5", (0.5, 1.5))):
        fast, plain = _resnet_pair(0, torch.float32, last)
        del plain
        g0 = _resnet_grads(fast, x, y)[1]
        g1 = _resnet_grads(fast, x * (1 + 1e-6), y)[1]
        rel = list(_rel_l2(g1, g0).values())
        out[f"f32_input_nudge_1e-6_{label}"] = {
            "median": float(np.median(rel)), "max": max(rel)}
        del fast
        torch.cuda.empty_cache()
    fast, plain = _resnet_pair(0, torch.bfloat16)
    rel = list(_rel_l2(_resnet_grads(fast, x, y)[1],
                       _resnet_grads(plain, x, y)[1]).values())
    out["bf16_fused_vs_plain_last_scales_0.1_0.3"] = {
        "median": float(np.median(rel)), "max": max(rel)}
    del fast, plain
    torch.cuda.empty_cache()
    print(json.dumps({"resnet_sensitivity": out}))


RESNET_FAULTS = ("bn_reduce_last_block", "bn_reduce_mask_no_residual",
                 "bn_dx_dres_unmasked")


@contextlib.contextmanager
def _injected_bn_fault(name):
    """Run the fused-BN backward as a faulty kernel would:
    ``bn_reduce_last_block``: B9's column sums leave out the last row
    block of its partition (``reduce_block_of_rows``);
    ``bn_reduce_mask_no_residual``: B9 recomputes the ReLU mask without
    the residual; ``bn_dx_dres_unmasked``: B10 writes dres = dy, not
    the masked dy_eff."""
    from horovod_tpu_torch.ops import batchnorm as bn

    if name == "bn_reduce_last_block":
        from horovod_tpu_torch.ops import _build

        attr, orig = "bn_bwd_reduce_cuda", bn.bn_bwd_reduce_cuda

        def faulty(x2, dy2, res2, s, t, mean, rstd, relu):
            dg, db = orig(x2, dy2, res2, s, t, mean, rstd, relu)
            n, c = x2.shape
            vec = bn.vector_width(c, x2.dtype, x2, dy2, res2)
            blocks, _ = bn.reduce_geometry(n, c, vec, x2.element_size(),
                                           _build.sm_count(x2.device))
            last = (bn.reduce_block_of_rows(n, c, vec, blocks)
                    == blocks - 1).to(x2.device)
            pg, pb = bn.bn_bwd_reduce_ref(
                x2[last], dy2[last], None if res2 is None else res2[last],
                s, t, mean, rstd, relu)
            return dg - pg, db - pb
    elif name == "bn_reduce_mask_no_residual":
        attr, orig = "bn_bwd_reduce_cuda", bn.bn_bwd_reduce_cuda

        def faulty(x2, dy2, res2, s, t, mean, rstd, relu):
            return orig(x2, dy2, None, s, t, mean, rstd, relu)
    elif name == "bn_dx_dres_unmasked":
        attr, orig = "bn_bwd_dx_cuda", bn.bn_bwd_dx_cuda

        def faulty(x2, dy2, res2, *stats_relu):
            dx, dres = orig(x2, dy2, res2, *stats_relu)
            return dx, None if dres is None else dy2.clone()
    else:
        raise ValueError(f"unknown fault {name!r}")
    setattr(bn, attr, faulty)
    try:
        yield
    finally:
        setattr(bn, attr, orig)


#: forwards of one layer that ``running_average_kernels`` profiles
RUNNING_AVERAGE_PROBES = 20
RUNNING_AVERAGE_SPAN = "running averages probe"


def running_average_kernels(step, batch):
    """The kernels that one ``FusedBatchNorm`` layer's training forward
    launches besides B7 and B8, by name: the running averages' eager
    update (``FusedBatchNorm.forward``), the same in every layer of the
    step. A profile (CPU and CUDA activity) holds one more training step
    and then ``RUNNING_AVERAGE_PROBES`` forwards of a 256-channel layer
    inside a ``record_function`` span; the kernels that start inside the
    span are the forwards' (a short profile of its own recorded no
    kernel at all on some machines). A profile counts only if the span
    holds every forward's B7 launch and a whole number of each kernel a
    forward (about one in six did not, on one machine); after three that
    do not, the count is not measured (None; the profile's line says
    "not measured"), which does not fail the smoke: it checks nothing of
    the port."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    from horovod_tpu_torch.ops.batchnorm import FusedBatchNorm

    layer = FusedBatchNorm(256).cuda().train()
    x = torch.randn(128, 8, 8, 256, device="cuda").to(torch.bfloat16)
    k = RUNNING_AVERAGE_PROBES
    with torch.no_grad():
        layer(x)
    torch.cuda.synchronize()
    for _ in range(3):
        with _profiled(ProfilerActivity.CPU,
                       ProfilerActivity.CUDA) as prof:
            step(*batch)
            torch.cuda.synchronize()
            with torch.no_grad(), record_function(RUNNING_AVERAGE_SPAN):
                for _ in range(k):
                    layer(x)
                torch.cuda.synchronize()
        events = prof.events()
        spans = [e.time_range for e in events
                 if e.name == RUNNING_AVERAGE_SPAN
                 and e.device_type == DeviceType.CPU]
        if len(spans) != 1:
            continue
        lo, hi = spans[0].start, spans[0].end
        counts = Counter(e.name[:80] for e in events
                         if e.device_type == DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)
                         and lo <= e.time_range.start <= hi)
        if (sum(n for name, n in counts.items() if "bn_stats" in name) == k
                and not any(n % k for n in counts.values())):
            return {name: n // k for name, n in counts.items()
                    if "bn_" not in name}
    return None


def profile_resnet_step(step, batch):
    """Where one ResNet-50 training step's device time goes, by group:
    cuDNN convolutions, the BatchNorm kernels, the optimizer, casts and
    other elementwise work; with the device busy share (kernel time over
    wall time, a lower bound: the profiler adds host time), and the
    running averages' kernels counted by name on one layer
    (``running_average_kernels``, in a second profile) and for the step's
    53 layers, and each BatchNorm kernel's calls and device ms by name.
    Returns the step's calls of each BatchNorm kernel by name
    (``column_sum``, the earlier reductions' finishing kernel, beside
    B7-B10)."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with _profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernel_events(prof)
    busy_us = sum(_dev_us(e) for e in kernels)
    top = sorted(kernels, key=_dev_us, reverse=True)[:12]
    bn_calls = {k: sum(e.count for e in kernels if f"{k}_kernel" in e.key)
                for k in ("column_sum", *BN_KERNELS)}
    bn_ms = {k: sum(_dev_us(e) for e in kernels if f"{k}_kernel" in e.key)
             / 1e3 for k in BN_KERNELS}
    averages = running_average_kernels(step, batch)
    groups, calls = {}, {}
    for e in kernels:
        name = e.key.lower()
        # cuDNN's and cuBLAS's kernels by their library's names; PyTorch's
        # own (casts, [C]-sized BatchNorm constants, pooling, padding, the
        # mean, the loss) are the rest
        group = next(g for g, keys in (
            ("batchnorm (B7-B10)", ("bn_", "column_sum")),
            ("optimizer (SGD)", ("multi_tensor", "foreach")),
            ("convolutions + dense (cuDNN, cuBLAS)",
             ("cudnn", "xmma", "cutlass", "implicit", "fprop", "dgrad",
              "wgrad", "gemm", "nvjet", "conv")),
            ("nccl", ("nccl",)),
            ("casts, constants, pooling, loss (PyTorch)", ("",)))
            if any(k in name for k in keys))
        groups[group] = groups.get(group, 0.0) + _dev_us(e) / 1e3
        calls[group] = calls.get(group, 0) + e.count
    print(json.dumps({
        "profile": "one ResNet-50 training step, batch 128 x 224 px, "
                   "fused BN",
        "wall_ms": wall * 1e3, "device_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernels": sum(e.count for e in kernels),
        "device_ms_by_group": groups, "launches_by_group": calls,
        "batchnorm_kernel_calls": bn_calls,
        "batchnorm_kernel_device_ms": bn_ms,
        "running_average_kernels_per_layer": (
            "not measured" if averages is None else averages),
        "running_average_kernels_per_step": (
            "not measured" if averages is None
            else RESNET_BN_LAYERS * sum(averages.values())),
        "top": [{"name": e.key[:70], "ms": _dev_us(e) / 1e3,
                 "calls": e.count} for e in top]}))
    return bn_calls


def train_resnet(seed, ledger):
    """Train ResNet-50 (224 px, 1000 classes) through the example's
    ``main`` with ``--fused-bn``: world of one over NCCL, batch 128, 1
    warm-up and 5 timed steps on one batch, after the step-1 parity
    check. Launch counts are zeroed just before and read just after;
    each of B7-B10 must launch once per BatchNorm layer per step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import resnet50_synthetic
    from horovod_tpu_torch.ops import _build

    parity = check_resnet_parity(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    _build.reset_launches()
    per_chip, mfu = resnet50_synthetic.main(RESNET_ARGS, stats)
    torch.cuda.synchronize()
    ledger["train_resnet"] = dict(_build.LAUNCHES)
    losses = stats["losses"]
    _require(len(losses) == RESNET_STEPS and all(np.isfinite(losses)),
             f"resnet losses {losses}")
    _require(losses[-1] < losses[0], f"resnet loss did not fall: {losses}")
    for name in BN_KERNELS:
        _require(ledger["train_resnet"][name]
                 == RESNET_BN_LAYERS * RESNET_STEPS,
                 f"kernel {name} launched {ledger['train_resnet'][name]} "
                 f"times in {RESNET_STEPS} steps, not "
                 f"{RESNET_BN_LAYERS} per step")
    print(json.dumps({
        "phase": "train_resnet", "model": "ResNet-50 v1.5, 224 px, 1000 "
        "classes, fused BN", "params": stats["n_params"],
        "batch": "128x224x224", "world": hvd.size(), "backend": "nccl",
        "losses": losses, "images_per_s": per_chip,
        "step_ms": stats["step_ms"][0], "mfu": mfu,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_step": {k: ledger["train_resnet"][k] / RESNET_STEPS
                              for k in BN_KERNELS},
        "parity": parity}))
    bn_calls = profile_resnet_step(stats["step"], stats["batch"])
    _require(bn_calls["column_sum"] == 0
             and all(bn_calls[k] == RESNET_BN_LAYERS for k in BN_KERNELS),
             f"the profiled ResNet-50 step ran BatchNorm kernels {bn_calls}, "
             f"not {RESNET_BN_LAYERS} of each of B7-B10 and no column sum")
    stats.clear()
    hvd.shutdown()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 5b and 5c: Inception V3, VGG-16, MNIST and the entry point
# ---------------------------------------------------------------------------

#: bench.py's CNN cells: (model, per-card batch, image px)
CNN_RUNS = (("inception3", 256, 299), ("vgg16", 128, 224))
CNN_STEPS = 4  # 1 warm-up + 3 timed


def profile_cnn_step(step, batch, what):
    """Where one CNN training step's device time goes, by group
    (convolutions and dense products, the optimizer, pooling, the rest:
    the plain BatchNorm, ReLUs, casts, concatenations and the loss), with
    the device busy share (kernel time over wall time, a lower bound: the
    profiler adds host time) and the top kernels."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with _profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernel_events(prof)
    busy_us = sum(_dev_us(e) for e in kernels)
    groups, calls = {}, {}
    for e in kernels:
        name = e.key.lower()
        group = next(g for g, keys in (
            ("optimizer (SGD)", ("multi_tensor", "foreach")),
            ("convolutions + dense (cuDNN, cuBLAS)",
             ("cudnn", "xmma", "cutlass", "implicit", "fprop", "dgrad",
              "wgrad", "gemm", "nvjet", "conv")),
            ("pooling", ("pool",)),
            ("nccl", ("nccl",)),
            ("norms, activations, casts, concat, loss (PyTorch)", ("",)))
            if any(k in name for k in keys))
        groups[group] = groups.get(group, 0.0) + _dev_us(e) / 1e3
        calls[group] = calls.get(group, 0) + e.count
    top = sorted(kernels, key=_dev_us, reverse=True)[:12]
    print(json.dumps({
        "profile": what, "wall_ms": wall * 1e3, "device_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernels": sum(e.count for e in kernels),
        "device_ms_by_group": groups, "launches_by_group": calls,
        "top": [{"name": e.key[:300], "ms": _dev_us(e) / 1e3,
                 "calls": e.count} for e in top]}))


def train_cnns(ledger):
    """Train Inception V3 (299 px, batch 256) and VGG-16 (224 px, batch
    128), bench.py's batches, through ``resnet50_synthetic.main(["--model",
    ...])``: world of one over NCCL, 1 warm-up and 3 timed steps on one
    batch each; the losses must be finite and fall. Neither runs a kernel
    of the port (Inception's norm is the plain one, as in the JAX model;
    VGG has none): the launch counts are read to show it."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import resnet50_synthetic
    from horovod_tpu_torch.ops import _build

    for model, batch, px in CNN_RUNS:
        args = ["--model", model, "--batch-size", str(batch),
                "--num-warmup-batches", "1", "--num-batches-per-iter", "3",
                "--num-iters", "1"]
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        _build.reset_launches()
        per_chip, mfu = resnet50_synthetic.main(args, stats)
        torch.cuda.synchronize()
        ledger[f"train_{model}"] = dict(_build.LAUNCHES)
        losses = stats["losses"]
        _require(len(losses) == CNN_STEPS and all(np.isfinite(losses))
                 and losses[-1] < losses[0],
                 f"{model} losses did not fall: {losses}")
        print(json.dumps({
            "phase": f"train_{model}", "args": args,
            "params": stats["n_params"], "batch": f"{batch}x{px}x{px}",
            "world": hvd.size(), "backend": "nccl", "losses": losses,
            "images_per_s": per_chip, "step_ms": stats["step_ms"][0],
            "mfu": mfu,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "port_kernel_launches": {
                k: v for k, v in ledger[f"train_{model}"].items() if v}}))
        profile_cnn_step(stats["step"], stats["batch"],
                         f"one {model} training step, batch {batch} x "
                         f"{px} px")
        stats.clear()
        hvd.shutdown()
        torch.cuda.empty_cache()


def train_mnist_and_entry():
    """MNIST for one epoch through the example's ``main`` (world of one
    over NCCL; the mean loss of the last 4 steps must be below the first
    4's), then ``entry()`` once: its loss finite and ``causal_lm_loss``
    of the same model and tokens, within 1e-6 relative."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.entry import entry
    from horovod_tpu_torch.examples import mnist
    from horovod_tpu_torch.models.transformer import causal_lm_loss

    stats = {}
    t0 = time.perf_counter()
    acc = mnist.main(["--epochs", "1"], stats)
    wall = time.perf_counter() - t0
    losses = stats["losses"]
    _require(all(np.isfinite(losses))
             and np.mean(losses[-4:]) < np.mean(losses[:4]),
             f"MNIST loss did not fall: {losses}")
    hvd.shutdown()
    fn, (model, tokens) = entry()
    with torch.no_grad():
        loss = fn(model, tokens).item()
        ref = causal_lm_loss(model(tokens), tokens)[0].item()
    _require(np.isfinite(loss) and abs(loss - ref) <= 1e-6 * abs(ref),
             f"entry(): loss {loss} vs causal_lm_loss {ref}")
    print(json.dumps({
        "phase": "mnist_and_entry",
        "mnist": {"steps": len(losses), "first_losses": losses[:4],
                  "last_losses": losses[-4:], "test_acc": acc,
                  "wall_s": wall},
        "entry": {"model": "GPT-2 small, seq 512", "tokens": list(
            tokens.shape), "loss": loss, "causal_lm_loss": ref}}))
    del model, tokens
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 6 and 7: serving GPT-2 small
# ---------------------------------------------------------------------------

def _drive(sched, reqs, max_iters):
    for _ in range(max_iters):
        if all(r.done for r in reqs):
            return
        sched.step_once()
    raise SmokeFailure(f"requests unfinished after {max_iters} iterations")


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p))


@contextlib.contextmanager
def _engine_calls(engine):
    """Count the engine's prefills (by bucket) and decode steps."""
    calls = {"prefill_buckets": [], "decode_steps": 0}
    prefill, decode = engine._prefill, engine.decode

    def counted_prefill(slot, padded, n):
        calls["prefill_buckets"].append(int(padded.shape[1]))
        return prefill(slot, padded, n)

    def counted_decode(*args, **kwargs):
        calls["decode_steps"] += 1
        return decode(*args, **kwargs)
    engine._prefill, engine.decode = counted_prefill, counted_decode
    try:
        yield calls
    finally:
        del engine._prefill, engine.decode


def serve(engine, prompts, max_new, label, ledger):
    """Serve ``prompts`` through the scheduler with the launch counts
    zeroed just before and read just after; returns the tokens. The
    append+attend launches must split by route as the engine's calls
    say: one a layer on B16's prefill route for each prefill of 16 rows
    or more (prompts run through a float32 cache), on the decode route
    for each shorter prefill and each decode step (B16 on a float cache,
    B17 on an int8 one), none on the CUDA cores."""
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import decode_attention as da
    from horovod_tpu_torch.serving.scheduler import DecodeScheduler

    sched = DecodeScheduler(engine, queue_limit=len(prompts),
                            default_timeout_s=600.0, stats_every=0)
    torch.cuda.synchronize()
    with _engine_calls(engine) as calls:
        _build.reset_launches()
        da.reset_route_launches()
        t0 = time.perf_counter()
        reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
        _drive(sched, reqs, 100 * max_new * len(prompts))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ledger[label] = dict(_build.LAUNCHES)
    layers = engine.cfg.num_layers
    long = sum(b >= da.PREFILL_MIN_T for b in calls["prefill_buckets"])
    short = len(calls["prefill_buckets"]) - long
    steps = layers * calls["decode_steps"]
    want = {"cuda_core": 0, "prefill": layers * long,
            "decode": layers * short + steps}
    routes = dict(da.ROUTE_LAUNCHES)
    _require(routes == want, f"{label}: append_attend routes {routes}, "
                             f"expected {want} from the engine's calls "
                             f"{calls}")
    int8 = steps if engine.spec.dtype == "int8" else 0
    _require(ledger[label]["append_attend_int8"] == int8,
             f"{label}: append_attend_int8 launched "
             f"{ledger[label]['append_attend_int8']} times, expected {int8} "
             "(one a layer a decode step on an int8 cache)")
    outs = []
    for r in reqs:
        toks, reason = r.result(0.0)
        _require(len(toks) == max_new and reason == "length",
                 f"{label}: a request got {len(toks)} tokens ({reason}), "
                 f"expected {max_new}")
        _require(all(0 <= t < engine.cfg.vocab_size for t in toks),
                 f"{label}: token id out of the vocabulary")
        outs.append(toks)
    n_tok = sum(len(t) for t in outs)
    ttft = [r.first_token_t - r.enqueue_t for r in reqs]
    tpot = [(r.done_t - r.first_token_t) / (len(r.tokens) - 1)
            for r in reqs]
    stats = {"phase": label, "requests": len(reqs), "succeeded": len(outs),
             "failed": 0, "tokens": n_tok, "wall_s": wall,
             "tokens_per_s": n_tok / wall,
             "ttft_p50_ms": _pct(ttft, 50) * 1e3,
             "ttft_max_ms": max(ttft) * 1e3,
             "tpot_p50_ms": _pct(tpot, 50) * 1e3,
             "tpot_max_ms": max(tpot) * 1e3,
             "prefills": len(calls["prefill_buckets"]),
             "decode_steps": calls["decode_steps"],
             "append_attend_routes": routes,
             "scheduler": sched.stats()}
    print(json.dumps(stats))
    return outs


def profile_decode(engine, prompts, steps=8):
    """Where a decode step's time goes: ``torch.profiler`` over
    ``steps`` scheduler iterations with every slot occupied. Prints the
    device busy share (kernel time over wall time; the profiler's own
    host cost makes the share a lower bound), the append+attend
    kernels' device time per step (B16 or B17, by the cache) and the
    kernels by device time per step."""
    from torch.profiler import ProfilerActivity

    from horovod_tpu_torch.serving.scheduler import DecodeScheduler

    sched = DecodeScheduler(engine, queue_limit=engine.slots,
                            default_timeout_s=600.0, stats_every=0)
    for p in prompts[:engine.slots]:
        sched.submit(p, max_new_tokens=steps + 4)
    sched.step_once()  # admit and prefill every slot
    sched.step_once()
    torch.cuda.synchronize()
    with _profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sched.close(drain=False)
    kernels = _kernel_events(prof)
    busy_us = sum(_dev_us(e) for e in kernels)
    top = sorted(kernels, key=_dev_us, reverse=True)[:8]
    attend_us = sum(_dev_us(e) for e in kernels
                    if "attend" in e.key or "decode_cluster" in e.key)
    print(json.dumps({
        "profile": f"decode, all {engine.slots} slots occupied, "
                   f"{engine.spec.dtype} cache",
        "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_ms_per_step": busy_us / 1e3 / steps,
        "append_attend_ms_per_step": attend_us / 1e3 / steps,
        "device_busy_share": (busy_us / 1e6 / wall) if busy_us else None,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "top": [{"name": e.key[:60], "ms_per_step": _dev_us(e) / 1e3 / steps,
                 "calls_per_step": e.count / steps} for e in top]}))


def _gpt2_small(seed):
    """GPT-2 small with fused norms on the card, random weights from
    ``seed``, and the serve mix's 16 prompts of 32..700 tokens."""
    from horovod_tpu_torch.models.transformer import GPT2_SMALL, Transformer

    cfg = dataclasses.replace(GPT2_SMALL, fused_norm=True)
    with torch.device("cuda"):
        model = Transformer(cfg)
    model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size,
                           size=int(rng.randint(32, 701))).tolist()
               for _ in range(16)]
    return cfg, model, prompts


def serve_gpt2(seed, ledger):
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.serving.decode import GenerationEngine

    cfg, model, prompts = _gpt2_small(seed)
    plain_cfg = dataclasses.replace(cfg, fused_norm=False)
    with torch.device("cuda"):
        plain = Transformer(plain_cfg)
    plain.load_state_dict(model.state_dict())
    plain.eval()

    # phase 6: bf16 KV cache
    engine = GenerationEngine(model, slots=8, max_len=1024, kv_dtype="bf16")
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    print(f"serve bf16: warmup {time.perf_counter() - t0:.2f} s "
          f"({len(engine.prefill_buckets)} prefill buckets + decode)")
    batched = serve(engine, prompts, 32, "serve_bf16", ledger)
    for i in (0, 5, 10, 15):
        alone = serve(engine, [prompts[i]], 32,
                      f"serve_bf16_alone_{i}", {})
        _require(alone[0] == batched[i],
                 f"request {i}: one-at-a-time tokens differ from the "
                 "continuous batch")
    print("serve bf16: 4 requests one at a time equal the batched run")
    profile_decode(engine, prompts)

    # the first-token logits against the plain forward of the same
    # weights (no kernel: unfused norms, cache-free attention)
    probe = prompts[3][:40]
    slot = engine.claim_slot()
    first, last = engine.prefill(slot, probe)
    engine.release_slot(slot)
    with torch.inference_mode():
        ref = plain(torch.tensor([probe], device="cuda"))[0, -1].float()
    ref = ref.cpu().numpy()
    _require(last.shape == (cfg.vocab_size,) and np.isfinite(last).all(),
             "prefill logits not finite or of the wrong shape")
    logit_err = float(np.abs(last - ref).max())
    logit_tol = 5e-2
    _require(logit_err <= logit_tol,
             f"prefill logits differ from the plain forward by {logit_err}")
    print(json.dumps({"logits_vs_plain": {
        "max_abs_err": logit_err, "tol": logit_tol,
        "max_abs_logit": float(np.abs(ref).max()),
        "same_argmax": bool(first == int(ref.argmax()))}}))
    del engine
    torch.cuda.empty_cache()

    # phase 7: int8 KV cache
    engine = GenerationEngine(model, slots=8, max_len=1024, kv_dtype="int8")
    engine.warmup()
    serve(engine, prompts[:4], 16, "serve_int8", ledger)
    _require(engine._cache["k"].dtype == torch.int8,
             "int8 serve did not hold an int8 cache")
    profile_decode(engine, prompts)
    del engine


#: kernels the profiles of ``--profiles`` run
PROFILE_KERNELS = ("layernorm_fwd", "append_attend", "append_attend_int8",
                   *BN_KERNELS, *TRAIN_KERNELS, *QUANT_KERNELS, "pack_rows")


def profile_kernels(seed):
    """B4, B6, B8 and B13 timed through the wrappers' signatures, which
    the parent commits have too, so that ``--profiles`` run in two trees
    compares them in one call: B4 (LayerNorm, bf16) at [8, 768], [512,
    768] and [8192, 1024], the last L2-hot and L2-cold, beside
    ``F.layer_norm``; B6 on BERT-Large's largest bucket (32,543,744
    float32) at world 4, from an aligned and from an unaligned start
    (the element-wise kernel), beside ``F.pad`` and a ``copy_`` of the
    same bytes; B8 at ResNet-50's [401408, 256], [1605632, 64] and
    [6272, 2048] bf16, plain and with ReLU + residual, the plain case
    beside ``torch.batch_norm_elemt``; B13 on GPT-2 medium's largest
    bucket at world 4 ([4, 12865792] int8, block 256), L2-hot and
    L2-cold. Device time from the profiler (``_device_ms``)."""
    from horovod_tpu_torch.ops import batchnorm as bn
    from horovod_tpu_torch.ops import layernorm as ln
    from horovod_tpu_torch.ops import quantized_collectives as qc
    from horovod_tpu_torch.ops import ring_pack

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for rows, c in ((8, 768), (512, 768), (8192, 1024)):
        x = (torch.randn(rows, c, generator=g, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device="cuda")
        beta = 0.1 * torch.randn(c, generator=g, device="cuda")
        gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)

        def kernel(_=0):
            ln.layer_norm_cuda(x, gamma, beta, 1e-5, False)

        def lib(_=0):
            F.layer_norm(x, (c,), gb, bb, 1e-5)
        row = {"ms": _device_ms(kernel), "library_ms": _device_ms(lib)}
        if rows == 8192:
            row.update(cold_ms=_device_ms(kernel, iters=20, cold=True),
                       cold_library_ms=_device_ms(lib, iters=20, cold=True))
        out[f"layernorm_fwd {rows}x{c} bf16"] = row
    big, n = 32543744, ZERO_RANKS
    base = torch.randn(big + 1, generator=g, device="cuda")
    x, off = base[:big], base[1:]
    dst = torch.empty(big, device="cuda")
    out[f"pack_rows [{big}] float32, world {n}"] = {
        "ms": _device_ms(lambda _=0: ring_pack.pack_rows_cuda(x, n),
                         iters=20),
        "unaligned_ms": _device_ms(
            lambda _=0: ring_pack.pack_rows_cuda(off, n), iters=20),
        "library_ms": _device_ms(lambda _=0: F.pad(x, (0, 0)).view(n, -1),
                                 iters=20),
        "copy_ms": _device_ms(lambda _=0: dst.copy_(x), iters=20)}
    del base, x, off, dst
    for n, c in ((401408, 256), (1605632, 64), (6272, 2048)):
        x, res = (torch.randn(2, n, c, generator=g, device="cuda")
                  .to(torch.bfloat16))
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device="cuda")
        beta = 0.1 * torch.randn(c, generator=g, device="cuda")
        mean = 0.5 + 0.1 * torch.randn(c, generator=g, device="cuda")
        rstd = 0.5 + 0.01 * torch.randn(c, generator=g, device="cuda")
        s = gamma * rstd
        t = beta - mean * s
        side = math.isqrt(n // 128)
        xn = x.reshape(128, side, side, c).permute(0, 3, 1, 2)
        out[f"bn_apply [{n}, {c}] bf16"] = {
            "ms": _device_ms(lambda _=0: bn.bn_apply_cuda(
                x, s, t, None, False), iters=20),
            "relu_residual_ms": _device_ms(lambda _=0: bn.bn_apply_cuda(
                x, s, t, res, True), iters=20),
            "library_ms": _device_ms(lambda _=0: torch.batch_norm_elemt(
                xn, gamma, beta, mean, rstd, 1e-5), iters=20)}
        del x, res, xn
    plans, _ = gpt2_medium_plan()
    big, n = max(_bucket_sizes(plans)), QUANT_RANKS
    c = big // n
    q = torch.randint(-127, 128, (n, c), generator=g, device="cuda",
                      dtype=torch.int8)
    sc = torch.rand(n, c // QUANT_BLOCK, generator=g, device="cuda")
    out[f"accum_rows [{n}, {c}] int8, block {QUANT_BLOCK}"] = {
        "ms": _device_ms(lambda _=0: qc.accum_rows_cuda(q, sc, QUANT_BLOCK),
                         iters=20),
        "cold_ms": _device_ms(lambda _=0: qc.accum_rows_cuda(
            q, sc, QUANT_BLOCK), iters=20, cold=True)}
    print(json.dumps({"profile": "B4, B6, B8 and B13 through their "
                      "wrappers", "kernels": out}))


def profiles(seed):
    """``--profiles``: only the profiles that compare two trees in one
    call, run from the root of each: B4, B6, B8 and B13 through their
    wrappers (``profile_kernels``), one rank's int8 stage kernels at
    world 4 (``profile_int8_stages``), GPT-2 medium training through the
    example's ``main`` with phase 4's arguments (batch 8 x 1024, flash
    attention and fused norms, 1 warm-up + 5 timed steps: the unprofiled
    step time and tokens/s) and then one profiled step
    (``profile_train_step``: the LayerNorm group's device time and
    launches), a decode step of GPT-2 small with every slot occupied on
    a bf16 and on an int8 cache (``profile_decode``), and one ResNet-50
    training step with the fused BatchNorm after one warm-up step
    (``profile_resnet_step``). Enforces nothing."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import (gpt2_pretraining,
                                            resnet50_synthetic)
    from horovod_tpu_torch.serving.decode import GenerationEngine

    profile_kernels(seed)
    stages = profile_int8_stages()
    print(json.dumps({
        "profile": "one rank's int8 stage kernels on GPT-2 medium's plan "
                   "at world 4", "device_ms": stages,
        "device_ms_total": sum(v for k, v in stages.items()
                               if not k.startswith("copies"))}))
    stats = {}
    per_chip, _ = gpt2_pretraining.main(TRAIN_ARGS, stats)
    print(json.dumps({
        "profile": "GPT-2 medium training through the example's main, "
                   "unprofiled (phase 4's arguments: batch 8x1024, 1 "
                   "warm-up + 5 timed steps)",
        "step_ms": stats["step_ms"][0], "tokens_per_s": per_chip}))
    profile_train_step(stats["step"], stats["tokens"])
    stats.clear()
    hvd.shutdown()
    torch.cuda.empty_cache()
    _, model, prompts = _gpt2_small(seed)
    for kv in ("bf16", "int8"):
        engine = GenerationEngine(model, slots=8, max_len=1024, kv_dtype=kv)
        engine.warmup()
        profile_decode(engine, prompts)
        del engine
    del model
    torch.cuda.empty_cache()
    stats = {}
    resnet50_synthetic.main(["--fused-bn", "--batch-size", "128",
                             "--num-warmup-batches", "1",
                             "--num-batches-per-iter", "1",
                             "--num-iters", "1"], stats)
    profile_resnet_step(stats["step"], stats["batch"])
    stats.clear()
    hvd.shutdown()
    print(json.dumps({"profiler_windows": PROFILER_TALLY}))


#: ``--profiler-probe``: the kernels each window launches back to back,
#: and the spin (``torch.cuda._sleep`` cycles, ~2 ms) that every other
#: window launches first
PROBE_KERNELS = 16
PROBE_SPIN_CYCLES = 4_000_000


def profiler_probe(windows, cadence_s=10.0):
    """``--profiler-probe N``: what ``torch.profiler`` windows keep as
    the process ages. Every ``cadence_s`` (the card idle in between), a
    window (CPU and CUDA activity) in which ``PROBE_KERNELS`` small
    kernels are launched back to back as soon as it opens; every other
    window launches one spin kernel of ~2 ms first. Printed
    per window: its index, whether it spun, the process's age, the
    small kernels launched and kept, the launch positions of those
    lost, whether the spin was kept, the median lag of a kept kernel's
    device start after its ``cudaLaunchKernel`` call (by correlation
    id, us), and the card's clock against the host's since the first
    window (CUDA-event ms against ``perf_counter`` ms, parts per
    million)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1024, device="cuda")
    x.add_(1)
    e0 = torch.cuda.Event(enable_timing=True)
    e0.record()
    e0.synchronize()
    t0 = time.perf_counter()
    for w in range(windows):
        spin = w % 2 == 1
        age = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if spin:
                torch.cuda._sleep(PROBE_SPIN_CYCLES)
            for _ in range(PROBE_KERNELS):
                x.add_(1)
            torch.cuda.synchronize()
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        e1.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        events = prof.profiler.kineto_results.events()
        kernels = {e.correlation_id(): (e.start_ns(), e.name())
                   for e in events if e.device_type() == DeviceType.CUDA}
        launches = sorted((e.start_ns(), e.correlation_id())
                          for e in events
                          if e.device_type() == DeviceType.CPU
                          and e.name().startswith("cudaLaunchKernel"))
        spin_kept = None
        if spin:
            spin_kept = launches[0][1] in kernels
            launches = launches[1:]
        lags = sorted((kernels[c][0] - t) / 1e3 for t, c in launches
                      if c in kernels)
        print(json.dumps({
            "profiler_probe_window": w, "spin": spin, "age_s": age,
            "launched": len(launches),
            "kept": sum(c in kernels for _, c in launches),
            "lost_positions": [i for i, (_, c) in enumerate(launches)
                               if c not in kernels],
            "spin_kept": spin_kept,
            "lag_us_median": lags[len(lags) // 2] if lags else None,
            "card_vs_host_ppm": (e0.elapsed_time(e1) - host_ms) / host_ms
            * 1e6}), flush=True)
        time.sleep(max(0.0, cadence_s - (time.perf_counter() - t0 - age)))


# ---------------------------------------------------------------------------

def _mangled_args(s, i):
    """The template arguments of an Itanium-mangled name from ``s[i]``
    (just past their ``I``) to their closing ``E``: ``(names, index past
    it)``, with ``f`` as f32, ``__nv_bfloat16`` as bf16, an integer
    literal as its value and a nested name as its last component."""
    out = []
    while s[i] != "E":
        a, i = _mangled_arg(s, i)
        if a is not None:
            out.append(a)
    return out, i + 1


def _mangled_arg(s, i):
    if s[i] == "f":
        return "f32", i + 1
    if s[i] == "L":  # literal: L <type> <value> E
        j = s.index("E", i)
        return s[i + 2:j], j + 1
    if s[i] == "N":  # nested name: its last component
        i, name = i + 1, None
        while s[i] != "E":
            part, i = _mangled_arg(s, i)
            name = part if part is not None else name
        return name, i + 1
    digits = re.match(r"\d+", s[i:]).group()
    i += len(digits)
    name, i = s[i:i + int(digits)], i + int(digits)
    name = {"__nv_bfloat16": "bf16", "_GLOBAL__N_1": None}.get(name, name)
    if i < len(s) and s[i] == "I":
        args, i = _mangled_args(s, i + 1)
        name = f"{name}<{','.join(args)}>"
    return name, i


def _kernel_name(mangled):
    """``flash_fwd_mma_kernel<64>`` or
    ``decode_cluster_kernel<FpDecodeRows<bf16>,64>`` from a mangled
    kernel name (template arguments: ``f`` float32, ``13__nv_bfloat16``
    bf16, numbers as they are, row policies by name);
    ``matmul_pack_kernel`` from a function that is no template. A name
    this does not parse is returned as it is."""
    for run in re.finditer(r"\d+", mangled):
        for k in range(run.start(), run.end()):  # the run's suffixes
            end = run.end() + int(mangled[k:run.end()])
            name = mangled[run.end():end]
            if re.fullmatch(r"[a-z]\w*_kernel", name):
                break
        else:
            continue
        if not mangled[end:].startswith("I"):
            return name
        try:
            args, _ = _mangled_args(mangled, end + 1)
        except (IndexError, AttributeError, ValueError):
            return mangled
        return f"{name}<{','.join(args)}>"
    return mangled


def ptxas_lines(_build, names):
    """``(source, kernel, line)`` of each ptxas register, shared-memory
    and spill line of the named kernel sources' build logs."""
    out = []
    for name in names:
        log = (_build.BUILD_DIR / f"{name}.log")
        fn = ""
        for line in log.read_text().splitlines() if log.exists() else []:
            if "Compiling entry function" in line:
                fn = _kernel_name(line.split("'")[1])
            elif "Function properties for" in line:
                fn = _kernel_name(line.split()[-1])
            elif "registers" in line or "spill" in line:
                out.append((name, fn, line.strip()))
    return out


def print_ptxas(_build, names):
    """The ptxas report of each named kernel source: registers, shared
    memory and spills, by kernel."""
    for name, fn, line in ptxas_lines(_build, names):
        print(f"ptxas {name} {fn}: {line}")


def _cuobjdump():
    import importlib.util
    import shutil

    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = ["/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    return next((c for c in cands if os.path.exists(c)), None)


def print_sass_mma(_build, names):
    """Count the tensor-core instructions in each kernel's SASS of the
    named libraries, with ``cuobjdump`` where it is installed:
    ``mma.sync``'s ``HMMA`` and ``wgmma``'s ``HGMMA`` (the substring
    "HMMA" does not match "HGMMA"). A kernel that reads 0 of both does
    not use the tensor cores. Also counts its local-memory (register
    spill) instructions ``LDL``/``STL``, and how many of them lie inside
    a loop (between a backward branch and its target), where they cost
    on every iteration. Informational; never fails."""
    tool = _cuobjdump()
    if tool is None:
        print("sass: cuobjdump is absent (CUDA toolkit, triton); HMMA "
              "and HGMMA counts not read")
        return
    for name in names:
        res = subprocess.run([tool, "-sass", str(_build._target(name))],
                             capture_output=True, text=True, timeout=300)
        counts, fn, local, loops = {}, None, {}, {}
        for line in res.stdout.splitlines():
            if "Function :" in line:
                fn = _kernel_name(line.split("Function :")[1].strip())
                counts[fn] = {"HMMA": 0, "HGMMA": 0}
                local[fn], loops[fn] = [], []
            elif fn is not None:
                for op in ("HMMA", "HGMMA"):
                    counts[fn][op] += op in line
                at = re.search(r"/\*([0-9a-f]{4,})\*/", line)
                if at is None:
                    continue
                here = int(at.group(1), 16)
                if re.search(r"\b(LDL|STL)\b", line):
                    local[fn].append(here)
                br = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", line)
                if br and int(br.group(1), 16) <= here:
                    loops[fn].append((int(br.group(1), 16), here))
        for fn, at in local.items():
            counts[fn]["LDL+STL"] = len(at)
            counts[fn]["LDL+STL in loops"] = sum(
                any(lo <= x <= hi for lo, hi in loops[fn]) for x in at)
        print(json.dumps({"sass_mma": name, "tool": tool,
                          "rc": res.returncode, "counts": counts}))


KERNELS = [
    ("flash_fwd", "horovod_tpu_torch/csrc/flash_fwd.cu",
     "horovod_tpu/ops/pallas_attention.py:105",
     "B1 pallas_attention._flash_fwd_kernel"),
    ("flash_bwd_dq", "horovod_tpu_torch/csrc/flash_bwd_dq.cu",
     "horovod_tpu/ops/pallas_attention.py:167",
     "B2 pallas_attention._flash_bwd_dq_kernel"),
    ("flash_bwd_dkv", "horovod_tpu_torch/csrc/flash_bwd_dkv.cu",
     "horovod_tpu/ops/pallas_attention.py:214",
     "B3 pallas_attention._flash_bwd_dkv_kernel"),
    ("layernorm_fwd", "horovod_tpu_torch/csrc/layernorm_fwd.cu",
     "horovod_tpu/ops/pallas_layernorm.py:67",
     "B4 pallas_layernorm._fwd_kernel"),
    ("layernorm_bwd", "horovod_tpu_torch/csrc/layernorm_bwd.cu",
     "horovod_tpu/ops/pallas_layernorm.py:80",
     "B5 pallas_layernorm._bwd_kernel"),
    ("append_attend", "horovod_tpu_torch/csrc/append_attend.cu",
     "horovod_tpu/ops/pallas_collectives.py:380",
     "B16 pallas_collectives._append_attend_kernel"),
    ("append_attend_int8", "horovod_tpu_torch/csrc/append_attend_int8.cu",
     "horovod_tpu/ops/pallas_collectives.py:409",
     "B17 pallas_collectives._append_attend_int8_kernel"),
    ("bn_stats", "horovod_tpu_torch/csrc/bn_stats.cu",
     "horovod_tpu/ops/pallas_batchnorm.py:70",
     "B7 pallas_batchnorm._stats_kernel"),
    ("bn_apply", "horovod_tpu_torch/csrc/bn_apply.cu",
     "horovod_tpu/ops/pallas_batchnorm.py:85",
     "B8 pallas_batchnorm._apply_kernel / _apply_res_kernel (:92)"),
    ("bn_bwd_reduce", "horovod_tpu_torch/csrc/bn_bwd_reduce.cu",
     "horovod_tpu/ops/pallas_batchnorm.py:100",
     "B9 pallas_batchnorm._bwd_reduce_kernel"),
    ("bn_bwd_dx", "horovod_tpu_torch/csrc/bn_bwd_dx.cu",
     "horovod_tpu/ops/pallas_batchnorm.py:130",
     "B10 pallas_batchnorm._bwd_dx_kernel"),
    ("quant_rows", "horovod_tpu_torch/csrc/quant_rows.cu",
     "horovod_tpu/ops/pallas_collectives.py:105",
     "B11 pallas_collectives._quant_kernel"),
    ("quant_ef_rows", "horovod_tpu_torch/csrc/quant_ef_rows.cu",
     "horovod_tpu/ops/pallas_collectives.py:112",
     "B12 pallas_collectives._quant_ef_kernel"),
    ("accum_rows", "horovod_tpu_torch/csrc/accum_rows.cu",
     "horovod_tpu/ops/pallas_collectives.py:123",
     "B13 pallas_collectives._accum_kernel"),
    ("dequant_flat", "horovod_tpu_torch/csrc/dequant_flat.cu",
     "horovod_tpu/ops/pallas_collectives.py:134",
     "B14 pallas_collectives._dequant_kernel"),
    ("pack_rows", "horovod_tpu_torch/csrc/pack_rows.cu",
     "horovod_tpu/ops/pallas_collectives.py:141",
     "B6 pallas_collectives._pack_kernel"),
    ("matmul_pack", "horovod_tpu_torch/csrc/matmul_pack.cu",
     "horovod_tpu/ops/pallas_collectives.py:148",
     "B15 pallas_collectives._matmul_pack_kernel"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parity-sweep", type=int, default=0, metavar="N",
                    help="only build the kernels and print the step-1 "
                         "parity readings of seeds 0..N-1 and of the "
                         "injected faults (the limits' evidence): the "
                         "fused cross-entropy on GPT-2 medium and "
                         "BERT-Large, GPT-2 medium's kernels, ResNet-50's "
                         "and the int8 wire")
    ap.add_argument("--profiles", action="store_true",
                    help="only build the kernels they run and print "
                         "B4's, B6's, B8's and B13's times, the int8 "
                         "stage kernels' profile, GPT-2 medium's unprofiled "
                         "training step time, the training-step, "
                         "decode-step (bf16 and int8 cache) and ResNet-50 "
                         "step profiles, to compare two trees in one call")
    ap.add_argument("--adasum-sweep", type=int, default=0, metavar="N",
                    help="only build the flash kernels and print phase "
                         "4g's readings of seeds 0..N-1 and of the "
                         "injected faults (ADASUM_REL_TOL's evidence)")
    ap.add_argument("--profiler-probe", type=int, default=0,
                    metavar="N",
                    help="only open N profiler windows, one every 10 s, "
                         "and print what each kept of the kernels launched "
                         "as it opened, with and without a spin kernel "
                         "first (profiler_probe)")
    ap.add_argument("--elastic-worker", metavar="OUT",
                    help="phase 4k's worker under the elastic launcher "
                         "(elastic_worker), not a smoke")
    ap.add_argument("--eager-stall-worker", action="store_true",
                    help="phase 4l (d)'s process (eager_stall_worker), "
                         "not a smoke")
    args = ap.parse_args(argv)

    # phase 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "horovod_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout holding horovod_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.elastic_worker:
        return elastic_worker(args.elastic_worker)
    if args.eager_stall_worker:
        return eager_stall_worker()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _require(smi.returncode == 0 and smi.stdout.strip(),
             f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    if args.profiler_probe:
        profiler_probe(args.profiler_probe)
        return 0

    # phase 2
    from horovod_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build(PROFILE_KERNELS if args.profiles
                        else ADASUM_KERNELS if args.adasum_sweep else None)
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    if args.profiles:
        profiles(args.seed)
        return 0
    if args.adasum_sweep:
        adasum_sweep(args.adasum_sweep)
        return 0
    print_ptxas(_build, secs)
    print_sass_mma(_build, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                            "append_attend", "append_attend_int8",
                            "matmul_pack"))
    if args.parity_sweep:
        parity_sweep(args.parity_sweep)
        return 0

    # phase 3
    checks = {
        **check_flash(args.seed),
        "layernorm_fwd": check_layernorm(args.seed),
        "layernorm_bwd": check_layernorm_bwd(args.seed),
        "append_attend": check_append_attend(args.seed),
        "append_attend_int8": check_append_attend_int8(args.seed),
        **check_batchnorm(args.seed),
        **check_quantized(args.seed),
        **check_pack_rows(args.seed),
        **check_matmul_pack(args.seed),
    }
    for name, cases in checks.items():
        for c in cases:
            print(json.dumps({"kernel": name, **c}))
    check_fused_ce(args.seed)

    # phases 4 and 5: training; phases 6 and 7: serving
    ledger = {}
    in_process_rate, in_process_losses = train_gpt2(args.seed, ledger)
    flat_stage_ms = train_int8(args.seed, ledger)
    train_zero(args.seed, ledger)
    train_gpt2_fused_ce(args.seed, ledger)
    launch_gpt2(ledger, in_process_rate, in_process_losses)
    train_fsdp(args.seed, ledger, in_process_losses, in_process_rate)
    train_adasum(args.seed, ledger)
    train_hierarchical(args.seed, ledger, in_process_losses, flat_stage_ms)
    train_llama(args.seed, ledger)
    train_checkpoint(ledger)
    train_elastic(ledger)
    train_eager(args.seed, ledger, in_process_losses)
    train_resnet(args.seed, ledger)
    train_cnns(ledger)
    train_mnist_and_entry()
    serve_gpt2(args.seed, ledger)
    launches = {name: sum(counts.get(name, 0) for counts in ledger.values())
                for name, *_ in KERNELS}
    print(json.dumps({"launches_by_phase": ledger}))
    for name, n in launches.items():
        _require(n > 0, f"kernel {name} was not launched on its path")

    # phase 8
    kernels = []
    for name, source, replaces, tpu in KERNELS:
        cases = checks[name]
        top = cases[0]  # the main path's shape
        err = max(c["max_abs_err"] for c in cases)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_kernel": tpu,
            "launches": launches[name],
            "max_abs_err": err, "tol": top["tol"], "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            **({"library_call": top["library_call"]}
               if "library_call" in top else {}),
            "cases": cases,
        })
    print(json.dumps({"profiler_windows": PROFILER_TALLY}))
    print(smi.stdout.strip())  # again, beside the numbers it qualifies
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        import traceback

        traceback.print_exc()
        print(json.dumps({"profiler_windows": PROFILER_TALLY}),
              file=sys.stderr)
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
