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
    python3 chip_smoke.py --mesh-sweep 8     # phase 4m's limits' readings
    python3 chip_smoke.py --pipe-sweep 8     # phase 4n's limits' readings
    python3 chip_smoke.py --fsdp-sweep 8     # phase 4o's limits' readings
    python -m horovod_tpu_torch.examples.local_world -np 4 -- \
        python3 chip_smoke.py --mesh-world   # phases 4m, 4o on four cards

Phases, in order; the first failure exits non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build every kernel of ``horovod_tpu_torch/csrc/`` (one nvcc each, in
   parallel, at a lower priority; ``append_attend.cu`` as five
   translation units and ``layernorm_bwd.cu`` as two, the slowest
   compiles split) while phase 5b, which runs none of them,
   trains on the card, and print the build's seconds and each nvcc's
   CPU seconds, ptxas's registers, shared memory and spills by kernel,
   and the count of tensor-core instructions (``mma.sync``'s HMMA,
   ``wgmma``'s HGMMA) in the flash, append+attend and matmul kernels'
   SASS where cuobjdump is installed (one cuobjdump a library, all at
   once); after each phase a ``{"phase_done": ...}`` line, flushed;
3. hold each kernel against its plain PyTorch version on the card, at
   its path's shapes and in its working dtypes (flash attention at
   GPT-2 medium's [8, 16, 1024, 64] and Llama-2's [2, 32, 4096, 128]
   bf16, and at phase 4m's ring blocks ([8, 16, 256, 64], query_offset
   768, key_offset 0, 256, 512 and 768, causal), row by row, and in the
   timed cases kernels that skip one tile of the
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
   stream with events), 2 x 1024 a rank, 2 steps on the float32 wire and
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
   composition within ``HIER_WIRE_TOL`` of the exact sum; beside (a)
   the two-axis form's decision: the world mesh ``HOROVOD_MESH=dcn=2,
   ici=2`` names with no local-size knob gives (a)'s block of 2 by the
   int8 optimizer's rule (``hierarchical.mesh_block``) and by the axes
   (``hierarchical.axes_block``), so its route is (a)'s; (c) the knobs
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
   1024, ``--flash``, 20 steps, a commit every 10) at world 1 over NCCL:
   (a) in process, a falling loss, B1-B3 exactly 24 a step, step ms,
   tokens/s and each commit's seconds, and ``device_prefetch`` of four
   token batches to the card; (b) under the elastic launcher
   (``--min-np 1 --max-np 1 --host-discovery-script``,
   ``--emergency-checkpoint``, ``--flight-dir``, ``HOROVOD_METRICS=1``
   pushed every second), the worker sent SIGTERM after its first
   commit, once the driver's ``/metrics`` (scraped then) holds rank 0's
   pushed series labeled ``rank="0"`` and lints clean: it exits 83, the
   host is not blacklisted, the driver persists its ``preemption`` dump
   (a ``preempt`` record, the store's receipt in its header, read by
   ``tools.flight_analyze``), and the second round recovers from the
   emergency rung; (c) with
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
   host seconds; with metrics, the flight recorder and a timeline on,
   the runtime's records against its own counters: the batch histogram
   its executed batches, the fused counters the 12 buckets' tensors and
   bytes every step, the negotiation histogram and the timeline's
   NEGOTIATE spans the warm-up's tensors, the plan cache's and the
   controller's gauges ``metrics_snapshot()``, one plan activation in
   the timeline and the flight ring; (b) the same on the int8 +
   error-feedback wire (block 256): each fused batch's sum and residual
   bitwise the plain composition of B11-B14 on the same buffer, B11-B14
   exactly once a fused batch a step, ``hvd_wire_*``'s logical and sent
   bytes the int8 wire's reckoning of those batches, a falling loss,
   one step profiled; every telemetry switch off again after the phase;
   (c) a bucket
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
4m. train GPT-2 medium (24 x 1024, vocab 50257, ``--flash
   --fused-norm``, AdamW, phase 4's weights and 8 x 1024 batch) through
   ``make_lm_train_step(mesh=...)`` on worlds of four ranks emulated on
   the card (threads on one stream, the tp/sp exchanges between them
   through ``parallel/comm.ThreadComm``, every other line the real
   path's): (a) tp = 4 (4 heads and a quarter of the MLP a rank, the
   vocab and norms whole), (b) sp = 4 with ring attention ([8, 256] a
   rank), (c) sp = 4 with Ulysses; each held at step 1 against phase
   4's world-1 step (the loss, every gradient row by row, the ranks'
   shards put back together; ``MESH_GRAD_TOL``), where its injected
   faults (a dropped ``attn.out`` all-reduce, rank 1's ``fc2`` partial
   left out; a skipped ring block, every ``key_offset`` 128 late; the
   Ulysses all-to-all reversed) must fail, then 2 steps: a falling loss,
   exact B1-B5 launches (tp and Ulysses 24 B1-B3 and 49 B4/B5 a rank a
   step; the ring 1 + 2 + 3 + 4 blocks a layer), the whole parameters
   bitwise across the ranks, step ms, tokens/s, peak memory; (d) a
   world of one over NCCL with ``HOROVOD_MESH=dp=1,tp=1``: phase 4's
   losses bitwise;
4n. train GPT-2 medium (24 x 1024, ``--flash --fused-norm``, AdamW,
   phase 4's weights and 8 x 1024 batch) pipelined over pp = 4 stages of
   6 blocks, emulated on the card as phase 4m's ranks are (only the pp
   communicator substituted): (a) GPipe at M = 4 (and M = 8, step 1
   only), (b) 1F1B at M = 4 and M = 8, each held at step 1 against
   phase 4's world-1 step (the loss and every gradient row; the 1F1B
   runs also on the batch with rows 4-7 all padding, against the
   world-1 step on it; ``PIPE_GRAD_TOL``, ``PIPE_LOSS_TOL``), the
   replicated gradients bitwise the same on every stage, where a zeroed
   backward hop and S copies of the head's cotangent (GPipe), and a
   backward one slot early and a fully padded microbatch counted as 1
   (1F1B) must fail; then 2 AdamW steps: a falling loss, exact B1-B5
   launches (``_pipe_launches``, and by kernel name in a profiled step),
   the replicated parameters bitwise across the stages, step ms,
   tokens/s; (c) each case's step memory (the world's peak over what
   was resident; 1F1B's at M = 8 below GPipe's) and each rank's bytes
   saved for the backward; (d) ``MoeMlp`` at GPT-2 medium's width with
   Mixtral's routing (8 experts, top 2, bf16, 8192 tokens): the dense
   path against the EP path over four emulated ranks (nothing dropped),
   and at capacity factor 1.25 against the drop rule's plain reference
   (pairs must drop), row by row (``MOE_ROW_TOL``), where a reversed
   return all-to-all must fail; forward + backward ms;
4o. train GPT-2 medium (24 x 1024, ``--flash --fused-norm``, AdamW,
   phase 4's weights and 8 x 1024 batch) with a live fsdp axis under the
   replicated optimizer (``parallel/fsdp_axis.py``, ZeRO-3 by the
   rules), four ranks emulated on the card as phase 4m's are, on (a)
   fsdp = 4, (b) dp = 2, fsdp = 2 and (c) fsdp = 2, tp = 2: each held
   at step 1 against phase 4's world-1 step (the loss and every gradient
   row; ``FSDP_AXIS_GRAD_TOL``), where the shards gathered in reversed
   rank order, a weight-gradient shard left as the rank's partial and a
   whole parameter's gradient not summed over fsdp must fail; then 2
   AdamW steps: a falling loss, exact B1-B5 launches (24 B1-B3 and 49
   B4/B5 a rank a step; and by kernel name in a profiled step), each
   rank's parameter and AdamW-state bytes exactly its specs' share
   (beside world 1's), the bytes gathered and reduce-scattered a step,
   peak memory, step ms, tokens/s;
4q. build straight into the shards, no kernel: GPT-2 medium from seed
   0 on the card's generator, each rank of fsdp = 4 and tp = 4
   (``parallel.train.build_sharded`` on an unbound mesh of its
   coordinates), each stage of pp = 4 (``build_stage``) and each rank's
   ``FullyShardedOptimizer`` rows at world 4 (``bind(materialize=)``)
   bitwise the whole build's slices, blocks and rows; rank 0 of
   Llama-2 7B (32 x 4096, float32) on fsdp = 4 built and given AdamW's
   moments by a zero-gradient step at lr 0 that leaves every parameter
   bitwise as it was, its peak device memory over the build at most
   its reckoning (``param_counts`` x 4 bytes) and over the step at most
   its own (x 12 bytes), each plus the largest parameter plus
   ``INIT_SLACK_BYTES``; ``distributed_value_and_grad`` and the ``_op``
   queries at world 1 (its own ``phase_seconds`` entry);
4p. train GPT-2 medium (24 x 1024, ``--flash --fused-norm``, AdamW
   under the DistributedOptimizer, phase 4's weights and 8 x 1024 batch)
   at world 1 over NCCL, 1 warm-up + 5 steps each inside
   ``hvd.metrics.step()``, with ``HOROVOD_METRICS``,
   ``HOROVOD_TPU_METRICS_FILE``, ``HOROVOD_TIMELINE`` (cycle marks) and
   the flight recorder on, then with every knob off: the losses bitwise
   equal (and phase 4's), B1-B5 exactly ``STEP_LAUNCHES`` a step in
   both; the JSONL one record a step, each step's time within
   ``OBSERVE_TIME_TOL`` of the smoke's clock, record 1 the plan's
   fusion fields and the weights' broadcasts, no gradient bytes at world
   1, ``tools.metrics_summary --check`` passing; the scrape lint-clean
   with a step histogram of 6; the timeline anchored, balanced, one
   broadcast span a weight and one ``FUSION_PLAN`` instant of the plan's
   buckets; a manual and a SIGUSR2 dump parsed; ``tools.trace_merge``
   merging timeline and dump; step ms on and off; then (f) the sampled
   profiler (``HOROVOD_PROF_EVERY=2``, duty 1.0, 6 N D declared) over
   1 + 5 steps: exactly 3 samples, each with its sidecar and B1-B5
   24/24/24/49/49 by name, its device ms within ``PROF_DEVICE_TOL`` of
   ``_profiled``'s for the nearest unsampled step, the attribution's
   parts summing to the step, ``hvd_mfu`` within ``PROF_MFU_TOL`` of 6 N
   D over the step's host clock and 989e12, losses bitwise; a sample at
   duty 0.02 holding the next off; (g) the health monitor with one step
   slowed by a spin: the step-time envelope fires, the incident log has
   the transition, the alert's forced sample captures the next step,
   ``GET /health`` on a rendezvous store names rank 0, losses bitwise;
   no ``HOROVOD_PROF_*`` or ``HOROVOD_HEALTH*`` knob left set;
5. train ResNet-50 (224 px, 1000 classes) through the example's
   ``main`` with ``--fused-bn`` (world of one over NCCL, batch 128, 1
   warm-up + 5 timed steps on one batch), after checking the step-1
   loss and gradients of the fused-BN path against the plain-BN path
   on the same weights (``RESNET_GRAD_TOL``); the loss must fall, each
   BatchNorm kernel must launch 53 times a step; one step is profiled,
   and there too each of B7-B10 must run 53 times and no column-sum
   kernel;
5b. (run during phase 2's build: its readings share the host's cores
   with nvcc) train Inception V3 (299 px, batch 256) and VGG-16 (224 px, batch
   128), bench.py's batches, through the same example's ``main``
   (``--model``), 1 warm-up + 3 timed steps each: finite, falling
   losses, images/s, MFU, peak memory, one profiled step each;
5c. train MNIST for one epoch through its example's ``main`` (a falling
   loss, the test accuracy), then call ``entry()`` once: its loss finite
   and equal to ``causal_lm_loss`` of the same model; then
   ``dryrun_multichip(4)``, its four ranks emulated on the card: the dp x
   tp x sp step with ring attention, GPipe and 1F1B on pp = 2, three
   ``OK`` lines with finite losses;
6. serve GPT-2 small at full width (random weights from the seed,
   ``fused_norm=True``, bf16 KV cache, 8 slots x 1024) under the
   continuous-batching scheduler, every decode and prefill step replayed
   from its CUDA graph (captured by ``warmup``: each graph's capture
   seconds and memory): 16 requests of 32..700 prompt tokens, 32 new
   tokens each, then the same serve through the uncaptured steps, whose
   tokens must be the same bitwise; 4 of them again one at a time must
   give the same tokens; decode steps with ``return_logits`` bitwise
   through the graph and the uncaptured step; B16's launches, reckoned
   as each graph's capture launches times its replays (the wrappers
   count at capture, not at replay, and must count nothing during a
   graphed serve), must split by route as the engine's calls say
   (prefills of 16 rows or more on the prefill route, decode steps on
   the decode route); a profiled window of 8 full-batch decode steps,
   graphed and uncaptured, shows where a step's time goes and must hold
   12 decode-route B16 and 25 B4 kernels a step; the first-token logits
   must agree with the plain (unfused, cache-free) forward of the same
   weights;
7. the same on an int8 KV cache (16 requests of 16 new tokens), whose
   decode steps must run B17 on the decode route;
8. the serving tier over HTTP: phase 6's model saved with
   ``checkpoint.save_model`` and its serving metadata, a ``--registry``
   and two ``--decode`` replica processes on the card (``python -m
   horovod_tpu_torch.serving.replica_set``, 8 slots x 1024, bf16 cache)
   behind an in-process front door: the 16 prompts streamed
   concurrently must get phase 6's tokens bitwise; the replicas'
   ``GET /metrics`` (their ``serve_replica`` turns metrics on) against
   the client: requests by code, a TTFT a request (their sum within the
   client's), the TPOT count the tokens after each request's first,
   the slots' gauges, and their median TPOT and decode step's wall with
   the records on; again, with one replica SIGTERMed once every stream
   has its first token: its streams complete, it exits 83, later
   requests reach the other replica, no client sees a failure, and the
   front door's ``/metrics`` counts every reply by code, one ejection
   of the SIGTERMed replica and none in flight; and an MLP's predict tier through a
   ``--checkpoint`` replica, groups of 64, 10, 3 and 1 concurrent
   clients, each answer bitwise the module's forward of the padded
   batch, with each group's batch fill, and in this process the MLP's
   ``InferenceEngine(mesh=hvd.mesh(), sharding_rules=RESNET_RULES)``
   bitwise the engine without a mesh at every bucket, graphed; an evicted
   predict graph must free its memory and its pinned host buffers, and
   across more shapes than the graph cache holds the engine's pinned
   host bytes must stay within one shape's; ``GET /health`` on the
   front door, with this process's health monitor on, answers a verdict
   ("ok"), not "off";
9. print each phase's seconds (``{"phase_seconds": ...}``; the
   telemetry checks of 4l and 8 as their own entry, "4l, 8 (part 3)")
   and the
   ``{"kernels": [...]}`` line: each kernel's launches on the
   training runs of phases 4, 4b, 4c, 4d, 4e (the launched worker's
   step), 4f (the FSDP runs, not their references), 4g ((a) and (b)), 4h
   ((a)'s kernel composition), 4i, 4j, 4k (in process and the
   launched workers' second rounds), 4l ((a), (b) and (e)'s ``run()``
   worker), 4m (the emulated worlds' steps and (d)), 4n (the trained
   cases' steps), 4o (the emulated worlds' steps), 4p (the run with
   telemetry on), 5c's dry run, 5 and
   5b and the
   graphed
   serving runs of phases 6 and 7 (counts zeroed
   just before each run and read just after), error, tolerance and
   times;
10. print ``{"ok": true, "device": {...}}`` as the last line.

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


#: the smoke's start on the host clock (``main`` resets it)
SMOKE_T0 = time.perf_counter()


def _phase_done(name, seconds):
    """One flushed progress line at a phase's end, so that a run cut off
    by its time limit shows where it stood."""
    print(json.dumps({"phase_done": name, "seconds": round(seconds, 2),
                      "elapsed": round(time.perf_counter() - SMOKE_T0, 2)}),
          flush=True)


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
    # phase 4m's ring blocks: rank 3 of sp = 4 attends each rank's span
    for k_off in (0, 256, 512, 768):
        case(f"B=8 H=16 T=256 D=64 bf16 causal ring block, query_offset="
             f"768, key_offset={k_off}", 8, 16, 256, 256, True, q_off=768,
             k_off=k_off, timed=k_off == 768)
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
    ``run()`` step's bitwise, the command line's as printed. The four
    launches run together (``_concurrently``), so each's seconds and
    rates are read with the others beside it."""
    import importlib

    from horovod_tpu_torch.runner import run

    # the parent holds the earlier phases' cache; a child needs ~20 GB
    torch.cuda.empty_cache()
    report = {"phase": "launch", "model": "GPT-2 medium 24x1024, 16 heads",
              "batch": "8x1024"}

    # the four launches, independent processes, run together (each's
    # seconds are read with the others beside it)
    def timed_run():
        # fn pickles by reference, so it must come from a module the
        # worker can import, not from __main__
        smoke = importlib.import_module("chip_smoke")
        t0 = time.perf_counter()
        res = run(smoke.launched_step, np=1, env=_child_env())[0]
        return res, time.perf_counter() - t0

    launched = _concurrently(
        cli=(_stream, (_launcher("-np", "1", "-H", "localhost:1",
                                 *_gpt2(*LAUNCH_ARGS)),), {}),
        run=(timed_run, (), {}),
        np2=(_stream, (_launcher("-np", "2", "-H", "localhost:2",
                                 *_gpt2(*LAUNCH_ARGS)),), {}),
        check_build=(_stream, (_launcher("--check-build"),),
                     {"timeout": 120}))

    # (1) the command line, one slot
    rc, lines, wall = launched["cli"]
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

    # (2) run(fn, np=1)
    res, run_s = launched["run"]
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
    rc, lines, wall = launched["np2"]
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
    rc, lines, _ = launched["check_build"]
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

FSDP_STEPS = 2
#: steps timed after the checked ones (world 1), for the median step time
FSDP_TIMED_STEPS = 3
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
#: the spins the dropped reduce-scatter wait's check tries in turn, until
#: the dropped exchange's spin is still running once its reader is
#: enqueued (the fault was live)
FSDP_SCATTER_SPINS = (FSDP_DELAY_CYCLES, 1 << 26, 1 << 28)


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
    at world 1 over NCCL, 2 steps in each mode, against the
    DistributedOptimizer step on the same seed, weights and batch:
    phase 4's losses and the parameters after 2 steps, bitwise. Launch
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
                   side=None, snapshot=False, pack_check=False,
                   on_enqueued=None):
    """FSDP on GPT-2 medium in a world of ``FSDP_RANKS`` emulated on the
    card (``EmulatedWorld``: each rank keeps only its rows; a gather is
    the concatenation of the ranks' rows, issued on a side stream with
    events; the reduce-scatter ``zero.emulated_scatter_buckets``, with the
    residuals on the int8 wire), each rank's loss its own mean.
    ``mode`` is ``"upfront"`` (the gathered reference) or one of
    ``FSDP_MODES``. Returns the losses, the final shards and residuals
    (and step 1's with ``snapshot``), the figures of one rank's last
    step, and the launches. ``on_enqueued()`` runs once a step's every
    optimizer step is enqueued, before the host waits for the card."""
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
            if on_enqueued is not None:
                on_enqueued()
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


def _faulty_side(drop=None, cycles=FSDP_DELAY_CYCLES):
    """A side stream with the faults of phase 4f (c): each exchange
    behind a spin of ``cycles`` on the side stream, each gather's output
    filled with NaN on the compute stream before it is issued, and the
    compute stream's wait on ``drop`` (``(kind, bucket)``) left out. Its
    ``dropped`` is the event recorded after the dropped exchange's spin:
    still pending once the exchange's reader is enqueued, the fault was
    live."""
    from horovod_tpu_torch.ops import overlap

    class FaultySide(overlap.SideStream):
        dropped = None

        def __init__(self, device):
            super().__init__(device)
            self._spun = {}

        def issue(self, start):
            spun = torch.cuda.Event()

            def delayed():
                torch.cuda._sleep(cycles)
                spun.record()  # on the side stream, after its spin
                return start()
            pending = super().issue(delayed)
            self._spun[pending] = spun
            return pending

        def consume(self, pending, kind, bucket):
            if (kind, bucket) != drop or pending.event is None:
                return super().consume(pending, kind, bucket)
            self.dropped = self._spun[pending]
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
    emulated on the card, GPT-2 medium at 2 x 1024 a rank, 2 steps on
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
    # fault is live only if the dropped exchange's spin still runs once
    # its reader (the rank's optimizer step) is enqueued; a spin that
    # ended first proves nothing, and the run is made again with a
    # longer one. Each try draws a batch no run drew before and runs the
    # fault first, so no block the allocator hands its pack can hold the
    # right rows already
    scatter_spins = []
    for attempt, cycles in enumerate(FSDP_SCATTER_SPINS):
        fresh = [torch.from_numpy(np.random.RandomState(
            seed + 1 + n * attempt + r).randint(
                0, cfg.vocab_size, (2, 1024))).cuda() for r in range(n)]
        sides = {}

        def scatter_side(r, cycles=cycles, sides=sides):
            sides[r] = _faulty_side(
                ("scatter", last) if r == n - 1 else None, cycles)
            return sides[r]

        live = []
        broken_s = _emulated_fsdp(
            cfg, init_named, fresh, None, "regather", 1, side=scatter_side,
            on_enqueued=lambda: live.append(
                sides[n - 1].dropped is not None
                and not sides[n - 1].dropped.query()))
        scatter_spins.append({"cycles": cycles, "live": live == [True]})
        if live == [True]:
            break
        del broken_s
    _require(live == [True], "FSDP's dropped reduce-scatter wait: the "
                             "spin ended before its reader was enqueued "
                             f"in every try {scatter_spins}")
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
                          "dropped_scatter_bucket": last,
                          "dropped_scatter_spins": scatter_spins},
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
    # the two-axis form: the block the world mesh HOROVOD_MESH=dcn=2,
    # ici=2 names gives, with no local-size knob: (a)'s, so its route is
    # the one below
    from horovod_tpu_torch.parallel.mesh import mesh_from_spec

    two_axis = mesh_from_spec("dcn=2,ici=2", n)
    mesh_block = (hier.mesh_block(two_axis),
                  hier.axes_block(("dcn", "ici"), two_axis))
    _require(mesh_block == (block, block),
             f"hierarchical: the dcn=2,ici=2 mesh's blocks (mesh, axes) "
             f"are {mesh_block}, not (a)'s {block}")
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
            "two_axis_dcn2_ici2": {
                "blocks_mesh_axes": list(mesh_block), "route": "(a)'s"},
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

#: the elastic example at GPT-2 medium's width: 16 heads of 64, MLP
#: 4096. Its steps cut from 30 to 20 (a commit every 10 still
#: gives (b) its first commit and (c) its second) to keep the whole
#: smoke inside its time limit
ELASTIC_ARGS = ["--layers", "24", "--hidden", "1024", "--vocab", "50257",
                "--seq-len", "1024", "--batch-size", "8", "--flash",
                "--steps", "20", "--commit-every", "10"]
ELASTIC_STEPS = 20
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


def _elastic_launch(args, out_path, env_extra=None, on_line=None,
                    label=""):
    """Run the elastic launcher over ``elastic_worker``; each output line
    is stamped with ``time.time()`` and handed to ``on_line(t, line,
    proc)``, and printed after the run with ``label``. Returns ``(exit
    code, [(t, line)], t0, t1)``. Past ``ELASTIC_TIMEOUT_S`` the launcher
    gets SIGTERM (its driver stops the round's workers) and the smoke
    fails."""
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
    print("\n".join(f"elastic{label} +{t - t0:.2f} s: {line}"
                    for t, line in lines))
    return rc, lines, t0, t1


def _concurrently(**calls):
    """Run each ``name=(fn, args, kwargs)`` on a thread of its own, all
    at once; their results by name once all have returned. The first
    exception any raised is raised again here, after every call ended."""
    import threading

    results, errors = {}, []

    def one(name, fn, a, kw):
        try:
            results[name] = fn(*a, **kw)
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    threads = [threading.Thread(target=one, args=(name, *call))
               for name, call in calls.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


#: how long phase 4k (b) waits for the driver's scrape to hold rank 0's
#: pushed series (the worker pushes every second)
ELASTIC_SCRAPE_WAIT_S = 5.0


def _driver_scrape(worker_pid):
    """The elastic driver's ``GET /metrics``, found through the worker's
    environment (its rendezvous address), once it holds rank 0's pushed
    series (or after ``ELASTIC_SCRAPE_WAIT_S``)."""
    import urllib.request

    with open(f"/proc/{worker_pid}/environ", "rb") as f:
        env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                   if b"=" in kv)
    url = (f"http://{env[b'HVD_TPU_RENDEZVOUS_ADDR'].decode()}:"
           f"{env[b'HVD_TPU_RENDEZVOUS_PORT'].decode()}/metrics")
    deadline = time.monotonic() + ELASTIC_SCRAPE_WAIT_S
    while True:
        with urllib.request.urlopen(url, timeout=5) as r:
            text = r.read().decode()
        if 'rank="0"' in text or time.monotonic() > deadline:
            return text
        time.sleep(0.2)


def _elastic_observed(scrape, driver_flight, worker_flight):
    """Phase 4k (b)'s telemetry: the driver's scrape during the run holds
    rank 0's pushed series, labeled, and lints clean; after the SIGTERM
    the driver persisted the worker's dump, whose ``preempt`` record and
    receipt stamp are there, and ``tools.flight_analyze`` reads it."""
    from horovod_tpu_torch.tools import flight_analyze
    from horovod_tpu_torch.utils import flight, metrics

    lint = metrics.lint_exposition(scrape)
    pushed = [line for line in scrape.splitlines()
              if not line.startswith("#") and 'rank="0"' in line]
    _require(lint == [] and any(
        line.startswith("hvd_collectives_total{") for line in pushed),
             f"phase 4k (b): the driver's scrape lints {lint[:3]} and has "
             f"{len(pushed)} series of rank 0")
    persisted = os.path.join(driver_flight, "flight_rank0.jsonl")
    _require(os.path.exists(persisted),
             f"phase 4k (b): the driver persisted no dump in {driver_flight}"
             f" ({os.listdir(driver_flight) if os.path.isdir(driver_flight) else 'no directory'})")
    with open(persisted) as f:
        header, events = flight.parse_dump(f.read())
    receipt = header.get("receipt", {})
    _require(header.get("reason") == "preemption"
             and any(e["kind"] == "preempt" for e in events)
             and receipt.get("bytes", 0) > 0,
             f"phase 4k (b): the persisted dump reads {header}")
    rc, out = _quiet(flight_analyze.main, [persisted])
    _require(rc == 0 and "dump: preemption" in out,
             f"phase 4k (b): flight_analyze gave {rc}: {out}")
    return {"scrape_series_rank0": len(pushed),
            "scrape_bytes": len(scrape.encode()),
            "dump_events": len(events),
            "dump_bytes": os.path.getsize(persisted),
            "dump_to_receipt_s": receipt["recv_time_unix"]
            - header["time_unix"],
            "worker_dump": os.path.exists(
                os.path.join(worker_flight, "flight_rank0.jsonl"))}


def _elastic_line(lines, text):
    return next(((t, l) for t, l in lines if text in l), (None, None))


def _elastic_in_process(ledger, report):
    """Phase 4k (a): ``gpt2_elastic.main`` in this process (its launch
    counts, falling loss, commit readings and the digests the launched
    runs are held to) and ``hvd.data.device_prefetch``; returns the
    digests and the run's seconds."""
    import gc

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.data import device_prefetch
    from horovod_tpu_torch.examples import gpt2_elastic
    from horovod_tpu_torch.ops import _build

    per_step = ELASTIC_LAYERS
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
    return want, wall_a


def train_elastic(ledger):
    """Phase 4k. The port of ``examples/gpt2_elastic.py`` at GPT-2
    medium's width (``ELASTIC_ARGS``: 24 x 1024, 16 heads of 64, vocab
    50257, batch 8 x 1024, ``--flash``, 20 steps, a commit every 10) at
    world 1 over NCCL:

    (a) in process through its ``main``: a falling loss, B1-B3 exactly
        ``ELASTIC_LAYERS`` a step by the launch counts; each commit
        interval's ms a step and tokens/s, each ``commit()``'s seconds;
        the sha256 of every
        parameter's and Adam moment's bytes after 20 steps; and
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

    (b) and (c) run at the same time (``_concurrently``), and (a) in this
    process beside them (``_elastic_in_process``), so each's seconds are
    read with the others beside it on the card and the host.

    Each run's launch counts are zeroed just before it and read just
    after (the workers' own, for (b) and (c))."""
    import shutil
    import signal
    import tempfile

    per_step = ELASTIC_LAYERS
    report = {"phase": "train_elastic",
              "model": f"GPT-2 medium width {ELASTIC_LAYERS}x1024, "
                       "batch 8x1024, Adam"}
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

        # (b) preempted after the worker's first commit, with metrics
        # pushed to the driver's store every second and the flight
        # recorder's dumps in a directory of the worker's (--flight-dir)
        # and, persisted by the driver, one of its own
        emergency = os.path.join(root, "emergency.pkl")
        out_b = os.path.join(root, "b.json")
        driver_flight = os.path.join(root, "driver_flight")
        worker_flight = os.path.join(root, "worker_flight")
        sent = {}

        def preempt(t, line, proc):
            if "sigterm" in sent or "step 10:" not in line:
                return
            workers = [pid for pid in _children(proc.pid)
                       if "--elastic-worker" in open(
                           f"/proc/{pid}/cmdline").read()]
            if workers:
                try:
                    sent["scrape"] = _driver_scrape(workers[0])
                except (OSError, KeyError) as e:  # fails below
                    sent["scrape"] = f"scrape failed: {e!r}"
                sent["sigterm"], sent["pid"] = time.time(), workers[0]
                os.kill(workers[0], signal.SIGTERM)

                def gone():
                    while os.path.exists(f"/proc/{workers[0]}"):
                        time.sleep(0.02)
                    sent["exit"] = time.time()

                import threading

                threading.Thread(target=gone, daemon=True).start()

        # (b) and (c), independent jobs on the one card, run together and
        # beside (a): each is mostly its processes' start and the
        # emergency file's write and read, and none holds a time limit
        import threading

        out_c = os.path.join(root, "c.json")
        runs, failed = {}, []

        def launch_b_and_c():
            try:
                runs.update(_concurrently(
                    b=(_elastic_launch, (
                        ["-np", "1", "--min-np", "1", "--max-np", "1",
                         "--host-discovery-script", one,
                         "--emergency-checkpoint", emergency,
                         "--flight-dir", worker_flight], out_b), dict(
                        on_line=preempt, label=" (b)",
                        env_extra={"HOROVOD_METRICS": "1",
                                   "HOROVOD_METRICS_PUSH_INTERVAL_S": "1",
                                   "HOROVOD_FLIGHT_DIR": driver_flight})),
                    c=(_elastic_launch, (
                        ["-np", "1", "--min-np", "1", "--max-np", "1",
                         "--host-discovery-script", two], out_c), dict(
                        label=" (c)", env_extra={
                            "HOROVOD_TPU_FAULT_SPEC": ELASTIC_KILL_SPEC}))))
            except BaseException as e:  # raised again below, after (a)
                failed.append(e)

        jobs = threading.Thread(target=launch_b_and_c)
        jobs.start()
        try:
            want, wall_a = _elastic_in_process(ledger, report)
        finally:
            jobs.join()
        if failed:
            raise failed[0]
        rc, lines, t0, t1 = runs["b"]
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
        observed = _elastic_observed(sent["scrape"], driver_flight,
                                     worker_flight)
        report["b_preempted"] = {
            "bitwise": True, "recovered_epoch": epoch,
            "sigterm_to_exit_s": sent["exit"] - sent["sigterm"],
            "emergency_bytes": os.path.getsize(emergency),
            "exit_to_first_step_s": got_b["first_step_unix"] - sent["exit"],
            "job_s": t1 - t0, "a_wall_s": wall_a,
            "second_round_commit_s": got_b["commit_s"],
            "telemetry": observed}
        os.remove(emergency)

        # (c) killed at its second commit
        rc, lines, t0, t1 = runs["c"]
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
#: the seconds of observability part 3's checks (the scrapes, the
#: comparisons, the file reads) inside phases 4l and 8, reported as their
#: own ``phase_seconds`` entry and taken out of those phases'
PART3_S = {"4l": 0.0, "8": 0.0}


def _prom(text):
    """A Prometheus exposition's samples: ``{(name, labels): value}``,
    ``labels`` the text between the braces ('' without)."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            name, _, labels = key.partition("{")
            out[(name, labels.rstrip("}"))] = float(val)
    return out


def _scrape(addr):
    """``GET /metrics`` of a serving process (unauthenticated)."""
    import urllib.request

    with urllib.request.urlopen(f"http://{addr}/metrics", timeout=10) as r:
        return r.read().decode()


def _eager_telemetry_a(rt, snap0, snap1, params, tl_path):
    """Phase 4l (a)'s telemetry, read from the run that just ended: the
    runtime's records against its own counters. The batch histogram
    counts the executor's batches; the fused counters carry the 12
    buckets' tensors and bytes every step; the negotiation histogram
    counts the tensors that went through the controller (the warm-up's,
    not the fast path's), and the timeline holds a NEGOTIATE span for
    each and one plan activation, the flight ring one ``plan_activate``;
    the plan cache's and the controller's gauges are
    ``metrics_snapshot()`` read around the same scrape."""
    from horovod_tpu_torch.utils import flight, metrics

    before = rt.metrics_snapshot()
    text = metrics.scrape()
    after = rt.metrics_snapshot()
    _require(not metrics.lint_exposition(text),
             "phase 4l (a): the exposition does not lint")
    got = _prom(text)
    batches = snap1["executor_batches"] - snap0["executor_batches"]
    hits = snap1["fast_path_hits"] - snap0["fast_path_hits"]
    tensors = EAGER_BUCKETS * EAGER_STEPS
    nbytes = sum(p.numel() * p.element_size() for p in params)
    negotiated = tensors - hits
    want = {
        ("hvd_batch_execution_seconds_count", 'op="allreduce"'): batches,
        ("hvd_fused_tensors_total", 'op="allreduce"'): tensors,
        ("hvd_fused_batch_bytes_total", 'op="allreduce"'):
            nbytes * EAGER_STEPS,
        ("hvd_negotiation_seconds_count", ""): negotiated,
        ("hvd_eager_fast_path_hits_total", ""): after["fast_path_hits"],
        ("hvd_eager_fast_path_steps_total", ""): after["fast_path_steps"],
        ("hvd_eager_fast_path_activations_total", ""):
            after["fast_path_activations"],
        ("hvd_eager_fast_path_active", ""): after["fast_path_active"],
    }
    wrong = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    _require(not wrong, f"phase 4l (a): records against the runtime's own "
                        f"counters (got, want): {wrong}")
    cycles = got.get(("hvd_coord_cycles_total", ""))
    _require(cycles is not None
             and before["cycles"] <= cycles <= after["cycles"],
             f"phase 4l (a): hvd_coord_cycles_total {cycles} outside the "
             f"snapshots' {before['cycles']}..{after['cycles']}")
    with open(tl_path) as f:
        events = json.load(f)
    spans = sum(1 for e in events if e["ph"] == "B"
                and e["name"] == "NEGOTIATE_ALLREDUCE")
    plans = sum(1 for e in events if e["name"] == "PLAN_ACTIVATED")
    kinds = [e[3] for e in flight.snapshot()]
    _require(spans == negotiated and plans == 1
             and kinds.count("plan_activate") == 1,
             f"phase 4l (a): timeline NEGOTIATE spans {spans} (negotiated "
             f"{negotiated}), plan activations {plans}, flight "
             f"plan_activate {kinds.count('plan_activate')}")
    return {"batches": batches, "negotiated_tensors": negotiated,
            "fast_path_hits": hits, "timeline_events": len(events),
            "timeline_bytes": os.path.getsize(tl_path),
            "flight_events": len(kinds), "exposition_bytes": len(text),
            "batch_execution_ms_mean": got[
                ("hvd_batch_execution_seconds_sum", 'op="allreduce"')]
            / max(batches, 1) * 1e3,
            "negotiation_ms_mean": got[("hvd_negotiation_seconds_sum", "")]
            / max(negotiated, 1) * 1e3}


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
    loss bitwise phase 4's step 1 (phase 4e's ``run()`` leg). The two
    run together (``_concurrently``), each's seconds read beside the
    other."""
    import importlib

    from horovod_tpu_torch.runner import run

    torch.cuda.empty_cache()
    env = {"HVD_TPU_NATIVE": "1", "HOROVOD_LOG_LEVEL": "INFO"}
    smoke = importlib.import_module("chip_smoke")
    run_env = dict(_child_env(), HVD_TPU_NATIVE="1",
                   HOROVOD_CYCLE_TIME="2", HOROVOD_CACHE_CAPACITY="256",
                   HOROVOD_STALL_ABORT_S="120")

    def timed_run():
        t0 = time.perf_counter()
        res = run(smoke.launched_eager_step, np=1, env=run_env)[0]
        return res, time.perf_counter() - t0

    # the command line and run(), independent processes, run together
    both = _concurrently(
        cli=(_stream, (_launcher("-np", "1", "-H", "localhost:1",
                                 *EAGER_LAUNCH_FLAGS, *_gpt2(*LAUNCH_ARGS)),),
             {"env_extra": env}),
        run=(timed_run, (), {}))
    rc, lines, wall = both["cli"]
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
    res, run_s = both["run"]
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
        (``_eager_launch``); (d) and (e)'s processes run together.

    Launch counts are zeroed just before each run and read just after."""
    import shutil
    import tempfile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.examples.gpt2_pretraining import synthetic_tokens
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.eager_runtime import DistExecutor
    from horovod_tpu_torch.optim.compression import WireSpec, wire_sent_bytes
    from horovod_tpu_torch.utils import flight, metrics

    t_phase = time.perf_counter()
    report = {"phase": "eager", "model": "GPT-2 medium 24x1024, 16 heads",
              "batch": "8x1024", "steps": EAGER_STEPS}
    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    os.environ["HVD_TPU_NATIVE"] = "1"
    tmp = tempfile.mkdtemp(prefix="hvd_eager_")
    flight_was = flight.enabled()
    metrics.reset()
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
        # part 3: metrics, the flight recorder (on since init()) and a
        # timeline on for (a) and (b)
        tl_path = os.path.join(tmp, "eager_a_timeline.json")
        metrics.enable()
        flight.clear()
        hvd.start_timeline(tl_path)
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
        hvd.stop_timeline()
        t3 = time.perf_counter()
        telemetry_a = _eager_telemetry_a(rt, snap0, snap1, params, tl_path)
        PART3_S["4l"] += time.perf_counter() - t3
        print(json.dumps({"eager telemetry (a)": telemetry_a}))
        report["a"] = {"telemetry": telemetry_a,
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
        wire0 = metrics.registry.snapshot()
        spec = WireSpec("int8", EAGER_BLOCK, error_feedback=True)
        reckoned = [0, 0]  # the int8 wire's logical and sent bytes
        for i in range(EAGER_STEPS):
            recorder.log = []
            _build.reset_launches()
            loss, ms = timed(step)
            for _, flat, _, _, outs in recorder.log:
                itemsize = outs[0].element_size()  # the bucket's dtype
                reckoned[0] += flat.numel() * itemsize
                reckoned[1] += wire_sent_bytes(flat.numel(), itemsize, spec)
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
        t3 = time.perf_counter()
        wire1 = metrics.registry.snapshot()
        wire = [wire1[f"hvd_wire_bytes_{k}_total"][""]
                - wire0[f"hvd_wire_bytes_{k}_total"][""]
                for k in ("logical", "sent")]
        _require(wire == reckoned,
                 f"phase 4l (b): hvd_wire_bytes logical/sent {wire}, the "
                 f"int8 wire's reckoning at block {EAGER_BLOCK} {reckoned}")
        PART3_S["4l"] += time.perf_counter() - t3
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
            "wire_bytes_logical_sent": wire,
            "int8_launches_per_step": {k: total[k] / EAGER_STEPS
                                       for k in INT8_KERNELS},
            "profiled_step_device_ms": by,
            "step_ms_median": float(np.median([s["ms"] for s in b_steps]))}
        rt._executor = recorder.inner
        rt.set_wire(None)
        del model, opt, step, recorder
        torch.cuda.empty_cache()

        metrics.disable()
        # (c) the ready event
        report["c"] = _eager_ready_wait()
        hvd.shutdown()
    finally:
        os.environ.pop("HVD_TPU_NATIVE", None)
        hvd.stop_timeline()
        if hvd.is_initialized():
            hvd.shutdown()
        metrics.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    from horovod_tpu_torch.utils.timeline import active_timeline

    _require(not metrics.enabled() and flight.enabled() == flight_was
             and active_timeline() is None,
             "phase 4l: telemetry left on after the phase: metrics "
             f"{metrics.enabled()}, flight {flight.enabled()}, timeline "
             f"{active_timeline() is not None}")
    torch.cuda.empty_cache()

    # (d) the stall watchdog, in a process of its own, and (e) the
    # launcher's processes, all run together
    def stall_process():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--eager-stall-worker"], cwd=HERE, env=_child_env(),
            capture_output=True, text=True, timeout=180)
        return proc, time.perf_counter() - t0

    both = _concurrently(d=(stall_process, (), {}),
                         e=(_eager_launch, (ledger, in_process_losses), {}))
    proc, process_s = both["d"]
    line = next((l for l in reversed(proc.stdout.splitlines())
                 if l.startswith("{")), None)
    _require(proc.returncode == 0 and line,
             f"phase 4l (d): exit {proc.returncode}:\n{proc.stderr[-3000:]}")
    d = json.loads(line)
    _require(d["raised"] and "stalled" in d["raised"]
             and d["raise_s"] < EAGER_STALL_ABORT_S + EAGER_STALL_SLACK_S,
             f"phase 4l (d): {d}")
    report["d"] = {**d, "abort_s": EAGER_STALL_ABORT_S,
                   "process_s": process_s}
    report["e"] = both["e"]
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(report))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4m: GPT-2 medium on a tp = 4 and an sp = 4 mesh (ring, Ulysses),
# four ranks emulated on the card
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_STEPS = 2  # launches counted over both, the second timed
#: (name, mesh axes, sequence_parallel) of phase 4m's emulated worlds
MESH_CASES = (("tp=4", {"tp": 4}, None),
              ("sp=4 ring", {"sp": 4}, "ring"),
              ("sp=4 ulysses", {"sp": 4}, "ulysses"))
#: the faults each case's step-1 check must catch (``_mesh_fault``)
MESH_FAULTS = {"tp=4": ("drop_attn_out_reduce", "fc2_partial_left_out"),
               "sp=4 ring": ("skip_ring_block", "wrong_key_offset"),
               "sp=4 ulysses": ("all_to_all_reversed",)}
#: limits of phase 4m's step-1 check against phase 4's world-1 step on
#: the same weights and batch. Each parameter's gradient is held row by
#: row (a row's relative L2, its norm floored at 1% of the tensor's RMS
#: row norm): over 8 batch seeds the healthy worst read 0.206 (tp = 4),
#: 0.202 (ring) and 0.061 (Ulysses), the worst rows in the key kernels,
#: whose gradient goes through dS = P * (dP - delta); the least fault
#: read 1.13 (a skipped ring block), the others 8.6-97.7
#: (``--mesh-sweep 8`` on an NVIDIA H100 80GB HBM3, 700 W; PERF.md). Both
#: sides run the same kernels in bf16; the emulated ranks' products have
#: other shapes (cuBLAS sums in another order) and the ring merges bf16
#: block outputs by their lse. The loss (absolute; healthy worst 1.9e-4,
#: faults 2.4e-4 to 1.0e-2) and the attention key biases (whose true
#: gradient is 0: against the whole gradient's norm; healthy worst
#: 7.7e-6) are held to sanity bounds only: the gradient rows catch the
#: faults
MESH_GRAD_TOL = 0.5
MESH_LOSS_TOL = 1e-3
MESH_KEY_BIAS_TOL = 1e-3


def _card():
    """The card's name and power limit as nvidia-smi gives them, to
    stand beside the numbers they qualify."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def _mesh_launches(case):
    """B1-B5 launches a step, over the four emulated ranks: B1-B3 once a
    layer a rank (tp: its 4 heads; Ulysses: its 4 heads over the whole
    sequence), the ring's blocks below the diagonal only (1 + 2 + 3 + 4
    a layer over the ranks, as many of B2 and B3); the 49 norms once a
    rank each."""
    layers, n = 24, MESH_RANKS
    flash = layers * (n * (n + 1) // 2 if "ring" in case else n)
    return {"flash_fwd": flash, "flash_bwd_dq": flash,
            "flash_bwd_dkv": flash, "layernorm_fwd": 49 * n,
            "layernorm_bwd": 49 * n}


def _mesh_grad_readings(full, ref):
    """Phase 4m's step-1 gradient readings: each parameter's largest
    row error (rows along its first dimension; a vector is one row) as
    a share of the row's norm, floored at 1% of the tensor's RMS row
    norm; the key biases' error over the whole gradient's norm."""
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in ref.values()))
    rows, key_bias = {}, {}
    for n, r in ref.items():
        r = r.float()
        d = full[n].float() - r
        if n.endswith("attn.key.bias"):
            key_bias[n] = (d.norm() / total).item()
            continue
        r2 = r.reshape(r.shape[0], -1) if r.dim() > 1 else r.reshape(1, -1)
        rn = r2.norm(dim=1)
        floor = 1e-2 * rn.square().mean().sqrt()
        rows[n] = (d.reshape(r2.shape).norm(dim=1)
                   / torch.clamp(rn, min=floor.item())).max().item()
    worst = max(rows, key=rows.get)
    return {"grad_row_rel_max": rows[worst], "grad_worst": worst,
            "grad_row_rel_median": float(np.median(list(rows.values()))),
            "key_bias_over_grad_norm_max": max(key_bias.values())}


@contextlib.contextmanager
def _mesh_fault(name, model, rank, sync):
    """One injected fault of phase 4m, on every emulated rank (``sync``
    is the ranks' barrier; the module-level patches are made by rank 0
    between two barriers): the attention's output all-reduce dropped
    (each rank keeps its partial), rank 1's ``fc2`` partial left out of
    the MLP's all-reduce, the ring's block from rank 0 skipped on rank
    3, every ring block's ``key_offset`` 128 positions late, or the
    Ulysses all-to-all's chunks taken in reverse order."""
    import importlib

    from horovod_tpu_torch.parallel import comm as pc
    from horovod_tpu_torch.parallel import tensor_parallel as tpm
    from horovod_tpu_torch.parallel import ulysses as ul

    # the package exports the function ring_attention under the module's
    # name
    ra = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")

    saved = {}
    if name in ("drop_attn_out_reduce", "fc2_partial_left_out"):
        tp = model.tp

        class _LeftOut:
            rank, size = tp.comm.rank, tp.comm.size

            def all_reduce(self, t):
                parts = tp.comm.all_gather(t)
                return pc.sum_in_rank_order(parts[:1] + parts[2:])

        class _Faulty(tpm.TensorParallel):
            def reduce_out(self, x):
                if name == "drop_attn_out_reduce":
                    return x
                return tpm._ReduceOut.apply(x, _LeftOut())

        faulty = _Faulty(tp.comm)
        for b in model.blocks:
            if name == "drop_attn_out_reduce":
                b.attn.tp = faulty
            else:
                b.mlp.tp = faulty
        try:
            yield
        finally:
            for b in model.blocks:
                b.attn.tp = b.mlp.tp = tp
        return
    sync()
    if rank == 0:
        if name == "skip_ring_block":
            blocks = saved["_blocks"] = ra._blocks

            def skipping(r, n, causal):
                for s, src, visible in blocks(r, n, causal):
                    yield s, src, visible and not (r == n - 1 and src == 0)

            ra._blocks = skipping
        elif name == "wrong_key_offset":
            fwd, bwd = saved["flash_fwd"], saved["flash_bwd"] = \
                ra.flash_fwd, ra.flash_bwd
            ra.flash_fwd = lambda *a: fwd(*a[:-1], a[-1] + 128)
            ra.flash_bwd = lambda *a: bwd(*a[:-1], a[-1] + 128)
        elif name == "all_to_all_reversed":
            a2a = saved["_all_to_all"] = ul._all_to_all

            def reversed_a2a(x, comm, split, cat):
                chunks = [c.contiguous() for c in x.chunk(comm.size, split)]
                return torch.cat(comm.all_to_all(chunks)[::-1], dim=cat)

            ul._all_to_all = reversed_a2a
        else:
            raise ValueError(f"no phase 4m fault {name!r}")
    sync()
    try:
        yield
    finally:
        sync()
        if rank == 0:
            for attr, fn in saved.items():
                setattr(ul if attr == "_all_to_all" else ra, attr, fn)
        sync()


def mesh_world(cfg, tokens, axes, sequence_parallel, faults=(),
               steps=MESH_STEPS):
    """One emulated world of phase 4m: ``MESH_RANKS`` threads on the
    card, each rank building ``make_lm_train_step(cfg, AdamW, mesh=...)``
    on its own ``Mesh`` whose live axis runs over a ``ThreadComm``
    (``parallel/comm.py``; every other line of the step is the real
    path's). Each rank takes the step-1 backward on ``tokens`` (its rows
    and span of them), then each fault's, then ``steps`` training steps,
    timed from the second. Returns rank 0's view: its loss, every rank's
    gradients (rank 0's only under sp, where every rank's must be bitwise
    the same), each fault's, the step losses, seconds, the launches of
    the steps, the peak memory and whether the parameters that every
    rank holds whole are bitwise the same on every rank."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn
    from horovod_tpu_torch.parallel import comm as pc
    from horovod_tpu_torch.parallel import mesh as pm
    from horovod_tpu_torch.parallel import sharding as psh

    layout = pm.make_mesh(world=MESH_RANKS, **axes)
    (axis,) = axes
    world = pc.ThreadWorld(MESH_RANKS)
    factory = functools.partial(torch.optim.AdamW, lr=1e-4,
                                weight_decay=1e-4)
    flash = (make_flash_attention_fn(causal=True)
             if sequence_parallel is None else None)
    def grads_of(model, rank, sync):
        g = {n: p.grad for n, p in model.named_parameters()}
        if axis == "sp":
            every = sync(g)
            same = all(torch.equal(every[0][n], v) for n, v in g.items())
            _require(same, f"phase 4m {axes}: rank {rank}'s gradients are "
                           "not bitwise rank 0's")
            return every[0] if rank == 0 else None
        return g

    def rank_fn(rank):
        def sync(value=None):
            return world.exchange(rank, value)

        mesh = pm.Mesh(layout.axis_names, layout.shape, rank,
                       comms={axis: pc.ThreadComm(world, rank)})
        model, step = hvd.make_lm_train_step(
            cfg, factory, mesh=mesh, attention_fn=flash,
            sequence_parallel=sequence_parallel)
        out = {"specs": step.specs}
        out["loss"] = float(step.backward(tokens))
        out["grads"] = grads_of(model, rank, sync)
        step.optimizer.zero_grad(set_to_none=True)
        out["faults"] = {}
        for name in faults:
            with _mesh_fault(name, model, rank, sync):
                loss = float(step.backward(tokens))
            out["faults"][name] = {"loss": loss,
                                   "grads": grads_of(model, rank, sync)}
            step.optimizer.zero_grad(set_to_none=True)
        sync()
        if rank == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
        losses, secs = [], []
        for _ in range(steps):
            sync()
            t0 = time.perf_counter()
            losses.append(step(tokens))
            sync()
            if rank == 0:
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        sync()
        out["losses"] = [float(x) for x in losses]
        if rank == 0:
            torch.cuda.synchronize()
            out["launches"] = dict(_build.LAUNCHES)
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
            out["secs"] = secs
        whole = {n: p.detach() for n, p in model.named_parameters()
                 if step.specs is None
                 or all(e is None for e in step.specs[n])}
        every = sync(whole)
        out["replicated_bitwise"] = all(
            torch.equal(every[0][n], v) for n, v in whole.items())
        out["replicated_params"] = len(whole)
        out["all_grads"] = sync(out["grads"]) if axis == "tp" else None
        out["all_fault_grads"] = {
            name: sync(out["faults"][name]["grads"]) if axis == "tp"
            else None for name in faults}
        return out

    results = pc.run_ranks([world], rank_fn, MESH_RANKS)
    top = results[0]
    _require(all(r["replicated_bitwise"] for r in results),
             f"phase 4m {axes}: a parameter every rank holds whole differs "
             "between the ranks after the steps")
    _require(all(r["losses"] == top["losses"] and r["loss"] == top["loss"]
                 for r in results),
             f"phase 4m {axes}: the ranks' losses differ")
    specs = top["specs"]
    if axis == "tp":
        top["full"] = psh.unshard_params(top["all_grads"], specs, layout)
        top["fault_full"] = {
            name: psh.unshard_params(g, specs, layout)
            for name, g in top["all_fault_grads"].items()}
    else:
        top["full"] = top["grads"]
        top["fault_full"] = {name: f["grads"]
                             for name, f in top["faults"].items()}
    del results
    return top


def _mesh_reference(cfg, tokens):
    """Phase 4's world-1 step on the same weights and batch (seed 0,
    flash attention, fused norms): its step-1 loss and gradients."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn

    factory = functools.partial(torch.optim.AdamW, lr=1e-4,
                                weight_decay=1e-4)
    model, step = hvd.make_lm_train_step(
        cfg, factory, attention_fn=make_flash_attention_fn(causal=True))
    loss = float(step.backward(tokens))
    ref = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    del model, step
    torch.cuda.empty_cache()
    return loss, ref


def _mesh_case_readings(name, top, ref_loss, ref):
    out = {"loss": top["loss"], "loss_err": abs(top["loss"] - ref_loss),
           **_mesh_grad_readings(top["full"], ref), "faults": {}}
    for f, grads in top["fault_full"].items():
        out["faults"][f] = {
            "loss_err": abs(top["faults"][f]["loss"] - ref_loss),
            **_mesh_grad_readings(grads, ref)}
    return out


def _mesh_within(r):
    return (r["loss_err"] <= MESH_LOSS_TOL
            and r["grad_row_rel_max"] <= MESH_GRAD_TOL
            and r["key_bias_over_grad_norm_max"] <= MESH_KEY_BIAS_TOL)


def mesh_sweep(n_seeds):
    """``--mesh-sweep N``: phase 4m's step-1 readings on the batches of
    seeds 0..N-1 (healthy) and of its injected faults on seed 0's, each
    case against the world-1 step: the limits' evidence."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM

    hvd.init()
    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    for seed in range(n_seeds):
        tokens = torch.from_numpy(np.random.RandomState(1000 + seed).randint(
            0, cfg.vocab_size, (8, 1024))).cuda()
        ref_loss, ref = _mesh_reference(cfg, tokens)
        for name, axes, sp in MESH_CASES:
            top = mesh_world(cfg, tokens, axes, sp,
                             faults=MESH_FAULTS[name] if seed == 0 else (),
                             steps=0)
            print(json.dumps({"mesh_sweep": name, "seed": seed,
                              **_mesh_case_readings(name, top, ref_loss,
                                                    ref)}))
            del top
            torch.cuda.empty_cache()
        del ref
    hvd.shutdown()


def _row_sums(g, ref, spec, mesh):
    """This rank's share of a parameter's per-row squared error and
    squared norm (rows along the whole tensor's first dimension, a
    vector one row): its slice's, placed at its rows and divided by the
    number of ranks that hold the same slice, so that a SUM over the
    world is the whole tensor's."""
    from horovod_tpu_torch.parallel import sharding as psh

    spec = spec or ()
    want = psh.local_slice(ref, spec, mesh).float()
    d = g.float() - want
    if ref.dim() > 1:
        d, want = d.reshape(d.shape[0], -1), want.reshape(d.shape[0], -1)
    else:
        d, want = d.reshape(1, -1), want.reshape(1, -1)
    rows = ref.shape[0] if ref.dim() > 1 else 1
    lo = 0
    if d.shape[0] != rows:  # this rank holds a block of the rows
        axes = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
        lo = mesh.group_index(axes) * d.shape[0]
    err = torch.zeros(rows, device=ref.device, dtype=torch.float64)
    nrm = torch.zeros_like(err)
    err[lo:lo + d.shape[0]] = d.double().square().sum(1)
    nrm[lo:lo + d.shape[0]] = want.double().square().sum(1)
    split = math.prod(mesh.axis_size(a) for e in spec if e
                      for a in (e if isinstance(e, tuple) else (e,)))
    holders = mesh.size // split
    return err / holders, nrm / holders


def mesh_world_worker() -> int:
    """``--mesh-world``: one rank of a real world of four cards
    (``python -m horovod_tpu_torch.examples.local_world -np 4 -- python3
    chip_smoke.py --mesh-world``), NCCL between them: phase 4m's and
    phase 4o's cases on real process groups. Each rank takes the
    gradients of phase 4's weights and batch on its own card (the whole
    model, the mean loss), then each case's step-1 gradients (under tp
    and fsdp its slices; its rows of the batch under a data axis,
    reduced over dp by the optimizer's ``synchronize``) and three timed
    steps. The rows' squared errors and norms sum over the world
    (``_row_sums``), each case is held to phase 4m's limits, and rank 0
    prints the readings, step ms, tokens/s, peak memory and launches a
    rank a step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.gpt2_pretraining import synthetic_tokens
    from horovod_tpu_torch.models.transformer import (GPT2_MEDIUM,
                                                      Transformer,
                                                      causal_lm_loss)
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.collectives import Sum, allreduce
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn
    from horovod_tpu_torch.parallel.sharding import batch_slices

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init()
    _require(hvd.size() == MESH_RANKS,
             f"--mesh-world needs {MESH_RANKS} ranks, has {hvd.size()}")
    _build.build(TRAIN_KERNELS)
    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    flash = make_flash_attention_fn(causal=True)
    tokens = torch.from_numpy(synthetic_tokens(
        cfg.vocab_size, 8, 1024, 0, 1)).cuda()
    with torch.device("cuda"):
        model = Transformer(cfg, attention_fn=flash)
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    loss, _ = causal_lm_loss(model(tokens), tokens)
    loss.backward()
    ref_loss = loss.item()
    ref = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    del model, loss
    torch.cuda.empty_cache()
    factory = functools.partial(torch.optim.AdamW, lr=1e-4,
                                weight_decay=1e-4)
    report = {"mesh_world": f"{MESH_RANKS} cards, NCCL", "card": _card(),
              "ref_loss": ref_loss, "tol": MESH_GRAD_TOL}
    cases = MESH_CASES + tuple((n, a, None) for n, a in FSDP_AXIS_CASES)
    for name, axes, sp in cases:
        spec = ",".join(f"{a}={s}" for a, s in axes.items())
        model, step = hvd.make_lm_train_step(
            cfg, factory, mesh=spec, attention_fn=None if sp else flash,
            sequence_parallel=sp)
        rows, _ = batch_slices(step.mesh, *tokens.shape)
        mine = tokens[rows]
        loss = float(step.backward(mine))
        step.optimizer.synchronize()
        readings = {}
        for n, p in model.named_parameters():
            err, nrm = _row_sums(p.grad, ref[n],
                                 (step.specs or {}).get(n), step.mesh)
            err, nrm = allreduce(err, op=Sum), allreduce(nrm, op=Sum)
            if n.endswith("attn.key.bias"):
                continue  # a true gradient of 0
            norm = nrm.sqrt()
            floor = 1e-2 * norm.square().mean().sqrt()
            readings[n] = (err.sqrt() / norm.clamp(min=floor.item())
                           ).max().item()
        step.optimizer.zero_grad(set_to_none=True)
        worst = max(readings, key=readings.get)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        losses, secs = [], []
        for _ in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(mine)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        step_s = float(np.median(secs[1:]))
        report[name] = {
            "loss": loss, "loss_err": abs(loss - ref_loss),
            "grad_row_rel_max": readings[worst], "grad_worst": worst,
            "losses": losses, "step_ms": step_s * 1e3,
            "step_ms_all": [x * 1e3 for x in secs],
            "tokens_per_s": 8 * 1024 / step_s,
            "peak_mem_gb_rank": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": {k: _build.LAUNCHES[k] / MESH_STEPS
                                  for k in TRAIN_KERNELS}}
        _require(readings[worst] <= MESH_GRAD_TOL
                 and report[name]["loss_err"] <= MESH_LOSS_TOL,
                 f"--mesh-world {name}: {report[name]}")
        _require(losses[-1] < losses[0], f"--mesh-world {name}: {losses}")
        del model, step
        torch.cuda.empty_cache()
    if hvd.rank() == 0:
        print(json.dumps(report), flush=True)
    hvd.shutdown()
    return 0


def train_mesh(seed, ledger, in_process_losses):
    """Phase 4m: GPT-2 medium at full width (24 x 1024, 16 heads, vocab
    50257, ``--flash --fused-norm``, AdamW, seed 0, phase 4's 8 x 1024
    batch) through ``make_lm_train_step(mesh=...)`` on worlds of four
    ranks emulated on the card (``mesh_world``):

    (a) tp = 4: each rank 4 heads and a quarter of the MLP, the vocab
        and the norms whole (``_prune_spec``);
    (b) sp = 4 with ring attention: each rank the [8, 256] span;
    (c) sp = 4 with Ulysses;

    each held at step 1 against phase 4's world-1 step on the same
    weights and batch (the loss, every gradient row by row; the ranks'
    shards put back together), with its injected faults failing the
    same check, then 2 steps with a falling loss, exact B1-B5 launches,
    the whole parameters bitwise across the ranks, step ms, tokens/s
    and peak memory; and (d) a world of one over NCCL with
    ``HOROVOD_MESH=dp=1,tp=1``: phase 4's losses bitwise."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.gpt2_pretraining import synthetic_tokens
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    tokens = torch.from_numpy(synthetic_tokens(
        cfg.vocab_size, 8, 1024, 0, 1)).cuda()
    report = {"phase": "mesh", "card": _card(),
              "model": "GPT-2 medium 24x1024, 16 heads",
              "batch": "8x1024", "ranks": MESH_RANKS,
              "emulated": "threads on one card, one stream",
              "tol": {"loss": MESH_LOSS_TOL, "grad_row_rel": MESH_GRAD_TOL,
                      "key_bias": MESH_KEY_BIAS_TOL}}
    hvd.init()
    ref_loss, ref = _mesh_reference(cfg, tokens)
    _require(ref_loss == in_process_losses[0],
             f"phase 4m: the world-1 step's loss {ref_loss} is not phase "
             f"4's {in_process_losses[0]}")
    total = {}
    for name, axes, sp in MESH_CASES:
        t0 = time.perf_counter()
        top = mesh_world(cfg, tokens, axes, sp, faults=MESH_FAULTS[name])
        r = _mesh_case_readings(name, top, ref_loss, ref)
        want = {k: v * MESH_STEPS for k, v in _mesh_launches(name).items()}
        got = {k: top["launches"][k] for k in want}
        step_s = float(np.median(top["secs"][1:]))
        r.update(losses=top["losses"], launches=got,
                 launches_per_step=_mesh_launches(name),
                 replicated_params=top["replicated_params"],
                 replicated_bitwise=True, step_ms=step_s * 1e3,
                 step_ms_all=[x * 1e3 for x in top["secs"]],
                 tokens_per_s=8 * 1024 / step_s,
                 peak_mem_gb_world=top["peak_bytes"] / 1e9,
                 peak_mem_gb_per_rank=top["peak_bytes"] / 1e9 / MESH_RANKS,
                 case_s=time.perf_counter() - t0)
        report[name] = r
        print(json.dumps({"phase": "mesh", "case": name, **r}))
        del top
        torch.cuda.empty_cache()
        _require(_mesh_within(r),
                 f"phase 4m {name}: step 1 against the world-1 step reads "
                 f"{r}")
        for f, fr in r["faults"].items():
            _require(not _mesh_within(fr),
                     f"phase 4m {name}: the fault {f} passes: {fr}")
        _require(got == want, f"phase 4m {name}: launches {got}, not {want}")
        _require(all(np.isfinite(r["losses"]))
                 and r["losses"][-1] < r["losses"][0],
                 f"phase 4m {name}: losses {r['losses']}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    del ref
    hvd.shutdown()

    # (d) a trivial mesh changes nothing
    os.environ["HOROVOD_MESH"] = "dp=1,tp=1"
    try:
        hvd.init()
        _require(hvd.mesh().sizes == {"dp": 1, "tp": 1},
                 f"phase 4m (d): hvd.mesh() is {hvd.mesh()!r}")
        factory = functools.partial(torch.optim.AdamW, lr=1e-4,
                                    weight_decay=1e-4)
        _build.reset_launches()
        _, step = hvd.make_lm_train_step(
            cfg, factory, attention_fn=make_flash_attention_fn(causal=True))
        losses = [float(step(tokens)) for _ in range(MESH_STEPS)]
        torch.cuda.synchronize()
        for k, v in _build.LAUNCHES.items():
            if v:
                total[k] = total.get(k, 0) + v
        del step
        _require(losses == in_process_losses[:MESH_STEPS],
                 f"phase 4m (d): HOROVOD_MESH=dp=1,tp=1 losses {losses} "
                 f"are not phase 4's {in_process_losses[:MESH_STEPS]}")
        report["d"] = {"mesh": "dp=1,tp=1", "losses": losses,
                       "bitwise_phase4": True}
    finally:
        hvd.shutdown()
        del os.environ["HOROVOD_MESH"]
    ledger["train_mesh"] = total
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(report))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4n: pipeline parallelism (GPipe, 1F1B) and experts, four ranks
# emulated on the card
# ---------------------------------------------------------------------------

PIPE_RANKS = 4
PIPE_STEPS = 2  # launches counted over both, the second timed
#: the stage whose backward hop is zeroed, or whose backward runs a slot
#: early, in the faults (a middle stage: the last one's backward follows
#: its forward in the next slot, so one slot early is still right)
PIPE_FAULT_STAGE = 1
#: (schedule, microbatches, faults, training steps) of phase 4n's worlds;
#: GPipe at M = 8 runs its step-1 check and its memory reading only
PIPE_CASES = (
    ("gpipe", 4, ("zero_bwd_hop", "head_cotangent_every_stage"),
     PIPE_STEPS),
    ("gpipe", 8, (), 0),
    ("1f1b", 4, ("backward_slot_early", "padded_microbatch_counts_1"),
     PIPE_STEPS),
    ("1f1b", 8, ("backward_slot_early", "padded_microbatch_counts_1"),
     PIPE_STEPS))
#: the rows of phase 4's batch whose targets (all of them) the padded runs
#: mark -1: microbatches 2-3 at M = 4, 4-7 at M = 8, no valid target
PIPE_PADDED_ROWS = slice(4, 8)
#: limits of phase 4n's step-1 check against phase 4's world-1 step on
#: the same weights and batch, read as phase 4m's (``_mesh_grad_readings``):
#: each parameter's worst gradient row and the loss (absolute). The
#: rows catch a zeroed backward hop (the stages before it get no
#: gradient) and S copies of the head's cotangent (every block's
#: gradient S times too large); only the loss catches a fully padded
#: microbatch counted as 1 (the gradients shrink by n / (n + 2) or
#: n / (n + 4)). Readings: PERF.md, ``--pipe-sweep``
PIPE_GRAD_TOL = 0.5
PIPE_LOSS_TOL = 1e-3
PIPE_KEY_BIAS_TOL = 1e-3
#: phase 4n (d): MoeMlp at GPT-2 medium's width with Mixtral's routing
MOE_DIMS = dict(hidden_size=1024, mlp_dim=4096, num_experts=8, top_k=2)
MOE_TOKENS, MOE_RANKS = 8192, 4
#: capacity factors: nothing drops (EP against the dense path), and
#: Switch's 1.25 (EP against the dense path with the drop rule's gates)
MOE_AMPLE, MOE_CAPACITY = 8.0, 1.25
#: limit of each output and input-gradient row's relative L2 (its norm
#: floored at 1% of the RMS row norm) between the EP path and its
#: reference: bf16 expert products of other shapes and the k
#: contributions rounded one add at a time. Readings: ``--pipe-sweep``
MOE_ROW_TOL = 5e-2


def _pipe_launches(schedule, m, layers=24, stages=PIPE_RANKS):
    """B1-B5 launches a step over the emulated world, reckoned from the
    schedules: GPipe runs each block once a microbatch, forward and
    backward, and ``ln_final`` once on every stage (the head runs on
    every stage's copy of the outputs, as the JAX function returns the
    logits on every device); 1F1B runs the forward on every stage but
    the last, each stage's again inside its backward (the recompute),
    and ``ln_final`` once a microbatch on the last stage."""
    blocks = layers * m
    if schedule == "gpipe":
        return {"flash_fwd": blocks, "flash_bwd_dq": blocks,
                "flash_bwd_dkv": blocks, "layernorm_fwd": 2 * blocks + stages,
                "layernorm_bwd": 2 * blocks + stages}
    fwd = blocks * (stages - 1) // stages
    return {"flash_fwd": fwd + blocks, "flash_bwd_dq": blocks,
            "flash_bwd_dkv": blocks, "layernorm_fwd": 2 * (fwd + blocks) + m,
            "layernorm_bwd": 2 * blocks + m}


class _Saved:
    __slots__ = ("owner", "key", "t")

    def __init__(self, owner, key, t):
        self.owner, self.key, self.t = owner, key, t

    def __del__(self):
        self.owner.release(self.key)


class _SavedBytes:
    """The bytes autograd holds for the backward: the storages of the
    tensors saved for it, each counted once while a saved tensor holds
    it, live and at their peak (``saved_tensors_hooks``, which act on the
    thread that enters them: each emulated rank counts its own)."""

    def __init__(self):
        self.live, self.now, self.peak = {}, 0, 0
        self.hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda saved: saved.t)

    def _pack(self, t):
        storage = t.untyped_storage()
        key = storage.data_ptr()
        n, size = self.live.get(key, (0, storage.nbytes()))
        if n == 0:
            self.now += size
            self.peak = max(self.peak, self.now)
        self.live[key] = (n + 1, size)
        return _Saved(self, key, t)

    def release(self, key):
        n, size = self.live[key]
        if n > 1:
            self.live[key] = (n - 1, size)
        else:
            del self.live[key]
            self.now -= size


class _ZeroBackwardHop:
    """A pp communicator whose backward hop delivers zeros (after the
    real exchange: the ranks' hops still pair up)."""

    def __init__(self, comm):
        self.comm, self.rank, self.size = comm, comm.rank, comm.size

    def __getattr__(self, name):
        return getattr(self.comm, name)

    def hop_backward(self, t):
        return torch.zeros_like(self.comm.hop_backward(t))


@contextlib.contextmanager
def _pipe_fault(name, mesh, rank, sync):
    """One injected fault of phase 4n on every emulated rank (``sync``
    is the ranks' barrier; the module-level patches are made by rank 0
    between two barriers): stage ``PIPE_FAULT_STAGE``'s backward hop
    delivering zeros; the last stage's outputs handed every stage's
    cotangent (their sum, S copies); stage ``PIPE_FAULT_STAGE``'s 1F1B
    backward one slot early (it finds no gradient yet); a microbatch
    with no valid target counted as 1. None: no fault."""
    from horovod_tpu_torch.parallel import pipeline as pl

    if name is None:
        yield
        return
    saved = {}
    sync()
    if name == "zero_bwd_hop":
        if rank == PIPE_FAULT_STAGE:
            saved["comm"] = mesh._comms["pp"]
            mesh._comms["pp"] = _ZeroBackwardHop(saved["comm"])
    elif rank == 0:
        if name == "head_cotangent_every_stage":
            share = saved["_hand_back_cotangent"] = pl._hand_back_cotangent
            pl._hand_back_cotangent = lambda g, comm: share(
                comm.all_reduce(g), comm)
        elif name == "backward_slot_early":
            slot = saved["_slot_ops"] = pl._slot_ops

            def early(t, s, S, M):
                f, b = slot(t, s, S, M)
                return (f, slot(t + 1, s, S, M)[1]
                        if s == PIPE_FAULT_STAGE else b)

            pl._slot_ops = early
        elif name == "padded_microbatch_counts_1":
            count = saved["_microbatch_count"] = pl._microbatch_count
            pl._microbatch_count = lambda t: torch.clamp(count(t), min=1)
        else:
            raise ValueError(f"no phase 4n fault {name!r}")
    sync()
    try:
        yield
    finally:
        sync()
        if "comm" in saved:
            mesh._comms["pp"] = saved.pop("comm")
        if rank == 0:
            for attr, fn in saved.items():
                setattr(pl, attr, fn)
        sync()


def pipe_world(cfg, tokens, padded, schedule, m, faults=(),
               steps=PIPE_STEPS, profile=False):
    """One emulated world of phase 4n: ``PIPE_RANKS`` threads on the
    card, rank s holding stage s (``parallel.build_stage``: its 6 blocks
    and the replicated rest, seed 0, flash attention), the pp axis's
    hops between them through ``ThreadComm``s
    (``parallel.mesh.emulated_meshes``), every other line the real
    path's. Each rank takes the step-1 backward of ``schedule``
    (``pipeline_lm_train_step_gpipe`` or ``_1f1b``) at ``m``
    microbatches on ``tokens`` (the world's peak memory and each rank's
    saved bytes read around it), then, under 1F1B, the same on
    ``padded``, then each fault's (the count fault on ``padded``), then
    ``steps`` AdamW steps (the last one profiled with ``profile``).
    Returns rank 0's view: the loss, the whole gradient (each stage's
    blocks; the replicated rest, which must be bitwise the same on every
    rank), each run's, the step losses, seconds, launches and kernels by
    name, the peak, and whether the replicated parameters end bitwise
    the same on every rank."""
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn
    from horovod_tpu_torch.parallel import comm as pc
    from horovod_tpu_torch.parallel import mesh as pm
    from horovod_tpu_torch.parallel import pipeline as pl

    meshes, worlds = pm.emulated_meshes(pm.make_mesh(world=PIPE_RANKS,
                                                     pp=PIPE_RANKS))
    barrier = pc.ThreadWorld(PIPE_RANKS)
    step_fn = (pl.pipeline_lm_train_step_gpipe if schedule == "gpipe"
               else pl.pipeline_lm_train_step_1f1b)
    flash = make_flash_attention_fn(causal=True)

    def whole(every):
        """Each stage's blocks and rank 0's replicated rest, which must
        be every rank's bitwise."""
        out = {}
        for r, g in enumerate(every):
            for n, v in g.items():
                if n.startswith("block_"):
                    out[n] = v
                elif r == 0:
                    out[n] = v
                else:
                    _require(torch.equal(v, every[0][n]),
                             f"phase 4n {schedule} M={m}: rank {r}'s {n} "
                             "is not bitwise rank 0's")
        return out

    def rank_fn(rank):
        def sync(value=None):
            return barrier.exchange(rank, value)

        mesh = meshes[rank]
        model = pl.build_stage(cfg, mesh, attention_fn=flash)

        def backward(t):
            return float(step_fn(cfg, model, t, mesh, m))

        def grads():
            return whole(sync({n: p.grad for n, p in
                               model.named_parameters()}))

        out = {}
        sync()
        if rank == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out["base_bytes"] = torch.cuda.memory_allocated()
        sync()
        saved = _SavedBytes()
        with saved.hooks:
            out["loss"] = backward(tokens)
        sync()
        if rank == 0:
            torch.cuda.synchronize()
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["saved_peak_bytes"] = sync(saved.peak)
        out["grads"] = grads()
        runs = [("padded", None, padded)] if schedule == "1f1b" else []
        runs += [(f, f, padded if f == "padded_microbatch_counts_1"
                  else tokens) for f in faults]
        out["runs"] = {}
        for label, fault, t in runs:
            with _pipe_fault(fault, mesh, rank, sync):
                loss = backward(t)
            out["runs"][label] = {"loss": loss, "grads": grads()}
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                weight_decay=1e-4)
        sync()
        if rank == 0:
            torch.cuda.synchronize()
            _build.reset_launches()
        losses, secs = [], []
        with contextlib.ExitStack() as stack:
            for i in range(steps):
                sync()
                if rank == 0 and profile and i == steps - 1:
                    prof = stack.enter_context(_profiled())
                sync()
                t0 = time.perf_counter()
                losses.append(backward(tokens))
                opt.step()
                opt.zero_grad(set_to_none=True)
                sync()
                if rank == 0:
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
            sync()
        if rank == 0:
            out["launches"] = dict(_build.LAUNCHES)
            out["secs"] = secs
            if profile and steps:
                events = _kernel_events(prof)
                out["by_name"] = {k: sum(e.count for e in events
                                         if k + "_" in e.key)
                                  for k in TRAIN_KERNELS}
        out["losses"] = losses
        rest = {n: p.detach() for n, p in model.named_parameters()
                if not n.startswith("block_")}
        every = sync(rest)
        out["replicated_bitwise"] = all(
            torch.equal(every[0][n], v) for n, v in rest.items())
        sync()
        return out

    results = pc.run_ranks(worlds + [barrier], rank_fn, PIPE_RANKS)
    top = results[0]
    _require(all(r["replicated_bitwise"] for r in results),
             f"phase 4n {schedule} M={m}: a replicated parameter differs "
             "between the ranks after the steps")
    _require(all(r["losses"] == top["losses"] and r["loss"] == top["loss"]
                 for r in results),
             f"phase 4n {schedule} M={m}: the ranks' losses differ")
    del results
    return top


def _pipe_readings(top, ref_loss, ref, pad_loss, pad_ref):
    out = {"loss": top["loss"], "loss_err": abs(top["loss"] - ref_loss),
           **_mesh_grad_readings(top["grads"], ref), "runs": {}}
    for label, run in top["runs"].items():
        padded = label in ("padded", "padded_microbatch_counts_1")
        want_loss, want = (pad_loss, pad_ref) if padded else (ref_loss, ref)
        out["runs"][label] = {"loss_err": abs(run["loss"] - want_loss),
                              **_mesh_grad_readings(run["grads"], want)}
    return out


def _pipe_within(r):
    return (r["loss_err"] <= PIPE_LOSS_TOL
            and r["grad_row_rel_max"] <= PIPE_GRAD_TOL
            and r["key_bias_over_grad_norm_max"] <= PIPE_KEY_BIAS_TOL)


def _pipe_tokens(cfg, seed_offset=None):
    from horovod_tpu_torch.examples.gpt2_pretraining import synthetic_tokens

    if seed_offset is None:  # phase 4's batch
        tokens = torch.from_numpy(synthetic_tokens(
            cfg.vocab_size, 8, 1024, 0, 1)).cuda()
    else:
        tokens = torch.from_numpy(np.random.RandomState(seed_offset).randint(
            0, cfg.vocab_size, (8, 1024))).cuda()
    padded = tokens.clone()
    padded[PIPE_PADDED_ROWS, 1:] = -1
    return tokens, padded


def _moe_row_rel(got, want):
    """Each row's relative L2 error, its norm floored at 1% of the RMS
    row norm; the largest."""
    got, want = got.float(), want.float()
    rn = want.norm(dim=-1)
    floor = 1e-2 * rn.square().mean().sqrt()
    return ((got - want).norm(dim=-1)
            / torch.clamp(rn, min=floor.item())).max().item()


def _moe_ep(layer, x, cot, cf, fault=None, timed=0):
    """The EP path over ``MOE_RANKS`` ranks emulated on the card (threads,
    ``ThreadComm``), each rank its rows of ``x``: the outputs, input
    gradients of ``Σ y · cot``, aux losses, (token, k) pairs dropped and
    the wall ms of ``timed`` more forward + backward passes of the world
    (the median); with ``fault="reversed_return"`` the return all-to-all
    takes its chunks in reverse order."""
    from horovod_tpu_torch.models import moe as moe_mod
    from horovod_tpu_torch.parallel import comm as pc

    world = pc.ThreadWorld(MOE_RANKS)
    n = x.shape[0] // MOE_RANKS
    saved = moe_mod._combine
    if fault == "reversed_return":
        def reversed_return(out, comm):
            back = saved(out, comm)  # the ranks' results, in rank order
            return torch.cat(back.chunk(comm.size, 0)[::-1], 0)

        moe_mod._combine = reversed_return

    def rank_fn(r):
        ep = moe_mod.MoeMlp(**MOE_DIMS, capacity_factor=cf,
                            dtype=torch.bfloat16,
                            ep=pc.ThreadComm(world, r)).cuda()
        ep.load_state_dict(layer.state_dict())

        def fwd_bwd():
            xr = x[r * n:(r + 1) * n].detach().clone().requires_grad_()
            y, aux = ep(xr)
            (y.float() * cot[r * n:(r + 1) * n]).sum().backward()
            ep.zero_grad(set_to_none=True)
            return xr, y, aux

        xr, y, aux = fwd_bwd()
        _, idx, _, _ = ep.route(xr.detach())
        _, keep = moe_mod.bucket_positions(idx.reshape(-1), ep.num_experts,
                                           ep.capacity(n))
        ms = []
        for _ in range(timed):
            world.exchange(r, None)
            t0 = time.perf_counter()
            fwd_bwd()
            world.exchange(r, None)
            if r == 0:
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        return (y.detach(), xr.grad, aux.item(), int((~keep).sum()),
                float(np.median(ms)) if ms else None)

    try:
        res = pc.run_ranks([world], rank_fn, MOE_RANKS)
    finally:
        moe_mod._combine = saved
    return (torch.cat([r[0] for r in res]), torch.cat([r[1] for r in res]),
            [r[2] for r in res], sum(r[3] for r in res), res[0][4])


def _moe_dropped_reference(layer, x, cot, cf):
    """The drop rule's plain reference: each rank's rows through the
    dense path with the gate of every (token, k) pair past its expert's
    capacity (on that rank's tokens) zeroed; outputs and input
    gradients."""
    from horovod_tpu_torch.models import moe as moe_mod

    n = x.shape[0] // MOE_RANKS
    ys, dxs = [], []
    for r in range(MOE_RANKS):
        xr = x[r * n:(r + 1) * n].detach().clone().requires_grad_()
        _, idx, gates, _ = layer.route(xr)
        _, keep = moe_mod.bucket_positions(
            idx.reshape(-1), layer.num_experts,
            int(cf * layer.top_k * n / layer.num_experts) + 1)
        gates = gates * keep.reshape(gates.shape)
        y = layer._dense(xr, idx, gates, layer.w_in.to(torch.bfloat16),
                         layer.w_out.to(torch.bfloat16))
        (y.float() * cot[r * n:(r + 1) * n]).sum().backward()
        ys.append(y.detach())
        dxs.append(xr.grad)
    layer.zero_grad(set_to_none=True)
    return torch.cat(ys), torch.cat(dxs)


def check_moe(seed, faults=True):
    """Phase 4n (d): ``MoeMlp`` at GPT-2 medium's width with Mixtral's
    routing (``MOE_DIMS``, bf16, ``MOE_TOKENS`` tokens sharing a random
    direction, so that routing is uneven): the dense path
    against the EP path over ``MOE_RANKS`` emulated ranks at
    ``MOE_AMPLE`` (nothing drops), and the EP path at ``MOE_CAPACITY``
    against the drop rule's plain reference, outputs and input
    gradients row by row (``MOE_ROW_TOL``); a reversed return
    all-to-all must fail. Forward + backward ms of the dense path and of
    the emulated EP world."""
    from horovod_tpu_torch.models.moe import MoeMlp

    g = torch.Generator(device="cuda").manual_seed(seed)
    layer = MoeMlp(**MOE_DIMS, dtype=torch.bfloat16).cuda().init_params(g)
    h = MOE_DIMS["hidden_size"]
    # tokens that share a direction (as a layer's activations do) route
    # unevenly: at capacity factor 1.25 the favoured experts overflow
    x = (torch.randn(MOE_TOKENS, h, generator=g, device="cuda")
         + torch.randn(h, generator=g, device="cuda")).to(torch.bfloat16)
    cot = torch.randn(x.shape, generator=g, device="cuda")

    def dense():
        xd = x.detach().clone().requires_grad_()
        y, aux = layer(xd)
        (y.float() * cot).sum().backward()
        layer.zero_grad(set_to_none=True)
        return y.detach(), xd.grad, aux.item()

    y, dx, aux = dense()
    out = {"dims": MOE_DIMS, "tokens": MOE_TOKENS, "ranks": MOE_RANKS,
           "dtype": "bf16", "tol": MOE_ROW_TOL}
    ey, edx, eaux, dropped, _ = _moe_ep(layer, x, cot, MOE_AMPLE)
    out["ample"] = {"capacity_factor": MOE_AMPLE, "dropped": dropped,
                    "y_row_rel_max": _moe_row_rel(ey, y),
                    "dx_row_rel_max": _moe_row_rel(edx, dx),
                    "aux_dense": aux, "aux_ranks": eaux}
    ry, rdx = _moe_dropped_reference(layer, x, cot, MOE_CAPACITY)
    cy, cdx, _, dropped, ep_ms = _moe_ep(layer, x, cot, MOE_CAPACITY,
                                         timed=3)
    out["capacity"] = {"capacity_factor": MOE_CAPACITY, "dropped": dropped,
                       "dropped_share": dropped / (MOE_TOKENS
                                                   * MOE_DIMS["top_k"]),
                       "y_row_rel_max": _moe_row_rel(cy, ry),
                       "dx_row_rel_max": _moe_row_rel(cdx, rdx),
                       "ep_world_fwd_bwd_ms": ep_ms}
    if faults:
        fy, fdx, _, _, _ = _moe_ep(layer, x, cot, MOE_AMPLE,
                                   "reversed_return")
        out["faults"] = {"reversed_return": {
            "y_row_rel_max": _moe_row_rel(fy, y),
            "dx_row_rel_max": _moe_row_rel(fdx, dx)}}
    return layer, x, cot, out


def _moe_within(r):
    return max(r["y_row_rel_max"], r["dx_row_rel_max"]) <= MOE_ROW_TOL


def _wall_ms(fn, iters=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def pipe_sweep(n_seeds):
    """``--pipe-sweep N``: phase 4n's step-1 readings on the batches of
    seeds 0..N-1 (healthy) and of its injected faults on seed 0's, each
    case against the world-1 step; and (d)'s MoE readings for seeds
    0..N-1 with its fault on seed 0: the limits' evidence."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM

    hvd.init()
    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    for seed in range(n_seeds):
        tokens, padded = _pipe_tokens(cfg, 1000 + seed)
        ref_loss, ref = _mesh_reference(cfg, tokens)
        pad_loss, pad_ref = _mesh_reference(cfg, padded)
        for schedule, m, faults, _ in PIPE_CASES:
            top = pipe_world(cfg, tokens, padded, schedule, m,
                             faults=faults if seed == 0 else (), steps=0)
            print(json.dumps({"pipe_sweep": f"{schedule} M={m}",
                              "seed": seed, **_pipe_readings(
                                  top, ref_loss, ref, pad_loss, pad_ref)}),
                  flush=True)
            del top
            torch.cuda.empty_cache()
        del ref, pad_ref
        torch.cuda.empty_cache()
    hvd.shutdown()
    for seed in range(n_seeds):
        _, _, _, r = check_moe(seed, faults=seed == 0)
        print(json.dumps({"moe_sweep": seed, **r}), flush=True)
        torch.cuda.empty_cache()


def train_pipeline(seed, ledger, in_process_losses):
    """Phase 4n: GPT-2 medium at full width (24 x 1024, 16 heads, vocab
    50257, flash attention and fused norms, AdamW, seed 0, phase 4's 8 x
    1024 batch) pipelined over pp = 4 ranks emulated on the card
    (``pipe_world``: 6 blocks a stage):

    (a) GPipe at M = 4, its faults (a zeroed backward hop; S copies of
        the head's cotangent), 2 steps; GPipe at M = 8, step 1 only;
    (b) 1F1B at M = 4 and M = 8 (the input ring reused), the padded
        batch, its faults (a backward one slot early; a fully padded
        microbatch counted as 1), 2 steps;
    (c) the world's peak memory around each step 1 and each rank's
        bytes saved for the backward; 1F1B's at M = 8 must be below
        GPipe's;

    each held at step 1 against phase 4's world-1 step on the same
    weights and batch (the padded runs against the world-1 step on the
    padded batch: the loss and every gradient row, ``PIPE_GRAD_TOL``,
    ``PIPE_LOSS_TOL``), each fault failing the same check, the
    replicated gradients and parameters bitwise the same on every rank,
    a falling loss, exact B1-B5 launches (``_pipe_launches``, confirmed
    by kernel name in a profiled step of each trained case), step ms,
    tokens/s; and (d) ``check_moe``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    tokens, padded = _pipe_tokens(cfg)
    card = _card()
    report = {"phase": "pipeline", "card": card,
              "model": "GPT-2 medium 24x1024, 16 heads, pp=4 (6 blocks a "
                       "stage)", "batch": "8x1024", "ranks": PIPE_RANKS,
              "emulated": "threads on one card, one stream",
              "tol": {"loss": PIPE_LOSS_TOL, "grad_row_rel": PIPE_GRAD_TOL,
                      "key_bias": PIPE_KEY_BIAS_TOL}}
    hvd.init()
    ref_loss, ref = _mesh_reference(cfg, tokens)
    _require(ref_loss == in_process_losses[0],
             f"phase 4n: the world-1 step's loss {ref_loss} is not phase "
             f"4's {in_process_losses[0]}")
    pad_loss, pad_ref = _mesh_reference(cfg, padded)
    total, peaks = {}, {}
    for schedule, m, faults, steps in PIPE_CASES:
        name = f"{schedule} M={m}"
        t0 = time.perf_counter()
        top = pipe_world(cfg, tokens, padded, schedule, m, faults, steps,
                         profile=steps > 0)
        r = _pipe_readings(top, ref_loss, ref, pad_loss, pad_ref)
        per_step = _pipe_launches(schedule, m)
        r.update(losses=top["losses"],
                 peak_mem_gb_world=top["peak_bytes"] / 1e9,
                 step_mem_gb_world=(top["peak_bytes"]
                                    - top["base_bytes"]) / 1e9,
                 saved_gb_per_rank=[b / 1e9
                                    for b in top["saved_peak_bytes"]],
                 launches_per_step=per_step, case_s=time.perf_counter() - t0)
        peaks[name] = top["peak_bytes"] - top["base_bytes"]
        if steps:
            want = {k: v * steps for k, v in per_step.items()}
            got = {k: top["launches"][k] for k in want}
            step_s = float(np.median(top["secs"][1:]))
            r.update(launches=got, profiled_step_kernels=top["by_name"],
                     step_ms=step_s * 1e3,
                     step_ms_all=[x * 1e3 for x in top["secs"]],
                     tokens_per_s=8 * 1024 / step_s)
        report[name] = r
        print(json.dumps({"phase": "pipeline", "case": name, "card": card,
                          **r}), flush=True)
        del top
        torch.cuda.empty_cache()
        _require(_pipe_within(r), f"phase 4n {name}: step 1 against the "
                                  f"world-1 step reads {r}")
        for label, run in r["runs"].items():
            ok = _pipe_within(run)
            _require(ok == (label == "padded"),
                     f"phase 4n {name}: the run {label} "
                     f"{'fails' if label == 'padded' else 'passes'}: {run}")
        if steps:
            _require(got == want,
                     f"phase 4n {name}: launches {got}, not {want}")
            _require(r["profiled_step_kernels"] == per_step,
                     f"phase 4n {name}: the profiled step's kernels "
                     f"{r['profiled_step_kernels']}, not {per_step}")
            _require(all(np.isfinite(r["losses"]))
                     and r["losses"][-1] < r["losses"][0],
                     f"phase 4n {name}: losses {r['losses']}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
    _require(peaks["1f1b M=8"] < peaks["gpipe M=8"],
             f"phase 4n (c): 1F1B's step at M = 8 takes "
             f"{peaks['1f1b M=8'] / 1e9:.2f} GB, GPipe's "
             f"{peaks['gpipe M=8'] / 1e9:.2f} GB")
    del ref, pad_ref
    hvd.shutdown()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    layer, x, cot, moe = check_moe(seed)
    _require(moe["ample"]["dropped"] == 0,
             f"phase 4n (d): {moe['ample']['dropped']} pairs dropped at "
             f"capacity factor {MOE_AMPLE}")
    _require(_moe_within(moe["ample"]) and _moe_within(moe["capacity"])
             and moe["capacity"]["dropped"] > 0,
             f"phase 4n (d): {moe}")
    _require(not _moe_within(moe["faults"]["reversed_return"]),
             f"phase 4n (d): the reversed return all-to-all passes: {moe}")

    def dense_step():
        xd = x.detach().clone().requires_grad_()
        y, _ = layer(xd)
        (y.float() * cot).sum().backward()
        layer.zero_grad(set_to_none=True)

    moe["dense_fwd_bwd_ms"] = _wall_ms(dense_step)
    moe["case_s"] = time.perf_counter() - t0
    moe["card"] = card
    report["moe"] = moe
    print(json.dumps({"phase": "pipeline", "case": "moe", **moe}),
          flush=True)
    del layer, x, cot
    ledger["train_pipeline"] = total
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(report))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4o: GPT-2 medium on a live fsdp axis under a replicated optimizer
# (ZeRO-3 by the sharding rules), four ranks emulated on the card
# ---------------------------------------------------------------------------

FSDP_AXIS_RANKS = 4
FSDP_AXIS_STEPS = 2  # launches counted over both, the second timed
#: (name, mesh axes) of phase 4o's emulated worlds
FSDP_AXIS_CASES = (("fsdp=4", {"fsdp": 4}),
                   ("dp=2,fsdp=2", {"dp": 2, "fsdp": 2}),
                   ("fsdp=2,tp=2", {"fsdp": 2, "tp": 2}))
#: the faults every case's step-1 check must catch (``_FaultyFsdpComm``):
#: the shards gathered in reversed rank order; a weight-gradient shard
#: left as the rank's own partial, not reduce-scattered; a whole
#: parameter's gradient not summed over fsdp
FSDP_AXIS_FAULTS = ("gather_reversed", "scatter_left_partial",
                    "whole_grad_unsummed")
#: limits of phase 4o's step-1 check against phase 4's world-1 step on the
#: same weights and batch, read as phase 4m's (``_mesh_grad_readings``):
#: each parameter's worst gradient row and the loss (absolute); the
#: attention key biases (a true gradient of 0) against the whole
#: gradient's norm. Over 8 batch seeds the healthy worst row read 0.065
#: (fsdp = 4 and dp = 2 x fsdp = 2, the same bits) and 0.206 (fsdp = 2 x
#: tp = 2, in a key kernel, as phase 4m's tp); the least fault 1.107 (a
#: shard left as the rank's partial), the others 1.34 (a whole gradient
#: unsummed) and 6.7 up (reversed gathers) (``--fsdp-sweep 8`` on an
#: NVIDIA H100 80GB HBM3, 700 W; PERF.md): phase 4m's 0.5 sits between.
#: The loss (healthy worst 2.3e-4, faults 0 to 8.8e-5: a fault moves only
#: the gradients) and the key biases (healthy 6.0e-6) are sanity bounds
FSDP_AXIS_GRAD_TOL = MESH_GRAD_TOL
FSDP_AXIS_LOSS_TOL = 1e-3
FSDP_AXIS_KEY_BIAS_TOL = 1e-3


class _FaultyFsdpComm:
    """The fsdp communicator of one rank with one of phase 4o's faults;
    everything else is the real communicator's."""

    def __init__(self, comm, fault):
        self.comm, self.fault = comm, fault
        self.rank, self.size = comm.rank, comm.size

    def all_gather(self, t):
        parts = self.comm.all_gather(t)
        return parts[::-1] if self.fault == "gather_reversed" else parts

    def all_reduce(self, t):
        if self.fault == "whole_grad_unsummed":
            return t
        return self.comm.all_reduce(t)

    def reduce_scatter(self, t):
        if self.fault == "scatter_left_partial":
            return t.chunk(self.size)[self.rank].clone()
        return self.comm.reduce_scatter(t)


def _fsdp_axis_launches():
    """B1-B5 launches a step over the four emulated ranks: B1-B3 once a
    layer a rank (each rank its rows; under tp its heads), the 49 norms
    once a rank each. The gathers launch none of them."""
    n = FSDP_AXIS_RANKS
    return {"flash_fwd": 24 * n, "flash_bwd_dq": 24 * n,
            "flash_bwd_dkv": 24 * n, "layernorm_fwd": 49 * n,
            "layernorm_bwd": 49 * n}


def _adamw_state_bytes(opt):
    return sum(t.numel() * t.element_size() for s in opt.state.values()
               for k, t in s.items() if k != "step")


def fsdp_axis_world(cfg, tokens, axes, faults=(), steps=FSDP_AXIS_STEPS,
                    profile=False):
    """One emulated world of phase 4o: ``FSDP_AXIS_RANKS`` threads on the
    card, each rank building ``make_lm_train_step(cfg, AdamW, mesh=...)``
    on its own ``Mesh`` (``parallel.mesh.emulated_meshes``: every live
    axis over ``ThreadComm``s; the dp average through its communicator;
    every other line the real path's), taking its rows of ``tokens``.
    Each rank takes the step-1 backward, then each fault's
    (``_FaultyFsdpComm`` as the step's fsdp communicator), then
    ``steps`` AdamW steps (the last one profiled with ``profile``).
    Returns rank 0's view: the loss, every rank's gradient slices put
    back together, each fault's, the step losses, seconds, launches and
    kernels by name, the peak memory, every rank's resident parameter
    and AdamW-state bytes and its bytes gathered and reduce-scattered in
    one step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.flash_attention import \
        make_flash_attention_fn
    from horovod_tpu_torch.parallel import comm as pc
    from horovod_tpu_torch.parallel import mesh as pm
    from horovod_tpu_torch.parallel import sharding as psh

    layout = pm.make_mesh(world=FSDP_AXIS_RANKS, **axes)
    meshes, worlds = pm.emulated_meshes(layout)
    barrier = pc.ThreadWorld(FSDP_AXIS_RANKS)
    factory = functools.partial(torch.optim.AdamW, lr=1e-4,
                                weight_decay=1e-4)
    flash = make_flash_attention_fn(causal=True)

    def rank_fn(rank):
        def sync(value=None):
            return barrier.exchange(rank, value)

        mesh = meshes[rank]
        model, step = hvd.make_lm_train_step(cfg, factory, mesh=mesh,
                                             attention_fn=flash)
        rows, _ = psh.batch_slices(mesh, *tokens.shape)
        mine = tokens[rows]
        opt, fsdp = step.optimizer, step.fsdp

        def backward():
            loss = float(step.backward(mine))
            opt.synchronize()
            g = {n: p.grad for n, p in model.named_parameters()}
            every = sync(g)
            opt.zero_grad(set_to_none=True)
            if rank != 0:
                return loss, None
            # ranks that differ only in dp hold the same slices, reduced
            # to the same bits
            for r, other in enumerate(every):
                twin = dict(layout.coords_of(r), dp=0)
                _require(all(torch.equal(v, every[layout.rank_of(twin)][n])
                             for n, v in other.items()),
                         f"phase 4o {axes}: rank {r}'s gradients are not "
                         "its dp twin's bits")
            return loss, psh.unshard_params(every, step.specs, layout)

        out = {"specs": step.specs}
        out["loss"], out["full"] = backward()
        out["faults"] = {}
        real = fsdp.comm
        for name in faults:
            fsdp.comm = _FaultyFsdpComm(real, name)
            try:
                loss, full = backward()
            finally:
                fsdp.comm = real
            out["faults"][name] = {"loss": loss, "full": full}
        sync()
        if rank == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
        losses, secs, moved = [], [], []
        with contextlib.ExitStack() as stack:
            for i in range(steps):
                sync()
                if rank == 0 and profile and i == steps - 1:
                    prof = stack.enter_context(_profiled())
                sync()
                before = (fsdp.gathered_bytes, fsdp.scattered_bytes)
                t0 = time.perf_counter()
                losses.append(step(mine))
                sync()
                if rank == 0:
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                moved.append((fsdp.gathered_bytes - before[0],
                              fsdp.scattered_bytes - before[1]))
            sync()
        out["losses"] = [float(x) for x in losses]
        if rank == 0:
            torch.cuda.synchronize()
            out["launches"] = dict(_build.LAUNCHES)
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
            out["secs"] = secs
            if profile and steps:
                events = _kernel_events(prof)
                out["by_name"] = {k: sum(e.count for e in events
                                         if k + "_" in e.key)
                                  for k in TRAIN_KERNELS}
        held = sum(p.numel() for p in model.parameters())
        out["resident"] = sync({
            "param_elements": held,
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters()),
            "adamw_state_bytes": _adamw_state_bytes(opt),
            "gathered_bytes_step": moved[-1][0] if moved else 0,
            "scattered_bytes_step": moved[-1][1] if moved else 0})
        return out

    results = pc.run_ranks(worlds + [barrier], rank_fn, FSDP_AXIS_RANKS)
    top = results[0]
    _require(all(r["losses"] == top["losses"] and r["loss"] == top["loss"]
                 for r in results),
             f"phase 4o {axes}: the ranks' losses differ")
    del results
    return top


def _fsdp_axis_readings(top, ref_loss, ref):
    out = {"loss": top["loss"], "loss_err": abs(top["loss"] - ref_loss),
           **_mesh_grad_readings(top["full"], ref), "faults": {}}
    for f, run in top["faults"].items():
        out["faults"][f] = {"loss_err": abs(run["loss"] - ref_loss),
                            **_mesh_grad_readings(run["full"], ref)}
    return out


def _fsdp_axis_within(r):
    return (r["loss_err"] <= FSDP_AXIS_LOSS_TOL
            and r["grad_row_rel_max"] <= FSDP_AXIS_GRAD_TOL
            and r["key_bias_over_grad_norm_max"] <= FSDP_AXIS_KEY_BIAS_TOL)


def _fsdp_axis_reckoning(cfg, axes):
    """``(elements a rank holds, elements of the model)`` by the rules'
    pruned specs on the case's layout (``fsdp_axis.param_counts``)."""
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.parallel import fsdp_axis
    from horovod_tpu_torch.parallel import mesh as pm
    from horovod_tpu_torch.parallel import sharding as psh

    layout = pm.make_mesh(world=FSDP_AXIS_RANKS, **axes)
    with torch.device("meta"):
        shapes = {n: tuple(p.shape)
                  for n, p in Transformer(cfg).named_parameters()}
    specs = psh.make_param_shardings(
        {n: torch.empty(s, device="meta") for n, s in shapes.items()},
        layout)
    return fsdp_axis.param_counts(specs, shapes, layout)


def fsdp_sweep(n_seeds):
    """``--fsdp-sweep N``: phase 4o's step-1 readings on the batches of
    seeds 0..N-1 (healthy) and of its injected faults on seed 0's, each
    case against the world-1 step: the limits' evidence."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM

    hvd.init()
    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    for seed in range(n_seeds):
        tokens = torch.from_numpy(np.random.RandomState(1000 + seed).randint(
            0, cfg.vocab_size, (8, 1024))).cuda()
        ref_loss, ref = _mesh_reference(cfg, tokens)
        for name, axes in FSDP_AXIS_CASES:
            top = fsdp_axis_world(
                cfg, tokens, axes,
                faults=FSDP_AXIS_FAULTS if seed == 0 else (), steps=0)
            r = _fsdp_axis_readings(top, ref_loss, ref)
            print(json.dumps({"fsdp_sweep": name, "seed": seed, **r}),
                  flush=True)
            del top
            torch.cuda.empty_cache()
        del ref
    hvd.shutdown()


def train_fsdp_axis(seed, ledger, in_process_losses):
    """Phase 4o: GPT-2 medium at full width (24 x 1024, 16 heads, vocab
    50257, flash attention and fused norms, AdamW, seed 0, phase 4's 8 x
    1024 batch) through ``make_lm_train_step(mesh=...)`` with a live fsdp
    axis under the replicated optimizer (``parallel/fsdp_axis.py``: each
    rank its slices of the rules' fsdp dimensions and AdamW's state of
    them, a block's weights gathered when it runs and regathered for its
    backward, their gradients reduce-scattered), four ranks emulated on
    the card (``fsdp_axis_world``) on (a) fsdp = 4, (b) dp = 2, fsdp = 2
    and (c) fsdp = 2, tp = 2; each held at step 1 against phase 4's
    world-1 step on the same weights and batch (the loss and every
    gradient row, ``FSDP_AXIS_GRAD_TOL``), its faults failing the same
    check, then 2 steps with a falling loss, exact B1-B5 launches
    (``_fsdp_axis_launches``, confirmed by kernel name in a profiled
    step), each rank's resident parameter and AdamW-state bytes exactly
    the reckoning from the specs (beside world 1's), the bytes gathered
    and reduce-scattered a step, the peak memory, step ms and tokens/s."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.gpt2_pretraining import synthetic_tokens
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    tokens = torch.from_numpy(synthetic_tokens(
        cfg.vocab_size, 8, 1024, 0, 1)).cuda()
    card = _card()
    report = {"phase": "fsdp_axis", "card": card,
              "model": "GPT-2 medium 24x1024, 16 heads",
              "batch": "8x1024", "ranks": FSDP_AXIS_RANKS,
              "emulated": "threads on one card, one stream",
              "tol": {"loss": FSDP_AXIS_LOSS_TOL,
                      "grad_row_rel": FSDP_AXIS_GRAD_TOL,
                      "key_bias": FSDP_AXIS_KEY_BIAS_TOL}}
    hvd.init()
    ref_loss, ref = _mesh_reference(cfg, tokens)
    _require(ref_loss == in_process_losses[0],
             f"phase 4o: the world-1 step's loss {ref_loss} is not phase "
             f"4's {in_process_losses[0]}")
    total = {}
    per_step = _fsdp_axis_launches()
    for name, axes in FSDP_AXIS_CASES:
        t0 = time.perf_counter()
        top = fsdp_axis_world(cfg, tokens, axes, FSDP_AXIS_FAULTS,
                              profile=True)
        r = _fsdp_axis_readings(top, ref_loss, ref)
        held, whole = _fsdp_axis_reckoning(cfg, axes)
        want = {k: v * FSDP_AXIS_STEPS for k, v in per_step.items()}
        got = {k: top["launches"][k] for k in want}
        step_s = float(np.median(top["secs"][1:]))
        resident = top["resident"]
        r.update(losses=top["losses"], launches=got,
                 launches_per_step=per_step,
                 profiled_step_kernels=top["by_name"],
                 param_elements_rank=held, param_elements_world1=whole,
                 share_of_world1=held / whole,
                 resident_gb_rank=[(x["param_bytes"]
                                    + x["adamw_state_bytes"]) / 1e9
                                   for x in resident],
                 resident_gb_world1=12 * whole / 1e9,
                 gathered_gb_rank_step=[x["gathered_bytes_step"] / 1e9
                                        for x in resident],
                 reduce_scattered_gb_rank_step=[
                     x["scattered_bytes_step"] / 1e9 for x in resident],
                 step_ms=step_s * 1e3,
                 step_ms_all=[x * 1e3 for x in top["secs"]],
                 tokens_per_s=8 * 1024 / step_s,
                 peak_mem_gb_world=top["peak_bytes"] / 1e9,
                 peak_mem_gb_per_rank=top["peak_bytes"] / 1e9
                 / FSDP_AXIS_RANKS,
                 case_s=time.perf_counter() - t0)
        report[name] = r
        print(json.dumps({"phase": "fsdp_axis", "case": name, "card": card,
                          **r}), flush=True)
        del top
        torch.cuda.empty_cache()
        _require(_fsdp_axis_within(r),
                 f"phase 4o {name}: step 1 against the world-1 step reads "
                 f"{r}")
        for f, fr in r["faults"].items():
            _require(not _fsdp_axis_within(fr),
                     f"phase 4o {name}: the fault {f} passes: {fr}")
        _require(got == want, f"phase 4o {name}: launches {got}, not {want}")
        _require(r["profiled_step_kernels"] == per_step,
                 f"phase 4o {name}: the profiled step's kernels "
                 f"{r['profiled_step_kernels']}, not {per_step}")
        _require(all(np.isfinite(r["losses"]))
                 and r["losses"][-1] < r["losses"][0],
                 f"phase 4o {name}: losses {r['losses']}")
        _require(all(x["param_elements"] == held
                     and x["adamw_state_bytes"] == 8 * held
                     and x["param_bytes"] == 4 * held for x in resident),
                 f"phase 4o {name}: resident {resident}, not {held} "
                 "elements a rank by the specs")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    del ref
    hvd.shutdown()
    ledger["train_fsdp_axis"] = total
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(report))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4q: init straight into the shards
# ---------------------------------------------------------------------------

#: what the Llama-2 reading may hold beyond its reckoning and one whole
#: parameter. The build's reckoning is 4 B an element held, the step's
#: 12 B (the parameters and AdamW's two moments); beyond them the step
#: holds the zero gradients' buffer and AdamW's two temporaries of one
#: parameter (131 MB each at most), and both hold the caching
#: allocator's rounding: it maps fresh memory in 2 MiB steps and does
#: not split off a remainder of 1 MiB or less, so a fresh tensor of an
#: odd number of MiB (a 45,088,768 B shard of w1, w2 or w3, a
#: 131,072,000 B one of tok_emb or lm_head) counts 1 MiB more: on an
#: H100 80GB HBM3 at 700 W, 196 MiB over the moments and 43 MiB over
#: the parameters (``rounding_bytes``: each block's size less the size
#: asked for, from ``torch.cuda.memory_snapshot()``)
INIT_SLACK_BYTES = 256 << 20


def _whole_gpt2(cfg):
    """GPT-2 medium whole on the card from seed 0, the path every build
    took before it drew into the shards: the reference."""
    from horovod_tpu_torch.models.transformer import Transformer

    with torch.device("cuda"):
        model = Transformer(cfg)
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    return {n: p.detach() for n, p in model.named_parameters()}


def _init_parity(cfg):
    """(a): each rank of fsdp = 4 and tp = 4 (``build_sharded``, an
    unbound mesh of the rank's coordinates), each stage of pp = 4
    (``build_stage``) and each rank of the ``FullyShardedOptimizer`` at
    world 4 (``bind(materialize=)``) against the whole build: its
    slices, blocks and rows bitwise. Returns the counts compared."""
    from horovod_tpu_torch.optim.compression import Compression
    from horovod_tpu_torch.optim.fsdp import FullyShardedOptimizer
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.parallel import mesh as pm
    from horovod_tpu_torch.parallel import pipeline as pl
    from horovod_tpu_torch.parallel import sharding as psh
    from horovod_tpu_torch.parallel.train import build_sharded

    t0 = time.perf_counter()
    whole = _whole_gpt2(cfg)
    out = {"whole_s": time.perf_counter() - t0}
    for name, axes in (("fsdp4", dict(fsdp=4)), ("tp4", dict(tp=4))):
        t0 = time.perf_counter()
        split = 0
        for r in range(4):
            mesh = pm.make_mesh(world=4, rank=r, **axes)
            model, specs = build_sharded(cfg, mesh, "cuda")
            for n, p in model.named_parameters():
                want = psh.local_slice(whole[n], specs[n], mesh)
                _require(p.shape == want.shape and torch.equal(p, want),
                         f"phase 4q {name} rank {r}: {n} is not the whole "
                         "build's slice")
                split += p.shape != whole[n].shape
            del model
        out[name] = {"ranks": 4, "split_params": split,
                     "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    blocks = 0
    for s in range(4):
        stage = pl.build_stage(cfg, pm.make_mesh(world=4, rank=s, pp=4),
                               device="cuda")
        got = dict(stage.named_parameters())
        held = {n.split(".")[0] for n in got if n.startswith("block_")}
        _require(held == {f"block_{i}" for i in stage.layers},
                 f"phase 4q pp stage {s} holds {sorted(held)}")
        _require(all(torch.equal(p, whole[n]) for n, p in got.items()),
                 f"phase 4q pp stage {s}: not the whole build's weights")
        blocks += len(held)
        del stage, got
    out["pp4_1f1b_stages"] = {"stages": 4, "blocks": blocks,
                              "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    with torch.device("meta"):
        meta = Transformer(cfg)
    factory = functools.partial(torch.optim.AdamW, lr=1e-4)
    rows = 0
    for r in range(4):
        fso = FullyShardedOptimizer(factory, world=4, rank=r,
                                    compression=Compression.none)
        gen = torch.Generator(device="cuda").manual_seed(0)
        drawn = fso.bind(meta.named_parameters(), materialize=lambda sink:
                         meta.init_params(gen, sink=sink)).shards
        today = fso.bind(list(whole.items())).shards
        _require(len(drawn) == len(today) and all(
            torch.equal(a, b) for a, b in zip(drawn, today)),
            f"phase 4q FSDP rank {r}: the drawn rows are not bind's")
        rows += len(drawn)
        del drawn, today
    out["fsdp_optimizer_world4"] = {"ranks": 4, "bucket_rows": rows,
                                    "seconds": time.perf_counter() - t0}
    del whole
    torch.cuda.empty_cache()
    return out


def _llama_rank0():
    """(b): rank 0 of an fsdp = 4 mesh builds Llama-2 7B at full width
    and depth (32 layers, float32) on the card, then takes AdamW's step
    on zero gradients at lr 0, which makes the moments and must leave
    every parameter bitwise as it was. The zero gradients are views of
    one buffer of the largest local parameter (AdamW reads them only),
    and the step runs AdamW's for-loop form (no full-size temporaries):
    the moments are what is measured. Peak device memory of each, from
    a reset after ``empty_cache``, above what was allocated before (and,
    for the step, above the copy of the parameters it is checked
    against), against its reckoning (``param_counts`` x 4 bytes for the
    build, the parameters; x 12 for the step, the parameters and two
    moments) plus the largest parameter plus ``INIT_SLACK_BYTES``. The
    step's peak is also taken apart: what the build left resident, the
    moments' blocks and three blocks of the largest local parameter
    (the zero buffer and AdamW's two temporaries), with the allocator's
    rounding of the parameters and moments read from its snapshot."""
    from horovod_tpu_torch.models.transformer import LLAMA2_7B, Transformer
    from horovod_tpu_torch.parallel import fsdp_axis
    from horovod_tpu_torch.parallel import mesh as pm
    from horovod_tpu_torch.parallel.train import build_sharded

    mesh = pm.make_mesh(world=4, rank=0, fsdp=4)
    with torch.device("meta"):
        shapes = {n: tuple(p.shape)
                  for n, p in Transformer(LLAMA2_7B).named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, specs = build_sharded(LLAMA2_7B, mesh, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak_build = torch.cuda.max_memory_allocated() - base
    resident = torch.cuda.memory_allocated() - base
    held, whole = fsdp_axis.param_counts(specs, shapes, mesh)
    params = list(model.parameters())
    _require(sum(p.numel() for p in params) == held,
             f"phase 4q Llama: {sum(p.numel() for p in params)} elements, "
             f"not the reckoning's {held}")
    zeros = torch.zeros(max(p.numel() for p in params), device="cuda")
    for p in params:
        p.grad = zeros[:p.numel()].view_as(p)
    opt = torch.optim.AdamW(params, lr=0.0, foreach=False, fused=False)
    # the parameters' bits before the step, on the card: their bytes are
    # taken out of the step's reading
    copied = torch.cuda.memory_allocated()
    before = [p.detach().clone() for p in params]
    torch.cuda.synchronize()
    copied = torch.cuda.memory_allocated() - copied
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak_step = torch.cuda.max_memory_allocated() - base - copied
    moments = [t for s in opt.state.values() for k, t in s.items()
               if k != "step"]
    state = sum(t.numel() * t.element_size() for t in moments)
    unchanged = all(torch.equal(p, b) for p, b in zip(params, before))
    blocks = {b["address"]: b for seg in torch.cuda.memory_snapshot()
              for b in seg["blocks"] if b["state"] == "active_allocated"}

    def block(t):
        return blocks[t.untyped_storage().data_ptr()]

    rounding = {what: sum(block(t)["size"] - block(t)["requested_size"]
                          for t in ts)
                for what, ts in (("params", params), ("moments", moments))}
    explained = (resident + sum(block(t)["size"] for t in moments)
                 + 3 * block(zeros)["size"])
    largest = 4 * max(math.prod(s) for s in shapes.values())
    reckoning = 12 * held
    limit = reckoning + largest + INIT_SLACK_BYTES
    build_limit = 4 * held + largest + INIT_SLACK_BYTES
    out = {"layers": LLAMA2_7B.num_layers,
           "hidden": LLAMA2_7B.hidden_size, "dtype": "float32",
           "mesh": "fsdp=4, rank 0 (unbound)",
           "elements_rank": held, "elements_whole": whole,
           "reckoning_bytes": reckoning, "whole_bytes": 12 * whole,
           "largest_param_bytes": largest,
           "slack_bytes": INIT_SLACK_BYTES, "limit_bytes": limit,
           "build_limit_bytes": build_limit,
           "allocated_before_bytes": base, "copy_bytes": copied,
           "peak_build_bytes": peak_build, "resident_bytes": resident,
           "peak_step_bytes": peak_step, "rounding_bytes": rounding,
           "explained_step_bytes": explained,
           "adamw_state_bytes": state, "build_s": build_s,
           "step_s": step_s, "params_unchanged": unchanged}
    del model, params, before, zeros, opt
    torch.cuda.empty_cache()
    _require(state == 8 * held,
             f"phase 4q Llama: AdamW's moments {state} B, not 8 x {held}")
    _require(unchanged, "phase 4q Llama: the lr-0 step changed a parameter")
    _require(peak_build <= build_limit,
             f"phase 4q Llama: build's peak {peak_build} B over "
             f"{build_limit} B ({out})")
    _require(peak_step <= limit,
             f"phase 4q Llama: step's peak {peak_step} B over {limit} B "
             f"({out})")
    return out


def _surface_world1():
    """(c): ``distributed_value_and_grad`` and the ``_op`` queries at
    world 1 over NCCL: the gradient bitwise the local one (the mean over
    one rank), the queries int32 on the card."""
    import horovod_tpu_torch as hvd

    w = torch.linspace(-1.0, 1.0, 1024, device="cuda")
    x = torch.linspace(0.5, 2.0, 1024, device="cuda")

    def loss_fn(w, x):
        return torch.sum(torch.tanh(w * x) ** 2)

    t0 = time.perf_counter()
    loss, grad = hvd.distributed_value_and_grad(loss_fn)(w, x)
    wl = w.clone().requires_grad_()
    want = torch.autograd.grad(loss_fn(wl, x), wl)[0]
    ops = {"rank": hvd.rank_op(), "size": hvd.size_op(),
           "local_rank": hvd.local_rank_op(),
           "local_size": hvd.local_size_op(),
           "included": hvd.process_set_included_op()}
    torch.cuda.synchronize()
    out = {"grad_bitwise": torch.equal(grad, want),
           "ops": {k: int(v) for k, v in ops.items()},
           "ops_int32_cuda": all(v.dtype == torch.int32
                                 and v.device.type == "cuda"
                                 for v in ops.values()),
           "is_homogeneous": hvd.is_homogeneous(),
           "seconds": time.perf_counter() - t0}
    _require(out["grad_bitwise"] and out["ops_int32_cuda"]
             and out["ops"] == {"rank": 0, "size": 1, "local_rank": 0,
                                "local_size": 1, "included": 1},
             f"phase 4q: value_and_grad and the queries at world 1: {out}")
    return out


def check_init_shards():
    """Phase 4q: the build straight into the shards. (a) GPT-2 medium's
    slices on fsdp = 4 and tp = 4, stages of pp = 4 and FSDP rows at
    world 4, each rank bitwise the whole build's; (b) rank 0 of Llama-2
    7B on fsdp = 4 built on the card with AdamW's state, its peak
    against the reckoning; (c) the public surface's value-and-grad and
    queries at world 1."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM

    card = _card()
    t0 = time.perf_counter()
    hvd.init()
    init_s = time.perf_counter() - t0
    parity = _init_parity(GPT2_MEDIUM)
    parity_s = time.perf_counter() - t0 - init_s
    t0 = time.perf_counter()
    llama = _llama_rank0()
    llama_s = time.perf_counter() - t0
    surface = _surface_world1()
    hvd.shutdown()
    report = {"phase": "init_shards", "card": card, "init_s": init_s,
              "gpt2_medium_bitwise": parity, "parity_s": parity_s,
              "llama2_7b_rank0_fsdp4": llama, "llama_s": llama_s,
              "surface_world1": surface}
    print(json.dumps(report), flush=True)
    return report


# ---------------------------------------------------------------------------
# phase 4p: GPT-2 medium trained with every telemetry knob on, then off
# ---------------------------------------------------------------------------

OBSERVE_STEPS = 6  # 1 warm-up + 5, each inside hvd.metrics.step()
#: a step record's host time against the smoke's clock around the same
#: block after a sync (the loss is read inside the step, so the block
#: ends with the device's work)
OBSERVE_TIME_TOL = 0.05
#: the knobs of phase 4p's first run (their values under a temporary
#: directory); the second run sets every one of them off
OBSERVE_KNOBS = ("HOROVOD_METRICS", "HOROVOD_TPU_METRICS_FILE",
                 "HOROVOD_TIMELINE", "HOROVOD_TIMELINE_MARK_CYCLES",
                 "HOROVOD_FLIGHT_RECORDER", "HOROVOD_FLIGHT_DIR")


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: ``(result,
    text)``."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


class _TelemetryClock:
    """The host seconds spent inside the telemetry calls of a training
    step, measured by wrapping them: ``StepStats.begin_step`` and
    ``end_step`` (the JSONL line, the step series), every
    ``metrics.record_*``, the collectives' ``_count``, the fusion plan's
    ``_record_plan``, the timeline's spans, instants and cycle marks and
    ``flight.record``. A call made inside another wrapped call counts
    once, in the outer; the wrapper's own two clock reads count with
    it. ``seconds`` and ``calls`` are by name."""

    def __init__(self):
        import threading

        self.seconds, self.calls, self._saved = {}, {}, []
        self._depth = threading.local()

    def _wrap(self, owner, attr, label):
        fn = getattr(owner, attr)
        clock = self

        def timed(*args, **kwargs):
            depth = getattr(clock._depth, "n", 0)
            clock._depth.n = depth + 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                clock._depth.n = depth
                if depth == 0:
                    clock.seconds[label] = clock.seconds.get(label, 0.0) + (
                        time.perf_counter() - t0)
                    clock.calls[label] = clock.calls.get(label, 0) + 1

        self._saved.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def __enter__(self):
        from horovod_tpu_torch.ops import collectives, fusion
        from horovod_tpu_torch.utils import flight, metrics, timeline

        for attr in ("begin_step", "end_step"):
            self._wrap(metrics.StepStats, attr, f"StepStats.{attr}")
        for attr in sorted(vars(metrics)):
            if attr.startswith("record_"):
                self._wrap(metrics, attr, f"metrics.{attr}")
        self._wrap(collectives, "_count", "collectives._count")
        self._wrap(fusion, "_record_plan", "fusion._record_plan")
        for attr in ("activity_start", "activity_end", "instant",
                     "mark_cycle_start"):
            self._wrap(timeline.Timeline, attr, f"Timeline.{attr}")
        self._wrap(flight, "record", "flight.record")
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def total(self):
        return sum(self.seconds.values())


def _observed_step(cfg, knobs):
    """``init()`` under ``knobs`` (set in the environment for it and
    restored after, in a ``finally``) and phase 4p's step: the step of
    ``make_lm_train_step`` (AdamW under the DistributedOptimizer, flash
    attention, fused norms, seed 0's weights), launch counts zeroed.
    Returns ``(model, step)``, still initialized."""
    import functools

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.flash_attention import make_flash_attention_fn

    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        hvd.init()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _build.reset_launches()
    return hvd.make_lm_train_step(
        cfg, functools.partial(torch.optim.AdamW, lr=1e-4,
                               weight_decay=1e-4),
        attention_fn=make_flash_attention_fn(causal=True))


def _observed_run(cfg, tokens, knobs):
    """One run of phase 4p under ``knobs`` (``_observed_step``):
    ``OBSERVE_STEPS`` steps on ``tokens``, each inside
    ``hvd.metrics.step()`` with its loss read inside it, timed around the
    block after a sync. Returns the run's readings and, still
    initialized, the model and step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build

    model, step = _observed_step(cfg, knobs)
    losses, host_s, tele_s = [], [], []
    with _TelemetryClock() as clock:
        for _ in range(OBSERVE_STEPS):
            torch.cuda.synchronize()
            before = clock.total()
            t0 = time.perf_counter()
            with hvd.metrics.step():
                losses.append(step(tokens).item())
            host_s.append(time.perf_counter() - t0)
            tele_s.append(clock.total() - before)
    launches = dict(_build.LAUNCHES)
    _exact_launches(launches, OBSERVE_STEPS, "phase 4p")
    return {"losses": losses, "host_s": host_s, "launches": launches,
            "step_ms": float(np.median(host_s[1:])) * 1e3,
            "telemetry_s": tele_s, "telemetry_by_call": {
                k: {"calls": clock.calls[k], "s": clock.seconds[k]}
                for k in sorted(clock.seconds)}}, model, step


#: phase 4p (f): the sampled profiler's knobs (a sample every 2 steps,
#: no duty floor between them), the step's kernels a sample must hold by
#: name (B1-B5, exactly as ``STEP_LAUNCHES``), the largest gap of a
#: sampled step's device ms from ``_profiled``'s reading of the nearest
#: unsampled step, of ``hvd_mfu`` from 6 N D over the step's host clock
#: and the card's 989e12 FLOP/s, and of the attribution's parts' sum
#: from 1; then a sample at the default duty cycle, whose floor must hold
#: off the next step's
PROF_KNOBS = {"HOROVOD_PROF_EVERY": "2", "HOROVOD_PROF_DUTY_CYCLE": "1.0"}
PROF_KERNEL_NAMES = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq",
                     "flash_bwd_dkv": "flash_bwd_dkv",
                     "layernorm_fwd": "layernorm_fwd",
                     "layernorm_bwd": "layernorm_bwd"}
PROF_DEVICE_TOL = 0.05
PROF_MFU_TOL = 0.01
PROF_ATTR_TOL = 1e-6
PROF_BUDGET_DUTY = 0.02
#: phase 4p (g): the health monitor on, its detectors and one step-time
#: envelope (``HOROVOD_HEALTH_RULES``, twice the rolling median: a host's
#: hiccup of up to 2x fires nothing) warm after 3 steps, no periodic
#: publish (its last one at shutdown); step 5 slowed by a spin of
#: ``HEALTH_SLOW_STEPS`` times the median of steps 1-4 (the envelope's
#: own reference) at the card's 1.98 GHz boost clock (longer at a lower
#: clock), so it takes about 3x the reference
HEALTH_KNOBS = {
    "HOROVOD_HEALTH": "1", "HOROVOD_HEALTH_MIN_STEPS": "3",
    "HOROVOD_HEALTH_INTERVAL_S": "3600",
    "HOROVOD_HEALTH_RULES": "step_time_envelope:envelope:signal=step_time"
                            ":factor=2:min=3:breach=1:clear=2"}
HEALTH_SLOW_STEP = 5
HEALTH_SLOW_STEPS = 2.0
CARD_BOOST_HZ = 1.98e9
#: the environment prefixes no phase may leave set
PART2_KNOB_PREFIXES = ("HOROVOD_PROF_", "HOROVOD_HEALTH", "HVD_TPU_PROF_",
                       "HVD_TPU_HEALTH")


def _sample_readings(sample_dir):
    """One profiler sample's directory: its sidecar, the card's spans
    without the profiler's spins, each B1-B5 kernel's count by name, and
    their device ms (the spans' summed durations)."""
    from horovod_tpu_torch.utils import kineto, prof

    with open(os.path.join(sample_dir, "hvd_prof_meta.json")) as f:
        meta = json.load(f)
    trace, _ = kineto.load_trace(os.path.join(sample_dir, prof.TRACE_FILE))
    ops = kineto.op_events(trace, skip=(prof.SPIN_KERNEL,))
    counts = {k: sum(name in o["name"] for o in ops)
              for k, name in PROF_KERNEL_NAMES.items()}
    return meta, ops, counts, sum(o["dur_us"] for o in ops) / 1e3


def _sampled_run(cfg, tokens, root):
    """Phase 4p (f): ``PROF_KNOBS`` and metrics on, 6 N D declared with
    ``hvd.prof.set_step_flops``; 1 + 5 steps inside
    ``hvd.metrics.step()``, the prof-unsampled steps 3 and 5 inside a
    ``_profiled`` window, each step's body (the step and its loss read)
    timed on the host's clock inside the block; every wait on the parse
    thread ``prof.join``. Then a duty cycle of ``PROF_BUDGET_DUTY`` and
    every step sampled: step 7 is, and its cost T's floor of T (1/d - 1)
    must hold off step 8's. Returns the readings."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.utils import metrics, prof

    jsonl = os.path.join(root, "steps_prof.jsonl")
    model, step = _observed_step(cfg, {
        **PROF_KNOBS, "HOROVOD_PROF_DIR": os.path.join(root, "prof"),
        "HOROVOD_METRICS": "1", "HOROVOD_TPU_METRICS_FILE": jsonl})
    n_params = sum(p.numel() for p in model.parameters())
    flops = 6.0 * n_params * tokens.numel()
    hvd.prof.set_step_flops(flops, n_chips=1)
    losses, body_s, profiled_ms, launches = [], [], {}, {}
    for i in range(1, OBSERVE_STEPS + 1):
        torch.cuda.synchronize()
        window = _profiled() if i in (3, 5) else contextlib.nullcontext()
        with window as p:
            with hvd.metrics.step():
                t0 = time.perf_counter()
                losses.append(step(tokens).item())
                body_s.append(time.perf_counter() - t0)
        if p is not None:
            profiled_ms[i] = sum(_dev_us(e) for e in _kernel_events(p)) / 1e3
        prof.join(30.0)
    launches = dict(_build.LAUNCHES)
    summary = prof.summary()
    gauge = metrics.registry.snapshot()["hvd_mfu"][""]
    # the budget at the default duty cycle
    prof.configure(every=1, duty_cycle=PROF_BUDGET_DUTY,
                   directory=os.path.join(root, "prof_budget"))
    before = prof.overhead_s()
    budget = []
    for _ in range(2):
        with hvd.metrics.step():
            step(tokens).item()
        t_body_end = time.perf_counter()
        prof.join(30.0)
        budget.append((prof.sample_count(), prof.overhead_s() - before,
                       prof._next_ok_t - time.monotonic(),
                       time.perf_counter() - t_body_end))
    del model, step
    hvd.shutdown()
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    return {"losses": losses, "body_s": body_s, "profiled_ms": profiled_ms,
            "launches": launches, "summary": summary, "gauge": gauge,
            "flops": flops, "n_params": n_params, "records": recs,
            "budget": budget}


def _check_sampled(run, root, off_losses):
    """Phase 4p (f)'s checks on ``_sampled_run``'s readings; the
    report's part."""
    samples = sorted(d for d in os.listdir(os.path.join(root, "prof",
                                                        "rank0")))
    s = run["summary"]
    _require(samples == ["step2", "step4", "step6"]
             and s["samples"] == 3 and s["errors"] == 0,
             f"phase 4p (f): samples {samples}, summary {s}")
    _require(run["losses"] == off_losses,
             f"phase 4p (f): losses {run['losses']} with the profiler, "
             f"{off_losses} without")
    _exact_launches(run["launches"], OBSERVE_STEPS, "phase 4p (f)")
    readings = {}
    for name in samples:
        i = int(name[4:])
        meta, ops, counts, device_ms = _sample_readings(
            os.path.join(root, "prof", "rank0", name))
        want = {k: STEP_LAUNCHES[k] for k in PROF_KERNEL_NAMES}
        _require(meta["step"] == i and counts == want,
                 f"phase 4p (f): sample {name}'s kernels {counts}, not "
                 f"{want} (a window that lost records)")
        ref = run["profiled_ms"][min((3, 5), key=lambda j: abs(j - i))]
        _require(abs(device_ms / ref - 1) <= PROF_DEVICE_TOL,
                 f"phase 4p (f): sample {name}'s {device_ms} device ms, "
                 f"_profiled's {ref}")
        readings[name] = {"device_ms": device_ms, "profiled_ms": ref,
                          "kernels": len(ops), "sidecar": meta}
    # the last sample's attribution: the gauges' and the record's
    attr = run["summary"]["attribution"]
    parts = (attr["compute_us"] + attr["exposed_collective_us"]
             + attr["idle_us"] + attr.get("host_gap_us", 0.0))
    whole = max(attr.get("host_wall_us", 0.0), attr["device_wall_us"])
    _require(attr["sampled_step"] == 6 and attr["compute_frac"] > 0
             and abs(parts / whole - 1) <= PROF_ATTR_TOL,
             f"phase 4p (f): attribution {attr}")
    # hvd_mfu a step against 6 N D over the body's host clock
    mfu_off = []
    for rec, body in zip(run["records"], run["body_s"]):
        want = run["flops"] / (body * PEAK_OPS["bf16"])
        mfu_off.append(rec["mfu"] / want - 1)
    _require(max(map(abs, mfu_off)) <= PROF_MFU_TOL
             and run["gauge"] == run["records"][OBSERVE_STEPS - 1]["mfu"],
             f"phase 4p (f): hvd_mfu off 6ND/(step x 989e12) by {mfu_off}")
    # the budget: step 7 sampled at d = 0.02; its cost T holds step 8 off
    (n7, t7, left7, since7), (n8, _, left8, since8) = run["budget"]
    floor = t7 * (1 / PROF_BUDGET_DUTY - 1)
    _require(n7 == 4 and n8 == 4 and left8 >= floor - since8 - since7
             - 1.0,
             f"phase 4p (f): the duty budget {run['budget']}: floor "
             f"{floor} s")
    return {"samples": readings, "attribution": attr,
            "mfu": run["gauge"], "mfu_rel_off": mfu_off,
            "overhead_s": s["overhead_s"],
            "overhead_per_sample_s": s["overhead_s"] / 3,
            "budget_sample_s": t7, "budget_floor_s": floor,
            "budget_left_s": left8, "n_params": run["n_params"],
            "step_ms": [x * 1e3 for x in run["body_s"]]}


def _health_run(cfg, tokens, root, off_losses):
    """Phase 4p (g): ``HEALTH_KNOBS`` on, its summaries published to a
    ``RendezvousServer`` in this process and its incidents to a JSONL;
    1 + 5 steps, step ``HEALTH_SLOW_STEP`` slowed by a spin of
    ``HEALTH_SLOW_STEPS`` steps inside its block: the step-time envelope
    fires, the incident log holds the transition, the alert's forced
    profiler sample captures the next step (the profiler is otherwise
    off), and after shutdown (whose
    last tick publishes) ``GET /health`` on the store names rank 0.
    Returns the report's part."""
    import urllib.request

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runner.http.http_server import RendezvousServer
    from horovod_tpu_torch.utils import prof

    incidents = os.path.join(root, "incidents.jsonl")
    rdv = RendezvousServer()
    port = rdv.start_server()
    try:
        model, step = _observed_step(cfg, {
            **HEALTH_KNOBS, "HOROVOD_HEALTH_INCIDENT_FILE": incidents,
            "HOROVOD_PROF_DIR": os.path.join(root, "prof_health"),
            "HOROVOD_FLIGHT_DIR": os.path.join(root, "flight_health"),
            "HVD_TPU_RENDEZVOUS_ADDR": "127.0.0.1",
            "HVD_TPU_RENDEZVOUS_PORT": str(port)})
        losses, verdicts, host_s = [], [], []
        for i in range(1, OBSERVE_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with hvd.metrics.step():
                if i == HEALTH_SLOW_STEP:
                    torch.cuda._sleep(int(HEALTH_SLOW_STEPS * CARD_BOOST_HZ
                                          * np.median(host_s)))
                losses.append(step(tokens).item())
            host_s.append(time.perf_counter() - t0)
            verdicts.append(hvd.health.verdict())
            prof.join(30.0)
        forced = prof.summary()
        del model, step
        hvd.shutdown()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=10) as r:
            fleet = json.loads(r.read())
    finally:
        rdv.shutdown_server()
    with open(incidents) as f:
        recs = [json.loads(line) for line in f]
    _require(losses == off_losses,
             f"phase 4p (g): losses {losses} with health, {off_losses} "
             "without")
    _require([v["health"] for v in verdicts] == ["ok"] * (
        HEALTH_SLOW_STEP - 1) + ["degraded"] * (
        OBSERVE_STEPS - HEALTH_SLOW_STEP + 1),
             f"phase 4p (g): verdicts {verdicts}, steps {host_s}")
    _require([(r["rule"], r["state"], r["rank"]) for r in recs]
             == [("step_time_envelope", "fire", 0)],
             f"phase 4p (g): incidents {recs}")
    # the profiler was off: the alert armed it for the one next step,
    # the only step it counted, and disarmed it after
    _require(forced["samples"] == 1 and forced["errors"] == 0
             and forced["steps"] == OBSERVE_STEPS - HEALTH_SLOW_STEP
             and not forced["active"],
             f"phase 4p (g): the alert's capture {forced}")
    _require(fleet["status"] == "degraded"
             and fleet["suspected_straggler_ranks"] == [0]
             and fleet["by_rank"]["0"]["alerts_active"]
             == ["step_time_envelope"],
             f"phase 4p (g): GET /health on the store: {fleet}")
    return {"step_ms": [x * 1e3 for x in host_s], "incident": recs[0],
            "forced_sample": forced["attribution"],
            "store_verdict": {k: fleet[k] for k in (
                "status", "ranks", "suspected_straggler_ranks")}}


def _observed_part2(cfg, tokens, root, off_losses):
    """Phase 4p (f) and (g), the sampled profiler and the health monitor
    (``_sampled_run``, ``_health_run``), each from the profiler's reset
    state; every knob they set is restored, and none is left in the
    environment. Returns the report's part and its seconds."""
    from horovod_tpu_torch.utils import prof

    t0 = time.perf_counter()
    out = {"prof": _check_sampled(_sampled_run(cfg, tokens, root), root,
                                  off_losses)}
    prof.reset()  # its counters and declared FLOPs outlive a shutdown
    _free_cuda()
    out["health"] = _health_run(cfg, tokens, root, off_losses)
    prof.reset()
    _free_cuda()
    left = sorted(k for k in os.environ
                  if k.startswith(PART2_KNOB_PREFIXES))
    _require(not left, f"phase 4p: knobs left set: {left}")
    return out, time.perf_counter() - t0


def _free_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _balanced(events):
    """Whether every B of a (tid, name) has its E after it, nested."""
    open_ = {}
    for e in events:
        key = (e["tid"], e["name"])
        if e["ph"] == "B":
            open_[key] = open_.get(key, 0) + 1
        elif e["ph"] == "E":
            if not open_.get(key):
                return False
            open_[key] -= 1
    return not any(open_.values())


def train_observed(seed, ledger, in_process_losses):
    """Phase 4p: GPT-2 medium at full width (24 x 1024, vocab 50257,
    bf16, flash attention and fused norms, AdamW under the
    DistributedOptimizer, seed 0, phase 4's 8 x 1024 batch) at world 1
    over NCCL, 1 warm-up + 5 steps each inside ``hvd.metrics.step()``,
    first with ``HOROVOD_METRICS=1``, ``HOROVOD_TPU_METRICS_FILE``,
    ``HOROVOD_TIMELINE`` (``..._MARK_CYCLES=1``) and the flight recorder
    into a temporary directory, then with every knob off, on the same
    weights and batches:

    (a) the losses bitwise the telemetry-off run's (and phase 4's), B1-B5
        exactly 24/24/24/49/49 a step in both runs;
    (b) the JSONL one record a step, numbered 1-6, each ``step_time_s``
        within ``OBSERVE_TIME_TOL`` of the smoke's clock around the same
        block; record 1 the fusion plan's fields as the JAX package's
        ``record_fusion_plan`` gives them for this plan and the
        broadcasts of the weights, every record its loss's all-reduce
        and no gradient bytes (a world of one reduces none, as in the
        JAX package); ``tools.metrics_summary --check`` passes;
    (c) ``hvd.metrics.scrape()`` lints clean and its step histogram
        counts 6;
    (d) after ``stop_timeline()`` the file parses as Chrome JSON, opens
        with ``CLOCK_ANCHOR``, its B/E pairs balance, it holds one
        ``XLA_COLLECTIVE`` span a broadcast weight and one
        ``FUSION_PLAN`` instant naming the plan's bucket count;
    (e) ``flight.dump("manual")`` and a SIGUSR2 dump to this process
        each parse with ``parse_dump``, and ``tools.trace_merge`` merges
        the timeline and the dump into one trace counting both sources;
    (f), (g) the sampled profiler and the health monitor
        (``_observed_part2``), whose seconds this returns.

    Prints the median step ms with telemetry on and off, the host
    milliseconds a step spent inside the telemetry calls in each run
    (``_TelemetryClock``), the JSONL's, the exposition's and the dump's
    bytes and the dump's seconds, beside the card's name and power
    limit."""
    import gc
    import shutil
    import signal
    import tempfile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.gpt2_pretraining import synthetic_tokens
    from horovod_tpu_torch.models.transformer import GPT2_MEDIUM
    from horovod_tpu_torch import health
    from horovod_tpu_torch.tools import metrics_summary, trace_merge
    from horovod_tpu_torch.utils import flight, metrics, prof

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(GPT2_MEDIUM, fused_norm=True)
    tokens = torch.from_numpy(synthetic_tokens(
        cfg.vocab_size, 8, 1024, 0, 1)).cuda()
    card = _card()
    root = tempfile.mkdtemp(prefix="hvd_observed_")
    jsonl = os.path.join(root, "steps.jsonl")
    trace = os.path.join(root, "timeline.json")
    fdir = os.path.join(root, "flight")
    report = {"phase": "train_observed", "card": card,
              "model": "GPT-2 medium 24x1024, 16 heads", "batch": "8x1024",
              "steps": OBSERVE_STEPS}
    try:
        on, model, step = _observed_run(cfg, tokens, {
            "HOROVOD_METRICS": "1", "HOROVOD_TPU_METRICS_FILE": jsonl,
            "HOROVOD_TIMELINE": trace, "HOROVOD_TIMELINE_MARK_CYCLES": "1",
            "HOROVOD_FLIGHT_RECORDER": "1", "HOROVOD_FLIGHT_DIR": fdir})
        ledger["train_observed"] = on["launches"]
        plan = step.optimizer.bucket_plan
        params = step.optimizer._params
        threshold = hvd.Knobs.from_env().fusion_threshold_bytes
        bucket_bytes = [sum(n for (_, _, n, _) in b)
                        * params[b[0][0]].element_size() for b in plan]
        bcast = {}
        for t in model.state_dict().values():
            c = bcast.setdefault(
                f"broadcast/{str(t.dtype).split('.')[-1]}",
                {"count": 0, "bytes": 0})
            c["count"] += 1
            c["bytes"] += t.numel() * t.element_size()
        n_bcast = sum(c["count"] for c in bcast.values())
        # (c) the exposition, live
        text = metrics.scrape()
        lint = metrics.lint_exposition(text)
        _require(lint == [], f"phase 4p (c): the scrape lints {lint[:3]}")
        _require("\nhvd_step_seconds_count 6\n" in text,
                 "phase 4p (c): the step histogram does not count 6")
        # (e) two dumps, each parsed
        t0 = time.perf_counter()
        path = flight.dump("manual")
        dump_s = time.perf_counter() - t0
        _require(path is not None, "phase 4p (e): the manual dump failed")
        with open(path) as f:
            header, events = flight.parse_dump(f.read())
        _require(header.get("reason") == "manual"
                 and header.get("events") == len(events),
                 f"phase 4p (e): the manual dump reads {header}")
        dump_bytes = os.path.getsize(path)
        before = flight.dump_count()
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 10
        while flight.dump_count() == before and time.monotonic() < deadline:
            time.sleep(0.01)
        with open(path) as f:
            header, events = flight.parse_dump(f.read())
        _require(header.get("reason") == "sigusr2"
                 and events and events[-1]["kind"] == "signal_dump",
                 f"phase 4p (e): the SIGUSR2 dump reads {header}")
        # (d) the timeline
        hvd.stop_timeline()
        with open(trace) as f:
            evs = json.load(f)
        spans = [e for e in evs if e["name"] == "XLA_COLLECTIVE"
                 and e["tid"] == "broadcast"]
        plans = [e for e in evs if e["name"] == "FUSION_PLAN"]
        _require(evs[0]["name"] == "CLOCK_ANCHOR" and _balanced(evs),
                 "phase 4p (d): the timeline opens without its anchor or "
                 "its B/E pairs do not balance")
        _require(len(spans) == 2 * n_bcast,
                 f"phase 4p (d): {len(spans)} broadcast span events, not "
                 f"2 x {n_bcast}")
        _require(len(plans) == 1
                 and plans[0]["args"]["buckets"] == len(plan),
                 f"phase 4p (d): FUSION_PLAN instants {plans}, not one "
                 f"of {len(plan)} buckets")
        del model, step
        hvd.shutdown()  # closes the JSONL
        gc.collect()
        torch.cuda.empty_cache()

        off, model, step = _observed_run(cfg, tokens, {
            "HOROVOD_METRICS": "0", "HOROVOD_TPU_METRICS_FILE": "",
            "HOROVOD_TIMELINE": "", "HOROVOD_TIMELINE_MARK_CYCLES": "0",
            "HOROVOD_FLIGHT_RECORDER": "0", "HOROVOD_FLIGHT_DIR": ""})
        _require(not metrics.enabled() and not flight.enabled(),
                 "phase 4p: the telemetry-off run records")
        del model, step
        hvd.shutdown()
        flight.uninstall_handlers()
        gc.collect()
        torch.cuda.empty_cache()
        # (f), (g): the sampled profiler and the health monitor
        part2, part2_s = _observed_part2(cfg, tokens, root, off["losses"])
        # (a)
        _require(on["losses"] == off["losses"],
                 f"phase 4p (a): losses {on['losses']} with telemetry, "
                 f"{off['losses']} without")
        _require(on["losses"][0] == in_process_losses[0],
                 f"phase 4p (a): step 1's loss {on['losses'][0]} is not "
                 f"phase 4's {in_process_losses[0]}")
        _require(on["losses"][-1] < on["losses"][0],
                 f"phase 4p (a): losses did not fall: {on['losses']}")
        # (b) the JSONL
        with open(jsonl) as f:
            recs = [json.loads(line) for line in f]
        _require([r["step"] for r in recs] == list(
            range(1, OBSERVE_STEPS + 1)),
                 f"phase 4p (b): records {[r['step'] for r in recs]}")
        off_by = [abs(r["step_time_s"] - s) / s
                  for r, s in zip(recs, on["host_s"])]
        _require(max(off_by) <= OBSERVE_TIME_TOL,
                 f"phase 4p (b): step_time_s off the clock by {off_by}")
        fill = [min(b / threshold, 1.0) for b in bucket_bytes]
        want_fusion = {"plans": 1, "buckets": len(plan),
                       "fill_ratio_mean": sum(fill) / len(fill)}
        _require(recs[0]["fusion"] == want_fusion,
                 f"phase 4p (b): record 1's fusion {recs[0]['fusion']}, "
                 f"not {want_fusion}")
        got = {k: v for k, v in recs[0]["collectives"].items()
               if k.startswith("broadcast/")}
        _require(got == bcast, f"phase 4p (b): record 1's broadcasts "
                               f"{got}, not the weights' {bcast}")
        for r in recs:
            _require(r["grad_bytes"] == 0 and "wire" not in r
                     and r["collectives"].get("allreduce/float64") == {
                         "count": 1, "bytes": 16},
                     f"phase 4p (b): record {r['step']} reads {r}")
            if r["step"] > 1:
                _require(r["fusion"]["plans"] == 0,
                         f"phase 4p (b): record {r['step']} plans again")
        rc, out = _quiet(metrics_summary.main, [jsonl, "--check"])
        _require(rc == 0, f"phase 4p (b): metrics_summary --check: {out}")
        # (e) one merged trace of both sources
        merged = os.path.join(root, "merged.json")
        rc, out = _quiet(trace_merge.main, ["--timeline", trace,
                                            "--flight", fdir,
                                            "--out", merged])
        merge = json.loads(out)
        _require(rc == 0 and merge["by_source"].get("rank0/host", 0) > 0
                 and merge["by_source"].get("rank0/flight", 0) > 0,
                 f"phase 4p (e): trace_merge gave {rc}, {merge}")
        report.update(
            losses=on["losses"], bitwise_off=True,
            launches_per_step={k: v / OBSERVE_STEPS
                               for k, v in on["launches"].items()
                               if k in STEP_LAUNCHES},
            step_ms_on=on["step_ms"], step_ms_off=off["step_ms"],
            on_over_off=on["step_ms"] / off["step_ms"],
            step_ms_on_all=[x * 1e3 for x in on["host_s"]],
            step_ms_off_all=[x * 1e3 for x in off["host_s"]],
            telemetry_ms_on=[x * 1e3 for x in on["telemetry_s"]],
            telemetry_ms_off=[x * 1e3 for x in off["telemetry_s"]],
            telemetry_ms_on_median=float(
                np.median(on["telemetry_s"][1:])) * 1e3,
            telemetry_share_on=sum(on["telemetry_s"][1:])
            / sum(on["host_s"][1:]),
            telemetry_by_call_on=on["telemetry_by_call"],
            telemetry_by_call_off=off["telemetry_by_call"],
            step_time_s_vs_clock_max=max(off_by),
            record_1={k: recs[0][k] for k in ("fusion", "grad_bytes")},
            broadcasts=n_bcast, buckets=len(plan),
            jsonl_bytes=os.path.getsize(jsonl),
            exposition_bytes=len(text.encode()),
            exposition_families=text.count("# TYPE "),
            timeline_events=len(evs), timeline_bytes=os.path.getsize(trace),
            flight_events=len(events), dump_bytes=dump_bytes,
            dump_s=dump_s, merged_events=merge["events"],
            merged_by_source=merge["by_source"], part2=part2,
            part2_s=part2_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        # later phases start from the recorders' defaults
        flight.reset()
        prof.reset()
        health.reset()
        metrics.reset()
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(report))
    return part2_s


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


#: ranks of phase 5c's ``dryrun_multichip`` (emulated on the card)
DRYRUN_RANKS = 4


def train_mnist_and_entry(ledger):
    """MNIST for one epoch through the example's ``main`` (world of one
    over NCCL; the mean loss of the last 4 steps must be below the first
    4's), then ``entry()`` once: its loss finite and ``causal_lm_loss``
    of the same model and tokens, within 1e-6 relative; then
    ``dryrun_multichip(DRYRUN_RANKS)`` (its ranks emulated on the card):
    its three ``OK`` lines, each loss finite."""
    import io

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.entry import dryrun_multichip, entry
    from horovod_tpu_torch.examples import mnist
    from horovod_tpu_torch.models.transformer import causal_lm_loss
    from horovod_tpu_torch.ops import _build

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
    del model, tokens
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _build.reset_launches()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        dryrun_multichip(DRYRUN_RANKS)
    torch.cuda.synchronize()
    ledger["dryrun"] = {k: v for k, v in _build.LAUNCHES.items() if v}
    lines = text.getvalue().splitlines()
    oks = [ln for ln in lines if " OK: " in ln]
    losses_ok = [float(ln.rsplit("loss=", 1)[1]) for ln in oks]
    _require(len(oks) == 3 and all(np.isfinite(losses_ok)),
             f"dryrun_multichip({DRYRUN_RANKS}): {lines}")
    print(json.dumps({
        "phase": "mnist_and_entry",
        "mnist": {"steps": len(losses), "first_losses": losses[:4],
                  "last_losses": losses[-4:], "test_acc": acc,
                  "wall_s": wall},
        "entry": {"model": "GPT-2 small, seq 512", "tokens": [4, 512],
                  "loss": loss, "causal_lm_loss": ref},
        "dryrun_multichip": {"ranks": DRYRUN_RANKS, "emulated": True,
                             "lines": oks, "launches": ledger["dryrun"],
                             "wall_s": time.perf_counter() - t0}}))


# ---------------------------------------------------------------------------
# phases 6 and 7: serving GPT-2 small from a CUDA graph per step
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


def _replays(engine):
    return {key: step.replays for key, step in engine.graphs.items()}


def _reckoned_launches(engine, before):
    """The launches of the engine's graphs replayed since ``before``
    (``_replays``): each graph's launches counted at its capture, times
    its replays since. A replay runs the captured kernels without
    passing through their wrappers, so the wrappers' counters tick at
    capture and not at replay."""
    out = {}
    for key, step in engine.graphs.items():
        n = step.replays - before.get(key, 0)
        for name, count in step.launches.items():
            out[name] = out.get(name, 0) + count * n
    return out


def _mb(nbytes):
    return nbytes / 2 ** 20


def serve(engine, prompts, max_new, label, ledger):
    """Serve ``prompts`` through the scheduler with the launch counts
    zeroed just before and read just after; returns the tokens and the
    run's numbers. On the card each step replays its graph, so the
    launches of the run are reckoned from the graphs (capture launches
    times replays in the run), and the wrappers must count nothing in
    it: no step ran outside its graph and none was captured. Under the
    engine's private ``_uncaptured`` the wrappers count every launch
    themselves. Either way the append+attend launches must split by
    route as the engine's calls say: one a layer on B16's prefill route
    for each prefill of 16 rows or more (prompts run through a float32
    cache), on the decode route for each shorter prefill and each decode
    step (B16 on a float cache, B17 on an int8 one), none on the CUDA
    cores."""
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import decode_attention as da
    from horovod_tpu_torch.serving.scheduler import DecodeScheduler

    sched = DecodeScheduler(engine, queue_limit=len(prompts),
                            default_timeout_s=600.0, stats_every=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _engine_calls(engine) as calls:
        _build.reset_launches()
        da.reset_route_launches()
        before = _replays(engine)
        t0 = time.perf_counter()
        reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
        _drive(sched, reqs, 100 * max_new * len(prompts))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    direct = dict(_build.LAUNCHES)
    direct.update({f"route:{r}": n for r, n in da.ROUTE_LAUNCHES.items()})
    reckoned = _reckoned_launches(engine, before)
    graphed = not engine._uncaptured
    if graphed:
        _require(not any(direct.values()),
                 f"{label}: kernels launched outside their graphs during "
                 f"the serve: {direct}")
        counts = reckoned
    else:
        _require(not any(reckoned.values()),
                 f"{label}: graphs replayed in an uncaptured serve")
        counts = direct
    ledger[label] = {k: v for k, v in counts.items()
                     if not k.startswith("route:")}
    layers = engine.cfg.num_layers
    long = sum(b >= da.PREFILL_MIN_T for b in calls["prefill_buckets"])
    short = len(calls["prefill_buckets"]) - long
    steps = layers * calls["decode_steps"]
    want = {"cuda_core": 0, "prefill": layers * long,
            "decode": layers * short + steps}
    routes = {r: counts.get(f"route:{r}", 0) for r in da.ROUTES}
    _require(routes == want, f"{label}: append_attend routes {routes}, "
                             f"expected {want} from the engine's calls "
                             f"{calls}")
    int8 = steps if engine.spec.dtype == "int8" else 0
    _require(counts.get("append_attend_int8", 0) == int8,
             f"{label}: append_attend_int8 launched "
             f"{counts.get('append_attend_int8', 0)} times, expected "
             f"{int8} (one a layer a decode step on an int8 cache)")
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
    stats = {"phase": label, "graphed": graphed, "requests": len(reqs),
             "succeeded": len(outs), "failed": 0, "tokens": n_tok,
             "wall_s": wall, "tokens_per_s": n_tok / wall,
             "ttft_p50_ms": _pct(ttft, 50) * 1e3,
             "ttft_max_ms": max(ttft) * 1e3,
             "tpot_p50_ms": _pct(tpot, 50) * 1e3,
             "tpot_max_ms": max(tpot) * 1e3,
             "prefills": len(calls["prefill_buckets"]),
             "decode_steps": calls["decode_steps"],
             "append_attend_routes": routes,
             "launches": ledger[label],
             "peak_allocated_mb": _mb(torch.cuda.max_memory_allocated()),
             "reserved_mb": _mb(torch.cuda.memory_reserved()),
             "scheduler": sched.stats()}
    print(json.dumps(stats))
    return outs, stats


def warm(engine, label):
    """``engine.warmup()``: every graph's capture seconds and the memory
    the graphs and their static buffers took."""
    torch.cuda.synchronize()
    alloc, reserved = torch.cuda.memory_allocated(), \
        torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    graphs = engine.graphs
    _require(all(s.graph is not None for s in graphs.values()),
             f"{label}: warmup left a step without its graph")
    print(json.dumps({
        "warmup": label, "seconds": time.perf_counter() - t0,
        "graphs": len(graphs),
        "capture_s": {" ".join(map(str, k)): s.capture_s
                      for k, s in graphs.items()},
        "graph_allocated_mb": _mb(torch.cuda.memory_allocated() - alloc),
        "graph_reserved_mb": _mb(torch.cuda.memory_reserved() - reserved),
    }))


def serve_both(engine, prompts, max_new, label, ledger):
    """The serve through the graphs, then the same serve through the
    uncaptured steps (the engine's private ``_uncaptured``): the tokens
    must be the same, bitwise. Returns the graphed serve's tokens and
    both runs' numbers."""
    graphed, g_stats = serve(engine, prompts, max_new, label, ledger)
    engine._uncaptured = True
    try:
        uncaptured, u_stats = serve(engine, prompts, max_new,
                                    f"{label}_uncaptured", {})
    finally:
        engine._uncaptured = False
    _require(uncaptured == graphed,
             f"{label}: the graphed serve's tokens differ from the "
             "uncaptured steps'")
    print(json.dumps({"graphed_vs_uncaptured": label,
                      "tokens_bitwise": True,
                      **{f"{k}": [g_stats[k], u_stats[k]] for k in (
                          "wall_s", "tokens_per_s", "ttft_p50_ms",
                          "tpot_p50_ms", "peak_allocated_mb")}}))
    return graphed, g_stats, u_stats


def check_return_logits(engine, prompts, steps=3):
    """Every slot prefilled, then ``steps + 1`` decode steps with
    ``return_logits`` through the graph (its first call captures it, the
    rest replay it) and, from the same cache state, through the
    uncaptured step: the next tokens and the ``[slots, vocab]`` logits
    bitwise."""
    slots = [engine.claim_slot() for _ in range(engine.slots)]
    toks = np.zeros(engine.slots, np.int32)
    lens = np.zeros(engine.slots, np.int32)
    for s, p in zip(slots, prompts):
        toks[s], _ = engine.prefill(s, p)
        lens[s] = len(p)
    snap = {k: v.clone() for k, v in engine._cache.items()}
    runs = []
    for uncaptured in (False, True):
        engine._uncaptured = uncaptured
        try:
            for k, v in engine._cache.items():
                v.copy_(snap[k])  # in place: the graphs hold the address
            t, ln, out = toks.copy(), lens.copy(), []
            for _ in range(steps + 1):
                nxt, logits = engine.decode(t, ln, return_logits=True)
                out.append((nxt, logits))
                t, ln = nxt, ln + 1
            runs.append(out)
        finally:
            engine._uncaptured = False
    for i, ((gn, gl), (un, ul)) in enumerate(zip(*runs)):
        _require(np.array_equal(gn, un) and np.array_equal(gl, ul),
                 f"return_logits step {i}: the graph's tokens or logits "
                 "differ from the uncaptured step's")
        _require(np.isfinite(gl).all(), "non-finite decode logits")
    key = ("decode", engine.slots, engine.max_len, True)
    _require(engine.graphs[key].replays == steps,
             f"the return_logits graph replayed "
             f"{engine.graphs[key].replays} times, not {steps}")
    for s in slots:
        engine.release_slot(s)
    del snap
    torch.cuda.empty_cache()
    print(json.dumps({"return_logits_bitwise": {
        "cache": engine.spec.dtype, "replayed_steps": steps,
        "logits_shape": list(runs[0][0][1].shape)}}))


def profile_decode(engine, prompts, steps=8):
    """Where a decode step's time goes: ``torch.profiler`` over
    ``steps`` scheduler iterations with every slot occupied, each one
    decode step (a graph replay, or the uncaptured step under the
    engine's ``_uncaptured``). Prints the device busy share (kernel time
    over wall time; the profiler's own host cost makes the share a lower
    bound), the append+attend kernels' device time per step (B16 or B17,
    by the cache), the kernels by device time per step, and requires
    the device records to hold one decode-route append+attend a layer
    and one LayerNorm forward per norm (two a layer and the final one) a
    step: the launch counts reckoned from the graphs, confirmed on the
    card. Returns the reading."""
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
    attend = [e for e in kernels
              if "attend" in e.key or "decode_cluster" in e.key]
    attend_us = sum(_dev_us(e) for e in attend)
    layers = engine.cfg.num_layers
    per_step = {
        "layernorm_fwd": sum(e.count for e in kernels
                             if "layernorm_fwd" in e.key) / steps,
        "append_attend": sum(e.count for e in kernels
                             if "decode_cluster" in e.key) / steps,
        "append_attend_other_routes": sum(
            e.count for e in attend
            if "decode_cluster" not in e.key) / steps}
    want = {"layernorm_fwd": 2 * layers + 1, "append_attend": layers,
            "append_attend_other_routes": 0}
    _require(per_step == want,
             f"decode step kernels in the profile {per_step}, expected "
             f"{want}")
    reading = {
        "profile": f"decode, all {engine.slots} slots occupied, "
                   f"{engine.spec.dtype} cache",
        "graphed": not getattr(engine, "_uncaptured", True),
        "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_ms_per_step": busy_us / 1e3 / steps,
        "append_attend_ms_per_step": attend_us / 1e3 / steps,
        "device_busy_share": (busy_us / 1e6 / wall) if busy_us else None,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "path_kernels_per_step": per_step,
        "top": [{"name": e.key[:60], "ms_per_step": _dev_us(e) / 1e3 / steps,
                 "calls_per_step": e.count / steps} for e in top]}
    print(json.dumps(reading))
    return reading


def profile_decode_both(engine, prompts):
    """``profile_decode`` through the graphs and through the uncaptured
    step."""
    graphed = profile_decode(engine, prompts)
    engine._uncaptured = True
    try:
        uncaptured = profile_decode(engine, prompts)
    finally:
        engine._uncaptured = False
    return graphed, uncaptured


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


#: new tokens a request of phase 6 (and 8), and of phase 7
SERVE_MAX_NEW = 32
SERVE_INT8_MAX_NEW = 16


def serve_engine(engine, prompts, max_new, label, ledger):
    """One cache's serve (phases 6 and 7): capture every graph, serve
    ``prompts`` through the graphs and through the uncaptured steps
    (bitwise), four of them one at a time (bitwise the batch), decode
    steps with ``return_logits`` (bitwise), and profile a decode step
    both ways. Returns the graphed tokens."""
    warm(engine, label)
    batched, _, _ = serve_both(engine, prompts, max_new, label, ledger)
    for i in (0, 5, 10, 15):
        alone, _ = serve(engine, [prompts[i]], max_new,
                         f"{label}_alone_{i}", {})
        _require(alone[0] == batched[i],
                 f"{label}: request {i}'s tokens one at a time differ from "
                 "the continuous batch")
    print(f"{label}: 4 requests one at a time equal the batched run")
    check_return_logits(engine, prompts)
    profile_decode_both(engine, prompts)
    return batched


def serve_gpt2(seed, ledger):
    """Phases 6, 7 and 8. Returns phase 6's tokens."""
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.serving.decode import GenerationEngine

    cfg, model, prompts = _gpt2_small(seed)
    plain_cfg = dataclasses.replace(cfg, fused_norm=False)
    with torch.device("cuda"):
        plain = Transformer(plain_cfg)
    plain.load_state_dict(model.state_dict())
    plain.eval()

    # phase 6: bf16 KV cache
    t_phase = time.perf_counter()
    engine = GenerationEngine(model, slots=8, max_len=1024, kv_dtype="bf16")
    batched = serve_engine(engine, prompts, SERVE_MAX_NEW, "serve_bf16",
                           ledger)

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
    del engine, plain
    torch.cuda.empty_cache()
    print(json.dumps({"phase_s": {"6": time.perf_counter() - t_phase}}))
    _phase_done("6", time.perf_counter() - t_phase)

    # phase 7: int8 KV cache
    t_phase = time.perf_counter()
    engine = GenerationEngine(model, slots=8, max_len=1024, kv_dtype="int8")
    serve_engine(engine, prompts, SERVE_INT8_MAX_NEW, "serve_int8", ledger)
    _require(engine._cache["k"].dtype == torch.int8,
             "int8 serve did not hold an int8 cache")
    del engine
    torch.cuda.empty_cache()
    print(json.dumps({"phase_s": {"7": time.perf_counter() - t_phase}}))
    _phase_done("7", time.perf_counter() - t_phase)

    # phase 8: over HTTP, from replica processes
    t_phase = time.perf_counter()
    serve_http(seed, cfg, model, prompts, batched)
    print(json.dumps({"phase_s": {"8": time.perf_counter() - t_phase}}))
    _phase_done("8", time.perf_counter() - t_phase)
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: the serving tier over HTTP (registry, replicas, front door)
# ---------------------------------------------------------------------------

#: the decode replicas' knobs: phase 6's bucket and cache
HTTP_DECODE_ENV = {"HOROVOD_SERVING_DECODE_BUCKETS": "8x1024",
                   "HOROVOD_SERVING_KV_DTYPE": "bf16"}
#: the predict tier: an MLP on flattened 28 x 28 images, the default
#: buckets, and the groups of concurrent one-example clients; the
#: replica's batching window outlasts a group's arrival, so each group
#: is one batch, padded to the smallest covering bucket
MLP_IN, MLP_FEATURES = 784, (128, 64, 10)
MLP_BUCKETS = (1, 4, 16, 64)
MLP_GROUPS = (64, 10, 3, 1)
MLP_WAIT_MS = 2000
#: seconds a replica (checkpoint restore and graph capture) may take to
#: report ready
HTTP_READY_S = 240.0


class _Proc:
    """A serving process of phase 8: ``python -m
    horovod_tpu_torch.serving.replica_set ...`` from the checkout's root,
    its output pumped into ``lines`` by a thread."""

    def __init__(self, args, key, env_extra=None):
        import threading

        env = dict(_child_env(), HVD_TPU_SECRET_KEY=key.decode(),
                   **(env_extra or {}))
        self.argv = [sys.executable, "-m",
                     "horovod_tpu_torch.serving.replica_set", *args]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(self.argv, cwd=HERE, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.append((time.perf_counter() - self.t0,
                               line.rstrip("\n")))

    def ready(self, prefix, timeout=HTTP_READY_S):
        """(seconds to the READY line, its port)."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            for t, line in self.lines:
                if line.startswith(prefix):
                    return t, int(line.rsplit("port=", 1)[1])
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        raise SmokeFailure(f"{' '.join(self.argv[3:])}: no {prefix} line "
                           f"(exit {self.proc.poll()}):\n" + "\n".join(
                               l for _, l in self.lines[-30:]))

    def stop(self):
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode


def _stream_all(addr, prompts, max_new, key, on_first=None):
    """Stream every prompt concurrently through ``addr``'s
    /v1/generate: per prompt the tokens, the seconds to the first token
    and to the end, and the error if one reached the client."""
    import threading

    from horovod_tpu_torch.serving import generate_stream_remote

    res = [None] * len(prompts)
    start = threading.Barrier(len(prompts))

    def client(i):
        start.wait()
        t0 = time.perf_counter()
        toks, first_t, err = [], None, None
        try:
            for chunk in generate_stream_remote(
                    addr, {"prompt": prompts[i], "max_new_tokens": max_new},
                    300.0, key=key):
                if chunk.get("tokens") and first_t is None:
                    first_t = time.perf_counter() - t0
                    if on_first is not None:
                        on_first()
                toks.extend(int(t) for t in chunk.get("tokens", ()))
                if chunk.get("error"):
                    err = chunk["error"]
        except Exception as e:  # noqa: BLE001 — reported as a failure
            err = f"{type(e).__name__}: {e}"
        res[i] = {"tokens": toks, "ttft_s": first_t,
                  "end_s": time.perf_counter() - t0, "error": err}

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return res, time.perf_counter() - t0


def _http_round(label, res, wall, want):
    """Check one round of streams against phase 6's tokens and print its
    numbers."""
    failed = [i for i, r in enumerate(res) if r is None or r["error"]]
    _require(not failed, f"phase 8 {label}: {len(failed)} client-visible "
                         f"failures: {[res[i] for i in failed[:3]]}")
    differ = [i for i, r in enumerate(res) if r["tokens"] != want[i]]
    _require(not differ, f"phase 8 {label}: requests {differ} got tokens "
                         "that are not phase 6's")
    n_tok = sum(len(r["tokens"]) for r in res)
    ttft = [r["ttft_s"] for r in res]
    tpot = [(r["end_s"] - r["ttft_s"]) / (len(r["tokens"]) - 1)
            for r in res]
    stats = {"phase": f"serve_http {label}", "requests": len(res),
             "failed": 0, "tokens": n_tok, "tokens_bitwise_phase_6": True,
             "wall_s": wall, "tokens_per_s": n_tok / wall,
             "ttft_p50_ms": _pct(ttft, 50) * 1e3,
             "ttft_max_ms": max(ttft) * 1e3,
             "tpot_p50_ms": _pct(tpot, 50) * 1e3,
             "tpot_max_ms": max(tpot) * 1e3}
    print(json.dumps(stats))
    return stats


def _predict_groups(addr, key, mlp, rng):
    """The predict tier's check: each group of one-example clients sent
    at once is one batch of the replica, padded to the covering bucket;
    every answer must be bitwise the module's forward of that padded
    batch in this process. Rows are matched by input, since the replica
    orders a batch by arrival; that a row's output does not depend on
    its place in the batch is checked here first, by permuting each
    bucket's batch. Returns each group's batch fill."""
    import threading

    from horovod_tpu_torch.serving import predict_remote

    with torch.inference_mode():
        for b in MLP_BUCKETS:
            x = torch.randn(b, MLP_IN, device="cuda")
            perm = torch.randperm(b, device="cuda")
            _require(torch.equal(mlp(x)[perm], mlp(x[perm])),
                     f"phase 8: the MLP's rows at bucket {b} depend on "
                     "their place in the batch")
    fills = []
    for k in MLP_GROUPS:
        bucket = min(b for b in MLP_BUCKETS if b >= k)
        xs = rng.randn(k, MLP_IN).astype(np.float32)
        got = [None] * k
        start = threading.Barrier(k)

        def client(i):
            start.wait()
            try:
                got[i] = predict_remote(addr, xs[i:i + 1], 60.0, key=key)
            except Exception as e:  # noqa: BLE001 — a failure below
                got[i] = e
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        bad = [g for g in got if not isinstance(g, np.ndarray)]
        _require(not bad, f"phase 8 predict: group of {k}: {bad[:3]}")
        padded = np.zeros((bucket, MLP_IN), np.float32)
        padded[:k] = xs
        with torch.inference_mode():
            want = mlp(torch.from_numpy(padded).cuda()).cpu().numpy()[:k]
        differ = [i for i in range(k)
                  if not np.array_equal(got[i][0], want[i])]
        _require(not differ,
                 f"phase 8 predict: group of {k} (bucket {bucket}): "
                 f"answers {differ[:5]} are not the module's forward of "
                 "the padded batch bitwise")
        fills.append({"clients": k, "bucket": bucket,
                      "batch_fill": k / bucket})
    return fills


def check_mesh_engine(mlp_dir):
    """Phase 8 (d)'s engine on the world's mesh: the predict tier's MLP
    in ``InferenceEngine(mesh=hvd.mesh(), sharding_rules=RESNET_RULES)``
    (a world of one over NCCL) against the engine without a mesh, each
    bucket's request twice (the lazily built graph's uncaptured first
    run, then its replay): bitwise, every bucket graphed. Returns the
    buckets and the resident and shard bytes."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.sharding import RESNET_RULES
    from horovod_tpu_torch.serving import InferenceEngine

    hvd.init()
    try:
        plain = InferenceEngine.from_checkpoint(mlp_dir, buckets=MLP_BUCKETS)
        meshed = InferenceEngine.from_checkpoint(
            mlp_dir, buckets=MLP_BUCKETS, mesh=hvd.mesh(),
            sharding_rules=RESNET_RULES)
        rng = np.random.RandomState(8)
        for b in MLP_BUCKETS:
            x = rng.randn(b, MLP_IN).astype(np.float32)
            for _ in range(2):
                _require(np.array_equal(meshed(x), plain(x)),
                         f"phase 8 (d): the mesh engine at bucket {b} is "
                         "not bitwise the engine without a mesh")
        graphed = [s.graph is not None for s in meshed._cache.values()]
        _require(len(graphed) == len(MLP_BUCKETS) and all(graphed),
                 f"phase 8 (d): the mesh engine's steps graphed {graphed}")
        return {"mesh": hvd.mesh().sizes, "buckets": list(MLP_BUCKETS),
                "bitwise_unmeshed": True, "graphed": True,
                "resident_param_bytes": meshed.resident_param_bytes,
                "shard_param_bytes": meshed.shard_param_bytes}
    finally:
        hvd.shutdown()


def check_graph_eviction(mlp_dir):
    """An ``InferenceEngine`` on the predict tier's checkpoint in this
    process: its four bucket graphs captured, then an engine limited to
    one graph captures a fifth (a float16 request), evicting the four:
    the memory the card holds for the engine must shrink, and no evicted
    step may keep a pinned host buffer. Then, still limited to one
    graph, requests of five more shapes (buckets x dtypes), more than
    ``MAX_CACHED_EXECUTABLES`` (its default) keys in all: the engine's
    pinned host bytes must stay at most the largest one key's buffers.
    Returns the reserved MB before and after and the pinned bytes."""
    from horovod_tpu_torch.serving import InferenceEngine

    eng = InferenceEngine.from_checkpoint(mlp_dir, buckets=MLP_BUCKETS)
    eng.warmup((MLP_IN,))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    warm = list(eng._cache.values())
    _require(all(st.pinned for st in warm) and eng.pinned_bytes > 0,
             "phase 8 (e): the warmed steps hold no pinned buffers")
    limit = eng.MAX_CACHED_EXECUTABLES
    eng.MAX_CACHED_EXECUTABLES = 1
    eng(np.zeros((1, MLP_IN), np.float16))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    _require(eng.cached_executables == 1 and after < before,
             f"phase 8 (e): evicting 4 graphs left {eng.cached_executables} "
             f"cached and the reserved memory at {after} bytes from "
             f"{before}")
    _require(not any(st.pinned for st in warm),
             "phase 8 (e): an evicted step kept its pinned host buffers")
    keys, peak, bound = 5, 0, 0
    for n, dtype in ((1, np.float32), (3, np.float16), (10, np.float32),
                     (50, np.float16), (64, np.float32)):
        eng(np.zeros((n, MLP_IN), dtype))
        bucket = eng.bucket_for(n)
        # the input buffer, and an output of at most 8 bytes a value
        bound = max(bound, bucket * (MLP_IN * np.dtype(dtype).itemsize
                                     + MLP_FEATURES[-1] * 8))
        peak = max(peak, eng.pinned_bytes)
    keys += 5
    _require(keys > eng.MAX_CACHED_EXECUTABLES and peak <= bound,
             f"phase 8 (e): {keys} keys (limit {limit}) held up to {peak} "
             f"pinned host bytes, more than one key's {bound}")
    eng.MAX_CACHED_EXECUTABLES = limit
    return {"reserved_mb": [_mb(before), _mb(after)],
            "keys": keys, "max_cached": 1,
            "pinned_bytes_max": peak, "pinned_bytes_bound": bound}


def _hist_quantile(samples, name, q):
    """The ``q`` quantile of a histogram's buckets summed over its label
    sets, interpolated within its bucket as Prometheus'
    ``histogram_quantile`` does (an estimate: the buckets are all the
    exposition keeps)."""
    cum = {}
    for (n, labels), v in samples.items():
        if n == name + "_bucket":
            le = labels.rsplit('le="', 1)[1].rstrip('"')
            le = float("inf") if le == "+Inf" else float(le)
            cum[le] = cum.get(le, 0.0) + v
    bounds = sorted(cum)
    total = cum[bounds[-1]] if bounds else 0.0
    if not total:
        return None
    rank, lo, below = q * total, 0.0, 0.0
    for le in bounds:
        if cum[le] >= rank:
            if le == float("inf"):
                return lo
            return lo + (le - lo) * (rank - below) / max(cum[le] - below,
                                                         1e-30)
        lo, below = le, cum[le]
    return lo


def _replica_telemetry(replicas, results):
    """Phase 8 (a)'s replica scrapes (part 3): each decode replica's
    ``GET /metrics`` (its ``serve_replica`` turned metrics on) against
    the client's view of the same requests (the first request and round
    (a)): requests by code, one TTFT a request on its replica and their
    sum within the client's TTFTs', the TPOT count the tokens after each
    request's first under its class ("standard"), the slots' gauges."""
    from horovod_tpu_torch.utils import metrics

    texts = {i: _scrape(a) for i, a in sorted(replicas.items())}
    per = {i: _prom(t) for i, t in texts.items()}
    lint = {i: problems[:3] for i, t in texts.items()
            if (problems := metrics.lint_exposition(t))}
    _require(not lint, f"phase 8: replica expositions do not lint: {lint}")
    merged = {}
    for got in per.values():
        for k, v in got.items():
            merged[k] = merged.get(k, 0.0) + v
    codes = {k[1]: v for k, v in merged.items()
             if k[0] == "hvd_serving_requests_total"}
    tokens_after_first = sum(len(r["tokens"]) - 1 for r in results)
    client_ttft = sum(r["ttft_s"] for r in results)
    std = 'slo="standard"'
    checks = {
        "requests_by_code": (codes, {'code="200"': float(len(results))}),
        "ttft_count": (merged.get(("hvd_serving_ttft_seconds_count", std)),
                       float(len(results))),
        "tpot_count": (merged.get(("hvd_serving_tpot_seconds_count", std)),
                       float(tokens_after_first)),
    }
    wrong = {k: v for k, v in checks.items() if v[0] != v[1]}
    for i, got in per.items():
        if got.get(("hvd_serving_ttft_seconds_count", std), 0.0) != got.get(
                ("hvd_serving_requests_total", 'code="200"'), 0.0):
            wrong[f"replica {i} ttft vs requests"] = got
        if ("hvd_serving_decode_slots", 'state="total"') not in got:
            wrong[f"replica {i} slots"] = "absent"
    ttft_sum = merged.get(("hvd_serving_ttft_seconds_sum", std), 0.0)
    if not ttft_sum <= client_ttft:
        wrong["ttft_sum"] = (ttft_sum, client_ttft)
    _require(not wrong, f"phase 8: replica records against the client "
                        f"(got, want): {wrong}")
    it_n = merged[("hvd_serving_decode_iteration_seconds_count", "")]
    tpot = [(r["end_s"] - r["ttft_s"]) / (len(r["tokens"]) - 1)
            for r in results]
    return {
        "requests": len(results), "ttft_sum_s": ttft_sum,
        "client_ttft_sum_s": client_ttft,
        "tpot_samples": tokens_after_first,
        "replica_tpot_median_ms": _hist_quantile(
            merged, "hvd_serving_tpot_seconds", 0.5) * 1e3,
        "replica_tpot_mean_ms": merged[("hvd_serving_tpot_seconds_sum",
                                        std)] / tokens_after_first * 1e3,
        "client_tpot_median_ms": _pct(tpot, 50) * 1e3,
        "decode_iterations": it_n,
        "decode_step_wall_mean_ms": merged[
            ("hvd_serving_decode_iteration_seconds_sum", "")] / it_n * 1e3,
        "decode_step_wall_median_ms": _hist_quantile(
            merged, "hvd_serving_decode_iteration_seconds", 0.5) * 1e3,
        "exposition_bytes": {i: len(t) for i, t in texts.items()}}


def _front_door_telemetry(addr, n_replies):
    """Phase 8 (c)'s front-door scrape (part 3; this process's metrics,
    on since (a)): every reply the clients got, by code; replica 0,
    SIGTERMed in (b), ejected once and replica 1 never; no request in
    flight on either."""
    got = _prom(_scrape(addr))
    want = {("hvd_serving_requests_total", 'code="200"'): float(n_replies),
            ("hvd_serving_failovers_total", 'replica="0"'): 1.0,
            ("hvd_serving_inflight", 'replica="0"'): 0.0,
            ("hvd_serving_inflight", 'replica="1"'): 0.0}
    wrong = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    extra = [k for k in got if k[0] in ("hvd_serving_requests_total",
                                        "hvd_serving_failovers_total")
             and k not in want]
    _require(not wrong and not extra,
             f"phase 8 (c): the front door's records (got, want) {wrong}, "
             f"unexpected {extra}")
    return {"replies": n_replies, "failovers": {"0": 1}}


def _front_door_health(addr):
    """``GET /health`` and ``/healthz`` on phase 8's front door with this
    process's health monitor on: a verdict ("ok", no alert), not "off".
    The monitor is reset after."""
    import urllib.request

    from horovod_tpu_torch import health
    from horovod_tpu_torch.utils import metrics

    health.configure(enabled_override=True, endpoint=None,
                     interval_s=3600.0, capture=False)
    try:
        with urllib.request.urlopen(f"http://{addr}/health",
                                    timeout=10) as r:
            verdict = json.loads(r.read())
        with urllib.request.urlopen(f"http://{addr}/healthz",
                                    timeout=10) as r:
            probe = json.loads(r.read())
    finally:
        health.reset()
        metrics.reset()
    _require(verdict == {"health": "ok", "alerts_active": 0, "alerts": []}
             and probe["health"] == "ok" and probe["status"] == "ok",
             f"phase 8: the front door's /health {verdict}, /healthz "
             f"{probe}")
    return verdict


def serve_http(seed, cfg, model, prompts, want):
    """Phase 8. Phase 6's GPT-2 small saved with ``checkpoint.save_model``
    and its serving metadata; a ``--registry``, two ``--decode``
    replicas on the card (``HTTP_DECODE_ENV``) registered to it, and an
    in-process front door (``ReplicaSet`` behind a ``ServingServer``).
    (a) After one request alone, the 16 prompts streamed concurrently
    through the front door with ``generate_stream_remote``: every token
    bitwise phase 6's;
    TTFT, TPOT and tokens/s on the client's clock. (b) The same again,
    and replica 0 SIGTERMed once every stream has its first token: its
    streams complete, it exits 83, and (c) 16 more requests reach replica
    1, with no failure any client sees, all tokens bitwise phase 6's.
    (d) The MLP predict tier through a ``--checkpoint`` replica
    (``_predict_groups``), 64 concurrent clients first, and the MLP on
    the world's mesh (``check_mesh_engine``). (e) An evicted
    predict graph frees its memory (``check_graph_eviction``)."""
    import shutil
    import tempfile
    import threading

    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.elastic.preemption import PREEMPTED_EXIT_CODE
    from horovod_tpu_torch.models.mlp import MLP
    from horovod_tpu_torch.runner.compute_service import ComputeClient
    from horovod_tpu_torch.runner.util.secret import make_secret_key
    from horovod_tpu_torch.serving import (SERVING_DECODE_KIND, SERVING_KIND,
                                           ReplicaSet, ServingServer)
    from horovod_tpu_torch.serving.decode import config_to_meta
    from horovod_tpu_torch.utils import metrics

    key = make_secret_key()
    root = tempfile.mkdtemp(prefix="hvd_serving_")
    procs = []
    front = None
    try:
        lm_dir, mlp_dir = (os.path.join(root, n) for n in ("lm", "mlp"))
        checkpoint.save_model(lm_dir, model, metadata={"serving": {
            "model": "transformer_lm", "config": config_to_meta(cfg)}})
        mlp = MLP(MLP_IN, MLP_FEATURES).cuda()
        mlp.init_params(torch.Generator(device="cuda").manual_seed(seed))
        mlp.eval()
        checkpoint.save_model(mlp_dir, mlp, metadata={"serving": {
            "model": "mlp", "features": list(MLP_FEATURES),
            "input_shape": [MLP_IN], "dtype": "float32"}})

        registry = _Proc(["--registry", "--port", "0"], key)
        procs.append(registry)
        _, reg_port = registry.ready("SERVING_REGISTRY_READY")
        reg = f"127.0.0.1:{reg_port}"
        decode = [_Proc(["--decode", "--checkpoint", lm_dir, "--index",
                         str(i), "--register", reg], key, HTTP_DECODE_ENV)
                  for i in range(2)]
        predict = _Proc(["--checkpoint", mlp_dir, "--index", "0",
                         "--register", reg, "--buckets",
                         ",".join(map(str, MLP_BUCKETS)), "--max-wait-ms",
                         str(MLP_WAIT_MS)], key)
        procs += decode + [predict]
        ready = [p.ready("SERVING_REPLICA_READY")[0]
                 for p in decode + [predict]]
        client = ComputeClient([("127.0.0.1", reg_port)], key)
        replicas = client.wait_for_workers(SERVING_DECODE_KIND, 2,
                                           timeout_s=60.0)
        _require(sorted(replicas) == [0, 1],
                 f"phase 8: decode replicas registered {replicas}")
        rs = ReplicaSet(replicas, key=key)
        front = ServingServer(generate_fn=rs.generate, key=key)
        addr = f"127.0.0.1:{front.start()}"
        # part 3: the front door (this process) records from here to its
        # scrape after (c); the replicas record since their start
        metrics.reset()
        metrics.enable()

        # one request first: a client process's first requests import
        # urllib's lazy modules, 0.3-0.9 s under 16 concurrent threads
        # (seen on the CPU as on the card), which is not the tier's time
        res, wall = _stream_all(addr, prompts[:1], SERVE_MAX_NEW, key)
        _require(not res[0]["error"] and res[0]["tokens"] == want[0],
                 f"phase 8: the first request got {res[0]}")
        print(json.dumps({"serve_http first request": {
            "ttft_ms": res[0]["ttft_s"] * 1e3, "wall_s": wall}}))
        first = res[0]
        # (a)
        res, wall = _stream_all(addr, prompts, SERVE_MAX_NEW, key)
        stats_a = _http_round("(a) two replicas", res, wall, want)
        t3 = time.perf_counter()
        replica_records = _replica_telemetry(replicas, [first] + res)
        PART3_S["8"] += time.perf_counter() - t3
        print(json.dumps({"serve_http replica records": replica_records}))

        # (b) SIGTERM replica 0 once every stream has its first token
        import signal

        started = threading.Semaphore(0)
        sent = {}

        def preempt():
            for _ in prompts:
                started.acquire()
            sent["t"] = time.perf_counter()
            decode[0].proc.send_signal(signal.SIGTERM)
        killer = threading.Thread(target=preempt, daemon=True)
        killer.start()
        res, wall = _stream_all(addr, prompts, SERVE_MAX_NEW, key,
                                on_first=started.release)
        killer.join(timeout=60)
        _require("t" in sent, "phase 8 (b): the streams never all started")
        stats_b = _http_round("(b) replica 0 SIGTERMed mid-load", res,
                              wall, want)
        rc = decode[0].proc.wait(timeout=120)
        exit_s = time.perf_counter() - sent["t"]
        _require(rc == PREEMPTED_EXIT_CODE,
                 f"phase 8 (b): the SIGTERMed replica exited {rc}, not "
                 f"{PREEMPTED_EXIT_CODE}:\n" + "\n".join(
                     l for _, l in decode[0].lines[-20:]))
        # (c) later requests reach replica 1
        res, wall = _stream_all(addr, prompts, SERVE_MAX_NEW, key)
        stats_c = _http_round("(c) after the drain", res, wall, want)
        _require(0 in rs.dead and 1 not in rs.dead,
                 f"phase 8 (c): dead replicas {rs.dead}")
        t3 = time.perf_counter()
        door_records = _front_door_telemetry(addr, 1 + 3 * len(prompts))
        PART3_S["8"] += time.perf_counter() - t3
        door_health = _front_door_health(addr)

        # (d)
        workers = client.wait_for_workers(SERVING_KIND, 1, timeout_s=60.0)
        fills = _predict_groups(workers[0], key, mlp,
                                np.random.RandomState(seed))
        mesh_engine = check_mesh_engine(mlp_dir)
        # (e)
        evict_mb = check_graph_eviction(mlp_dir)
        print(json.dumps({"serve_http": {
            "graph_eviction": evict_mb, "mesh_engine": mesh_engine,
            "replicas_ready_s": ready, "sigterm_to_exit_83_s": exit_s,
            "dead": rs.dead, "predict_batch_fill": fills,
            "front_door_health": door_health,
            "front_door_records": door_records,
            "rounds": [stats_a["tokens_per_s"], stats_b["tokens_per_s"],
                       stats_c["tokens_per_s"]]}}))
    finally:
        if front is not None:
            front.shutdown()
        metrics.reset()
        codes = [p.stop() for p in reversed(procs)]
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"serve_http_exit_codes": codes[::-1]}))


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
    a bf16 and on an int8 cache, replayed from its graph and uncaptured
    (``profile_decode_both``; a tree without graphs runs its eager step
    twice), and one ResNet-50 training step with the fused BatchNorm
    after one warm-up step (``profile_resnet_step``). Enforces nothing
    but the decode step's kernel counts."""
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
        profile_decode_both(engine, prompts)
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


def start_sass(_build, names):
    """Start one ``cuobjdump -sass`` a named library, all at once, each
    writing a temporary file (``print_sass_mma`` reads them). None where
    cuobjdump is absent."""
    import tempfile

    tool = _cuobjdump()
    if tool is None:
        return None
    started = {}
    for name in names:
        out = tempfile.TemporaryFile("w+")  # a pipe would block it
        started[name] = (subprocess.Popen(
            [tool, "-sass", str(_build._target(name))], stdout=out,
            stderr=subprocess.DEVNULL, text=True), out)
    return tool, started


def print_sass_mma(started):
    """Count the tensor-core instructions in each kernel's SASS of the
    named libraries, with ``cuobjdump`` where it is installed:
    ``mma.sync``'s ``HMMA`` and ``wgmma``'s ``HGMMA`` (the substring
    "HMMA" does not match "HGMMA"). A kernel that reads 0 of both does
    not use the tensor cores. Also counts its local-memory (register
    spill) instructions ``LDL``/``STL``, and how many of them lie inside
    a loop (between a backward branch and its target), where they cost
    on every iteration, from the disassemblies ``start_sass`` started.
    Informational; never fails."""
    if started is None:
        print("sass: cuobjdump is absent (CUDA toolkit, triton); HMMA "
              "and HGMMA counts not read")
        return
    tool, procs = started
    for name, (proc, out) in procs.items():
        proc.wait(timeout=300)
        out.seek(0)
        stdout = out.read()
        out.close()
        counts, fn, local, loops = {}, None, {}, {}
        for line in stdout.splitlines():
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
                          "rc": proc.returncode, "counts": counts}))


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
    ap.add_argument("--mesh-sweep", type=int, default=0, metavar="N",
                    help="only build the flash and norm kernels and print "
                         "phase 4m's step-1 readings of seeds 0..N-1 and "
                         "of its injected faults (MESH_GRAD_TOL's "
                         "evidence)")
    ap.add_argument("--pipe-sweep", type=int, default=0, metavar="N",
                    help="only build the flash and norm kernels and print "
                         "phase 4n's step-1 readings of seeds 0..N-1 and "
                         "of its injected faults, and (d)'s MoE readings "
                         "(PIPE_GRAD_TOL's, PIPE_LOSS_TOL's and "
                         "MOE_ROW_TOL's evidence)")
    ap.add_argument("--fsdp-sweep", type=int, default=0, metavar="N",
                    help="only build the flash and norm kernels and print "
                         "phase 4o's step-1 readings of seeds 0..N-1 and "
                         "of its injected faults (FSDP_AXIS_GRAD_TOL's "
                         "evidence)")
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
    ap.add_argument("--mesh-world", action="store_true",
                    help="one rank of phase 4m's cases on a real world of "
                         "four cards (mesh_world_worker; under "
                         "examples/local_world -np 4), not a smoke")
    ap.add_argument("--eager-stall-worker", action="store_true",
                    help="phase 4l (d)'s process (eager_stall_worker), "
                         "not a smoke")
    args = ap.parse_args(argv)
    global SMOKE_T0
    SMOKE_T0 = time.perf_counter()

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
    if args.mesh_world:
        return mesh_world_worker()
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

    # phase 2: the kernels' build; in a whole smoke phase 5b beside it,
    # whose Inception V3 and VGG-16 run no kernel of the port, on the
    # card while nvcc compiles on the host's cores
    import threading

    from horovod_tpu_torch.ops import _build

    ledger = {}
    whole = not (args.profiles or args.adasum_sweep or args.mesh_sweep
                 or args.pipe_sweep or args.fsdp_sweep or args.parity_sweep)
    names = (PROFILE_KERNELS if args.profiles
             else ADASUM_KERNELS if args.adasum_sweep
             else TRAIN_KERNELS if args.mesh_sweep or args.pipe_sweep
             or args.fsdp_sweep else None)
    secs, failed, built_at = {}, [], []

    def build():
        try:
            secs.update(_build.build(names))
            built_at.append(time.perf_counter())
        except BaseException as e:  # raised again below, after the join
            failed.append(e)

    t0 = time.perf_counter()
    build_thread = threading.Thread(target=build)
    build_thread.start()
    try:
        if whole:
            t5b = time.perf_counter()
            train_cnns(ledger)
            cnn_s = round(time.perf_counter() - t5b, 2)
            _phase_done("5b", cnn_s)
    finally:
        build_thread.join()
    if failed:
        raise failed[0]
    print(f"build: {built_at[0] - t0:.2f} s wall "
          + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    print(json.dumps({"build_cpu_s": {
        k: round(v, 2) for k, v in _build.CPU_SECONDS.items()}}))
    if args.profiles:
        profiles(args.seed)
        return 0
    if args.adasum_sweep:
        adasum_sweep(args.adasum_sweep)
        return 0
    if args.mesh_sweep:
        mesh_sweep(args.mesh_sweep)
        return 0
    if args.pipe_sweep:
        pipe_sweep(args.pipe_sweep)
        return 0
    if args.fsdp_sweep:
        fsdp_sweep(args.fsdp_sweep)
        return 0
    print_ptxas(_build, secs)
    # all disassembled at once, and done before phase 3's profiler
    # windows: a loaded host may lose a window's device records
    print_sass_mma(start_sass(_build, (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "append_attend",
        "append_attend_int8", "matmul_pack")))
    if args.parity_sweep:
        parity_sweep(args.parity_sweep)
        return 0

    seconds = {"1": round(t0 - SMOKE_T0, 2),
               "2": round(time.perf_counter() - t0, 2)}
    _phase_done("2", seconds["2"])
    if whole:
        seconds["5b (inside 2)"] = cnn_s

    # phase 3
    t0 = time.perf_counter()
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
    seconds["3"] = round(time.perf_counter() - t0, 2)
    _phase_done("3", seconds["3"])

    # phases 4 and 5: training; phases 6, 7 and 8: serving
    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 2)
        _phase_done(name, seconds[name])
        return out

    in_process_rate, in_process_losses = timed("4", train_gpt2, args.seed,
                                               ledger)
    flat_stage_ms = timed("4b", train_int8, args.seed, ledger)
    timed("4c", train_zero, args.seed, ledger)
    timed("4d", train_gpt2_fused_ce, args.seed, ledger)
    timed("4e", launch_gpt2, ledger, in_process_rate, in_process_losses)
    timed("4f", train_fsdp, args.seed, ledger, in_process_losses,
          in_process_rate)
    timed("4g", train_adasum, args.seed, ledger)
    timed("4h", train_hierarchical, args.seed, ledger, in_process_losses,
          flat_stage_ms)
    timed("4i", train_llama, args.seed, ledger)
    timed("4j", train_checkpoint, ledger)
    timed("4k", train_elastic, ledger)
    timed("4l", train_eager, args.seed, ledger, in_process_losses)
    timed("4m", train_mesh, args.seed, ledger, in_process_losses)
    timed("4n", train_pipeline, args.seed, ledger, in_process_losses)
    timed("4o", train_fsdp_axis, args.seed, ledger, in_process_losses)
    timed("4q (init shards)", check_init_shards)
    # 4p's seconds without (f) and (g), which have their own entry
    part2_s = timed("4p", train_observed, args.seed, ledger,
                    in_process_losses)
    seconds["4p"] = round(seconds["4p"] - part2_s, 2)
    seconds["4p (f), (g)"] = round(part2_s, 2)
    timed("5", train_resnet, args.seed, ledger)
    timed("5c", train_mnist_and_entry, ledger)
    timed("6-8", serve_gpt2, args.seed, ledger)
    # observability part 3's checks have their own entry, out of 4l's
    # and 6-8's
    seconds["4l"] = round(seconds["4l"] - PART3_S["4l"], 2)
    seconds["6-8"] = round(seconds["6-8"] - PART3_S["8"], 2)
    seconds["4l, 8 (part 3)"] = round(PART3_S["4l"] + PART3_S["8"], 2)
    print(json.dumps({"phase_seconds": seconds}))
    launches = {name: sum(counts.get(name, 0) for counts in ledger.values())
                for name, *_ in KERNELS}
    print(json.dumps({"launches_by_phase": ledger}))
    for name, n in launches.items():
        _require(n > 0, f"kernel {name} was not launched on its path")

    # phase 9
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
