#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (horovod_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N]

Phases, in order; the first failure exits non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build every kernel of ``horovod_tpu_torch/csrc/`` (one nvcc each, in
   parallel) and print the build seconds and ptxas resource lines;
3. hold each kernel against its plain PyTorch version on the card, at
   the serving path's shapes and in its working dtypes, and time the
   kernel, the plain version and one PyTorch library call computing the
   same function (a yardstick only: the port never calls it);
4. serve GPT-2 small at full width (random weights from the seed,
   ``fused_norm=True``, bf16 KV cache, 8 slots x 1024) under the
   continuous-batching scheduler: 16 requests of 32..700 prompt tokens,
   32 new tokens each; 4 of them again one at a time must give the
   same tokens; a profiled window of 8 full-batch decode steps shows
   where a step's time goes; the first-token logits must agree with
   the plain (unfused, cache-free) forward of the same weights;
5. a short serve on an int8 KV cache (4 requests);
6. print the ``{"kernels": [...]}`` line: each kernel's launches on the
   serving runs of phases 4 and 5 (counts zeroed just before each run
   and read just after), error, tolerance and times;
7. print ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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


def _device_ms(fn, iters=50):
    """Device time of one call of ``fn``: the summed device time of the
    kernels it launches, from ``torch.profiler`` over ``iters`` calls.
    For a call shorter than its host-side launch, where back-to-back
    CUDA-event timing measures the enqueue and not the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    us = sum(_dev_us(e) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    _require(us > 0, "the profiler saw no device time")
    return us / 1e3 / iters


def _bf16_ulp(x):
    mag = x.abs().to(torch.float32).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_layernorm(seed):
    from horovod_tpu_torch.ops import layernorm as ln

    cases = []
    g = torch.Generator(device="cuda").manual_seed(seed)
    for rows, kind in ((8, "layernorm"), (8, "rmsnorm"),
                       (512, "layernorm"), (512, "rmsnorm")):
        c = 768
        rms = kind == "rmsnorm"
        x = (torch.randn(rows, c, generator=g, device="cuda") * 2 + 0.5).to(
            torch.bfloat16)
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device="cuda")
        beta = None if rms else 0.1 * torch.randn(c, generator=g,
                                                  device="cuda")
        got = ln.layer_norm_cuda(x, gamma, beta, 1e-5, rms)
        want = ln.layer_norm_ref(x, gamma, beta, 1e-5, rms)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        ok = bool(torch.all(err <= _bf16_ulp(want.float())))
        _require(ok, f"layernorm_fwd {rows}x{c} {kind}: more than one bf16 "
                     f"ulp from the plain version (max err "
                     f"{err.max().item()})")
        gb, bb = gamma.to(torch.bfloat16), (
            None if beta is None else beta.to(torch.bfloat16))
        if rms:
            def lib(_=0):
                F.rms_norm(x, (c,), gb, 1e-5)
        else:
            def lib(_=0):
                F.layer_norm(x, (c,), gb, bb, 1e-5)
        nbytes = 2 * rows * c * 2 + c * 4 * (1 if rms else 2)
        bound, by = _bound(nbytes, rows * c * 8, "f32")

        def kernel(_=0):
            ln.layer_norm_cuda(x, gamma, beta, 1e-5, rms)

        def plain(_=0):
            ln.layer_norm_ref(x, gamma, beta, 1e-5, rms)
        # a call this short is shorter than its launch: times are the
        # card's (profiler), the host's enqueue is kept beside them
        cases.append({
            "case": f"{rows}x{c} bf16 {kind}",
            "max_abs_err": err.max().item(),
            "tol": "1 bf16 ulp of the plain value",
            "ms": _device_ms(kernel),
            "plain_ms": _device_ms(plain),
            "library_ms": _device_ms(lib),
            "enqueue_ms": _time_ms(kernel),
            "bound_ms": bound, "bound_by": by,
        })
    return cases


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


def check_append_attend(seed):
    from horovod_tpu_torch.ops import decode_attention as da

    rng = np.random.RandomState(seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cases = []
    L, KH, H, D = 12, 12, 12, 64
    atol = 4e-3  # bf16 outputs of magnitude ~0.1: summation order only

    def case(name, slots, m, t, cache_dtype, pos):
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
            torch.bfloat16)
        kn = torch.randn(slots, t, KH, D, generator=g, device="cuda").to(
            torch.bfloat16)
        vn = torch.randn(slots, t, KH, D, generator=g, device="cuda").to(
            torch.bfloat16)
        posd = torch.from_numpy(pos).cuda()
        kk, vk = k0.clone(), v0.clone()
        kr, vr = k0.clone(), v0.clone()
        got = da.append_attend_cuda(q, kk[:, 0], vk[:, 0], kn, vn, posd)
        want = da.append_attend_ref(q, kr[:, 0], vr[:, 0], kn, vn, posd)
        torch.cuda.synchronize()
        _require(bool(torch.equal(kk, kr)) and bool(torch.equal(vk, vr)),
                 f"append_attend {name}: merged cache differs")
        err = (got.float() - want.float()).abs().max().item()
        _require(err <= atol, f"append_attend {name}: max err {err} > "
                              f"{atol}")
        k_full, v_full, valid = da.append_rows_ref(
            kr[:, 0], vr[:, 0], kn, vn, posd, torch.bfloat16)
        cb = 4 if cache_dtype == torch.float32 else 2
        nbytes, ops = _attn_bytes_ops(pos, m, H, KH, D, 2, D * cb)
        bound, by = _bound(nbytes, ops, "bf16")
        cases.append({
            "case": name, "max_abs_err": err, "tol": atol,
            # rotate over the 12 layers' slices: a decode step finds
            # each layer's slice cold in L2, as here
            "ms": _time_ms(lambda i=0: da.append_attend_cuda(
                q, kk[:, i % L], vk[:, i % L], kn, vn, posd)),
            "plain_ms": _time_ms(lambda i=0: da.append_attend_ref(
                q, kr[:, i % L], vr[:, i % L], kn, vn, posd), iters=10),
            "library_ms": _time_ms(_sdpa(q, k_full, v_full, valid)),
            "bound_ms": bound, "bound_by": by,
        })

    case("decode B=8 T=1 M=1024 bf16 cache", 8, 1024, 1, torch.bfloat16,
         rng.randint(32, 1024, size=(8, 1)).astype(np.int32))
    case("prefill B=1 T=M=512 f32 cache", 1, 512, 512, torch.float32,
         np.arange(512, dtype=np.int32)[None])
    return cases


def check_append_attend_int8(seed):
    from horovod_tpu_torch.ops import decode_attention as da

    rng = np.random.RandomState(seed + 2)
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    cases = []
    S, L, KH, H, M, D = 8, 12, 12, 12, 1024, 64
    atol = 4e-3
    def codes():
        return torch.randint(-127, 128, (S, L, KH, M, D), generator=g,
                             device="cuda", dtype=torch.int8)

    def scales(nb):
        # blocks of randn rows: amax in about [1.5, 3.5]
        return (1.5 + 2 * torch.rand(S, L, KH, M, nb, generator=g,
                                     device="cuda")) / 127

    for block in (64, 32):
        nb = D // block
        kc0, vc0, ks0, vs0 = codes(), codes(), scales(nb), scales(nb)
        q = torch.randn(S, 1, H, D, generator=g, device="cuda").to(
            torch.bfloat16)
        kn = torch.randn(S, 1, KH, D, generator=g, device="cuda").to(
            torch.bfloat16)
        vn = torch.randn(S, 1, KH, D, generator=g, device="cuda").to(
            torch.bfloat16)
        pos = rng.randint(32, M, size=(S, 1)).astype(np.int32)
        posd = torch.from_numpy(pos).cuda()
        kk, vk, ksk, vsk = kc0.clone(), vc0.clone(), ks0.clone(), vs0.clone()
        kr, vr, ksr, vsr = kc0.clone(), vc0.clone(), ks0.clone(), vs0.clone()
        got = da.append_attend_int8_cuda(q, kk[:, 0], ksk[:, 0], vk[:, 0],
                                         vsk[:, 0], kn, vn, posd, block)
        want = da.append_attend_int8_ref(q, kr[:, 0], ksr[:, 0], vr[:, 0],
                                         vsr[:, 0], kn, vn, posd, block)
        torch.cuda.synchronize()
        for a, b, what in ((kk, kr, "k codes"), (vk, vr, "v codes"),
                           (ksk.view(torch.int32), ksr.view(torch.int32),
                            "k scales"),
                           (vsk.view(torch.int32), vsr.view(torch.int32),
                            "v scales")):
            _require(bool(torch.equal(a, b)),
                     f"append_attend_int8 block {block}: {what} not "
                     "bitwise equal to the plain version")
        err = (got.float() - want.float()).abs().max().item()
        _require(err <= atol, f"append_attend_int8 block {block}: max err "
                              f"{err} > {atol}")
        k_full, v_full, valid = da.append_rows_int8_ref(
            kr[:, 0], ksr[:, 0], vr[:, 0], vsr[:, 0], kn, vn, posd, block,
            torch.bfloat16)
        nbytes, ops = _attn_bytes_ops(pos, M, H, KH, D, 2, D + 4 * nb)
        bound, by = _bound(nbytes, ops, "bf16")
        cases.append({
            "case": f"decode B=8 T=1 M=1024 int8 cache block {block}",
            "max_abs_err": err, "tol": atol,
            "codes_scales": "bitwise",
            "ms": _time_ms(lambda i=0: da.append_attend_int8_cuda(
                q, kk[:, i % L], ksk[:, i % L], vk[:, i % L], vsk[:, i % L],
                kn, vn, posd, block)),
            "plain_ms": _time_ms(lambda i=0: da.append_attend_int8_ref(
                q, kr[:, i % L], ksr[:, i % L], vr[:, i % L], vsr[:, i % L],
                kn, vn, posd, block), iters=10),
            "library_ms": _time_ms(_sdpa(q, k_full, v_full, valid)),
            "bound_ms": bound, "bound_by": by,
        })
    return cases


# ---------------------------------------------------------------------------
# phases 4 and 5: serving GPT-2 small
# ---------------------------------------------------------------------------

def _drive(sched, reqs, max_iters):
    for _ in range(max_iters):
        if all(r.done for r in reqs):
            return
        sched.step_once()
    raise SmokeFailure(f"requests unfinished after {max_iters} iterations")


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p))


def serve(engine, prompts, max_new, label, ledger):
    """Serve ``prompts`` through the scheduler with the launch counts
    zeroed just before and read just after; returns the tokens."""
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.serving.scheduler import DecodeScheduler

    sched = DecodeScheduler(engine, queue_limit=len(prompts),
                            default_timeout_s=600.0, stats_every=0)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    _drive(sched, reqs, 100 * max_new * len(prompts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ledger[label] = dict(_build.LAUNCHES)
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
             "scheduler": sched.stats()}
    print(json.dumps(stats))
    return outs


def profile_decode(engine, prompts, steps=8):
    """Where a decode step's time goes: ``torch.profiler`` over
    ``steps`` scheduler iterations with every slot occupied. Prints the
    device busy share (kernel time over wall time; the profiler's own
    host cost makes the share a lower bound) and the kernels by device
    time per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.serving.scheduler import DecodeScheduler

    sched = DecodeScheduler(engine, queue_limit=engine.slots,
                            default_timeout_s=600.0, stats_every=0)
    for p in prompts[:engine.slots]:
        sched.submit(p, max_new_tokens=steps + 4)
    sched.step_once()  # admit and prefill every slot
    sched.step_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sched.close(drain=False)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(_dev_us(e) for e in kernels)
    top = sorted(kernels, key=_dev_us, reverse=True)[:8]
    print(json.dumps({
        "profile": f"decode, all {engine.slots} slots occupied",
        "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": (busy_us / 1e6 / wall) if busy_us else None,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "top": [{"name": e.key[:60], "ms_per_step": _dev_us(e) / 1e3 / steps,
                 "calls_per_step": e.count / steps} for e in top]}))


def serve_gpt2(seed, ledger):
    from horovod_tpu_torch.models.transformer import GPT2_SMALL, Transformer
    from horovod_tpu_torch.serving.decode import GenerationEngine

    cfg = dataclasses.replace(GPT2_SMALL, fused_norm=True)
    with torch.device("cuda"):
        model = Transformer(cfg)
    model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    plain_cfg = dataclasses.replace(cfg, fused_norm=False)
    with torch.device("cuda"):
        plain = Transformer(plain_cfg)
    plain.load_state_dict(model.state_dict())
    plain.eval()

    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size,
                           size=int(rng.randint(32, 701))).tolist()
               for _ in range(16)]

    # phase 4: bf16 KV cache
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

    # phase 5: int8 KV cache
    engine = GenerationEngine(model, slots=8, max_len=1024, kv_dtype="int8")
    engine.warmup()
    serve(engine, prompts[:4], 16, "serve_int8", ledger)
    _require(engine._cache["k"].dtype == torch.int8,
             "int8 serve did not hold an int8 cache")
    del engine


# ---------------------------------------------------------------------------

KERNELS = [
    ("layernorm_fwd", "horovod_tpu_torch/csrc/layernorm_fwd.cu",
     "horovod_tpu/ops/pallas_layernorm.py:67",
     "B4 pallas_layernorm._fwd_kernel"),
    ("append_attend", "horovod_tpu_torch/csrc/append_attend.cu",
     "horovod_tpu/ops/pallas_collectives.py:380",
     "B16 pallas_collectives._append_attend_kernel"),
    ("append_attend_int8", "horovod_tpu_torch/csrc/append_attend_int8.cu",
     "horovod_tpu/ops/pallas_collectives.py:409",
     "B17 pallas_collectives._append_attend_int8_kernel"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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

    # phase 2
    from horovod_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    for name in secs:
        log = (_build.BUILD_DIR / f"{name}.log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    # phase 3
    checks = {
        "layernorm_fwd": check_layernorm(args.seed),
        "append_attend": check_append_attend(args.seed),
        "append_attend_int8": check_append_attend_int8(args.seed),
    }
    for name, cases in checks.items():
        for c in cases:
            print(json.dumps({"kernel": name, **c}))

    # phases 4 and 5
    ledger = {}
    serve_gpt2(args.seed, ledger)
    launches = {name: sum(counts.get(name, 0) for counts in ledger.values())
                for name, *_ in KERNELS}
    print(json.dumps({"launches_by_phase": ledger}))
    for name, n in launches.items():
        _require(n > 0, f"kernel {name} was not launched while serving")

    # phase 6
    kernels = []
    for name, source, replaces, tpu in KERNELS:
        cases = checks[name]
        top = cases[0]  # the decode-shape case: the steady state
        err = max(c["max_abs_err"] for c in cases)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_kernel": tpu,
            "launches": launches[name],
            "max_abs_err": err, "tol": top["tol"], "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "cases": cases,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
