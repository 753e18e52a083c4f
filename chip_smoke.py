#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (horovod_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --parity-sweep 8   # the parity limits' readings

Phases, in order; the first failure exits non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build every kernel of ``horovod_tpu_torch/csrc/`` (one nvcc each, in
   parallel) and print the build seconds and ptxas resource lines;
3. hold each kernel against its plain PyTorch version on the card, at
   its path's shapes and in its working dtypes (flash attention at
   GPT-2 medium's [8, 16, 1024, 64] bf16, row by row, and there kernels
   that skip one tile must fail the same check; LayerNorm backward at
   [8192, 1024], the decode kernels at the serving shapes; the
   BatchNorm kernels at ResNet-50's shapes, apply and dx bitwise, the
   two reductions per channel, where sums that leave out one row block
   must fail), and time the kernel, the plain version and one PyTorch
   library call computing the same function (a yardstick only: the
   port never calls it);
4. train GPT-2 medium at full width and depth through the example's
   ``main`` (world of one over NCCL, batch 8 x 1024, flash attention and
   fused norms, 1 warm-up + 5 timed steps on one batch), after checking
   that the step-1 loss and every gradient of the kernel path agree
   with the plain path on the same weights (``GRAD_TOL``); the loss
   must fall; one step is profiled;
5. train ResNet-50 (224 px, 1000 classes) through the example's
   ``main`` with ``--fused-bn`` (world of one over NCCL, batch 128, 1
   warm-up + 5 timed steps on one batch), after checking the step-1
   loss and gradients of the fused-BN path against the plain-BN path
   on the same weights (``RESNET_GRAD_TOL``); the loss must fall, each
   BatchNorm kernel must launch 53 times a step; one step is profiled;
6. serve GPT-2 small at full width (random weights from the seed,
   ``fused_norm=True``, bf16 KV cache, 8 slots x 1024) under the
   continuous-batching scheduler: 16 requests of 32..700 prompt tokens,
   32 new tokens each; 4 of them again one at a time must give the
   same tokens; a profiled window of 8 full-batch decode steps shows
   where a step's time goes; the first-token logits must agree with
   the plain (unfused, cache-free) forward of the same weights;
7. a short serve on an int8 KV cache (4 requests);
8. print the ``{"kernels": [...]}`` line: each kernel's launches on the
   training runs of phases 4 and 5 and the serving runs of phases 6
   and 7 (counts zeroed just before each run and read just after),
   error, tolerance and times;
9. print ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
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


def _kernel_events(prof):
    """The profiler's averaged device events, without the GPU-side
    copies of user annotations (e.g. ``Optimizer.step``), whose time
    overlaps the kernels they enclose."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _device_ms(fn, iters=50):
    """Device time of one call of ``fn``: the summed device time of the
    kernels it launches, from ``torch.profiler`` over ``iters`` calls.
    For a call shorter than its host-side launch, where back-to-back
    CUDA-event timing measures the enqueue and not the card."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    us = sum(_dev_us(e) for e in _kernel_events(prof))
    _require(us > 0, "the profiler saw no device time")
    return us / 1e3 / iters


def _bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits), exact:
    x = m * 2^e with m in [0.5, 1) has ulp 2^(e - 8)."""
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       (e - 8).float())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_layernorm(seed):
    from horovod_tpu_torch.ops import layernorm as ln

    cases = []
    g = torch.Generator(device="cuda").manual_seed(seed)
    for rows, c, kind in ((8, 768, "layernorm"), (8, 768, "rmsnorm"),
                          (512, 768, "layernorm"), (512, 768, "rmsnorm"),
                          (8192, 1024, "layernorm")):
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
        # one bf16 ulp of the larger of the two values, plus float32
        # slack for outputs near 0, where beta cancels the rest and the
        # sum order moves the result by ~1e-6
        tol = _bf16_ulp(torch.maximum(got.float().abs(),
                                      want.float().abs())) + 1e-5
        _require(bool(torch.all(err <= tol)),
                 f"layernorm_fwd {rows}x{c} {kind}: more than one bf16 ulp "
                 f"(+1e-5) from the plain version (max err "
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
            "tol": "1 bf16 ulp of the larger value + 1e-5",
            "ms": _device_ms(kernel),
            "plain_ms": _device_ms(plain),
            "library_ms": _device_ms(lib),
            "enqueue_ms": _time_ms(kernel),
            "bound_ms": bound, "bound_by": by,
        })
    return cases


def _rel_err(got, want):
    """(max |got - want|, that over max |want|), both as floats."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def check_layernorm_bwd(seed):
    """B5 at the training path's rows: GPT-2 medium's 8 x 1024 tokens of
    1024 channels, bf16, LayerNorm with beta and RMSNorm."""
    from horovod_tpu_torch.ops import layernorm as ln

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    cases = []
    rows, c = 8192, 1024
    tol = 1e-2  # max |err| / max |want|: bf16 dx, float32 column sums
    for kind in ("layernorm", "rmsnorm"):
        rms = kind == "rmsnorm"
        x = (torch.randn(rows, c, generator=g, device="cuda") * 2 + 0.5).to(
            torch.bfloat16)
        dy = torch.randn(rows, c, generator=g, device="cuda").to(
            torch.bfloat16)
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device="cuda")
        got = ln.layer_norm_bwd_cuda(x, dy, gamma, 1e-5, rms, not rms)
        want = ln.layer_norm_bwd_ref(x, dy, gamma, 1e-5, rms, not rms)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
            if b is None:
                continue
            _require(bool(torch.isfinite(a).all()),
                     f"layernorm_bwd {kind}: {name} not finite")
            err, rel = _rel_err(a, b)
            _require(rel <= tol, f"layernorm_bwd {kind}: {name} max err "
                                 f"{err} ({rel:.2e} of max) > {tol}")
            errs[name] = err
        xl = x.detach().requires_grad_()
        gb = gamma.to(torch.bfloat16).requires_grad_()
        bb = None if rms else torch.zeros(c, device="cuda", dtype=torch.bfloat16,
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
        cases.append({
            "case": f"{rows}x{c} bf16 {kind}", "max_abs_err": max(
                errs.values()), "errs": errs,
            "tol": f"{tol} of max |plain| per output",
            "ms": _device_ms(kernel), "plain_ms": _device_ms(plain, iters=10),
            "library_ms": _device_ms(lib), "enqueue_ms": _time_ms(kernel),
            "bound_ms": bound, "bound_by": by,
        })
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
FLASH_TILE = 32  # rows of a streamed tile at head_dim <= 64 (flash.cuh)
FLASH_ROWS = 64  # rows a block holds (flash.cuh kRows)


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
    one streamed tile, the least visible one: the last block of query
    rows skipping keys 0..31 (forward, dQ), and the first block of keys
    skipping the last 32 queries (dK, dV), whose part of an early key's
    gradient is the smallest. The skipped tile's part comes from the
    plain version on the slices. Each reading is the least, over the
    (b, h) blocks, of the block's largest row share: above 1, a skip in
    any one block fails the check."""
    causal, scale, q_off, k_off = args
    t = q.shape[2]
    r0, q0, kt = t - FLASH_ROWS, t - FLASH_TILE, FLASH_TILE
    o_skip, _ = fa.flash_attention_ref(q[:, :, r0:], k[:, :, kt:],
                                       v[:, :, kt:], causal, scale,
                                       q_off + r0, k_off + kt)
    dq_part = fa.flash_bwd_ref(q[:, :, r0:], k[:, :, :kt], v[:, :, :kt],
                               dout[:, :, r0:], lse[:, :, r0:],
                               delta[:, :, r0:], causal, scale, q_off + r0,
                               k_off)[0]
    _, dk_part, dv_part = fa.flash_bwd_ref(
        q[:, :, q0:], k[:, :, :FLASH_ROWS], v[:, :, :FLASH_ROWS],
        dout[:, :, q0:], lse[:, :, q0:], delta[:, :, q0:], causal, scale,
        q_off + q0, k_off)
    rows = {"o": (o_skip, slice(r0, None)),
            "dq": (got["dq"][:, :, r0:].float() - dq_part.float(),
                   slice(r0, None)),
            "dk": (got["dk"][:, :, :FLASH_ROWS].float() - dk_part.float(),
                   slice(0, FLASH_ROWS)),
            "dv": (got["dv"][:, :, :FLASH_ROWS].float() - dv_part.float(),
                   slice(0, FLASH_ROWS))}
    return {what: _row_share(skip, want[what][:, :, sl], rtol,
                             atol).amax(-1).min().item()
            for what, (skip, sl) in rows.items()}


def check_flash(seed):
    """B1, B2, B3 at GPT-2 medium's attention ([8, 16, 1024, 64] bf16,
    causal), plus a non-causal, a padded-T and an offset case at batch
    2. Every case feeds the kernel and the plain version the same
    inputs (the backward gets the plain forward's lse and delta). Each
    row is held to ``FLASH_TOL``; in the main case, kernels that skip
    one tile must fail that check."""
    from horovod_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    out = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}

    def case(name, b, h, tq, tk, causal, q_off=0, k_off=0, timed=False,
             d=64, dtype=torch.bfloat16):
        rtol, atol = FLASH_TOL[dtype]

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
        errs, shares, rels = {}, {}, {}
        for what in got:
            _require(bool(torch.isfinite(got[what]).all()),
                     f"flash {name}: {what} not finite")
            errs[what] = _rel_err(got[what], want[what])[0]
            shares[what] = _row_share(got[what], want[what], rtol,
                                      atol).max().item()
            rels[what] = _row_rel(got[what], want[what], rtol, atol)
        lse_err = (lse - lse_r).abs().max().item()
        skips = (_tile_skip_shares(fa, q, k, v, dout, lse_r, delta, got,
                                   want, args, rtol, atol)
                 if timed else None)
        print(json.dumps({"flash_case": name, "row_share_max": shares,
                          "row_rel_l2_max": rels, "lse_err": lse_err,
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
        lib_fwd = _time_ms(lambda _=0: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        lib_bwd = _time_ms(lambda _=0: torch.autograd.grad(
            lib_out, (qg, kg, vg), dout, retain_graph=True))
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
                plain_ms=(_time_ms(plain, iters=3, warmup=1) if plain
                          else plain_bwd),
                library_ms=lib_ms, bound_ms=bound, bound_by=by)

    case("B=8 H=16 T=1024 D=64 bf16 causal", 8, 16, 1024, 1024, True,
         timed=True)
    case("B=2 H=16 T=1024 D=64 bf16 non-causal", 2, 16, 1024, 1024, False)
    case("B=2 H=16 T=1000 D=64 bf16 causal (T not a tile multiple)", 2, 16,
         1000, 1000, True)
    case("B=2 H=16 Tq=200 Tk=1000 D=64 bf16 causal, query_offset=700", 2,
         16, 200, 1000, True, q_off=700)
    # the other head_dim instantiations and float32, once each
    case("B=1 H=4 T=300 D=128 bf16 causal", 1, 4, 300, 300, True, d=128)
    case("B=1 H=4 T=200 D=32 f32 non-causal", 1, 4, 200, 200, False, d=32,
         dtype=torch.float32)
    case("B=1 H=4 Tq=64 Tk=96 D=16 f32 causal, key_offset=40", 1, 4, 64, 96,
         True, k_off=40, d=16, dtype=torch.float32)
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


#: per-channel tolerance of the BatchNorm reductions (B7, B9): each of
#: sum(x), sum(x^2), dgamma and dbeta within BN_RTOL x the sum of its
#: terms' magnitudes of the plain version's. The kernels and the plain
#: sums differ only in the order of float32 additions; in the main case
#: a sum that leaves out one of the kernel's row blocks must fail it
BN_RTOL = 1e-5
#: (rows, channels, dtype, relu, residual, what): the path's shapes at
#: batch 128 x 224 px, the main case first, then ragged float32 cases
#: (a row count no block size divides; C = 100 takes the one-element
#: path, C = 96 the 16-byte one)
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
)


def _bitwise(a, b):
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return a.dtype == b.dtype and bool(torch.equal(
        a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def _bn_reading(got, want, terms_abs):
    """Largest per-channel error as a share of the sum of the terms'
    magnitudes (a reading of at most BN_RTOL passes)."""
    return ((got - want).abs() / terms_abs.clamp_min(1e-30)).max().item()


def _bn_skip_reading(terms, terms_abs, rows_per_block):
    """What the per-channel check reads on a sum that leaves out one row
    block of the kernel's: the least, over the blocks, of the block's
    largest per-channel share. Above BN_RTOL, leaving out any one block
    fails the check."""
    n, c = terms.shape
    pad = (-n) % rows_per_block
    blocks = torch.cat([terms, terms.new_zeros(pad, c)]).reshape(
        -1, rows_per_block, c).sum(1)
    return (blocks.abs() / terms_abs.clamp_min(1e-30)).amax(1).min().item()


def check_batchnorm(seed):
    """B7-B10 at the ResNet-50 path's shapes (``BN_CASES``). B8 and B10
    (dx and dres) must be bitwise equal to their plain versions; B7 and
    B9 are held per channel (``BN_RTOL``), and in the main case sums that
    leave out one row block of the kernel must fail that check. The
    per-channel constants between the kernels come from the plain
    version's sums, so each kernel sees the same inputs as its plain
    version. The bf16 cases are timed: the kernel, its plain version and
    one PyTorch call as a yardstick (``torch.var_mean`` for B7, the
    training forward of ``F.batch_norm`` beside B7 + B8, its autograd
    backward beside B9 + B10)."""
    from horovod_tpu_torch.ops import batchnorm as bn

    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    out = {k: [] for k in ("bn_stats", "bn_apply", "bn_bwd_reduce",
                           "bn_bwd_dx")}
    eps = 1e-5
    for ci, (n, c, dtype, relu, has_res, what) in enumerate(BN_CASES):
        def mk(scale=1.0, shift=0.0):
            return (torch.randn(n, c, generator=g, device="cuda") * scale
                    + shift).to(dtype)
        x, dy = mk(2.0, 0.5), mk()
        res = mk() if has_res else None
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device="cuda")
        beta = 0.1 * torch.randn(c, generator=g, device="cuda")
        xf = x.float()
        # B7
        ks, kq = bn.bn_stats_cuda(x)
        ps, pq = bn.bn_stats_ref(x)
        # the constants, in the order of the autograd function
        nf = float(n)
        mean = ps / nf
        var = torch.clamp(pq / nf - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        s, t = gamma * rstd, beta - mean * (gamma * rstd)
        u, w = rstd, -mean * rstd
        # B8, B9
        ky = bn.bn_apply_cuda(x, s, t, res, relu)
        py = bn.bn_apply_ref(x, s, t, res, relu)
        kg, kb = bn.bn_bwd_reduce_cuda(x, dy, res, s, t, u, w, relu)
        pg, pb = bn.bn_bwd_reduce_ref(x, dy, res, s, t, u, w, relu)
        # B10
        a = gamma * rstd
        b = rstd * (-a * pg / nf)
        cc = -a * pb / nf - (-mean * rstd) * a * pg / nf
        kdx, kdres = bn.bn_bwd_dx_cuda(x, dy, res, s, t, a, b, cc, relu)
        pdx, pdres = bn.bn_bwd_dx_ref(x, dy, res, s, t, a, b, cc, relu)
        torch.cuda.synchronize()

        dye = bn._dy_eff(x, dy, res, s, t, relu)
        terms = {"sum": xf, "sumsq": xf * xf, "dgamma": dye * (xf * u + w),
                 "dbeta": dye}
        absum = {k: v.abs().sum(0) for k, v in terms.items()}
        got = {"sum": ks, "sumsq": kq, "dgamma": kg, "dbeta": kb}
        want = {"sum": ps, "sumsq": pq, "dgamma": pg, "dbeta": pb}
        reads = {k: _bn_reading(got[k], want[k], absum[k]) for k in got}
        vec = bn.vector_width(c, dtype, x)
        rows_per_block, blocks = bn.reduce_geometry(n, c, vec)
        skips = ({k: _bn_skip_reading(terms[k], absum[k], rows_per_block)
                  for k in terms} if ci == 0 else None)
        bitwise = {"y": _bitwise(ky, py), "dx": _bitwise(kdx, pdx),
                   "dres": (None if res is None else _bitwise(kdres, pdres))}
        print(json.dumps({"bn_case": what, "rows": n, "channels": c,
                          "vec": vec, "rows_per_block": rows_per_block,
                          "blocks": blocks, "rtol": BN_RTOL,
                          "reduce_reading": reads, "skip_reading": skips,
                          "bitwise": bitwise}))
        for k, r in reads.items():
            _require(r <= BN_RTOL, f"batchnorm {what}: {k} reads {r:.2e} of "
                                   f"its terms' magnitude > {BN_RTOL}")
        for k, r in (skips or {}).items():
            _require(r > BN_RTOL, f"batchnorm {what}: a {k} that leaves out "
                                  f"one row block reads {r:.2e} <= "
                                  f"{BN_RTOL} and would pass")
        for k, ok in bitwise.items():
            _require(ok is not False, f"batchnorm {what}: {k} is not bitwise "
                                      "equal to the plain version")
        for k, v in (("y", ky), ("dx", kdx)):
            _require(bool(torch.isfinite(v).all()),
                     f"batchnorm {what}: {k} not finite")
        rows = {
            "bn_stats": {"max_abs_err": max((ks - ps).abs().max().item(),
                                            (kq - pq).abs().max().item()),
                         "tol": f"per channel <= {BN_RTOL} x sum |terms|",
                         "reading": {k: reads[k] for k in ("sum", "sumsq")}},
            "bn_apply": {"max_abs_err": (ky.float() - py.float()).abs().max()
                         .item(), "tol": "bitwise"},
            "bn_bwd_reduce": {
                "max_abs_err": max((kg - pg).abs().max().item(),
                                   (kb - pb).abs().max().item()),
                "tol": f"per channel <= {BN_RTOL} x sum |terms|",
                "reading": {k: reads[k] for k in ("dgamma", "dbeta")}},
            "bn_bwd_dx": {"max_abs_err": (kdx.float() - pdx.float()).abs()
                          .max().item(), "tol": "bitwise (dx, dres)"},
        }
        for kname, row in rows.items():
            row["case"] = f"[{n}, {c}] {str(dtype)[6:]}: {what}"
            if skips:
                row["skip_reading"] = skips
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
            "bn_stats": (big + 2 * c * 4, 3 * n * c),
            "bn_apply": ((2 + nres) * big + 2 * c * 4, (3 + nres) * n * c),
            "bn_bwd_reduce": ((2 + mask_res) * big + 6 * c * 4, 9 * n * c),
            "bn_bwd_dx": ((3 + mask_res + nres) * big + 5 * c * 4,
                          9 * n * c),
        }
        calls = {
            "bn_stats": (lambda _=0: bn.bn_stats_cuda(x),
                         lambda _=0: bn.bn_stats_ref(x)),
            "bn_apply": (lambda _=0: bn.bn_apply_cuda(x, s, t, res, relu),
                         lambda _=0: bn.bn_apply_ref(x, s, t, res, relu)),
            "bn_bwd_reduce": (
                lambda _=0: bn.bn_bwd_reduce_cuda(x, dy, res, s, t, u, w,
                                                  relu),
                lambda _=0: bn.bn_bwd_reduce_ref(x, dy, res, s, t, u, w,
                                                 relu)),
            "bn_bwd_dx": (
                lambda _=0: bn.bn_bwd_dx_cuda(x, dy, res, s, t, a, b, cc,
                                              relu),
                lambda _=0: bn.bn_bwd_dx_ref(x, dy, res, s, t, a, b, cc,
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
            "bn_stats": _device_ms(lambda _=0: torch.var_mean(
                x, dim=0, correction=0), iters=20),
            "bn_apply": _device_ms(lambda _=0: F.batch_norm(
                xn, None, None, gamma, beta, training=True, eps=eps),
                iters=20),
            "bn_bwd_reduce": lib_bwd, "bn_bwd_dx": lib_bwd,
        }
        covers = {"bn_stats": "torch.var_mean",
                  "bn_apply": "F.batch_norm training fwd (B7 + B8)",
                  "bn_bwd_reduce": "F.batch_norm bwd (B9 + B10)",
                  "bn_bwd_dx": "F.batch_norm bwd (B9 + B10)"}
        for kname, (kern, plain) in calls.items():
            bound, by = _bound(*work[kname], "f32")
            out[kname][-1].update(
                ms=_device_ms(kern, iters=20),
                plain_ms=_device_ms(plain, iters=5),
                library_ms=lib[kname], library_call=covers[kname],
                bound_ms=bound, bound_by=by)
        del yl, xg
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
    early in every block (the last 32 queries add nothing to dK, dV);
    ``ln_last_block``: B5's column sums stop one block short (the last
    block's rows add nothing to dgamma, dbeta)."""
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import layernorm as ln

    if name == "dkv_last_q_tile":
        mod, attr = fa, "flash_bwd_dkv_cuda"
        orig = fa.flash_bwd_dkv_cuda

        def faulty(q, k, v, dout, lse, delta, causal, scale, q_off=0,
                   k_off=0):
            dk, dv = orig(q, k, v, dout, lse, delta, causal, scale, q_off,
                          k_off)
            q0 = q.shape[2] - FLASH_TILE
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
            rows = -(-n // min(n, ln._BWD_MAX_BLOCKS))
            last = n - (-(-n // rows) - 1) * rows
            _, pg, pb = ln.layer_norm_bwd_ref(x2[-last:], dy2[-last:], gamma,
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
    fault, for GPT-2 medium and then for ResNet-50. Prints one summary
    line for each; enforces nothing."""
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


def profile_train_step(step, tokens):
    """Where one training step's device time goes: ``torch.profiler``
    over one step; kernels by device time and the device busy share
    (kernel time over wall time, a lower bound: the profiler adds host
    time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernel_events(prof)
    busy_us = sum(_dev_us(e) for e in kernels)
    top = sorted(kernels, key=_dev_us, reverse=True)[:12]
    groups = {}
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
    print(json.dumps({
        "profile": "one GPT-2-medium training step, batch 8x1024",
        "wall_ms": wall * 1e3, "device_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernels": sum(e.count for e in kernels),
        "device_ms_by_group": groups,
        "top": [{"name": e.key[:70], "ms": _dev_us(e) / 1e3,
                 "calls": e.count} for e in top]}))


def train_gpt2(seed, ledger):
    """Train GPT-2 medium at full width and depth through the example's
    ``main``: world of one over NCCL, per-rank batch 8 x 1024, flash
    attention and fused norms, 1 warm-up and 5 timed steps on one
    batch. Launch counts are zeroed just before and read just after."""
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
    ``bn_reduce_last_block``: B9's column sums stop one row block short;
    ``bn_reduce_mask_no_residual``: B9 recomputes the ReLU mask without
    the residual; ``bn_dx_dres_unmasked``: B10 writes dres = dy, not
    the masked dy_eff."""
    from horovod_tpu_torch.ops import batchnorm as bn

    if name == "bn_reduce_last_block":
        attr, orig = "bn_bwd_reduce_cuda", bn.bn_bwd_reduce_cuda

        def faulty(x2, dy2, res2, s, t, u, w, relu):
            dg, db = orig(x2, dy2, res2, s, t, u, w, relu)
            n, c = x2.shape
            rows, blocks = bn.reduce_geometry(
                n, c, bn.vector_width(c, x2.dtype, x2, dy2, res2))
            tail = slice((blocks - 1) * rows, None)
            pg, pb = bn.bn_bwd_reduce_ref(
                x2[tail], dy2[tail], None if res2 is None else res2[tail],
                s, t, u, w, relu)
            return dg - pg, db - pb
    elif name == "bn_reduce_mask_no_residual":
        attr, orig = "bn_bwd_reduce_cuda", bn.bn_bwd_reduce_cuda

        def faulty(x2, dy2, res2, s, t, u, w, relu):
            return orig(x2, dy2, None, s, t, u, w, relu)
    elif name == "bn_dx_dres_unmasked":
        attr, orig = "bn_bwd_dx_cuda", bn.bn_bwd_dx_cuda

        def faulty(x2, dy2, res2, s, t, a, b, c, relu):
            dx, dres = orig(x2, dy2, res2, s, t, a, b, c, relu)
            return dx, None if dres is None else dy2.clone()
    else:
        raise ValueError(f"unknown fault {name!r}")
    setattr(bn, attr, faulty)
    try:
        yield
    finally:
        setattr(bn, attr, orig)


def profile_resnet_step(step, batch):
    """Where one ResNet-50 training step's device time goes, by group:
    cuDNN convolutions, the BatchNorm kernels, the optimizer, casts and
    other elementwise work; with the device busy share (kernel time over
    wall time, a lower bound: the profiler adds host time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernel_events(prof)
    busy_us = sum(_dev_us(e) for e in kernels)
    top = sorted(kernels, key=_dev_us, reverse=True)[:12]
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
        "top": [{"name": e.key[:70], "ms": _dev_us(e) / 1e3,
                 "calls": e.count} for e in top]}))


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
    profile_resnet_step(stats["step"], stats["batch"])
    stats.clear()
    hvd.shutdown()
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
    kernels = _kernel_events(prof)
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
    del engine


# ---------------------------------------------------------------------------

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
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parity-sweep", type=int, default=0, metavar="N",
                    help="only build the kernels and print the step-1 "
                         "parity readings of seeds 0..N-1 and of the "
                         "injected faults (the limits' evidence)")
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
    }
    for name, cases in checks.items():
        for c in cases:
            print(json.dumps({"kernel": name, **c}))

    # phases 4 and 5: training; phases 6 and 7: serving
    ledger = {}
    train_gpt2(args.seed, ledger)
    train_resnet(args.seed, ledger)
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
            "cases": cases,
        })
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
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
