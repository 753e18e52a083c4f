"""One rank of the port's eager-runtime worlds (tests/test_torch_eager_e2e.py).

Started once per rank with the launcher's slot environment
(``runner/exec_run.slot_env``: the ``HOROVOD_*`` topology, the TCP
store's address and the native coordinator's) and ``HVD_TPU_NATIVE=1``.
It drives the public API, as the JAX package's
``tests/native_eager_worker.py`` does: ``hvd.init(device="cpu")`` starts
the runtime over gloo, and the collectives enqueue through it with
rank-distinct values and rank-different enqueue orders, the hazards
negotiation exists to remove. Prints one ``RESULT {json}`` line.

    python tests/torch_native_eager_worker.py api|stall|crash
"""

import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _f32(shape, value):
    return torch.full(shape, float(value), dtype=torch.float32)


@contextlib.contextmanager
def _without_runtime():
    """Build an object as if the runtime were off (the optimizer's hook
    path, to hold the runtime's path against it)."""
    from horovod_tpu_torch.core.state import global_state

    st = global_state()
    rt, st.eager_runtime = st.eager_runtime, None
    try:
        yield
    finally:
        st.eager_runtime = rt


def _train(hvd, rank, steps=3):
    """A few SGD steps of a small model through the DistributedOptimizer
    (several buckets at a 2 KiB fusion threshold); its parameters."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 24), torch.nn.Tanh(),
                                torch.nn.Linear(24, 12), torch.nn.Tanh(),
                                torch.nn.Linear(12, 4))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        fusion_threshold_bytes=2048)
    g = torch.Generator().manual_seed(100 + rank)
    for _ in range(steps):
        x = torch.randn(8, 16, generator=g)
        opt.zero_grad()
        model(x).pow(2).sum().backward()
        opt.step()
    return opt, [p.detach().clone() for p in model.parameters()]


def api(hvd, st, rank, size):
    out = {"rank": rank}
    rt = st.eager_runtime
    s_world = sum(r + 1 for r in range(size))

    # 1. out-of-order enqueue with distinct values
    names = ["grad_a", "grad_b", "grad_c", "grad_d"]
    order = list(range(4)) if rank % 2 == 0 else list(reversed(range(4)))
    handles = {i: hvd.allreduce_async(_f32((4, 3), (rank + 1) * (i + 1)),
                                      name=names[i], op=hvd.Sum)
               for i in order}
    res = {i: hvd.synchronize(handles[i]) for i in order}
    out["allreduce_ok"] = all(
        torch.equal(res[i], _f32((4, 3), s_world * (i + 1)))
        for i in range(4))

    # 2. averaged allreduce with a prescale
    avg = hvd.allreduce(_f32((8,), rank + 1), average=True, name="avg_t",
                        prescale_factor=2.0)
    out["average_ok"] = bool(torch.allclose(
        avg, _f32((8,), 2.0 * s_world / size)))

    # 3. ragged allgather
    g = hvd.allgather(_f32((rank + 2, 2), rank), name="rag")
    out["allgather_ok"] = torch.equal(
        g, torch.cat([_f32((r + 2, 2), r) for r in range(size)]))

    # 4. broadcast from a non-zero root
    b = hvd.broadcast(_f32((5,), rank * 10 + 7), root_rank=size - 1,
                      name="bc")
    out["broadcast_ok"] = torch.equal(b, _f32((5,), (size - 1) * 10 + 7))

    # 5. reducescatter (average)
    d0 = 2 * size
    base = torch.arange(d0 * 3, dtype=torch.float32).reshape(d0, 3)
    rs = hvd.reducescatter(base * (rank + 1), name="rs")
    want = (base * s_world / size)[rank * 2:(rank + 1) * 2]
    out["reducescatter_ok"] = bool(torch.allclose(rs, want))

    # 6. uneven alltoall: rank r sends (j+1) rows stamped [r, j] to j
    splits = [j + 1 for j in range(size)]
    t = torch.cat([torch.tensor([[rank, j]], dtype=torch.float32)
                   .repeat(n, 1) for j, n in enumerate(splits)])
    recv, recv_splits = hvd.alltoall(t, splits=splits, name="a2a")
    expect = torch.cat([torch.tensor([[s, rank]], dtype=torch.float32)
                        .repeat(rank + 1, 1) for s in range(size)])
    out["alltoall_ok"] = (torch.equal(recv, expect)
                          and recv_splits.tolist() == [rank + 1] * size
                          and recv_splits.dtype == torch.int32)

    # 6a. sparse allreduce with rank-distinct nnz: values and indices
    # ride the negotiated ragged allgather
    nnz = rank + 1
    sl = hvd.IndexedSlices(_f32((nnz, 2), rank + 1),
                           torch.arange(nnz) * 2 + rank, (12, 2))
    from horovod_tpu_torch.ops.sparse import sparse_to_dense

    dense = sparse_to_dense(hvd.sparse_allreduce(sl, op=hvd.Sum))
    want = torch.zeros(12, 2)
    for r in range(size):
        for k in range(r + 1):
            want[k * 2 + r] += r + 1
    out["sparse_ok"] = torch.equal(dense, want)

    # 6b. grouped allreduce: one all-or-nothing group, fused
    gres = hvd.synchronize(hvd.grouped_allreduce_async(
        [_f32((3,), (rank + 1) * (i + 1)) for i in range(3)], op=hvd.Sum,
        name="gblk"))
    out["grouped_ok"] = all(
        torch.equal(gres[i], _f32((3,), s_world * (i + 1)))
        for i in range(3))
    sres = hvd.grouped_allreduce(
        [_f32((4,), (rank + 1) * (i + 1)) for i in range(2)], op=hvd.Sum,
        name="gsync")
    out["grouped_sync_ok"] = all(
        torch.equal(sres[i], _f32((4,), s_world * (i + 1)))
        for i in range(2))

    # 6b'. grouped allgather and reducescatter
    ag = hvd.grouped_allgather([_f32((2, 2), rank * 10 + i)
                                for i in range(2)], name="gag")
    out["grouped_allgather_ok"] = all(
        torch.equal(ag[i], torch.cat([_f32((2, 2), r * 10 + i)
                                      for r in range(size)]))
        for i in range(2))
    rs_in = [torch.arange(d0 * (i + 1), dtype=torch.float32).reshape(
        d0, i + 1) * (rank + 1) for i in range(2)]
    rsg = hvd.grouped_reducescatter(rs_in, op=hvd.Sum, name="grs")
    full = [torch.arange(d0 * (i + 1), dtype=torch.float32).reshape(
        d0, i + 1) * s_world for i in range(2)]
    out["grouped_reducescatter_ok"] = all(
        torch.equal(rsg[i], full[i][rank * 2:(rank + 1) * 2])
        for i in range(2))

    # 6b''. the plan cache over the torch.distributed executor:
    # rank-different submit order, rank-distinct values, bitwise equal
    # results once negotiation is bypassed
    fp_names = ["fp_a", "fp_b", "fp_c"]
    fp_order = list(range(3)) if rank % 2 == 0 else [2, 1, 0]
    fp_in = [_f32((16,), (rank + 1) * (i + 1)) for i in range(3)]
    steps = []
    for _ in range(12):
        hs = {i: hvd.allreduce_async(fp_in[i], name=fp_names[i],
                                     op=hvd.Sum)
              for i in fp_order}
        steps.append([hvd.synchronize(hs[i]) for i in range(3)])
    fp = rt.fast_path_stats()
    out["fast_path_ok"] = bool(
        fp["active"] and fp["steps"] > 0
        and all(torch.equal(r[i], steps[0][i]) for r in steps
                for i in range(3))
        and torch.equal(steps[0][0], _f32((16,), s_world)))

    # 6b'''. the DistributedOptimizer through the runtime against its
    # hook path on the same model, data and seed; the executor's
    # batches a step say whether the controller fused the buckets
    before = rt.metrics_snapshot()["executor_batches"]
    opt, mine = _train(hvd, rank)
    batches = rt.metrics_snapshot()["executor_batches"] - before
    with _without_runtime():
        hook_opt, hooks = _train(hvd, rank)
    assert opt._rt is rt and hook_opt._rt is None
    num = sum(float((a - b).double().pow(2).sum())
              for a, b in zip(mine, hooks))
    den = sum(float(b.double().pow(2).sum()) for b in hooks)
    out["optimizer"] = {
        "bitwise": all(torch.equal(a, b) for a, b in zip(mine, hooks)),
        "rel_l2": (num / den) ** 0.5, "buckets": len(opt.bucket_plan),
        "batches_per_step": batches / 3}

    # 6b''''. the int8 + error-feedback wire, bitwise the port's
    # emulated composition of the same fused buffers and residuals
    from horovod_tpu_torch.ops.quantized_collectives import \
        emulated_quantized_psum

    rng = np.random.RandomState(42)
    block = 16
    flats = [torch.from_numpy(rng.uniform(-1, 1, 513).astype(np.float32))
             * (r + 1) for r in range(size)]
    from horovod_tpu_torch.optim.compression import WireSpec

    rt.set_wire(WireSpec("int8", block, error_feedback=True))
    res_all = [None] * size
    wire_ok = True
    for step in range(3):
        xs = [f * (step + 1) for f in flats]
        got = hvd.allreduce(xs[rank], op=hvd.Sum, name="wire_q")
        want, errs = emulated_quantized_psum(
            xs, size, block,
            [r if r is not None else torch.zeros(513) for r in res_all])
        res_all = errs
        mine_res = next(iter(rt._executor._wire_residuals.values()))
        wire_ok = wire_ok and torch.equal(got, want[rank]) and \
            torch.equal(mine_res, errs[rank])
    rt.set_wire("none")
    exact = hvd.allreduce(flats[rank], op=hvd.Sum, name="wire_n")
    wire_ok = wire_ok and bool(torch.allclose(exact, sum(flats)))
    out["int8_wire_ok"] = bool(wire_ok)

    # 6d. the executor's two-level route (taken where the controller
    # stamps a hierarchy block, under autotune) against its flat route
    # on the same batch, at world 4 as 2 x 2
    if size == 4:
        from horovod_tpu_torch._native import ExecutionBatch
        from horovod_tpu_torch.ops import hierarchical

        hierarchical.block_sets(2)  # collective, ahead of the executor

        def batch(tuned):
            return ExecutionBatch(
                batch_id=0, op=0, reduce_op=0, root_rank=0, prescale=2.0,
                postscale=0.5, dtype="float32", total_bytes=64,
                names=["h"], handles=[0], first_shape=[16],
                error_reason="", shapes=[[16]], tuned_hierarchical=tuned,
                tuned_hier_block=2 if tuned else 0)

        x = torch.from_numpy(np.random.RandomState(rank).randn(16)
                             .astype(np.float32))
        two = rt._executor(batch(True), {"h": x})["h"]
        flat = rt._executor(batch(False), {"h": x})["h"]
        out["two_level_ok"] = bool(torch.allclose(two, flat, rtol=1e-6,
                                                  atol=1e-6))
    else:
        out["two_level_ok"] = True

    # 6c. process sets through the negotiated path (worlds >= 3)
    if size >= 3:
        ps = hvd.add_process_set([0, size - 1])
        ps_ok = True
        if rank in (0, size - 1):
            red = hvd.allreduce(_f32((4,), rank + 1), op=hvd.Sum,
                                process_set=ps, name="sub")
            ps_ok = ps_ok and torch.equal(red, _f32((4,), 1.0 + size))
            b = hvd.broadcast(_f32((3,), rank * 100), root_rank=size - 1,
                              process_set=ps, name="sub_bc")
            ps_ok = ps_ok and torch.equal(b, _f32((3,), (size - 1) * 100))
            local = ps.rank(rank)
            g2 = hvd.allgather(_f32((local + 1, 2), rank), process_set=ps,
                               name="sub_rag")
            ps_ok = ps_ok and torch.equal(g2, torch.cat(
                [_f32((i + 1, 2), r) for i, r in enumerate(ps.ranks)]))
            sp = [j + 1 + local for j in range(ps.size())]
            ta = torch.cat([torch.tensor([[rank, j]], dtype=torch.float32)
                            .repeat(n, 1) for j, n in enumerate(sp)])
            ra, rsp = hvd.alltoall(ta, splits=sp, process_set=ps,
                                   name="sub_a2a")
            ps_ok = ps_ok and torch.equal(ra, torch.cat(
                [torch.tensor([[gr, local]], dtype=torch.float32)
                 .repeat(local + 1 + i, 1) for i, gr in enumerate(ps.ranks)]
            )) and rsp.tolist() == [local + 1 + i for i in range(ps.size())]
        glob = hvd.allreduce(_f32((2,), rank + 1), op=hvd.Sum,
                             name="after_sub")
        out["process_set_ok"] = bool(ps_ok and torch.equal(
            glob, _f32((2,), s_world)))
    else:
        out["process_set_ok"] = True

    # 7. join: rank 0 runs out of data; the others keep reducing with
    # zeros from it, and their active plan falls back (peer_join)
    for _ in range(6):
        hvd.allreduce(_f32((4,), rank + 1), op=hvd.Sum, name="jp")
    join_ok = rt.fast_path_stats()["active"]
    if rank == 0:
        out["join_ok"] = bool(join_ok and hvd.join() == 0)
    else:
        time.sleep(0.5)
        expect = _f32((4,), sum(r + 1 for r in range(1, size)))
        for _ in range(2):
            red = hvd.allreduce(_f32((4,), rank + 1), op=hvd.Sum, name="jp")
            join_ok = join_ok and torch.equal(red, expect)
        s_fp = rt.fast_path_stats()
        join_ok = join_ok and (s_fp["last_invalidation"] == "peer_join"
                               and not s_fp["active"])
        tail = hvd.allreduce(_f32((3,), rank + 1), op=hvd.Sum, name="tail")
        out["join_ok"] = bool(join_ok and torch.equal(
            tail, _f32((3,), sum(r + 1 for r in range(1, size))))
            and hvd.join() == 0)

    # 8. barrier and the runtime's stats
    hvd.barrier()
    out["cache_hits"] = int(rt.cache_hits())
    out["bytes_negotiated"] = int(rt.bytes_negotiated())
    out["coordinator_port"] = rt.coordinator_port
    out["bound_port"] = rt.bound_port()
    return out


def stall(hvd, st, rank, size):
    """Rank 1 stops submitting; rank 0's watchdog (HOROVOD_STALL_ABORT_S)
    raises HorovodInternalError there."""
    from horovod_tpu_torch.core.exceptions import HorovodInternalError

    hvd.allreduce(_f32((4,), 1), op=hvd.Sum, name="warm")
    if rank != 0:
        time.sleep(3)
        return {"rank": rank, "slept": True}
    t0 = time.monotonic()
    try:
        hvd.allreduce(_f32((4,), 1), op=hvd.Sum, name="never")
        return {"rank": rank, "raised": None}
    except HorovodInternalError as e:
        return {"rank": rank, "raised": str(e),
                "seconds": time.monotonic() - t0}


def crash(hvd, st, rank, size):
    """Rank 1 dies after one collective; the survivors' next collective
    raises HorovodInternalError."""
    import signal

    from horovod_tpu_torch.core.exceptions import HorovodInternalError

    hvd.allreduce(_f32((4,), 1), op=hvd.Sum, name="warm")
    hvd.barrier()
    if rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(0.5)
    try:
        hvd.allreduce(_f32((4,), 1), op=hvd.Sum, name="after")
        return {"rank": rank, "raised": None}
    except HorovodInternalError as e:
        return {"rank": rank, "raised": str(e)}


def main():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state

    scenario = sys.argv[1]
    hvd.init(device="cpu")
    st = global_state()
    assert st.eager_runtime is not None, "the eager runtime is not live"
    rank, size = hvd.rank(), hvd.size()
    out = {"api": api, "stall": stall, "crash": crash}[scenario](
        hvd, st, rank, size)
    print("RESULT " + json.dumps(out), flush=True)
    if scenario == "api":
        hvd.shutdown()
    else:
        # the world is broken: no negotiated shutdown can complete
        os._exit(0)


if __name__ == "__main__":
    main()
