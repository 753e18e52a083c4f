"""The port's elastic state (horovod_tpu_torch.elastic.state) against
the JAX package's:

* ``ObjectState`` and ``TorchState`` commit, restore and sync on a gloo
  world of 2: after ``sync()`` every rank holds rank 0's values bitwise
  (a module's parameters, Adam's state, a tensor, plain values), and
  ``restore()`` returns to the last commit bitwise;
* ``run``: ``HorovodInternalError`` restores the last commit and joins
  the world again (on the gloo world of 2 too, both ranks failing
  together), ``HostsUpdatedInterrupt`` re-syncs without restoring,
  ``HOROVOD_RESET_LIMIT`` stops the loop; the same scripted ``train``
  through the JAX package's ``run`` with an ``ObjectState`` ends with
  the same values, the same entries and the same resets;
* a SIGTERM delivered inside ``optimizer.step()`` (the handler's exit
  hook records the code instead of exiting) writes the last commit, so
  a restore from the emergency file is that commit bitwise and never the
  torn parameters;
* a peer killed mid-collective becomes ``HorovodInternalError`` on gloo,
  in the blocking allreduce, a handle's ``synchronize`` and the
  DistributedOptimizer's bucket wait.
"""

import os
import pathlib
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch.core.exceptions import (HorovodInternalError,
                                               HostsUpdatedInterrupt)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

_WORKER = r'''
import os, sys, time
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch.core.exceptions import HorovodInternalError

out, mode = sys.argv[1], sys.argv[2]
hvd.init(device="cpu")
rank = hvd.rank()
res = {}


def bits(t):
    return t.detach().reshape(-1).view(torch.uint8).clone()


def snap(state):
    d = {"m." + k: bits(v) for k, v in state.model.state_dict().items()}
    for pid, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            d[f"o.{pid}.{k}"] = bits(v)
    d["t"] = bits(state.t)
    d["step"], d["name"] = state.step, state.name
    return d


if mode == "state":
    g = torch.Generator().manual_seed(10 + rank)
    model = torch.nn.Linear(4, 3).to(torch.bfloat16)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    model(torch.randn(2, 4, generator=g).to(torch.bfloat16)).float() \
        .sum().backward()
    opt.step()
    state = elastic.TorchState(model=model, optimizer=opt,
                               t=torch.full((3,), float(rank)),
                               step=7 * rank, name=f"r{rank}")
    res["before"] = snap(state)
    state.sync()
    res["synced"] = snap(state)
    state.commit()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        state.t.add_(5.0)
    model(torch.ones(2, 4).to(torch.bfloat16)).float().sum().backward()
    opt.step()
    state.step, state.name = 99, "changed"
    state.restore()
    res["restored"] = snap(state)
    res["grads_dropped"] = all(p.grad is None for p in model.parameters())
    obj = elastic.ObjectState(value=[rank, rank * 2], epoch=rank)
    obj.sync()
    res["object"] = (obj.value, obj.epoch)
elif mode == "reset":
    state = elastic.ObjectState(value=1, epoch=0)
    entries, resets = [], []
    state.register_reset_callbacks([lambda: resets.append(hvd.size())])

    @elastic.run
    def train(state):
        entries.append((state.value, state.epoch, hvd.size()))
        while state.epoch < 5:
            s = hvd.allreduce(torch.tensor([float(state.value)]),
                              op=hvd.Sum)
            state.value = int(s.item()) + state.epoch
            state.epoch += 1
            if state.epoch == 3 and len(entries) == 1:
                raise HorovodInternalError("both ranks fail at epoch 3")
            state.commit()
        return state.value

    res["final"] = train(state)
    res["entries"], res["resets"] = entries, resets
elif mode == "peer":
    x = torch.ones(1000)
    hvd.allreduce(x)
    if rank == 1:
        os._exit(3)
    time.sleep(1.0)
    for what, fn in (
            ("allreduce", lambda: hvd.allreduce(x)),
            ("synchronize", lambda: hvd.synchronize(
                hvd.allreduce_async(x))),
            ("optimizer", None)):
        try:
            if fn is None:
                model = torch.nn.Linear(8, 8)
                opt = hvd.DistributedOptimizer(
                    torch.optim.SGD(model.parameters(), lr=0.1),
                    named_parameters=model.named_parameters())
                model(torch.ones(2, 8)).sum().backward()
                opt.step()
            else:
                fn()
            res[what] = "no error"
        except HorovodInternalError as e:
            res[what] = "HorovodInternalError"
        except Exception as e:
            res[what] = type(e).__name__ + ": " + str(e)[:200]
torch.save(res, out + "/%s_rank%d.pt" % (mode, rank))
if mode == "peer":
    os._exit(0)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(out, mode, n=2, timeout=120):
    port = _free_port()
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(out), mode], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    return procs, outs


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic_state")
    res = {}
    for mode in ("state", "reset"):
        procs, outs = _world(out, mode)
        for p, o in zip(procs, outs):
            assert p.returncode == 0, o
        res[mode] = [torch.load(out / f"{mode}_rank{r}.pt",
                                weights_only=False) for r in range(2)]
    procs, outs = _world(out, "peer")
    assert procs[1].returncode == 3 and procs[0].returncode == 0, outs
    res["peer"] = torch.load(out / "peer_rank0.pt", weights_only=False)
    return res


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_sync_gives_every_rank_rank0s_state_bitwise(gloo):
    r0, r1 = gloo["state"]
    _same(r0["synced"], r0["before"])
    _same(r1["synced"], r0["before"])
    assert not torch.equal(r1["before"]["m.weight"],
                           r0["before"]["m.weight"])
    for r in (r0, r1):
        assert r["object"] == ([0, 0], 0)


def test_restore_returns_to_the_commit_bitwise(gloo):
    for r in gloo["state"]:
        _same(r["restored"], r["synced"])
        assert r["grads_dropped"]


def test_reset_on_the_gloo_world_rejoins_and_replays(gloo):
    """Both ranks fail at epoch 3: each restores its commit of epoch 2,
    the world is joined again and the epochs replay."""
    r0, r1 = gloo["reset"]
    assert r0["final"] == r1["final"]
    assert r0["entries"] == r1["entries"]
    assert [e[1] for e in r0["entries"]] == [0, 2]
    assert r0["resets"] == [2] and r1["resets"] == [2]
    # the uninterrupted value: v <- 2v + epoch, five times from 1
    v = 1
    for epoch in range(5):
        v = 2 * v + epoch
    assert r0["final"] == v


def test_peer_death_is_horovod_internal_error(gloo):
    assert gloo["peer"] == {"allreduce": "HorovodInternalError",
                            "synchronize": "HorovodInternalError",
                            "optimizer": "HorovodInternalError"}


# ---------------------------------- run() against the JAX package's run


def _scripted(run, ObjectState, internal, updated, events):
    """One scripted train through ``run``: a HorovodInternalError at
    epoch 2 on the first entry (restore, reset), a HostsUpdatedInterrupt
    at epoch 4 on the second (no restore, reset, sync)."""
    state = ObjectState(value=3, epoch=0)
    entries, resets = [], []
    state.register_reset_callbacks([lambda: resets.append(len(entries))])

    @run
    def train(state):
        entries.append((state.value, state.epoch))
        while state.epoch < 6:
            state.value = state.value * 3 - state.epoch
            state.epoch += 1
            if (len(entries), state.epoch) in events:
                raise (internal("lost a peer")
                       if events[(len(entries), state.epoch)] == "error"
                       else updated(skip_sync=False))
            state.commit()
        return state.value

    final = train(state)
    return final, entries, resets, (state.value, state.epoch)


_EVENTS = {(1, 2): "error", (2, 4): "hosts"}


@pytest.fixture(autouse=True)
def _no_preemption_handler():
    """``run`` arms the packages' SIGTERM handlers: disarm them after
    each test, as a process that leaves ``run`` would not need them."""
    from horovod_tpu.elastic import preemption as jax_preemption

    yield
    elastic.preemption.uninstall()
    jax_preemption.uninstall()


def test_run_matches_the_jax_run():
    import jax

    import horovod_tpu as jhvd
    from horovod_tpu.core.exceptions import (
        HorovodInternalError as JaxInternal,
        HostsUpdatedInterrupt as JaxUpdated)
    from horovod_tpu.elastic.state import ObjectState as JaxObjectState
    from horovod_tpu.elastic.state import run as jax_run

    hvd.init(device="cpu")
    try:
        mine = _scripted(elastic.run, elastic.ObjectState,
                         HorovodInternalError, HostsUpdatedInterrupt,
                         _EVENTS)
        assert hvd.is_initialized() and hvd.size() == 1
    finally:
        hvd.shutdown()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("hvd",))
    jhvd.init(mesh=mesh)
    try:
        theirs = _scripted(jax_run, JaxObjectState, JaxInternal,
                           JaxUpdated, _EVENTS)
    finally:
        jhvd.shutdown()
    assert mine == theirs
    final, entries, resets, _ = mine
    # the error restored epoch 1's commit; the interrupt kept epoch 4
    assert [e[1] for e in entries] == [0, 1, 4] and resets == [1, 2]


def test_reset_limit_stops_the_loop(monkeypatch):
    monkeypatch.setenv("HOROVOD_RESET_LIMIT", "2")
    hvd.init(device="cpu")
    try:
        calls = []

        @elastic.run
        def train(state):
            calls.append(state.value)
            raise HorovodInternalError("always")

        with pytest.raises(RuntimeError, match="reset limit 2"):
            train(elastic.ObjectState(value=1))
        assert calls == [1, 1]
    finally:
        hvd.shutdown()


def test_reinit_detaches_the_old_worlds_optimizer():
    """An elastic re-init keeps nothing of the old world: the wrapper's
    hooks go with the shutdown, and a new wrapper works."""
    from horovod_tpu_torch.optim import distributed

    hvd.init(device="cpu")
    try:
        model = torch.nn.Linear(4, 2)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        opt._size = 2  # as a world of two would have it
        opt._install_hooks()
        assert opt in distributed._LIVE and opt._hooks
        elastic.state._reinitialize()
        assert not opt._hooks and opt not in distributed._LIVE
        with pytest.raises(RuntimeError, match="shut down"):
            opt.synchronize()
        hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters()).step()
    finally:
        hvd.shutdown()


# --------------------------------------------- SIGTERM inside a step


class _HaltingSGD(torch.optim.SGD):
    """SGD whose step sends this process SIGTERM after updating its
    first parameter: the handler runs between two parameters' updates."""

    def step(self, closure=None):
        with torch.no_grad():
            for i, p in enumerate(self.param_groups[0]["params"]):
                p.add_(p.grad, alpha=-self.param_groups[0]["lr"])
                if i == 0:
                    os.kill(os.getpid(), signal.SIGTERM)


def test_sigterm_inside_a_step_writes_the_last_commit(tmp_path):
    from horovod_tpu_torch.elastic import preemption

    g = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5),
                                torch.nn.Linear(5, 2))
    opt = _HaltingSGD(model.parameters(), lr=0.5)
    state = elastic.TorchState(model=model, optimizer=opt, step=0)
    x = torch.randn(4, 6, generator=g)
    state.step = 1
    state.commit()
    committed = {k: v.clone() for k, v in model.state_dict().items()}
    codes, torn = [], {}
    path = str(tmp_path / "emergency.pkl")

    def on_exit(code):
        codes.append(code)
        torn.update({k: v.clone() for k, v in model.state_dict().items()})

    preemption.install(state=state, checkpoint_path=path, exit_fn=on_exit)
    try:
        model(x).pow(2).sum().backward()
        opt.step()
    finally:
        preemption.uninstall()
    assert codes == [preemption.PREEMPTED_EXIT_CODE]
    # the handler ran half-way: the first parameter moved, the rest not
    names = list(committed)
    assert not torch.equal(torn[names[0]], committed[names[0]])
    assert all(torch.equal(torn[k], committed[k]) for k in names[1:])
    epoch, _ = preemption.emergency_read(path)
    assert epoch == 1
    fresh = torch.nn.Sequential(torch.nn.Linear(6, 5),
                                torch.nn.Linear(5, 2))
    back = elastic.TorchState(model=fresh,
                              optimizer=torch.optim.SGD(
                                  fresh.parameters(), lr=0.5), step=0)
    preemption.emergency_restore(back, path)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, committed[k]), k
    assert back.step == 1 and back._commit_count == 1


def test_object_state_snapshots_anew_on_preemption(tmp_path):
    """An ObjectState (attributes replaced whole) is snapshotted at the
    signal, as the JAX package does."""
    from horovod_tpu_torch.elastic import preemption

    state = elastic.ObjectState(step=1)
    state.commit()
    state.step = 5
    path = str(tmp_path / "e.pkl")
    preemption.emergency_save(state, path)
    assert preemption.emergency_read(path)[1] == {"step": 5}


# ------------------------------------- tests/test_faults.py's preemption


def test_preemption_handler_commits_and_exits_with_code(tmp_path):
    from horovod_tpu_torch.elastic import preemption

    state = elastic.ObjectState(step=7, lr=0.1)
    state.step = 12  # uncommitted progress
    ckpt = str(tmp_path / "emergency.pkl")
    codes = []
    assert preemption.install(state=state, checkpoint_path=ckpt,
                              exit_fn=codes.append)
    os.kill(os.getpid(), signal.SIGTERM)
    assert codes == [preemption.PREEMPTED_EXIT_CODE]
    # the signal snapshotted the ObjectState's in-flight step
    assert state._saved["step"] == 12
    assert os.path.exists(ckpt)
    fresh = elastic.ObjectState(step=0, lr=0.0)
    preemption.emergency_restore(fresh, ckpt)
    assert fresh.step == 12 and fresh.lr == pytest.approx(0.1)


def test_preemption_handler_fires_once():
    from horovod_tpu_torch.elastic import preemption

    state = elastic.ObjectState(step=1)
    codes = []
    preemption.install(state=state, exit_fn=codes.append)
    os.kill(os.getpid(), signal.SIGTERM)
    os.kill(os.getpid(), signal.SIGTERM)
    assert codes == [preemption.PREEMPTED_EXIT_CODE]


def test_emergency_restore_rejects_unknown_attrs(tmp_path):
    from horovod_tpu_torch.elastic import preemption

    path = str(tmp_path / "e.pkl")
    preemption.emergency_save(elastic.ObjectState(step=3), path)
    with pytest.raises(ValueError, match="unregistered"):
        preemption.emergency_restore(elastic.ObjectState(epoch=0), path)


def test_emergency_save_is_atomic(tmp_path):
    from horovod_tpu_torch.elastic import preemption

    path = str(tmp_path / "nested" / "e.pkl")
    preemption.emergency_save(elastic.ObjectState(step=5), path)
    epoch, saved = preemption.emergency_read(path)
    assert saved["step"] == 5
    assert not [p for p in os.listdir(tmp_path / "nested")
                if ".tmp." in p], "tmp file must be renamed away"
