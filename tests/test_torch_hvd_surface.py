"""The collective and optimizer scenarios of ``tests/test_torch_adapter.py``
(the JAX package's torch adapter) against the port.

The adapter runs them in the JAX package's single-controller world,
where every rank holds the controller's tensor (Sum = x x size, Average
= x). Here a world of two ranks over gloo (one spawn, every scenario in
it) runs them with every rank passing the same tensor, which has the
same semantics, and, where the adapter's scenario cannot tell ranks
apart, with rank-distinct values too: allreduce Sum/Average, the
in-place async form, allgather and broadcast, grouped allreduce, the
parameter and optimizer-state broadcasts, the DistributedOptimizer
training a toy regression, fp16 compression, ``backward_passes_per_step``,
duplicate names, and the four ``groups`` cases (``:131``, ``:175``,
``:192``, ``:220``): chunked groups fuse (one bucket a group, and the
same parameters as without groups, bitwise), validation, a partial
group flushed by ``synchronize()``, and bools and unregistered tensors
refused.
"""

import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 2

_WORKER = r'''
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd

out = sys.argv[1]
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
res = {}


def raises(exc, fn):
    try:
        fn()
    except exc as e:
        return type(e).__name__ + ": " + str(e)
    return None


x = torch.arange(8, dtype=torch.float32)
res["sum"] = hvd.allreduce(x, op=hvd.Sum, name="t.sum")
res["avg"] = hvd.allreduce(x, average=True, name="t.avg")
res["avg_distinct"] = hvd.allreduce(x + 8 * r, average=True)

ones = torch.ones(4)
h = hvd.allreduce_async_(ones, op=hvd.Sum, name="t.as")
out_t = hvd.synchronize(h)
res["inplace_async"] = (out_t is ones, ones.clone(), isinstance(h, int))
res["poll_unknown"] = raises(ValueError, lambda: hvd.poll(h))

g = torch.arange(6, dtype=torch.float32).reshape(2, 3)
res["allgather"] = hvd.allgather(g, name="t.ag")
res["broadcast"] = hvd.broadcast(g + r, root_rank=0, name="t.bc")
res["grouped"] = hvd.grouped_allreduce(
    [torch.ones(3), torch.full((2,), 2.0)], op=hvd.Sum, name="t.g")

torch.manual_seed(10 + r)
model = torch.nn.Linear(4, 2)
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
res["bp_state_dict"] = {k: v.clone() for k, v in model.state_dict().items()}
torch.manual_seed(20 + r)
model2 = torch.nn.Linear(4, 2)
hvd.broadcast_parameters(model2.named_parameters(), root_rank=0)
res["bp_named"] = {k: v.detach().clone()
                   for k, v in model2.named_parameters()}

opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
torch.manual_seed(30 + r)
model(torch.randn(3, 4)).sum().backward()
opt.step()
hvd.broadcast_optimizer_state(opt, root_rank=0)
res["bos"] = (opt.state_dict()["param_groups"][0]["lr"],
              {k: v["momentum_buffer"].clone()
               for k, v in opt.state_dict()["state"].items()})

# the four-step recipe on a toy regression: each rank its own rows
torch.manual_seed(0)
lin = torch.nn.Linear(8, 1)
dopt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                                named_parameters=lin.named_parameters())
hvd.broadcast_parameters(lin.state_dict(), root_rank=0)
gen = torch.Generator().manual_seed(1)
X = torch.randn(64, 8, generator=gen)
w_true = torch.randn(8, 1, generator=gen)
Y = X @ w_true
Xr, Yr = X[32 * r:32 * (r + 1)], Y[32 * r:32 * (r + 1)]
first = last = None
for i in range(60):
    dopt.zero_grad()
    loss = ((lin(Xr) - Yr) ** 2).mean()
    loss.backward()
    dopt.step()
    first = float(loss) if first is None else first
    last = float(loss)
res["trains"] = (first, last)

lin = torch.nn.Linear(4, 1)
fopt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                                named_parameters=lin.named_parameters(),
                                compression=hvd.Compression.fp16)
fopt.zero_grad()
(lin(torch.randn(2, 4)) ** 2).mean().backward()
fopt.step()
res["fp16_grad_dtypes"] = [p.grad.dtype for p in lin.parameters()]

lin = torch.nn.Linear(4, 1)
bopt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.0),
                                named_parameters=lin.named_parameters(),
                                backward_passes_per_step=2)
bopt.zero_grad()
(lin(torch.randn(2, 4)) ** 2).mean().backward()
first_pass = bool(bopt._pending)
(lin(torch.randn(2, 4)) ** 2).mean().backward()
res["bpps"] = (first_pass, bool(bopt._pending))
bopt.step()

params = list(lin.named_parameters())
res["duplicate"] = raises(ValueError, lambda: hvd.DistributedOptimizer(
    torch.optim.SGD(lin.parameters(), lr=0.1),
    named_parameters=params + params))


def grouped_run(groups):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 1))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=list(model.named_parameters()), groups=groups)
    issued = []
    orig = opt._issue

    def spy(b):
        issued.append(len(opt.bucket_plan[b]))
        orig(b)

    opt._issue = spy
    gen = torch.Generator().manual_seed(2 + r)
    x = torch.randn(32, 4, generator=gen)
    y = x.sum(dim=1, keepdim=True)
    first = None
    for _ in range(30):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        first = float(loss) if first is None else first
    return (first, float(loss), issued,
            {k: v.clone() for k, v in model.state_dict().items()})


res["groups2"] = grouped_run(2)
res["groups_none"] = grouped_run(None)
model = torch.nn.Linear(2, 2)
p0 = next(model.parameters())
res["groups_zero"] = raises(ValueError, lambda: hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=0.1), groups=0))
res["groups_twice"] = raises(ValueError, lambda: hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=0.1), groups=[[p0], [p0]]))
res["groups_bool"] = raises(ValueError, lambda: hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=0.1), groups=True))
stranger = torch.nn.Parameter(torch.ones(2))
res["groups_stranger"] = raises(ValueError, lambda: hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=0.1), groups=[[stranger]]))
res["groups_not_tensor"] = raises(ValueError, lambda: (
    hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                             groups=[["w"]])))

a = torch.nn.Parameter(torch.ones(3))
b = torch.nn.Parameter(torch.ones(3))
popt = hvd.DistributedOptimizer(torch.optim.SGD([a, b], lr=0.1),
                                named_parameters=[("a", a), ("b", b)],
                                groups=[[a, b]])
(a * 2 * (r + 1)).sum().backward()  # b gets no gradient this step
popt.step()
after_one = (a.detach().clone(), b.detach().clone())
popt.zero_grad()
(a + b).sum().backward()
popt.step()
res["partial_flush"] = (after_one, (a.detach().clone(), b.detach().clone()),
                        len(popt.bucket_plan))
torch.save(res, out + "/rank%d.pt" % r)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("hvd_surface")
    port = _free_port()
    procs = []
    for r in range(N):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(N),
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(out)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        finally:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(N)]


def test_allreduce_sum_and_average(world):
    x = torch.arange(8, dtype=torch.float32)
    for out in world:
        assert torch.equal(out["sum"], x * N)
        assert torch.equal(out["avg"], x)
        assert out["sum"].dtype == x.dtype
        assert torch.equal(out["avg_distinct"], x + 4)


def test_allreduce_inplace_and_async(world):
    for out in world:
        is_input, value, is_int = out["inplace_async"]
        assert is_input and is_int
        assert torch.equal(value, torch.full((4,), float(N)))
        assert "unknown handle" in out["poll_unknown"]


def test_allgather_broadcast_roundtrip(world):
    g = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for out in world:
        assert out["allgather"].shape == (2 * N, 3)
        assert torch.equal(out["allgather"], torch.cat([g] * N))
        assert torch.equal(out["broadcast"], g)


def test_grouped_allreduce(world):
    for out in world:
        a, b = out["grouped"]
        assert torch.equal(a, torch.full((3,), float(N)))
        assert torch.equal(b, torch.full((2,), 2.0 * N))


def test_broadcast_parameters_state_dict_and_named(world):
    for key in ("bp_state_dict", "bp_named"):
        for name, v in world[0][key].items():
            assert torch.equal(world[1][key][name], v)


def test_broadcast_optimizer_state(world):
    lr0, state0 = world[0]["bos"]
    for out in world:
        lr, state = out["bos"]
        assert lr == lr0 == 0.1
        for k, v in state0.items():
            assert torch.equal(state[k], v)


def test_distributed_optimizer_trains(world):
    for out in world:
        first, last = out["trains"]
        assert last < first * 0.01, (first, last)


def test_distributed_optimizer_fp16_compression(world):
    for out in world:
        assert out["fp16_grad_dtypes"] == [torch.float32, torch.float32]


def test_backward_passes_per_step_delays_allreduce(world):
    for out in world:
        assert out["bpps"] == (False, True)


def test_duplicate_names_rejected(world):
    for out in world:
        assert "duplicate" in out["duplicate"]


def test_distributed_optimizer_groups_fuse(world):
    """groups=2 chunks the 4 parameters into 2 buckets of 2, issued once
    a step each; training converges, to the same parameters as without
    groups, bitwise (Average is elementwise: the bucket layout does not
    change a value)."""
    for out in world:
        first, last, issued, state = out["groups2"]
        assert last < first / 4, (first, last)
        assert issued == [2, 2] * 30
        f0, l0, _, state0 = out["groups_none"]
        assert (f0, l0) == (first, last)
        for k, v in state0.items():
            assert torch.equal(state[k], v)


def test_distributed_optimizer_groups_validation(world):
    for out in world:
        assert "groups" in out["groups_zero"]
        assert "once" in out["groups_twice"]
        assert "torch.Tensor" in out["groups_not_tensor"]


def test_groups_partial_flush_on_synchronize(world):
    """b got no gradient in step 1: synchronize() reduces the group with
    b's slot as zeros, so a steps on its averaged gradient, b stays; the
    next step moves both."""
    mean_a = 2.0 * (1 + 2) / 2
    for out in world:
        (a1, b1), (a2, b2), buckets = out["partial_flush"]
        assert buckets == 1
        assert torch.allclose(a1, torch.full((3,), 1 - 0.1 * mean_a))
        assert torch.equal(b1, torch.ones(3))
        assert torch.allclose(a2, a1 - 0.1)
        assert torch.allclose(b2, torch.full((3,), 0.9))


def test_groups_reject_bool_and_unregistered(world):
    for out in world:
        assert "positive integer" in out["groups_bool"]
        assert "registered" in out["groups_stranger"]
