"""``InferenceEngine(mesh=, sharding_rules=)`` on a world of four over gloo
against the JAX package's engine on the same mesh.

A two-layer dense model (flax ``nn.Dense`` layers: ``Dense_0``,
``Dense_1``) is served with ``parallel.sharding.RESNET_RULES``, whose
``Dense_i/kernel`` spec ``(fsdp, tp)`` splits both dimensions of each
kernel on ``HOROVOD_MESH=fsdp=2,tp=2``. Each port rank builds the engine
on ``hvd.mesh()``; the JAX engine places the same parameters on a mesh
of four CPU devices. Held: each rank's slices (``engine.shards``)
bitwise the JAX array's shard on that device; every rank's output, at
each bucket and above the top one, the same on every rank and within
rtol/atol 1e-5 of the JAX engine's; the resident bytes are the whole
parameters' (the graphs read the whole leaves every rank loaded: the
deliberate difference of ROADMAP queue C), the slices' a quarter of
each kernel.
"""

import os
import pathlib
import socket
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import make_mesh as jmake_mesh
from horovod_tpu.parallel.sharding import RESNET_RULES as JRESNET_RULES
from horovod_tpu.serving.engine import InferenceEngine as JaxEngine
from horovod_tpu_torch.models.convert import params_from_flax

REPO = pathlib.Path(__file__).resolve().parent.parent
N, IN_DIM, BUCKETS = 4, 8, (1, 4)
BATCHES = (1, 3, 6)  # a bucket exactly, padded, above the top bucket


class _TwoDense(nn.Module):
    @nn.compact
    def __call__(self, x):
        h = nn.relu(nn.Dense(16)(x))
        return nn.Dense(4)(h)


_WORKER = r'''
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel.sharding import RESNET_RULES
from horovod_tpu_torch.serving import InferenceEngine

out, buckets, batches = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
hvd.init(device="cpu")
data = torch.load(out + "/data.pt", weights_only=False)


def apply(p, x):
    h = torch.relu(x @ p["Dense_0.kernel"] + p["Dense_0.bias"])
    return h @ p["Dense_1.kernel"] + p["Dense_1.bias"]


eng = InferenceEngine(apply, data["params"], buckets=buckets,
                      mesh=hvd.mesh(), sharding_rules=RESNET_RULES,
                      device="cpu")
res = {"shards": eng.shards,
       "outputs": [eng(data["x"][:b].numpy()) for b in batches],
       "resident": eng.resident_param_bytes, "shard": eng.shard_param_bytes,
       "mesh": hvd.mesh().sizes}
torch.save(res, out + "/rank%d.pt" % hvd.rank())
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving_mesh")
    mod = _TwoDense()
    params = jax.tree.map(np.asarray, mod.init(
        jax.random.PRNGKey(3), jnp.ones((1, IN_DIM)))["params"])
    x = np.random.RandomState(2).randn(max(BATCHES), IN_DIM).astype(
        np.float32)
    torch.save({"params": params_from_flax(params),
                "x": torch.from_numpy(x)}, tmp / "data.pt")
    port = _free_port()
    procs = []
    for r in range(N):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
        env.update(HOROVOD_RANK=str(r), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(N),
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HOROVOD_MESH="fsdp=2,tp=2",
                   HVD_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp), repr(BUCKETS),
             repr(BATCHES)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        mesh = jmake_mesh(devices=jax.devices()[:N], fsdp=2, tp=2)
        jeng = JaxEngine(lambda p, xb: mod.apply({"params": p}, xb), params,
                         buckets=BUCKETS, mesh=mesh,
                         sharding_rules=JRESNET_RULES)
        want = [jeng(x[:b]) for b in BATCHES]
    finally:
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            finally:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(N)]
    return {"jax": jeng, "mesh": mesh, "want": want, "ranks": ranks,
            "params": params}


def _jax_shard(arr, device):
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(shard.data)


def test_each_rank_holds_the_jax_shard_of_its_device(setup):
    devices = setup["mesh"].devices.reshape(-1)
    tree = setup["jax"]._params
    for r, out in enumerate(setup["ranks"]):
        assert out["mesh"] == {"fsdp": 2, "tp": 2}
        for layer, leaves in tree.items():
            for leaf, arr in leaves.items():
                got = out["shards"][f"{layer}.{leaf}"]
                want = _jax_shard(arr, devices[r])
                assert got.shape == want.shape, (r, layer, leaf)
                np.testing.assert_array_equal(got.numpy(), want)
        # the kernels are split over both axes, the biases whole
        assert out["shards"]["Dense_0.kernel"].shape == (IN_DIM // 2, 8)
        assert out["shards"]["Dense_0.bias"].shape == (16,)


def test_outputs_replicated_and_match_the_jax_engine(setup):
    first = setup["ranks"][0]["outputs"]
    for out in setup["ranks"]:
        for got, want, same, b in zip(out["outputs"], setup["want"], first,
                                      BATCHES):
            assert got.shape == (b, 4)
            np.testing.assert_array_equal(got, same)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resident_bytes_are_the_whole_parameters(setup):
    whole = sum(a.size * 4 for leaves in setup["params"].values()
                for a in leaves.values())
    shard = sum(a.size * 4 // (4 if k == "kernel" else 1)
                for leaves in setup["params"].values()
                for k, a in leaves.items())
    for out in setup["ranks"]:
        assert out["resident"] == whole
        assert out["shard"] == shard < whole
