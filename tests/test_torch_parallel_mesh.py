"""The port's device mesh and sharding rules against the JAX package's.

* ``make_mesh``: the axis sizes, each rank's coordinates (its position
  in the JAX mesh's device array) and the errors, on the same requests
  over 8 ranks and the conftest's 8 CPU devices; ``data_axes``
  (``tests/test_parallel.py``'s cases); the ``HOROVOD_MESH`` spec
  parser's shapes and errors against ``core/basics._parse_mesh_spec``;
  ``batch_sharding``'s spec;
* ``make_param_shardings``: the pruned spec of every parameter of a
  small GPT-2-style model (vocab 61: not divisible, whole) and a
  Llama-style one (RMSNorm, RoPE, SwiGLU, GQA with 2 kv heads, untied,
  vocab 64) on ``dp=2,tp=4`` and ``fsdp=2,tp=2``, against the JAX
  package's on the same flax tree (its ``/`` paths mapped to the port's
  dotted names here, not in the rules); ``shard_params``: every rank's
  slice bitwise the data of the JAX array's shard on the device at that
  rank's place in the mesh;
* ``HOROVOD_MESH`` through ``init()`` and ``hvd.mesh()`` (a world of
  one; a spec the world cannot hold raises and leaves nothing
  initialized), and the launcher's ``--mesh`` reaching two workers as
  ``HOROVOD_MESH``, whose ``hvd.mesh()`` gives each its coordinates.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.core.basics import _parse_mesh_spec as jparse
from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel import data_axes as jdata_axes
from horovod_tpu.parallel import make_mesh as jmake_mesh
from horovod_tpu.parallel import make_param_shardings as jshardings
from horovod_tpu.parallel.sharding import batch_sharding as jbatch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.parallel import mesh as pm
from horovod_tpu_torch.parallel import sharding as psh

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 8

MESHES = [dict(dp=8), dict(dp=2, tp=4), dict(dp=2, fsdp=2, tp=2),
          dict(dp=1, tp=8), dict(tp=2, sp=2), dict(pp=2, sp=2, tp=2),
          dict(dp=0, ep=2, tp=2)]
BAD_MESHES = [dict(tp=3), dict(dp=3, tp=2), dict(dp=2, tp=2)]
SPECS = ["dp=4,tp=2", "dp=-1,tp=2", "tp=2,dp=-1", "hvd=8", "sp=2,-1=x"]
BAD_SPECS = ["dp=-1,tp=-1", "dp=3", "dp=3,tp=-1"]
CFGS = {
    "gpt2": dict(vocab_size=61, num_layers=2, num_heads=4, hidden_size=32,
                 max_seq_len=16),
    "llama": dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                  hidden_size=32, mlp_ratio=2.0, max_seq_len=16,
                  norm="rmsnorm", position="rope", activation="swiglu",
                  tie_embeddings=False),
}


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("axes", MESHES, ids=str)
def test_make_mesh_sizes_and_coordinates(axes):
    jmesh = jmake_mesh(devices=jax.devices()[:N], **axes)
    mesh = pm.make_mesh(world=N, **axes)
    assert mesh.sizes == dict(zip(jmesh.axis_names, jmesh.devices.shape))
    assert mesh.axis_names == tuple(jmesh.axis_names) == pm.AXIS_ORDER
    for pos, dev in np.ndenumerate(jmesh.devices):
        r = int(np.ravel_multi_index(pos, jmesh.devices.shape))
        assert tuple(mesh.coords_of(r).values()) == pos
        assert mesh.rank_of(mesh.coords_of(r)) == r
    assert pm.data_axes(mesh) == jdata_axes(jmesh)
    for seq_axis in (None, 1):
        assert psh.batch_sharding(mesh, seq_axis=seq_axis) == \
            tuple(jbatch(jmesh, seq_axis=seq_axis).spec)


@pytest.mark.parametrize("axes", BAD_MESHES, ids=str)
def test_make_mesh_errors(axes):
    want = _error(lambda: jmake_mesh(devices=jax.devices()[:N], **axes))
    assert _error(lambda: pm.make_mesh(world=N, **axes)) == want


def test_data_axes_cases():
    """tests/test_parallel.py:test_data_axes_helper, on the port."""
    assert pm.data_axes(pm.make_mesh(dp=8, world=8)) == ("dp",)
    assert pm.data_axes(pm.make_mesh(dp=2, tp=4, world=8)) == ("dp",)
    assert pm.data_axes(pm.make_mesh(dp=2, fsdp=2, tp=2, world=8)) == \
        ("dp", "fsdp")
    assert pm.data_axes(pm.make_mesh(dp=1, tp=8, world=8)) == ()


@pytest.mark.parametrize("spec", SPECS + BAD_SPECS)
def test_mesh_spec_parser(spec):
    try:
        want = jparse(spec, N)
    except ValueError as e:
        assert _error(lambda: pm.parse_mesh_spec(spec, N)) == str(e)
        return
    assert pm.parse_mesh_spec(spec, N) == want


def _flax_params(cname):
    jmod = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32,
                                               **CFGS[cname]))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                jnp.ones((1, 4), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _dotted(path):
    return ".".join(str(getattr(k, "key", k)) for k in path)


@pytest.mark.parametrize("axes", [dict(dp=2, tp=4), dict(fsdp=2, tp=2,
                                                         dp=2)], ids=str)
@pytest.mark.parametrize("cname", list(CFGS))
def test_param_specs_and_shards_match_jax(cname, axes):
    params = _flax_params(cname)
    jmesh = jmake_mesh(devices=jax.devices()[:N], **axes)
    jspecs = jshardings(params, jmesh)
    want = {_dotted(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(jspecs)[0]}
    mesh = pm.make_mesh(world=N, **axes)
    full = params_from_flax(params)
    specs = psh.make_param_shardings(full, mesh)
    assert specs == want
    # the rules split what the example says they split
    if cname == "llama" and axes == dict(dp=2, tp=4):
        assert specs["block_0.attn.query.kernel"] == (None, "tp", None)
        assert specs["block_0.attn.key.kernel"] == (None, None, None)
        assert specs["tok_emb.embedding"] == ("tp", None)
    if cname == "gpt2":
        assert specs["tok_emb.embedding"][0] is None  # 61 % tp
    placed = jax.tree.map(jax.device_put, params, jspecs)
    devices = list(jmesh.devices.reshape(-1))
    for path, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
        name = _dotted(path)
        for shard in arr.addressable_shards:
            r = devices.index(shard.device)
            mine = psh.shard_params({name: full[name]}, mesh, rank=r)[name]
            assert np.array_equal(mine.numpy(), np.asarray(shard.data)), \
                (name, r)
    # and back: every rank's shards make the whole tensors again
    shards = [psh.shard_params(full, mesh, rank=r) for r in range(N)]
    back = psh.unshard_params(shards, specs, mesh)
    assert all(torch.equal(back[k], v) for k, v in full.items())


def test_horovod_mesh_through_init(monkeypatch):
    monkeypatch.delenv("HVD_TPU_MESH", raising=False)
    monkeypatch.delenv("HOROVOD_MESH", raising=False)
    hvd.init(device="cpu")
    try:
        assert hvd.mesh().sizes == {"dp": 1}
        assert hvd.Knobs.from_env().mesh_spec == ""
    finally:
        hvd.shutdown()
    monkeypatch.setenv("HOROVOD_MESH", "dp=1,tp=1")
    hvd.init(device="cpu")
    try:
        mesh = hvd.mesh()
        assert mesh.axis_names == ("dp", "tp") and mesh.shape == (1, 1)
        assert mesh.coords == {"dp": 0, "tp": 0} and mesh.bound
    finally:
        hvd.shutdown()
    monkeypatch.setenv("HOROVOD_MESH", "dp=2,tp=1")
    with pytest.raises(ValueError, match="2 devices, but 1"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()
    with pytest.raises(hvd.NotInitializedError):
        hvd.mesh()


_MESH_WORKER = r'''
import json, os
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
m = hvd.mesh()
print("MESH", json.dumps({"env": os.environ.get("HOROVOD_MESH"),
                          "sizes": m.sizes, "coords": m.coords,
                          "rank": hvd.rank()}), flush=True)
hvd.shutdown()
'''


def test_launcher_mesh_reaches_the_workers(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_MESH_WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", "-H", "localhost:2", "--mesh", "dp=1,tp=2", sys.executable,
         str(script)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    import json

    seen = {}
    for line in out.stdout.splitlines():
        if "MESH " in line:
            d = json.loads(line.split("MESH ", 1)[1])
            seen[d["rank"]] = d
    assert sorted(seen) == [0, 1], out.stdout
    for r, d in seen.items():
        assert d["env"] == "dp=1,tp=2"
        assert d["sizes"] == {"dp": 1, "tp": 2}
        assert d["coords"] == {"dp": 0, "tp": r}
