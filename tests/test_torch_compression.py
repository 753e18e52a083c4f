"""The port's wire compression surface against the JAX package's
(``tests/test_compression.py``'s primitives and knob plumbing, mirrored):

* the int8 round trip's error bound, bitwise equal to the JAX
  package's ``quantize_dequantize``;
* ``Compression.int8`` compress/decompress (codes, scales, the block in
  the ctx), integer payloads passed through;
* an all-zero block: codes 0, scale 1;
* ``wire_sent_bytes`` equal to the JAX package's for every wire;
* ``parse_wire``, ``resolve_wire`` (with the legacy wire-dtype knob),
  ``Compression.lookup``/``from_knobs`` and the knobs read from the
  environment, against the JAX package's answers;
* the block knob reaching the compressor's wire spec;
* the fusion bucket plan unchanged by the wire.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.core.knobs import Knobs as JaxKnobs
from horovod_tpu.core.state import global_state as jax_state
from horovod_tpu.optim import compression as jcomp
from horovod_tpu_torch.core.knobs import Knobs
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.optim import compression as tcomp

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port(monkeypatch):
    hvd.shutdown()
    # the JAX package's compressors read its global knobs, which outlive
    # its shutdown(): start from the defaults
    monkeypatch.setattr(jax_state(), "knobs", JaxKnobs())
    yield
    hvd.shutdown()


@pytest.mark.parametrize("block", [64, 256])
def test_quantize_roundtrip_error_bound(block):
    rng = np.random.RandomState(0)
    x = rng.uniform(-3, 3, (block * 7 + 13,)).astype(np.float32)
    dq = tcomp.quantize_dequantize(torch.from_numpy(x), block).numpy()
    # per-block symmetric int8: |err| <= scale / 2 = amax_block / 254
    b = np.pad(x, (0, -len(x) % block)).reshape(-1, block)
    bound = np.repeat(np.abs(b).max(axis=1) / 254.0 + 1e-7, block)[:len(x)]
    assert (np.abs(x - dq) <= bound).all()
    want = np.asarray(jcomp.quantize_dequantize(jnp.asarray(x), block))
    assert np.array_equal(dq, want)


def test_int8_compressor_roundtrip():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 77).astype(np.float32)
    wire, ctx = hvd.Compression.int8.compress(torch.from_numpy(x))
    jwire, jctx = jcomp.Compression.int8.compress(jnp.asarray(x))
    assert wire.dtype == torch.int8
    assert np.array_equal(wire.numpy(), np.asarray(jwire))
    assert np.array_equal(ctx[0].numpy(), np.asarray(jctx[0]))
    assert ctx[1:] == (torch.float32, (3, 77), 231, 256)
    back = hvd.Compression.int8.decompress(wire, ctx)
    assert back.shape == (3, 77) and back.dtype == torch.float32
    assert np.array_equal(back.numpy(), np.asarray(
        jcomp.Compression.int8.decompress(jwire, jctx)))
    assert float((back - torch.from_numpy(x)).abs().max()) <= float(
        np.abs(x).max()) / 127.0
    # non-floating payloads pass through untouched
    ints = torch.arange(10, dtype=torch.int32)
    w2, c2 = hvd.Compression.int8.compress(ints)
    assert c2 is None and w2 is ints
    assert hvd.Compression.int8_raw.compress(ints)[0] is ints


def test_zero_block_quantizes_to_zero():
    q, s = tcomp.quantize_blocks(torch.zeros(512), 256)
    assert not q.any()
    assert (s == 1.0).all()  # guarded divide
    assert not tcomp.dequantize_blocks(q, s, 256).any()


@pytest.mark.parametrize("wire", [None, "bf16", "fp16", "int8", "int8-raw"])
@pytest.mark.parametrize("n,itemsize,block", [(1000, 4, 256), (1, 4, 256),
                                              (4096, 2, 64), (777, 4, 32)])
def test_wire_sent_bytes(wire, n, itemsize, block):
    spec = tcomp.parse_wire(wire, block)
    jspec = jcomp.parse_wire(wire, block)
    assert tcomp.wire_sent_bytes(n, itemsize, spec) == \
        jcomp.wire_sent_bytes(n, itemsize, jspec)
    if wire == "int8" and (n, block) == (1000, 256):
        # padded payload + one float32 scale per 256-block
        assert tcomp.wire_sent_bytes(n, itemsize, spec) == 1024 + 4 * 4
        assert 4000 / tcomp.wire_sent_bytes(n, itemsize, spec) > 3.5


@pytest.mark.parametrize("name", ["none", "", "off", "bfloat16", "float16",
                                  "bf16", "fp16", "int8", "INT8", "int8-raw",
                                  "int8_raw"])
@pytest.mark.parametrize("block", [0, 64])
def test_parse_wire_and_knobs(name, block):
    spec, jspec = tcomp.parse_wire(name, block), jcomp.parse_wire(name, block)
    if jspec is None:
        assert spec is None
        assert hvd.Compression.lookup(name) is hvd.Compression.none
    else:
        assert spec.key == jspec.key
        assert spec.wire_dtype == {jnp.float16: torch.float16,
                                   jnp.bfloat16: torch.bfloat16,
                                   jnp.int8: torch.int8}[jspec.wire_dtype]
        kind = jcomp.Compression.lookup(name).__name__
        assert hvd.Compression.lookup(name).__name__ == {
            "Int8BlockCompressor": "Int8BlockCompressor",
            "Int8BlockRawCompressor": "Int8BlockRawCompressor",
            "BF16Compressor": "BF16Compressor",
            "FP16Compressor": "FP16Compressor"}[kind]
    knobs = dict(compression=name or "none", compression_block=block or 256)
    assert tcomp.resolve_wire(Knobs(**knobs)) == \
        (None if jspec is None else tcomp.WireSpec(*jcomp.resolve_wire(
            JaxKnobs(**knobs)).key))


def test_parse_wire_rejects_and_legacy_knob():
    for bad in ("int4", "fp8"):
        with pytest.raises(ValueError, match="unknown"):
            tcomp.parse_wire(bad)
        with pytest.raises(ValueError, match="unknown"):
            hvd.Compression.lookup(bad)
    assert tcomp.resolve_wire(Knobs(compression="int8",
                                    compression_block=64)) == \
        tcomp.WireSpec("int8", 64, True)
    # the legacy wire-dtype knob names a cast wire when compression is unset
    k2 = Knobs(compression="none", compression_wire_dtype="bfloat16")
    assert tcomp.resolve_wire(k2).kind == "bf16"
    assert hvd.Compression.from_knobs(k2) is hvd.Compression.bf16
    assert hvd.Compression.from_knobs(Knobs()) is hvd.Compression.none
    assert (hvd.Compression.from_knobs(Knobs(compression="int8"))
            is hvd.Compression.int8)
    assert (hvd.Compression.from_knobs(Knobs(compression="int8-raw"))
            is hvd.Compression.int8_raw)
    assert tcomp.WireSpec("int8", 256, True).describe() == "int8 block 256 ef"
    assert tcomp.WireSpec("int8", 32).describe() == "int8 block 32 raw"


@pytest.mark.parametrize("env,want", [
    ({}, dict(compression="none", compression_block=256,
              compression_wire_dtype="", fused_collectives=False,
              hierarchical_allreduce=False)),
    ({"HOROVOD_COMPRESSION": "int8", "HOROVOD_COMPRESSION_BLOCK": "128",
      "HOROVOD_FUSED_COLLECTIVES": "1",
      "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
      "HOROVOD_COMPRESSION_WIRE_DTYPE": "float16"},
     dict(compression="int8", compression_block=128,
          compression_wire_dtype="float16", fused_collectives=True,
          hierarchical_allreduce=True)),
    ({"HVD_TPU_COMPRESSION": "int8-raw", "HOROVOD_COMPRESSION": "bf16"},
     dict(compression="int8-raw")),
])
def test_knobs_from_env(monkeypatch, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    k, jk = Knobs.from_env(), JaxKnobs.from_env()
    for field, value in want.items():
        assert getattr(k, field) == value == getattr(jk, field), field


def test_block_knob_reaches_spmd_wire_spec():
    """HOROVOD_COMPRESSION_BLOCK reaches the knob-resolved compressor's
    wire spec (a class default must not shadow it), and the ctx carries
    the grid, so a decompress survives a knob change."""
    hvd.init(device="cpu")
    st = global_state()
    st.knobs = dataclasses.replace(st.knobs, compression="int8",
                                   compression_block=64)
    spec = tcomp.compressor_wire_spec(hvd.Compression.from_knobs())
    assert spec == tcomp.WireSpec("int8", 64, True)
    assert tcomp.resolve_wire().block == 64
    lin = torch.nn.Linear(2, 2)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1),
                                   named_parameters=lin.named_parameters())
    assert opt.wire == spec
    x = torch.from_numpy(np.random.RandomState(0).randn(100).astype(
        np.float32))
    wire, ctx = hvd.Compression.int8.compress(x)
    assert wire.numel() == 128 and ctx[-1] == 64
    st.knobs = dataclasses.replace(st.knobs, compression_block=256)
    back = hvd.Compression.int8.decompress(wire, ctx)
    assert float((back - x).abs().max()) <= float(x.abs().max()) / 127


def test_fusion_bucket_plan_unchanged_by_wire(monkeypatch):
    """The wire tags buckets, it never moves their boundaries: the plan
    (and the optimizer's) is the same with and without int8."""
    leaves = [(("a",), (100,), torch.float32), (("b",), (50,), torch.float32),
              (("c",), (10,), torch.int32)]
    off = tfusion.pytree_bucket_plan(leaves, threshold_bytes=1 << 20,
                                     backward_order=True)
    monkeypatch.setenv("HOROVOD_COMPRESSION", "int8")
    on = tfusion.pytree_bucket_plan(leaves, threshold_bytes=1 << 20,
                                    backward_order=True)
    assert off == on
    model = torch.nn.Sequential(torch.nn.Linear(30, 20),
                                torch.nn.Linear(20, 3))
    plans = {}
    for wire in ("none", "int8"):
        monkeypatch.setenv("HOROVOD_COMPRESSION", wire)
        hvd.init(device="cpu")
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=1),
            named_parameters=model.named_parameters(),
            fusion_threshold_bytes=1024)
        plans[wire] = opt.bucket_plan
        hvd.shutdown()
    assert plans["none"] == plans["int8"] and len(plans["none"]) > 1
