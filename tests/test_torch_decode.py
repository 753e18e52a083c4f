"""The PyTorch port's serving path: engine, scheduler, knobs, imports.

* the port's ``GenerationEngine`` against the JAX package's on the
  same converted weights (prefill's first token and logits, then six
  teacher-forced decode steps) for float32, bfloat16 and int8 KV;
* continuous batching bitwise equal to one-at-a-time within the port;
* the scheduler's SLO shedding and drain contracts (mirrors of
  tests/test_decode.py);
* the engine refuses to fall back to the CPU, the knobs agree with the
  JAX package's, and neither the package nor ``chip_smoke.py`` imports
  JAX or ``horovod_tpu``.
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

from horovod_tpu.core.knobs import Knobs as JaxKnobs
from horovod_tpu.models.transformer import Transformer as JaxTransformer
from horovod_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from horovod_tpu.serving.decode import GenerationEngine as JaxEngine
from horovod_tpu_torch.core.knobs import Knobs
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)
from horovod_tpu_torch.serving import decode as tdecode
from horovod_tpu_torch.serving.batcher import Draining, QueueFull
from horovod_tpu_torch.serving.decode import (GenerationEngine,
                                              config_from_meta,
                                              config_to_meta)
from horovod_tpu_torch.serving.scheduler import DecodeScheduler

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
VOCAB = 61
_CFG = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, hidden_size=16,
            max_seq_len=32)


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.fixture(scope="module")
def flax_lm():
    mod = JaxTransformer(JaxTransformerConfig(dtype=jnp.float32, **_CFG))
    params = mod.init(jax.random.PRNGKey(0),
                      jnp.ones((1, 4), jnp.int32))["params"]
    return mod, params


def _port_engine(flax_lm, kv_dtype="fp32", **kw):
    _, params = flax_lm
    model = Transformer(TransformerConfig(dtype=torch.float32, **_CFG))
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    return GenerationEngine(model, sd, slots=2, max_len=24,
                            prefill_buckets=(8,), kv_dtype=kv_dtype,
                            device="cpu", **kw)


@pytest.fixture(scope="module")
def engine(flax_lm):
    return _port_engine(flax_lm)


def _make_sched(engine, clock, **kw):
    kw.setdefault("queue_limit", 16)
    kw.setdefault("default_timeout_s", 1000.0)
    kw.setdefault("default_max_new", 6)
    kw.setdefault("stats_every", 0)
    return DecodeScheduler(engine, clock=clock, **kw)


def _run_alone(engine, prompt, max_new):
    s = _make_sched(engine, FakeClock())
    r = s.submit(prompt, max_new_tokens=max_new)
    for _ in range(3 * max_new + 8):
        if r.done:
            break
        s.step_once()
    return r.result(1.0)


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["fp32", "bf16", "int8"])
def test_engine_matches_jax_engine(flax_lm, kv_dtype):
    """Same weights, same prompt: the first token and every
    teacher-forced decode step's token agree, logits within 1e-5."""
    mod, params = flax_lm
    jeng = JaxEngine(mod, params, slots=2, max_len=24,
                     prefill_buckets=(8,), kv_dtype=kv_dtype)
    teng = _port_engine(flax_lm, kv_dtype)
    prompt = [5, 17, 3, 44, 9]
    js, ts = jeng.claim_slot(), teng.claim_slot()
    jf, jl = jeng.prefill(js, prompt)
    tf, tl = teng.prefill(ts, prompt)
    assert tf == jf
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    toks = np.zeros(2, np.int32)
    lens = np.zeros(2, np.int32)
    lens[ts] = len(prompt)
    drive = jf
    for _ in range(6):
        toks[ts] = drive
        jn, jlog = jeng.decode(toks, lens, return_logits=True)
        tn, tlog = teng.decode(toks, lens, return_logits=True)
        assert int(tn[ts]) == int(jn[js])
        np.testing.assert_allclose(tlog[ts], jlog[js], rtol=0, atol=1e-5)
        drive = int(jn[js])
        lens[ts] += 1
    if kv_dtype == "int8":
        assert teng._cache["k"].dtype == torch.int8
        assert "k_scale" in teng._cache


def test_config_meta_roundtrip_matches_jax():
    cfg = TransformerConfig(dtype=torch.float32, **_CFG)
    meta = config_to_meta(cfg)
    assert config_from_meta(meta) == cfg
    from horovod_tpu.serving.decode import config_to_meta as jax_to_meta

    assert meta == jax_to_meta(JaxTransformerConfig(dtype=jnp.float32,
                                                    **_CFG))


def test_kv_parsing_and_spec_bytes():
    assert tdecode.parse_kv_dtype("bfloat16") == "bf16"
    assert tdecode.parse_kv_dtype("INT8") == "int8"
    with pytest.raises(ValueError):
        tdecode.parse_kv_dtype("fp8")
    assert tdecode.parse_decode_buckets("8x256, 4x128") == ((4, 128),
                                                            (8, 256))
    assert tdecode.default_prefill_buckets(100) == (8, 16, 32, 64, 100)
    spec = tdecode.KVCacheSpec(slots=2, layers=3, kv_heads=2, max_len=16,
                               head_dim=8, dtype="int8", block=4)
    assert spec.nbytes() == 2 * (2 * 3 * 2 * 16 * 8) + 2 * 4 * (
        2 * 3 * 2 * 16 * 2)


# ---------------------------------------------------------------------------
# continuous batching and scheduler contracts
# ---------------------------------------------------------------------------

def test_continuous_matches_one_at_a_time_bitwise(engine):
    """Mixed-length requests through the continuous batch equal the
    one-at-a-time runs, token for token."""
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(1, VOCAB - 1,
                         size=int(rng.randint(2, 7))).tolist(),
             int(rng.randint(2, 9))) for _ in range(6)]
    s = _make_sched(engine, FakeClock())
    pendings = [s.submit(p, max_new_tokens=mn) for p, mn in reqs]
    for _ in range(200):
        if all(p.done for p in pendings):
            break
        s.step_once()
    outs = [p.result(1.0)[0] for p in pendings]
    for (prompt, mn), got in zip(reqs, outs):
        assert len(got) == mn
        assert got == _run_alone(engine, prompt, mn)[0]
    assert s.stats()["evictions"] == {"length": 6}


def test_slo_class_shedding_order(engine):
    """Queue at capacity: an arriving higher-SLO request sheds the
    NEWEST strictly-lower-class queued request; equal-or-better
    classes are never shed (QueueFull instead)."""
    s = _make_sched(engine, FakeClock(), queue_limit=3)
    occ = [s.submit([1, 2], max_new_tokens=20),
           s.submit([2, 3], max_new_tokens=20)]
    s.step_once()  # both slots busy; queue empties
    q_std = s.submit([3, 4], slo="standard")
    q_b1 = s.submit([4, 5], slo="batch")
    q_b2 = s.submit([5, 6], slo="batch")
    with pytest.raises(QueueFull, match="at capacity"):
        s.submit([6, 7], slo="batch")
    q_int = s.submit([7, 8], slo="interactive")
    assert q_b2.done and not q_b1.done and not q_std.done
    with pytest.raises(QueueFull, match="shed for an arriving"):
        q_b2.result(0.1)
    occ[0].deadline_t = -1.0  # force-evict an occupier
    s.step_once()
    active = {r.seq for r in s._active.values()}
    assert q_int.seq in active, "interactive must be admitted first"
    s.close(drain=False)
    assert engine.free_slots == engine.slots


def test_drain_contract(engine):
    s = _make_sched(engine, FakeClock())
    r = s.submit([1, 2, 3], max_new_tokens=3)
    s.close(drain=True, timeout_s=30.0)
    assert r.done and r.finish_reason == "length"
    assert r.first_token_t is not None and r.done_t is not None
    with pytest.raises(Draining):
        s.submit([4, 5])


def test_rejects_unservable_prompts(engine):
    s = _make_sched(engine, FakeClock())
    with pytest.raises(ValueError, match="exceeds"):
        s.submit(list(range(1, 10)))  # 9 tokens > top prefill bucket 8
    with pytest.raises(ValueError, match="at least one"):
        s.submit([])
    with pytest.raises(ValueError, match="max_new_tokens"):
        s.submit([1], max_new_tokens=0)


# ---------------------------------------------------------------------------
# device, knobs, imports
# ---------------------------------------------------------------------------

def test_engine_without_device_raises_when_no_cuda(flax_lm, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Transformer(TransformerConfig(dtype=torch.float32, **_CFG))
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(model, slots=2, max_len=24, kv_dtype="fp32")


_KNOB_ENV = {  # suffix -> value (set as HOROVOD_<suffix>)
    "SERVING_QUEUE_LIMIT": "7",
    "SERVING_REQUEST_TIMEOUT": "2.5",
    "SERVING_KV_DTYPE": "int8",
    "SERVING_KV_BLOCK": "32",
    "SERVING_DECODE_BUCKETS": "8x1024",
    "SERVING_PREFILL_BUCKETS": "16,64",
    "SERVING_DECODE_MAX_NEW": "12",
    "SERVING_DECODE_STATS_EVERY": "0",
}


@pytest.mark.parametrize("set_env", [False, True])
def test_knobs_match_jax_knobs(set_env, monkeypatch):
    """Defaults, env names and the HVD_TPU_ > HOROVOD_ priority agree
    with the JAX package's Knobs on every field the port carries."""
    for suffix in _KNOB_ENV:
        for prefix in ("HOROVOD_", "HVD_TPU_"):
            monkeypatch.delenv(prefix + suffix, raising=False)
    if set_env:
        for suffix, value in _KNOB_ENV.items():
            monkeypatch.setenv("HOROVOD_" + suffix, value)
        monkeypatch.setenv("HVD_TPU_SERVING_KV_BLOCK", "16")
    mine, theirs = Knobs.from_env(), JaxKnobs.from_env()
    for field in Knobs.__dataclass_fields__:
        assert getattr(mine, field) == getattr(theirs, field), field
        assert getattr(Knobs(), field) == getattr(JaxKnobs(), field), field


def test_no_jax_in_port_or_chip_smoke():
    """Every module of horovod_tpu_torch and chip_smoke.py import
    without pulling in jax or horovod_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import horovod_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'horovod_tpu',\n"
        "              'triton'))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "CLEAN" in out.stdout, out.stderr


def test_chip_smoke_refuses_without_cuda():
    """On a machine without a card chip_smoke.py exits non-zero and
    prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
