"""The PyTorch port's generation engine: checkpoints, graph steps, HTTP.

* ``GenerationEngine.from_checkpoint`` (the port's checkpoint of
  converted flax weights) generates the JAX ``GenerationEngine``'s
  greedy tokens, restored from the JAX package's checkpoint of the
  same weights, on a tiny LM with a float32 cache;
* the graphs' step functions, which the CPU runs directly, give the
  previous eager ``prefill``/``decode`` bits (kept below as
  ``_eager_prefill``/``_eager_decode``) on the same inputs: outputs,
  logits and every cache buffer, for float32, bfloat16 and int8 caches;
* the step cache's keys (the JAX package's executable keys), its LRU and
  the serving fault points;
* ``/v1/generate`` streamed over HTTP and ``/healthz``'s slots
  (tests/test_decode.py's scenarios), and the front door's generate
  failover before the first chunk.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import checkpoint as jax_checkpoint
from horovod_tpu.models.transformer import Transformer as JaxTransformer
from horovod_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from horovod_tpu.serving.decode import GenerationEngine as JaxEngine
from horovod_tpu.serving.decode import config_to_meta as jax_config_to_meta
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)
from horovod_tpu_torch.serving import (GenerationEngine, ReplicaSet,
                                       ServingServer, config_to_meta,
                                       generate_remote)
from horovod_tpu_torch.serving.decode import SlottedKVCache, _quantize_rows
from horovod_tpu_torch.serving.scheduler import DecodeScheduler
from horovod_tpu_torch.utils import faults

torch.set_num_threads(1)

VOCAB = 61
_CFG = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, hidden_size=16,
            max_seq_len=32)
_ENGINE = dict(slots=2, max_len=24, prefill_buckets=(8, 16))


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


@pytest.fixture(scope="module")
def state(flax_lm):
    return params_from_flax(jax.tree.map(np.asarray, flax_lm[1]))


def _engine(state, kv_dtype="fp32", **kw):
    model = Transformer(TransformerConfig(dtype=torch.float32, **_CFG))
    return GenerationEngine(model, state, kv_dtype=kv_dtype, device="cpu",
                            **dict(_ENGINE, **kw))


@pytest.fixture(scope="module")
def engine(state):
    eng = _engine(state)
    eng.warmup()
    return eng


def _greedy(eng, prompt, steps):
    slot = eng.claim_slot()
    first, _ = eng.prefill(slot, prompt)
    toks = np.zeros(eng.slots, np.int32)
    lens = np.zeros(eng.slots, np.int32)
    out, lens[slot] = [first], len(prompt)
    for _ in range(steps):
        toks[slot] = out[-1]
        nxt, _ = eng.decode(toks, lens)
        out.append(int(nxt[slot]))
        lens[slot] += 1
    eng.release_slot(slot)
    return out


# ---------------------------------------------------------------------------
# from_checkpoint against the JAX engine
# ---------------------------------------------------------------------------

def test_from_checkpoint_greedy_tokens_match_jax(flax_lm, state, tmp_path):
    mod, params = flax_lm
    meta = {"serving": {"model": "transformer_lm",
                        "config": jax_config_to_meta(mod.cfg), "eos": 7}}
    jax_path = str(tmp_path / "jax")
    jax_checkpoint.save_model(jax_path, params, metadata=meta)
    jeng = JaxEngine.from_checkpoint(jax_path, kv_dtype="fp32", **_ENGINE)
    port_meta = {"serving": dict(meta["serving"], config=config_to_meta(
        TransformerConfig(dtype=torch.float32, **_CFG)))}
    assert port_meta == meta  # the same metadata both ways
    path = str(tmp_path / "port")
    checkpoint.save_model(path, state, metadata=port_meta)
    teng = GenerationEngine.from_checkpoint(path, kv_dtype="fp32",
                                            device="cpu", **_ENGINE)
    assert teng.eos_id == jeng.eos_id == 7
    assert teng.cfg == TransformerConfig(dtype=torch.float32, **_CFG)
    for prompt in ([5, 17, 3, 44, 9], list(range(1, 12))):
        assert _greedy(teng, prompt, 8) == _greedy(jeng, prompt, 8)


def test_from_checkpoint_refuses_a_non_lm_checkpoint(state, tmp_path):
    path = str(tmp_path / "mlp")
    checkpoint.save_model(path, state, metadata={"serving": {
        "model": "mlp"}})
    with pytest.raises(ValueError, match="not a generation LM"):
        GenerationEngine.from_checkpoint(path, device="cpu")


# ---------------------------------------------------------------------------
# the graphs' step functions against the eager steps they replace
# ---------------------------------------------------------------------------

def _eager_prefill(eng, cache, slot, padded, n):
    """The engine's prefill before the graphs (host-int indexing),
    writing into ``cache``."""
    spec = eng.spec
    bucket = padded.shape[1]
    local_spec = dataclasses.replace(spec, slots=1, max_len=bucket,
                                     dtype="fp32")
    with torch.inference_mode():
        local = SlottedKVCache(local_spec, local_spec.allocate("cpu"))
        tok = torch.from_numpy(padded)
        pos = torch.arange(bucket, dtype=torch.int32)[None]
        logits = eng.model(tok, positions=pos, kv_cache=local)
        last = logits[0, n - 1].to(torch.float32)
        first = torch.argmax(last)
        for name in ("k", "v"):
            rows = local.buffers[name]
            dst = slice(slot, slot + 1)
            if spec.dtype == "int8":
                codes, scales = _quantize_rows(rows, spec.resolved_block)
                cache[name][dst, :, :, :bucket] = codes
                cache[name + "_scale"][dst, :, :, :bucket] = scales
            else:
                cache[name][dst, :, :, :bucket] = rows.to(cache[name].dtype)
        return int(first), last.numpy()


def _eager_decode(eng, cache, tokens, lengths):
    """The engine's decode before the graphs, writing into ``cache``."""
    with torch.inference_mode():
        kv = SlottedKVCache(eng.spec, cache)
        tok = torch.from_numpy(tokens)[:, None]
        pos = torch.from_numpy(lengths)[:, None]
        logits = eng.model(tok, positions=pos, kv_cache=kv)
        last = logits[:, -1].to(torch.float32)
        return (torch.argmax(last, dim=-1).to(torch.int32).numpy(),
                last.numpy())


@pytest.mark.parametrize("kv_dtype", ["fp32", "bf16", "int8"])
def test_step_functions_are_bitwise_the_eager_steps(state, kv_dtype):
    """Two prompts (buckets 8 and 16) into both slots, then six decode
    steps: first tokens, logits, next tokens and the whole cache equal
    the eager steps' bitwise."""
    eng = _engine(state, kv_dtype, kv_block=4)
    ref = {k: v.clone() for k, v in eng._cache.items()}
    prompts = {0: [5, 17, 3, 44, 9], 1: list(range(3, 15))}
    lens = np.zeros(2, np.int32)
    toks = np.zeros(2, np.int32)
    for slot, prompt in prompts.items():
        assert eng.claim_slot() == slot
        bucket = eng.prefill_bucket_for(len(prompt))
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(prompt)] = prompt
        first, last = eng.prefill(slot, prompt)
        want_first, want_last = _eager_prefill(eng, ref, slot, padded,
                                               len(prompt))
        assert first == want_first
        assert np.array_equal(last, want_last)
        toks[slot], lens[slot] = first, len(prompt)
    for _ in range(6):
        nxt, logits = eng.decode(toks, lens, return_logits=True)
        want_nxt, want_logits = _eager_decode(eng, ref, toks, lens)
        assert np.array_equal(nxt, want_nxt)
        assert np.array_equal(logits, want_logits)
        toks, lens = nxt, lens + 1
    for name, buf in eng._cache.items():
        assert torch.equal(buf, ref[name]), name


def test_cache_buffers_are_never_rebound(state):
    eng = _engine(state)
    ptrs = {k: v.data_ptr() for k, v in eng._cache.items()}
    eng.warmup()
    slot = eng.claim_slot()
    eng.prefill(slot, [1, 2, 3])
    eng.decode(np.zeros(2, np.int32), np.array([3, 0], np.int32))
    assert {k: v.data_ptr() for k, v in eng._cache.items()} == ptrs


def test_step_cache_keys_and_lru(state, monkeypatch):
    """warmup builds the decode step and every prefill bucket's under
    the JAX package's executable keys; the LRU keeps at most
    MAX_CACHED_EXECUTABLES."""
    eng = _engine(state)
    eng.warmup()
    assert set(eng.graphs) == {("decode", 2, 24, False), ("prefill", 8),
                               ("prefill", 16)}
    assert eng.cached_executables == 3
    eng.decode(np.zeros(2, np.int32), np.zeros(2, np.int32),
               return_logits=True)
    assert ("decode", 2, 24, True) in eng.graphs
    monkeypatch.setattr(GenerationEngine, "MAX_CACHED_EXECUTABLES", 2)
    eng = _engine(state)
    eng.warmup()
    assert list(eng.graphs) == [("prefill", 16), ("decode", 2, 24, False)]
    eng.prefill(0, [1, 2])
    assert list(eng.graphs) == [("decode", 2, 24, False), ("prefill", 8)]
    # no graphs on the CPU: every step ran uncaptured
    assert all(s.graph is None and s.replays == 0
               for s in eng.graphs.values())


def test_serving_fault_points_fire(state):
    eng = _engine(state)
    eng.warmup()  # warmup fires no fault point
    try:
        faults.configure("serving.decode_step:error:after=1")
        z = np.zeros(2, np.int32)
        eng.decode(z, z)
        with pytest.raises(faults.InjectedFault):
            eng.decode(z, z)
        faults.configure("serving.decode_prefill:error")
        with pytest.raises(faults.InjectedFault):
            eng.prefill(0, [1, 2])
    finally:
        faults.configure("")


# ---------------------------------------------------------------------------
# HTTP: /healthz slots and the /v1/generate stream (tests/test_decode.py)
# ---------------------------------------------------------------------------

def _make_sched(engine, clock, **kw):
    kw.setdefault("queue_limit", 16)
    kw.setdefault("default_timeout_s", 1000.0)
    kw.setdefault("default_max_new", 6)
    kw.setdefault("stats_every", 0)
    return DecodeScheduler(engine, clock=clock, **kw)


def _generate_local(s):
    def generate_local(req, timeout_s):
        p = s.submit(req["prompt"],
                     max_new_tokens=req.get("max_new_tokens"),
                     timeout_s=timeout_s,
                     slo=req.get("slo", "standard"))
        return p.stream(timeout_s=30.0)
    return generate_local


def test_healthz_slots_distinguishes_full_from_wedged(engine):
    s = _make_sched(engine, FakeClock())
    srv = ServingServer(
        generate_fn=_generate_local(s),
        health_extra=lambda: {"slots": s.slot_stats(),
                              "queued": s.pending,
                              "bucket_cache": engine.cached_executables})
    port = srv.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=5.0) as r:
            h = json.loads(r.read())
        assert h["slots"] == {"total": 2, "occupied": 0,
                              "queued_prefills": 0}
        assert h["bucket_cache"] >= 1
        s.submit([1, 2], max_new_tokens=20)
        s.submit([2, 3], max_new_tokens=20)
        s.submit([3, 4], max_new_tokens=20)
        s.step_once()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=5.0) as r:
            h = json.loads(r.read())
        assert h["slots"] == {"total": 2, "occupied": 2,
                              "queued_prefills": 1}
        assert h["status"] == "ok"  # full != wedged
    finally:
        srv.shutdown()
        s.close(drain=False)


def test_generate_stream_http_roundtrip(engine):
    """Chunked line-delimited tokens, the request id echoed, and the
    non-stream body equal to the collected stream."""
    want = _greedy(engine, [5, 17, 3], 3)
    s = _make_sched(engine, FakeClock()).start()
    srv = ServingServer(generate_fn=_generate_local(s))
    port = srv.start()
    try:
        body = json.dumps({"prompt": [5, 17, 3], "max_new_tokens": 4,
                           "stream": True}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate", data=body,
            method="POST", headers={"X-Request-Id": "gen-test-1"})
        with urllib.request.urlopen(req, timeout=30.0) as resp:
            assert resp.headers.get("X-Request-Id") == "gen-test-1"
            chunks = [json.loads(ln) for ln in resp if ln.strip()]
        assert chunks[-1]["done"]
        assert chunks[-1]["finish_reason"] == "length"
        streamed = [t for c in chunks for t in c.get("tokens", ())]
        assert len(streamed) == chunks[-1]["n"] == 4

        body2 = json.dumps({"prompt": [5, 17, 3],
                            "max_new_tokens": 4}).encode()
        req2 = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate", data=body2,
            method="POST")
        with urllib.request.urlopen(req2, timeout=30.0) as resp:
            payload = json.loads(resp.read())
        assert payload["tokens"] == streamed
        # the same tokens as the engine's own greedy run
        assert streamed == want
    finally:
        srv.shutdown()
        s.close(drain=False)


def test_front_door_generate_fails_over_before_the_first_chunk(engine):
    """A decode replica that fails before streaming anything is ejected
    and the request retried on its peer; the client sees the peer's
    tokens and no error."""
    want = _greedy(engine, [5, 17, 3], 3)
    s = _make_sched(engine, FakeClock()).start()
    good = ServingServer(generate_fn=_generate_local(s))

    def dying(req, timeout_s):
        raise ConnectionError("replica dying")

    bad = ServingServer(generate_fn=dying)
    gp, bp = good.start(), bad.start()
    rs = ReplicaSet({0: f"127.0.0.1:{bp}", 1: f"127.0.0.1:{gp}"})
    front = ServingServer(generate_fn=rs.generate)
    fp = front.start()
    try:
        for _ in range(3):
            tokens, reason = generate_remote(
                f"127.0.0.1:{fp}", {"prompt": [5, 17, 3],
                                    "max_new_tokens": 4}, 30.0)
            assert reason == "length"
            assert tokens == want
        assert 0 in rs.dead and 1 not in rs.dead
    finally:
        front.shutdown()
        good.shutdown()
        bad.shutdown()
        s.close(drain=False)
