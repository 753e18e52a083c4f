"""The port's metric catalogue against the JAX package's.

* every family the JAX ``utils/metrics.py`` registers (each
  ``registry.counter``/``gauge``/``histogram`` call and the native-stats
  gauge table) exists in the port's with the same type, label names,
  help text and buckets; the only families missing are ``_LATER``'s,
  each naming the ROADMAP queue A entry that brings it (the pod label of
  a step record, ``set_pod_label``, is set only by entry 14's multipod);
* part 3's record functions, called with the same seeded arguments in
  both packages, render the same exposition byte for byte, and the
  native-stats provider feeds the same gauges;
* the FSDP step records the JAX step's families (the twin of
  tests/test_fsdp.py's ``test_make_lm_train_step_routes_fsdp_and_knob_gates``)
  and its step record carries the JAX record's ``fsdp`` and
  ``overlap_window_frac`` fields.
"""

import ast
import functools
import inspect
import json
import pathlib

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.utils import metrics as jmetrics
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.utils import flight, metrics

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

#: families the port does not register yet, by the queue A entry that
#: brings them
_LATER = {
    "hvd_autotune_trials_total": "entry 12",
    "hvd_autotune_trial_errors_total": "entry 12",
    "hvd_autotune_best_step_s": "entry 12",
    "hvd_autotune_dimension": "entry 12",
}


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (metrics, jmetrics, flight):
        mod.reset()
    _build._SURFACES.clear()
    yield
    for mod in (metrics, jmetrics, flight):
        mod.reset()
    _build._SURFACES.clear()


def _const(node):
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(_const(e) for e in node.elts)
    if isinstance(node, ast.Name):
        return node.id  # a named constant (the bucket ladders)
    return None


def _catalogue(path):
    """{family: (kind, label names, help, buckets)} of every registry
    call with a literal name in a module, and its native gauge table."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("counter", "gauge", "histogram")
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "registry"):
            continue
        args = list(node.args)
        kw = {k.arg: k.value for k in node.keywords}
        name = _const(args[0]) if args else None
        if not isinstance(name, str):
            continue
        help_ = _const(args[1]) if len(args) > 1 else _const(
            kw.get("help"))
        labels = (_const(args[2]) if len(args) > 2
                  else _const(kw["labelnames"]) if "labelnames" in kw
                  else ())
        buckets = _const(kw["buckets"]) if "buckets" in kw else None
        ent = (node.func.attr, tuple(labels or ()), help_, buckets)
        assert out.setdefault(name, ent) == ent, (path, name)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "_NATIVE_GAUGES"
                        for t in node.targets)):
            for v in node.value.values:
                name, help_ = _const(v.elts[0]), _const(v.elts[1])
                out.setdefault(name, ("gauge", (), help_, None))
    return out


def test_every_jax_family_is_the_ports_or_awaits_its_entry():
    jax_cat = _catalogue(REPO / "horovod_tpu" / "utils" / "metrics.py")
    port_cat = _catalogue(REPO / "horovod_tpu_torch" / "utils"
                          / "metrics.py")
    assert len(jax_cat) > 60
    missing = sorted(set(jax_cat) - set(port_cat))
    assert missing == sorted(_LATER), missing
    for name, ent in jax_cat.items():
        if name in _LATER:
            continue
        kind, labels, help_, buckets = port_cat[name]
        assert (kind, labels, help_, buckets) == ent, name
    assert metrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS
    assert metrics.RATIO_BUCKETS == jmetrics.RATIO_BUCKETS
    assert set(port_cat) - set(jax_cat) == set()


def test_every_jax_record_function_is_the_ports_or_awaits_its_entry():
    def names(mod):
        return {n for n, f in vars(mod).items()
                if inspect.isfunction(f) and f.__module__ == mod.__name__
                and n.startswith(("record_", "set_"))}

    later = {"record_autotune_trial", "record_autotune_pin"}
    assert names(jmetrics) - names(metrics) == later
    for name in names(jmetrics) - later:
        jp = inspect.signature(getattr(jmetrics, name)).parameters
        tp = inspect.signature(getattr(metrics, name)).parameters
        assert list(tp) == list(jp), name
        assert [p.default for p in tp.values()] == [
            p.default for p in jp.values()], name


def _part3_calls(seed):
    rng = np.random.RandomState(seed)
    ops = ("allreduce", "allgather", "broadcast")
    slos = ("interactive", "standard", "batch")
    calls = []
    for _ in range(80):
        k = rng.randint(19)
        t = float(rng.exponential(0.01))
        if k == 0:
            calls.append(("record_negotiation_latency", (t,)))
        elif k == 1:
            calls.append(("record_batch_execution", (
                ops[rng.randint(3)], int(rng.randint(1, 9)),
                int(rng.randint(1, 1 << 20)), t)))
        elif k == 2:
            calls.append(("record_fused_collective", (
                ("quantized_psum", "reduce_scatter_rows", "pack_epilogue",
                 "matmul_epilogue", "decode_append_attend")[
                    rng.randint(5)],)))
        elif k == 3:
            calls.append(("record_overlap_window", (float(rng.rand()),)))
        elif k == 4:
            calls.append(("record_fsdp_step", (
                int(rng.randint(1, 1 << 20)), int(rng.randint(1, 1 << 22)),
                int(rng.randint(0, 2)) * int(rng.randint(1, 1 << 20)),
                int(rng.randint(0, 2)) * int(rng.randint(1, 1 << 16)))))
        elif k == 5:
            calls.append(("record_serving_request", (
                t, int((200, 429, 503)[rng.randint(3)]))))
        elif k == 6:
            b = int((1, 4, 16, 64)[rng.randint(4)])
            calls.append(("record_serving_batch", (
                b, int(rng.randint(1, b + 1)))))
        elif k == 7:
            calls.append(("record_serving_compile", (
                int((1, 4, 16)[rng.randint(3)]), t)))
        elif k == 8:
            calls.append(("set_serving_inflight", (
                int(rng.randint(0, 9)), ("", "0", "1")[rng.randint(3)])))
        elif k == 9:
            calls.append(("record_serving_failover", (str(rng.randint(3)),)))
        elif k == 10:
            calls.append(("record_decode_prefill", (
                int((8, 16, 32)[rng.randint(3)]), t)))
        elif k == 11:
            calls.append(("record_decode_iteration", (
                int(rng.randint(1, 9)), t)))
        elif k == 12:
            calls.append(("record_decode_tokens", (int(rng.randint(0, 9)),)))
        elif k == 13:
            total = int(rng.randint(1, 9))
            calls.append(("set_decode_slots", (
                total, int(rng.randint(0, total + 1)),
                int(rng.randint(0, 5)))))
        elif k == 14:
            calls.append(("record_decode_eviction", (
                ("eos", "length", "deadline", "shed", "drain")[
                    rng.randint(5)],)))
        elif k == 15:
            calls.append(("record_autoscale", (
                ("grow", "shrink")[rng.randint(2)],)))
        elif k == 16:
            calls.append(("set_serving_replicas", (int(rng.randint(1, 5)),)))
        elif k == 17:
            calls.append(("record_serving_tpot", (t, slos[rng.randint(3)])))
        else:
            calls.append(("record_serving_queue_wait",
                          (t, slos[rng.randint(3)])))
    return calls


_NATIVE = {"cache_hits": 7, "bytes_negotiated": 4096, "stall_warnings": 1,
           "queue_depth": 3, "fast_path_hits": 12, "fast_path_steps": 3,
           "fast_path_activations": 1, "fast_path_invalidations": 0,
           "fast_path_active": 1, "negotiation_bypassed_bytes": 8192,
           "cycles": 99, "busy_cycles": 40, "wait_us": 1500000,
           "work_us": 2500, "bytes_rx": 640, "bytes_tx": 320,
           "cache_hit_positions": 5, "responses": 16,
           "executor_seconds": 0.5}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_part3_records_render_the_jax_exposition(seed):
    for mod in (metrics, jmetrics):
        mod.enable()
        for name, args in _part3_calls(seed):
            getattr(mod, name)(*args)
        mod.set_native_stats_provider(lambda: dict(_NATIVE))
    text = metrics.scrape()
    assert text == jmetrics.scrape()
    assert not metrics.lint_exposition(text)
    assert "hvd_coord_wait_seconds_total 1.5" in text
    assert "executor_seconds" not in text  # not a native gauge
    for mod in (metrics, jmetrics):
        mod.set_native_stats_provider(None)


def test_step_records_carry_the_jax_records_fields(tmp_path):
    """A step with FSDP, the overlap pin and native stats: the JSONL
    records of both packages are equal but for their clocks."""
    recs = {}
    for name, mod in (("port", metrics), ("jax", jmetrics)):
        path = tmp_path / f"{name}.jsonl"
        mod.enable()
        mod.step_stats.open_log(str(path))
        stats = dict(_NATIVE)
        mod.set_native_stats_provider(lambda s=stats: s)
        for step in range(2):
            with mod.step():
                mod.record_collective("allreduce", "float32", 1024)
                mod.record_fsdp_step(4096, 8192, 1024 * step, 0)
                mod.record_overlap_window(0.25 * (step + 1))
                mod.record_negotiation_latency(0.001)
            stats["cache_hits"] += 5
        mod.step_stats.close_log()
        mod.set_native_stats_provider(None)
        recs[name] = [json.loads(line) for line in path.read_text()
                      .splitlines()]
        for r in recs[name]:
            r.pop("time_unix"), r.pop("step_time_s")
            r["negotiation"].pop("sum_s")
    assert recs["port"] == recs["jax"]
    assert recs["port"][1]["fsdp"] == {
        "hbm_param_bytes": 4096, "gather_bytes": 8192,
        "regather_bytes": 1024, "offload_bytes": 0}
    assert recs["port"][1]["native"]["cache_hits"] == 5


def test_fused_surface_is_recorded_once_at_its_first_launch(monkeypatch):
    """The port records a fused surface at its first launch on the card
    (the JAX package at its lowering): once a process, only with metrics
    on. On the CPU the plain versions run and record nothing, as the JAX
    package's unfused path does."""
    from horovod_tpu_torch.ops import quantized_collectives as qc
    from horovod_tpu_torch.ops import ring_pack

    metrics.enable()
    ring_pack.pack_rows_fused(torch.ones(10), 4)
    qc.emulated_quantized_psum([torch.ones(64)] * 2, 2, 32)
    assert "hvd_fused_collective" not in metrics.scrape()
    metrics.disable()
    _build.note_surface("pack_epilogue")  # off: not recorded, not spent
    metrics.enable()
    for _ in range(3):
        _build.note_surface("pack_epilogue")
    _build.note_surface("quantized_psum")
    snap = metrics.registry.snapshot()
    assert snap["hvd_fused_collective_lowerings_total"] == {
        "pack_epilogue": 1.0, "quantized_psum": 1.0}
    assert snap["hvd_fused_collectives_enabled"] == {"": 1.0}
    # every launching wrapper notes its surface
    for fn, surface in ((ring_pack.pack_rows_cuda, "pack_epilogue"),
                        (ring_pack.matmul_pack_cuda, "matmul_epilogue"),
                        (qc.start_quantized_psum, "quantized_psum"),
                        (qc.emulated_quantized_psum, "quantized_psum"),
                        (qc.fused_quantized_reduce_scatter_rows,
                         "reduce_scatter_rows"),
                        (qc.emulated_quantized_reduce_scatter_rows,
                         "reduce_scatter_rows")):
        assert f'note_surface("{surface}")' in inspect.getsource(fn), fn
    from horovod_tpu_torch.ops import decode_attention as da

    assert 'note_surface("decode_append_attend")' in inspect.getsource(
        da._count)


# ---------------------------------------------------------------------------
# the FSDP step's families
# ---------------------------------------------------------------------------

_FSDP_FAMILIES = ("hvd_hbm_param_bytes", "hvd_fsdp_gather_bytes_total",
                  "hvd_fsdp_regather_bytes_total",
                  "hvd_grad_reduced_bytes_total", "hvd_grad_reductions_total",
                  "hvd_wire_bytes_logical_total", "hvd_wire_bytes_sent_total",
                  "hvd_overlap_window_frac")
_CFG = dict(vocab_size=64, num_layers=2, num_heads=2, hidden_size=32,
            max_seq_len=16)


def _jax_fsdp_step_families(jhvd):
    """tests/test_fsdp.py's routed FSDP step (fsdp = 8, regather by
    default) with metrics on: its families and types."""
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.models.transformer import TransformerConfig
    from horovod_tpu.parallel.mesh import make_mesh
    from horovod_tpu.parallel.train import make_lm_train_step

    toks = jnp.asarray(np.random.RandomState(1).randint(0, 64, (16, 16)),
                       jnp.int32)
    opt = jhvd.FullyShardedOptimizer(optax.adamw(1e-3), axis_name="fsdp",
                                     fusion_threshold_bytes=8 << 10)
    jmetrics.enable()
    init_fn, step_fn, _ = make_lm_train_step(
        TransformerConfig(dtype=jnp.float32, **_CFG), opt,
        make_mesh(dp=1, fsdp=8))
    rows, state = init_fn(jax.random.PRNGKey(0), toks[:2])
    _, _, loss = step_fn(rows, state, toks)
    assert np.isfinite(float(loss))
    return jmetrics.registry.snapshot(), jmetrics.scrape()


def test_fsdp_step_records_the_jax_steps_families(hvd8):
    jsnap, jtext = _jax_fsdp_step_families(hvd8)
    hvd.init(device="cpu")
    try:
        metrics.enable()
        cfg = tt.TransformerConfig(dtype=torch.float32, **_CFG)
        _, step = hvd.make_lm_train_step(
            cfg, hvd.FullyShardedOptimizer(
                functools.partial(torch.optim.AdamW, lr=1e-3),
                fusion_threshold_bytes=8 << 10), device="cpu")
        tokens = torch.from_numpy(
            np.random.RandomState(1).randint(0, 64, (2, 16)))
        assert np.isfinite(float(step(tokens)))
        snap, text = metrics.registry.snapshot(), metrics.scrape()
    finally:
        hvd.shutdown()
    for name in _FSDP_FAMILIES:
        assert name in jsnap and name in snap, name
        jtype = next(ln for ln in jtext.splitlines()
                     if ln.startswith(f"# TYPE {name} "))
        assert f"\n{jtype}\n" in f"\n{text}", name
        assert list(snap[name]) == list(jsnap[name]), name
    v = step.vag
    # a rank records its step once (the JAX step once a device)
    assert snap["hvd_hbm_param_bytes"][""] == v.param_bytes
    assert snap["hvd_fsdp_gather_bytes_total"][""] == v.gather_bytes
    assert snap["hvd_fsdp_regather_bytes_total"][""] == v.regather_bytes
    assert snap["hvd_overlap_window_frac"][""] == v.pinned_frac
    assert snap["hvd_grad_reductions_total"][""] == 1
    assert snap["hvd_wire_bytes_sent_total"][""] \
        == snap["hvd_wire_bytes_logical_total"][""] \
        == snap["hvd_grad_reduced_bytes_total"][""] \
        == step.layout.param_bytes
