"""The port's offline tools (``python -m horovod_tpu_torch.tools.*``)
against the JAX package's scripts, the launcher's telemetry flags, and
a gloo world of 2 under the static launcher:

* ``metrics_summary`` prints the JAX script's table on the same JSONL
  (``--last`` too) and gives its ``--check`` verdicts;
  ``tests/test_faults.py::test_retries_land_in_step_jsonl_and_summary``'s
  twin;
* ``flight_analyze`` gives the JAX script's report, text and JSON on
  the same dumps;
* ``trace_merge`` gives the JAX script's merged trace and report on the
  same timelines, flight dumps and incident log; its ``--xplane`` reads
  the sampled profiler's directories, each a ``torch.profiler`` Chrome
  trace (a deliberate difference: the JAX tool reads an xplane);
* ``--timeline-filename``, ``--timeline-mark-cycles``,
  ``--flight-recorder``/``--no-flight-recorder``, ``--flight-dir`` and
  ``--prof-every``/``--prof-dir``/``--prof-duty-cycle`` reach the
  workers' knobs as the JAX launcher's do, and a launched worker reads
  ``--prof-every``;
* a static ``launch -np 2`` world over gloo: the launcher's rendezvous
  store serves the workers' pushes on ``/metrics`` labeled by rank
  (counters equal to the collectives each rank issued), a SIGUSR2 dump
  of rank 1 lands on ``/flight/1`` with its receipt, and each rank's
  step record carries the JAX package's fusion, gradient and wire
  fields for the same parameters at world 2.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from horovod_tpu.utils import flight as jflight
from horovod_tpu.utils import metrics as jmetrics
from horovod_tpu_torch.tools import flight_analyze, metrics_summary, \
    trace_merge
from horovod_tpu_torch.utils import flight, metrics, timeline

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (metrics, jmetrics, flight, jflight):
        mod.reset()
    yield
    for mod in (metrics, jmetrics, flight, jflight):
        mod.reset()


def _run_log(path, seed, steps=5):
    """A seeded step JSONL with collectives, plans, wire, retries and
    elastic events, and two out-of-band event lines."""
    rng = np.random.RandomState(seed)
    metrics.enable()
    metrics.step_stats.open_log(path)
    for s in range(steps):
        with metrics.step():
            for _ in range(rng.randint(1, 4)):
                metrics.record_collective(
                    ("allreduce", "broadcast")[rng.randint(2)], "float32",
                    int(rng.randint(1, 1 << 16)))
            if s == 0:
                metrics.record_fusion_plan(12, 3, 1 << 20,
                                           [1 << 19, 1 << 18, 7])
            metrics.record_grad_reduction(int(rng.randint(1, 1 << 20)), 3)
            metrics.record_wire_bytes(4096, 1100)
            if rng.rand() < 0.5:
                metrics.record_retry("http.put")
            if s == 2:
                metrics.record_retry_giveup("http.get")
                metrics.record_elastic_event("reset")
    metrics.step_stats.close_log()
    with open(path, "a") as f:
        f.write(json.dumps({"event": "autotune", "autotune": {
            "kind": "trial", "dimension": "fusion", "step_s": 0.01,
            "overrides": {"fusion_threshold": 64}}}) + "\n")
        f.write(json.dumps({"rule": "slow", "state": "fire", "rank": 1,
                            "signal": "step_time",
                            "time_unix": time.time()}) + "\n")


@pytest.mark.parametrize("argv", [[], ["--last", "2"], ["--check"]])
def test_metrics_summary_prints_the_jax_table(argv, tmp_path, capsys):
    path = str(tmp_path / "run.jsonl")
    _run_log(path, seed=len(argv))
    theirs = _script("metrics_summary")
    assert theirs.main([path] + argv) == 0
    want = capsys.readouterr()
    assert metrics_summary.main([path] + argv) == 0
    got = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    if not argv:
        assert "wire compression" in got.out and "steps: 5" in got.out


def test_metrics_summary_check_verdicts(tmp_path, capsys):
    theirs = _script("metrics_summary")
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"step": 1}\nnot json\n')
    for path in (empty, bad, tmp_path / "missing.jsonl"):
        assert metrics_summary.main([str(path), "--check"]) == 1
        got = capsys.readouterr().out
        assert theirs.main([str(path), "--check"]) == 1
        assert capsys.readouterr().out == got
        assert "metrics check FAILED" in got


def test_retries_land_in_step_jsonl_and_summary(tmp_path, capsys):
    metrics.enable()
    log = str(tmp_path / "m.jsonl")
    metrics.step_stats.open_log(log)
    with metrics.step():
        metrics.record_retry("http.put")
        metrics.record_retry("http.put")
        metrics.record_retry_giveup("http.get")
    metrics.step_stats.close_log()
    rec = json.loads(open(log).read().splitlines()[-1])
    assert rec["retries"] == {"http.put": 2}
    assert rec["retry_giveups"] == {"http.get": 1}
    assert metrics_summary.main([log]) == 0
    out = capsys.readouterr().out
    assert "control-plane retries: http.put=2" in out
    assert "retry GIVE-UPS: http.get=1" in out


def _dumps(tmp_path):
    """Two ranks' dumps: rank 1 never submitted the second round."""
    paths = []
    for r, evs, off in (
            (0, [("enqueue", "g0"), ("enqueue", "g1"),
                 ("exec_end", "g0", ["g0", "g1"]), ("enqueue", "g0"),
                 ("enqueue", "g1"), ("stall_abort", "g0")], 0.25),
            (1, [("enqueue", "g0"), ("enqueue", "g1"),
                 ("exec_end", "g0", ["g0", "g1"])], -0.25)):
        path = tmp_path / f"flight_rank{r}.jsonl"
        with open(path, "w") as f:
            f.write(json.dumps({"flight_header": 1, "rank": r,
                                "reason": "test", "time_unix": 1e9 + r,
                                "events": len(evs),
                                "clock_offset_s": off}) + "\n")
            for i, ev in enumerate(evs):
                d = {"seq": i, "t_mono": float(i), "t_wall": 1e9 + i + r,
                     "kind": ev[0], "name": ev[1]}
                if len(ev) > 2:
                    d["names"] = ev[2]
                f.write(json.dumps(d) + "\n")
        paths.append(str(path))
    return paths


def test_flight_analyze_gives_the_jax_report(tmp_path, capsys):
    paths = _dumps(tmp_path)
    theirs = _script("flight_analyze")
    dup = str(tmp_path / "dup.jsonl")
    with open(dup, "w") as f:
        f.write(open(paths[0]).read().replace('"reason": "test"',
                                              '"reason": "later"'))
    for files in (paths, paths + [dup]):
        mine_rep = flight_analyze.analyze(
            [flight_analyze.load_file(p) for p in files])
        their_rep = theirs.analyze([theirs.load_file(p) for p in files])
        assert mine_rep == their_rep
        assert flight_analyze.render(mine_rep) == theirs.render(their_rep)
    assert mine_rep["suspected_straggler_ranks"] == [1]
    assert mine_rep["ranks"][0]["dump_reason"] == "later"
    out_m, out_t = str(tmp_path / "m.json"), str(tmp_path / "t.json")
    assert flight_analyze.main(paths + ["--json", out_m]) == 0
    got = capsys.readouterr().out
    assert theirs.main(paths + ["--json", out_t]) == 0
    assert capsys.readouterr().out == got
    assert json.load(open(out_m)) == json.load(open(out_t))
    assert "SUSPECTED STRAGGLER rank 1" in got
    assert flight_analyze.main([]) == 1


def _sources(tmp_path):
    """A host timeline per rank, flight dumps and an incident log, from
    the port's own recorders."""
    tls = []
    for r in (0, 1):
        flight.set_rank(r)
        path = str(tmp_path / f"tl_rank{r}.json")
        tl = timeline.Timeline(path)
        with tl.activity("allreduce", timeline.XLA_COLLECTIVE):
            tl.instant("fusion", timeline.FUSION_PLAN, {"buckets": 2})
        tl.stop()
        tls.append(path)
    fdir = tmp_path / "flight"
    fdir.mkdir()
    for r in (0, 1):
        flight.reset()
        flight.configure(enabled_override=True, rank=r,
                         directory=str(fdir), handlers=False)
        flight.record("enqueue", "g0")
        flight.record("retry", "http.put")
        flight.dump("test")
    inc = tmp_path / "incidents.jsonl"
    inc.write_text(json.dumps({"rule": "slow", "state": "fire", "rank": 1,
                               "time_unix": time.time()}) + "\n")
    return tls, str(fdir), str(inc)


def test_trace_merge_gives_the_jax_trace(tmp_path, capsys):
    tls, fdir, inc = _sources(tmp_path)
    theirs = _script("trace_merge")
    args = ["--timeline", str(tmp_path / "tl_rank*.json"), "--flight", fdir,
            "--incidents", inc]
    mine_out, their_out = str(tmp_path / "m.json"), str(tmp_path / "t.json")
    assert trace_merge.main(args + ["--out", mine_out]) == 0
    mine_rep = json.loads(capsys.readouterr().out)
    assert theirs.main(args + ["--out", their_out]) == 0
    their_rep = json.loads(capsys.readouterr().out)
    assert mine_rep.pop("out") == mine_out
    assert their_rep.pop("out") == their_out
    assert mine_rep == their_rep
    assert set(mine_rep["by_source"]) == {
        "rank0/host", "rank1/host", "rank0/flight", "rank1/flight",
        "rank1/incident"}
    mine, their = json.load(open(mine_out)), json.load(open(their_out))
    assert mine["metadata"].pop("tool") == \
        "horovod_tpu_torch.tools.trace_merge"
    their["metadata"].pop("tool")
    assert mine == their


def test_trace_merge_refuses_the_device_leg(tmp_path, capsys):
    """The device leg, which the tool refused until the sampled
    profiler: ``--xplane`` now reads a profiler directory (a sample's
    Chrome trace and sidecar) and puts the card's spans on the rank's
    ``device:*`` thread; a directory without a sample gives no events
    and exit 1, as the JAX script does."""
    assert trace_merge.main(["--xplane", str(tmp_path),
                             "--out", str(tmp_path / "o.json")]) == 1
    assert "no events" in capsys.readouterr().err
    d = tmp_path / "rank1" / "step4"
    d.mkdir(parents=True)
    (d / "hvd_prof_meta.json").write_text(json.dumps(
        {"hvd_prof_meta": 1, "rank": 1, "step": 4,
         "t_start_unix": 1_700_000_000.0, "clock_offset_s": 0.5}))
    (d / "trace.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10.0,
         "dur": 5.0, "pid": 0, "tid": 7, "args": {"device": 0,
                                                  "stream": 7}}]}))
    assert trace_merge.main(["--xplane", str(tmp_path),
                             "--out", str(tmp_path / "o.json")]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["by_source"] == {"rank1/device": 1}
    assert report["clock_offsets_s"] == {"1": 0.5}
    (ev,) = [e for e in json.load(open(tmp_path / "o.json"))["traceEvents"]
             if e["ph"] == "X"]
    assert (ev["name"], ev["tid"], ev["dur"]) == ("gemm", "device:stream 7",
                                                  5.0)


# ------------------------------------------------- the launcher's flags

_OBSERVE_FLAGS = {
    "--timeline-filename": (["--timeline-filename", "/tmp/t.json"],
                            {"timeline_filename": "/tmp/t.json"}),
    "--timeline-mark-cycles": (["--timeline-mark-cycles"],
                               {"timeline_mark_cycles": True}),
    "--flight-recorder": (["--flight-recorder"], {"flight_recorder": True}),
    "--no-flight-recorder": (["--no-flight-recorder"],
                             {"flight_recorder": False}),
    "--flight-dir": (["--flight-dir", "/tmp/fd"], {"flight_dir": "/tmp/fd"}),
    "--prof-every": (["--prof-every", "5"], {"prof_every": 5}),
    "--prof-dir": (["--prof-dir", "/tmp/pd"], {"prof_dir": "/tmp/pd"}),
    "--prof-duty-cycle": (["--prof-duty-cycle", "0.5"],
                          {"prof_duty_cycle": 0.5}),
}


@pytest.mark.parametrize("flag", sorted(_OBSERVE_FLAGS))
def test_observability_flag_reaches_the_workers_knobs(flag, monkeypatch):
    """The flag is accepted, exported into the slot env as the JAX
    launcher exports it, and read by the worker's knobs as the JAX
    package's knobs read it."""
    from horovod_tpu.core.knobs import Knobs as JKnobs
    from horovod_tpu.runner import launch as jax_launch
    from horovod_tpu.runner.util import config_parser as jax_config
    from horovod_tpu_torch.core.knobs import Knobs
    from horovod_tpu_torch.runner import launch
    from horovod_tpu_torch.runner.util import config_parser

    flags, want = _OBSERVE_FLAGS[flag]
    argv = flags + ["python", "train.py"]
    args = launch.parse_args(argv)
    assert launch.unported_flags(args, argv) == []
    env = config_parser.env_from_args(args, {})
    assert env == jax_config.env_from_args(jax_launch.parse_args(argv), {})
    for k in list(os.environ):
        if k.startswith(("HOROVOD_", "HVD_TPU_")):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mine, theirs = Knobs.from_env(), JKnobs.from_env()
    for field, value in want.items():
        assert getattr(mine, field) == getattr(theirs, field) == value


def test_prof_every_reaches_a_launched_worker(tmp_path):
    """``hvdrun --prof-every 3 --prof-dir D`` starts its worker with the
    profiler armed by ``init()`` from those knobs."""
    out = tmp_path / "knobs.json"
    code = ("import json, sys\n"
            "import horovod_tpu_torch as hvd\n"
            "hvd.init(device='cpu')\n"
            "s = hvd.prof.summary()\n"
            "json.dump({'every': s['every'], 'active': s['active'],\n"
            "           'dir': hvd.prof.default_dir()},\n"
            "          open(sys.argv[1], 'w'))\n"
            "hvd.shutdown()\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "1", "-H", "localhost:1", "--prof-every", "3", "--prof-dir",
         str(tmp_path / "prof"), sys.executable, "-c", code, str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    got = json.load(open(out))
    assert got == {"every": 3, "active": True,
                   "dir": str(tmp_path / "prof" / "rank0")}


# --------------------------------------- a static world of 2 over gloo

_WORKER = r'''
import json, os, signal, sys, time, urllib.request
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.runner.http import http_client
from horovod_tpu_torch.utils import flight, metrics

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
addr = os.environ["HVD_TPU_RENDEZVOUS_ADDR"]
port = int(os.environ["HVD_TPU_RENDEZVOUS_PORT"])
metrics.step_stats.open_log(os.path.join(out, f"steps{r}.jsonl"))
model = torch.nn.Linear(4, 3)
opt = hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=0.1),
    named_parameters=[("b", model.bias), ("w", model.weight)])
hvd.broadcast_parameters(model.state_dict())
with hvd.metrics.step():
    model(torch.ones(2, 4) * (r + 1)).sum().backward()
    opt.step()
    opt.zero_grad()
for _ in range(3):
    hvd.allreduce(torch.ones(8))
assert metrics.push_once(addr, port, r)
res = {"flight_dir": flight.dump_dir(), "sink": list(flight.sink()),
       "flight_on": flight.enabled()}
if r == 1:
    os.kill(os.getpid(), signal.SIGUSR2)
    deadline = time.monotonic() + 10
    while flight.dump_count() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    res["dumps"] = flight.dump_count()
hvd.barrier()
if r == 0:
    with urllib.request.urlopen(f"http://{addr}:{port}/metrics",
                                timeout=10) as resp:
        res["scrape"] = resp.read().decode()
    res["flight1"] = http_client.get(addr, port, "flight", "1").decode()
    res["meta1"] = json.loads(http_client.get(addr, port, "flight_meta",
                                              "1"))
hvd.barrier()
with open(os.path.join(out, f"res{r}.json"), "w") as f:
    json.dump(res, f)
hvd.shutdown()
'''


def _jax_world2_record(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    import horovod_tpu as jhvd

    jhvd.init(mesh=Mesh(np.array(jax.devices()[:2]), ("hvd",)))
    try:
        jmetrics.enable()
        path = str(tmp_path / "jax2.jsonl")
        jmetrics.step_stats.open_log(path)
        tree = {"b": jnp.ones((3,)), "w": jnp.ones((3, 4))}
        opt = jhvd.DistributedOptimizer(optax.sgd(0.1))
        state = opt.init(tree)
        with jmetrics.step():
            opt.update(tree, state, tree)
        jmetrics.step_stats.close_log()
    finally:
        jhvd.shutdown()
    rec = json.loads(open(path).read().splitlines()[-1])
    return {k: rec[k] for k in ("fusion", "grad_bytes", "wire")}


def test_static_world_serves_metrics_flight_and_step_records(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    fdir = tmp_path / "flight"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO),
               HOROVOD_METRICS="1", HOROVOD_METRICS_PUSH_INTERVAL_S="30")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", "-H", "localhost:2", "--flight-dir", str(fdir),
         sys.executable, str(worker), str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = [json.load(open(tmp_path / f"res{r}.json")) for r in (0, 1)]
    for r in res:
        assert r["flight_on"] and r["flight_dir"] == str(fdir)
        assert r["sink"][0] == "127.0.0.1"
    scrape = res[0]["scrape"]
    assert metrics.lint_exposition(scrape) == []
    for rank in ("0", "1"):
        for op, n, nbytes in (("allreduce", 3, 96), ("broadcast", 2, 60)):
            labels = f'op="{op}",dtype="float32",rank="{rank}"'
            assert f"hvd_collectives_total{{{labels}}} {n}\n" in scrape
            assert f"hvd_collective_bytes_total{{{labels}}} {nbytes}\n" \
                in scrape
    assert res[1]["dumps"] == 1
    header, events = flight.parse_dump(res[0]["flight1"])
    assert header["rank"] == 1 and header["reason"] == "sigusr2"
    assert events[-1]["kind"] == "signal_dump"
    assert res[0]["meta1"]["bytes"] == len(res[0]["flight1"].encode())
    assert (fdir / "flight_rank1.jsonl").exists()
    want = _jax_world2_record(tmp_path)
    for r in (0, 1):
        (rec,) = [json.loads(line)
                  for line in open(tmp_path / f"steps{r}.jsonl")]
        assert {k: rec.get(k) for k in want} == want
    assert want["grad_bytes"] == 60 and want["fusion"]["plans"] == 1
