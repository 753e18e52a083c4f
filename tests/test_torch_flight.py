"""The port's flight recorder (horovod_tpu_torch.utils.flight) against
the JAX package's (horovod_tpu.utils.flight), and its control plane:

* the disabled path by structure (nothing recorded, no lock taken, no
  dump), the bounded ring, its resize;
* dumps: a port dump parses with the JAX ``parse_dump`` and a JAX dump
  with the port's, to the same events; the same dumps give the same
  ``straggler_report`` text;
* the rendezvous store's ``GET /clock``, ``PUT /flight/<rank>`` with its
  receipt stamp, the peer fetch, the metrics push feeding the
  aggregated ``/metrics``, and ``RendezvousServer.init`` clearing the
  flight and push scopes of the round before;
* the triggers: SIGUSR2 on demand (chaining a handler found before it),
  the crash excepthook, the preemption handler's ``preempt`` record and
  dump; the non-blocking dump lock; the anomaly dump's rate limit;
* the knobs through ``init``, and the elastic driver's persisted dumps
  with their receipts.

Every test that installs the process-wide handlers puts back what it
found (xdist runs several tests a process).
"""

import json
import os
import signal
import sys
import time
import types
import urllib.request

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.utils import flight as jflight
from horovod_tpu_torch.utils import flight, metrics

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    found = (signal.getsignal(signal.SIGUSR2), sys.excepthook)
    flight.reset()
    jflight.reset()
    yield
    flight.uninstall_handlers()
    flight.reset()
    jflight.reset()
    signal.signal(signal.SIGUSR2, found[0])
    sys.excepthook = found[1]


@pytest.fixture()
def kv_server():
    from horovod_tpu_torch.runner.http.http_server import KVStoreServer

    srv = KVStoreServer()
    srv.start_server()
    yield srv
    srv.shutdown_server()


class _RaisingLock:
    def __enter__(self):
        raise AssertionError("the disabled recorder took a lock")

    def __exit__(self, *exc):
        return False

    def acquire(self, *a, **k):
        raise AssertionError("the disabled recorder took a lock")

    release = acquire


def test_disabled_records_nothing_and_takes_no_lock(monkeypatch):
    assert not flight.enabled()
    monkeypatch.setattr(flight, "_dump_lock", _RaisingLock())
    for i in range(1000):
        flight.record("enqueue", f"g{i}", op=1, handle=7)
    assert flight.event_count() == 0
    assert flight.dump("manual") is None
    assert flight.anomaly_dump("rule") is None
    assert flight.straggler_report(["g0"], 2) == ""


def test_ring_is_bounded_ordered_and_resizes():
    flight.enable(capacity=32)
    for i in range(100):
        flight.record("enqueue", f"g{i}")
    assert flight.event_count() == 32
    events = flight.snapshot()
    assert [e[4] for e in events] == [f"g{i}" for i in range(68, 100)]
    assert [e[0] for e in events] == sorted(e[0] for e in events)
    flight.enable(capacity=128)
    assert flight.event_count() == 32
    flight.enable(capacity=4)
    assert flight.event_count() == 16  # the floor


def _record_both(mod):
    mod.record("enqueue", "g0", op=1, handle=5)
    mod.record("exec_end", "g0", names=["g0", "g1"])
    mod.record("fault", "http.put", action="error")
    mod.record("autotune", "pin", config={"fusion": 64})


def _masked(events):
    return [{k: v for k, v in e.items() if k not in ("t_mono", "t_wall")}
            for e in events]


def test_dumps_parse_across_packages(tmp_path):
    flight.configure(enabled_override=True, rank=3,
                     directory=str(tmp_path / "mine"), handlers=False)
    jflight.configure(enabled_override=True, rank=3,
                      directory=str(tmp_path / "theirs"), handlers=False)
    _record_both(flight)
    _record_both(jflight)
    mine_path, theirs_path = flight.dump("unit"), jflight.dump("unit")
    assert mine_path.endswith("flight_rank3.jsonl")
    mine_text, theirs_text = open(mine_path).read(), open(theirs_path).read()
    mh, me = jflight.parse_dump(mine_text)
    th, te = flight.parse_dump(theirs_text)
    assert (mh["rank"], mh["reason"], mh["events"]) == (3, "unit", 4)
    assert mh["autotune"] == th["autotune"] == {"name": "pin",
                                                "config": {"fusion": 64}}
    assert set(mh) == set(th)
    assert _masked(me) == _masked(te)
    assert me[1]["names"] == ["g0", "g1"] and me[2]["action"] == "error"
    assert flight.parse_dump(mine_text) == jflight.parse_dump(mine_text)
    # a truncated dump still yields what it carries
    h, ev = flight.parse_dump(mine_text[:-20])
    assert h["rank"] == 3 and len(ev) == 3
    # a second dump overwrites the file: it is the last dump
    flight.record("stall_abort", "g1")
    assert flight.dump("again") == mine_path
    h2, ev2 = flight.parse_dump(open(mine_path).read())
    assert h2["reason"] == "again" and h2["dump"] == 2 and len(ev2) == 5


def test_clock_route_and_dump_ship_with_receipt(kv_server, tmp_path):
    from horovod_tpu_torch.runner.http.http_client import server_clock
    from horovod_tpu_torch.runner.http.http_server import FLIGHT_META_SCOPE

    t, rtt = server_clock("127.0.0.1", kv_server.port)
    assert abs(t - time.time()) < 5 and 0 <= rtt < 5
    flight.configure(enabled_override=True, rank=2,
                     sink_addr="127.0.0.1", sink_port=kv_server.port,
                     directory=str(tmp_path), handlers=False)
    flight.record("enqueue", "g0")
    flight.dump("ship_it")
    with urllib.request.urlopen(
            f"http://127.0.0.1:{kv_server.port}/flight/2", timeout=5) as r:
        header, events = jflight.parse_dump(r.read().decode())
    assert header["rank"] == 2 and len(events) == 1
    assert abs(header["clock_offset_s"]) < 5.0
    assert header["clock_rtt_s"] >= 0
    meta = json.loads(kv_server.store[FLIGHT_META_SCOPE]["2"])
    assert meta["bytes"] == len(kv_server.store["flight"]["2"])
    assert abs(meta["recv_time_unix"] - time.time()) < 5.0
    got = flight.fetch_peer_dump(2)
    assert got is not None and got[0]["rank"] == 2
    assert flight.fetch_peer_dump(7) is None


def _put_fake_dump(port, rank, enqueues):
    lines = [json.dumps({"flight_header": 1, "rank": rank,
                         "reason": "fake", "time_unix": time.time(),
                         "events": len(enqueues)})]
    for i, name in enumerate(enqueues):
        lines.append(json.dumps({"seq": i, "t_mono": float(i),
                                 "t_wall": time.time(), "kind": "enqueue",
                                 "name": name}))
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/flight/{rank}",
        data=("\n".join(lines) + "\n").encode(), method="PUT")
    urllib.request.urlopen(req, timeout=5)


def test_straggler_report_gives_the_jax_text(kv_server, tmp_path):
    texts = []
    for mod in (flight, jflight):
        mod.configure(enabled_override=True, rank=0, sink_addr="127.0.0.1",
                      sink_port=kv_server.port, directory=str(tmp_path),
                      handlers=False)
        for _ in range(2):
            for n in ("g0", "g1", "g2", "g3"):
                mod.record("enqueue", n)
        _put_fake_dump(kv_server.port, 1,
                       ["g0", "g1", "g2", "g3", "g0", "g1", "g2"])
        _put_fake_dump(kv_server.port, 2, ["g0", "g1", "g2", "g3"] * 2)
        texts.append(mod.straggler_report(["g3", "g2", "g2"], world_size=4,
                                          my_rank=0))
    assert texts[0] == texts[1]
    msg = texts[0]
    assert "rank 1 has not submitted g3" in msg and "rank 2" not in msg
    assert "[3]" in msg and "locally pending: g2, g3" in msg
    assert f"flight dump: {tmp_path}" in msg
    # and with no sink
    for mod in (flight, jflight):
        mod.reset()
        mod.configure(enabled_override=True, rank=0,
                      directory=str(tmp_path), handlers=False)
        mod.record("enqueue", "g0")
    mine = flight.straggler_report(["g0"], world_size=2, my_rank=0)
    assert mine == jflight.straggler_report(["g0"], world_size=2, my_rank=0)
    assert "no flight sink configured" in mine


def test_dump_does_not_block_on_a_held_lock(tmp_path):
    flight.configure(enabled_override=True, rank=0,
                     directory=str(tmp_path), handlers=False)
    flight.record("enqueue", "g0")
    assert flight._dump_lock.acquire(blocking=False)
    try:
        assert flight.dump("reentrant") is None
    finally:
        flight._dump_lock.release()
    assert flight.dump("after") is not None


def test_anomaly_dump_is_rate_limited_per_rule(tmp_path):
    flight.configure(enabled_override=True, rank=0,
                     directory=str(tmp_path), handlers=False)
    assert flight.anomaly_dump("slow") is not None
    assert flight.anomaly_dump("slow") is None
    assert flight.anomaly_dump("other") is not None
    assert flight.anomaly_dump("slow", min_interval_s=0.0) is not None
    header, _ = flight.parse_dump(
        open(tmp_path / "flight_rank0.jsonl").read())
    assert header["reason"] == "anomaly:slow" and flight.dump_count() == 3


def _wait_dumps(n):
    deadline = time.monotonic() + 5.0
    while flight.dump_count() < n and time.monotonic() < deadline:
        time.sleep(0.01)
    return flight.dump_count()


def test_sigusr2_dumps_and_chains_the_handler_found(tmp_path):
    fired = []
    signal.signal(signal.SIGUSR2, lambda s, f: fired.append(s))
    flight.configure(enabled_override=True, rank=0,
                     directory=str(tmp_path), handlers=True)
    flight.record("enqueue", "g0")
    os.kill(os.getpid(), signal.SIGUSR2)
    assert _wait_dumps(1) == 1
    deadline = time.monotonic() + 5.0
    while not fired and time.monotonic() < deadline:
        time.sleep(0.01)
    assert fired == [signal.SIGUSR2]
    header, events = flight.parse_dump(
        open(tmp_path / "flight_rank0.jsonl").read())
    assert header["reason"] == "sigusr2"
    assert events[-1]["kind"] == "signal_dump"
    assert events[-1]["signum"] == signal.SIGUSR2
    flight.uninstall_handlers()
    assert signal.getsignal(signal.SIGUSR2) is not flight._sigusr2


def test_excepthook_dumps_a_crash_and_chains(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a[0]))
    flight.configure(enabled_override=True, rank=1,
                     directory=str(tmp_path), handlers=True)
    assert sys.excepthook is flight._excepthook
    try:
        raise ValueError("boom " * 100)
    except ValueError:
        sys.excepthook(*sys.exc_info())
    assert seen == [ValueError]
    header, events = flight.parse_dump(
        open(tmp_path / "flight_rank1.jsonl").read())
    assert header["reason"] == "crash"
    assert events[-1]["kind"] == "crash" and events[-1]["name"] == \
        "ValueError" and len(events[-1]["error"]) == 200


def test_preemption_records_and_dumps(tmp_path):
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.elastic import preemption

    flight.configure(enabled_override=True, rank=0,
                     directory=str(tmp_path), handlers=False)
    codes = []
    preemption.install(state=elastic.ObjectState(step=3),
                       exit_fn=codes.append)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        preemption.uninstall()
    assert codes == [preemption.PREEMPTED_EXIT_CODE]
    header, events = flight.parse_dump(
        open(tmp_path / "flight_rank0.jsonl").read())
    assert header["reason"] == "preemption"
    assert events[-1]["kind"] == "preempt"
    assert events[-1]["signum"] == signal.SIGTERM


def test_knobs_through_init(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_FLIGHT_RECORDER", "0")
    hvd.init(device="cpu")
    try:
        assert not flight.enabled()
        flight.record("enqueue", "x")
        assert flight.event_count() == 0
    finally:
        hvd.shutdown()
    monkeypatch.delenv("HOROVOD_FLIGHT_RECORDER")
    monkeypatch.setenv("HOROVOD_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_FLIGHT_CAPACITY", "77")
    hvd.init(device="cpu")
    try:
        assert flight.enabled()  # on by default
        assert flight.dump_dir() == str(tmp_path)
        assert flight._events.maxlen == 77
        assert flight.rank() == 0
        assert signal.getsignal(signal.SIGUSR2) is flight._sigusr2
    finally:
        hvd.shutdown()
    assert not flight.enabled()  # configure()'s enable ends with it


def test_metrics_push_feeds_the_aggregated_scrape(kv_server):
    metrics.reset()
    metrics.enable()
    try:
        metrics.registry.counter("t_push_total", "x").inc(5)
        assert metrics.push_once("127.0.0.1", kv_server.port, 1)
        metrics.registry.counter("t_push_total", "x").inc(2)
        metrics.start_metrics_push("127.0.0.1", kv_server.port, 0,
                                   interval_s=30.0)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{kv_server.port}/metrics",
                    timeout=5) as r:
                scrape = r.read().decode()
            if 'rank="0"' in scrape:
                break
            time.sleep(0.05)
        assert 't_push_total{rank="1"} 5' in scrape
        assert 't_push_total{rank="0"} 7' in scrape
        assert scrape.count("# TYPE t_push_total counter") == 1
        assert metrics.lint_exposition(scrape) == []
        # a dead store costs a False, not a raise
        assert not metrics.push_once("127.0.0.1", 1, 0)
    finally:
        metrics.reset()


def test_new_round_clears_the_flight_and_push_scopes():
    from horovod_tpu_torch.runner.http import http_client
    from horovod_tpu_torch.runner.http.http_server import (
        FLIGHT_META_SCOPE, RendezvousServer)
    from horovod_tpu_torch.runner.util.hosts import SlotInfo

    srv = RendezvousServer()
    try:
        port = srv.init([SlotInfo("localhost", 0, 0, 0, 1, 1, 1)])
        http_client.put("127.0.0.1", port, "flight", "0", b"dump")
        http_client.put("127.0.0.1", port, "metrics_push", "0", b"x 1\n")
        http_client.put("127.0.0.1", port, "user", "k", b"v")
        assert "0" in srv.store[FLIGHT_META_SCOPE]
        srv.init([SlotInfo("localhost", 0, 0, 0, 1, 1, 1)])
        for scope in ("flight", FLIGHT_META_SCOPE, "metrics_push"):
            assert scope not in srv.store
        assert http_client.get("127.0.0.1", port, "user", "k") == b"v"
    finally:
        srv.shutdown_server()


def test_driver_persists_dumps_with_their_receipts(tmp_path, monkeypatch,
                                                   capsys):
    from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
    from horovod_tpu_torch.runner.http.http_server import RendezvousServer
    from horovod_tpu_torch.tools import flight_analyze

    srv = RendezvousServer()
    srv.start_server()
    try:
        flight.configure(enabled_override=True, rank=0,
                         sink_addr="127.0.0.1", sink_port=srv.port,
                         directory=str(tmp_path / "worker"),
                         handlers=False)
        flight.record("preempt", signum=15)
        flight.dump("preemption")
        out = tmp_path / "driver"
        monkeypatch.setenv("HOROVOD_FLIGHT_DIR", str(out))
        ElasticDriver._persist_flight_dumps(
            types.SimpleNamespace(_rendezvous=srv))
    finally:
        srv.shutdown_server()
    text = (out / "flight_rank0.jsonl").read_text()
    header, events = jflight.parse_dump(text)
    assert header["reason"] == "preemption"
    assert header["receipt"]["bytes"] > 0
    assert header["receipt"]["recv_time_unix"] >= header["time_unix"]
    assert events[-1]["kind"] == "preempt"
    assert flight_analyze.main([str(out / "flight_rank0.jsonl")]) == 0
    assert "dump: preemption" in capsys.readouterr().out
