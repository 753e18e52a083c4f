"""The port's launcher (horovod_tpu_torch.runner) against the JAX
package's: the cases of tests/test_runner.py with the same names and
assertions (command/env construction with injected exec, no real ssh),
then parity cases that feed the same inputs to both launchers, and the
refusal of every flag whose feature the port does not have yet."""

import argparse
import dataclasses
import json
import os
import sys
import threading
import time

import pytest

from horovod_tpu.runner import exec_run as jax_exec_run
from horovod_tpu.runner import launch as jax_launch
from horovod_tpu.runner.util import config_parser as jax_config_parser
from horovod_tpu.runner.util import hosts as jax_hosts
from horovod_tpu_torch.runner.util.hosts import (
    SlotInfo,
    get_host_assignments,
    parse_hosts,
)
from horovod_tpu_torch.runner.util import config_parser, safe_shell_exec
from horovod_tpu_torch.runner.util.network import (
    BasicClient,
    BasicService,
    Wire,
    find_free_port,
)
from horovod_tpu_torch.runner.util.secret import make_secret_key
from horovod_tpu_torch.runner.http import http_client
from horovod_tpu_torch.runner.http.http_server import (
    RENDEZVOUS_SCOPE,
    KVStoreServer,
    RendezvousServer,
)
from horovod_tpu_torch.runner import exec_run, launch
from horovod_tpu_torch.runner.exec_run import run_static, slot_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- hosts


def test_parse_hosts():
    hosts = parse_hosts("h1:4, h2:2,h3")
    assert [(h.hostname, h.slots) for h in hosts] == [
        ("h1", 4), ("h2", 2), ("h3", 1),
    ]


def test_parse_host_files(tmp_path):
    f = tmp_path / "hostfile"
    f.write_text("# comment\nh1 slots=4\nh2:2\nh3\n")
    from horovod_tpu_torch.runner.util.hosts import parse_host_files

    assert parse_host_files(str(f)) == "h1:4,h2:2,h3:1"


def test_host_assignments_basic():
    slots = get_host_assignments(parse_hosts("h1:2,h2:2"), 4)
    assert [s.rank for s in slots] == [0, 1, 2, 3]
    assert [s.hostname for s in slots] == ["h1", "h1", "h2", "h2"]
    assert [s.local_rank for s in slots] == [0, 1, 0, 1]
    assert [s.cross_rank for s in slots] == [0, 0, 1, 1]
    assert all(s.size == 4 and s.local_size == 2 for s in slots)


def test_host_assignments_max_np_truncates():
    slots = get_host_assignments(parse_hosts("h1:4,h2:4"), 2, max_np=3)
    assert len(slots) == 3
    assert [s.hostname for s in slots] == ["h1", "h1", "h1"]


def test_host_assignments_min_np_enforced():
    with pytest.raises(ValueError):
        get_host_assignments(parse_hosts("h1:2"), 4)


def test_host_assignments_rank_stability():
    """Surviving hosts keep their global ranks across a resize
    (reference elastic/driver.py:240)."""
    prior = {"h2": [2, 3], "h3": [4, 5]}
    slots = get_host_assignments(
        parse_hosts("h2:2,h3:2,h4:2"), 2, rank_assignments=prior
    )
    by_host = {}
    for s in slots:
        by_host.setdefault(s.hostname, []).append(s.rank)
    assert by_host["h2"] == [2, 3]
    assert by_host["h3"] == [4, 5]
    assert sorted(by_host["h4"]) == [0, 1]  # freed ranks reused


def test_slot_info_roundtrip():
    s = SlotInfo("h1", 3, 1, 1, 8, 4, 2)
    assert SlotInfo.from_response_string(s.to_response_string()) == s


# ---------------------------------------------------------------- network


def test_basic_service_ping_and_custom():
    key = make_secret_key()

    class EchoService(BasicService):
        def _handle(self, req, addr):
            if isinstance(req, dict):
                return {"echo": req}
            return super()._handle(req, addr)

    svc = EchoService("echo", key)
    try:
        client = BasicClient("echo", svc.addresses(), key)
        assert client.request({"x": 1}) == {"echo": {"x": 1}}
    finally:
        svc.shutdown()


def test_service_rejects_bad_hmac():
    key = make_secret_key()
    svc = BasicService("s", key)
    try:
        with pytest.raises(ConnectionError):
            BasicClient("s", svc.addresses(), b"wrong-key", attempts=1)
    finally:
        svc.shutdown()


def test_wire_detects_tamper():
    import io

    w_good, w_bad = Wire(b"k1"), Wire(b"k2")
    buf = io.BytesIO()
    w_good.write([1, 2], buf)
    buf.seek(0)
    with pytest.raises(PermissionError):
        w_bad.read(buf)


# ---------------------------------------------------------------- http kv


def test_kv_store_put_get_delete():
    server = KVStoreServer()
    port = server.start_server()
    try:
        assert http_client.get("127.0.0.1", port, "sc", "k") is None
        http_client.put("127.0.0.1", port, "sc", "k", b"v1")
        assert http_client.get("127.0.0.1", port, "sc", "k") == b"v1"
        http_client.delete("127.0.0.1", port, "sc", "k")
        assert http_client.get("127.0.0.1", port, "sc", "k") is None
    finally:
        server.shutdown_server()


def test_rendezvous_publishes_slots():
    server = RendezvousServer()
    slots = get_host_assignments(parse_hosts("h1:2"), 2)
    port = server.init(slots)
    try:
        raw = http_client.get(
            "127.0.0.1", port, RENDEZVOUS_SCOPE, "rank_1"
        )
        got = SlotInfo.from_response_string(raw.decode())
        assert got.rank == 1 and got.hostname == "h1"
        assert http_client.get(
            "127.0.0.1", port, RENDEZVOUS_SCOPE, "size"
        ) == b"2"
        # new round replaces assignments
        server.init(get_host_assignments(parse_hosts("h1:1"), 1))
        assert http_client.get(
            "127.0.0.1", port, RENDEZVOUS_SCOPE, "rank_1"
        ) is None
    finally:
        server.shutdown_server()


# ---------------------------------------------------------------- exec


def test_safe_shell_exec_runs_and_captures(capfd):
    ret = safe_shell_exec.execute(
        ["python", "-c", "print('hello-from-child')"], prefix="3"
    )
    assert ret == 0
    out = capfd.readouterr().out
    assert "[3]hello-from-child" in out


def test_safe_shell_exec_kill_on_event():
    ev = threading.Event()
    result = {}

    def run():
        result["code"] = safe_shell_exec.execute(
            ["python", "-c", "import time; time.sleep(60)"], events=[ev]
        )

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.5)
    ev.set()
    t.join(timeout=15)
    assert not t.is_alive()
    assert result["code"] != 0


# ---------------------------------------------------------------- config


def _args(**kw):
    defaults = dict(
        fusion_threshold_mb=None, cycle_time_ms=None, cache_capacity=None,
        timeline_filename=None, timeline_mark_cycles=None, autotune=None,
        autotune_log=None, compression_wire_dtype=None,
        hierarchical_allreduce=None, hierarchical_allgather=None,
        elastic_timeout=None, reset_limit=None, stall_check_disable=None,
        stall_warning_time_seconds=None, stall_shutdown_time_seconds=None,
        log_level=None, mesh=None,
    )
    defaults.update(kw)
    return argparse.Namespace(**defaults)


def test_env_from_args():
    env = config_parser.env_from_args(
        _args(fusion_threshold_mb=64, autotune=True, mesh="dp=4,tp=2"),
        {"BASE": "1"},
    )
    assert env["BASE"] == "1"
    assert env["HOROVOD_FUSION_THRESHOLD"] == str(64 * 1024 * 1024)
    assert env["HOROVOD_AUTOTUNE"] == "1"
    assert env["HOROVOD_MESH"] == "dp=4,tp=2"
    assert "HOROVOD_CYCLE_TIME" not in env


def test_config_file(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("cycle-time-ms: 2.5\nautotune: true\nlog-level: INFO\n")
    args = launch.parse_args(
        ["--config-file", str(cfg), "--log-level", "DEBUG",
         "-np", "2", "python", "t.py"]
    )
    assert args.cycle_time_ms == 2.5
    assert args.autotune is True
    assert args.log_level == "DEBUG"  # CLI beats config file


# ---------------------------------------------------------------- launch


def test_parse_args_static():
    args = launch.parse_args(
        ["-np", "4", "-H", "h1:2,h2:2", "python", "train.py", "--lr", "0.1"]
    )
    assert args.np == 4
    assert args.hosts == "h1:2,h2:2"
    assert args.command == ["python", "train.py", "--lr", "0.1"]
    assert not launch.is_elastic(args)


def test_parse_args_elastic():
    args = launch.parse_args(
        ["-np", "8", "--min-np", "4", "--max-np", "12",
         "--host-discovery-script", "./d.sh", "python", "train.py"]
    )
    assert launch.is_elastic(args)
    assert args.min_np == 4 and args.max_np == 12


def test_run_static_env_protocol():
    """Injected exec captures the per-slot env (reference gloo_run env
    protocol, gloo_run.py:66-101), and the keys the port changes: the
    data plane's name, the rendezvous store the static launch starts
    (as the JAX launcher does: its address on loopback for a local
    world), rank 0's TCP store address on a local port, and the eager
    runtime's coordinator on rank 0's host at another port, as the JAX
    launcher publishes it."""
    captured = {}

    def fake_exec(command, env, slot, events):
        captured[slot.rank] = (command, env)
        return 0

    codes = run_static(
        ["python", "train.py"],
        parse_hosts("localhost:2"),
        2,
        env={},
        exec_fn=fake_exec,
    )
    assert codes == [0, 0]
    assert set(captured) == {0, 1}
    cmd, env0 = captured[0]
    assert cmd == ["python", "train.py"]
    assert env0["HOROVOD_RANK"] == "0"
    assert env0["HOROVOD_SIZE"] == "2"
    assert env0["HOROVOD_LOCAL_RANK"] == "0"
    assert env0["HVD_TPU_PROCESS_ID"] == "0"
    assert env0["HVD_TPU_NUM_PROCESSES"] == "2"
    assert "HVD_TPU_SECRET_KEY" in env0
    _, env1 = captured[1]
    assert env1["HOROVOD_RANK"] == "1"
    assert env1["HOROVOD_LOCAL_RANK"] == "1"
    for env in (env0, env1):
        assert env["HOROVOD_CONTROLLER"] == "torch.distributed"
        assert env["HOROVOD_CPU_OPERATIONS"] == "torch.distributed"
        assert env["HVD_TPU_RENDEZVOUS_ADDR"] == "127.0.0.1"
        assert env["HOROVOD_GLOO_RENDEZVOUS_ADDR"] == "127.0.0.1"
        assert env["HVD_TPU_RENDEZVOUS_PORT"] == \
            env["HOROVOD_GLOO_RENDEZVOUS_PORT"] == \
            env0["HVD_TPU_RENDEZVOUS_PORT"]
        assert 0 < int(env["HVD_TPU_RENDEZVOUS_PORT"]) < 65536
        assert "NCCL_SOCKET_IFNAME" not in env  # no NICs given
    host, _, port = env0["HVD_TPU_COORDINATOR_ADDRESS"].rpartition(":")
    assert host == "127.0.0.1" and 0 < int(port) < 65536
    assert env1["HVD_TPU_COORDINATOR_ADDRESS"] == \
        env0["HVD_TPU_COORDINATOR_ADDRESS"]
    native = int(env0["HVD_TPU_NATIVE_COORDINATOR_PORT"])
    assert 0 < native < 65536 and native != int(port)
    for env in (env0, env1):
        assert env["HVD_TPU_NATIVE_COORDINATOR_ADDR"] == "127.0.0.1"
        assert env["HVD_TPU_NATIVE_COORDINATOR_PORT"] == str(native)


def test_run_static_failure_kills_all():
    events_seen = []

    def fake_exec(command, env, slot, events):
        if slot.rank == 0:
            return 1  # fail immediately
        # wait for the kill event like a real worker would
        events_seen.append(events)
        deadline = time.time() + 10
        while time.time() < deadline:
            if any(e.is_set() for e in events):
                return 143
            time.sleep(0.05)
        return 0

    codes = run_static(
        ["x"], parse_hosts("localhost:2"), 2, env={}, exec_fn=fake_exec
    )
    assert codes[0] == 1
    assert codes[1] == 143  # terminated by the failure event


# ------------------------------------------------- NIC routability probe
# (reference driver_service.py:260 get_common_interfaces: tasks ring-
# probe each other's advertised interface addresses, the driver
# intersects the routable sets)


def test_ring_probe_filters_dark_interfaces():
    """Each task advertises a reachable NIC and a dark one (an address
    nothing routes); the ring intersection must keep only the NIC every
    hop could actually reach."""
    from horovod_tpu_torch.runner.driver.probe import (
        TaskProbeService,
        find_common_nics,
    )

    key = make_secret_key()
    tasks = [
        TaskProbeService(
            i, key,
            advertised={
                "eth0": "127.0.0.1",
                # dark NIC: an endpoint nothing listens on
                "ib0": ("127.0.0.1", find_free_port()),
            },
        )
        for i in range(3)
    ]
    try:
        addrs = [t.addresses() for t in tasks]
        nics = find_common_nics(addrs, key)
        assert nics == ["eth0"]
    finally:
        for t in tasks:
            t.shutdown()


def test_ring_probe_raises_without_common_interface():
    from horovod_tpu_torch.runner.driver.probe import (
        TaskProbeService,
        find_common_nics,
    )

    key = make_secret_key()
    tasks = [
        TaskProbeService(
            i, key, advertised={"ib0": ("127.0.0.1", find_free_port())}
        )
        for i in range(2)
    ]
    try:
        addrs = [t.addresses() for t in tasks]
        with pytest.raises(RuntimeError, match="no common routable"):
            find_common_nics(addrs, key)
    finally:
        for t in tasks:
            t.shutdown()


def test_probe_task_registration_flow():
    """Full driver flow with REAL probe-task subprocesses: driver
    launches them, they register, ring probe intersects, shutdown
    request ends them (reference _driver_fn, driver_service.py:163)."""
    import subprocess

    from horovod_tpu_torch.runner.driver.probe import get_common_interfaces
    from horovod_tpu_torch.runner.util.secret import ENV_SECRET

    key = make_secret_key()
    procs = []

    def launch_task(idx, host, driver_addresses):
        import base64

        b64 = base64.b64encode(
            json.dumps([list(a) for a in driver_addresses]).encode()
        ).decode()
        env = dict(os.environ)
        env[ENV_SECRET] = key.decode()
        env["PYTHONPATH"] = REPO
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "horovod_tpu_torch.runner.driver.probe_task", str(idx), b64,
             "--linger-s", "30"],
            env=env,
        ))

    # a fake remote hostname forces the probe path; the injected
    # launcher runs the tasks locally
    try:
        nics = get_common_interfaces(
            ["fake-remote-a", "fake-remote-b"], key,
            launch_task_fn=launch_task, timeout_s=30.0,
        )
        assert nics  # at least one common interface on one machine
        for p in procs:
            assert p.wait(timeout=15) == 0  # shutdown request ended them
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=15)


def test_run_static_binds_probed_nic(monkeypatch):
    """launch_slots with explicit nics exports HOROVOD_NICS and binds
    rank 0's TCP store to the named NIC's ip; the port also hands the
    NIC to NCCL and gloo."""
    import horovod_tpu_torch.runner.driver.probe as probe_mod
    from horovod_tpu_torch.runner.exec_run import launch_slots

    monkeypatch.setattr(
        probe_mod, "interface_addresses",
        lambda nics=None: {"ethX": "127.0.0.1"},
    )
    seen = {}

    def fake_exec(command, env, slot, events):
        seen[slot.rank] = (env.get("HOROVOD_NICS"),
                           env["HVD_TPU_COORDINATOR_ADDRESS"]
                           .rpartition(":")[0],
                           env.get("NCCL_SOCKET_IFNAME"),
                           env.get("GLOO_SOCKET_IFNAME"))
        return 0

    assignments = get_host_assignments(parse_hosts("localhost:2"), 2, 2)
    codes = launch_slots(["x"], assignments, {}, exec_fn=fake_exec,
                         nics=["ethX"])
    assert codes == [0, 0]
    assert seen[0] == ("ethX", "127.0.0.1", "ethX", "ethX")
    assert seen[1] == ("ethX", "127.0.0.1", "ethX", "ethX")


def test_check_build_reports_capabilities(capsys):
    """The port's own table: PyTorch; NCCL, gloo and CUDA as this
    torch build has them; the nvcc ops/_build.py compiles with. No JAX
    line."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.runner.launch import run_commandline

    assert run_commandline(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert "[X] PyTorch" in out
    assert "JAX" not in out and "XLA" not in out
    mark = {True: "X", False: " "}
    assert f"[{mark[hvd.nccl_built()]}] NCCL" in out
    assert f"[{mark[hvd.gloo_built()]}] Gloo" in out
    assert f"[{mark[torch.version.cuda is not None]}] CUDA" in out
    try:
        _build._nvcc()
        has_nvcc = True
    except RuntimeError:
        has_nvcc = False
    assert f"[{mark[has_nvcc]}] nvcc" in out


# ------------------------------------------------------- the port's own


def test_rendezvous_round_drops_the_previous_rounds_pushes():
    """A new round replaces the rendezvous scope whole: what was pushed
    there and the last round's slots beyond the new world go; other
    scopes stay."""
    server = RendezvousServer()
    port = server.init(get_host_assignments(parse_hosts("h1:3"), 3))
    try:
        for scope in (RENDEZVOUS_SCOPE, "user"):
            http_client.put("127.0.0.1", port, scope, "pushed", b"x")
        assert server.round == 1
        server.init(get_host_assignments(parse_hosts("h1:2"), 2))
        assert server.round == 2
        assert http_client.get("127.0.0.1", port, RENDEZVOUS_SCOPE,
                               "round") == b"1"
        for key in ("pushed", "rank_2"):
            assert http_client.get("127.0.0.1", port, RENDEZVOUS_SCOPE,
                                   key) is None
        assert http_client.get("127.0.0.1", port, RENDEZVOUS_SCOPE,
                               "size") == b"2"
        assert http_client.get("127.0.0.1", port, "user",
                               "pushed") == b"x"
    finally:
        server.shutdown_server()


def test_slot_env_keeps_data_plane_env_for_remote_workers():
    """A remote worker's command line carries NCCL_*, GLOO_*, CUDA_* and
    TORCH_* besides the control plane's env; other variables stay."""
    cmd = exec_run._remote_command(
        ["python", "t.py"],
        {"HOROVOD_RANK": "1", "NCCL_SOCKET_IFNAME": "ib0",
         "GLOO_SOCKET_IFNAME": "ib0", "CUDA_VISIBLE_DEVICES": "0,1",
         "TORCH_NCCL_ASYNC_ERROR_HANDLING": "1", "PATH": "/bin",
         "HOME": "/home/u", "SECRET_TOKEN": "s"})
    for k in ("HOROVOD_RANK=1", "NCCL_SOCKET_IFNAME=ib0",
              "GLOO_SOCKET_IFNAME=ib0", "CUDA_VISIBLE_DEVICES=0,1",
              "TORCH_NCCL_ASYNC_ERROR_HANDLING=1", "PATH=/bin"):
        assert k in cmd
    assert "HOME=" not in cmd and "SECRET_TOKEN" not in cmd
    assert cmd.endswith("python t.py")


def test_user_socket_ifname_wins_and_default_iface_is_not_exported(
        monkeypatch):
    import horovod_tpu_torch.runner.driver.probe as probe_mod
    from horovod_tpu_torch.runner.exec_run import launch_slots

    monkeypatch.setattr(probe_mod, "interface_addresses",
                        lambda nics=None: {})
    seen = {}

    def fake_exec(command, env, slot, events):
        seen[slot.rank] = (env.get("NCCL_SOCKET_IFNAME"),
                           env.get("GLOO_SOCKET_IFNAME"))
        return 0

    one = get_host_assignments(parse_hosts("localhost:1"), 1, 1)
    launch_slots(["x"], one, {"NCCL_SOCKET_IFNAME": "ib0"},
                 exec_fn=fake_exec, nics=["eth1"])
    assert seen[0] == ("ib0", "eth1")
    launch_slots(["x"], one, {}, exec_fn=fake_exec,
                 nics=[probe_mod.DEFAULT_IFACE], nics_explicit=False)
    assert seen[0] == (None, None)


def test_interface_addresses_without_psutil_names_real_interfaces(
        monkeypatch):
    """The card's machine has no psutil: the fallback still names the
    kernel's interfaces (what NCCL_SOCKET_IFNAME needs), as psutil
    does where it is installed."""
    import socket

    from horovod_tpu_torch.runner.driver import probe

    monkeypatch.setitem(sys.modules, "psutil", None)
    got = probe.interface_addresses()
    names = {n for _, n in socket.if_nameindex()}
    assert got and set(got) <= names
    assert probe.interface_addresses(["lo"]) == {"lo": "127.0.0.1"}


def test_failing_rank_sets_exit_code_over_stopped_ranks(monkeypatch):
    """The launcher's exit code is the failing rank's own, not the
    signal of a rank it stopped after it."""
    codes = {0: -15, 1: 3}

    def fake_exec(command, env, slot, events):
        return codes[slot.rank]

    orig = exec_run.run_static
    monkeypatch.setattr(exec_run, "run_static",
                        lambda *a, **k: orig(*a, exec_fn=fake_exec, **k))
    args = launch.parse_args(["-np", "2", "-H", "localhost:2", "x"])
    assert launch._run_static(args) == 3


def test_config_file_json_without_yaml(tmp_path, monkeypatch):
    """The card's machine has no yaml: a JSON config file (which YAML
    reads the same way) and a flat key: value file still load."""
    js = tmp_path / "cfg.json"
    js.write_text(json.dumps({"cycle-time-ms": 2.5, "log-level": "INFO",
                              "compression": {"compression": "int8"}}))
    flat = tmp_path / "cfg.yaml"
    flat.write_text("cycle-time-ms: 2.5\nlog-level: INFO\n")
    with_yaml = [config_parser.load_config_file(str(p)) for p in (js, flat)]
    monkeypatch.setitem(sys.modules, "yaml", None)
    without = [config_parser.load_config_file(str(p)) for p in (js, flat)]
    assert without == with_yaml
    assert without[0] == {"cycle_time_ms": 2.5, "log_level": "INFO",
                          "compression": "int8"}


# ------------------------------------------- parity with the JAX launcher

_HOST_STRINGS = ["h1:4, h2:2,h3", "localhost:2", "a,b,c", "x:1,y:3,z:2"]


@pytest.mark.parametrize("spec", _HOST_STRINGS)
def test_parse_hosts_matches_jax(spec):
    mine = [(h.hostname, h.slots) for h in parse_hosts(spec)]
    theirs = [(h.hostname, h.slots) for h in jax_hosts.parse_hosts(spec)]
    assert mine == theirs


@pytest.mark.parametrize("text", [
    "# comment\nh1 slots=4\nh2:2\nh3\n",
    "a slots=2 # two\n\nb:3\nc slots=1\n",
])
def test_parse_host_files_matches_jax(tmp_path, text):
    from horovod_tpu_torch.runner.util.hosts import parse_host_files

    f = tmp_path / "hostfile"
    f.write_text(text)
    assert parse_host_files(str(f)) == jax_hosts.parse_host_files(str(f))


def _assignments(mod, hosts, min_np, max_np):
    try:
        return [s.to_response_string() for s in mod.get_host_assignments(
            mod.parse_hosts(hosts), min_np, max_np)]
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("hosts", ["h1:2,h2:2", "h1:4,h2:1,h3:3", "h1:1",
                                   "a:3,b:3,c:3,d:1"])
def test_host_assignments_match_jax(hosts):
    from horovod_tpu_torch.runner.util import hosts as port_hosts

    for min_np in (1, 2, 4, 7, 11):
        for max_np in (None, 1, 3, 8):
            assert _assignments(port_hosts, hosts, min_np, max_np) == \
                _assignments(jax_hosts, hosts, min_np, max_np), \
                (hosts, min_np, max_np)


def _flag_argv(action):
    """One command line that sets the flag of ``action``."""
    opt = action.option_strings[-1]
    if action.nargs == 0:
        return [opt]
    if action.choices:
        return [opt, str(list(action.choices)[-1])]
    if action.nargs == 2:
        return [opt, "1.5", "4.5"]
    value = {int: "3", float: "2.5"}.get(action.type, "val")
    return [opt, value]


_FLAGS = [a for a in launch._parser()._actions
          if a.option_strings and a.dest not in ("help", "config_file")]


@pytest.mark.parametrize("action", _FLAGS,
                         ids=[a.option_strings[-1] for a in _FLAGS])
def test_parse_args_and_env_match_jax(action):
    """Every flag parses to the same namespace as in the JAX launcher;
    every flag the port accepts exports the same worker env."""
    argv = _flag_argv(action) + ["python", "train.py", "--lr", "0.1"]
    mine, theirs = launch.parse_args(argv), jax_launch.parse_args(argv)
    assert vars(mine) == vars(theirs)
    if action.dest not in launch.UNPORTED:
        assert config_parser.env_from_args(mine, {"B": "1"}) == \
            jax_config_parser.env_from_args(theirs, {"B": "1"})


def test_parsers_have_the_same_flags():
    mine = {(tuple(a.option_strings), a.dest, a.default, a.nargs,
             a.type, tuple(a.choices or ()), a.const)
            for a in launch._parser()._actions}
    class Built(Exception):
        pass

    def capture(self, *a, **k):
        raise Built(self)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(Built) as built:
            jax_launch.parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = real
    theirs = {(tuple(a.option_strings), a.dest, a.default, a.nargs,
               a.type, tuple(a.choices or ()), a.const)
              for a in built.value.args[0]._actions}
    assert mine == theirs


def test_config_file_matches_jax(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("cycle-time-ms: 2.5\nlog-level: INFO\n"
                   "retry:\n  retry-max-attempts: 7\n"
                   "compression: int8\n")
    argv = ["--config-file", str(cfg), "--log-level", "DEBUG", "-np", "2",
            "python", "t.py"]
    mine, theirs = launch.parse_args(argv), jax_launch.parse_args(argv)
    assert vars(mine) == vars(theirs)
    assert config_parser.env_from_args(mine) == \
        jax_config_parser.env_from_args(theirs)


def test_slot_env_matches_jax_but_for_the_listed_keys():
    slot = SlotInfo("h1", 3, 1, 1, 8, 4, 2)
    base = {"PATH": "/bin", "HOROVOD_NICS": "eth0", "X": "y"}
    mine = slot_env(slot, base, "h0:4261", native_coordinator_port=4265)
    theirs = jax_exec_run.slot_env(
        jax_hosts.SlotInfo("h1", 3, 1, 1, 8, 4, 2), base, "10.0.0.1",
        4242, "h0:4261", native_coordinator_port=4265)
    differ = {k for k in set(mine) | set(theirs)
              if mine.get(k) != theirs.get(k)}
    assert differ == {"HOROVOD_CONTROLLER", "HOROVOD_CPU_OPERATIONS",
                      "HOROVOD_GLOO_RENDEZVOUS_ADDR",
                      "HOROVOD_GLOO_RENDEZVOUS_PORT",
                      "HVD_TPU_RENDEZVOUS_ADDR", "HVD_TPU_RENDEZVOUS_PORT"}
    assert mine["HOROVOD_CONTROLLER"] == "torch.distributed"
    assert mine["HOROVOD_CPU_OPERATIONS"] == "torch.distributed"
    assert theirs["HOROVOD_CONTROLLER"] == "xla"
    assert mine["HVD_TPU_NATIVE_COORDINATOR_ADDR"] == "h0"
    assert mine["HVD_TPU_NATIVE_COORDINATOR_PORT"] == "4265"
    assert "HVD_TPU_RENDEZVOUS_PORT" not in mine
    assert theirs["HVD_TPU_RENDEZVOUS_PORT"] == "4242"
    assert base == {"PATH": "/bin", "HOROVOD_NICS": "eth0", "X": "y"}


# ------------------------------------- FSDP and the overlap schedule

_ENTRY5 = [a for a in _FLAGS if a.dest in (
    "overlap_schedule", "fsdp", "fsdp_prefetch", "fsdp_regather",
    "fsdp_offload", "fsdp_offload_duty")]


@pytest.mark.parametrize("action", _ENTRY5,
                         ids=[a.option_strings[-1] for a in _ENTRY5])
def test_fsdp_and_overlap_flags_reach_the_workers_knobs(action,
                                                        monkeypatch):
    """FSDP's and the overlap schedule's flags are accepted, exported
    into the slot env as the JAX launcher exports them, and read by the
    worker's knobs as the JAX package reads them."""
    from horovod_tpu.core.knobs import Knobs as JKnobs
    from horovod_tpu_torch.core.knobs import Knobs

    argv = _flag_argv(action) + ["python", "train.py"]
    mine, theirs = launch.parse_args(argv), jax_launch.parse_args(argv)
    assert launch.unported_flags(mine, argv) == []
    env = config_parser.env_from_args(mine, {})
    assert env == jax_config_parser.env_from_args(theirs, {})
    assert len(env) == 1
    slot = SlotInfo("localhost", 0, 0, 0, 1, 1, 1)
    wenv = slot_env(slot, env, "localhost:4261")
    var, value = next(iter(env.items()))
    assert wenv[var] == value
    for k in list(os.environ):
        if k.startswith(("HOROVOD_", "HVD_TPU_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv(var, value)
    assert getattr(Knobs.from_env(), action.dest) == \
        getattr(JKnobs.from_env(), action.dest)


# ------------------------------------------------------ elastic flags

#: ROADMAP queue A entry 8's flags, refused until the elastic slice
_ELASTIC = [a for a in _FLAGS if a.dest in (
    "min_np", "max_np", "host_discovery_script", "slots",
    "elastic_timeout", "reset_limit", "cooldown_range", "vanish_grace",
    "spawn_join", "preemption", "emergency_checkpoint", "replication",
    "replication_partners", "rendezvous_state_dir", "retry_max_attempts",
    "retry_base_delay", "retry_max_delay")]


def _captured_elastic_run(launch_mod, driver_mod, argv, monkeypatch):
    """Run ``launch_mod``'s command line with its ElasticDriver replaced
    by a recorder: what the launcher built, without a round."""
    seen = {}

    class Recorder:
        def __init__(self, host_manager, settings, command, env, **kw):
            seen.update(settings=dataclasses.asdict(settings),
                        command=command, env=env,
                        script=host_manager._discovery._script,
                        slots=host_manager._discovery._default_slots,
                        cooldown=host_manager._cooldown_range,
                        nics=kw.get("nics"),
                        state_dir=kw.get("rendezvous_state_dir"))

        def run(self):
            return 0

    monkeypatch.setattr(driver_mod, "ElasticDriver", Recorder)
    assert launch_mod.run_commandline(argv) == 0
    return seen


def test_elastic_flags_are_the_seventeen_of_entry_8():
    assert len(_ELASTIC) == 17
    assert 8 not in launch.ENTRIES
    assert not any(a.dest in launch.UNPORTED for a in _ELASTIC)


@pytest.mark.parametrize("action", _ELASTIC,
                         ids=[a.option_strings[-1] for a in _ELASTIC])
def test_elastic_flag_is_accepted_and_reaches_the_driver(action,
                                                         monkeypatch):
    """Each of entry 8's flags is accepted, and the launcher hands the
    elastic driver the JAX launcher's worker env, ElasticSettings,
    discovery script and slots, cooldown and rendezvous state dir."""
    from horovod_tpu.runner.elastic import driver as jax_driver
    from horovod_tpu_torch.runner.elastic import driver as port_driver

    argv = _flag_argv(action)
    if action.dest != "host_discovery_script":
        argv += ["--host-discovery-script", "./discover.sh"]
    argv += ["python", "train.py"]
    assert launch.unported_flags(launch.parse_args(argv), argv) == []
    for k in list(os.environ):
        if k.startswith(("HOROVOD_", "HVD_TPU_")):
            monkeypatch.delenv(k)
    mine = _captured_elastic_run(launch, port_driver, argv, monkeypatch)
    theirs = _captured_elastic_run(jax_launch, jax_driver, argv,
                                   monkeypatch)
    assert mine == theirs
    assert mine["command"] == ["python", "train.py"]


# ------------------------------------------------------ unported flags

_REFUSED = [a for a in _FLAGS if a.dest in launch.UNPORTED]


@pytest.mark.parametrize("action", _REFUSED,
                         ids=[a.option_strings[-1] for a in _REFUSED])
def test_unported_flag_is_refused_with_its_entry(action, capsys):
    """Given explicitly, a flag whose feature the port lacks stops the
    launcher before anything runs, naming its ROADMAP entry."""
    argv = _flag_argv(action) + ["python", "-c", "raise SystemExit(7)"]
    assert launch.run_commandline(argv) == 2
    err = capsys.readouterr().err
    entry = launch.UNPORTED[action.dest]
    assert f"{action.option_strings[-1]} is not in horovod_tpu_torch" in err
    assert f"ROADMAP queue A entry {entry} " in err


#: ROADMAP queue A entry 9's flags, refused until the eager runtime:
#: their value, each knob it sets, and the runtime argument it reaches
_EAGER = {
    "cycle_time_ms": (("cycle_time_ms",), "cycle_ms", 2.5),
    "cache_capacity": (("cache_capacity",), "cache_capacity", 3),
    "stall_check_disable": (("stall_check_enabled",), "stall_warning_s",
                            0.0),
    "stall_warning_time_seconds": (("stall_warning_time_seconds",),
                                   "stall_warning_s", 2.5),
    "stall_shutdown_time_seconds": (("stall_shutdown_time_seconds",),
                                    "stall_shutdown_s", 2.5),
    "stall_abort_s": (("stall_abort_time_seconds",), "stall_abort_s", 2.5),
}
_EAGER_FLAGS = [a for a in _FLAGS if a.dest in _EAGER]


@pytest.mark.parametrize("action", _EAGER_FLAGS,
                         ids=[a.option_strings[-1] for a in _EAGER_FLAGS])
def test_eager_flag_reaches_the_knobs_and_the_runtime(action, monkeypatch):
    """Each of entry 9's flags is accepted, exported into the slot env as
    the JAX launcher exports it, read by the worker's knobs as the JAX
    package reads them, and handed to the eager runtime's constructor
    by init()'s _start_native_eager, with the published coordinator."""
    import types

    import torch

    from horovod_tpu.core.knobs import Knobs as JKnobs
    from horovod_tpu_torch.core import basics
    from horovod_tpu_torch.core.knobs import Knobs
    from horovod_tpu_torch.ops import eager_runtime

    fields, arg, value = _EAGER[action.dest]
    argv = _flag_argv(action) + ["python", "train.py"]
    mine, theirs = launch.parse_args(argv), jax_launch.parse_args(argv)
    assert launch.unported_flags(mine, argv) == []
    env = config_parser.env_from_args(mine, {})
    assert env == jax_config_parser.env_from_args(theirs, {})
    assert len(env) == 1
    wenv = slot_env(SlotInfo("localhost", 0, 0, 0, 1, 1, 1), env,
                    "localhost:4261", native_coordinator_port=4265)
    for k in list(os.environ):
        if k.startswith(("HOROVOD_", "HVD_TPU_")):
            monkeypatch.delenv(k)
    for k, v in wenv.items():
        if k.startswith(("HOROVOD_", "HVD_TPU_")):
            monkeypatch.setenv(k, v)
    knobs = Knobs.from_env()
    for field in fields:
        assert getattr(knobs, field) == getattr(JKnobs.from_env(), field)
        assert getattr(knobs, field) != getattr(Knobs(), field), field
    seen = {}

    class Recorder:
        def __init__(self, **kw):
            seen.update(kw)

    monkeypatch.setattr(eager_runtime, "EagerRuntime", Recorder)
    monkeypatch.setattr(eager_runtime, "make_dist_executor",
                        lambda: "executor")
    st = types.SimpleNamespace(knobs=knobs, rank=0, size=1,
                               device=torch.device("cpu"),
                               eager_runtime=None)
    basics._start_native_eager(st)
    assert isinstance(st.eager_runtime, Recorder)
    assert seen[arg] == value
    assert seen["coordinator_addr"] == "localhost"
    assert seen["coordinator_port"] == 4265
    assert seen["executor"] == "executor"


def test_unported_flags_at_their_defaults_are_accepted(tmp_path, capfd):
    """Left at their defaults the same flags are accepted and the
    command runs; a config file that sets one is refused like the
    flag."""
    argv = ["-np", "1", "python", "-c", "print('ran')"]
    assert launch.unported_flags(launch.parse_args(argv), argv) == []
    assert launch.run_commandline(argv) == 0
    assert "[0]ran" in capfd.readouterr().out
    # the trainee's own --mesh is not the launcher's
    argv = ["-np", "1", "python", "-c", "pass", "--mesh", "dp=2"]
    assert launch.unported_flags(launch.parse_args(argv), argv) == []
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("autotune: true\nlog-level: INFO\n")
    argv = ["--config-file", str(cfg), "-np", "1", "python", "-c", "pass"]
    assert launch.unported_flags(launch.parse_args(argv), argv) == [
        ("--autotune", 12)]
    assert launch.run_commandline(argv) == 2
