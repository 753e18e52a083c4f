"""Worlds started by the port's launcher on the CPU: a world-2 gloo
GPT-2 train step through ``python -m horovod_tpu_torch.runner.launch``,
bitwise equal to the same command under ``examples.local_world``;
``runner.run(fn, np=2)``; a failing rank, or a SIGTERM to the launcher,
stopping the world; and ``init()`` refusing a local rank that has no
card of its own.

Every subprocess has its own timeout; every world binds a free port
(rank 0's TCP store)."""

import ast
import os
import subprocess
import sys
import time

import pytest
import torch

from horovod_tpu_torch.core import basics
from horovod_tpu_torch.runner import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the GPT-2 example's main at a tiny size, its losses printed exactly
_GPT2 = [
    sys.executable, "-c",
    "import sys\n"
    "from horovod_tpu_torch.examples import gpt2_pretraining as g\n"
    "s = {}\n"
    "g.main(sys.argv[1:], s)\n"
    "print('losses', repr(s['losses']), flush=True)\n",
    "--device", "cpu", "--layers", "2", "--hidden", "64", "--seq-len", "16",
    "--batch-size", "2", "--num-warmup-batches", "1",
    "--num-batches-per-iter", "2", "--num-iters", "1", "--flash",
    "--fused-norm",
]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in list(env):
        if k.startswith(("HOROVOD_", "HVD_TPU_")):
            del env[k]
    return env


def _run(argv, timeout=120):
    return subprocess.run(argv, cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=timeout)


def _losses(stdout):
    return {line[1:line.index("]")]: line.split("losses ", 1)[1]
            for line in stdout.splitlines() if "]losses [" in line}


def test_launch_trains_gpt2_world_of_two_like_local_world():
    launched = _run([sys.executable, "-m", "horovod_tpu_torch.runner.launch",
                     "-np", "2", "-H", "localhost:2"] + _GPT2)
    assert launched.returncode == 0, launched.stderr[-3000:]
    lines = launched.stdout.splitlines()
    assert any(line.startswith("[0]GPT-2 2L/64H") and "2 ranks" in line
               for line in lines), launched.stdout
    assert any(line.startswith("[0]tokens/sec on 2 rank(s)")
               for line in lines)
    mine = _losses(launched.stdout)
    assert set(mine) == {"0", "1"}
    local = _run([sys.executable, "-m",
                  "horovod_tpu_torch.examples.local_world", "-np", "2",
                  "--"] + _GPT2)
    assert local.returncode == 0, local.stdout[-3000:]
    theirs = _losses(local.stdout)
    assert mine == theirs  # float reprs: bitwise equal losses
    losses = ast.literal_eval(mine["0"])
    assert len(losses) == 3 and all(torch.isfinite(torch.tensor(losses)))


@pytest.mark.parametrize("use_cloudpickle", [True, False])
def test_run_returns_every_ranks_result(use_cloudpickle):
    """``run(fn, np=2)`` runs fn in a spawned interpreter per slot and
    returns the results in rank order; with ``use_cloudpickle=False`` (as
    on a machine without cloudpickle) fn pickles by reference."""
    got = run(os.getenv, args=("HOROVOD_RANK",), np=2, env=_env(),
              use_cloudpickle=use_cloudpickle)
    assert got == ["0", "1"]
    got = run(os.getenv, args=("HVD_TPU_COORDINATOR_ADDRESS",), np=2,
              env=_env(), use_cloudpickle=use_cloudpickle)
    assert got[0] == got[1] and got[0].startswith("127.0.0.1:")


def test_run_raises_on_a_failing_rank():
    with pytest.raises(RuntimeError, match="worker failure"):
        run(os.getenv, args=(), np=2, env=_env())  # getenv() needs a key


def test_failing_rank_stops_the_world_with_its_exit_code():
    """Rank 1 exits 3 at once; rank 0 would sleep for a minute. The
    launcher stops rank 0 and exits with rank 1's code."""
    code = ("import os, sys, time\n"
            "if os.environ['HOROVOD_RANK'] == '1':\n"
            "    print('rank 1 fails', flush=True); sys.exit(3)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    res = _run([sys.executable, "-m", "horovod_tpu_torch.runner.launch",
                "-np", "2", "-H", "localhost:2", sys.executable, "-c", code],
               timeout=60)
    assert res.returncode == 3, (res.stdout, res.stderr)
    assert "[1]rank 1 fails" in res.stdout
    assert time.monotonic() - t0 < 30


def test_sigterm_to_the_launcher_stops_every_worker(tmp_path):
    """The workers run in sessions of their own: a SIGTERM to the
    launcher must still stop them, and the launcher exits 143."""
    import signal

    # the pid goes to a temporary name first and is renamed into place,
    # so a file that exists holds the whole pid
    code = ("import os, time\n"
            f"path = os.path.join({str(tmp_path)!r}, os.environ["
            "'HOROVOD_RANK'])\n"
            "with open(path + '.tmp', 'w') as f:\n"
            "    f.write(str(os.getpid()))\n"
            "os.replace(path + '.tmp', path)\n"
            "time.sleep(60)\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", "-H", "localhost:2", sys.executable, "-c", code],
        cwd=REPO, env=_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        files = [tmp_path / r for r in ("0", "1")]
        deadline = time.monotonic() + 60
        while not all(f.exists() and f.stat().st_size for f in files):
            if time.monotonic() > deadline:
                pytest.fail("the workers did not write their pids in 60 s")
            time.sleep(0.1)
        pids = [int(f.read_text()) for f in files]
        assert all(pid > 0 for pid in pids), pids
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_init_refuses_a_local_rank_without_a_card(monkeypatch):
    """Local rank 1 on a host with one visible card: init() raises
    naming the rank, the count and CUDA_VISIBLE_DEVICES before it
    touches the card, and does not fall back to the CPU."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    monkeypatch.setenv("HOROVOD_RANK", "1")
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "1")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    with pytest.raises(RuntimeError) as e:
        basics.init()
    msg = str(e.value)
    assert "local rank 1" in msg and "1 card(s)" in msg
    assert "CUDA_VISIBLE_DEVICES=0" in msg
    assert calls == [] and not basics.is_initialized()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("HOROVOD_SIZE", "1")
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: None)
    basics.init()  # a second card: the check passes, rank 1 binds it
    try:
        assert calls == [1]
        assert basics.device() == torch.device("cuda", 1)
    finally:
        basics.shutdown()
