"""End-to-end elastic training through the port's driver with real
worker processes on gloo: tests/test_elastic_e2e.py's scenario.

The discovery script reads the training log, so the host set evolves as
training progresses: hostB serves the first batches, dies (os._exit
mid-epoch), and hostC appears in its place. The fake hosts run locally
through ``exec_fn`` with their addresses pointed at the loopback. As
with the JAX package's worker, progress is committed to disk after every
batch (the respawn model's commit: an ElasticSampler cursor); a survivor
whose collective fails (gloo raises at once where the JAX runtime
blocked) waits for the launcher to stop it. Asserts:

* the job finishes (the driver returns 0) across >= 2 rounds;
* the surviving host keeps rank 0 in every round;
* the failed host is blacklisted and never relaunched, the stopped
  survivor is not;
* every sample of every epoch is processed, and nothing committed is
  replayed beyond one batch window a rank a reset.
"""

import os
import pathlib
import sys
from collections import Counter, defaultdict

from horovod_tpu_torch.runner.elastic.discovery import (
    HostDiscoveryScript,
    HostManager,
)
from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
from horovod_tpu_torch.runner.elastic.settings import ElasticSettings
from horovod_tpu_torch.runner.util import safe_shell_exec

REPO = pathlib.Path(__file__).resolve().parent.parent

DATASET = 48
BATCH = 2
EPOCHS = 2

_WORKER = r'''
import json, os, sys, time
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.exceptions import HorovodInternalError
from horovod_tpu_torch.data import ElasticSampler

DATASET, BATCH, EPOCHS = 48, 2, 2


def atomic_write(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
host = os.environ.get("ELASTIC_E2E_HOST", "?")
workdir = os.environ["ELASTIC_E2E_DIR"]
state_path = os.path.join(workdir, "state.json")
log_path = os.path.join(workdir, "processed.log")
marker = os.path.join(workdir, "killed_once")
with open(os.path.join(workdir, "assignments.log"), "a") as f:
    f.write(f"{host} {rank} {size}\n")

sampler = ElasticSampler(DATASET, shuffle=True, seed=7)
start_epoch = 0
if os.path.exists(state_path):
    with open(state_path) as f:
        st = json.load(f)
    sampler.load_state_dict(st["sampler"])
    start_epoch = st["epoch"]
sampler.set_world(rank, size)

commits = 0
for epoch in range(start_epoch, EPOCHS):
    if sampler.epoch != epoch:
        sampler.set_epoch(epoch)
    mine = list(sampler)
    for off in range(0, len(mine), BATCH):
        batch = mine[off:off + BATCH]
        try:
            total = hvd.allreduce(torch.tensor(batch, dtype=torch.float64),
                                  op=hvd.Sum)
        except HorovodInternalError:
            # a peer went away: the launcher stops this round's workers
            # and the driver starts the next; wait to be stopped
            time.sleep(120)
            sys.exit(1)
        float(total.sum())
        sampler.record_batch(off // BATCH, BATCH)
        if rank == 0:
            atomic_write(state_path,
                         {"epoch": epoch, "sampler": sampler.state_dict()})
        with open(log_path, "a") as f:
            f.write(f"{epoch} {host} {rank} "
                    f"{','.join(str(i) for i in batch)}\n")
        commits += 1
        if host == "hostC" and os.path.exists(marker):
            try:
                fd = os.open(os.path.join(workdir, "recovery_ts"),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(time.time()).encode())
                os.close(fd)
            except FileExistsError:
                pass
        if (rank == 1 and epoch == 0 and commits == 3
                and not os.path.exists(marker)):
            with open(marker, "w") as f:
                f.write("x")
            with open(os.path.join(workdir, "death_ts"), "w") as f:
                f.write(str(time.time()))
            os._exit(1)  # the host dies, mid-epoch
    sampler.set_epoch(epoch + 1)
    if rank == 0:
        atomic_write(state_path,
                     {"epoch": epoch + 1, "sampler": sampler.state_dict()})
hvd.shutdown()
print(f"worker {host} rank {rank}: completed", flush=True)
'''


def _make_discovery_script(tmp_path):
    """hostB until the processed log shows 6 batches, then hostC."""
    log = tmp_path / "processed.log"
    script = tmp_path / "discover.sh"
    script.write_text(
        "#!/bin/sh\n"
        "echo hostA:1\n"
        f'N=$(cat "{log}" 2>/dev/null | wc -l)\n'
        'if [ "$N" -lt 6 ]; then echo hostB:1; else echo hostC:1; fi\n')
    script.chmod(0o755)
    return str(script)


def _worker_env(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="", ELASTIC_E2E_DIR=str(tmp_path))
    return env


def _local_exec(command, env, slot, events):
    """The ssh analog for fake hostnames: every slot runs locally, its
    coordinator and rendezvous addresses pointed at the loopback."""
    env = dict(env)
    env["ELASTIC_E2E_HOST"] = slot.hostname
    host, _, port = env["HVD_TPU_COORDINATOR_ADDRESS"].rpartition(":")
    env["HVD_TPU_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    env["HVD_TPU_RENDEZVOUS_ADDR"] = "127.0.0.1"
    return safe_shell_exec.execute(
        command, env=env, prefix=f"{slot.hostname}:{slot.rank}",
        events=events)


def test_elastic_end_to_end(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    settings = ElasticSettings(min_np=2, max_np=2, timeout_s=120.0,
                               discovery_interval_s=0.2)
    driver = ElasticDriver(
        HostManager(HostDiscoveryScript(_make_discovery_script(tmp_path))),
        settings, [sys.executable, str(worker)], _worker_env(tmp_path),
        exec_fn=_local_exec)
    assert driver.run() == 0, "elastic job did not finish"
    assert (tmp_path / "killed_once").exists()
    death = float((tmp_path / "death_ts").read_text())
    recovery = float((tmp_path / "recovery_ts").read_text())
    assert recovery > death

    rounds = [line.split() for line in
              (tmp_path / "assignments.log").read_text().splitlines()]
    a_ranks = [int(r) for h, r, s in rounds if h == "hostA"]
    assert len(a_ranks) >= 2, "hostA should run in every round"
    assert set(a_ranks) == {0}, f"hostA changed rank: {a_ranks}"
    assert len([r for h, r, s in rounds if h == "hostB"]) == 1, \
        "failed hostB must not be relaunched"
    assert any(h == "hostC" for h, r, s in rounds), "hostC never joined"
    assert driver._host_manager.is_blacklisted("hostB")
    assert not driver._host_manager.is_blacklisted("hostA")

    per_epoch = defaultdict(list)
    for line in (tmp_path / "processed.log").read_text().splitlines():
        epoch, host, rank, idxs = line.split()
        per_epoch[int(epoch)].extend(int(i) for i in idxs.split(","))
    for epoch in range(EPOCHS):
        counts = Counter(per_epoch[epoch])
        missing = set(range(DATASET)) - set(counts)
        assert not missing, f"epoch {epoch} lost samples: {sorted(missing)}"
        replayed = sum(c - 1 for c in counts.values())
        assert replayed <= 2 * BATCH * 2, \
            f"epoch {epoch} replayed too much: {replayed}"
