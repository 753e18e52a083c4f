"""The port of ``examples/pipeline_pretraining.py``, the twins of the JAX
package's ``tests/test_examples.py`` pipeline cases: both schedules, on
a world of two over gloo (``examples/local_world.py``, ``--device
cpu``), 14 steps at ``--pp 2 --microbatches 4 --layers 2 --seq-len 64``;
the loss must fall by 0.5, as the JAX example's does, and both
schedules give the same losses (the same weights, batch and
optimizer).
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
ARGS = ["--steps", "14", "--pp", "2", "--microbatches", "4", "--layers",
        "2", "--seq-len", "64", "--device", "cpu"]


@pytest.fixture(scope="module")
def runs():
    """Both schedules' worlds, run at once."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO),
               CUDA_VISIBLE_DEVICES="")
    procs = {s: subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.examples.local_world",
         "-np", "2", "--", sys.executable, "-m",
         "horovod_tpu_torch.examples.pipeline_pretraining", "--schedule", s,
         *ARGS], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for s in ("1f1b", "gpipe")}
    out = {}
    try:
        for s, p in procs.items():
            out[s] = (p.communicate(timeout=150)[0], p.returncode)
    finally:
        for p in procs.values():
            p.kill()
    return out


def _losses(text):
    return [float(v) for v in re.findall(r"^\[0\]step \d+: loss (\S+)$",
                                          text, re.M)]


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_pipeline_pretraining_learns(runs, schedule):
    text, rc = runs[schedule]
    assert rc == 0, text
    losses = _losses(text)
    assert len(losses) == 14, text
    assert losses[-1] < losses[0] - 0.5, losses
    summary = re.search(rf"^\[0\]{schedule} pp=2 dp=1 M=4: [\d,]+ "
                        r"tokens/sec, loss (\S+) -> (\S+)$", text, re.M)
    assert summary, text
    assert float(summary.group(2)) < float(summary.group(1)) - 0.5


def test_schedules_agree(runs):
    """GPipe and 1F1B compute the same gradients up to float32 rounding:
    their losses agree to the printed digits."""
    a, b = _losses(runs["1f1b"][0]), _losses(runs["gpipe"][0])
    assert max(abs(x - y) for x, y in zip(a, b)) <= 2e-4, (a, b)
